"""Chatterbox Turbo's T3: GPT-2 medium, text → speech tokens without CFG,
perceiver or emotion, and the meanflow few-step flow solve (port of
tpu_audio/models/chatterbox_turbo/model.py: GPT2_MEDIUM, SILENCE_TOKEN,
T3TurboConfig, init_params, TurboSampler, T3TurboGenerator,
T3TurboStreamer, meanflow_inference).

GPT-2's learned positions are not shift-invariant, so the prefill keeps
[speaker | text | BOS] left-aligned in a bucket of 1 + text_pad + 1 slots
with explicit positions: the real slots read positions 0 … n_text + 1,
the pad slots after BOS read position 0 and are masked for every query;
the prefill's logits are those of the BOS slot. Generated token k
(0-based) is fed back at position n_text + 2 + k (the cache's position
past the prefill, plus n_text + 2). The stack runs per layer on a plain
`KVCache` at B=1; on the q4/q8 trees each of its linears, all with
biases in the published checkpoints, and the 8194-row speech head go to
`quant_matmul`. The cache is sized for each request unless `max_cache`
is given (then a request past it is refused, ROADMAP C22).

`T3TurboStreamer` decodes in chunks for token streaming: one prefill,
then chunks of `chunk` tokens (`chunk + first_extra` the first), each
chunk's first token drawn from the logits the previous chunk left, its
last token forwarded after the chunk to leave the next chunk's; the
cache, the repetition window and the position carry across chunks, so
its tokens are `T3TurboGenerator.generate`'s on the same draws, and
`max_new` is honoured by trimming the last chunk.

`meanflow_inference`: Euler steps on a linear t grid (no cosine warp, no
CFG), each step's estimator conditioned on its start t and end r.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_audio_torch.codecs.s3gen.params import Init
from tpu_audio_torch.convert import params_from_numpy, tree_device
from tpu_audio_torch.models.chatterbox.t3 import RECENT, cache_slots, sampler_config, table_dtype
from tpu_audio_torch.nn import attention, layers, transformer
from tpu_audio_torch.ops import sampling
from tpu_audio_torch.ops.decoding import SYNC_EVERY, decode_loop

GPT2_MEDIUM = transformer.TransformerConfig(
    dim=1024, n_layers=24, n_heads=16, n_kv_heads=16, hidden_dim=4096, mlp="gelu_new",
    norm="ln", pos_emb="none", max_position_embeddings=8192)  # positions added here

SILENCE_TOKEN = 4299


@dataclass(frozen=True)
class T3TurboConfig:
    gpt2: transformer.TransformerConfig = field(default=GPT2_MEDIUM)
    text_tokens_dict_size: int = 50276
    speech_tokens_dict_size: int = 8194
    start_speech_token: int = 6561
    stop_speech_token: int = 6562
    speaker_embed_size: int = 256
    max_positions: int = 8192


def numpy_params(rng: np.random.Generator, cfg: T3TurboConfig) -> dict:
    """The JAX `init_params` tree as f32 numpy arrays."""
    init, d = Init(rng), cfg.gpt2.dim
    return {"tfmr": transformer.numpy_params(rng, cfg.gpt2),
            "wpe": init.embedding(cfg.max_positions, d),
            "text_emb": init.embedding(cfg.text_tokens_dict_size, d),
            "speech_emb": init.embedding(cfg.speech_tokens_dict_size, d),
            "speech_head": init.linear(d, cfg.speech_tokens_dict_size, False),
            "cond_enc": {"spkr_enc": init.linear(cfg.speaker_embed_size, d)}}


def init_params(seed: int, cfg: T3TurboConfig, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters from a numpy seed, on the card unless `device`
    says otherwise."""
    return params_from_numpy(numpy_params(np.random.default_rng(seed), cfg), device, dtype)


@dataclass(frozen=True)
class TurboSampler:
    temperature: float = 0.8
    top_p: float = 0.95
    min_p: float = 0.05
    repetition_penalty: float = 1.2


def text_bucket(n: int) -> int:
    return -(-max(n, 1) // 32) * 32


class T3TurboGenerator:
    def __init__(self, params, cfg: T3TurboConfig, max_cache: int | None = None,
                 cache_dtype: torch.dtype = torch.bfloat16):
        """max_cache: the cache's slots, or None (the default) for as many
        as each request needs."""
        self.params = params
        self.cfg = cfg
        self.max_cache = max_cache
        self.cache_dtype = cache_dtype
        self.device = tree_device(params)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Speech logits (B, V) f32 of hidden rows (B, D)."""
        return layers.linear(self.params["speech_head"], h).float()

    def wpe(self, pos: torch.Tensor) -> torch.Tensor:
        """Learned position rows, the index clamped to the table."""
        return layers.embedding(self.params["wpe"],
                                torch.clamp(pos, 0, self.cfg.max_positions - 1))

    def prefill(self, spk_emb: torch.Tensor, text_tokens: list[int], steps: int):
        """[speaker | text | BOS] through the stack into a cache with room
        for `steps` more tokens: (the BOS slot's logits (1, V) f32, cache,
        extra mask, the prefill's slots)."""
        p, cfg, dev = self.params, self.cfg, self.device
        n, pad = len(text_tokens), text_bucket(len(text_tokens))
        dt = table_dtype(p["speech_emb"])
        toks = torch.zeros(pad, dtype=torch.int64)
        toks[:n] = torch.as_tensor(text_tokens, dtype=torch.int64)
        cond = layers.linear(p["cond_enc"]["spkr_enc"], spk_emb.to(dt))[:, None, :]
        text_e = layers.embedding(p["text_emb"], toks.to(dev)[None])
        bos = layers.embedding(p["speech_emb"],
                               torch.full((1, 1), cfg.start_speech_token, device=dev))
        total = 1 + pad + 1
        x = torch.cat([cond.to(dt), text_e.to(dt), torch.zeros_like(bos, dtype=dt)], dim=1)
        x[:, 1 + n] = bos[:, 0].to(dt)
        slots = torch.arange(total, device=dev)
        x = x + self.wpe(torch.clamp(slots, max=n + 1))[None].to(dt)
        n_real = 2 + n
        cache = transformer.make_cache(cfg.gpt2, 1, cache_slots(self.max_cache, total, steps),
                                       self.cache_dtype, device=dev)
        slot = torch.arange(cache.max_len, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        extra = torch.where((slot >= n_real) & (slot < total), attention.NEG_INF,
                            zero)[None, None, None, :]
        hidden, cache = transformer.forward_hidden(p["tfmr"], cfg.gpt2, x, cache, extra)
        return self.head(hidden[:, n_real - 1]), cache, extra, total

    def step_fn(self, extra: torch.Tensor, n_text: int, total: int):
        """(token (1, 1), cache) → (logits (1, V) f32, cache): generated
        token k at position n_text + 2 + k, k the cache's position past the
        prefill."""
        dt = table_dtype(self.params["speech_emb"])

        def step(tok, cache):
            x = (layers.embedding(self.params["speech_emb"], tok)
                 + self.wpe(cache.pos - total + n_text + 2)).to(dt)
            h, cache = transformer.forward_hidden(self.params["tfmr"], self.cfg.gpt2, x, cache,
                                                  extra)
            return self.head(h[:, -1]), cache
        return step

    @torch.inference_mode()
    def generate(self, spk_emb: torch.Tensor, text_tokens: list[int], *,
                 sampler: TurboSampler = TurboSampler(), max_new: int = 600, seed: int = 0,
                 noise=None) -> list[int]:
        """Speech tokens for the text ids (the stop token and ids ≥
        start_speech_token dropped; the silence token kept). noise(i): the
        Gumbel draw (1, V) of token i instead of the generator's."""
        cfg, sc = self.cfg, sampler_config(sampler)
        logits, cache, extra, total = self.prefill(spk_emb, text_tokens, max_new + SYNC_EVERY)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        recent = torch.full((1, RECENT), -1, dtype=torch.int64, device=self.device)
        first = sampling.sample(logits, sc, recent, gen, None if noise is None else noise(0))
        stop = cfg.stop_speech_token
        res = decode_loop(self.step_fn(extra, len(text_tokens), total), cache, first,
                          max_new - 1, eos_ids=(stop,), sampler=sc, generator=gen, pad_id=stop,
                          finished0=first == stop,
                          noise=None if noise is None else (lambda i: noise(i + 1)))
        out = [int(first[0])] + res.tokens[0, :int(res.lengths[0])].tolist()
        return [t for t in out if t < cfg.start_speech_token]


class T3TurboStreamer:
    """Chunked decode for token-granularity streaming. first_extra: tokens
    added to the FIRST chunk only (the flow's pre-lookahead, so that the
    first audio needs one chunk)."""

    def __init__(self, gen: T3TurboGenerator, chunk: int = 25, first_extra: int = 0):
        self.gen = gen
        self.chunk = chunk
        self.first_extra = first_extra

    @torch.inference_mode()
    def stream(self, spk_emb: torch.Tensor, text_tokens: list[int], *,
               sampler: TurboSampler = TurboSampler(), max_new: int = 600, seed: int = 0,
               noise=None):
        """Yields lists of speech tokens (≤ chunk each, the first ≤ chunk +
        first_extra) as they decode; the stop and start specials dropped,
        the silence token kept (the synthesis filters it). noise(c, i):
        chunk c's draw i (1, V)."""
        g, cfg, sc = self.gen, self.gen.cfg, sampler_config(sampler)
        stop, n_text = cfg.stop_speech_token, len(text_tokens)
        steps = max_new + self.chunk + self.first_extra + SYNC_EVERY
        logits, cache, extra, total = g.prefill(spk_emb, text_tokens, steps)
        step = g.step_fn(extra, n_text, total)
        gen = torch.Generator(device=g.device).manual_seed(seed)
        recent = torch.full((1, RECENT), -1, dtype=torch.int64, device=g.device)
        produced, c = 0, 0
        while produced < max_new:
            size = self.chunk + (self.first_extra if c == 0 else 0)
            first = sampling.sample(logits, sc, recent, gen,
                                    None if noise is None else noise(c, 0))
            recent = sampling.update_recent(recent, first)
            res = decode_loop(step, cache, first, size - 1, eos_ids=(stop,), sampler=sc,
                              generator=gen, pad_id=stop, recent0=recent,
                              finished0=first == stop,
                              noise=None if noise is None else (lambda i, c=c: noise(c, i + 1)))
            tokens = torch.cat([first, res.tokens[0]])
            finished = bool(res.finished[0])
            n = 1 + int(res.lengths[0])
            if not finished:  # the next chunk's first logits: its last token through the stack
                logits, cache = step(tokens[n - 1].reshape(1, 1), res.last_state)
            recent = res.recent
            take = min(n, max_new - produced)
            out = [t for t in tokens[:take].tolist() if t < cfg.start_speech_token]
            produced += take
            c += 1
            if out:
                yield out
            if finished:
                break


def meanflow_inference(estimator_fn, mu: torch.Tensor, mask_len: torch.Tensor,
                       spks: torch.Tensor, cond: torch.Tensor, z: torch.Tensor,
                       n_timesteps: int = 2, streaming: bool = False) -> torch.Tensor:
    """Few-step Euler from z (B, T, D) on a linear t grid, without CFG:
    estimator_fn(x, mask_len, mu, t, spks, cond, streaming, r) → the mean
    velocity over [t, r]. streaming applies the estimator's chunk-causal
    masks (the token stream's windows)."""
    b = mu.shape[0]
    ts = torch.linspace(0.0, 1.0, n_timesteps + 1, device=mu.device)
    x = z.to(mu.dtype)
    for i in range(n_timesteps):
        t = ts[i].to(mu.dtype).expand(b)
        r = ts[i + 1].to(mu.dtype).expand(b)
        v = estimator_fn(x, mask_len, mu, t, spks, cond, streaming, r)
        x = (x.float() + (ts[i + 1] - ts[i]) * v.float()).to(x.dtype)
    return x
