"""T3: Chatterbox's Llama text → speech-token model with classifier-free
guidance and voice conditioning (port of tpu_audio/models/chatterbox/t3.py:
LLAMA_520M, T3Config, init_params, _perceiver, prepare_conditioning,
T3SamplerConfig, T3Generator).

The conditioning is [speaker projection | the prompt's speech tokens
resampled by the perceiver (32 queries; one attention block used twice,
as cross-attention and then as self-attention) | the emotion scalar's
projection], (1, 34, D). The prefill is [conditioning | text | BOS] with
learned text and speech positions, right-aligned in a bucket of
34 + text_pad + 1 slots: the pad slots sit before the real rows and are
masked by an additive bias on every query, so RoPE's shift invariance
keeps the result the bucket's (the JAX generator rolls the same rows
right by text_pad − n_text). CFG runs as a batch of 2, the second row
with its text embeddings zeroed, both rows fed the same sampled token;
the logits merge as c + w·(c − u), and the repetition penalty (over the
last 64 tokens), temperature, top-p and min-p apply to the merged row.

Generated token k (0-based) is fed back at speech position k + 2, as the
JAX loop's `i + 1` with i from 1 gives it: BOS reads position 0 and
position 1 is never read (`STEP_POS0`, ROADMAP C23, unconfirmed). The
decode runs per layer on a plain `KVCache` at B=2 (the whole-stack step
is single-stream); on the q4/q8 trees every linear of ≤ 32 rows goes to
`quant_matmul`, the speech head (8194 × 1024) among them. The cache is
sized for each request unless `max_cache` is given, and a request past a
given `max_cache` is refused, where the JAX cache clamps its writes at
the last slot (ROADMAP C22). Draws come from a `torch.Generator` on the
model's device, or from `noise(i)` (a test feeds the JAX package's
Gumbel draws).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_audio_torch.codecs.s3gen.params import Init
from tpu_audio_torch.convert import params_from_numpy, tree_device
from tpu_audio_torch.nn import attention, layers, transformer
from tpu_audio_torch.ops import sampling
from tpu_audio_torch.ops.decoding import SYNC_EVERY, decode_loop

LLAMA_520M = transformer.TransformerConfig(
    dim=1024, n_layers=30, n_heads=16, n_kv_heads=16, hidden_dim=4096, rope_theta=10000.0,
    norm_eps=1e-5)

PERCEIVER_HEADS = 4
RECENT = 64  # the repetition penalty's window
STEP_POS0 = 2  # the speech position of the first generated token (ROADMAP C23)


@dataclass(frozen=True)
class T3Config:
    llama: transformer.TransformerConfig = field(default=LLAMA_520M)
    text_tokens_dict_size: int = 704  # 2454 multilingual
    start_text_token: int = 255
    stop_text_token: int = 0
    speech_tokens_dict_size: int = 8194
    start_speech_token: int = 6561
    stop_speech_token: int = 6562
    max_speech_tokens: int = 1024
    speaker_embed_size: int = 256
    perceiver_tokens: int = 32
    max_text_seq_len: int = 2048
    max_mel_seq_len: int = 4096
    emotion_adv: bool = True


def numpy_params(rng: np.random.Generator, cfg: T3Config) -> dict:
    """The JAX `init_params` tree as f32 numpy arrays."""
    init, d = Init(rng), cfg.llama.dim
    attn = {"norm": Init.norm(d), "q": init.linear(d, d), "k": init.linear(d, d),
            "v": init.linear(d, d), "proj_out": init.linear(d, d)}
    return {"tfmr": transformer.numpy_params(rng, cfg.llama),
            "text_emb": init.embedding(cfg.text_tokens_dict_size, d),
            "speech_emb": init.embedding(cfg.speech_tokens_dict_size, d),
            "text_head": init.linear(d, cfg.text_tokens_dict_size, False),
            "speech_head": init.linear(d, cfg.speech_tokens_dict_size, False),
            "text_pos_emb": {"emb": init.embedding(cfg.max_text_seq_len, d)},
            "speech_pos_emb": {"emb": init.embedding(cfg.max_mel_seq_len, d)},
            "cond_enc": {"spkr_enc": init.linear(cfg.speaker_embed_size, d),
                         "emotion_adv_fc": init.linear(1, d, False),
                         "perceiver": {"pre_attention_query": init.uniform(
                             (1, cfg.perceiver_tokens, d), 0.1), "attn": attn}}}


def init_params(seed: int, cfg: T3Config, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters from a numpy seed, on the card unless `device`
    says otherwise."""
    return params_from_numpy(numpy_params(np.random.default_rng(seed), cfg), device, dtype)


def table_dtype(p: dict) -> torch.dtype:
    """The dtype a table's rows come out in (f32 for a quantised table)."""
    return p["weight"].dtype if "weight" in p else torch.float32


def positions(p: dict, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a learned position table {"emb": table}, the index clamped
    to the table as a JAX gather clamps it."""
    table = p["emb"]
    n = (table["weight"] if "weight" in table else table["scales"]).shape[0]
    return layers.embedding(table, torch.clamp(idx, max=n - 1))


def attn_block(ap: dict, q_in: torch.Tensor, kv: torch.Tensor,
               heads: int = PERCEIVER_HEADS) -> torch.Tensor:
    """The perceiver's attention block: q_in + proj_out(attention of the
    LayerNormed q_in over the LayerNormed kv), the norm shared."""
    b, _, d = q_in.shape
    hd = d // heads
    qn, kvn = layers.layer_norm(ap["norm"], q_in), layers.layer_norm(ap["norm"], kv)
    q = layers.linear(ap["q"], qn).reshape(b, -1, heads, hd)
    k = layers.linear(ap["k"], kvn).reshape(b, -1, heads, hd)
    v = layers.linear(ap["v"], kvn).reshape(b, -1, heads, hd)
    o = attention.attend(q, k, v, scale=1.0 / math.sqrt(hd))
    return q_in + layers.linear(ap["proj_out"], o.reshape(b, q_in.shape[1], d))


def _perceiver(p: dict, h: torch.Tensor, heads: int = PERCEIVER_HEADS) -> torch.Tensor:
    """Fixed-length resampling of (B, T, D) to (B, 32, D): the queries
    cross-attend h, then one self-attention pass through the same block."""
    q0 = p["pre_attention_query"].to(h.dtype).expand(h.shape[0], -1, -1)
    cross = attn_block(p["attn"], q0, h, heads)
    return attn_block(p["attn"], cross, cross, heads)


def prepare_conditioning(params: dict, cfg: T3Config, speaker_emb: torch.Tensor,
                         cond_tokens: torch.Tensor | None, emotion_adv: float) -> torch.Tensor:
    """speaker_emb (B, 256), cond_tokens (B, P) S3 tokens or None → the
    conditioning rows (B, 1 + 32 + 1, D) in the activations' dtype."""
    ce = params["cond_enc"]
    dt = table_dtype(params["speech_emb"])
    spk = speaker_emb.to(dt)
    parts = [layers.linear(ce["spkr_enc"], spk)[:, None, :]]
    if cond_tokens is not None:
        n = cond_tokens.shape[1]
        ids = torch.clamp(cond_tokens, 0, cfg.speech_tokens_dict_size - 1)  # as JAX's gather
        emb = (layers.embedding(params["speech_emb"], ids)
               + positions(params["speech_pos_emb"], torch.arange(n, device=spk.device))[None])
        parts.append(_perceiver(ce["perceiver"], emb.to(dt)))
    if cfg.emotion_adv:
        emo = torch.full((spk.shape[0], 1, 1), float(emotion_adv), dtype=dt, device=spk.device)
        parts.append(layers.linear(ce["emotion_adv_fc"], emo))
    return torch.cat([p.to(dt) for p in parts], dim=1)


@dataclass(frozen=True)
class T3SamplerConfig:
    temperature: float = 0.8
    top_p: float = 0.95
    min_p: float = 0.05
    repetition_penalty: float = 1.2
    cfg_weight: float = 0.5


def sampler_config(s) -> sampling.SamplerConfig:
    """The port's sampler of a T3 (or Turbo) sampler's knobs: repetition penalty over
    RECENT tokens → temperature → top-p → min-p → a Gumbel draw."""
    return sampling.SamplerConfig(temperature=s.temperature, top_p=s.top_p, min_p=s.min_p,
                                  repetition_penalty=s.repetition_penalty,
                                  repetition_window=RECENT)


def cache_slots(max_cache: int | None, total: int, steps: int) -> int:
    """A T3 cache's slots for a prefill of `total` and `steps` decode steps:
    what the request needs (to a multiple of 32) with max_cache None, else
    max_cache, refused where the request would overrun it (ROADMAP C22)."""
    need = total + steps
    if max_cache is None:
        return -(-need // 32) * 32
    if need > max_cache:
        raise ValueError(f"a prefill of {total} slots + {steps} decode steps exceeds "
                         f"max_cache {max_cache} (ROADMAP C22)")
    return max_cache


def text_bucket(n: int) -> int:
    return -(-n // 32) * 32


def cfg_text_rows(text_e: torch.Tensor) -> torch.Tensor:
    """The CFG batch's text rows (2, T, D): the conditioned row's, and the
    unconditioned row's zeroed."""
    return torch.cat([text_e, torch.zeros_like(text_e)])


def cfg_merge(logits: torch.Tensor, cfg_weight: float) -> torch.Tensor:
    """(B, V) → the CFG-merged (1, V): c + w·(c − u) at B=2."""
    if logits.shape[0] == 1:
        return logits
    c, u = logits[:1], logits[1:2]
    return c + cfg_weight * (c - u)


def pad_mask(slots: int, shift: int, device) -> torch.Tensor:
    """The additive (1, 1, 1, slots) bias that hides the prefill's pad
    slots [0, shift) from every query."""
    slot = torch.arange(slots, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(slot < shift, attention.NEG_INF, zero)[None, None, None, :]


class T3Generator:
    """CFG speech-token generation, the text bucketed to a multiple of 32."""

    def __init__(self, params, cfg: T3Config, max_cache: int | None = None,
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

    def speech_rows(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Speech embeddings of tok (B, 1) at speech position pos (0-d)."""
        p = self.params
        return layers.embedding(p["speech_emb"], tok) + positions(p["speech_pos_emb"], pos)

    def prefill(self, cond_emb: torch.Tensor, text_tokens: list[int], steps: int,
                cfg_weight: float):
        """[cond | text | BOS] through the stack into a cache with room for
        `steps` more tokens: (merged logits (1, V) f32, cache, extra mask,
        prefill slots)."""
        p, cfg, dev = self.params, self.cfg, self.device
        n, pad = len(text_tokens), text_bucket(len(text_tokens))
        b = 2 if cfg_weight > 0 else 1
        dt = table_dtype(p["speech_emb"])
        toks = torch.as_tensor(text_tokens, dtype=torch.int64, device=dev)
        text_e = (layers.embedding(p["text_emb"], toks[None])
                  + positions(p["text_pos_emb"], torch.arange(n, device=dev))[None]).to(dt)
        if b == 2:
            text_e = cfg_text_rows(text_e)
        bos = self.speech_rows(torch.full((b, 1), cfg.start_speech_token, device=dev),
                               torch.zeros((), dtype=torch.int64, device=dev)).to(dt)
        real = torch.cat([cond_emb.to(dt).expand(b, -1, -1), text_e, bos], dim=1)
        total = cond_emb.shape[1] + pad + 1
        shift = total - real.shape[1]
        x = torch.zeros((b, total, real.shape[-1]), dtype=dt, device=dev)
        x[:, shift:] = real
        cache = transformer.make_cache(cfg.llama, b, cache_slots(self.max_cache, total, steps),
                                       self.cache_dtype, device=dev)
        extra = pad_mask(cache.max_len, shift, dev)
        hidden, cache = transformer.forward_hidden(p["tfmr"], cfg.llama, x, cache, extra)
        return cfg_merge(self.head(hidden[:, -1]), cfg_weight), cache, extra, total

    def step_fn(self, extra: torch.Tensor, total: int, cfg_weight: float):
        """(token (1, 1), cache) → (merged logits (1, V) f32, cache): the
        token fed to every CFG row at its speech position (the cache's
        position past the prefill + STEP_POS0)."""
        cfg = self.cfg
        b = 2 if cfg_weight > 0 else 1

        def step(tok, cache):
            x = self.speech_rows(tok.expand(b, 1), cache.pos - total + STEP_POS0)
            h, cache = transformer.forward_hidden(self.params["tfmr"], cfg.llama,
                                                  x.to(table_dtype(self.params["speech_emb"])),
                                                  cache, extra)
            return cfg_merge(self.head(h[:, -1]), cfg_weight), cache
        return step

    @torch.inference_mode()
    def generate(self, cond_emb: torch.Tensor, text_tokens: list[int], *,
                 sampler: T3SamplerConfig = T3SamplerConfig(), max_new: int = 600,
                 seed: int = 0, noise=None) -> list[int]:
        """Speech tokens for the text ids (the stop token and ids ≥
        start_speech_token dropped). noise(i): the Gumbel draw (1, V) of
        token i instead of the generator's."""
        cfg = self.cfg
        sc = sampler_config(sampler)
        logits, cache, extra, total = self.prefill(cond_emb, text_tokens, max_new + SYNC_EVERY,
                                                   sampler.cfg_weight)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        recent = torch.full((1, RECENT), -1, dtype=torch.int64, device=self.device)
        first = sampling.sample(logits, sc, recent, gen, None if noise is None else noise(0))
        stop = cfg.stop_speech_token
        res = decode_loop(self.step_fn(extra, total, sampler.cfg_weight), cache, first,
                          max_new - 1, eos_ids=(stop,), sampler=sc, generator=gen, pad_id=stop,
                          finished0=first == stop,
                          noise=None if noise is None else (lambda i: noise(i + 1)))
        out = [int(first[0])] + res.tokens[0, :int(res.lengths[0])].tolist()
        return [t for t in out if t < cfg.start_speech_token]
