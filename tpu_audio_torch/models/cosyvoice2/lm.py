"""CosyVoice2's LM: Qwen2-0.5B, text → speech tokens (port of
tpu_audio/models/cosyvoice2/lm.py: QWEN2_05B, CosyLMConfig, RAS_SAMPLER,
init_params, CosyLMGenerator, CosyLMStreamer).

The prefill is [sos | prompt text + text (Qwen2's embeddings) | task |
prompt speech (the speech embeddings)], roll-packed: the real rows sit at
the end of a bucket of 2 + text_pad + speech_pad, the slots before them
masked (the whole-stack step's `start`), so RoPE keeps padded decode exact.
The speech head `llm_decoder` (896 → 6561 + 3, with a bias) gives the
logits; EOS (6561) and the two other specials are masked while fewer than
min_len = 2 × the text's tokens were made; max_len = 20 × the text's
tokens (rounded up to 32 by `generate`). Sampling is RAS (top-k 25, top-p
0.8, a redraw when the token repeats more than twice in the last 10).

Each T=1 step runs the whole stack as one launch of the whole-stack step
kernel (`ops/kernels/fused_step.py`: bf16 or int8 trees, the qkv bias
folded in) where `fused_decode_supported` holds, and the head through
`int8_matmul` on the w8a8 tree. The cache is sized for each request
unless `max_cache` is given, and a request past a given `max_cache` is
refused, where the JAX generator's cache writes clamp at the last slot
(ROADMAP C18). Draws come from a `torch.Generator` on the model's device,
two Gumbel draws a RAS step, or from `noise(chunk, i)`, which a test uses
to feed the JAX package's draws. `speculative=` and `mesh=` are ROADMAP A9
and raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_audio_torch.convert import params_from_numpy, tree_device
from tpu_audio_torch.nn import layers, transformer
from tpu_audio_torch.ops import sampling
from tpu_audio_torch.ops.decoding import SYNC_EVERY, decode_loop
from tpu_audio_torch.ops.sampling import SamplerConfig

_NOT_PORTED = "is not ported yet (ROADMAP A9)"

QWEN2_05B = transformer.TransformerConfig(
    dim=896, n_layers=24, n_heads=14, n_kv_heads=2, hidden_dim=4864, vocab_size=151936,
    rope_theta=1000000.0, attn_qkv_bias=True, norm_eps=1e-6, tie_word_embeddings=True)


@dataclass(frozen=True)
class CosyLMConfig:
    qwen: transformer.TransformerConfig = field(default=QWEN2_05B)
    llm_input_size: int = 896
    speech_token_size: int = 6561
    sos_eos: int = 0
    task_id: int = 1
    fill_token: int = 2
    min_token_text_ratio: float = 2.0
    max_token_text_ratio: float = 20.0

    @property
    def eos_id(self) -> int:
        return self.speech_token_size


RAS_SAMPLER = SamplerConfig(temperature=1.0, top_k=25, top_p=0.8, ras=True, ras_window=10,
                            ras_max_repeats=2)


def numpy_params(rng: np.random.Generator, cfg: CosyLMConfig) -> dict:
    """The JAX `init_params` tree as f32 numpy arrays."""
    d, n = cfg.llm_input_size, cfg.speech_token_size + 3
    scale = np.float32(1.0 / np.sqrt(d))

    def table(rows):
        return {"weight": rng.standard_normal((rows, d), dtype=np.float32) * np.float32(0.02)}
    return {"llm": transformer.numpy_params(rng, cfg.qwen), "llm_embedding": table(2),
            "llm_decoder": {"weight": (rng.random((n, d), dtype=np.float32) * 2 - 1) * scale,
                            "bias": (rng.random((n,), dtype=np.float32) * 2 - 1) * scale},
            "speech_embedding": table(n)}


def init_params(seed: int, cfg: CosyLMConfig, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters from a numpy seed, on the card unless `device`
    says otherwise."""
    return params_from_numpy(numpy_params(np.random.default_rng(seed), cfg), device, dtype)


def _bucket(n: int) -> int:
    return max(32, -(-n // 32) * 32)


class CosyLMGenerator:
    def __init__(self, params, cfg: CosyLMConfig, max_cache: int | None = None, mesh=None,
                 cache_dtype: torch.dtype = torch.bfloat16):
        """max_cache: the cache's slots, or None (the default) for as many
        as each request needs."""
        if mesh is not None:
            raise NotImplementedError(f"tensor-parallel serving (mesh=) {_NOT_PORTED}")
        self.params = dict(params, llm=transformer.fuse_fp_tree(params["llm"]))
        self.cfg = cfg
        self.max_cache = max_cache
        self.cache_dtype = cache_dtype
        self.device = tree_device(params)

    def fused_ok(self) -> bool:
        """Whether the T=1 steps run the whole-stack step kernel."""
        return transformer.fused_decode_supported(self.cfg.qwen, self.params["llm"])

    def _slots(self, total: int, steps: int) -> int:
        need = total + steps
        if self.max_cache is None:
            return -(-need // 32) * 32
        if need > self.max_cache:
            raise ValueError(f"a prompt of {total} slots + {steps} decode steps exceeds "
                             f"max_cache {self.max_cache} (ROADMAP C18)")
        return self.max_cache

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Speech logits (B, V) f32 of hidden rows (B, D)."""
        return layers.linear(self.params["llm_decoder"], h).float()

    def embed_speech(self, tok: torch.Tensor) -> torch.Tensor:
        return layers.embedding(self.params["speech_embedding"], tok)

    def prefill(self, text_ids: list[int], prompt_text_ids: list[int],
                prompt_speech: list[int], steps: int, fused: bool | None = None):
        """The packed prompt through the stack into a cache with room for
        `steps` more tokens: (logits (1, V) f32, cache, extra mask). fused:
        the whole-stack step's cache (None: where `fused_ok`)."""
        p, cfg = self.params, self.cfg
        full_text = list(prompt_text_ids) + list(text_ids)
        n_t, n_s = len(full_text), len(prompt_speech)
        total = 2 + _bucket(n_t) + _bucket(n_s)
        dev = self.device

        def ids(v):
            return torch.as_tensor(v, dtype=torch.int64, device=dev)
        text_e = layers.embedding(p["llm"]["embed"], ids(full_text)[None]).float()
        speech_e = self.embed_speech(ids(prompt_speech)[None])
        sos, task = layers.embedding(p["llm_embedding"], ids([[cfg.sos_eos], [cfg.task_id]]))
        dt = sos.dtype  # the table's (f32 where it is quantised)
        real = torch.cat([sos[None], text_e.to(dt), task[None], speech_e.to(dt)], dim=1)
        shift = total - real.shape[1]
        x = torch.zeros((1, total, real.shape[-1]), dtype=dt, device=dev)
        x[:, shift:] = real
        cache, extra = transformer.decode_cache_and_mask(
            cfg.qwen, self._slots(total, steps), shift, self.fused_ok() if fused is None else fused,
            dtype=self.cache_dtype, device=dev)
        hidden, cache = transformer.forward_hidden(p["llm"], cfg.qwen, x, cache, extra)
        return self.head(hidden[:, -1]), cache, extra

    def step_fn(self, extra):
        """(token (B, 1), cache) → (logits (B, V) f32, cache): one T=1 step."""
        def step(tok, cache):
            h, cache = transformer.forward_hidden(self.params["llm"], self.cfg.qwen,
                                                  self.embed_speech(tok), cache, extra)
            return self.head(h[:, -1]), cache
        return step

    def processor(self, min_len: int, produced: int = 0):
        """Masks the specials (EOS among them) at draw i while
        produced + i + 1 < min_len."""
        size = self.cfg.speech_token_size

        def process(logits, i, recent):
            if produced + i + 1 >= min_len:
                return logits
            vocab = torch.arange(logits.shape[-1], device=logits.device)
            return torch.where((vocab >= size)[None], torch.full_like(logits, -1e30), logits)
        return process

    @staticmethod
    def _draws(noise, chunk: int):
        return None if noise is None else (lambda i: noise(chunk, i + 1))

    @torch.inference_mode()
    def generate(self, text_ids: list[int], prompt_text_ids: list[int],
                 prompt_speech_tokens: list[int], *, seed: int = 0,
                 sampler: SamplerConfig = RAS_SAMPLER, max_new: int | None = None,
                 speculative: str | None = None, gamma: int = 4, noise=None) -> list[int]:
        """Speech tokens for text_ids (EOS and the other specials dropped).
        noise(0, i): the draw i (0 the first token's, i the loop's step
        i − 1), each (2, 1, V) under RAS, instead of the generator's."""
        if speculative is not None:
            raise NotImplementedError(f"speculative decoding {_NOT_PORTED}")
        cfg = self.cfg
        min_len = int(len(text_ids) * cfg.min_token_text_ratio)
        max_len = max_new or max(8, int(len(text_ids) * cfg.max_token_text_ratio))
        max_len = -(-max_len // 32) * 32
        logits, cache, extra = self.prefill(text_ids, prompt_text_ids, prompt_speech_tokens,
                                            max_len + SYNC_EVERY)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        proc = self.processor(min_len)
        recent = torch.full((1, 64), -1, dtype=torch.int64, device=self.device)
        first = sampling.sample(proc(logits, 0, None), sampler, recent, gen,
                                None if noise is None else noise(0, 0))
        res = decode_loop(self.step_fn(extra), cache, first, max_len - 1,
                          eos_ids=(cfg.eos_id,), sampler=sampler, generator=gen,
                          logit_processor=proc, pad_id=cfg.eos_id,
                          noise=self._draws(noise, 0))
        out = [int(first[0])] + res.tokens[0, :int(res.lengths[0])].tolist()
        return [t for t in out if t < cfg.speech_token_size]


class CosyLMStreamer:
    """Chunked generation for token-granularity streaming: the cache, the
    last logits and the RAS/repetition ring carry across chunks on the
    device. first_extra: tokens added to the FIRST chunk only (the flow's
    pre-lookahead, so that the first audio needs one chunk)."""

    def __init__(self, gen: CosyLMGenerator, chunk: int = 25, first_extra: int = 0):
        self.gen = gen
        self.chunk = chunk
        self.first_extra = first_extra

    def _chunk(self, logits, cache, extra, recent, produced: int, min_len: int, size: int,
               sampler: SamplerConfig, gen: torch.Generator, noise, c: int):
        g, eos = self.gen, self.gen.cfg.eos_id
        proc = g.processor(min_len, produced)
        first = sampling.sample(proc(logits, 0, None), sampler, recent, gen,
                                None if noise is None else noise(c, 0))
        recent = sampling.update_recent(recent, first)
        res = decode_loop(g.step_fn(extra), cache, first, size - 1, eos_ids=(eos,),
                          sampler=sampler, generator=gen, logit_processor=proc, pad_id=eos,
                          recent0=recent, noise=g._draws(noise, c))
        tokens = torch.cat([first, res.tokens[0]])
        n = 1 + int(res.lengths[0])
        finished = bool((res.tokens[0] == eos).any() | (first[0] == eos))
        # the next chunk's logits: the last valid token through the stack
        last = first if finished else tokens[max(n - 1, 0)][None]
        next_logits, cache = g.step_fn(extra)(last[None], res.last_state)
        return tokens, n, finished, next_logits, cache, res.recent

    @torch.inference_mode()
    def stream(self, text_ids, prompt_text_ids, prompt_speech_tokens, *,
               sampler: SamplerConfig = RAS_SAMPLER, seed: int = 0, max_new: int | None = None,
               speculative: str | None = None, gamma: int = 4, noise=None):
        """Yields lists of speech tokens (≤ chunk each, the first ≤ chunk +
        first_extra) as they are made. noise(c, i): chunk c's draw i."""
        if speculative is not None:
            raise NotImplementedError(f"speculative decoding {_NOT_PORTED}")
        g, cfg = self.gen, self.gen.cfg
        min_len = int(len(text_ids) * cfg.min_token_text_ratio)
        max_len = max_new or max(8, int(len(text_ids) * cfg.max_token_text_ratio))
        steps = max_len + self.chunk + self.first_extra + SYNC_EVERY
        logits, cache, extra = g.prefill(text_ids, prompt_text_ids, prompt_speech_tokens, steps)
        gen = torch.Generator(device=g.device).manual_seed(seed)
        window = max(sampler.repetition_window, sampler.ras_window, 1)
        recent = torch.full((1, window), -1, dtype=torch.int64, device=g.device)
        produced, c = 0, 0
        while produced < max_len:
            size = self.chunk + (self.first_extra if c == 0 else 0)
            tokens, n, finished, logits, cache, recent = self._chunk(
                logits, cache, extra, recent, produced, min_len, size, sampler, gen, noise, c)
            n = min(n, max_len - produced)
            toks = [t for t in tokens[:n].tolist() if t < cfg.speech_token_size]
            produced += n
            c += 1
            if toks:
                yield toks
            if finished:
                break
