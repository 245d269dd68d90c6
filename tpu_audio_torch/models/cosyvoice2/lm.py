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
to feed the JAX package's draws.

`speculative="ngram"` decodes through `ops/speculative.py` with prompt
lookup over the prompt's speech tokens and the tokens made so far, gamma
drafts verified in one per-layer pass at gamma + 1 rows on the plain cache
(the JAX generator forces it too). The streamer then runs each chunk as a
span of that loop, resumed from the last span's cache, last and
second-last tokens, recent ring and history; with the same draws
(`draws(iteration)`, numbered across spans) its tokens are the one-shot
`generate`'s.

`mesh=` (a `parallel.make_mesh` DeviceMesh with a "tp" axis) serves the
Qwen2 stack tensor-parallel on an fp tree: each rank keeps its megatron
shard (`parallel/tp_quant.local_params`) and all-reduces the row-parallel
sums (`transformer.forward_hidden`'s `axis_name`); embeddings and the
speech head stay whole. A tree with quantised layer leaves runs replicated
on every rank, as in the JAX generator, whose rules match `.weight` leaves
only. Under a mesh every step runs per layer (no whole-stack step).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_audio_torch.convert import params_from_numpy, tree_device
from tpu_audio_torch.nn import layers, transformer
from tpu_audio_torch.ops import sampling
from tpu_audio_torch.ops import speculative as spec
from tpu_audio_torch.ops.decoding import SYNC_EVERY, decode_loop
from tpu_audio_torch.ops.sampling import SamplerConfig
from tpu_audio_torch.parallel import tp_quant

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


def check_speculative(speculative) -> None:
    """Refuse a `speculative=` other than None and "ngram" (the LM drafts
    by prompt lookup; no draft model serves CosyVoice)."""
    if speculative not in (None, "ngram"):
        raise ValueError(f"speculative must be None or 'ngram', got {speculative!r}")


def _quantised_layers(llm: dict) -> bool:
    """Whether any linear of the stack's layers is quantised."""
    def rec(d):
        return any(rec(v) for v in d.values() if isinstance(v, dict)) or (
            "weight" not in d and any(k.startswith("weight_") for k in d))
    return rec(llm["layers"])


def _bucket(n: int) -> int:
    return max(32, -(-n // 32) * 32)


class CosyLMGenerator:
    def __init__(self, params, cfg: CosyLMConfig, max_cache: int | None = None, mesh=None,
                 cache_dtype: torch.dtype = torch.bfloat16):
        """max_cache: the cache's slots, or None (the default) for as many
        as each request needs. mesh: a DeviceMesh with a "tp" axis; the
        stack's config on this rank is then `qwen` (its local heads), the tp
        group `axis` (None where the tree runs replicated)."""
        self.last_spec_stats: dict | None = None
        self.params = dict(params, llm=transformer.fuse_fp_tree(params["llm"]))
        self.cfg = cfg
        self.qwen, self.axis, self.mesh = cfg.qwen, None, mesh
        if mesh is not None:
            group, rank, tp = tp_quant.tp_axis(mesh)
            if not _quantised_layers(self.params["llm"]):
                self.params["llm"] = tp_quant.local_params(self.params["llm"], cfg.qwen, tp, rank)
                self.qwen, self.axis = tp_quant.local_config(cfg.qwen, tp), group
        self.max_cache = max_cache
        self.cache_dtype = cache_dtype
        self.device = tree_device(params)

    def fused_ok(self) -> bool:
        """Whether the T=1 steps run the whole-stack step kernel (never
        under a mesh)."""
        return self.mesh is None and transformer.fused_decode_supported(self.cfg.qwen,
                                                                        self.params["llm"])

    def _hidden(self, x, cache, extra):
        return transformer.forward_hidden(self.params["llm"], self.qwen, x, cache, extra,
                                          axis_name=self.axis)

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
        fused = self.fused_ok() if fused is None else fused and self.mesh is None
        cache, extra = transformer.decode_cache_and_mask(
            self.qwen, self._slots(total, steps), shift, fused, dtype=self.cache_dtype, device=dev)
        hidden, cache = self._hidden(x, cache, extra)
        return self.head(hidden[:, -1]), cache, extra

    def step_fn(self, extra):
        """(token (B, 1), cache) → (logits (B, V) f32, cache): one T=1 step."""
        def step(tok, cache):
            h, cache = self._hidden(self.embed_speech(tok), cache, extra)
            return self.head(h[:, -1]), cache
        return step

    def processor(self, min_len: int, produced: int = 0):
        """Masks the specials (EOS among them) at draw i while
        produced + i + 1 < min_len; i an int, or a 0-d tensor on the device
        (the speculative loop's), which the host never reads."""
        size = self.cfg.speech_token_size

        def process(logits, i, recent):
            below = produced + i + 1 < min_len
            if not isinstance(below, torch.Tensor) and not below:
                return logits
            vocab = torch.arange(logits.shape[-1], device=logits.device)
            return torch.where((vocab >= size)[None] & below, torch.full_like(logits, -1e30),
                               logits)
        return process

    def target_step(self, extra):
        """(tokens (1, T), cache) → (logits (1, T, V) f32, cache): the
        speculative verify, T rows through the stack and the head."""
        def step(toks, cache):
            h, cache = self._hidden(self.embed_speech(toks), cache, extra)
            return self.head(h), cache
        return step

    def spec_history(self, prompt_speech: list[int], width: int):
        """(the n-gram history (1, width) holding the prompt's speech tokens,
        its length, second_last: the last prompt speech token, or -1)."""
        n_s, dev = len(prompt_speech), self.device
        hist = torch.zeros((1, width), dtype=torch.int64, device=dev)
        hist[0, :n_s] = torch.as_tensor(prompt_speech, dtype=torch.int64)
        second = prompt_speech[-1] if n_s else -1
        return (hist, torch.tensor(n_s, device=dev),
                torch.tensor([second], dtype=torch.int64, device=dev))

    def _stats(self, runs) -> dict:
        it, dr, ac = (sum(int(getattr(r, n)) for r in runs)
                      for n in ("iterations", "drafted", "accepted"))
        self.last_spec_stats = {"iterations": it, "drafted": dr, "accepted": ac,
                                "accept_rate": ac / max(dr, 1),
                                "tokens_per_iteration": (ac + it) / it if it else 0.0}
        return self.last_spec_stats

    @staticmethod
    def _draws(noise, chunk: int):
        return None if noise is None else (lambda i: noise(chunk, i + 1))

    @torch.inference_mode()
    def generate(self, text_ids: list[int], prompt_text_ids: list[int],
                 prompt_speech_tokens: list[int], *, seed: int = 0,
                 sampler: SamplerConfig = RAS_SAMPLER, max_new: int | None = None,
                 speculative: str | None = None, gamma: int = 4, noise=None,
                 draws=None) -> list[int]:
        """Speech tokens for text_ids (EOS and the other specials dropped).
        noise(0, i): the draw i (0 the first token's, i the loop's step
        i − 1), each (2, 1, V) under RAS, instead of the generator's.
        speculative "ngram": the speculative loop, its iteration i's draws
        `draws(i)` (`ops/speculative`) instead of the generator's."""
        check_speculative(speculative)
        cfg = self.cfg
        min_len = int(len(text_ids) * cfg.min_token_text_ratio)
        max_len = max_new or max(8, int(len(text_ids) * cfg.max_token_text_ratio))
        max_len = -(-max_len // 32) * 32
        steps = spec.loop_slots(max_len - 1, gamma) if speculative else max_len + SYNC_EVERY
        logits, cache, extra = self.prefill(text_ids, prompt_text_ids, prompt_speech_tokens,
                                            steps, fused=False if speculative else None)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        proc = self.processor(min_len)
        recent = torch.full((1, 64), -1, dtype=torch.int64, device=self.device)
        first = sampling.sample(proc(logits, 0, None), sampler, recent, gen,
                                None if noise is None else noise(0, 0))
        if speculative:
            width = _bucket(len(prompt_speech_tokens)) + max_len + 2 * gamma + 4
            hist, hist_len, second = self.spec_history(prompt_speech_tokens, width)
            res = spec.speculative_decode_loop(
                self.target_step(extra), cache, first, second, max_len - 1, gamma,
                (cfg.eos_id,), sampler, pad_id=cfg.eos_id, history=hist,
                history_len=hist_len, logit_processor=proc, generator=gen, draws=draws)
            self._stats([res])
        else:
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
               speculative: str | None = None, gamma: int = 4, noise=None, draws=None):
        """Yields lists of speech tokens (≤ chunk each, the first ≤ chunk +
        first_extra) as they are made. noise(c, i): chunk c's draw i.
        speculative "ngram": spans of the speculative loop (a span may run
        gamma past its chunk), draws(i) its iteration i's, numbered across
        spans."""
        check_speculative(speculative)
        g, cfg = self.gen, self.gen.cfg
        min_len = int(len(text_ids) * cfg.min_token_text_ratio)
        max_len = max_new or max(8, int(len(text_ids) * cfg.max_token_text_ratio))
        if speculative:
            yield from self._stream_spec(text_ids, prompt_text_ids, prompt_speech_tokens,
                                         min_len, max_len, sampler, seed, gamma, noise, draws)
            return
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

    def _stream_spec(self, text_ids, prompt_text_ids, prompt_speech, min_len: int,
                     max_len: int, sampler: SamplerConfig, seed: int, gamma: int, noise,
                     draws):
        """Token streaming through the speculative loop: the first span
        samples the first token from the prefill's logits and runs the loop
        for chunk + first_extra − 1 more; each later span resumes the
        carried state for `chunk` more, or the fewer left to max_len (where
        the JAX spans run a whole chunk and drop the excess), so the spans
        run the one-shot loop's iterations. Spans end at the first EOS or
        the emission boundary (the buffer pads with EOS). The counters of
        all spans land in the generator's `last_spec_stats`."""
        g, cfg = self.gen, self.gen.cfg
        eos, size = cfg.eos_id, cfg.speech_token_size
        chunk0 = self.chunk + self.first_extra
        logits, cache, extra = g.prefill(text_ids, prompt_text_ids, prompt_speech,
                                         max_len + spec.loop_slots(chunk0, gamma), fused=False)
        gen = torch.Generator(device=g.device).manual_seed(seed)
        recent = torch.full((1, 64), -1, dtype=torch.int64, device=g.device)
        first = sampling.sample(g.processor(min_len)(logits, 0, None), sampler, recent, gen,
                                None if noise is None else noise(0, 0))
        width = -(-(_bucket(len(prompt_speech)) + max_len + chunk0 + 2 * gamma + 8) // 64) * 64
        hist, hist_len, second = g.spec_history(prompt_speech, width)
        common = dict(gamma=gamma, eos_ids=(eos,), sampler=sampler, pad_id=eos,
                      generator=gen, draws=draws)
        res = spec.speculative_decode_loop(
            g.target_step(extra), cache, first, second, min(chunk0, max_len) - 1, history=hist,
            history_len=hist_len, logit_processor=g.processor(min_len), **common)
        runs = [res]
        first_eos = int(first[0]) == eos
        loop = res.tokens[0]
        n = 0 if first_eos else 1 + int((loop == eos).long().argmax())
        tokens = torch.cat([first, loop])
        finished = first_eos or bool(res.finished)
        produced = 0
        while True:
            n = min(n, max_len - produced)
            toks = [t for t in tokens[:n].tolist() if t < size]
            produced += n
            if toks:
                yield toks
            if finished or produced >= max_len:
                break
            res = spec.speculative_decode_loop(
                g.target_step(extra), res.last_state, res.last, res.second_last,
                min(self.chunk, max_len - produced),
                history=res.history, history_len=res.history_len,
                logit_processor=g.processor(min_len, produced - 1), recent0=res.recent,
                append_first_to_history=False, iteration0=sum(int(r.iterations) for r in runs),
                **common)
            runs.append(res)
            tokens = res.tokens[0]
            n = int((tokens == eos).long().argmax())
            finished = bool(res.finished)
        g._stats(runs)
