"""Orpheus TTS: a Llama-3.2-3B LM emitting 7-token SNAC frames (port of
tpu_audio/models/orpheus/model.py: the token constants, LLAMA_3B,
build_prompt_ids, CausalLMGenerator, parse_frames).

`CausalLMGenerator` is the shared prefill + decode of any Llama-family
config over `nn/transformer.py`: `generate` (one stream; with
`should_stop`, in spans the host can cancel between), `stream_spans`
(token-granularity serving), `generate_batch` (B streams in one loop) and
`generate_speculative` (drafts verified gamma + 1 at a time,
`ops/speculative.py`: by prompt lookup, or by a `DraftModel` of the same
vocabulary).
Prompts are LEFT-padded to a bucket, the pad key slots masked, and
`pos_offset` gives RoPE the canonical positions 0, 1, 2, …, as in the JAX
generator. A single stream runs the whole-stack step kernel where
`transformer.fused_decode_supported` holds (bf16 and int8 trees); W4A8
trees decode layer by layer through the W4A8 kernels, as in the JAX
package.

The loops run eagerly with their state on the device (`ops/decoding`).
Sampling draws from one `torch.Generator` seeded with `seed`: first the
prefill's token, then one draw per step, so `stream_spans` and `generate`
give the same stream for a seed. JAX's PRNG draws cannot be reproduced:
parity is tested greedily. The cache holds `max_cache` slots, or with None
as many as each request needs.

The speculative target runs on the plain cache, so a verify is one
per-layer pass at gamma + 1 rows (the int8 and W4A8 matmuls at that row
count), as the JAX generator forces it; only the draft's T = 1 and T = 2
steps ride the whole-stack step kernel, where it serves the draft's tree.

`mesh=` (a `parallel.make_mesh` DeviceMesh with a "tp" axis) serves the
stack tensor-parallel, by one route for fp and quantised trees: each rank
keeps its contiguous megatron shard (`parallel/tp_quant.local_params`),
runs the layers at `local_config`'s head counts through the same kernels on
its local shapes, with a KV cache of its local heads, and all-reduces the
row-parallel partial sums over the tp group (`transformer.forward_hidden`'s
`axis_name`). The JAX generator has two modes (GSPMD for fp trees,
`shard_map` for quantised ones); the port's one route is the second. Under
a mesh the whole-stack step is off (every step runs per layer, as in JAX),
and a draft model runs replicated, without the group. Every rank emits the
same token: the all-reduce leaves the same hidden state, hence the same
logits, on every rank, and every rank's `torch.Generator` is seeded with
the same `seed`, so each draws the same sample.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_audio_torch.convert import tree_device
from tpu_audio_torch.nn import attention, transformer
from tpu_audio_torch.ops import sampling, speculative
from tpu_audio_torch.ops.decoding import decode_loop
from tpu_audio_torch.ops.sampling import SamplerConfig
from tpu_audio_torch.parallel import tp_quant

SAMPLE_RATE = 24000
MAX_TOKENS = 1200
START_TOKEN = 128259
END_TOKEN = 128258
PAD_TOKEN = 128263
AUDIO_START_TOKEN = 128261
AUDIO_END_TOKEN = 128262
VOICE_PREFIX_TOKEN = 128260
TEXT_END_TOKEN = 128009
CODE_OFFSET = 128266
AUDIO_MARKER = 128257
CODEBOOK_SIZE = 4096
REPETITION_WINDOW = 20

VOICES = ["tara", "leah", "jess", "leo", "dan", "mia", "zac", "zoe"]
EXPRESSION_TAGS = ["<laugh>", "<chuckle>", "<sigh>", "<cough>", "<sniffle>",
                   "<groan>", "<yawn>", "<gasp>"]

# Llama-3.2-3B architecture (orpheus-3b-0.1-ft)
LLAMA_3B = transformer.TransformerConfig(
    dim=3072, n_layers=28, n_heads=24, n_kv_heads=8, head_dim=128,
    hidden_dim=8192, vocab_size=156940, rope_theta=500000.0,
    rope_scaling={"rope_type": "llama3", "factor": 32.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192},
    norm_eps=1e-5, tie_word_embeddings=True)


def build_prompt_ids(text_ids: list[int]) -> list[int]:
    """[start] + text + [text_end, voice_prefix]."""
    return [START_TOKEN] + list(text_ids) + [TEXT_END_TOKEN, VOICE_PREFIX_TOKEN]


@dataclass
class DraftModel:
    """A small model of the target's vocabulary that drafts tokens for
    speculative decoding (e.g. a Llama-3.2-1B for the 3B Orpheus); its tree
    bf16 or quantised. Its cache is sized for each request, or holds
    `max_cache` slots and refuses a request past them."""

    params: dict = field(repr=False)
    cfg: transformer.TransformerConfig
    max_cache: int | None = None

    def __post_init__(self):
        self.params = transformer.fuse_fp_tree(self.params)


class CausalLMGenerator:
    """Prefill + decode over `nn/transformer.py` for a Llama-family config;
    shared by the LLM TTS engines. fp q/k/v and gate/up leaves are fused
    (quantised trees arrive fused). Under `mesh` the tree becomes this
    rank's shard (`params`), `cfg_run` its local config and `axis` the tp
    process group; without one `cfg_run` is `cfg` and `axis` None."""

    def __init__(self, params, cfg: transformer.TransformerConfig,
                 max_cache: int | None = 2048, pad_id: int = 0,
                 cache_dtype: torch.dtype = torch.bfloat16, mesh=None):
        self.cfg = self.cfg_run = cfg
        self.mesh = mesh
        self.axis = None
        self.last_spec_stats: dict | None = None
        self.max_cache = max_cache
        self.pad_id = pad_id
        self.cache_dtype = cache_dtype
        self.params = transformer.fuse_fp_tree(params)
        if mesh is not None:
            self.axis, rank, tp = tp_quant.tp_axis(mesh)
            self.params = tp_quant.local_params(self.params, cfg, tp, rank)
            self.cfg_run = tp_quant.local_config(cfg, tp)
        self.device = tree_device(params)

    # ------------------------------------------------------------ helpers

    def _fused_ok(self) -> bool:
        """Whole-stack step eligibility (single stream, no mesh)."""
        return self.mesh is None and transformer.fused_decode_supported(self.cfg, self.params)

    def _forward(self, tokens, cache, extra, off):
        return transformer.forward(self.params, self.cfg_run, tokens, cache, extra_mask=extra,
                                   axis_name=self.axis, pos_offset=off)

    @staticmethod
    def _fit(max_cache: int | None, prompt_pad: int, steps: int) -> int:
        need = prompt_pad + steps
        if max_cache is None:
            return need
        if need > max_cache:
            raise ValueError(f"a prompt of {prompt_pad} slots + {steps} decode steps exceeds "
                             f"max_cache {max_cache}")
        return max_cache

    def _slots(self, prompt_pad: int, steps: int) -> int:
        """Cache slots for a prompt bucket and `steps` decode steps."""
        return self._fit(self.max_cache, prompt_pad, steps)

    def _prompt(self, prompt_ids: list[int], bucket: int) -> tuple[torch.Tensor, int]:
        """(the left-padded prompt (pad,), its pad amount)."""
        n = len(prompt_ids)
        pad = -(-n // bucket) * bucket
        prompt = torch.full((pad,), self.pad_id, dtype=torch.int64)
        prompt[pad - n:] = torch.as_tensor(prompt_ids, dtype=torch.int64)
        return prompt.to(self.device), pad - n

    def _prefill(self, prompt: torch.Tensor, start: int, slots: int, sampler: SamplerConfig,
                 gen: torch.Generator):
        """The prompt through the stack: (first token (1,), cache, extra
        mask, pos_offset). A single-stream cache in the whole-stack step's
        layout where that step serves the tree."""
        cache, extra = transformer.decode_cache_and_mask(
            self.cfg_run, slots, start, self._fused_ok(), dtype=self.cache_dtype,
            device=self.device)
        off = torch.tensor([start], device=self.device)
        logits, cache = self._forward(prompt[None], cache, extra, off)
        first = sampling.sample(logits[:, -1].float(), sampler, None, gen)
        return first, cache, extra, off

    def _step(self, extra, off):
        def step(tok, cache):
            lg, cache = self._forward(tok, cache, extra, off)
            return lg[:, -1].float(), cache
        return step

    # ------------------------------------------------------------ single

    @torch.inference_mode()
    def generate(self, prompt_ids: list[int], *, sampler: SamplerConfig, eos_ids: tuple,
                 max_new: int, seed: int = 0, bucket: int = 32, should_stop=None,
                 span: int = 32) -> list[int]:
        """Generated ids (EOS excluded; [] when the first token is one).
        should_stop: a callable checked between decode spans of `span`
        tokens (cancellation); None decodes in one loop."""
        if should_stop is not None:
            out: list[int] = []
            for toks in self.stream_spans(prompt_ids, sampler=sampler, eos_ids=eos_ids,
                                          max_new=max_new, seed=seed, bucket=bucket,
                                          should_stop=should_stop, span=span):
                out.extend(toks)
            return out
        prompt, start = self._prompt(prompt_ids, bucket)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        slots = self._slots(prompt.shape[0], max_new)
        first, cache, extra, off = self._prefill(prompt, start, slots, sampler, gen)
        res = decode_loop(self._step(extra, off), cache, first, max_new - 1, eos_ids=eos_ids,
                          sampler=sampler, generator=gen, pad_id=self.pad_id)
        first = int(first[0])
        if first in eos_ids:
            return []
        return [first] + res.tokens[0, :int(res.lengths[0])].tolist()

    @torch.inference_mode()
    def stream_spans(self, prompt_ids: list[int], *, sampler: SamplerConfig, eos_ids: tuple,
                     max_new: int, seed: int = 0, bucket: int = 32, should_stop=None,
                     span: int = 32):
        """Yield the generated ids one `span`-step decode at a time. The
        cache, the repetition window and the finished flag carry across
        spans on the device, so the stream equals `generate`'s."""
        prompt, start = self._prompt(prompt_ids, bucket)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        spans = -(-(max_new - 1) // span) if max_new > 1 else 0
        slots = self._slots(prompt.shape[0], 1 + spans * span)
        first, cache, extra, off = self._prefill(prompt, start, slots, sampler, gen)
        if int(first[0]) in eos_ids:
            return
        window = max(sampler.repetition_window, sampler.ras_window, 1)
        recent = sampling.update_recent(
            torch.full((1, window), -1, dtype=torch.int64, device=self.device), first)
        finished = torch.zeros(1, dtype=torch.bool, device=self.device)
        last = first
        step = self._step(extra, off)
        pending = [int(first[0])]
        remaining = max_new - 1
        while remaining > 0 and (should_stop is None or not should_stop()):
            res = decode_loop(step, cache, last, span, eos_ids=eos_ids, sampler=sampler,
                              generator=gen, pad_id=self.pad_id, recent0=recent,
                              finished0=finished)
            got = min(int(res.lengths[0]), remaining)
            pending.extend(res.tokens[0, :got].tolist())
            remaining -= span
            cache, recent, finished, last = (res.last_state, res.recent, res.finished,
                                             res.last_token)
            if pending:
                yield pending
                pending = []
            if bool(finished[0]):
                return
        if pending:
            yield pending

    # ------------------------------------------------------------ batch

    @torch.inference_mode()
    def generate_batch(self, prompts: list[list[int]], *, sampler: SamplerConfig,
                       eos_ids: tuple, max_new: int, seed: int = 0,
                       bucket: int = 32) -> list[list[int]]:
        """Decode B prompts in one loop: the weights stream once a step for
        the whole batch; rows finish on their own EOS and all run until the
        slowest. Each row left-padded, its pad slots masked, its positions
        offset."""
        b = len(prompts)
        n_max = max(len(p) for p in prompts)
        pad = -(-n_max // bucket) * bucket
        arr = torch.full((b, pad), self.pad_id, dtype=torch.int64)
        pad_amounts = torch.zeros(b, dtype=torch.int64)
        for r, ids in enumerate(prompts):
            arr[r, pad - len(ids):] = torch.as_tensor(ids, dtype=torch.int64)
            pad_amounts[r] = pad - len(ids)
        arr, off = arr.to(self.device), pad_amounts.to(self.device)
        slots = self._slots(pad, max_new)
        cache = transformer.make_cache(self.cfg_run, b, slots, self.cache_dtype,
                                       device=self.device)
        slot = torch.arange(slots, device=self.device)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        extra = torch.where(slot[None] >= off[:, None], zero,
                            attention.NEG_INF)[:, None, None, :]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        logits, cache = self._forward(arr, cache, extra, off)
        first = sampling.sample(logits[:, -1].float(), sampler, None, gen)
        res = decode_loop(self._step(extra, off), cache, first, max_new - 1, eos_ids=eos_ids,
                          sampler=sampler, generator=gen, pad_id=self.pad_id)
        firsts = first.tolist()
        tokens, lengths = res.tokens.tolist(), res.lengths.tolist()
        return [[] if firsts[r] in eos_ids else [firsts[r]] + tokens[r][:lengths[r]]
                for r in range(b)]

    # ------------------------------------------------------------ speculative

    def _target_step(self, extra, off):
        def step(toks, cache):
            lg, cache = self._forward(toks, cache, extra, off)
            return lg.float(), cache
        return step

    @torch.inference_mode()
    def generate_speculative(self, prompt_ids: list[int], *, sampler: SamplerConfig,
                             eos_ids: tuple, max_new: int, seed: int = 0, bucket: int = 32,
                             gamma: int = 5, draft: DraftModel | None = None,
                             draws=None) -> list[int]:
        """`generate`, emitting up to gamma + 1 tokens a target pass: every
        token has exactly the sampler's distribution (repetition penalty
        and RAS included), though not `generate`'s stream for a seed.
        draft None drafts by prompt lookup, a DraftModel by its model.
        draws(i): iteration i's draws (`ops/speculative`) instead of the
        generator's. The counters of the call land in `last_spec_stats`."""
        prompt, start = self._prompt(prompt_ids, bucket)
        pad = prompt.shape[0]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        steps = speculative.loop_slots(max_new - 1, gamma)
        dev = self.device
        cache, extra = transformer.decode_cache_and_mask(
            self.cfg_run, self._slots(pad, steps), start, False, dtype=self.cache_dtype,
            device=dev)
        off = torch.tensor([start], device=dev)
        logits, cache = self._forward(prompt[None], cache, extra, off)
        first = sampling.sample(logits[:, -1].float(), sampler, None, gen)
        common = dict(max_new_tokens=max_new - 1, gamma=gamma, eos_ids=eos_ids,
                      sampler=sampler, pad_id=self.pad_id, generator=gen, draws=draws)
        if draft is not None:
            # replicated under a mesh (no group), and per layer there, as in JAX
            d_fused = self.mesh is None and transformer.fused_decode_supported(draft.cfg,
                                                                              draft.params)
            d_cache, d_extra = transformer.decode_cache_and_mask(
                draft.cfg, self._fit(draft.max_cache, pad, steps), start, d_fused,
                dtype=self.cache_dtype, device=dev)
            _, d_cache = transformer.forward(draft.params, draft.cfg, prompt[None], d_cache,
                                             extra_mask=d_extra, pos_offset=off)
            d_cache.pos -= 1  # the first 2-token draft step re-writes the last prompt slot

            def d_step(toks, c):
                lg, c = transformer.forward(draft.params, draft.cfg, toks, c,
                                            extra_mask=d_extra, pos_offset=off)
                return lg.float(), c

            res = speculative.speculative_decode_loop(
                self._target_step(extra, off), cache, first, prompt[-1:],
                draft_step=d_step, draft_cache=d_cache, **common)
        else:
            hist = torch.zeros((1, pad + max_new + 2 * gamma + 4), dtype=torch.int64, device=dev)
            hist[0, :pad] = torch.roll(prompt, -start)
            res = speculative.speculative_decode_loop(
                self._target_step(extra, off), cache, first, prompt[-1:], history=hist,
                history_len=torch.tensor(pad - start, device=dev), **common)
        it, dr, ac = int(res.iterations), int(res.drafted), int(res.accepted)
        self.last_spec_stats = {"iterations": it, "drafted": dr, "accepted": ac,
                                "accept_rate": ac / dr if dr else 0.0,
                                "tokens_per_iteration": (ac + it) / it if it else 0.0}
        first = int(first[0])
        if first in eos_ids:
            return []
        return [first] + res.tokens[0, :int(res.lengths[0])].tolist()


def parse_frames(tokens: list[int]) -> list[np.ndarray]:
    """7-token frames → the 3 SNAC code layers (after the last audio
    marker; codes clipped to the codebook)."""
    if AUDIO_MARKER in tokens:
        tokens = tokens[len(tokens) - tokens[::-1].index(AUDIO_MARKER):]
    toks = [t - CODE_OFFSET for t in tokens if t != END_TOKEN and t >= CODE_OFFSET]
    n = len(toks) // 7 * 7
    toks = np.asarray(toks[:n], np.int64).reshape(-1, 7)
    l1 = toks[:, 0]
    l2 = np.stack([toks[:, 1] - CODEBOOK_SIZE, toks[:, 4] - 4 * CODEBOOK_SIZE], 1).reshape(-1)
    l3 = np.stack([toks[:, 2] - 2 * CODEBOOK_SIZE, toks[:, 3] - 3 * CODEBOOK_SIZE,
                   toks[:, 5] - 5 * CODEBOOK_SIZE, toks[:, 6] - 6 * CODEBOOK_SIZE],
                  1).reshape(-1)

    def clip(a):
        return np.clip(a, 0, CODEBOOK_SIZE - 1).astype(np.int32)
    return [clip(l1), clip(l2), clip(l3)]
