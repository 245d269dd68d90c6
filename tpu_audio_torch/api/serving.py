"""Continuous batching for the shared LLM decode path (port of
tpu_audio/api/serving.py: Request, ContinuousBatcher).

`CausalLMGenerator.generate_batch` runs a static batch until its slowest
row finishes; a server then pays head-of-line blocking. ContinuousBatcher
keeps a static batch of B rows decoding in spans of `span` steps and
refills a finished row from the request queue between spans.

How admission stays exact: all rows decode in lockstep and share the
cache's write position P. A request with an n-token prompt admitted at P
is prefilled into a 1-row scratch cache at slots [P-pad, P), its left pad
key-masked and its RoPE positions offset so that its first real token
sits at position 0; that KV window is then copied into the batch row in
place. Each row's key mask starts at its own first real slot
(`row_start`) and RoPE sees `slot - row_start`, so the row decodes as a
fresh single-stream `generate` of its prompt: greedy rows give
`generate`'s tokens. Sampled rows draw from one `torch.Generator` seeded
with `seed` on the generator's device: the sampler's distribution, not
the JAX batcher's bitstream. The batch runs on the generator's device.

The scratch cache is allocated once: an admission writes its window and
masks every slot below its `row_start`, so older windows are never read.

Capacity: the batch shares one ring of `gen.max_cache` slots (a generator
built with `max_cache=None` is refused). A request is admitted only while
P + ceil((max_new - 1) / span) * span + 1 ≤ max_cache, so no row in
flight ever decodes past the ring; one that does not fit waits. The JAX
batcher checks one span at admission and then decodes past its ring,
clamping the writes (ROADMAP C26). When no row is in flight, P moves to
where the head of the queue fits (forward past its prompt window, or
back from a spent ring: every row's mask starts at its own `row_start`
and slots past P are causally masked), so `run_until_idle` and
`while step()` end; the JAX batcher's idle position never rewinds and
`step()` returns True forever with the request queued (C27). A request
that would not fit even an empty ring is refused at `submit`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_audio_torch.nn import attention, transformer
from tpu_audio_torch.ops import sampling
from tpu_audio_torch.ops.decoding import decode_loop
from tpu_audio_torch.ops.sampling import SamplerConfig


@dataclass
class Request:
    prompt_ids: list[int]
    max_new: int = 256
    arrival: float = 0.0  # host clock, for latency accounting
    # filled on completion:
    tokens: list[int] = field(default_factory=list)
    done: bool = False
    first_token_at: float | None = None
    done_at: float | None = None


class ContinuousBatcher:
    """Rolling-admission batch decoder over a CausalLMGenerator's params.

    Usage:
        batcher = ContinuousBatcher(gen, batch=8, span=16, sampler=...,
                                    eos_ids=(eos,))
        batcher.submit(Request(prompt_ids, max_new=400))
        batcher.run_until_idle()   # or step() in a serving loop
    """

    def __init__(self, gen, batch: int, span: int, sampler: SamplerConfig, eos_ids: tuple,
                 prompt_bucket: int = 64, seed: int = 0):
        if gen.max_cache is None:
            raise ValueError("ContinuousBatcher needs a CausalLMGenerator built with "
                             "max_cache=<slots>: its rows share one ring of max_cache slots")
        self.gen = gen
        self.b = batch
        self.span = span
        self.sampler = sampler
        self.eos_ids = tuple(eos_ids)
        self.bucket = prompt_bucket
        self.ring = gen.max_cache
        self.device = gen.device
        window = max(sampler.repetition_window, sampler.ras_window, 1)
        dev, cfg = self.device, gen.cfg
        with torch.inference_mode():
            self.generator = torch.Generator(device=dev).manual_seed(seed)
            self.cache = transformer.make_cache(cfg, batch, self.ring, gen.cache_dtype,
                                                device=dev)
            self._scratch = transformer.make_cache(cfg, 1, self.ring, gen.cache_dtype,
                                                   device=dev)
            self._slot = torch.arange(self.ring, device=dev)
            self._zero = torch.zeros((), dtype=torch.float32, device=dev)
            # per-row state on the device: first real KV slot, last token, recent ring
            self.row_start = torch.zeros(batch, dtype=torch.int64, device=dev)
            self.last = torch.zeros(batch, dtype=torch.int64, device=dev)
            self.recent = torch.full((batch, window), -1, dtype=torch.int64, device=dev)
        self.pos = 0  # host mirror of the cache's write position P
        self.row_req: list[Request | None] = [None] * batch
        self.active = np.zeros(batch, bool)
        self.queue: list[Request] = []
        self.completed: list[Request] = []

    # ---------------------------------------------------------------- rules

    def _pad(self, req: Request) -> int:
        return -(-len(req.prompt_ids) // self.bucket) * self.bucket

    def _need(self, req: Request) -> int:
        """Ring slots from P that the request's decode may write, plus one."""
        spans = -(-(req.max_new - 1) // self.span) if req.max_new > 1 else 0
        return spans * self.span + 1

    def _mask(self, row_start: torch.Tensor) -> torch.Tensor:
        """(R, 1, 1, ring) additive mask hiding each row's slots below its start."""
        return torch.where(self._slot[None] >= row_start[:, None], self._zero,
                           attention.NEG_INF)[:, None, None, :]

    def _set_pos(self, pos: int) -> None:
        self.pos = pos
        self.cache.pos.fill_(pos)

    def _copy_window(self, row: int, lo: int, hi: int) -> None:
        """The admitted prompt's KV slots [lo, hi) from the scratch into the row."""
        self.cache.k[:, row, lo:hi] = self._scratch.k[:, 0, lo:hi]
        self.cache.v[:, row, lo:hi] = self._scratch.v[:, 0, lo:hi]

    # ---------------------------------------------------------------- queue

    def submit(self, req: Request) -> None:
        if self._pad(req) + self._need(req) > self.ring:
            raise ValueError(
                f"a prompt of {len(req.prompt_ids)} tokens (bucket {self._pad(req)}) with "
                f"max_new {req.max_new} in spans of {self.span} needs "
                f"{self._pad(req) + self._need(req)} slots; the ring (max_cache) holds "
                f"{self.ring}")
        req.arrival = req.arrival or time.perf_counter()
        self.queue.append(req)

    def _admit(self, row: int, req: Request) -> None:
        gen, n, pad, p = self.gen, len(req.prompt_ids), self._pad(req), self.pos
        prompt = torch.full((1, pad), gen.pad_id, dtype=torch.int64)
        prompt[0, pad - n:] = torch.as_tensor(req.prompt_ids, dtype=torch.int64)
        start = torch.tensor([p - n], dtype=torch.int64, device=self.device)
        self._scratch.pos.fill_(p - pad)
        logits, _ = transformer.forward(gen.params, gen.cfg, prompt.to(self.device),
                                        self._scratch, extra_mask=self._mask(start),
                                        pos_offset=start)
        first = sampling.sample(logits[:, -1].float(), self.sampler, None, self.generator)
        self._copy_window(row, p - pad, p)
        self.row_start[row] = p - n
        self.recent[row] = -1
        self.recent[row, -1] = first[0]
        self.last[row] = first[0]
        first = int(first[0])
        req.first_token_at = time.perf_counter()
        self.row_req[row] = req
        self.active[row] = True
        if first in self.eos_ids:
            self._finish_row(row)
            return
        req.tokens.append(first)
        if len(req.tokens) >= req.max_new:
            self._finish_row(row)

    def _try_admit(self) -> None:
        for row in range(self.b):
            if self.active[row] or not self.queue:
                continue
            req = self.queue[0]
            pad, need = self._pad(req), self._need(req)
            if not self.active.any() and (pad > self.pos or self.pos + need > self.ring):
                self._set_pos(pad)
            if pad > self.pos or self.pos + need > self.ring:
                return  # rows in flight: wait for P to grow, or for them to drain
            self.queue.pop(0)
            self._admit(row, req)

    def _finish_row(self, row: int) -> None:
        req = self.row_req[row]
        req.done = True
        req.done_at = time.perf_counter()
        self.completed.append(req)
        self.row_req[row] = None
        self.active[row] = False

    # ----------------------------------------------------------------- loop

    @torch.inference_mode()
    def step(self) -> bool:
        """Admit waiting requests, then decode one span. Returns True while
        any work remains queued or in flight."""
        self._try_admit()
        if not self.active.any():
            return bool(self.queue)
        finished = torch.as_tensor(~self.active, device=self.device)
        # early_exit=False: the span writes exactly `span` slots of every row,
        # so P stays aligned for the next admission
        res = decode_loop(self.gen._step(self._mask(self.row_start), self.row_start),
                          self.cache, self.last, self.span, eos_ids=self.eos_ids,
                          sampler=self.sampler, generator=self.generator,
                          pad_id=self.gen.pad_id, recent0=self.recent, finished0=finished,
                          early_exit=False)
        self.recent, self.last = res.recent, res.last_token
        tokens, lengths = res.tokens.tolist(), res.lengths.tolist()
        fin = res.finished.tolist()
        self.pos += self.span
        for row in range(self.b):
            if not self.active[row]:
                continue
            req = self.row_req[row]
            room = req.max_new - len(req.tokens)
            req.tokens.extend(tokens[row][:min(lengths[row], room)])
            if fin[row] or len(req.tokens) >= req.max_new:
                self._finish_row(row)
        return bool(self.queue) or bool(self.active.any())

    def run_until_idle(self, max_spans: int = 10_000) -> list[Request]:
        for _ in range(max_spans):
            if not self.step():
                break
        return self.completed
