"""Stage timers and optional device traces (port of
tpu_audio/utils/profiling.py: StageStats, Profiler, device_trace).

A launch on a CUDA device returns before the card has run it, so a host
clock around a stage of CUDA work measures the enqueue, not the work. A
`Profiler` given a CUDA device therefore times each stage between two
CUDA events recorded on the current stream, and reads them (waiting for
the card) only at `summary()`; a stage on the CPU is timed by the host
clock. `device_trace` takes a `torch.profiler` trace where
`TPU_AUDIO_TRACE_DIR` is set.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


@dataclass
class StageStats:
    total_s: float = 0.0
    count: int = 0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


@dataclass
class Profiler:
    """Accumulating per-stage timers: CUDA events on `device` where it is a
    CUDA device, else the host's perf_counter."""

    device: object = None
    stages: dict = field(default_factory=lambda: defaultdict(StageStats))
    _pending: list = field(default_factory=list, init=False, repr=False)

    def _on_card(self) -> bool:
        return self.device is not None and torch.device(self.device).type == "cuda"

    @contextlib.contextmanager
    def time(self, stage: str):
        if self._on_card():
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            try:
                yield
            finally:
                end.record()
                self._pending.append((stage, start, end))
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(stage, time.perf_counter() - t0)

    def record(self, stage: str, seconds: float) -> None:
        s = self.stages[stage]
        s.total_s += seconds
        s.count += 1

    def _resolve(self) -> None:
        for stage, start, end in self._pending:
            end.synchronize()
            self.record(stage, start.elapsed_time(end) / 1e3)
        self._pending.clear()

    def summary(self) -> dict:
        self._resolve()
        return {k: {"total_s": v.total_s, "count": v.count, "mean_s": v.mean_s}
                for k, v in self.stages.items()}

    def reset(self) -> None:
        self._pending.clear()
        self.stages.clear()


@contextlib.contextmanager
def device_trace(name: str = "tpu_audio_torch"):
    """A torch.profiler trace of the block, written as a Chrome trace to
    $TPU_AUDIO_TRACE_DIR/{name}.json, if that variable is set."""
    trace_dir = os.environ.get("TPU_AUDIO_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
