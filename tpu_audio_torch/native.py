"""The runtime helpers of the JAX package's native layer, in NumPy (port of
tpu_audio/native.py: available, resample, NativeBPE, dtw, RingBuffer).

The port builds no host library: `available()` is False, `resample` and
`dtw` are the NumPy functions the JAX module falls back to
(`ops/resample.resample`, `models/whisper/timing.dtw`), and `NativeBPE`
raises as the JAX class does without its library.

`RingBuffer` is a preallocated single-producer / single-consumer float32
ring. Only `write` moves the write count and only `read` moves the read
count; each stores its count after it has copied the samples, so one
writer thread and one reader thread move every sample once and in order,
without a lock. (The JAX fallback rebinds one array from both sides and
can lose or repeat samples across threads.)
"""

from __future__ import annotations

import numpy as np


def available() -> bool:
    return False


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    from tpu_audio_torch.ops.resample import resample as np_resample

    return np_resample(x, sr_in, sr_out)


class NativeBPE:
    """The JAX package's native merge loop; there is no library here."""

    def __init__(self, ranks: dict[bytes, int]):
        raise RuntimeError("native library unavailable")


def dtw(x: np.ndarray):
    """The alignment path of `models/whisper/timing.dtw`."""
    from tpu_audio_torch.models.whisper.timing import dtw as py_dtw

    return py_dtw(x)


class RingBuffer:
    """SPSC float32 ring of `capacity` samples for the playback sinks.

    `_written` and `_read` are monotonic sample counts; the ring holds
    `_written - _read` samples. The producer reads `_read` and stores
    `_written`; the consumer reads `_written` and stores `_read`. A Python
    int store is atomic, and each side publishes its count only after its
    copy, so the other side never sees a slot before it is filled (read)
    or after it is freed (write)."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._capacity = int(capacity)
        self._buf = np.zeros(self._capacity, np.float32)
        self._written = 0
        self._read = 0

    @property
    def capacity(self) -> int:
        return self._capacity

    def _copy_in(self, start: int, data: np.ndarray) -> None:
        i = start % self._capacity
        head = min(len(data), self._capacity - i)
        self._buf[i:i + head] = data[:head]
        self._buf[:len(data) - head] = data[head:]

    def write(self, data: np.ndarray) -> int:
        """Copy as much of `data` as there is room for; returns the count."""
        data = np.ascontiguousarray(data, np.float32).reshape(-1)
        w = self._written
        todo = min(self._capacity - (w - self._read), len(data))
        if todo > 0:
            self._copy_in(w, data[:todo])
            self._written = w + todo
        return max(todo, 0)

    def read(self, n: int) -> np.ndarray:
        """Take up to n samples (fewer when fewer are queued)."""
        r = self._read
        got = min(int(n), self._written - r)
        if got <= 0:
            return np.zeros(0, np.float32)
        i = r % self._capacity
        head = min(got, self._capacity - i)
        out = np.empty(got, np.float32)
        out[:head] = self._buf[i:i + head]
        out[head:] = self._buf[:got - head]
        self._read = r + got
        return out

    @property
    def available(self) -> int:
        return self._written - self._read
