"""Analysis windows used by the speech front-ends.

Computed in float64 NumPy at trace time (they're static constants) and cast
at use sites. Conventions match the reference formulas:
  - symmetric Hann: package/STT/Whisper/WhisperAudio.swift:31-45
  - periodic Hann (hanning(N+1)[:N]): package/Codec/S3Gen/Mel/S3GenMel.swift:71
  - Hamming: package/STT/FunASR/FunASRAudio.swift:35-46
  - Povey (hann^0.85, Kaldi): package/Codec/S3Gen/CAMPPlus.swift:14-19
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def hann(length: int, periodic: bool = False) -> np.ndarray:
    """Symmetric (numpy.hanning-style) or periodic Hann window."""
    if length == 1:
        return np.ones(1, dtype=np.float32)
    denom = length if periodic else length - 1
    n = np.arange(length, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / denom))
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def hamming(length: int) -> np.ndarray:
    if length == 1:
        return np.ones(1, dtype=np.float32)
    n = np.arange(length, dtype=np.float64)
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (length - 1))
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def povey(length: int) -> np.ndarray:
    """Kaldi's Povey window: symmetric Hann raised to the 0.85 power."""
    n = np.arange(length, dtype=np.float64)
    w = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length - 1))) ** 0.85
    return w.astype(np.float32)


def get_window(name: str, length: int) -> np.ndarray:
    if name == "hann":
        return hann(length)
    if name == "hann_periodic":
        return hann(length, periodic=True)
    if name == "hamming":
        return hamming(length)
    if name == "povey":
        return povey(length)
    raise ValueError(f"unknown window {name!r}")
