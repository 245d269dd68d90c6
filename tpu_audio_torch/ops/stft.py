"""STFT primitives (port of tpu_audio/ops/stft.py: dft_basis, frame,
stft_power).

The rFFT is a dense DFT matrix product, as in the JAX module; the fused
log-mel kernel's plain version (`kernels/fused_mel.py`) keeps that
formulation, and its CUDA kernel takes an FFT of each frame instead.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def dft_basis(n_fft: int) -> np.ndarray:
    """Real-DFT basis, shape (n_fft, 2*K) with K = n_fft//2 + 1.

    columns [0:K] are cos(2πkn/N), columns [K:2K] are -sin(2πkn/N), so
    frames @ basis yields [real | imag] of the one-sided spectrum.
    """
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    n = np.arange(n_fft, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def frame(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Slice (..., T) into overlapping frames (..., num_frames, n_fft)."""
    t = x.shape[-1]
    if t < n_fft:
        raise ValueError(f"input length {t} too short for n_fft={n_fft}")
    return x.unfold(-1, n_fft, hop)


def stft_power(x: torch.Tensor, window: np.ndarray, n_fft: int,
               hop: int) -> torch.Tensor:
    """Power spectrogram of (T,) or (B, T) → (..., frames, K), f32, with
    n_fft//2 samples of reflect padding on each side (centered frames)."""
    pad = n_fft // 2
    x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad),
              mode="reflect").reshape(*x.shape[:-1], -1)
    w = torch.zeros(n_fft, dtype=torch.float32, device=x.device)
    w[: len(window)] = torch.as_tensor(window, dtype=torch.float32)
    frames = frame(x.float(), n_fft, hop) * w
    basis = torch.as_tensor(dft_basis(n_fft), device=x.device)
    spec = frames @ basis
    k = n_fft // 2 + 1
    return spec[..., :k] ** 2 + spec[..., k:] ** 2
