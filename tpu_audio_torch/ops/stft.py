"""STFT primitives (port of tpu_audio/ops/stft.py: dft_basis, frame,
stft_power, stft_complex, overlap_add, window_sumsquare).

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


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """(..., T) with `pad` samples of reflect padding on each side."""
    return F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad),
                 mode="reflect").reshape(*x.shape[:-1], -1)


def stft_power(x: torch.Tensor, window: np.ndarray, n_fft: int,
               hop: int, center: bool = True, magnitude: bool = False) -> torch.Tensor:
    """Power (or, with magnitude, magnitude) spectrogram of (..., T) →
    (..., frames, K), f32; center: n_fft//2 samples of reflect padding on
    each side (centered frames)."""
    if center:
        x = reflect_pad(x, n_fft // 2)
    w = torch.zeros(n_fft, dtype=torch.float32, device=x.device)
    w[: len(window)] = torch.as_tensor(window, dtype=torch.float32)
    frames = frame(x.float(), n_fft, hop) * w
    basis = torch.as_tensor(dft_basis(n_fft), device=x.device)
    spec = frames @ basis
    k = n_fft // 2 + 1
    power = spec[..., :k] ** 2 + spec[..., k:] ** 2
    return torch.sqrt(power) if magnitude else power


def stft_complex(x: torch.Tensor, window: np.ndarray, n_fft: int, hop: int,
                 center: bool = True) -> torch.Tensor:
    """Complex one-sided STFT of (..., T) → complex64 (..., frames, K), by
    `torch.fft.rfft` of the windowed frames."""
    if center:
        x = reflect_pad(x, n_fft // 2)
    w = torch.zeros(n_fft, dtype=torch.float32, device=x.device)
    w[: len(window)] = torch.as_tensor(window, dtype=torch.float32)
    return torch.fft.rfft(frame(x.float(), n_fft, hop) * w, dim=-1)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, NF, n_fft) → (B, (NF − 1)·hop + n_fft), hop dividing n_fft: each
    sample gets its n_fft / hop frames' terms."""
    b, nf, n_fft = frames.shape
    out = frames.new_zeros((b, (nf - 1) * hop + n_fft))
    for m in range(n_fft // hop):
        out[:, m * hop: m * hop + nf * hop] += frames[:, :, m * hop: (m + 1) * hop].reshape(b, -1)
    return out


def window_sumsquare(window: np.ndarray, num_frames: int, hop: int, n_fft: int) -> np.ndarray:
    """The squared window's overlap-added sum, (num_frames − 1)·hop + n_fft
    samples, float64 (the iSTFT's normalisation)."""
    w = np.zeros(n_fft, np.float64)
    w[: len(window)] = np.asarray(window, np.float64)
    out = np.zeros((num_frames - 1) * hop + n_fft)
    for f in range(num_frames):
        out[f * hop: f * hop + n_fft] += w * w
    return out
