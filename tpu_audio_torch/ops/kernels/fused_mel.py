"""Fused log-mel: window → DFT → |·|² → Slaney mel → log10 in one launch.

Replaces the TPU kernel tpu_audio/ops/pallas/fused_mel.py:fused_log_mel
with `csrc/fused_mel.cu`.

Bound on the H100: device-memory bytes (1.9 MB of audio in and 1.5 MB of
log-mel out per 30 s chunk). The TPU kernel computes the DFT as a GEMM
against a window-folded basis for its matrix unit; the CUDA kernel takes
the DFT of each frame by a Stockham FFT of 200 complex points (the 400 real
samples paired, radix 5, 5, 8, `RADICES`) in shared memory, in float64 with
float64 twiddle tables (in float32 the FFT puts the loudest bin's rounding
into the quiet ones), then a split pass to the 201 bins. Each mel band sums
only its nonzero bins, in bin order (`_constants`' band table). A block
stages its frames' audio span by one bulk copy, so the signal must start
16-byte aligned; a launch takes the whole clip.

The plain version keeps the TPU kernel's formulation: the frames against
the window-folded DFT basis, then the dense filterbank. On the CPU the
wrapper runs it on 30 s chunk slices (`CHUNK_FRAMES` frames each), so a
long clip never holds all its frames at once.

Whisper's settings are fixed: n_fft 400, hop 160, 16 kHz, Slaney mels up
to 8 kHz, symmetric Hann window. The global max−8 clip needs the whole
clip's maximum, so the caller (`pipeline.MelExtractor`) applies it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tpu_audio_torch.ops import mel_filters, windows
from tpu_audio_torch.ops.frontends import (WHISPER_HOP, WHISPER_N_FFT, WHISPER_N_FRAMES,
                                           WHISPER_SAMPLE_RATE)
from tpu_audio_torch.ops.kernels import _build
from tpu_audio_torch.ops.stft import dft_basis, frame

LAUNCHES = {"fused_log_mel": 0}

N_POINTS = WHISPER_N_FFT // 2  # complex points of the kernel's FFT
RADICES = (5, 5, 8)            # the kernel's Stockham passes, in order
MAX_BAND = 16                  # the most bins a band may span in the kernel (kMaxBand)
CHUNK_FRAMES = WHISPER_N_FRAMES  # the CPU branch's frames a slice

_KERNEL = _build.Kernel(
    "tpa_fused_log_mel",
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int)


class Tables(NamedTuple):
    """The constants of `fused_log_mel` on one device."""
    basis: torch.Tensor     # (n_fft, 2K) f32, the window-folded DFT basis (plain version)
    fb: torch.Tensor        # (K, n_mels) f32, the dense filterbank (plain version)
    window: torch.Tensor    # (n_fft,) f64, the f32 Hann window's values
    twiddles: torch.Tensor  # (300, 2) f64, see `twiddles`
    bands: torch.Tensor     # (n_mels, 4) int32: first bin, count, offset into weights, 0
    weights: torch.Tensor   # (nonzeros,) f32, each band's weights in bin order
    widest: int             # the most bins a band spans


def twiddles() -> np.ndarray:
    """The kernel's twiddle table, complex128, computed in float64: for each
    pass of `RADICES` in order, after sub-transforms of Ns points, its
    (R − 1) × Ns factors e^{-2πi k r / (Ns R)} at [r − 1][k]; then
    e^{-2πi k / 400} for k ≤ 100 (the split of the 200 complex points into
    201 bins)."""
    parts, ns = [], 1
    for r in RADICES:
        kr = np.outer(np.arange(1, r), np.arange(ns)).astype(np.float64)
        parts.append(np.exp(-2j * np.pi * kr / (ns * r)).ravel())
        ns *= r
    k = np.arange(N_POINTS // 2 + 1, dtype=np.float64)
    return np.concatenate(parts + [np.exp(-2j * np.pi * k / WHISPER_N_FFT)])


def bands(n_mels: int) -> tuple[np.ndarray, np.ndarray]:
    """The filterbank by bands: ((n_mels, 4) int32 of first nonzero bin,
    count, offset into the weights, 0; the packed f32 weights). Each band's
    nonzeros are one run of bins (a Slaney triangle)."""
    fb = mel_filters.slaney(WHISPER_SAMPLE_RATE, WHISPER_N_FFT, n_mels, fmax=8000.0)
    table = np.zeros((n_mels, 4), np.int32)
    packed = []
    offset = 0
    for m in range(n_mels):
        nz = np.flatnonzero(fb[m])
        first, count = (int(nz[0]), int(nz[-1]) - int(nz[0]) + 1) if nz.size else (0, 0)
        table[m, :3] = first, count, offset
        packed.append(fb[m, first:first + count])
        offset += count
    return table, np.concatenate(packed).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _constants(n_mels: int, device: torch.device) -> Tables:
    """The plain version's basis and filterbank and the kernel's tables, on
    `device`."""
    window = windows.hann(WHISPER_N_FFT)
    basis = dft_basis(WHISPER_N_FFT) * window[:, None]
    fb = mel_filters.slaney(WHISPER_SAMPLE_RATE, WHISPER_N_FFT, n_mels, fmax=8000.0).T
    tw = twiddles()
    table, weights = bands(n_mels)
    return Tables(torch.tensor(basis, device=device),
                  torch.tensor(fb, device=device).contiguous(),
                  torch.tensor(window.astype(np.float64), device=device),
                  torch.tensor(np.stack([tw.real, tw.imag], axis=1), device=device),
                  torch.tensor(table, device=device), torch.tensor(weights, device=device),
                  int(table[:, 1].max()))


def num_frames(n_samples: int) -> int:
    return (n_samples - WHISPER_N_FFT) // WHISPER_HOP + 1


def fused_log_mel_plain(audio: torch.Tensor, *, n_mels: int = 128) -> torch.Tensor:
    """Plain PyTorch version of `fused_log_mel`."""
    c = _constants(n_mels, audio.device)
    spec = frame(audio.float(), WHISPER_N_FFT, WHISPER_HOP) @ c.basis
    k = WHISPER_N_FFT // 2 + 1
    power = spec[:, :k] ** 2 + spec[:, k:] ** 2
    return torch.log10(torch.clamp(power @ c.fb, min=1e-10))


def _plain_by_chunks(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The plain version on 30 s slices: slice c starts at frame
    CHUNK_FRAMES · c and gives its first CHUNK_FRAMES frames, the last slice
    every frame to the end; a signal of one chunk and its margins is one
    slice."""
    n = num_frames(audio.shape[0])
    starts = range(0, max(1, -(-(n - 1) // CHUNK_FRAMES)) * CHUNK_FRAMES, CHUNK_FRAMES)
    step = CHUNK_FRAMES * WHISPER_HOP
    parts = []
    for c, f0 in enumerate(starts):
        last = c == len(starts) - 1
        piece = audio[f0 * WHISPER_HOP: None if last else f0 * WHISPER_HOP + step
                      + WHISPER_N_FFT]
        mel = fused_log_mel_plain(piece, n_mels=n_mels)
        parts.append(mel if last else mel[:CHUNK_FRAMES])
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def fused_log_mel(audio: torch.Tensor, *, n_mels: int = 128) -> torch.Tensor:
    """audio (T,) f32, already padded (reflect + tail) → (num_frames, n_mels)
    UN-normalized log10 mel, num_frames = (T − 400) // 160 + 1, in one
    launch."""
    if audio.device.type == "cpu":
        return _plain_by_chunks(audio, n_mels)
    device = _build.require_cuda("fused_log_mel", audio)
    n = audio.shape[0] if audio.dim() == 1 else -1
    if n < WHISPER_N_FFT:
        raise ValueError(f"fused_log_mel: need a 1-D signal of at least "
                         f"{WHISPER_N_FFT} samples, got shape {tuple(audio.shape)}")
    _build.check("fused_log_mel audio", audio, torch.float32, (n,))
    if audio.data_ptr() % 16:  # each block's span is staged by one bulk copy
        raise ValueError("fused_log_mel: the signal must start 16-byte aligned")
    c = _constants(n_mels, device)
    if c.widest > MAX_BAND:
        raise ValueError(f"fused_log_mel: a band of {n_mels} mels spans {c.widest} bins, "
                         f"the kernel at most {MAX_BAND}")
    out = torch.empty((num_frames(n), n_mels), dtype=torch.float32, device=device)
    _KERNEL(device, audio, n, c.window, c.twiddles, c.bands, c.weights, out,
            out.shape[0], n_mels)
    LAUNCHES["fused_log_mel"] += 1
    return out
