"""Fused log-mel: window → DFT → |·|² → Slaney mel → log10 in one launch.

Replaces the TPU kernel tpu_audio/ops/pallas/fused_mel.py:fused_log_mel
with `csrc/fused_mel.cu`.

Bound on the H100: float32 arithmetic (1.1 GFLOP against 3.4 MB of device
memory traffic per 30 s chunk). The reference computes at HIGHEST
precision and the 1e-10-floored log10 magnifies relative error, so the
kernel uses f32 FMAs and no TF32. Its design: one block per 16 frames,
the audio those frames cover copied to shared memory once (framing needs
no gather in device memory), one frequency bin per thread, and the power
spectrum kept in shared memory for the mel projection.

Whisper's settings are fixed: n_fft 400, hop 160, 16 kHz, Slaney mels up
to 8 kHz, symmetric Hann window. The global max−8 clip needs the whole
clip's maximum, so the caller (`pipeline.MelExtractor`) applies it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_audio_torch.ops import mel_filters, windows
from tpu_audio_torch.ops.frontends import (WHISPER_HOP, WHISPER_N_FFT,
                                           WHISPER_SAMPLE_RATE)
from tpu_audio_torch.ops.kernels import _build
from tpu_audio_torch.ops.stft import dft_basis, frame

LAUNCHES = {"fused_log_mel": 0}

_KERNEL = _build.Kernel(
    "tpa_fused_log_mel",
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int)


@functools.lru_cache(maxsize=None)
def _constants(n_mels: int, device: torch.device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(window-folded DFT basis (n_fft, 2K), mel filterbank (K, n_mels)),
    f32 on `device`."""
    basis = dft_basis(WHISPER_N_FFT) * windows.hann(WHISPER_N_FFT)[:, None]
    fb = mel_filters.slaney(WHISPER_SAMPLE_RATE, WHISPER_N_FFT, n_mels,
                            fmax=8000.0).T
    return (torch.tensor(basis, device=device),
            torch.tensor(fb, device=device).contiguous())


def fused_log_mel_plain(audio: torch.Tensor, *, n_mels: int = 128) -> torch.Tensor:
    """Plain PyTorch version of `fused_log_mel`."""
    basis, fb = _constants(n_mels, audio.device)
    spec = frame(audio.float(), WHISPER_N_FFT, WHISPER_HOP) @ basis
    k = WHISPER_N_FFT // 2 + 1
    power = spec[:, :k] ** 2 + spec[:, k:] ** 2
    return torch.log10(torch.clamp(power @ fb, min=1e-10))


def fused_log_mel(audio: torch.Tensor, *, n_mels: int = 128) -> torch.Tensor:
    """audio (T,) f32, already padded (reflect + tail) → (num_frames, n_mels)
    UN-normalized log10 mel, num_frames = (T − 400) // 160 + 1."""
    if audio.device.type == "cpu":
        return fused_log_mel_plain(audio, n_mels=n_mels)
    device = _build.require_cuda("fused_log_mel", audio)
    n = audio.shape[0] if audio.dim() == 1 else -1
    if n < WHISPER_N_FFT:
        raise ValueError(f"fused_log_mel: need a 1-D signal of at least "
                         f"{WHISPER_N_FFT} samples, got shape {tuple(audio.shape)}")
    _build.check("fused_log_mel audio", audio, torch.float32, (n,))
    num_frames = (n - WHISPER_N_FFT) // WHISPER_HOP + 1
    basis, fb = _constants(n_mels, device)
    out = torch.empty((num_frames, n_mels), dtype=torch.float32, device=device)
    _KERNEL(device, audio, n, basis, fb, out, num_frames, WHISPER_N_FFT,
            WHISPER_HOP, n_mels)
    LAUNCHES["fused_log_mel"] += 1
    return out
