"""Audio front-ends (port of tpu_audio/ops/frontends.py: whisper_log_mel
and the WHISPER_* constants; funasr_log_mel, apply_lfr, apply_cmvn and
funasr_features; s3_log_mel, s3gen_mel and kaldi_fbank).

The S3 and Kaldi front-ends are plain torch, as the JAX package computes
them outside its Pallas kernel: frames times a DFT basis, then a
filterbank product.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch.ops import mel_filters, windows
from tpu_audio_torch.ops.stft import dft_basis, frame, reflect_pad, stft_power

# Whisper audio constants (package/STT/Whisper/WhisperAudio.swift:15-26)
WHISPER_SAMPLE_RATE = 16000
WHISPER_N_FFT = 400
WHISPER_HOP = 160
WHISPER_CHUNK_SECONDS = 30
WHISPER_N_SAMPLES = WHISPER_CHUNK_SECONDS * WHISPER_SAMPLE_RATE
WHISPER_N_FRAMES = WHISPER_N_SAMPLES // WHISPER_HOP


def log10_norm(log_spec: torch.Tensor) -> torch.Tensor:
    """Whisper's normalisation of a log10 mel: clip to max-8, (x+4)/4."""
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def whisper_log_mel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(T,) 16 kHz waveform → (frames, n_mels) normalized log-mel, f32."""
    power = stft_power(audio, windows.hann(WHISPER_N_FFT), WHISPER_N_FFT,
                       WHISPER_HOP)
    power = power[:-1]  # python whisper drops the final time frame
    fb = torch.as_tensor(mel_filters.slaney(WHISPER_SAMPLE_RATE, WHISPER_N_FFT,
                                            n_mels, fmax=8000.0),
                         device=audio.device)
    mel = power @ fb.T
    return log10_norm(torch.log10(torch.clamp(mel, min=1e-10)))


def funasr_log_mel(audio: torch.Tensor, n_mels: int = 80, n_fft: int = 400,
                   hop: int = 160) -> torch.Tensor:
    """FunASR's mel: Hamming window, HTK triangles over the first n_fft/2
    bins, natural log. (T,) → (frames, n_mels) f32."""
    power = stft_power(audio, windows.hamming(n_fft), n_fft, hop)[..., : n_fft // 2]
    fb = torch.as_tensor(mel_filters.torchaudio_htk(16000, n_fft, n_mels), device=audio.device)
    return torch.log(torch.clamp(power @ fb.T, min=1e-10))


def apply_lfr(features: torch.Tensor, lfr_m: int = 7, lfr_n: int = 6) -> torch.Tensor:
    """Low-frame-rate stacking: (T, D) → (ceil(T/n), m·D). Left-pads
    (m-1)//2 copies of the first frame, right-pads with the last, then
    gathers m consecutive frames every n."""
    t, d = features.shape
    t_lfr = -(-t // lfr_n)
    left = (lfr_m - 1) // 2
    right = max(0, (t_lfr - 1) * lfr_n + lfr_m - (t + left))
    padded = torch.cat([features[:1].expand(left, d), features, features[-1:].expand(right, d)])
    idx = np.arange(t_lfr)[:, None] * lfr_n + np.arange(lfr_m)[None, :]
    return padded[torch.as_tensor(idx, device=features.device)].reshape(t_lfr, lfr_m * d)


def apply_cmvn(features: torch.Tensor, mean: torch.Tensor | None = None,
               istd: torch.Tensor | None = None) -> torch.Tensor:
    """Cepstral mean/variance normalisation: (x + mean) · istd with stored
    statistics, else per-utterance standardisation."""
    if mean is not None and istd is not None:
        return (features + mean) * istd
    mu = features.mean(dim=0, keepdim=True)
    std = torch.sqrt(features.var(dim=0, unbiased=False, keepdim=True)) + 1e-6
    return (features - mu) / std


def funasr_features(audio: torch.Tensor, n_mels: int = 80, lfr_m: int = 7, lfr_n: int = 6,
                    normalize: bool = True) -> torch.Tensor:
    """Full FunASR preprocessing: mel → LFR → CMVN. (T,) → (T', n_mels·lfr_m)."""
    feats = apply_lfr(funasr_log_mel(audio, n_mels=n_mels), lfr_m, lfr_n)
    return apply_cmvn(feats) if normalize else feats


def s3_log_mel(audio: torch.Tensor, n_mels: int = 128, padding: int = 0) -> torch.Tensor:
    """The S3 tokenizer's front-end: (T,) 16 kHz → (n_mels, frames) f32
    (periodic Hann 400 / hop 160, Slaney mels, the last frame dropped,
    Whisper's log10 normalisation)."""
    if padding > 0:
        audio = F.pad(audio, (0, padding))
    power = stft_power(audio, windows.hann(400, periodic=True), 400, 160)[:-1]
    fb = torch.as_tensor(mel_filters.slaney(16000, 400, n_mels), device=audio.device)
    return log10_norm(torch.log10(torch.clamp(power @ fb.T, min=1e-10))).T


def s3gen_mel(audio: torch.Tensor, n_fft: int = 1920, n_mels: int = 80,
              sample_rate: int = 24000, hop: int = 480, fmin: float = 0.0,
              fmax: float = 8000.0) -> torch.Tensor:
    """S3Gen's and HiFT's mel: (..., T) 24 kHz → (..., n_mels, frames) f32,
    the natural log of the magnitude (not the power) spectrum, reflect
    padding of (n_fft - hop) / 2 and uncentered frames."""
    audio = reflect_pad(audio, (n_fft - hop) // 2)
    mag = stft_power(audio, windows.hann(n_fft, periodic=True), n_fft, hop, center=False,
                     magnitude=True)
    fb = torch.as_tensor(mel_filters.slaney(sample_rate, n_fft, n_mels, fmin, fmax),
                         device=audio.device)
    return torch.log(torch.clamp(mag @ fb.T, min=1e-5)).transpose(-1, -2)


def kaldi_fbank(audio: torch.Tensor, sample_rate: int = 16000, n_mels: int = 80,
                frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
                fmin: float = 20.0) -> torch.Tensor:
    """Kaldi-compatible fbank (CAMPPlus's input): (T,) → (frames, n_mels)
    f32. Snip-edges framing, no dither, each frame's mean removed,
    pre-emphasis 0.97, the Povey window, zero padding to a power of two,
    HTK mels on integer bins, natural log floored at float32's eps."""
    win_length = int(sample_rate * frame_length_ms / 1000)
    hop = int(sample_rate * frame_shift_ms / 1000)
    n_fft = 1 << (win_length - 1).bit_length()
    frames = frame(audio.float(), win_length, hop)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    pre = torch.cat([frames[..., :1], frames[..., 1:] - 0.97 * frames[..., :-1]], dim=-1)
    pre = pre * torch.as_tensor(windows.povey(win_length), dtype=torch.float32,
                                device=audio.device)
    pre = F.pad(pre, (0, n_fft - win_length))
    spec = pre @ torch.as_tensor(dft_basis(n_fft), device=audio.device)
    k = n_fft // 2 + 1
    power = spec[..., :k] ** 2 + spec[..., k:] ** 2
    fb = torch.as_tensor(mel_filters.kaldi_htk(sample_rate, n_fft, n_mels, fmin=fmin),
                         device=audio.device)
    return torch.log(torch.clamp(power @ fb.T, min=1.1920929e-07))
