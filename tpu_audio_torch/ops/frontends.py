"""Audio front-ends (port of tpu_audio/ops/frontends.py: whisper_log_mel
and the WHISPER_* constants; funasr_log_mel, apply_lfr, apply_cmvn and
funasr_features).

The other mel conventions of the JAX module (S3Tokenizer, S3Gen, Kaldi
fbank) come with the engines that use them.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_audio_torch.ops import mel_filters, windows
from tpu_audio_torch.ops.stft import stft_power

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
