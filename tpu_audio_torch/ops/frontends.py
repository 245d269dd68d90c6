"""Whisper's audio front-end (port of tpu_audio/ops/frontends.py:
whisper_log_mel and the WHISPER_* constants).

The other mel conventions of the JAX module (S3Tokenizer, S3Gen, FunASR,
Kaldi fbank) come with the engines that use them.
"""

from __future__ import annotations

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
