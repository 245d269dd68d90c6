"""Per-word audio features for OuteTTS speaker profiles, in numpy (port of
tpu_audio/models/outetts/features.py).

Reference: package/TTS/OuteTTS/OuteTTSAudioProcessor.swift — pitch via
autocorrelation (:15), energy RMS, spectral centroid (:219), each
quantized to 0..100 buckets.
"""

from __future__ import annotations

import numpy as np

from tpu_audio_torch.models.outetts.tokens import AudioFeatures


def pitch_autocorr(audio: np.ndarray, sr: int, fmin: float = 50.0,
                   fmax: float = 500.0) -> float:
    """Fundamental frequency estimate via autocorrelation peak."""
    if len(audio) < int(sr / fmin) * 2:
        return 0.0
    x = audio - audio.mean()
    ac = np.correlate(x, x, mode="full")[len(x) - 1:]
    lo, hi = int(sr / fmax), int(sr / fmin)
    if hi >= len(ac):
        hi = len(ac) - 1
    if lo >= hi:
        return 0.0
    lag = lo + int(np.argmax(ac[lo:hi]))
    return sr / lag if ac[lag] > 0 else 0.0


def spectral_centroid(audio: np.ndarray, sr: int) -> float:
    if len(audio) == 0:
        return 0.0
    spec = np.abs(np.fft.rfft(audio))
    freqs = np.fft.rfftfreq(len(audio), 1.0 / sr)
    total = spec.sum()
    return float((freqs * spec).sum() / total) if total > 0 else 0.0


def energy_rms(audio: np.ndarray) -> float:
    return float(np.sqrt(np.mean(audio ** 2))) if len(audio) else 0.0


def _bucket(value: float, lo: float, hi: float) -> int:
    return int(np.clip(round((value - lo) / (hi - lo) * 100), 0, 100))


def extract_features(audio: np.ndarray, sr: int) -> AudioFeatures:
    """Quantize pitch/energy/centroid into the 0..100 token buckets."""
    return AudioFeatures(
        energy=_bucket(energy_rms(audio), 0.0, 0.2),
        spectral_centroid=_bucket(spectral_centroid(audio, sr), 0.0, sr / 4),
        pitch=_bucket(pitch_autocorr(audio, sr), 50.0, 500.0),
    )
