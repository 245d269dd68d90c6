"""Mel filterbank construction (static NumPy, cached).

Three constructions are used across the reference models; each is replicated
exactly so mel outputs are bit-comparable:

  - Slaney scale + Slaney norm (Whisper, S3Tokenizer, S3Gen):
    package/Codec/S3Tokenizer/S3TokenizerUtils.swift:301-375
  - torchaudio-style HTK triangles without norm over linspace(0, sr/2, n_freqs)
    (FunASR, n_freqs = n_fft//2): package/STT/FunASR/FunASRAudio.swift:322-400
  - Kaldi-HTK integer-bin triangles (CAMPPlus fbank):
    package/Codec/S3Gen/CAMPPlus.swift:134-171
"""

from __future__ import annotations

import functools

import numpy as np

_MIN_LOG_HZ = 1000.0
_F_SP = 200.0 / 3.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel_slaney(hz: np.ndarray) -> np.ndarray:
    hz = np.asarray(hz, dtype=np.float64)
    lin = hz / _F_SP
    log = _MIN_LOG_MEL + np.log(np.maximum(hz, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP
    return np.where(hz >= _MIN_LOG_HZ, log, lin)


def _mel_to_hz_slaney(mel: np.ndarray) -> np.ndarray:
    mel = np.asarray(mel, dtype=np.float64)
    lin = _F_SP * mel
    log = _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL))
    return np.where(mel >= _MIN_LOG_MEL, log, lin)


def _hz_to_mel_htk(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def slaney(sample_rate: int, n_fft: int, n_mels: int,
           fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney-scale, Slaney-normalized filterbank of shape (n_mels, n_fft//2+1)."""
    fmax = float(sample_rate) / 2.0 if fmax is None else float(fmax)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fft_freqs = np.arange(n_fft // 2 + 1, dtype=np.float64) * sample_rate / n_fft

    fb = np.zeros((n_mels, n_fft // 2 + 1), dtype=np.float64)
    for m in range(n_mels):
        f_left, f_center, f_right = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - f_left) / (f_center - f_left)
        down = (f_right - fft_freqs) / (f_right - f_center)
        fb[m] = np.where(
            (fft_freqs >= f_left) & (fft_freqs <= f_center), up,
            np.where((fft_freqs > f_center) & (fft_freqs <= f_right), down, 0.0),
        )
        fb[m] *= 2.0 / (f_right - f_left)
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=None)
def torchaudio_htk(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None,
                   n_freqs: int | None = None) -> np.ndarray:
    """torchaudio-style unnormalized HTK triangles, shape (n_mels, n_freqs).

    FunASR truncates the spectrum to n_fft//2 bins, so n_freqs defaults to
    n_fft//2 (not the usual n_fft//2+1).
    """
    fmax = float(sample_rate) / 2.0 if fmax is None else float(fmax)
    n_freqs = n_fft // 2 if n_freqs is None else n_freqs
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel_htk(fmin), _hz_to_mel_htk(fmax), n_mels + 2)
    f_pts = _mel_to_hz_htk(mel_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.T.astype(np.float32)


@functools.lru_cache(maxsize=None)
def kaldi_htk(sample_rate: int, n_fft: int, n_mels: int,
              fmin: float = 20.0, fmax: float | None = None) -> np.ndarray:
    """Kaldi-style integer-FFT-bin HTK triangles, shape (n_mels, n_fft//2+1)."""
    fmax = float(sample_rate) / 2.0 if fmax is None else float(fmax)
    mel_min = float(_hz_to_mel_htk(fmin))
    mel_max = float(_hz_to_mel_htk(fmax))
    mel_pts = mel_min + np.arange(n_mels + 2) * (mel_max - mel_min) / (n_mels + 1)
    hz_pts = _mel_to_hz_htk(mel_pts)
    bins = np.round(hz_pts * n_fft / sample_rate).astype(np.int64)

    n_bins = n_fft // 2 + 1
    fb = np.zeros((n_mels, n_bins), dtype=np.float64)
    for m in range(n_mels):
        left, center, right = bins[m], bins[m + 1], bins[m + 2]
        for k in range(max(left, 0), min(center, n_bins)):
            if center != left:
                fb[m, k] = (k - left) / (center - left)
        for k in range(max(center, 0), min(right, n_bins)):
            if right != center:
                fb[m, k] = (right - k) / (right - center)
    return fb.astype(np.float32)
