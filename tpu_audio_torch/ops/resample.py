"""Host-side polyphase sample-rate conversion (port of
tpu_audio/ops/resample.py, the NumPy version).

Replaces the reference's AVAudioConverter anti-aliased resampler
(package/Audio/AudioResampler.swift:8-89): audio enters at any rate and is
resampled on the host before its features move to the card.
Kaiser-windowed sinc polyphase, rational up/down from the gcd,
block-processed to bound memory. The JAX package's optional C++ core is not
ported; this is the version it is checked against.
"""

from __future__ import annotations

import math

import numpy as np


def _kaiser_sinc_filter(up: int, down: int, taps_per_zero: int = 10,
                        beta: float = 5.0) -> np.ndarray:
    """Lowpass for rational resampling, gain `up`, odd length."""
    max_rate = max(up, down)
    half_len = taps_per_zero * max_rate
    n = np.arange(-half_len, half_len + 1, dtype=np.float64)
    cutoff = 1.0 / max_rate  # normalized to the upsampled Nyquist
    h = cutoff * np.sinc(cutoff * n)
    h *= np.kaiser(len(n), beta)
    return (h * up).astype(np.float64)


def resample(x: np.ndarray, sr_in: int, sr_out: int,
             block: int = 1 << 16) -> np.ndarray:
    """Resample 1-D float audio from sr_in to sr_out."""
    x = np.asarray(x, dtype=np.float64)
    if sr_in == sr_out:
        return x.astype(np.float32)
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g

    h = _kaiser_sinc_filter(up, down)
    half = (len(h) - 1) // 2
    # polyphase decomposition: H[r, t] = h[t*up + r]
    n_taps = -(-len(h) // up)
    h_pad = np.concatenate([h, np.zeros(n_taps * up - len(h))])
    H = h_pad.reshape(n_taps, up).T  # (up, n_taps)

    n_out = int(np.ceil(len(x) * up / down))
    # y[n] uses upsampled position p = n*down + half (center the filter)
    pad = n_taps + 2
    xp = np.concatenate([np.zeros(pad), x, np.zeros(pad + n_taps)])

    out = np.empty(n_out, dtype=np.float64)
    for start in range(0, n_out, block):
        stop = min(start + block, n_out)
        n = np.arange(start, stop)
        p = n * down + half
        phase = p % up
        base = p // up
        idx = base[:, None] - np.arange(n_taps)[None, :] + pad
        out[start:stop] = np.einsum("nt,nt->n", H[phase], xp[idx])
    return out.astype(np.float32)
