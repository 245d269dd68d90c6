"""Rotary position embeddings: plain RoPE and Llama-3 frequency-scaled RoPE
(port of tpu_audio/nn/rope.py).

The inverse frequencies are float64 NumPy constants; the angles and the
rotation are f32, in the HF half-split form (rotate_half).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def base_inv_freq(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.lru_cache(maxsize=None)
def llama3_inv_freq(head_dim: int, theta: float, factor: float,
                    low_freq_factor: float, high_freq_factor: float,
                    original_max_pos: int) -> np.ndarray:
    inv = base_inv_freq(head_dim, theta)
    wavelen = 2.0 * math.pi / inv
    low_wavelen = original_max_pos / low_freq_factor
    high_wavelen = original_max_pos / high_freq_factor
    scaled = inv / factor
    smooth = (original_max_pos / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    smoothed = (1 - smooth) * scaled + smooth * inv
    out = np.where(wavelen > low_wavelen, scaled,
                   np.where(wavelen < high_wavelen, inv, smoothed))
    return out.astype(np.float64)


def make_inv_freq(head_dim: int, theta: float = 10000.0,
                  rope_scaling: dict | None = None) -> np.ndarray:
    """Inverse frequencies from an HF-style rope_scaling config dict."""
    if rope_scaling and rope_scaling.get("rope_type", rope_scaling.get("type")) == "llama3":
        return llama3_inv_freq(
            head_dim, theta, float(rope_scaling["factor"]),
            float(rope_scaling.get("low_freq_factor", 1.0)),
            float(rope_scaling.get("high_freq_factor", 4.0)),
            int(rope_scaling.get("original_max_position_embeddings", 8192)))
    return base_inv_freq(head_dim, theta)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def cos_sin(positions: torch.Tensor, inv_freq: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 (…, D) cos and sin of positions × inv_freq, duplicated over the
    two halves."""
    inv = torch.as_tensor(np.asarray(inv_freq, np.float32), device=positions.device)
    ang = positions[..., None].float() * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: np.ndarray) -> torch.Tensor:
    """x (B, T, H, D), positions (T,) or (B, T) → x rotated, in x's dtype."""
    cos, sin = cos_sin(positions, inv_freq)
    cos, sin = cos[..., None, :], sin[..., None, :]  # broadcast over heads
    xf = x.float()
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)
