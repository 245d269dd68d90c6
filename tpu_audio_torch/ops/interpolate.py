"""1-D interpolation along the time axis of (B, T, C) (port of
tpu_audio/ops/interpolate.py: nearest_2x, linear_resize).

`linear_resize` writes out torch's `align_corners=False` rule with its
clamp, as the JAX module does, instead of calling `F.interpolate`; a
test holds the two equal.
"""

from __future__ import annotations

import torch


def nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C) → (B, 2T, C), nearest neighbour."""
    return torch.repeat_interleave(x, 2, dim=-2)


def linear_resize(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Linear interpolation along axis -2 of (B, T, C) to out_len frames,
    align_corners=False: src = (dst + 0.5)·T/out − 0.5, clamped to
    [0, T − 1]; the source positions in f32 as in the JAX module."""
    t = x.shape[-2]
    src = (torch.arange(out_len, dtype=torch.float32, device=x.device) + 0.5) * (t / out_len) - 0.5
    src = torch.clamp(src, 0.0, t - 1.0)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=t - 1)
    w = (src - lo)[None, :, None].to(x.dtype)
    return x[:, lo] * (1 - w) + x[:, hi] * w
