"""Multi-head attention (port of tpu_audio/nn/attention.py: attend,
decode_mask).

Layout is (B, T, H, D). Scores and softmax are f32; masks are additive
f32 biases. `attend` is always the plain computation: the JAX `attend`
sends long unmasked self-attention to a Pallas kernel, which the port's
Whisper encoder replaces with the fused-encoder kernels instead.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps fully-masked rows finite


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, Tq, H, D), k/v: (B, Tk, H, D) → (B, Tq, H, D) in v's dtype.

    The caller has folded the softmax scale into q and k (Whisper applies
    (d/h)^-0.25 to both; the JAX `attend` with q_scaled=True).
    mask: broadcastable to (B, H, Tq, Tk), additive f32.
    """
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if mask is not None:
        scores = scores + mask
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def decode_mask(tk_max: int, pos: torch.Tensor, tq: int = 1) -> torch.Tensor:
    """Mask for cached decode: new queries at absolute positions
    pos..pos+tq-1 attend cache slots < pos+q_idx+1. (1, 1, tq, tk_max) f32.
    `pos` is a 0-d tensor on the cache's device."""
    qi = pos + torch.arange(tq, device=pos.device)[:, None]
    ki = torch.arange(tk_max, device=pos.device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    return torch.where(ki <= qi, zero, NEG_INF)[None, None]
