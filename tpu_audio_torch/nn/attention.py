"""Multi-head attention (port of tpu_audio/nn/attention.py: attend with
GQA, causal_mask, decode_mask, padding_mask).

Layout is (B, T, H, D). Scores and softmax are f32 (f64 for f64 q);
masks are additive f32 biases. As in the JAX `attend`, long unmasked
self-attention (no mask, equal head counts, q and k of one shape,
`encoder_attention.supported`) goes to the `encoder_attention` kernel: the
Whisper encoder's per-op path on quantised trees. Every other call is the
plain computation, `attend_plain`, which a caller that needs gradients
calls itself: the kernel has no backward.
"""

from __future__ import annotations

import torch

from tpu_audio_torch.ops.kernels import encoder_attention as ea

NEG_INF = -1e30  # large-negative instead of -inf: keeps fully-masked rows finite


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor | None = None, scale: float = 1.0) -> torch.Tensor:
    """q: (B, Tq, H, D), k/v: (B, Tk, Hkv, D) with H % Hkv == 0 (GQA; query
    head j uses key head j // (H/Hkv)) → (B, Tq, H, D) in v's dtype.

    `scale` multiplies q in q's dtype before the f32 product, as the JAX
    `attend` does; the default 1.0 is for callers that folded it into q and
    k themselves (Whisper applies (d/h)^-0.25 to both, the JAX
    q_scaled=True). mask: broadcastable to (B, H or Hkv, Tq, Tk), additive f32.
    On the kernel's route the scale multiplies the f32 scores instead.
    """
    if ea.supported(q, k, mask):  # unmasked, q and k of one shape, T ≥ 512
        return ea.encoder_attention(q, k, v, scale=scale)
    return attend_plain(q, k, v, mask, scale)


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor | None = None, scale: float = 1.0) -> torch.Tensor:
    """`attend` without the kernel's route: the JAX function's einsum,
    softmax, einsum in autograd ops, at any length (the Whisper training
    route, `models/whisper/model.encode_xla`)."""
    b, tq, h, d = q.shape
    hkv = k.shape[2]
    if scale != 1.0:
        q = q * torch.tensor(scale, dtype=q.dtype)
    ct = torch.promote_types(q.dtype, torch.float32)  # f32 scores, f64 for f64 q
    if hkv != h:
        qg = q.reshape(b, tq, hkv, h // hkv, d)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(ct), k.to(ct))
        if mask is not None:
            scores = scores + mask[:, :, None]
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
        return out.reshape(b, tq, h, d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct))
    if mask is not None:
        scores = scores + mask
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def causal_mask(tq: int, tk: int, offset: int = 0,
                device: torch.device | str = "cuda") -> torch.Tensor:
    """Additive causal mask (1, 1, tq, tk) f32; query i attends keys <= i+offset."""
    qi = torch.arange(tq, device=device)[:, None] + offset
    ki = torch.arange(tk, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ki <= qi, zero, NEG_INF)[None, None]


def decode_mask(tk_max: int, pos: torch.Tensor, tq: int = 1) -> torch.Tensor:
    """Mask for cached decode: new queries at absolute positions
    pos..pos+tq-1 attend cache slots < pos+q_idx+1. (1, 1, tq, tk_max) f32.
    `pos` is a 0-d tensor on the cache's device."""
    qi = pos + torch.arange(tq, device=pos.device)[:, None]
    ki = torch.arange(tk_max, device=pos.device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    return torch.where(ki <= qi, zero, NEG_INF)[None, None]


def padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) valid lengths → additive key-padding mask (B, 1, 1, max_len) f32."""
    ki = torch.arange(max_len, device=lengths.device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=lengths.device)
    return torch.where(ki < lengths[:, None], zero, NEG_INF)[:, None, None, :]
