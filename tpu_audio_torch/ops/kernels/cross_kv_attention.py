"""Cross-attention decode over int8 cross-K/V, one token, one layer.

Replaces the TPU kernel
tpu_audio/ops/pallas/cross_kv_attention.py:cross_attention_decode with
`csrc/cross_kv_attention.cu`.

Bound on the H100: device-memory bytes. Each decode step re-reads every
layer's cross-K/V (61 MB per layer at large-v3-turbo batch 16 in int8)
at 2 FLOP per byte. Design: int8 K/V halve the bytes against bf16, and
the dequantisation is algebraically free — the per-channel K scale folds
into q before the dot and the V scale multiplies the output after the
softmax division. One block per (batch, head) reads each 64-byte head row
as four 16-byte vectors; padded key rows (t ≥ t_valid) are never read.

The TPU kernel's block-diagonal q and 8-row output pad exist for the MXU
and are not carried over; the kernel computes in f32 where the TPU one
feeds bf16 dots.

`quantize_cross_kv` and `dequant_layer` are plain PyTorch, run once per
window (quantisation) or per prefill (dequantisation).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_audio_torch.ops.kernels import _build

LANE = 128          # T pads to a multiple of this (the int8 layout's contract)
HEAD_DIM = 64       # the kernel is compiled for hd = 64

LAUNCHES = {"cross_attention_decode": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = _build.Kernel("tpa_cross_attention_decode", _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I)


def quantize_cross_kv(ck: torch.Tensor, cv: torch.Tensor):
    """(L, B, T, H, hd) float K/V → ((L, B, T_pad, H·hd) int8,
    (L, B, H·hd) f32 scale) × 2, quantized per channel over the T axis.
    T pads to a multiple of 128 with zero rows."""

    def q(x):
        lyr, b, t, h, hd = x.shape
        xf = x.float().reshape(lyr, b, t, h * hd)
        s = torch.clamp(xf.abs().amax(dim=2) / 127.0, min=1e-10)
        x8 = torch.clamp(torch.round(xf / s[:, :, None]), -127, 127)
        t_pad = -(-t // LANE) * LANE
        x8 = torch.nn.functional.pad(x8, (0, 0, 0, t_pad - t))
        return x8.to(torch.int8), s

    k8, ks = q(ck)
    v8, vs = q(cv)
    return k8, ks, v8, vs


def dequant_layer(x8: torch.Tensor, scale: torch.Tensor, t: int,
                  n_heads: int) -> torch.Tensor:
    """One layer's (B, T_pad, H·hd) int8 → (B, t, H, hd) bf16 (the prefill
    path, where the dequantisation amortises over the prompt)."""
    b, _, hdim = x8.shape
    xf = x8.float() * scale[:, None, :]
    return xf[:, :t].reshape(b, t, n_heads, hdim // n_heads).to(torch.bfloat16)


def cross_attention_decode_plain(q, k8, v8, k_scale, v_scale, layer: int, *,
                                 t_valid: int, n_heads: int) -> torch.Tensor:
    """Plain PyTorch version of `cross_attention_decode`."""
    b, h, hd = q.shape
    qs = (q.float().reshape(b, h * hd) * k_scale).reshape(b, h, hd)
    kf = k8[layer, :, :t_valid].float().reshape(b, t_valid, h, hd)
    vf = v8[layer, :, :t_valid].float().reshape(b, t_valid, h, hd)
    w = torch.softmax(torch.einsum("bhd,bthd->bht", qs, kf), dim=-1)
    out = torch.einsum("bht,bthd->bhd", w, vf)
    return out * v_scale.reshape(b, h, hd)


def cross_attention_decode(q: torch.Tensor, k8: torch.Tensor,
                           v8: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, layer: int, *,
                           t_valid: int, n_heads: int) -> torch.Tensor:
    """One decode step of cross-attention for layer `layer`.

    q: (B, H, hd) f32, already carrying the softmax scale.
    k8/v8: (L, B, T_pad, H·hd) int8 (`quantize_cross_kv` layout).
    k_scale/v_scale: this layer's (B, H·hd) f32 channel scales.
    Returns (B, H, hd) f32. On CUDA all inputs are contiguous and hd = 64.
    """
    if q.device.type == "cpu":
        return cross_attention_decode_plain(q, k8, v8, k_scale, v_scale, layer,
                                            t_valid=t_valid, n_heads=n_heads)
    device = _build.require_cuda("cross_attention_decode", q, k8, v8, k_scale,
                                 v_scale)
    if q.dim() != 3 or k8.dim() != 4:
        raise ValueError("cross_attention_decode: q must be (B, H, hd) and "
                         "k8 (L, B, T_pad, H*hd)")
    b, h, hd = q.shape
    lyr, _, t_pad, d = k8.shape
    if h != n_heads or hd != HEAD_DIM:
        raise ValueError(f"cross_attention_decode: unsupported heads={h}, "
                         f"hd={hd} (n_heads={n_heads})")
    if not 0 <= layer < lyr or not 1 <= t_valid <= t_pad:
        raise ValueError(f"cross_attention_decode: layer={layer} or "
                         f"t_valid={t_valid} out of range")
    _build.check("cross_attention_decode q", q, torch.float32, (b, h, hd))
    _build.check("cross_attention_decode k8", k8, torch.int8, (lyr, b, t_pad, h * hd))
    _build.check("cross_attention_decode v8", v8, torch.int8, (lyr, b, t_pad, d))
    _build.check("cross_attention_decode k_scale", k_scale, torch.float32, (b, d))
    _build.check("cross_attention_decode v_scale", v_scale, torch.float32, (b, d))
    out = torch.empty((b, h, hd), dtype=torch.float32, device=device)
    _KERNEL(device, q, k8, v8, k_scale, v_scale, out, int(layer), b, t_pad, h,
            t_valid)
    LAUNCHES["cross_attention_decode"] += 1
    return out
