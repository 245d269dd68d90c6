"""Bidirectional attention for encoder-length sequences: the (B, T, H, D)
and head-major (B·H, T, D) entry, and the pair-packed (B·H/2, T, 128) one.

Replaces the TPU kernels
tpu_audio/ops/pallas/encoder_attention.py:encoder_attention and
tpu_audio/ops/pallas/encoder_attention.py:encoder_attention_packed with
`csrc/encoder_attention.cu`.

What both compute, per (batch, head): scores from the input-dtype dot
accumulated in f32, times `scale` (default hd^-0.5); keys at or beyond
`t_valid` masked with -1e30; f32 max subtraction; e = exp(s - m) rounded to
the input dtype before the product with V, accumulated in f32; the division
by Σe after that product; the output in the input dtype. The packed entry
multiplies q by its scale in q's dtype before the product, as the TPU entry
does (its scores then take no scale); on the Whisper paths the scale is 1.

Bound on the H100: tensor-core arithmetic, 4·B·H·T²·hd operations (184
GFLOP a layer at large-v3-turbo batch 16, 0.186 ms at 989 TFLOP/s) against
246 MB of q, k, v and output (0.073 ms). Design: one kernel reads all three
layouts in place through one TMA tensor-map recipe (`tma_view`: no
transpose, no padding of T); the TPU's pair packing into 128 lanes and its
block-diagonal q exist for the MXU, and only the packed entry's layout is
kept. A block takes 128 query rows of one head, two blocks an SM: one
thread streams 64-key K/V tiles through a 4-stage TMA ring, two warpgroups
compute S = Q·Kᵀ and P·V with wgmma and keep the online softmax in
registers. Compiled for hd = 64 and bf16.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpu_audio_torch.ops.kernels import _build
from tpu_audio_torch.ops.kernels.fused_encoder import attention_plain

HEAD_DIM = 64       # the kernel is compiled for hd = 64
MAX_HEADS = 65535   # B·H is the grid's second dimension

LAUNCHES = {"encoder_attention": 0, "encoder_attention_packed": 0}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_KERNEL = _build.Kernel("tpa_encoder_attention", _P, _P, _P, _P, _I, _I, _I, _I, _L, _L,
                        _I, _F)


def supported(q, k, mask) -> bool:
    """Whether the JAX package sends this attention to its kernel, without
    its TPU check: unmasked, 4-D, equal q and k shapes, T ≥ 512, d ≤ 256,
    and one head's K/V small enough (t·d·4 ≤ 2^20). Reads only the shapes,
    so it answers for a tensor of either package."""
    if mask is not None or len(q.shape) != 4 or tuple(q.shape) != tuple(k.shape):
        return False
    _, t, _, d = q.shape
    return t >= 512 and d <= 256 and t * d * 4 <= 2 ** 20


# ---------------------------------------------------------------- plain

def _heads_plain(q, k, v, t_valid: int, scale: float) -> torch.Tensor:
    """Head-major (N, T, D) → (N, T, D) in q's dtype: the tile's attention
    (shared with the fused encoder's plain versions), rounded once."""
    return attention_plain(q, k, v, t_valid, scale).to(q.dtype)


def encoder_attention_plain(q, k, v, t_valid: int | None = None, scale: float | None = None,
                            pre_bh: bool = False) -> torch.Tensor:
    """Plain PyTorch version of `encoder_attention`."""
    t, d = q.shape[1], q.shape[-1]
    t_valid = t if t_valid is None else t_valid
    eff = 1.0 / math.sqrt(d) if scale is None else scale
    if pre_bh:
        return _heads_plain(q, k, v, t_valid, eff)
    b, _, h, _ = q.shape

    def bh(x):
        return x.transpose(1, 2).reshape(b * h, t, d)

    out = _heads_plain(bh(q), bh(k), bh(v), t_valid, eff)
    return out.reshape(b, h, t, d).transpose(1, 2)


def encoder_attention_packed_plain(q, k, v, t_valid: int | None = None,
                                   scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of `encoder_attention_packed`."""
    bg, t, d2 = q.shape
    hd = d2 // 2
    t_valid = t if t_valid is None else t_valid
    eff = 1.0 / math.sqrt(hd) if scale is None else scale
    q = q * torch.tensor(eff, dtype=q.dtype, device=q.device)

    def unpack(x):
        return x.reshape(bg, t, 2, hd).transpose(1, 2).reshape(bg * 2, t, hd)

    out = _heads_plain(unpack(q), unpack(k), unpack(v), t_valid, 1.0)
    return out.reshape(bg, 2, t, hd).transpose(1, 2).reshape(bg, t, d2)


# ---------------------------------------------------------------- kernels

def tma_view(layout: str, shape) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The kernel's tensor-map description of a layout of this shape:
    (dims, strides), innermost first, of the 4-D tensor (hd, inner, T,
    outer) that holds head n = (outer n // inner, inner n % inner) as T rows
    of hd elements, with element strides (1, stride_inner, ld,
    stride_outer). `layout` is "bthd" for (B, T, H, hd), "pre_bh" for
    (B·H, T, hd) and "packed" for (B·H/2, T, 2·hd). A dimension of one
    element takes the stride hd (the tensor map takes no stride 0). The
    kernel reads (hd, 1, 128, 1) boxes of q and (hd, 1, 64, 1) boxes of k
    and v; rows past T read as zeros."""
    if layout == "bthd":
        b, t, h, hd = shape
        inner, outer, ld = h, b, h * hd
    elif layout == "pre_bh":
        outer, t, hd = shape
        inner, ld = 1, hd
    elif layout == "packed":
        outer, t, d2 = shape
        hd = d2 // 2
        inner, ld = 2, d2
    else:
        raise ValueError(f"tma_view: unknown layout {layout!r}")
    return (hd, inner, t, outer), (1, hd, ld, t * ld)


def _launch(name: str, device, layout: str, q, k, v, t_valid: int,
            scale: float) -> torch.Tensor:
    t = q.shape[1]
    for label, a in (("q", q), ("k", k), ("v", v)):
        _build.check(f"{name} {label}", a, torch.bfloat16, tuple(q.shape))
        if a.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must start on a 16-byte boundary")
    if not 1 <= t_valid <= t:
        raise ValueError(f"{name}: t_valid={t_valid} outside [1, {t}]")
    (_, inner, _, outer), (_, stride_inner, ld, stride_outer) = tma_view(layout, q.shape)
    n_heads = inner * outer
    if n_heads > MAX_HEADS:
        raise ValueError(f"{name}: {n_heads} heads exceed the grid's {MAX_HEADS}")
    out = torch.empty_like(q)
    _KERNEL(device, q, k, v, out, n_heads, t, t_valid, inner, stride_outer, stride_inner, ld,
            scale)
    LAUNCHES[name] += 1
    return out


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      t_valid: int | None = None, scale: float | None = None,
                      pre_bh: bool = False) -> torch.Tensor:
    """q, k, v (B, T, H, D) → (B, T, H, D); with pre_bh, head-major (B·H,
    T, D) → (B·H, T, D). Keys ≥ t_valid (default T) are masked; `scale`
    (default D^-0.5) multiplies the f32 scores.

    On CUDA: bf16, contiguous, D = 64."""
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, t_valid, scale, pre_bh)
    device = _build.require_cuda("encoder_attention", q, k, v)
    if q.dim() != (3 if pre_bh else 4) or q.shape[-1] != HEAD_DIM:
        want = "(B·H, T, 64)" if pre_bh else "(B, T, H, 64)"
        raise ValueError(f"encoder_attention: expected {want}, got {tuple(q.shape)}")
    t = q.shape[1]
    eff = 1.0 / math.sqrt(HEAD_DIM) if scale is None else scale
    t_valid = t if t_valid is None else t_valid
    return _launch("encoder_attention", device, "pre_bh" if pre_bh else "bthd", q, k, v,
                   t_valid, eff)


def encoder_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             t_valid: int | None = None,
                             scale: float | None = None) -> torch.Tensor:
    """Head pairs packed per row: q, k, v (B·H/2, T, 2·hd) with head j of a
    pair at channels [j·hd, (j+1)·hd) → the same layout. q is multiplied by
    `scale` (default hd^-0.5) in its dtype before the product.

    On CUDA: bf16, contiguous, 2·hd = 128."""
    if q.device.type == "cpu":
        return encoder_attention_packed_plain(q, k, v, t_valid, scale)
    device = _build.require_cuda("encoder_attention_packed", q, k, v)
    if q.dim() != 3 or q.shape[-1] != 2 * HEAD_DIM:
        raise ValueError(f"encoder_attention_packed: expected (B·H/2, T, 128), "
                         f"got {tuple(q.shape)}")
    t = q.shape[1]
    eff = 1.0 / math.sqrt(HEAD_DIM) if scale is None else scale
    if eff != 1.0:  # q · 1 is q: the Whisper path skips the pass
        q = q * torch.tensor(eff, dtype=q.dtype, device=q.device)
    t_valid = t if t_valid is None else t_valid
    return _launch("encoder_attention_packed", device, "packed", q, k, v, t_valid, 1.0)
