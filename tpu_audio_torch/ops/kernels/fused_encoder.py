"""Fused Whisper encoder-block phases (bf16): LN + QKV, and attention +
o-projection + residual + LN2.

Replaces the TPU kernels tpu_audio/ops/pallas/fused_encoder.py:ln_qkv_packed
with `csrc/ln_qkv.cu` and
tpu_audio/ops/pallas/fused_encoder.py:attn_oproj_ln with
`csrc/fused_encoder.cu`.

Bound on the H100: tensor-core arithmetic — at large-v3-turbo batch 16 a
block is ~500 GFLOP against ~0.25 GB of activations. `ln_qkv` is two
launches behind one call: a LayerNorm pass writes the normalized rows (bf16)
to a scratch tensor, then a persistent TMA + wgmma GEMM (128 x 256 tiles,
a 3-stage ring filled by a producer warp, two consumer warpgroups) adds the
bias and writes q, k, v head-major. `attn_oproj_ln` keeps the attention output out
of device memory: per 16-row query tile it runs online-softmax attention
head by head (WMMA fragments) and adds each head's slice of the
o-projection into a (16, D) f32 shared-memory accumulator (the TPU
kernel's 256-row VMEM accumulator would not fit a block's 227 KB).

Layout: the TPU kernels pair-pack two heads into 128 lanes for the MXU;
the port writes q, k, v head-major, (B, H, T, hd), and T is not padded.
The packed weight is therefore the plain concatenation [q·s; k·s; v] of
the torch-layout (out, in) weights, s = hd^-0.25 (`pack_qkv_weights`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpu_audio_torch.ops.kernels import _build

LAUNCHES = {"ln_qkv": 0, "attn_oproj_ln": 0}
HEAD_DIM = 64           # attn_oproj_ln's kernel is compiled for hd = 64
MASKED = -1e30

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LN_QKV = _build.Kernel("tpa_ln_qkv", _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _F)
_ATTN = _build.Kernel("tpa_attn_oproj_ln", _P, _P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _I, _I, _I, _I, _F)


def pack_qkv_weights(attn: dict, n_heads: int, dtype: torch.dtype
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """q/k/v linear dicts (weights (..., D, D), torch (out, in) layout,
    any leading layer dims) → packed weight (..., 3D, D) in `dtype` and
    bias (..., 3D) f32, with hd^-0.25 folded into the q and k rows.
    A missing k bias is zero."""
    wq = attn["q"]["weight"]
    d = wq.shape[-1]
    scale = (d // n_heads) ** -0.25
    w = torch.cat([wq.float() * scale, attn["k"]["weight"].float() * scale,
                   attn["v"]["weight"].float()], dim=-2)
    bq = attn["q"]["bias"].float()
    bk = (attn["k"]["bias"].float() if "bias" in attn["k"]
          else torch.zeros_like(bq))
    bias = torch.cat([bq * scale, bk * scale, attn["v"]["bias"].float()],
                     dim=-1)
    return w.to(dtype).contiguous(), bias.contiguous()


# ---------------------------------------------------------------- ln_qkv

def ln_rows_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """The LayerNorm pass of `ln_qkv`: f32 statistics over the last axis,
    f32 out (the kernel then rounds it to the weight's dtype)."""
    d = x.shape[-1]
    return F.layer_norm(x.float(), (d,), ln_w.float(), ln_b.float(), eps)


def ln_qkv_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                 w_qkv: torch.Tensor, b_qkv: torch.Tensor, n_heads: int,
                 eps: float = 1e-5):
    """Plain PyTorch version of `ln_qkv`."""
    b, t, d = x.shape
    xn = ln_rows_plain(x, ln_w, ln_b, eps)
    y = (xn.to(w_qkv.dtype) @ w_qkv.T).float() + b_qkv
    y = y.to(x.dtype).reshape(b, t, 3, n_heads, d // n_heads)
    y = y.permute(2, 0, 3, 1, 4)
    return y[0].contiguous(), y[1].contiguous(), y[2].contiguous()


def ln_qkv(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
           w_qkv: torch.Tensor, b_qkv: torch.Tensor, n_heads: int,
           eps: float = 1e-5):
    """x (B, T, D) → q, k, v each (B, H, T, hd): LayerNorm(x; ln_w, ln_b)
    projected by the packed weight (`pack_qkv_weights`), scale folded in.

    On CUDA: x and w_qkv bf16, ln_w, ln_b, b_qkv f32, all contiguous,
    D a multiple of 128. The normalized rows go through a (B·T, D) bf16
    scratch tensor allocated here."""
    if x.device.type == "cpu":
        return ln_qkv_plain(x, ln_w, ln_b, w_qkv, b_qkv, n_heads, eps)
    device = _build.require_cuda("ln_qkv", x, ln_w, ln_b, w_qkv, b_qkv)
    if x.dim() != 3:
        raise ValueError(f"ln_qkv: x must be (B, T, D), got {tuple(x.shape)}")
    b, t, d = x.shape
    if d % 128 or d % n_heads:
        raise ValueError(f"ln_qkv: unsupported width D={d}, heads={n_heads}")
    _build.check("ln_qkv x", x, torch.bfloat16, (b, t, d))
    _build.check("ln_qkv ln_w", ln_w, torch.float32, (d,))
    _build.check("ln_qkv ln_b", ln_b, torch.float32, (d,))
    _build.check("ln_qkv w_qkv", w_qkv, torch.bfloat16, (3 * d, d))
    _build.check("ln_qkv b_qkv", b_qkv, torch.float32, (3 * d,))
    for name, a in (("x", x), ("ln_w", ln_w), ("ln_b", ln_b), ("w_qkv", w_qkv)):
        if a.data_ptr() % 16:
            raise ValueError(f"ln_qkv: {name} must start on a 16-byte boundary")
    shape = (b, n_heads, t, d // n_heads)
    q, k, v = (torch.empty(shape, dtype=torch.bfloat16, device=device)
               for _ in range(3))
    xn = torch.empty((b * t, d), dtype=torch.bfloat16, device=device)
    _LN_QKV(device, x, ln_w, ln_b, w_qkv, b_qkv, xn, q, k, v, b, t, d,
            n_heads, eps)
    LAUNCHES["ln_qkv"] += 1
    return q, k, v


# --------------------------------------------------------- attn_oproj_ln

def attention_plain(q, k, v, t_valid: int, scale: float = 1.0) -> torch.Tensor:
    """Head-major q, k, v (…, T, hd) → the attention output (…, T, hd) in
    f32, as the kernels compute it (`csrc/attention_tile.cuh`,
    `csrc/attention_wgmma.cuh`): f32 scores times `scale` (1 where it is
    folded into q and k), keys ≥ t_valid masked, f32 softmax, the
    exponentials rounded to v's dtype before the value product, which sums
    in f32, and the division after it."""
    scores = (q.float() @ k.float().transpose(-1, -2)) * scale   # (…, T, T)
    keys = torch.arange(q.shape[-2], device=q.device)
    scores = scores.masked_fill(keys >= t_valid, MASKED)
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    return (e.to(v.dtype).float() @ v.float()) / e.sum(-1, keepdim=True)


def attn_oproj_ln_plain(q, k, v, x, wo, bo, ln2_w, ln2_b, t_valid: int,
                        eps: float = 1e-5):
    """Plain PyTorch version of `attn_oproj_ln`."""
    b, h, t, hd = q.shape
    d = h * hd
    r = attention_plain(q, k, v, t_valid)
    attn = r.to(x.dtype).transpose(1, 2).reshape(b, t, d)
    y = x.float() + bo.float() + (attn @ wo.to(x.dtype).T).float()
    h_out = F.layer_norm(y, (d,), ln2_w.float(), ln2_b.float(), eps)
    return y.to(x.dtype), h_out.to(x.dtype)


def attn_oproj_ln(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  x: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                  ln2_w: torch.Tensor, ln2_b: torch.Tensor, t_valid: int,
                  eps: float = 1e-5):
    """Head-major q, k, v (B, H, T, hd) (scale already folded in) and the
    residual x (B, T, D) → (y, h), both (B, T, D):
    y = x + o_proj(attention), h = LayerNorm2(y). Keys ≥ t_valid are masked.

    On CUDA: q, k, v, x, wo (D, D) bf16; bo, ln2_w, ln2_b f32; all
    contiguous; hd = 64. A D whose block needs more shared memory than the
    card gives raises from the entry point."""
    if q.device.type == "cpu":
        return attn_oproj_ln_plain(q, k, v, x, wo, bo, ln2_w, ln2_b, t_valid,
                                   eps)
    device = _build.require_cuda("attn_oproj_ln", q, k, v, x, wo, bo, ln2_w,
                                 ln2_b)
    if q.dim() != 4:
        raise ValueError(f"attn_oproj_ln: q must be (B, H, T, hd), "
                         f"got {tuple(q.shape)}")
    b, h, t, hd = q.shape
    d = h * hd
    if hd != HEAD_DIM:
        raise ValueError(f"attn_oproj_ln: unsupported heads={h}, hd={hd}")
    if not 1 <= t_valid <= t:
        raise ValueError(f"attn_oproj_ln: t_valid={t_valid} outside [1, {t}]")
    for name, a in (("q", q), ("k", k), ("v", v)):
        _build.check(f"attn_oproj_ln {name}", a, torch.bfloat16, (b, h, t, hd))
    _build.check("attn_oproj_ln x", x, torch.bfloat16, (b, t, d))
    _build.check("attn_oproj_ln wo", wo, torch.bfloat16, (d, d))
    for name, a in (("bo", bo), ("ln2_w", ln2_w), ("ln2_b", ln2_b)):
        _build.check(f"attn_oproj_ln {name}", a, torch.float32, (d,))
    y = torch.empty((b, t, d), dtype=torch.bfloat16, device=device)
    h_out = torch.empty_like(y)
    _ATTN(device, q, k, v, x, wo, bo, ln2_w, ln2_b, y, h_out, b, t, h,
          t_valid, eps)
    LAUNCHES["attn_oproj_ln"] += 1
    return y, h_out
