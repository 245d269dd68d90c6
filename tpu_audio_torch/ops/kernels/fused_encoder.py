"""Fused Whisper encoder-block phases (bf16): LN + QKV, and attention +
o-projection + residual + LN2.

Replaces the TPU kernels tpu_audio/ops/pallas/fused_encoder.py:ln_qkv_packed
with `csrc/ln_qkv.cu` and
tpu_audio/ops/pallas/fused_encoder.py:attn_oproj_ln with
`csrc/fused_encoder.cu`.

Bound on the H100: tensor-core arithmetic — at large-v3-turbo batch 16 a
block is ~500 GFLOP against ~0.25 GB of activations. Each entry is two
launches behind one call, with a scratch tensor the wrapper allocates:

- `ln_qkv`: a LayerNorm pass writes the normalized rows (bf16) to the
  scratch, then a persistent TMA + wgmma GEMM (128 x 256 tiles, a 3-stage
  ring filled by a producer warp, two consumer warpgroups) adds the bias and
  writes q, k, v head-major.
- `attn_oproj_ln`: the TPU kernel keeps a (rows, D) f32 accumulator across
  the heads, which a Hopper block cannot hold beside its ring. So
  `attn_heads` (the encoder-attention kernel's block, `attend` of
  `csrc/attention_wgmma.cuh`) writes each head's attention output, rounded
  to bf16, token-major into a (B·T, D) scratch (`attn_heads_plain`); then
  `oproj_ln`, a persistent TMA + bf16 wgmma GEMM in thread-block clusters
  of ceil(D / 256) blocks (`oproj_split`), adds x + bo to the f32 product
  and exchanges each row's LayerNorm2 statistics through distributed
  shared memory (`oproj_ln_plain`).

Each pass has a plain version here, and the entry's plain version is their
composition. Products of bf16 operands are kept in f32 until the bias or
residual is added, and rounded once, as the TPU kernels
(`preferred_element_type=f32`) and the CUDA kernels do.

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
# the two launches of attn_oproj_ln called alone (for checks and timing); the
# encoder calls the entry above
PASS_LAUNCHES = {"attn_heads": 0, "oproj_ln": 0}
HEAD_DIM = 64           # the attention kernels are compiled for hd = 64
OPROJ_CLUSTER_MAX = 8   # the o-projections' clusters, portable: D ≤ 2048
MASKED = -1e30

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LN_QKV = _build.Kernel("tpa_ln_qkv", _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _F)
_ATTN_HEADS = _build.Kernel("tpa_attn_heads", _P, _P, _P, _P, _I, _I, _I, _I)
_OPROJ = _build.Kernel("tpa_oproj_ln_bf16", _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _F)
_OPROJ_CLUSTERS = _build.Kernel("tpa_oproj_ln_bf16_clusters", _P, _I)


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
    """Plain PyTorch version of `ln_qkv`: the normalized rows rounded to
    the weight's dtype, their product with it in f32, + bias, rounded once."""
    b, t, d = x.shape
    xn = ln_rows_plain(x, ln_w, ln_b, eps)
    y = xn.to(w_qkv.dtype).float() @ w_qkv.float().T + b_qkv
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
    _aligned("ln_qkv", x=x, ln_w=ln_w, ln_b=ln_b, w_qkv=w_qkv)
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
    f32, as the kernels compute it (`csrc/attention_wgmma.cuh`): f32 scores
    times `scale` (1 where it is folded into q and k), keys ≥ t_valid
    masked, f32 softmax, the exponentials rounded to v's dtype before the
    value product, which sums in f32, and the division after it."""
    scores = (q.float() @ k.float().transpose(-1, -2)) * scale   # (…, T, T)
    keys = torch.arange(q.shape[-2], device=q.device)
    scores = scores.masked_fill(keys >= t_valid, MASKED)
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    return (e.to(v.dtype).float() @ v.float()) / e.sum(-1, keepdim=True)


def attn_heads_plain(q, k, v, t_valid: int) -> torch.Tensor:
    """Plain PyTorch version of `attn_oproj_ln`'s first pass: head-major q,
    k, v (B, H, T, hd) → the attention output rounded to q's dtype,
    token-major (B, T, H·hd): head h in columns [h·hd, (h + 1)·hd)."""
    b, h, t, hd = q.shape
    r = attention_plain(q, k, v, t_valid).to(q.dtype)
    return r.transpose(1, 2).reshape(b, t, h * hd)


def oproj_ln_plain(attn, x, wo, bo, ln2_w, ln2_b, eps: float = 1e-5):
    """Plain PyTorch version of `attn_oproj_ln`'s second pass: the attention
    output (B, T, D) and the residual x (B, T, D) → (y, h) in x's dtype:
    y = x + bo + attn · woᵀ, the product of the operands in x's dtype kept
    in f32, h = LayerNorm2(y) in f32."""
    d = x.shape[-1]
    y = x.float() + bo.float() + attn.float() @ wo.to(x.dtype).float().T
    h_out = F.layer_norm(y, (d,), ln2_w.float(), ln2_b.float(), eps)
    return y.to(x.dtype), h_out.to(x.dtype)


def attn_oproj_ln_plain(q, k, v, x, wo, bo, ln2_w, ln2_b, t_valid: int,
                        eps: float = 1e-5):
    """Plain PyTorch version of `attn_oproj_ln`."""
    attn = attn_heads_plain(q, k, v, t_valid).to(x.dtype)
    return oproj_ln_plain(attn, x, wo, bo, ln2_w, ln2_b, eps)


def oproj_split(d: int) -> int | None:
    """Blocks a cluster of the o-projections (the second launch of
    `attn_oproj_ln` and of `attn_oproj_ln_int8`) for width D: a block takes
    256 of a row tile's D output columns (the last one 128 where D is an
    odd multiple of 128), and the blocks of one cluster cover all D, so
    that LayerNorm2's statistics stay on the chip; None where D is not a
    multiple of 128 or needs more than OPROJ_CLUSTER_MAX blocks."""
    if d <= 0 or d % 128 or d > OPROJ_CLUSTER_MAX * 256:
        return None
    return -(-d // 256)


def oproj_active_clusters(n_heads: int, device) -> int:
    """How many of the bf16 o-projection's clusters the card runs at once
    (`cudaOccupancyMaxActiveClusters`)."""
    out = torch.zeros(1, dtype=torch.int32)
    _OPROJ_CLUSTERS(torch.device(device), out, n_heads)
    return int(out.item())


def _aligned(name: str, **tensors) -> None:
    for label, a in tensors.items():
        if a.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must start on a 16-byte boundary")


def _check_heads(name: str, q, k, v, t_valid: int) -> tuple[int, int, int, int]:
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, H, T, hd), got {tuple(q.shape)}")
    b, h, t, hd = q.shape
    if hd != HEAD_DIM or oproj_split(h * hd) is None:
        raise ValueError(f"{name}: unsupported heads={h}, hd={hd} (hd {HEAD_DIM}, "
                         f"D a multiple of 128, at most {OPROJ_CLUSTER_MAX * 256})")
    if not 1 <= t_valid <= t:
        raise ValueError(f"{name}: t_valid={t_valid} outside [1, {t}]")
    for label, a in (("q", q), ("k", k), ("v", v)):
        _build.check(f"{name} {label}", a, torch.bfloat16, (b, h, t, hd))
    _aligned(name, q=q, k=k, v=v)
    return b, h, t, hd


def _check_oproj(name: str, x, wo, bo, ln2_w, ln2_b) -> tuple[int, int, int]:
    if x.dim() != 3 or oproj_split(x.shape[-1]) is None:
        raise ValueError(f"{name}: unsupported x {tuple(x.shape)}: (B, T, D) with D a "
                         f"multiple of 128, at most {OPROJ_CLUSTER_MAX * 256}")
    b, t, d = x.shape
    _build.check(f"{name} x", x, torch.bfloat16, (b, t, d))
    _build.check(f"{name} wo", wo, torch.bfloat16, (d, d))
    for label, a in (("bo", bo), ("ln2_w", ln2_w), ("ln2_b", ln2_b)):
        _build.check(f"{name} {label}", a, torch.float32, (d,))
    _aligned(name, x=x, wo=wo)
    return b, t, d


def _launch_attn_heads(device, q, k, v, t_valid: int) -> torch.Tensor:
    b, h, t, hd = q.shape
    attn = torch.empty((b, t, h * hd), dtype=torch.bfloat16, device=device)
    _ATTN_HEADS(device, q, k, v, attn, b, t, h, t_valid)
    return attn


def _launch_oproj(device, attn, x, wo, bo, ln2_w, ln2_b, eps: float):
    b, t, d = x.shape
    y = torch.empty((b, t, d), dtype=torch.bfloat16, device=device)
    h_out = torch.empty_like(y)
    _OPROJ(device, attn, x, wo, bo, ln2_w, ln2_b, y, h_out, b * t, d, eps)
    return y, h_out


def attn_oproj_ln(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  x: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                  ln2_w: torch.Tensor, ln2_b: torch.Tensor, t_valid: int,
                  eps: float = 1e-5):
    """Head-major q, k, v (B, H, T, hd) (scale already folded in) and the
    residual x (B, T, D) → (y, h), both (B, T, D):
    y = x + o_proj(attention), h = LayerNorm2(y). Keys ≥ t_valid are masked.

    On CUDA: q, k, v, x, wo (D, D) bf16; bo, ln2_w, ln2_b f32; all
    contiguous; hd = 64 and D a multiple of 128, at most 2048 (every
    Whisper width). The attention output goes through a (B, T, D) bf16
    scratch tensor allocated here."""
    if q.device.type == "cpu":
        return attn_oproj_ln_plain(q, k, v, x, wo, bo, ln2_w, ln2_b, t_valid,
                                   eps)
    device = _build.require_cuda("attn_oproj_ln", q, k, v, x, wo, bo, ln2_w,
                                 ln2_b)
    b, h, t, hd = _check_heads("attn_oproj_ln", q, k, v, t_valid)
    if tuple(x.shape) != (b, t, h * hd):
        raise ValueError(f"attn_oproj_ln: x must be {(b, t, h * hd)}, got {tuple(x.shape)}")
    _check_oproj("attn_oproj_ln", x, wo, bo, ln2_w, ln2_b)
    attn = _launch_attn_heads(device, q, k, v, t_valid)     # scratch
    out = _launch_oproj(device, attn, x, wo, bo, ln2_w, ln2_b, eps)
    LAUNCHES["attn_oproj_ln"] += 1
    return out


def attn_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               t_valid: int) -> torch.Tensor:
    """`attn_oproj_ln`'s first launch alone, for checks and timing:
    head-major q, k, v → the attention output (B, T, D) bf16, as
    `attn_heads_plain`."""
    if q.device.type == "cpu":
        return attn_heads_plain(q, k, v, t_valid)
    device = _build.require_cuda("attn_heads", q, k, v)
    _check_heads("attn_heads", q, k, v, t_valid)
    out = _launch_attn_heads(device, q, k, v, t_valid)
    PASS_LAUNCHES["attn_heads"] += 1
    return out


def oproj_ln(attn: torch.Tensor, x: torch.Tensor, wo: torch.Tensor,
             bo: torch.Tensor, ln2_w: torch.Tensor, ln2_b: torch.Tensor,
             eps: float = 1e-5):
    """`attn_oproj_ln`'s second launch alone, for checks and timing: the
    attention output (B, T, D) bf16 → (y, h), as `oproj_ln_plain`."""
    if attn.device.type == "cpu":
        return oproj_ln_plain(attn, x, wo, bo, ln2_w, ln2_b, eps)
    device = _build.require_cuda("oproj_ln", attn, x, wo, bo, ln2_w, ln2_b)
    b, t, d = _check_oproj("oproj_ln", x, wo, bo, ln2_w, ln2_b)
    _build.check("oproj_ln attn", attn, torch.bfloat16, (b, t, d))
    _aligned("oproj_ln", attn=attn)
    out = _launch_oproj(device, attn, x, wo, bo, ln2_w, ln2_b, eps)
    PASS_LAUNCHES["oproj_ln"] += 1
    return out
