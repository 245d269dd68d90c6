"""The W8A8 Whisper encoder block: LN + QKV, attention + o-projection +
residual + LN2, fc1 + GELU, fc2 + residual, with int8 weights and
activation rows quantised inside the kernels.

Replaces the TPU kernels tpu_audio/ops/pallas/fused_encoder.py:
ln_qkv_packed_int8, attn_oproj_ln_int8, fc1_gelu_int8 and
fc2_residual_int8 with `csrc/fused_encoder_int8.cu`.

Bound on the H100: tensor-core operations — at large-v3-turbo batch 16 a
block is ~944 G int8 ops and 184 GFLOP of bf16 attention against ~1 GB of
activations. Design: exact int32 sums on the tensor cores; `ln_qkv_int8`
and `attn_oproj_ln_int8` use mma.sync s8 fragments (the attention is the
bf16 kernel's, shared through `csrc/attention_tile.cuh`); `fc1_gelu_int8`
and `fc2_residual_int8` are TMA + s8 wgmma GEMMs (`csrc/hopper.cuh`).
`fc2_residual_int8` is one persistent GEMM. `fc1_gelu_int8` is two
launches: a row-quantisation pass writes h's int8 codes (M, D) and row
scales (M) into scratch that the wrapper allocates with `torch.empty`
(`quant_rows_plain` is its plain version), then a GEMM whose thread-block
clusters split FF (`fc1_split`) and exchange each row's partial |max|
through distributed shared memory, so a row is requantised over all FF
values without leaving the chip.

Quantisation, as the TPU kernels: every activation row is quantised by
`int8_matmul.quantize_rows` (max|row| / 127, round half to even); the
attention output is quantised per head pair (one scale per row for heads
2g and 2g+1), in f32; fc1 emits int8 codes and one scale per row for fc2.
The products' int32 sums are exact; the epilogues multiply in the TPU
kernels' order (acc · row scale · channel scale + bias).

Layout: q, k, v head-major (B, H, T, hd), T not padded, as the bf16
kernels. GELU is the exact erf GELU; the TPU kernel's rational erf
(|err| ≤ 1.5e-7) can move a code of fc1's output by one step.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpu_audio_torch.ops.kernels import _build
from tpu_audio_torch.ops.kernels.fused_encoder import HEAD_DIM, attention_plain
from tpu_audio_torch.ops.kernels.int8_matmul import quantize_rows

LAUNCHES = {"ln_qkv_int8": 0, "attn_oproj_ln_int8": 0, "fc1_gelu_int8": 0,
            "fc2_residual_int8": 0}
PAIR = 2 * HEAD_DIM     # the channels of one head pair

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LN_QKV = _build.Kernel("tpa_ln_qkv_int8", _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _F)
_ATTN = _build.Kernel("tpa_attn_oproj_ln_int8", _P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _P, _P, _I, _I, _I, _I, _F)
_FC1 = _build.Kernel("tpa_fc1_gelu_int8", _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                     _I)
_FC1_CLUSTERS = _build.Kernel("tpa_fc1_gelu_int8_clusters", _P, _I, _I)
_FC2 = _build.Kernel("tpa_fc2_residual_int8", _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I)


def pack_qkv_weights_int8(attn: dict, n_heads: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int8 q/k/v linear dicts (weight_i8 (..., D, D), scale_i8 (..., D, 1),
    any leading layer dims) → packed int8 weight (..., 3D, D), column
    scales (..., 3D) f32 with hd^-0.25 folded into the q and k columns, and
    bias (..., 3D) f32 (q and k bias scaled too; a missing bias is zero)."""
    wq = attn["q"]["weight_i8"]
    d = wq.shape[-1]
    scale = (d // n_heads) ** -0.25
    w = torch.cat([attn[n]["weight_i8"] for n in "qkv"], dim=-2)
    cs = torch.cat([attn["q"]["scale_i8"][..., 0].float() * scale,
                    attn["k"]["scale_i8"][..., 0].float() * scale,
                    attn["v"]["scale_i8"][..., 0].float()], dim=-1)
    zeros = torch.zeros(wq.shape[:-1], dtype=torch.float32, device=wq.device)

    def bias(name):
        return attn[name]["bias"].float() if "bias" in attn[name] else zeros

    b = torch.cat([bias("q") * scale, bias("k") * scale, bias("v")], dim=-1)
    return w.contiguous(), cs.contiguous(), b.contiguous()


def _ln_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float):
    """LayerNorm in f32 with the TPU kernels' formula (mean, then the mean
    square of the deviations)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) * (x - mu)).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def _gelu(a: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as the kernel's `erff`."""
    return F.gelu(a)


def _s8_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., K) int8 · w (N, K) int8 → (..., N) f32, the int32 sums exact
    (an f64 product holds them, on any device), rounded as int32 → f32."""
    return (a.double() @ w.double().T).float()


def _scales(name: str, s: torch.Tensor, n: int) -> torch.Tensor:
    if s.dtype != torch.float32 or s.numel() != n or not s.is_contiguous():
        raise ValueError(f"{name}: expected {n} contiguous f32 values, "
                         f"got {s.dtype} {tuple(s.shape)}")
    return s


# ------------------------------------------------------------ ln_qkv_int8

def ln_qkv_int8_plain(x, ln_w, ln_b, w_i8, cs, bias, n_heads: int,
                      eps: float = 1e-5):
    """Plain PyTorch version of `ln_qkv_int8`."""
    b, t, d = x.shape
    xq, sx = quantize_rows(_ln_f32(x.float(), ln_w, ln_b, eps))
    y = _s8_product(xq, w_i8) * sx * cs.reshape(-1) + bias
    y = y.to(x.dtype).reshape(b, t, 3, n_heads, d // n_heads).permute(2, 0, 3, 1, 4)
    return y[0].contiguous(), y[1].contiguous(), y[2].contiguous()


def _check_heads(name: str, d: int, n_heads: int) -> None:
    if n_heads % 2 or d != n_heads * HEAD_DIM:
        raise ValueError(f"{name}: unsupported width D={d}, heads={n_heads} "
                         f"(an even head count of {HEAD_DIM} channels)")


def ln_qkv_int8(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                w_i8: torch.Tensor, cs: torch.Tensor, bias: torch.Tensor,
                n_heads: int, eps: float = 1e-5):
    """x (B, T, D) → q, k, v each (B, H, T, hd): LayerNorm(x), quantised per
    row, times the packed int8 weight (`pack_qkv_weights_int8`), dequantised
    by row scale × column scale, + bias; the attention scale is folded in.

    On CUDA: x bf16; w_i8 (3D, D) int8; ln_w, ln_b, cs, bias f32; all
    contiguous; an even head count with hd = 64. The outputs are bf16."""
    if x.device.type == "cpu":
        return ln_qkv_int8_plain(x, ln_w, ln_b, w_i8, cs, bias, n_heads, eps)
    device = _build.require_cuda("ln_qkv_int8", x, ln_w, ln_b, w_i8, cs, bias)
    if x.dim() != 3:
        raise ValueError(f"ln_qkv_int8: x must be (B, T, D), got {tuple(x.shape)}")
    b, t, d = x.shape
    _check_heads("ln_qkv_int8", d, n_heads)
    _build.check("ln_qkv_int8 x", x, torch.bfloat16, (b, t, d))
    _build.check("ln_qkv_int8 ln_w", ln_w, torch.float32, (d,))
    _build.check("ln_qkv_int8 ln_b", ln_b, torch.float32, (d,))
    _build.check("ln_qkv_int8 w_i8", w_i8, torch.int8, (3 * d, d))
    _scales("ln_qkv_int8 cs", cs, 3 * d)
    _build.check("ln_qkv_int8 bias", bias, torch.float32, (3 * d,))
    shape = (b, n_heads, t, HEAD_DIM)
    q, k, v = (torch.empty(shape, dtype=torch.bfloat16, device=device)
               for _ in range(3))
    _LN_QKV(device, x, ln_w, ln_b, w_i8, cs, bias, q, k, v, b, t, d, n_heads,
            eps)
    LAUNCHES["ln_qkv_int8"] += 1
    return q, k, v


# ------------------------------------------------------ attn_oproj_ln_int8

def attn_oproj_ln_int8_plain(q, k, v, x, wo_i8, cso, bo, ln2_w, ln2_b,
                             t_valid: int, eps: float = 1e-5):
    """Plain PyTorch version of `attn_oproj_ln_int8`."""
    h = q.shape[1]
    r = attention_plain(q, k, v, t_valid)
    acc = x.float() + bo.float()
    cso = cso.reshape(-1).float()
    for g in range(h // 2):
        pair = torch.cat([r[:, 2 * g], r[:, 2 * g + 1]], dim=-1)   # (B, T, 128) f32
        aq, sa = quantize_rows(pair)
        part = _s8_product(aq, wo_i8[:, g * PAIR:(g + 1) * PAIR])
        acc = acc + part * sa * cso
    h_out = _ln_f32(acc, ln2_w, ln2_b, eps)
    return acc.to(x.dtype), h_out.to(x.dtype)


def attn_oproj_ln_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       x: torch.Tensor, wo_i8: torch.Tensor, cso: torch.Tensor,
                       bo: torch.Tensor, ln2_w: torch.Tensor,
                       ln2_b: torch.Tensor, t_valid: int, eps: float = 1e-5):
    """Head-major q, k, v (B, H, T, hd) (scale folded in) and the residual x
    (B, T, D) → (y, h), both (B, T, D): y = x + bo + Σ_pairs (the pair's
    attention output, quantised per row) · wo_i8's 128 input channels of
    the pair · row scale · cso; h = LayerNorm2(y). Keys ≥ t_valid are
    masked.

    On CUDA: q, k, v, x bf16; wo_i8 (D, D) int8; cso, bo, ln2_w, ln2_b f32;
    all contiguous; an even head count with hd = 64."""
    if q.device.type == "cpu":
        return attn_oproj_ln_int8_plain(q, k, v, x, wo_i8, cso, bo, ln2_w,
                                        ln2_b, t_valid, eps)
    device = _build.require_cuda("attn_oproj_ln_int8", q, k, v, x, wo_i8, cso,
                                 bo, ln2_w, ln2_b)
    if q.dim() != 4:
        raise ValueError(f"attn_oproj_ln_int8: q must be (B, H, T, hd), "
                         f"got {tuple(q.shape)}")
    b, h, t, hd = q.shape
    d = h * hd
    _check_heads("attn_oproj_ln_int8", d, h)
    if not 1 <= t_valid <= t:
        raise ValueError(f"attn_oproj_ln_int8: t_valid={t_valid} outside [1, {t}]")
    for name, a in (("q", q), ("k", k), ("v", v)):
        _build.check(f"attn_oproj_ln_int8 {name}", a, torch.bfloat16, (b, h, t, hd))
    _build.check("attn_oproj_ln_int8 x", x, torch.bfloat16, (b, t, d))
    _build.check("attn_oproj_ln_int8 wo_i8", wo_i8, torch.int8, (d, d))
    _scales("attn_oproj_ln_int8 cso", cso, d)
    for name, a in (("bo", bo), ("ln2_w", ln2_w), ("ln2_b", ln2_b)):
        _build.check(f"attn_oproj_ln_int8 {name}", a, torch.float32, (d,))
    y = torch.empty((b, t, d), dtype=torch.bfloat16, device=device)
    h_out = torch.empty_like(y)
    _ATTN(device, q, k, v, x, wo_i8, cso, bo, ln2_w, ln2_b, y, h_out, b, t, h,
          t_valid, eps)
    LAUNCHES["attn_oproj_ln_int8"] += 1
    return y, h_out


# ----------------------------------------------------------- fc1_gelu_int8

def quant_rows_plain(h):
    """Plain PyTorch version of fc1's row-quantisation pass: h (B, T, D) →
    (codes (B·T, D) int8, scales (B·T,) f32)."""
    hq, sh = quantize_rows(h.float().reshape(-1, h.shape[-1]))
    return hq, sh.reshape(-1)


def fc1_gelu_int8_plain(h, w_i8, cs, bias):
    """Plain PyTorch version of `fc1_gelu_int8`."""
    hq, sh = quantize_rows(h.float())
    a = _s8_product(hq, w_i8) * sh * cs.reshape(-1) + bias.float()
    return quantize_rows(_gelu(a))


CLUSTER_MAX = 16   # blocks a cluster (non-portable past 8)


def fc1_split(ff: int) -> tuple[int, int] | None:
    """(columns a warpgroup, blocks a cluster) of fc1's GEMM for FF: a
    block takes 2 × 160 (or 2 × 128) of a row tile's FF columns, and the
    blocks of one cluster cover all FF; None where no split fits."""
    for nw in (160, 128):
        if ff % (2 * nw) == 0 and ff // (2 * nw) <= CLUSTER_MAX:
            return nw, ff // (2 * nw)
    return None


def fc1_active_clusters(d: int, ff: int, device) -> int:
    """How many of fc1's clusters the card runs at once
    (`cudaOccupancyMaxActiveClusters`)."""
    out = torch.zeros(1, dtype=torch.int32)
    _FC1_CLUSTERS(torch.device(device), out, d, ff)
    return int(out.item())


def fc1_gelu_int8(h: torch.Tensor, w_i8: torch.Tensor, cs: torch.Tensor,
                  bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """h (B, T, D) → (codes (B, T, FF) int8, scales (B, T, 1) f32) of
    gelu(quantised h · w_i8ᵀ · row scale · cs + bias), the GELU's output
    quantised per row over all FF values: the next GEMM's activations.

    On CUDA: h bf16; w_i8 (FF, D) int8; cs, bias f32; all contiguous; D a
    multiple of 128 and FF one that `fc1_split` takes (320 · C or 256 · C,
    C ≤ 16: every Whisper width)."""
    if h.device.type == "cpu":
        return fc1_gelu_int8_plain(h, w_i8, cs, bias)
    device = _build.require_cuda("fc1_gelu_int8", h, w_i8, cs, bias)
    if h.dim() != 3 or w_i8.dim() != 2:
        raise ValueError(f"fc1_gelu_int8: h must be (B, T, D) and w_i8 (FF, D), "
                         f"got {tuple(h.shape)} and {tuple(w_i8.shape)}")
    b, t, d = h.shape
    ff = w_i8.shape[0]
    if d % 128 or fc1_split(ff) is None:
        raise ValueError(f"fc1_gelu_int8: unsupported D={d} or FF={ff} (D a multiple "
                         f"of 128, FF 320·C or 256·C with C ≤ {CLUSTER_MAX})")
    _build.check("fc1_gelu_int8 h", h, torch.bfloat16, (b, t, d))
    _build.check("fc1_gelu_int8 w_i8", w_i8, torch.int8, (ff, d))
    _scales("fc1_gelu_int8 cs", cs, ff)
    _build.check("fc1_gelu_int8 bias", bias, torch.float32, (ff,))
    hq = torch.empty((b * t, d), dtype=torch.int8, device=device)     # scratch
    sh = torch.empty((b * t,), dtype=torch.float32, device=device)    # scratch
    codes = torch.empty((b, t, ff), dtype=torch.int8, device=device)
    sg = torch.empty((b, t, 1), dtype=torch.float32, device=device)
    _FC1(device, h, w_i8, cs, bias, hq, sh, codes, sg, b * t, d, ff)
    LAUNCHES["fc1_gelu_int8"] += 1
    return codes, sg


# ------------------------------------------------------- fc2_residual_int8

def fc2_residual_int8_plain(g_i8, sg, y, w_i8, cs, bias):
    """Plain PyTorch version of `fc2_residual_int8`."""
    out = _s8_product(g_i8, w_i8) * sg * cs.reshape(-1) + bias.float() + y.float()
    return out.to(y.dtype)


def fc2_residual_int8(g_i8: torch.Tensor, sg: torch.Tensor, y: torch.Tensor,
                      w_i8: torch.Tensor, cs: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """(codes (B, T, FF) int8, scales (B, T, 1), residual y (B, T, D)) →
    y + codes · w_i8ᵀ · sg · cs + bias, (B, T, D) in y's dtype.

    On CUDA: y bf16; w_i8 (D, FF) int8; sg, cs, bias f32; all contiguous;
    D and FF multiples of 128."""
    if g_i8.device.type == "cpu":
        return fc2_residual_int8_plain(g_i8, sg, y, w_i8, cs, bias)
    device = _build.require_cuda("fc2_residual_int8", g_i8, sg, y, w_i8, cs, bias)
    if y.dim() != 3 or w_i8.dim() != 2:
        raise ValueError(f"fc2_residual_int8: y must be (B, T, D) and w_i8 (D, FF), "
                         f"got {tuple(y.shape)} and {tuple(w_i8.shape)}")
    b, t, d = y.shape
    ff = w_i8.shape[1]
    if d % 128 or ff % 128:
        raise ValueError(f"fc2_residual_int8: unsupported D={d} or FF={ff}")
    _build.check("fc2_residual_int8 g_i8", g_i8, torch.int8, (b, t, ff))
    _build.check("fc2_residual_int8 sg", sg, torch.float32, (b, t, 1))
    _build.check("fc2_residual_int8 y", y, torch.bfloat16, (b, t, d))
    _build.check("fc2_residual_int8 w_i8", w_i8, torch.int8, (d, ff))
    _scales("fc2_residual_int8 cs", cs, d)
    _build.check("fc2_residual_int8 bias", bias, torch.float32, (d,))
    out = torch.empty_like(y)
    _FC2(device, g_i8, sg, y, w_i8, cs, bias, out, b * t, d, ff)
    LAUNCHES["fc2_residual_int8"] += 1
    return out
