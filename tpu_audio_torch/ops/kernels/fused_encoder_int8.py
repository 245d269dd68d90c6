"""The W8A8 Whisper encoder block: LN + QKV, attention + o-projection +
residual + LN2, fc1 + GELU, fc2 + residual, with int8 weights and
activation rows quantised inside the kernels.

Replaces the TPU kernels tpu_audio/ops/pallas/fused_encoder.py:
ln_qkv_packed_int8, attn_oproj_ln_int8, fc1_gelu_int8 and
fc2_residual_int8 with `csrc/fused_encoder_int8.cu`.

Bound on the H100: tensor-core operations — at large-v3-turbo batch 16 a
block is ~944 G int8 ops and 184 GFLOP of bf16 attention against ~1 GB of
activations. Design: exact int32 sums on the tensor cores in TMA + s8
wgmma GEMMs (`csrc/hopper.cuh`). Three of the four entry points run two
launches with a scratch between them that the wrapper allocates with
`torch.empty`; each pass has a plain version here, and the entry's plain
version is their composition:

- `ln_qkv_int8`: a LayerNorm + row-quantisation pass writes x's codes
  (M, D) and row scales (M) (`ln_quant_rows_plain`), then a persistent
  GEMM writes q, k, v head-major (`qkv_from_codes_plain`); fc2's GEMM with
  another epilogue.
- `attn_oproj_ln_int8`: the encoder-attention kernel's block in clusters
  of two (the heads of a pair) writes the attention output's per-pair
  codes (B, T, D) and scales (B, T, H / 2) (`pair_codes_plain`), then an
  s8 GEMM whose k-stages are the pairs adds each pair's dequantised
  product onto x + bo in f32, and thread-block clusters of ceil(D / 256)
  blocks (`oproj_split`) exchange each row's LayerNorm2 statistics through
  distributed shared memory (`oproj_ln_int8_plain`).
- `fc1_gelu_int8`: a row-quantisation pass writes h's codes (M, D) and row
  scales (M) (`quant_rows_plain`), then a GEMM whose clusters split FF
  (`fc1_split`) and exchange each row's partial |max|, so a row is
  requantised over all FF values without leaving the chip.
- `fc2_residual_int8`: one persistent GEMM.

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
from tpu_audio_torch.ops.kernels.fused_encoder import (HEAD_DIM, OPROJ_CLUSTER_MAX,
                                                      attention_plain, oproj_split)
from tpu_audio_torch.ops.kernels.int8_matmul import quantize_rows

LAUNCHES = {"ln_qkv_int8": 0, "attn_oproj_ln_int8": 0, "fc1_gelu_int8": 0,
            "fc2_residual_int8": 0}
# the two launches of ln_qkv_int8 and of attn_oproj_ln_int8 called alone (for
# checks and timing); the encoder calls the entries above
PASS_LAUNCHES = {"ln_quant_rows": 0, "qkv_from_codes": 0, "pair_codes": 0,
                 "oproj_ln_int8": 0}
PAIR = 2 * HEAD_DIM     # the channels of one head pair
CLUSTER_MAX = 16        # blocks a thread-block cluster (non-portable past 8)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LN_QUANT = _build.Kernel("tpa_ln_quant_rows", _P, _P, _P, _P, _P, _I, _I, _F)
_QKV = _build.Kernel("tpa_qkv_gemm_int8", _P, _P, _P, _P, _P, _P, _I, _I, _I, _I)
_PAIR_CODES = _build.Kernel("tpa_pair_codes", _P, _P, _P, _P, _P, _I, _I, _I, _I)
_OPROJ = _build.Kernel("tpa_oproj_ln", _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F)
_OPROJ_CLUSTERS = _build.Kernel("tpa_oproj_ln_clusters", _P, _I)
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

def ln_quant_rows_plain(x, ln_w, ln_b, eps: float = 1e-5):
    """Plain PyTorch version of `ln_qkv_int8`'s first pass: x (B, T, D) →
    (codes (B·T, D) int8, scales (B·T,) f32) of LayerNorm(x) in f32."""
    xq, sx = quantize_rows(_ln_f32(x.float().reshape(-1, x.shape[-1]), ln_w, ln_b, eps))
    return xq, sx.reshape(-1)


def qkv_from_codes_plain(xq, sx, w_i8, cs, bias, shape, n_heads: int,
                         dtype=torch.bfloat16):
    """Plain PyTorch version of `ln_qkv_int8`'s GEMM: codes (M, D) and row
    scales (M,) → q, k, v each (B, H, T, hd) in `dtype`, x's (B, T, D)
    `shape`."""
    b, t, d = shape
    y = _s8_product(xq, w_i8) * sx.reshape(-1, 1) * cs.reshape(-1) + bias
    y = y.to(dtype).reshape(b, t, 3, n_heads, d // n_heads).permute(2, 0, 3, 1, 4)
    return y[0].contiguous(), y[1].contiguous(), y[2].contiguous()


def ln_qkv_int8_plain(x, ln_w, ln_b, w_i8, cs, bias, n_heads: int,
                      eps: float = 1e-5):
    """Plain PyTorch version of `ln_qkv_int8`."""
    xq, sx = ln_quant_rows_plain(x, ln_w, ln_b, eps)
    return qkv_from_codes_plain(xq, sx, w_i8, cs, bias, x.shape, n_heads, x.dtype)


def _check_heads(name: str, d: int, n_heads: int) -> None:
    if n_heads % 2 or d != n_heads * HEAD_DIM:
        raise ValueError(f"{name}: unsupported width D={d}, heads={n_heads} "
                         f"(an even head count of {HEAD_DIM} channels)")


def _check_x(name: str, x, ln_w, ln_b) -> tuple[int, int, int]:
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, T, D), got {tuple(x.shape)}")
    b, t, d = x.shape
    if d % PAIR:
        raise ValueError(f"{name}: unsupported width D={d} (a multiple of {PAIR})")
    _build.check(f"{name} x", x, torch.bfloat16, (b, t, d))
    _build.check(f"{name} ln_w", ln_w, torch.float32, (d,))
    _build.check(f"{name} ln_b", ln_b, torch.float32, (d,))
    return b, t, d


def _check_qkv_weights(name: str, w_i8, cs, bias, d: int, n_heads: int) -> None:
    _check_heads(name, d, n_heads)
    _build.check(f"{name} w_i8", w_i8, torch.int8, (3 * d, d))
    _scales(f"{name} cs", cs, 3 * d)
    _build.check(f"{name} bias", bias, torch.float32, (3 * d,))


def _launch_ln_quant(device, x, ln_w, ln_b, eps):
    m, d = x.shape[0] * x.shape[1], x.shape[2]
    xq = torch.empty((m, d), dtype=torch.int8, device=device)
    sx = torch.empty((m,), dtype=torch.float32, device=device)
    _LN_QUANT(device, x, ln_w, ln_b, xq, sx, m, d, eps)
    return xq, sx


def _launch_qkv(device, xq, sx, w_i8, cs, bias, shape, n_heads):
    b, t, d = shape
    qkv = torch.empty((3, b, n_heads, t, HEAD_DIM), dtype=torch.bfloat16, device=device)
    _QKV(device, xq, sx, w_i8, cs, bias, qkv, b, t, d, n_heads)
    return qkv.unbind(0)


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
    b, t, d = _check_x("ln_qkv_int8", x, ln_w, ln_b)
    _check_qkv_weights("ln_qkv_int8", w_i8, cs, bias, d, n_heads)
    xq, sx = _launch_ln_quant(device, x, ln_w, ln_b, eps)    # scratch
    out = _launch_qkv(device, xq, sx, w_i8, cs, bias, (b, t, d), n_heads)
    LAUNCHES["ln_qkv_int8"] += 1
    return out


def ln_quant_rows(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                  eps: float = 1e-5):
    """`ln_qkv_int8`'s first launch alone, for checks and timing: x (B, T,
    D) → (codes (B·T, D) int8, scales (B·T,) f32), as `ln_quant_rows_plain`."""
    if x.device.type == "cpu":
        return ln_quant_rows_plain(x, ln_w, ln_b, eps)
    device = _build.require_cuda("ln_quant_rows", x, ln_w, ln_b)
    _check_x("ln_quant_rows", x, ln_w, ln_b)
    out = _launch_ln_quant(device, x, ln_w, ln_b, eps)
    PASS_LAUNCHES["ln_quant_rows"] += 1
    return out


def qkv_from_codes(xq: torch.Tensor, sx: torch.Tensor, w_i8: torch.Tensor,
                   cs: torch.Tensor, bias: torch.Tensor, shape, n_heads: int):
    """`ln_qkv_int8`'s second launch alone, for checks and timing: codes
    (M, D) and row scales (M,) of x's (B, T, D) `shape` → bf16 q, k, v
    (B, H, T, hd), as `qkv_from_codes_plain`."""
    if xq.device.type == "cpu":
        return qkv_from_codes_plain(xq, sx, w_i8, cs, bias, shape, n_heads)
    device = _build.require_cuda("qkv_from_codes", xq, sx, w_i8, cs, bias)
    b, t, d = shape
    _build.check("qkv_from_codes xq", xq, torch.int8, (b * t, d))
    _build.check("qkv_from_codes sx", sx, torch.float32, (b * t,))
    _check_qkv_weights("qkv_from_codes", w_i8, cs, bias, d, n_heads)
    out = _launch_qkv(device, xq, sx, w_i8, cs, bias, (b, t, d), n_heads)
    PASS_LAUNCHES["qkv_from_codes"] += 1
    return out


# ------------------------------------------------------ attn_oproj_ln_int8

def pair_codes_plain(q, k, v, t_valid: int):
    """Plain PyTorch version of `attn_oproj_ln_int8`'s first pass: head-major
    q, k, v (B, H, T, hd) → (codes (B, T, D) int8, scales (B, T, H / 2) f32):
    the attention output in f32, each row's head pair g (heads 2g, 2g + 1,
    columns [128 g, 128 g + 128)) quantised by its own scale."""
    b, h, t, hd = q.shape
    r = attention_plain(q, k, v, t_valid).transpose(1, 2)       # (B, T, H, hd) f32
    aq, sa = quantize_rows(r.reshape(b, t, h // 2, 2 * hd))
    return aq.reshape(b, t, h * hd), sa.reshape(b, t, h // 2)


def oproj_ln_int8_plain(codes, scales, x, wo_i8, cso, bo, ln2_w, ln2_b,
                        eps: float = 1e-5):
    """Plain PyTorch version of `attn_oproj_ln_int8`'s second pass: the
    codes (B, T, D) and pair scales (B, T, H / 2), the residual x (B, T, D)
    → (y, h) in x's dtype: y = x + bo + Σ_pairs (the pair's codes · wo_i8's
    128 input channels of the pair) · scale · cso, added pair by pair in
    f32; h = LayerNorm2(y)."""
    acc = x.float() + bo.float()
    cso = cso.reshape(-1).float()
    for g in range(scales.shape[-1]):
        part = _s8_product(codes[..., g * PAIR:(g + 1) * PAIR],
                           wo_i8[:, g * PAIR:(g + 1) * PAIR])
        acc = acc + part * scales[..., g:g + 1] * cso
    h_out = _ln_f32(acc, ln2_w, ln2_b, eps)
    return acc.to(x.dtype), h_out.to(x.dtype)


def attn_oproj_ln_int8_plain(q, k, v, x, wo_i8, cso, bo, ln2_w, ln2_b,
                             t_valid: int, eps: float = 1e-5):
    """Plain PyTorch version of `attn_oproj_ln_int8`."""
    codes, scales = pair_codes_plain(q, k, v, t_valid)
    return oproj_ln_int8_plain(codes, scales, x, wo_i8, cso, bo, ln2_w, ln2_b, eps)


def oproj_active_clusters(n_heads: int, device) -> int:
    """How many of the o-projection's clusters the card runs at once
    (`cudaOccupancyMaxActiveClusters`)."""
    out = torch.zeros(1, dtype=torch.int32)
    _OPROJ_CLUSTERS(torch.device(device), out, n_heads)
    return int(out.item())


def _check_qkv_heads(name: str, q, k, v) -> tuple[int, int, int, int]:
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, H, T, hd), got {tuple(q.shape)}")
    b, h, t, hd = q.shape
    _check_heads(name, h * hd, h)
    if oproj_split(h * hd) is None:
        raise ValueError(f"{name}: unsupported width D={h * hd} (a multiple of "
                         f"{PAIR}, at most {OPROJ_CLUSTER_MAX * 2 * PAIR})")
    for label, a in (("q", q), ("k", k), ("v", v)):
        _build.check(f"{name} {label}", a, torch.bfloat16, (b, h, t, hd))
    return b, h, t, hd


def _check_oproj(name: str, x, wo_i8, cso, bo, ln2_w, ln2_b, b: int, t: int, d: int) -> None:
    _build.check(f"{name} x", x, torch.bfloat16, (b, t, d))
    _build.check(f"{name} wo_i8", wo_i8, torch.int8, (d, d))
    _scales(f"{name} cso", cso, d)
    for label, a in (("bo", bo), ("ln2_w", ln2_w), ("ln2_b", ln2_b)):
        _build.check(f"{name} {label}", a, torch.float32, (d,))


def _launch_pair_codes(device, q, k, v, t_valid: int):
    b, h, t, hd = q.shape
    codes = torch.empty((b, t, h * hd), dtype=torch.int8, device=device)
    scales = torch.empty((b, t, h // 2), dtype=torch.float32, device=device)
    _PAIR_CODES(device, q, k, v, codes, scales, b, t, h, t_valid)
    return codes, scales


def _launch_oproj(device, codes, scales, x, wo_i8, cso, bo, ln2_w, ln2_b, eps):
    b, t, d = x.shape
    y = torch.empty((b, t, d), dtype=torch.bfloat16, device=device)
    h_out = torch.empty_like(y)
    _OPROJ(device, codes, scales, x, wo_i8, cso, bo, ln2_w, ln2_b, y, h_out, b * t, d, eps)
    return y, h_out


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
    all contiguous; an even head count with hd = 64 and D ≤ 2048."""
    if q.device.type == "cpu":
        return attn_oproj_ln_int8_plain(q, k, v, x, wo_i8, cso, bo, ln2_w,
                                        ln2_b, t_valid, eps)
    device = _build.require_cuda("attn_oproj_ln_int8", q, k, v, x, wo_i8, cso,
                                 bo, ln2_w, ln2_b)
    b, h, t, hd = _check_qkv_heads("attn_oproj_ln_int8", q, k, v)
    if not 1 <= t_valid <= t:
        raise ValueError(f"attn_oproj_ln_int8: t_valid={t_valid} outside [1, {t}]")
    _check_oproj("attn_oproj_ln_int8", x, wo_i8, cso, bo, ln2_w, ln2_b, b, t, h * hd)
    codes, scales = _launch_pair_codes(device, q, k, v, t_valid)    # scratch
    out = _launch_oproj(device, codes, scales, x, wo_i8, cso, bo, ln2_w, ln2_b, eps)
    LAUNCHES["attn_oproj_ln_int8"] += 1
    return out


def pair_codes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t_valid: int):
    """`attn_oproj_ln_int8`'s first launch alone, for checks and timing:
    head-major q, k, v → (codes (B, T, D) int8, scales (B, T, H / 2) f32),
    as `pair_codes_plain`."""
    if q.device.type == "cpu":
        return pair_codes_plain(q, k, v, t_valid)
    device = _build.require_cuda("pair_codes", q, k, v)
    t = _check_qkv_heads("pair_codes", q, k, v)[2]
    if not 1 <= t_valid <= t:
        raise ValueError(f"pair_codes: t_valid={t_valid} outside [1, {t}]")
    out = _launch_pair_codes(device, q, k, v, t_valid)
    PASS_LAUNCHES["pair_codes"] += 1
    return out


def oproj_ln_int8(codes: torch.Tensor, scales: torch.Tensor, x: torch.Tensor,
                  wo_i8: torch.Tensor, cso: torch.Tensor, bo: torch.Tensor,
                  ln2_w: torch.Tensor, ln2_b: torch.Tensor, eps: float = 1e-5):
    """`attn_oproj_ln_int8`'s second launch alone, for checks and timing:
    the pair codes (B, T, D) int8 and scales (B, T, H / 2) f32 → (y, h), as
    `oproj_ln_int8_plain`."""
    if codes.device.type == "cpu":
        return oproj_ln_int8_plain(codes, scales, x, wo_i8, cso, bo, ln2_w, ln2_b, eps)
    device = _build.require_cuda("oproj_ln_int8", codes, scales, x, wo_i8, cso, bo,
                                 ln2_w, ln2_b)
    if x.dim() != 3 or oproj_split(x.shape[-1]) is None:
        raise ValueError(f"oproj_ln_int8: unsupported x {tuple(x.shape)} (B, T, D) with D a "
                         f"multiple of {PAIR}, at most {OPROJ_CLUSTER_MAX * 2 * PAIR}")
    b, t, d = x.shape
    _build.check("oproj_ln_int8 codes", codes, torch.int8, (b, t, d))
    _build.check("oproj_ln_int8 scales", scales, torch.float32, (b, t, d // PAIR))
    _check_oproj("oproj_ln_int8", x, wo_i8, cso, bo, ln2_w, ln2_b, b, t, d)
    out = _launch_oproj(device, codes, scales, x, wo_i8, cso, bo, ln2_w, ln2_b, eps)
    PASS_LAUNCHES["oproj_ln_int8"] += 1
    return out


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
