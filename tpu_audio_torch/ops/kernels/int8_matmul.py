"""W8A8 weight-streaming matmul: per-row int8 activations × per-channel
int8 weights, exact int32 accumulation, × row scale × channel scale.

Replaces the TPU kernels tpu_audio/ops/pallas/int8_matmul.py:int8_matmul
and tpu_audio/ops/pallas/int8_matmul.py:int8_matmul_stacked with
`csrc/int8_matmul.cu`: one kernel, two entry points. The stacked one reads
layer `layer` of an (L, O, I) weight by offsetting the pointer; indexing a
stacked tensor is free here, so the TPU's scalar-prefetch layer select has
no counterpart.

Bound on the H100: device-memory bytes. At ≤ 32 rows every weight byte is
used at most 32 times, far below the ~295 op/byte ridge: the lm head at
large-v3-turbo reads 66.4 MB of int8 weights per call. Design: a first
kernel quantises the activation rows (`quantize_rows`, round half to even
like `torch.round`), the second keeps the codes in shared memory, streams
16-byte weight vectors (one warp per output channel) and accumulates with
`__dp4a`; the epilogue applies × row scale × channel scale. Any O works,
the lm head's 51866 included (the TPU's ragged tail needs no special case).

`int8_matmul_bigm` is the large-M branch (encoder, prefill, cross-K/V
projection). In the JAX package it is an XLA dot, not a Pallas kernel, so
here it is `torch._int_mm` (cuBLASLt s8×s8→s32) on CUDA and an exact int32
product on the CPU.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpu_audio_torch.ops.kernels import _build

MAX_ROWS = 32     # the weight-streaming regime; more rows take int8_matmul_bigm

LAUNCHES = {"int8_matmul": 0, "int8_matmul_stacked": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = _build.Kernel("tpa_int8_matmul", _P, _I, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I)


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once, on any device: CUDA divides by a Python scalar as
    a product with its reciprocal, one ulp off for some a."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (B, I) float → ((B, I) int8, (B, 1) f32)."""
    xf = x.float()
    sx = torch.clamp(true_div(xf.abs().amax(dim=-1, keepdim=True), 127.0), min=1e-10)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def int8_matmul_plain(x: torch.Tensor, w_i8: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `int8_matmul`."""
    xq, sx = quantize_rows(x)
    # f64 holds every s8×s8 sum exactly (|acc| < 2^53), on any device; the
    # cast to f32 rounds it as the int32 → f32 conversion does
    acc = xq.double() @ w_i8.double().T
    return acc.float() * sx * scale.reshape(1, -1).float()


def int8_matmul_stacked_plain(x: torch.Tensor, w_st: torch.Tensor,
                              scale: torch.Tensor, layer: int) -> torch.Tensor:
    """Plain PyTorch version of `int8_matmul_stacked`."""
    return int8_matmul_plain(x, w_st[layer], scale)


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
            layer: int) -> torch.Tensor:
    device = _build.require_cuda(name, x, w, scale)
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"{name}: x must be (B, I), got {tuple(x.shape)}")
    b, i = x.shape
    lyr, o, _ = w.shape
    if not 1 <= b <= MAX_ROWS or i % 16:
        raise ValueError(f"{name}: unsupported rows={b} or in_features={i}")
    if not 0 <= layer < lyr:
        raise ValueError(f"{name}: layer={layer} outside [0, {lyr})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    _build.check(f"{name} x", x, x.dtype, (b, i))
    _build.check(f"{name} w", w, torch.int8, (lyr, o, i))
    if (scale.dtype != torch.float32 or scale.numel() != o
            or not scale.is_contiguous()):
        raise ValueError(f"{name}: scale must be {o} contiguous f32 values")
    xq = torch.empty((b, i), dtype=torch.int8, device=device)
    sx = torch.empty((b,), dtype=torch.float32, device=device)
    out = torch.empty((b, o), dtype=torch.float32, device=device)
    _KERNEL(device, x, int(x.dtype == torch.bfloat16), w, scale, xq, sx, out,
            b, i, o, int(layer))
    LAUNCHES[name] += 1
    return out


def int8_matmul(x: torch.Tensor, w_i8: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (B, I) float · (w_i8 (O, I) int8 · scale (O, 1)).T → (B, O) f32.

    On CUDA: B ≤ 32, x f32 or bf16, I a multiple of 16, all contiguous."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_i8, scale)
    return _launch("int8_matmul", x, w_i8[None], scale, 0)


def int8_matmul_stacked(x: torch.Tensor, w_st: torch.Tensor,
                        scale: torch.Tensor, layer: int) -> torch.Tensor:
    """x (B, I) float · layer `layer` of stacked int8 weights (L, O, I);
    scale is this layer's (O, 1) f32. Same rules as `int8_matmul`."""
    if x.device.type == "cpu":
        return int8_matmul_stacked_plain(x, w_st, scale, layer)
    return _launch("int8_matmul_stacked", x, w_st, scale, layer)


def int8_matmul_bigm(x: torch.Tensor, w_i8: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Large-M W8A8 GEMM: x (M, I) float → (M, O) f32 =
    (quantize_rows(x) · w_i8ᵀ) · sx · scaleᵀ with exact int32 sums.

    On CUDA `torch._int_mm` takes M > 16 and I, O multiples of 8: O is
    padded with zero rows (the lm head's 51866) and cut off again."""
    xq, sx = quantize_rows(x)
    if x.device.type == "cuda":
        o = w_i8.shape[0]
        w = F.pad(w_i8, (0, 0, 0, -o % 8)) if o % 8 else w_i8
        acc = torch._int_mm(xq, w.T)[:, :o]
    else:
        acc = xq.int() @ w_i8.int().T
    return acc.float() * sx * scale.reshape(1, -1).float()
