"""W8A8 weight-streaming matmul: per-row int8 activations × per-channel
int8 weights, exact int32 accumulation, × row scale × channel scale; in
f32, or cast once to x's dtype and plus a bias (what `ops/quant.int8_linear`
returns).

Replaces the TPU kernels tpu_audio/ops/pallas/int8_matmul.py:int8_matmul
and tpu_audio/ops/pallas/int8_matmul.py:int8_matmul_stacked with
`csrc/int8_matmul.cu`: one kernel, two entry points. The stacked one reads
layer `layer` of an (L, O, I) weight by offsetting the pointer; indexing a
stacked tensor is free here, so the TPU's scalar-prefetch layer select has
no counterpart.

Bound on the H100: device-memory bytes. At ≤ 32 rows every weight byte is
used at most 32 times, far below the ~295 op/byte ridge: the lm head at
large-v3-turbo reads 66.4 MB of int8 weights per call. Design in the .cu:
one launch a call, no workspace. A producer warp streams 16-channel tiles
by bulk copies into a ring before the kernel waits on the kernel before it
(a programmatic dependent launch); 16 consumer warps quantise the rows
inside the kernel, as `quantize_rows` does (round half to even like
`torch.round`), with the columns split over a cluster of `plan`'s C blocks
where one block would code too much of x (their partial row maxima and
int32 sums meet through DSMEM); `mma.sync` s8 on the codes; the cast and
the bias in the epilogue. Any O works, the lm head's 51866 included.
`LAUNCHES` counts calls, each one device launch.

`int8_matmul_bigm` is the large-M branch (encoder, prefill, cross-K/V
projection). In the JAX package it is an XLA dot, not a Pallas kernel, so
here it is `torch._int_mm` (cuBLASLt s8×s8→s32) on CUDA and an exact int32
product on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tpu_audio_torch.ops.kernels import _build

MAX_ROWS = 32     # the weight-streaming regime; more rows take int8_matmul_bigm
TILE = 16         # output channels of the kernel's tile
CHUNK = 64        # columns of the kernel's unit of a slice
SLICES = (1, 2, 4, 8)
QUANT_VALUES = 32768  # values of x a block codes, at most, where more slices allow
ROW_BYTES = 192 << 10  # codes and a stage: (rows + 16) rows of a slice's bytes, at most
HEAD_TILES = 8       # tiles an SM from which a call takes one slice (the heads)
DTYPES = (torch.float32, torch.bfloat16)  # x, the output, the bias

LAUNCHES = {"int8_matmul": 0, "int8_matmul_stacked": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = _build.Kernel("tpa_int8_matmul", _P, _I, _P, _P, _P, _I, _P, _I,
                        _I, _I, _I, _I, _I)
_PLAN = _build.Kernel("tpa_int8_matmul_plan", _I, _I, _I, _I, _I, _P)


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


def int8_matmul_plain(x: torch.Tensor, w_i8: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor | None = None, *,
                      out_dtype: torch.dtype = torch.float32,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of `int8_matmul`."""
    xq, sx = quantize_rows(x)
    # f64 holds every s8×s8 sum exactly (|acc| < 2^53), on any device; the
    # cast to f32 rounds it as the int32 → f32 conversion does
    acc = xq.double() @ w_i8.double().T
    y = (acc.float() * sx * scale.reshape(1, -1).float()).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y if out is None else out.copy_(y)


def int8_matmul_stacked_plain(x: torch.Tensor, w_st: torch.Tensor, scale: torch.Tensor,
                              layer: int, bias: torch.Tensor | None = None, *,
                              out_dtype: torch.dtype = torch.float32,
                              out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of `int8_matmul_stacked`."""
    return int8_matmul_plain(x, w_st[layer], scale, bias, out_dtype=out_dtype, out=out)


# --------------------------------------------------------- the launch's map

def slice_columns(in_features: int, slices: int, rank: int) -> range:
    """The columns that rank `rank` of a cluster of `slices` blocks
    quantises and multiplies (the .cu's rule: 64-column chunks, rank r
    taking chunks [r n / C, (r + 1) n / C))."""
    n = -(-in_features // CHUNK)
    return range(CHUNK * (rank * n // slices),
                 min(in_features, CHUNK * ((rank + 1) * n // slices)))


def tile_channels(tile: int, out_features: int) -> range:
    """The output channels of tile `tile`."""
    return range(tile * TILE, min(out_features, (tile + 1) * TILE))


def block_work(block: int, grid: int, slices: int, tiles: int) -> list[tuple[int, int]]:
    """The (tile, slice) pairs that block `block` of a launch of `grid`
    blocks computes (the .cu's map: blocks in clusters of `slices`, the
    block's slice its rank, the cluster's tiles c, c + clusters, …)."""
    rank, cl, clusters = block % slices, block // slices, grid // slices
    return [(tile, rank) for tile in range(cl, tiles, clusters)]


@functools.lru_cache(maxsize=None)
def plan(rows: int, in_features: int, out_features: int, n_sm: int) -> int:
    """The column slices C of a call on a card of `n_sm` SMs, which the
    wrapper hands to the launch. One where there are HEAD_TILES tiles an SM
    or more (the heads: the stream of weights is the time, and the rows'
    codes are made while the ring fills); else the fewest at which a block
    codes at most QUANT_VALUES values of x (every block codes all rows of
    its columns) and its codes and a stage fit (ROW_BYTES rows of them)."""
    tiles = -(-out_features // TILE)
    chunks = -(-in_features // CHUNK)
    if tiles >= HEAD_TILES * n_sm:
        return 1
    usable = [c for c in SLICES if c <= chunks]
    for c in usable:
        width = CHUNK * -(-chunks // c)
        if rows * width <= QUANT_VALUES and (rows + TILE) * width <= ROW_BYTES:
            return c
    return usable[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_plan(device: torch.device, rows: int, in_features: int, out_features: int, *,
                x_dtype: torch.dtype, slices: int | None = None) -> dict:
    """The launch a call of these sizes takes on `device` (at `plan`'s
    slices, or those given), without launching: slices, ring stages, shared
    memory bytes of a block, blocks, clusters, bytes a staged row, 8-row
    tiles of the codes, and whether a warp takes whole tiles (1)."""
    if slices is None:
        slices = plan(rows, in_features, out_features, _sm_count(device))
    out = torch.zeros(7, dtype=torch.int32)
    _PLAN(device, rows, in_features, out_features, int(x_dtype == torch.bfloat16), slices, out)
    return {"slices": slices, **dict(zip(
        ("stages", "smem", "blocks", "clusters", "row_bytes", "row_tiles", "wide"),
        out.tolist()))}


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, layer: int,
            bias: torch.Tensor | None, out_dtype: torch.dtype,
            out: torch.Tensor | None) -> torch.Tensor:
    extra = [t for t in (bias, out) if t is not None]
    device = _build.require_cuda(name, x, w, scale, *extra)
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"{name}: x must be (B, I), got {tuple(x.shape)}")
    b, i = x.shape
    lyr, o, _ = w.shape
    if not 1 <= b <= MAX_ROWS or i % 16:
        raise ValueError(f"{name}: unsupported rows={b} or in_features={i}")
    if not 0 <= layer < lyr:
        raise ValueError(f"{name}: layer={layer} outside [0, {lyr})")
    if x.dtype not in DTYPES or out_dtype not in DTYPES:
        raise ValueError(f"{name}: x and the output must be f32 or bf16, got {x.dtype} "
                         f"and {out_dtype}")
    _build.check(f"{name} x", x, x.dtype, (b, i))
    _build.check(f"{name} w", w, torch.int8, (lyr, o, i))
    if (scale.dtype != torch.float32 or scale.numel() != o
            or not scale.is_contiguous()):
        raise ValueError(f"{name}: scale must be {o} contiguous f32 values")
    if bias is not None and (bias.dtype not in DTYPES or bias.numel() != o
                             or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be {o} contiguous f32 or bf16 values")
    if out is None:
        out = torch.empty((b, o), dtype=out_dtype, device=device)
    else:
        _build.check(f"{name} out", out, out_dtype, (b, o))
    kind = 0 if bias is None else 1 if bias.dtype == torch.float32 else 2
    _KERNEL(device, x, int(x.dtype == torch.bfloat16), w, scale, bias, kind, out,
            int(out_dtype == torch.bfloat16), b, i, o, int(layer),
            plan(b, i, o, _sm_count(device)))
    LAUNCHES[name] += 1
    return out


def int8_matmul(x: torch.Tensor, w_i8: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor | None = None, *, out_dtype: torch.dtype = torch.float32,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, I) float · (w_i8 (O, I) int8 · scale (O, 1)).T → (B, O) in
    `out_dtype`: the f32 product cast once to it, then plus `bias` (O) cast
    to it, if given; into `out` (B, O) if given.

    On CUDA: B ≤ 32, x, the output and the bias f32 or bf16, I a multiple
    of 16, all contiguous. One device launch; a launch that the card or the
    kernel refuses raises."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_i8, scale, bias, out_dtype=out_dtype, out=out)
    return _launch("int8_matmul", x, w_i8[None], scale, 0, bias, out_dtype, out)


def int8_matmul_stacked(x: torch.Tensor, w_st: torch.Tensor, scale: torch.Tensor,
                        layer: int, bias: torch.Tensor | None = None, *,
                        out_dtype: torch.dtype = torch.float32,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, I) float · layer `layer` of stacked int8 weights (L, O, I);
    scale is this layer's (O, 1) f32. Same rules as `int8_matmul`."""
    if x.device.type == "cpu":
        return int8_matmul_stacked_plain(x, w_st, scale, layer, bias, out_dtype=out_dtype,
                                         out=out)
    return _launch("int8_matmul_stacked", x, w_st, scale, layer, bias, out_dtype, out)


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
