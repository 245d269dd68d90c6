"""Group-affine q4/q8 dequant-matmul (the MLX checkpoint format) at ≤ 32
rows: y = x · (q · s + b)ᵀ in f32.

Replaces the TPU kernel tpu_audio/ops/pallas/quant_matmul.py:quant_matmul
with `csrc/quant_matmul.cu`. The TPU kernel's nibble planes and its 0/1
expansion matmul for the group scales are Mosaic devices; here the codes
go to the tensor cores as exact bf16 operands (q − 8, or q8's two nibble
planes) against x split into exact bf16 terms, and each group's affine
folds in as s · Σ x (q − c) + (b + c s) · Σ x.

Bound on the H100: device-memory bytes, 0.5 (q4) or 1 (q8) byte a weight
plus 8 bytes of scale and bias per 64 weights; at Qwen3-0.6B's tied lm head
97.2 MB a call. Design in the .cu: one launch for all 1-32 rows, 16-channel
tiles streamed by a producer warp into a ring of stages before the kernel
waits on the kernel before it (a programmatic dependent launch), x read
in its own dtype, the columns split over a cluster's blocks only where the
terms of x would not fit in shared memory. Where no plan holds all the
rows (f32 x of 32 rows at K 8192, the Llama-3.2-3B down projection: their
exact bf16 terms overflow a block's shared memory even split over a
cluster of 8), the rows go in as few launches as the plan allows
(`rows_a_launch`). `LAUNCHES` counts device launches.

The packed words are int32 tensors holding the uint32 bits (torch has few
uint32 operations); `unpack_words` masks the sign extension off.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_audio_torch.ops.kernels import _build

MAX_ROWS = 32   # the weight-streaming regime; more rows take the dequantised product
GROUP = 64      # the group size the kernel takes
TILE = 16       # output channels of the kernel's tile
X_DTYPES = (torch.float32, torch.bfloat16)  # what the kernel reads x as

LAUNCHES = {"quant_matmul": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_KERNEL = _build.Kernel("tpa_quant_matmul", _P, _I, _L, _P, _P, _P, _P, _I, _I, _I, _I)
_PLAN = _build.Kernel("tpa_quant_matmul_plan", _I, _I, _I, _I, _I, _P)


def unpack_words(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(…, W) words (int32 or int64 with the uint32 bits) → (…, W·32/bits)
    int32 codes in [0, 2^bits), low bits first."""
    per = 32 // bits
    shifts = torch.arange(per, device=packed.device, dtype=torch.int64) * bits
    vals = (packed.to(torch.int64)[..., None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(*packed.shape[:-1], packed.shape[-1] * per).to(torch.int32)


def dequantize_words(packed: torch.Tensor, scales: torch.Tensor, biases: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """(…, O, W) words with (…, O, G) scales and biases → (…, O, I) f32."""
    q = unpack_words(packed, bits).float()
    group = q.shape[-1] // scales.shape[-1]
    return (q * scales.float().repeat_interleave(group, dim=-1)
            + biases.float().repeat_interleave(group, dim=-1))


def quant_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                       biases: torch.Tensor, *, bits: int = 4) -> torch.Tensor:
    """Plain PyTorch version of `quant_matmul`."""
    return x.float() @ dequantize_words(packed, scales, biases, bits).T


def slice_groups(groups: int, slices: int, s: int) -> range:
    """The groups of 64 columns that slice s of `slices` covers (the .cu's
    rule: slice s takes [s G / S, (s + 1) G / S))."""
    return range(s * groups // slices, (s + 1) * groups // slices)


def span_channels(span: int, tiles_a_span: int, out_features: int) -> range:
    """The output channels of span `span` (a stage of the kernel's ring:
    `tiles_a_span` tiles of TILE channels)."""
    width = TILE * tiles_a_span
    return range(span * width, min(out_features, (span + 1) * width))


def block_work(block: int, grid: int, slices: int, spans: int) -> list[tuple[int, int]]:
    """The (span, slice) pairs that block `block` of a launch of `grid`
    blocks computes (the .cu's map: blocks in clusters of `slices`, the
    block's slice its rank, the cluster's spans c, c + clusters, …)."""
    rank, cl, clusters = block % slices, block // slices, grid // slices
    return [(span, rank) for span in range(cl, spans, clusters)]


def launch_plan(device: torch.device, rows: int, in_features: int, out_features: int, *,
                bits: int, x_dtype: torch.dtype) -> dict:
    """The launch a call of these sizes takes on `device`, without
    launching: slices, blocks an SM, ring stages, shared memory bytes of a
    block, 8-column tiles of the (row, term) columns, channel tiles, tiles
    a span."""
    out = torch.zeros(7, dtype=torch.int32)
    _PLAN(device, rows, in_features, out_features, bits, int(x_dtype == torch.bfloat16), out)
    return dict(zip(("slices", "per_sm", "stages", "smem", "col_tiles", "tiles",
                     "tiles_a_span"), out.tolist()))


@functools.lru_cache(maxsize=None)
def rows_a_launch(device: torch.device, rows: int, in_features: int, out_features: int,
                  bits: int, x_dtype: torch.dtype) -> int:
    """The most rows of x one launch takes at these sizes: `rows`, or where
    no plan holds them, the largest of rows / 2, rows / 4, … (rounded up)
    that one does."""
    n = rows
    while n > 1:
        try:
            launch_plan(device, n, in_features, out_features, bits=bits, x_dtype=x_dtype)
            return n
        except RuntimeError:
            n = (n + 1) // 2
    return 1


def quant_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                 biases: torch.Tensor, *, bits: int = 4) -> torch.Tensor:
    """x (B, I) float · dequant(packed (O, I·bits/32), scales and biases
    (O, I/64))ᵀ → (B, O) f32.

    On CUDA: 1 ≤ B ≤ 32, x f32 or bf16, read as it is and widened exactly
    in the kernel, as the TPU kernel widens it (rows may lie apart; a
    layout whose rows are not contiguous and 16-byte aligned is copied
    first); bits 4 or 8, group 64, packed int32, scales and biases f32,
    all contiguous. Rows that no single launch's plan holds go in several
    launches (`rows_a_launch`). A launch that the card or the kernel
    refuses raises."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, packed, scales, biases, bits=bits)
    device = _build.require_cuda("quant_matmul", x, packed, scales, biases)
    if x.dim() != 2 or bits not in (4, 8) or x.dtype not in X_DTYPES:
        raise ValueError(f"quant_matmul: x must be (B, I) f32 or bf16 and bits 4 or 8, got "
                         f"{tuple(x.shape)} {x.dtype}, bits {bits}")
    b, i = x.shape
    o = packed.shape[0]
    if not 1 <= b <= MAX_ROWS or i % GROUP:
        raise ValueError(f"quant_matmul: unsupported rows={b} or in_features={i}")
    _build.check("quant_matmul packed", packed, torch.int32, (o, i * bits // 32))
    _build.check("quant_matmul scales", scales, torch.float32, (o, i // GROUP))
    _build.check("quant_matmul biases", biases, torch.float32, (o, i // GROUP))
    step = rows_a_launch(device, b, i, o, bits, x.dtype)
    if step < b:
        return torch.cat([quant_matmul(x[r:r + step], packed, scales, biases, bits=bits)
                          for r in range(0, b, step)])
    ldx = x.stride(0) if b > 1 else i
    if x.stride(1) != 1 or (ldx * x.element_size()) % 16 or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)  # a copy, only for such layouts
        ldx = i
    out = torch.empty((b, o), dtype=torch.float32, device=device)
    _KERNEL(device, x, int(x.dtype == torch.bfloat16), ldx, packed, scales, biases,
            out, b, i, o, bits)
    LAUNCHES["quant_matmul"] += 1
    return out
