"""W4A8 decode matmuls: group-affine int4 weights × per-row int8
activations, exact int32 dots per group, f32 only in the scale epilogue.

Replaces the TPU kernels of tpu_audio/ops/pallas/w4a8_matmul.py —
`w4a8_matmul` (:121), `w4a8_matmul_stacked` (:256), `w4a8_sg_matmul`
(:422) and `w4a8_sg_matmul_stacked` (:513) — with `csrc/w4a8_matmul.cu`:
one kernel template, four entry points. The stacked entries read layer
`layer` of an (L, O, I/2) weight by offsetting the pointer (the TPU's
scalar-prefetch layer select has no counterpart).

The formats (the contract, byte for byte as the JAX package packs them):
  - pair layout ("weight_q4p", `pack_w4a8`): byte 64p+j of a row holds
    column 128p+j (group 2p) in its low nibble and column 128p+64+j
    (group 2p+1) in its high nibble, the latter stored as (h − 8) mod 16.
    Codes q ∈ [0, 16), f32 scales and biases per group of 64 (O, I/64):
    w = s·q + b, the mlx checkpoint's group-affine int4 without loss.
    y = sx·Σ_g s[o,g]·(xq·q)_g + Σ_g b[o,g]·Σ_{i∈g} x_i.
  - super-group layout ("weight_q4s", `requantize_w4a8_sg`): signed codes
    c ∈ [−8, 7] against one f32 scale per 256 columns (O, I/256), the low
    nibble holding c + 8 and the high nibble c itself.
    y = sx·Σ_s S[o,s]·(xq·c)_s.
xq, sx are `quantize_rows(x)`: per-row absmax/127, round half to even,
clip ±127. The −8 bias of the stored high nibble and the ×1/16 folded into
the odd scales are Mosaic devices (it has no int8 vector shift); the kernel
folds the biases back in exact integers (8·Σxq of the plane) before the
scales.

Bound on the H100: device-memory bytes. At ≤ 32 rows every weight byte is
used at most 32 times, far below the ~295 op/byte ridge. Llama-3.2-3B's
tied head (156,940 × 3,072) streams 241 MB of codes and 61.6 MB of group
scales and biases: 302 MB, 0.090 ms at 3.35 TB/s; a layer's gateup
(16,384 × 3,072) 31.5 MB, 0.0094 ms; its super-group gateup 26.0 MB. Design
(in the .cu): at one row one launch; each block issues its first weight tiles
(16 channels over all I, or over a chunk of I where that does not fit) as
bulk copies into a shared-memory ring before it quantises the row itself. Above one row a rows kernel writes the codes and
the products run as its programmatic dependents, streaming their weights
before they wait on it. `mma.sync` s8 products of the nibble planes (made
valid s8 operands by masks), the 8 warps splitting a tile's 128-column
pairs, scales applied per warp in f32, the warps' sums added in a fixed
order (`tools/w4a8_order.py` models it on the CPU).

One routing difference from the TPU: there the super-group head at a
vocabulary no `block_o` divides (128,266) fails `sg_supported` and takes
the dequantised product; here one kernel takes any O, so it runs the
kernel, which differs from that product only by the int8 rounding of the
activations.

The plain versions follow the JAX functions step by step (the −8
corrections as f32 GEMMs on activation sums, the nibble planes as exact
f32 dots of integers); the tests hold them against the Pallas kernels in
interpret mode. The format helpers run in torch on the tensor's device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_audio_torch.ops.kernels import _build
from tpu_audio_torch.ops.kernels.int8_matmul import quantize_rows, true_div

GROUP = 64          # columns per affine group
PAIR = 2 * GROUP    # columns covered by one 64-byte span of a packed row
SUPER = 4 * GROUP   # columns sharing one scale in the super-group layout
MAX_ROWS = 32       # the weight-streaming regime; more rows take the dequantised product

LAUNCHES = {"w4a8_matmul": 0, "w4a8_matmul_stacked": 0, "w4a8_sg_matmul": 0,
            "w4a8_sg_matmul_stacked": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = _build.Kernel("tpa_w4a8_matmul", _P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I)


# ------------------------------------------------------------ the formats

def _as_int8(byte_values: torch.Tensor) -> torch.Tensor:
    """Values in [0, 256) → int8 tensor with those bits."""
    return byte_values.to(torch.uint8).view(torch.int8)


def pack_w4a8(q: torch.Tensor) -> torch.Tensor:
    """Unpacked int4 codes (…, O, I) in [0, 16) → pair-packed int8
    (…, O, I/2): byte 64p+j holds column 128p+j in the low nibble and
    column 128p+64+j in the high one, stored as (h − 8) mod 16."""
    *lead, o, i = q.shape
    if i % PAIR:
        raise ValueError(f"in_features {i} is not a multiple of {PAIR}")
    g3 = q.to(torch.int16).reshape(*lead, o, i // PAIR, PAIR)
    lo, hi = g3[..., :GROUP], g3[..., GROUP:]
    return _as_int8(lo | (((hi - 8) & 15) << 4)).reshape(*lead, o, i // 2)


def split_activations(xq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, I) int8 → the even- and odd-group halves (B, I/2), in packed
    byte order."""
    b, i = xq.shape
    g3 = xq.reshape(b, i // PAIR, PAIR)
    return g3[..., :GROUP].reshape(b, i // 2), g3[..., GROUP:].reshape(b, i // 2)


def requantize_w4a8_sg(scales: torch.Tensor, biases: torch.Tensor,
                       q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-affine int4 (codes q (O, I) in [0, 16), scales/biases (O, I/64))
    → super-group layout (packed int8 (O, I/2), f32 scales (O, I/256)):
    each 256-column super-group recoded as signed int4 against
    S = max(w_max/7, −w_min/8). Lossy. The JAX function's f32 arithmetic,
    on q's device, so bytes and scales come out equal."""
    o, i = q.shape
    if i % SUPER:
        raise ValueError(f"in_features {i} is not a multiple of {SUPER}")
    w = (q.float().reshape(o, -1, GROUP) * scales.float()[..., None]
         + biases.float()[..., None]).reshape(o, i)
    wsg = w.reshape(o, i // SUPER, SUPER)
    s = torch.clamp(torch.maximum(true_div(wsg.amax(-1), 7.0), true_div(wsg.amin(-1), -8.0)),
                    min=1e-8)
    c = torch.clamp(torch.round(wsg / s[..., None]), -8, 7).reshape(o, i // PAIR, PAIR)
    c = c.to(torch.int16)
    lo, hi = (c[..., :GROUP] + 8) & 15, c[..., GROUP:] & 15
    return _as_int8(lo | (hi << 4)).reshape(o, i // 2), s


def dequantize_w4a8(wp: torch.Tensor, scales: torch.Tensor,
                    biases: torch.Tensor) -> torch.Tensor:
    """Pair-packed (…, O, I/2) with (…, O, I/64) scales and biases →
    (…, O, I) f32."""
    *lead, o, half = wp.shape
    npair = half // GROUP
    lo = (wp & 15).float().reshape(*lead, o, npair, GROUP)
    # arithmetic >> 4 sign-extends the stored (h − 8); + 8 gives the code
    hi = ((wp >> 4) + 8).float().reshape(*lead, o, npair, GROUP)
    q = torch.cat([lo, hi], dim=-1).reshape(*lead, o, 2 * npair, GROUP)
    w = q * scales.float()[..., None] + biases.float()[..., None]
    return w.reshape(*lead, o, 2 * half)


def dequantize_w4a8_sg(wp: torch.Tensor, scales_sg: torch.Tensor) -> torch.Tensor:
    """Super-group packed (…, O, I/2) with (…, O, I/256) scales →
    (…, O, I) f32."""
    *lead, o, half = wp.shape
    npair = half // GROUP
    lo = ((wp & 15) - 8).float().reshape(*lead, o, npair, GROUP)
    hi = ((wp & -16).float() / 16.0).reshape(*lead, o, npair, GROUP)
    c = torch.cat([lo, hi], dim=-1).reshape(*lead, o, 2 * half)
    return c * scales_sg.float().repeat_interleave(SUPER, dim=-1)


# ------------------------------------------------------------ plain

def _plane_dots(xs: torch.Tensor, ws: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N) codes · (O, N) codes, summed in spans of k packed columns →
    (B, N/k, O). f32 holds every partial sum exactly (|sum| < 2^24), so the
    result is the exact integer dot whatever the summation order."""
    b, n = xs.shape
    o = ws.shape[0]
    return torch.einsum("bpk,opk->bpo", xs.float().reshape(b, n // k, k),
                        ws.float().reshape(o, n // k, k))


def w4a8_matmul_plain(x: torch.Tensor, wp: torch.Tensor, scales: torch.Tensor,
                      biases: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `w4a8_matmul`, step by step as the JAX
    function: the affine term on exact f32 group sums of x, the −8 bias of
    the odd groups as a GEMM on their int8 sums, the kernel's per-group
    dots with the odd scales divided by 16."""
    b, i = x.shape
    g, p = i // GROUP, i // PAIR
    xq, sx = quantize_rows(x)
    x_lo, x_hi = split_activations(xq)
    xsum = x.float().reshape(b, g, GROUP).sum(-1)
    y_bias = xsum @ biases.float().T
    s_odd = scales.float()[:, 1::2]
    xqsum_odd = x_hi.float().reshape(b, p, GROUP).sum(-1)
    y_bias = y_bias + 8.0 * sx * (xqsum_odd @ s_odd.T)
    dlo = _plane_dots(x_lo, wp & 15, GROUP)
    dhi = _plane_dots(x_hi, wp & -16, GROUP)
    se = scales.float()[:, 0::2].T                      # (P, O)
    so = (s_odd * (1.0 / 16.0)).T
    acc = (dlo * se + dhi * so).sum(1)
    return acc * sx + y_bias


def w4a8_matmul_stacked_plain(x: torch.Tensor, wp_st: torch.Tensor, scales: torch.Tensor,
                              biases: torch.Tensor, layer: int) -> torch.Tensor:
    """Plain PyTorch version of `w4a8_matmul_stacked`."""
    return w4a8_matmul_plain(x, wp_st[layer], scales, biases)


def w4a8_sg_matmul_plain(x: torch.Tensor, wp: torch.Tensor,
                         scales_sg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `w4a8_sg_matmul`, step by step as the JAX
    function: the +8 of the low plane folded out as a GEMM on the int8
    sums of the even columns, k = 128 plane dots per super-group."""
    b, i = x.shape
    xq, sx = quantize_rows(x)
    x_lo, x_hi = split_activations(xq)
    xlo_sum = x_lo.float().reshape(b, i // SUPER, PAIR).sum(-1)
    y_bias = -8.0 * sx * (xlo_sum @ scales_sg.float().T)
    dlo = _plane_dots(x_lo, wp & 15, PAIR)
    dhi = _plane_dots(x_hi, wp & -16, PAIR)
    acc = ((dlo + dhi * 0.0625) * scales_sg.float().T).sum(1)
    return acc * sx + y_bias


def w4a8_sg_matmul_stacked_plain(x: torch.Tensor, wp_st: torch.Tensor,
                                 scales_sg: torch.Tensor, layer: int) -> torch.Tensor:
    """Plain PyTorch version of `w4a8_sg_matmul_stacked`."""
    return w4a8_sg_matmul_plain(x, wp_st[layer], scales_sg)


# ------------------------------------------------------------ kernels

def supported(x: torch.Tensor, wp: torch.Tensor, sg: bool = False) -> bool:
    """The format's own shape rule: (B, I) activations with I a multiple of
    128 (pair layout) or 256 (super-group) matching the packed width. Any O."""
    i = x.shape[-1]
    return (x.dim() == 2 and i % (SUPER if sg else PAIR) == 0
            and wp.shape[-1] * 2 == i)


@functools.lru_cache(maxsize=None)
def _work_bytes(rows: int, in_features: int) -> int:
    """Scratch of a call (the codes, scales and group sums its rows kernel
    writes; none at one row, where the products quantise the row)."""
    fn = _build.library().tpa_w4a8_work_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_long
    return fn(rows, in_features)


def _launch(name: str, x: torch.Tensor, wp: torch.Tensor, scales: torch.Tensor,
            biases: torch.Tensor | None, layer: int) -> torch.Tensor:
    sg = biases is None
    tensors = (x, wp, scales) if sg else (x, wp, scales, biases)
    device = _build.require_cuda(name, *tensors)
    if x.dim() != 2 or wp.dim() != 3:
        raise ValueError(f"{name}: x must be (B, I), got {tuple(x.shape)}")
    b, i = x.shape
    lyr, o, _ = wp.shape
    if not 1 <= b <= MAX_ROWS or not supported(x, wp, sg):
        raise ValueError(f"{name}: unsupported rows={b}, in_features={i}, "
                         f"packed width {wp.shape[-1]}")
    if not 0 <= layer < lyr:
        raise ValueError(f"{name}: layer={layer} outside [0, {lyr})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    _build.check(f"{name} x", x, x.dtype, (b, i))
    _build.check(f"{name} packed", wp, torch.int8, (lyr, o, i // 2))
    _build.check(f"{name} scales", scales, torch.float32, (o, i // (SUPER if sg else GROUP)))
    if not sg:
        _build.check(f"{name} biases", biases, torch.float32, (o, i // GROUP))
    n_work = _work_bytes(b, i)
    work = torch.empty(n_work, dtype=torch.uint8, device=device) if n_work else None
    out = torch.empty((b, o), dtype=torch.float32, device=device)
    _KERNEL(device, x, int(x.dtype == torch.bfloat16), wp, scales, biases, int(sg), work, out,
            b, i, o, int(layer))
    LAUNCHES[name] += 1
    return out


def w4a8_matmul(x: torch.Tensor, wp: torch.Tensor, scales: torch.Tensor,
                biases: torch.Tensor) -> torch.Tensor:
    """x (B, I) float · pair-packed int4 (O, I/2) with f32 scales and
    biases (O, I/64) → (B, O) f32.

    On CUDA: 1 ≤ B ≤ 32, x f32 or bf16, I a multiple of 128, all
    contiguous; any O."""
    if x.device.type == "cpu":
        return w4a8_matmul_plain(x, wp, scales, biases)
    return _launch("w4a8_matmul", x, wp[None], scales, biases, 0)


def w4a8_matmul_stacked(x: torch.Tensor, wp_st: torch.Tensor, scales: torch.Tensor,
                        biases: torch.Tensor, layer: int) -> torch.Tensor:
    """x (B, I) · layer `layer` of stacked pair-packed int4 (L, O, I/2);
    scales and biases are this layer's (O, I/64). Rules of `w4a8_matmul`."""
    if x.device.type == "cpu":
        return w4a8_matmul_stacked_plain(x, wp_st, scales, biases, layer)
    return _launch("w4a8_matmul_stacked", x, wp_st, scales, biases, layer)


def w4a8_sg_matmul(x: torch.Tensor, wp: torch.Tensor, scales_sg: torch.Tensor) -> torch.Tensor:
    """x (B, I) float · super-group signed int4 (O, I/2) with f32 scales
    (O, I/256) → (B, O) f32. On CUDA: as `w4a8_matmul`, I a multiple of 256."""
    if x.device.type == "cpu":
        return w4a8_sg_matmul_plain(x, wp, scales_sg)
    return _launch("w4a8_sg_matmul", x, wp[None], scales_sg, None, 0)


def w4a8_sg_matmul_stacked(x: torch.Tensor, wp_st: torch.Tensor, scales_sg: torch.Tensor,
                           layer: int) -> torch.Tensor:
    """x (B, I) · layer `layer` of stacked super-group int4 (L, O, I/2);
    scales_sg is this layer's (O, I/256)."""
    if x.device.type == "cpu":
        return w4a8_sg_matmul_stacked_plain(x, wp_st, scales_sg, layer)
    return _launch("w4a8_sg_matmul_stacked", x, wp_st, scales_sg, None, layer)
