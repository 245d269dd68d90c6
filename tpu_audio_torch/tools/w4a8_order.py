"""The W4A8 decode kernel's order on the CPU (`csrc/w4a8_matmul.cu`): the
k-slot order of its m16n8k32 products, its nibble planes as s8 operands,
and its order of summation, for the tests and `chip_smoke.py`'s planted
faults to hold against the plain versions."""

from __future__ import annotations

import torch

from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm

WARPS = 8  # the kernel's warps a block: warp w sums pairs w, w + 8, …


def mma_k_order() -> torch.Tensor:
    """The byte of a 64-byte span of a packed row (and of the activations
    beside it) in each of the 64 k-slots of the kernel's two m16n8k32 steps:
    lane t holds bytes 16t.. of the span, its words 0 and 1 in the first
    step's slots 4t.. and 16 + 4t.., words 2 and 3 in the second's."""
    k = torch.arange(2 * 32)
    step, slot = k // 32, k % 32
    return 16 * ((slot % 16) // 4) + 4 * (2 * step + slot // 16) + slot % 4


def kernel_planes(wp: torch.Tensor, sg: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The two nibble planes of packed bytes as the kernel's s8 operands, by
    its masks: the pair layout's codes q and h (the stored (h − 8) mod 16
    with bit 3 flipped), the super-group layout's 16·c of each plane."""
    w = wp.to(torch.int16) & 255
    if sg:
        lo, hi = ((w ^ 8) << 4) & 0xF0, w & 0xF0
        return torch.where(lo > 127, lo - 256, lo), torch.where(hi > 127, hi - 256, hi)
    return w & 15, ((w >> 4) & 15) ^ 8


def mma_dots(xq: torch.Tensor, wp: torch.Tensor, sg: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's exact integer dots of each 128-column pair (B, I/128, O),
    low plane and high plane: its planes in its k-slot order, in f64 (which
    holds them exactly on any device)."""
    b, i = xq.shape
    o, npair = wp.shape[0], i // w4mm.PAIR
    order = mma_k_order().to(xq.device)

    def dots(xs, ws):
        return torch.einsum("bpk,opk->bpo", xs.double().reshape(b, npair, w4mm.GROUP)[..., order],
                            ws.double().reshape(o, npair, w4mm.GROUP)[..., order])

    w_lo, w_hi = kernel_planes(wp, sg)
    x_lo, x_hi = w4mm.split_activations(xq)
    return dots(x_lo, w_lo), dots(x_hi, w_hi)


def mma_partials(xq: torch.Tensor, sx: torch.Tensor, xsum: torch.Tensor | None,
                 wp: torch.Tensor, scales: torch.Tensor,
                 biases: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's order of summation: (B, WARPS, O) f32, warp w's share,
    its pairs p = w, w + WARPS, … in order, each pair's `mma_dots` scaled in
    f32, then × sx plus (pair layout) the biases against the group sums
    `xsum` (B, I/64). The kernel adds the warps' shares in order 0, 1, ….
    xq, sx: `quantize_rows(x)`; biases None selects the super-group layout."""
    sg = biases is None
    b, i = xq.shape
    o, npair = wp.shape[0], i // w4mm.PAIR
    d_lo, d_hi = mma_dots(xq, wp, sg)
    if sg:  # both planes hold 16 c: their sum / 16 is exact
        terms = scales.float().T.repeat_interleave(2, 0) * ((d_lo + d_hi) / 16).float()
        bias = torch.zeros_like(terms)
    else:
        terms = scales.float()[:, 0::2].T * d_lo.float() + scales.float()[:, 1::2].T * d_hi.float()
        xs = xsum.float().reshape(b, npair, 2, 1)
        bias = biases.float()[:, 0::2].T * xs[:, :, 0] + biases.float()[:, 1::2].T * xs[:, :, 1]
    parts = []
    for w in range(WARPS):
        acc, bac = torch.zeros((b, o), device=xq.device), torch.zeros((b, o), device=xq.device)
        for p in range(w, npair, WARPS):
            acc, bac = acc + terms[:, p], bac + bias[:, p]
        parts.append(acc * sx.reshape(b, 1) + bac)
    return torch.stack(parts, 1)
