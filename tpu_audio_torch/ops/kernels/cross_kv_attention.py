"""Cross-attention decode over int8 cross-K/V, one token, one layer.

Replaces the TPU kernel
tpu_audio/ops/pallas/cross_kv_attention.py:cross_attention_decode with
`csrc/cross_kv_attention.cu`.

Bound on the H100: device-memory bytes. Each decode step re-reads every
layer's cross-K/V (61 MB per layer at large-v3-turbo batch 16 in int8)
at 2 FLOP per byte. Design: int8 K/V halve the bytes against bf16, and
the dequantisation is algebraically free — the per-channel K scale folds
into q before the dot and the V scale multiplies the output after the
softmax division. A cluster of `RANKS` blocks takes one (batch, head pair),
each a chunk of its keys (`chunk_bounds`); a block streams its chunk's key
and value rows together under an online softmax, and the ranks merge their
(max, sum, P·V) through distributed shared memory (`attend_chunks` is the
same partition and merge in PyTorch). Padded key rows (t ≥ t_valid) are
never read.

The TPU kernel's block-diagonal q and 8-row output pad exist for the MXU
and are not carried over; the kernel computes in f32 where the TPU one
feeds bf16 dots.

`quantize_cross_kv` and `dequant_layer` are plain PyTorch, run once per
window (quantisation) or per prefill (dequantisation).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_audio_torch.ops.kernels import _build

LANE = 128          # T pads to a multiple of this (the int8 layout's contract)
HEAD_DIM = 64       # the kernel is compiled for hd = 64
RANKS = 4           # blocks (key chunks) a (batch, head pair): the .cu's kRanks
HEADS_PER_BLOCK = 2  # the .cu's kHeads: a block reads a row's two heads, 128 bytes
KEYS_PER_TRIP = 32  # keys a block reads a trip of its loop: the .cu's 2 x kGroups

LAUNCHES = {"cross_attention_decode": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = _build.Kernel("tpa_cross_attention_decode", _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I)


def quantize_cross_kv(ck: torch.Tensor, cv: torch.Tensor):
    """(L, B, T, H, hd) float K/V → ((L, B, T_pad, H·hd) int8,
    (L, B, H·hd) f32 scale) × 2, quantized per channel over the T axis.
    T pads to a multiple of 128 with zero rows."""

    def q(x):
        lyr, b, t, h, hd = x.shape
        xf = x.float().reshape(lyr, b, t, h * hd)
        s = torch.clamp(xf.abs().amax(dim=2) / 127.0, min=1e-10)
        x8 = torch.clamp(torch.round(xf / s[:, :, None]), -127, 127)
        t_pad = -(-t // LANE) * LANE
        x8 = torch.nn.functional.pad(x8, (0, 0, 0, t_pad - t))
        return x8.to(torch.int8), s

    k8, ks = q(ck)
    v8, vs = q(cv)
    return k8, ks, v8, vs


def dequant_layer(x8: torch.Tensor, scale: torch.Tensor, t: int,
                  n_heads: int) -> torch.Tensor:
    """One layer's (B, T_pad, H·hd) int8 → (B, t, H, hd) bf16 (the prefill
    path, where the dequantisation amortises over the prompt)."""
    b, _, hdim = x8.shape
    xf = x8.float() * scale[:, None, :]
    return xf[:, :t].reshape(b, t, n_heads, hdim // n_heads).to(torch.bfloat16)


def cross_attention_decode_plain(q, k8, v8, k_scale, v_scale, layer: int, *,
                                 t_valid: int, n_heads: int) -> torch.Tensor:
    """Plain PyTorch version of `cross_attention_decode`."""
    b, h, hd = q.shape
    qs = (q.float().reshape(b, h * hd) * k_scale).reshape(b, h, hd)
    kf = k8[layer, :, :t_valid].float().reshape(b, t_valid, h, hd)
    vf = v8[layer, :, :t_valid].float().reshape(b, t_valid, h, hd)
    w = torch.softmax(torch.einsum("bhd,bthd->bht", qs, kf), dim=-1)
    out = torch.einsum("bht,bthd->bhd", w, vf)
    return out * v_scale.reshape(b, h, hd)


def chunk_bounds(n: int, split: int) -> list[tuple[int, int]]:
    """The decode kernels' partition of n keys into `split` chunks: chunk c
    holds rows [min(n, c·cs), min(n, c·cs + cs)) with cs = ceil(n / split),
    so trailing chunks may be empty."""
    cs = -(-n // split)
    return [(min(n, c * cs), min(n, c * cs + cs)) for c in range(split)]


def attend_chunks(s, v, split: int, *, s_fresh=None, v_fresh=None, rnd=None,
                  drop_sum: int | None = None, drop_chunk: int | None = None):
    """One token's attention with its keys split into chunks and merged as
    the decode kernels merge them. s (H, n) f32 scores, v (n, H, hd) f32
    values; s_fresh (H,) and v_fresh (H, hd), the current token's own score
    and value, join the merge when given → (H, hd) f32.

    Chunk c (`chunk_bounds`) leaves its max m_c and sum l_c of exp(s − m_c);
    the head's max M and sum L take every chunk and the fresh term. With
    `rnd` None, one pass: the chunk's P·V is Σ exp(s − m_c) v, and the merge
    weighs it by exp(m_c − M) / L. With `rnd` (bf16 activations), two
    passes: every probability is rnd(exp(s − M) / L), as the unsplit
    attention rounds it, the chunk's P·V is Σ p rnd(v), and the merge sums
    them. An empty chunk has sum 0 and is left out. Planted faults:
    `drop_sum` leaves chunk drop_sum's sum out of L, `drop_chunk` leaves the
    chunk out altogether."""
    h, n = s.shape
    chunks = []
    for c, (a, b) in enumerate(chunk_bounds(n, split)):
        if b > a and c != drop_chunk:
            m = s[:, a:b].amax(-1)
            chunks.append((c, a, b, m, torch.exp(s[:, a:b] - m[:, None]).sum(-1)))
    m_all = torch.stack([m for *_, m, _ in chunks]).amax(0) if chunks else None
    if s_fresh is not None:
        m_all = s_fresh if m_all is None else torch.maximum(m_all, s_fresh)
    big = torch.zeros(h, dtype=s.dtype, device=s.device)
    for c, _, _, m, l in chunks:
        if c != drop_sum:
            big = big + l * torch.exp(m - m_all)
    e_fresh = None
    if s_fresh is not None:
        e_fresh = torch.exp(s_fresh - m_all)
        big = big + e_fresh
    out = torch.zeros(h, v.shape[-1], dtype=s.dtype, device=s.device)
    for c, a, b, m, _ in chunks:
        if rnd is None:
            e = torch.exp(s[:, a:b] - m[:, None])
            out = out + torch.einsum("ht,thd->hd", e, v[a:b]) * (torch.exp(m - m_all)
                                                                 / big)[:, None]
        else:
            p = rnd(torch.exp(s[:, a:b] - m_all[:, None]) / big[:, None])
            out = out + torch.einsum("ht,thd->hd", p, rnd(v[a:b]))
    if s_fresh is not None:
        out = out + (e_fresh / big)[:, None] * v_fresh
    elif not chunks:  # no key left: the merge's 0 / 0
        out = out / big[:, None]
    return out


def cross_attention_chunks_plain(q, k8, v8, k_scale, v_scale, layer: int, *,
                                 t_valid: int, n_heads: int, ranks: int = RANKS,
                                 drop_chunk: int | None = None) -> torch.Tensor:
    """`cross_attention_decode_plain` as the kernel partitions it: each
    (batch, head)'s keys in `ranks` chunks merged by `attend_chunks`.
    `drop_chunk` (a planted fault) leaves one rank's partial out."""
    b, h, hd = q.shape
    qs = (q.float().reshape(b, h * hd) * k_scale).reshape(b, h, hd)
    kf = k8[layer, :, :t_valid].float().reshape(b, t_valid, h, hd)
    vf = v8[layer, :, :t_valid].float().reshape(b, t_valid, h, hd)
    s = torch.einsum("bhd,bthd->bht", qs, kf)
    out = torch.stack([attend_chunks(s[i], vf[i], ranks, drop_chunk=drop_chunk)
                       for i in range(b)])
    return out * v_scale.reshape(b, h, hd)


def cross_attention_decode(q: torch.Tensor, k8: torch.Tensor,
                           v8: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, layer: int, *,
                           t_valid: int, n_heads: int) -> torch.Tensor:
    """One decode step of cross-attention for layer `layer`.

    q: (B, H, hd) f32, already carrying the softmax scale.
    k8/v8: (L, B, T_pad, H·hd) int8 (`quantize_cross_kv` layout).
    k_scale/v_scale: this layer's (B, H·hd) f32 channel scales.
    Returns (B, H, hd) f32. On CUDA all inputs are contiguous, hd = 64 and
    H is even.
    """
    if q.device.type == "cpu":
        return cross_attention_decode_plain(q, k8, v8, k_scale, v_scale, layer,
                                            t_valid=t_valid, n_heads=n_heads)
    device = _build.require_cuda("cross_attention_decode", q, k8, v8, k_scale,
                                 v_scale)
    if q.dim() != 3 or k8.dim() != 4:
        raise ValueError("cross_attention_decode: q must be (B, H, hd) and "
                         "k8 (L, B, T_pad, H*hd)")
    b, h, hd = q.shape
    lyr, _, t_pad, d = k8.shape
    if h != n_heads or hd != HEAD_DIM or h % HEADS_PER_BLOCK:
        raise ValueError(f"cross_attention_decode: unsupported heads={h}, "
                         f"hd={hd} (n_heads={n_heads})")
    if not 0 <= layer < lyr or not 1 <= t_valid <= t_pad:
        raise ValueError(f"cross_attention_decode: layer={layer} or "
                         f"t_valid={t_valid} out of range")
    _build.check("cross_attention_decode q", q, torch.float32, (b, h, hd))
    _build.check("cross_attention_decode k8", k8, torch.int8, (lyr, b, t_pad, h * hd))
    _build.check("cross_attention_decode v8", v8, torch.int8, (lyr, b, t_pad, d))
    _build.check("cross_attention_decode k_scale", k_scale, torch.float32, (b, d))
    _build.check("cross_attention_decode v_scale", v_scale, torch.float32, (b, d))
    out = torch.empty((b, h, hd), dtype=torch.float32, device=device)
    _KERNEL(device, q, k8, v8, k_scale, v_scale, out, int(layer), b, t_pad, h,
            t_valid)
    LAUNCHES["cross_attention_decode"] += 1
    return out
