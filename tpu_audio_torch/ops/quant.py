"""Quantised weight formats (port of tpu_audio/ops/quant.py: the MLX
group-affine q4/q8 format, the per-channel int8 (W8A8) serving format and
the conversion between them).

Group-affine (the mlx-community checkpoints): {"weight_q4" | "weight_q8"
(…, O, I·bits/32) packed words, "scales" (…, O, I/G), "biases" (…, O, I/G)
f32, optional "bias"}: w = scale · q + bias per group of G = 64 columns, q
unpacked from each 32-bit word low bits first. torch has few operations on
uint32, so the words are carried as int32 with the same bits; unpacking
masks the sign extension off. Up to 32 rows go to the fused
dequant-matmul kernel (`kernels/quant_matmul.py`); more rows take the
product with the dequantised weight, as the JAX module does.

Per-channel int8: {"weight_i8" (…, O, I) int8, "scale_i8" (…, O, 1) f32,
optional "bias"}: w ≈ weight_i8 · scale_i8. A layer of a stacked (L, O, I)
leaf, as `ParamTree.layer` hands it out, is {"weight_i8_stacked": the whole
(L, O, I) tensor, "layer_idx": i, and this layer's "scale_i8" and "bias"}:
the stacked kernel reads the layer in place, as the JAX package's
scalar-prefetch kernel does.

W4A8 (`kernels/w4a8_matmul.py` has the byte layouts): the pair-packed
repack {"weight_q4p" (…, O, I/2) int8, "scales"/"biases" (…, O, I/64) f32}
of a q4 leaf, lossless, and the super-group requantisation {"weight_q4s"
(…, O, I/2) int8, "scales_sg" (…, O, I/256) f32}, lossy. Up to 32
rows go to the W4A8 kernels, gated by the format's own shape rule only (I a
multiple of 128, or 256 for the super-group; any O); more rows (prefill)
take the product with the weight dequantised to x's dtype, as the JAX
module does: there an XLA dot, here `torch.matmul`. A stacked leaf reaches
a layer as {"weight_q4p_stacked" (or "weight_q4s_stacked"): the whole
(L, O, I/2) tensor, "layer_idx": i, this layer's scales/biases}, and the
stacked kernel reads the layer in place. Bound: device-memory bytes, 0.5 B
a weight plus 8 B of scale and bias per 64 weights (0.5 + 4/256 B for the
super-group); Llama-3.2-3B's tied head is 302 MB a call, 0.090 ms at
3.35 TB/s.

One routing difference from the TPU: the JAX super-group gate also needs a
`block_o` that divides O, so a super-group head at vocabulary 128,266
takes the dequantised product there; here it takes the kernel, which
differs from that product only by the int8 rounding of the activations.

A super-group embedding table has no row lookup: the JAX `dequantize_rows`
has no branch for it either (ROADMAP C5), so `dequantize_rows` raises.
"""

from __future__ import annotations

import math
import re

import torch

from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
from tpu_audio_torch.ops.kernels import quant_matmul as qmm
from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm
from tpu_audio_torch.utils import pytree

_I8_SKIP = re.compile(r"(ln\w*|norm|conv\w*|pos_embed)\.weight$")


# ------------------------------------------------------- group-affine q4/q8

def _bits(p: dict) -> int:
    return 4 if "weight_q4" in p else 8


def unpack_uint32(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(…, W) packed words (int32 or int64 holding the uint32 bits) →
    (…, W·32/bits) int32 values in [0, 2^bits)."""
    return qmm.unpack_words(packed, bits)


def pack_uint32(vals: torch.Tensor, bits: int) -> torch.Tensor:
    """(…, I) values in [0, 2^bits) → (…, I·bits/32) words, as int32 with
    the uint32 bits."""
    per = 32 // bits
    v = vals.to(torch.int64).reshape(*vals.shape[:-1], -1, per)
    shifts = torch.arange(per, device=vals.device, dtype=torch.int64) * bits
    words = (v << shifts).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def quantize_array(w: torch.Tensor, bits: int = 4, group: int = 64) -> dict:
    """fp weight (…, O, I) → group-affine dict on w's device; lead dims
    (the stacked layer axis) pass through. The JAX function's arithmetic
    in f32, so codes, scales and biases come out equal."""
    *lead, o, i = w.shape
    if i % group:
        raise ValueError(f"in_features {i} not divisible by group {group}")
    wg = w.float().reshape(*lead, o, i // group, group)
    wmax, wmin = wg.amax(dim=-1), wg.amin(dim=-1)
    levels = (1 << bits) - 1
    scales = torch.clamp(i8mm.true_div(wmax - wmin, float(levels)), min=1e-8)
    q = torch.clamp(torch.round((wg - wmin[..., None]) / scales[..., None]), 0, levels)
    return {f"weight_q{bits}": pack_uint32(q.reshape(*lead, o, i), bits),
            "scales": scales, "biases": wmin}


def dequantize(p: dict) -> torch.Tensor:
    """A quantised dict → (…, O, I) f32 weight."""
    if "weight_i8" in p:
        return dequantize_int8(p)
    if "weight_q4p" in p:
        return dequantize_w4a8(p)
    if "weight_q4s" in p:
        return dequantize_w4a8_sg(p)
    bits = _bits(p)
    return qmm.dequantize_words(p[f"weight_q{bits}"], p["scales"], p["biases"], bits)


def dequantize_rows(p: dict, ids: torch.Tensor) -> torch.Tensor:
    """Gather-then-dequantise for a quantised embedding table: (…, I) f32,
    unpacking only the gathered rows."""
    if "weight_i8" in p:
        return p["weight_i8"][ids].float() * p["scale_i8"][ids]
    if "weight_q4p" in p:
        return w4mm.dequantize_w4a8(p["weight_q4p"][ids], p["scales"][ids], p["biases"][ids])
    if "weight_q4s" in p:
        raise ValueError("a super-group (weight_q4s) embedding table has no row lookup: the "
                         "JAX dequantize_rows has none either (ROADMAP C5); keep the "
                         "embedding in bf16 and untie the head")
    bits = _bits(p)
    return qmm.dequantize_words(p[f"weight_q{bits}"][ids], p["scales"][ids],
                                p["biases"][ids], bits)


def quantize_tree(tree: dict, bits: int = 4, group: int = 64, predicate=None) -> dict:
    """Quantise every eligible 2-D or stacked 3-D "weight" leaf of a param
    tree to the group-affine format (norms, convs and positional tables
    stay fp); predicate(path, tensor) can veto a leaf."""
    out = {}
    for k, v in pytree.flatten(tree).items():
        if (k.endswith(".weight") and v.dim() in (2, 3) and v.shape[-1] % group == 0
                and not _I8_SKIP.search(k)
                and (predicate is None or predicate(k, v))):
            prefix = k[: -len(".weight")]
            for qk, qv in quantize_array(v, bits, group).items():
                out[f"{prefix}.{qk}"] = qv
        else:
            out[k] = v
    return pytree.unflatten(out)


# ------------------------------------------------------------ int8 (W8A8)

def dequantize_tree(tree: dict, dtype: torch.dtype) -> dict:
    """Every quantised leaf dict of a param tree (group-affine, int8, W4A8)
    as an fp {"weight", optional "bias"} leaf in `dtype`; fp leaves pass
    through."""
    if any(k in tree for k in ("weight_q4", "weight_q8", "weight_q4p", "weight_q4s",
                               "weight_i8")):
        out = {"weight": dequantize(tree).to(dtype)}
    else:
        return {k: dequantize_tree(v, dtype) if isinstance(v, dict) else v
                for k, v in tree.items()}
    if "bias" in tree:
        out["bias"] = tree["bias"]
    return out


def quantize_array_int8(w: torch.Tensor) -> dict:
    """fp weight (…, O, I) → {"weight_i8" (…, O, I) int8, "scale_i8"
    (…, O, 1) f32}, per-output-channel symmetric, on w's device."""
    w = w.float()
    s = torch.clamp(i8mm.true_div(w.abs().amax(dim=-1, keepdim=True), 127.0), min=1e-10)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"weight_i8": q, "scale_i8": s}


def quantize_tree_int8(tree: dict, predicate=None) -> dict:
    """Quantise the matmul weights of a param tree (stacked (L, O, I)
    leaves and embedding tables included) to per-channel int8; norms,
    convs and positional tables stay fp. predicate(path, tensor) can veto
    a leaf; paths are dotted keys relative to `tree`."""
    out = {}
    for k, v in pytree.flatten(tree).items():
        if (k.endswith(".weight") and v.dim() in (2, 3)
                and v.shape[-1] % 128 == 0 and v.shape[-2] >= 64
                and not _I8_SKIP.search(k)
                and (predicate is None or predicate(k, v))):
            prefix = k[: -len(".weight")]
            for qk, qv in quantize_array_int8(v).items():
                out[f"{prefix}.{qk}"] = qv
        else:
            out[k] = v
    return pytree.unflatten(out)


def requantize_int8(p: dict) -> dict:
    """Group-affine q4/q8 dict → per-channel int8 dict, on its device."""
    out = quantize_array_int8(dequantize(p))
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def requantize_tree_int8(tree: dict, fuse: bool = True) -> dict:
    """Convert every group-affine q4/q8 leaf dict of a param tree (stacked
    (L, O, I) leaves included) to per-channel int8; fp and int8 leaves pass
    through. With `fuse`, q/k/v and gate/up int8 leaves are then fused
    (`fuse_int8_tree`), the JAX package's serving recipe."""
    if "weight_q4" in tree or "weight_q8" in tree:
        return requantize_int8(tree)
    out = {k: requantize_tree_int8(v, fuse=False) if isinstance(v, dict) else v
           for k, v in tree.items()}
    return fuse_int8_tree(out) if fuse else out


def fuse_leaves(tree: dict, has, cat) -> dict:
    """Replace attn q/k/v by "qkv" and mlp gate/up by "gateup" where
    has(leaf) holds for each, concatenating them with cat(leaves)."""
    if not isinstance(tree, dict):
        return tree

    def all_have(names, d):
        return all(n in d and isinstance(d[n], dict) and has(d[n]) for n in names)

    out = {}
    for k, v in tree.items():
        if k == "attn" and all_have("qkv", v):
            out[k] = {kk: vv for kk, vv in v.items() if kk not in ("q", "k", "v")}
            out[k]["qkv"] = cat([v["q"], v["k"], v["v"]])
        elif k == "mlp" and all_have(("gate", "up"), v):
            out[k] = {kk: vv for kk, vv in v.items() if kk not in ("gate", "up")}
            out[k]["gateup"] = cat([v["gate"], v["up"]])
        elif isinstance(v, dict):
            out[k] = fuse_leaves(v, has, cat)
        else:
            out[k] = v
    return out


def _cat_leaves(keys):
    def cat(ds):
        out = {k: torch.cat([d[k] for d in ds], dim=-2) for k in keys}
        if all("bias" in d for d in ds):
            out["bias"] = torch.cat([d["bias"] for d in ds], dim=-1)
        return out
    return cat


def fuse_int8_tree(tree: dict) -> dict:
    """Fuse q/k/v → qkv and gate/up → gateup int8 leaves along the output
    channels; per-channel scales concatenate exactly, so the fused product
    equals the separate ones."""
    return fuse_leaves(tree, lambda d: "weight_i8" in d, _cat_leaves(("weight_i8", "scale_i8")))


def dequantize_int8(p: dict) -> torch.Tensor:
    return p["weight_i8"].float() * p["scale_i8"]


# ------------------------------------------------------------- dispatch

def quantized_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "weight_i8" in p or "weight_i8_stacked" in p:
        return int8_linear(p, x)
    if "weight_q4s" in p or "weight_q4s_stacked" in p:
        return w4a8_sg_linear(p, x)
    if "weight_q4p" in p or "weight_q4p_stacked" in p:
        return w4a8_linear(p, x)
    return group_affine_linear(p, x)


def group_affine_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (…, I) → (…, O) in x's dtype, by the JAX rule: up to 32 rows go to
    the fused dequant-matmul kernel (group 64); more rows take the product
    with the weight dequantised to x's dtype."""
    bits = _bits(p)
    packed = p[f"weight_q{bits}"]
    lead = x.shape[:-1]
    rows = math.prod(lead)
    x2 = x.reshape(rows, x.shape[-1])
    group = x.shape[-1] // p["scales"].shape[-1]
    if rows <= qmm.MAX_ROWS and group == qmm.GROUP:
        y = qmm.quant_matmul(x2, packed, p["scales"], p["biases"], bits=bits)
    else:
        y = x2 @ dequantize(p).to(x.dtype).T
    y = y.to(x.dtype).reshape(*lead, -1)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def int8_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (…, I) → (…, O) in x's dtype, by the JAX rule: up to 32 rows go to
    the weight-streaming kernel (the stacked one for a stacked leaf), which
    also casts to x's dtype and adds the bias, as the JAX function does
    after it; more rows take the exact s8×s8 GEMM on CUDA, and on the CPU
    the product with the dequantised weight that the JAX package takes off
    the TPU."""
    lead = x.shape[:-1]
    rows = math.prod(lead)
    x2 = x.reshape(rows, x.shape[-1])
    bias = p["bias"] if "bias" in p else None
    if "weight_i8_stacked" in p:
        w_st, li = p["weight_i8_stacked"], p["layer_idx"]
        if rows <= i8mm.MAX_ROWS:
            y = i8mm.int8_matmul_stacked(x2, w_st, p["scale_i8"], li, bias, out_dtype=x.dtype)
            return y.reshape(*lead, -1)
        sliced = {k: v for k, v in p.items() if k not in ("weight_i8_stacked", "layer_idx")}
        return int8_linear({**sliced, "weight_i8": w_st[li]}, x)
    if rows <= i8mm.MAX_ROWS:
        y = i8mm.int8_matmul(x2, p["weight_i8"], p["scale_i8"], bias, out_dtype=x.dtype)
        return y.reshape(*lead, -1)
    if x2.device.type == "cuda" and x2.shape[-1] % 128 == 0:
        y = i8mm.int8_matmul_bigm(x2, p["weight_i8"], p["scale_i8"])
    else:
        w = p["weight_i8"].to(x.dtype) * p["scale_i8"].to(x.dtype)
        y = x2 @ w.T
    y = y.to(x.dtype).reshape(*lead, -1)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


# ------------------------------------------------------------------ W4A8

def repack_w4a8(p: dict) -> dict:
    """Group-affine q4 dict → the pair-packed W4A8 dict on its device
    (lossless: the codes and group scales are the checkpoint's)."""
    q = unpack_uint32(p["weight_q4"], 4)
    out = {"weight_q4p": w4mm.pack_w4a8(q), "scales": p["scales"].float(),
           "biases": p["biases"].float()}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def dequantize_w4a8(p: dict) -> torch.Tensor:
    return w4mm.dequantize_w4a8(p["weight_q4p"], p["scales"], p["biases"])


def requantize_w4a8_sg(p: dict) -> dict:
    """Group-affine q4 dict → the super-group dict on its device (lossy;
    stacked leaves one layer at a time)."""
    q = unpack_uint32(p["weight_q4"], 4)
    *lead, o, i = q.shape
    q2 = q.reshape(-1, o, i)
    sc = p["scales"].reshape(-1, o, i // w4mm.GROUP)
    bi = p["biases"].reshape(-1, o, i // w4mm.GROUP)
    packed, ssg = zip(*[w4mm.requantize_w4a8_sg(sc[n], bi[n], q2[n]) for n in range(q2.shape[0])])
    out = {"weight_q4s": torch.stack(packed).reshape(*lead, o, i // 2),
           "scales_sg": torch.stack(ssg).reshape(*lead, o, i // w4mm.SUPER)}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def dequantize_w4a8_sg(p: dict) -> torch.Tensor:
    return w4mm.dequantize_w4a8_sg(p["weight_q4s"], p["scales_sg"])


def _w4a8_product(p: dict, x: torch.Tensor, sg: bool) -> torch.Tensor:
    """The JAX rule for both W4A8 formats: ≤ 32 rows of a supported shape
    go to the kernel (the stacked one for a stacked leaf); otherwise the
    product with the weight dequantised to x's dtype."""
    key = "weight_q4s" if sg else "weight_q4p"
    lead = x.shape[:-1]
    rows = math.prod(lead)
    x2 = x.reshape(rows, x.shape[-1])
    if key + "_stacked" in p:
        w_st, li = p[key + "_stacked"], p["layer_idx"]
        if rows <= w4mm.MAX_ROWS and w4mm.supported(x2, w_st, sg):
            y = (w4mm.w4a8_sg_matmul_stacked(x2, w_st, p["scales_sg"], li) if sg else
                 w4mm.w4a8_matmul_stacked(x2, w_st, p["scales"], p["biases"], li))
        else:
            sliced = {k: v for k, v in p.items() if k not in (key + "_stacked", "layer_idx")}
            return _w4a8_product({**sliced, key: w_st[li]}, x, sg)
    elif rows <= w4mm.MAX_ROWS and w4mm.supported(x2, p[key], sg):
        y = (w4mm.w4a8_sg_matmul(x2, p[key], p["scales_sg"]) if sg else
             w4mm.w4a8_matmul(x2, p[key], p["scales"], p["biases"]))
    else:
        y = x2 @ dequantize(p).to(x.dtype).T
    y = y.to(x.dtype).reshape(*lead, -1)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def w4a8_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (…, I) → (…, O) in x's dtype on a pair-packed leaf."""
    return _w4a8_product(p, x, sg=False)


def w4a8_sg_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (…, I) → (…, O) in x's dtype on a super-group leaf."""
    return _w4a8_product(p, x, sg=True)


def repack_tree_w4a8(tree: dict, fuse: bool = True) -> dict:
    """Repack every group-affine q4 leaf dict whose in_features is a
    multiple of 128 to the pair-packed W4A8 layout (stacked leaves
    included; narrower q4, q8 and fp leaves pass through); with `fuse`,
    q/k/v and gate/up W4A8 leaves are then fused."""
    if "weight_q4" in tree:
        return repack_w4a8(tree) if tree["weight_q4"].shape[-1] * 8 % w4mm.PAIR == 0 else tree
    out = {k: repack_tree_w4a8(v, fuse=False) if isinstance(v, dict) else v
           for k, v in tree.items()}
    return fuse_w4a8_tree(out) if fuse else out


def fuse_w4a8_tree(tree: dict) -> dict:
    """Fuse q/k/v → qkv and gate/up → gateup W4A8 leaves along the output
    channels (packed rows and group scales concatenate exactly)."""
    return fuse_leaves(tree, lambda d: "weight_q4p" in d,
                       _cat_leaves(("weight_q4p", "scales", "biases")))


def requantize_tree_w4a8_sg(tree: dict, fuse: bool = True) -> dict:
    """Requantise every group-affine q4 leaf dict whose in_features is a
    multiple of 256 to the super-group layout (others pass through); with
    `fuse`, q/k/v and gate/up super-group leaves are then fused."""
    if "weight_q4" in tree:
        if tree["weight_q4"].shape[-1] * 8 % w4mm.SUPER == 0:
            return requantize_w4a8_sg(tree)
        return tree
    out = {k: requantize_tree_w4a8_sg(v, fuse=False) if isinstance(v, dict) else v
           for k, v in tree.items()}
    return fuse_w4a8_sg_tree(out) if fuse else out


def fuse_w4a8_sg_tree(tree: dict) -> dict:
    """Fuse q/k/v → qkv and gate/up → gateup super-group leaves."""
    return fuse_leaves(tree, lambda d: "weight_q4s" in d, _cat_leaves(("weight_q4s", "scales_sg")))
