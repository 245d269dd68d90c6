"""The per-channel int8 (W8A8) serving format (port of
tpu_audio/ops/quant.py: quantize_array_int8, quantize_tree_int8,
requantize_tree_int8, dequantize_int8, dequantize_rows, quantized_linear,
int8_linear).

A quantised linear is a dict {"weight_i8" (…, O, I) int8, "scale_i8"
(…, O, 1) f32, optional "bias"}: w ≈ weight_i8 · scale_i8. A layer of a
stacked (L, O, I) leaf, as `ParamTree.layer` hands it out, is
{"weight_i8_stacked": the whole (L, O, I) tensor, "layer_idx": i, and this
layer's "scale_i8" and "bias"}: the stacked kernel reads the layer in
place, as the JAX package's scalar-prefetch kernel does.

Only the int8 part of the JAX module is ported. The MLX group-affine q4/q8
checkpoint formats and their W4A8 repacks are not (ROADMAP A4, kernels B6
and B7): a tree holding them raises.
"""

from __future__ import annotations

import math
import re

import torch

from tpu_audio_torch.ops.kernels import int8_matmul as i8mm

_I8_SKIP = re.compile(r"(ln\w*|norm|conv\w*|pos_embed)\.weight$")


def quantize_array_int8(w: torch.Tensor) -> dict:
    """fp weight (…, O, I) → {"weight_i8" (…, O, I) int8, "scale_i8"
    (…, O, 1) f32}, per-output-channel symmetric, on w's device."""
    w = w.float()
    s = torch.clamp(w.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-10)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"weight_i8": q, "scale_i8": s}


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *heads, last = path.split(".")
        for k in heads:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def quantize_tree_int8(tree: dict, predicate=None) -> dict:
    """Quantise the matmul weights of a param tree (stacked (L, O, I)
    leaves and embedding tables included) to per-channel int8; norms,
    convs and positional tables stay fp. predicate(path, tensor) can veto
    a leaf; paths are dotted keys relative to `tree`."""
    out = {}
    for k, v in _flatten(tree).items():
        if (k.endswith(".weight") and v.dim() in (2, 3)
                and v.shape[-1] % 128 == 0 and v.shape[-2] >= 64
                and not _I8_SKIP.search(k)
                and (predicate is None or predicate(k, v))):
            prefix = k[: -len(".weight")]
            for qk, qv in quantize_array_int8(v).items():
                out[f"{prefix}.{qk}"] = qv
        else:
            out[k] = v
    return _unflatten(out)


def requantize_tree_int8(tree: dict) -> dict:
    """Pass fp and int8 leaves through. The JAX function also converts
    group-affine q4/q8 checkpoint leaves; those are not ported and raise."""
    if "weight_q4" in tree or "weight_q8" in tree:
        raise NotImplementedError(
            "group-affine q4/q8 weights are not ported yet (ROADMAP A4)")
    return {k: requantize_tree_int8(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def dequantize_int8(p: dict) -> torch.Tensor:
    return p["weight_i8"].float() * p["scale_i8"]


def dequantize_rows(p: dict, ids: torch.Tensor) -> torch.Tensor:
    """Gather-then-dequantise for an int8 embedding table: (…, I) f32."""
    return p["weight_i8"][ids].float() * p["scale_i8"][ids]


def quantized_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "weight_i8" in p or "weight_i8_stacked" in p:
        return int8_linear(p, x)
    raise NotImplementedError(
        f"quantized weights {sorted(p)} are not ported yet (ROADMAP A4)")


def int8_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (…, I) → (…, O) in x's dtype, by the JAX rule: up to 32 rows go to
    the weight-streaming kernel (the stacked one for a stacked leaf); more
    rows take the exact s8×s8 GEMM on CUDA, and on the CPU the product with
    the dequantised weight that the JAX package takes off the TPU."""
    lead = x.shape[:-1]
    rows = math.prod(lead)
    x2 = x.reshape(rows, x.shape[-1])
    if "weight_i8_stacked" in p:
        w_st, li = p["weight_i8_stacked"], p["layer_idx"]
        if rows <= i8mm.MAX_ROWS:
            y = i8mm.int8_matmul_stacked(x2, w_st, p["scale_i8"], li)
        else:
            sliced = {k: v for k, v in p.items()
                      if k not in ("weight_i8_stacked", "layer_idx")}
            return int8_linear({**sliced, "weight_i8": w_st[li]}, x)
    elif rows <= i8mm.MAX_ROWS:
        y = i8mm.int8_matmul(x2, p["weight_i8"], p["scale_i8"])
    elif x2.device.type == "cuda" and x2.shape[-1] % 128 == 0:
        y = i8mm.int8_matmul_bigm(x2, p["weight_i8"], p["scale_i8"])
    else:
        w = p["weight_i8"].to(x.dtype) * p["scale_i8"].to(x.dtype)
        y = x2 @ w.T
    y = y.to(x.dtype).reshape(*lead, -1)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y
