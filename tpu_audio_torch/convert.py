"""Parameter conversion from the JAX package's param trees.

`params_from_numpy` turns a tpu_audio param pytree (nested dicts whose
leaves are numpy arrays, or anything `np.asarray` accepts, or torch
tensors in the JAX layout) into the port's tree of torch tensors with the
same keys. Stacked (L, …) layer leaves keep
their layout. Conv weights go from JAX's (kernel, in, out) to torch's
(out, in, kernel). Both packages then compute the same function from the
same weights.

Int8 serving trees (`load.serve_tree_int8`) carry across as they are:
`weight_i8` codes stay int8 and `scale_i8` scales stay float32 at any
target dtype, as the JAX tree keeps them. Group-affine q4/q8 trees
(`quant.quantize_tree`) too: their uint32 words become int32 tensors with
the same bits (torch has few uint32 operations), and their `scales` and
`biases` stay float32. W4A8 trees (`quant.repack_tree_w4a8`,
`requantize_tree_w4a8_sg`) too: `weight_q4p` / `weight_q4s` codes stay int8
and `scales_sg` float32. FunASR's FSMN memory weight (`fsmn_block`, (K, 1, C)
in the JAX tree) becomes torch's depthwise (C, 1, K). The weight-normalised
convolutions of SNAC ("weight_v", "weight_g") go from (K, I, O) to torch's
(O, I, K), and under "convT", a transposed convolution, to torch's
(I, O, K). Mimi, whose conv kernels sit under other names, applies its own
rule (`codecs/mimi/model.params_from_numpy`). The S3 family (the S3
tokenizer, S3Gen, CAMPPlus), whose kernels sit under many names, goes
through `s3_params_from_numpy`, which reads a kernel by its rank
(`s3_perm`) and keeps BatchNorm statistics and Snake alphas in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_audio_torch.utils import pytree


KEEP_F32 = ("scale_i8", "scales", "biases", "scales_sg")  # f32 at any dtype
CONV_KEYS = ("fsmn_block",)  # conv kernels under keys that do not start with "conv"
WN_KEYS = ("weight_v", "weight_g")  # weight-normalised conv kernels, under any key


def _leaf(a, perm, device, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a tensor already (on any device)
        t = a.permute(*perm) if perm is not None and a.dim() == len(perm) else a
        t = t.contiguous()
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)
    a = np.asarray(a)
    if a.dtype == np.uint32:  # packed q4/q8 words: the same bits as int32
        a = np.ascontiguousarray(a).view(np.int32)
    elif a.dtype.kind not in "iub":
        a = a.astype(np.float32)  # also widens bfloat16 leaves, unknown to torch
    if perm is not None and a.ndim == len(perm):
        a = a.transpose(*perm)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def serving_dtype(device: torch.device | str) -> torch.dtype:
    """The dtype a loaded engine serves its weights in: bf16 on the card,
    f32 (the JAX package's) on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def tree_device(tree: dict) -> torch.device:
    """The device of a parameter tree's first leaf."""
    for v in tree.values():
        return tree_device(v) if isinstance(v, dict) else v.device
    raise ValueError("empty parameter tree")


def params_from_numpy(tree: dict, device: torch.device | str = "cuda",
                      dtype: torch.dtype = torch.float32,
                      _conv: bool = False) -> dict:
    """JAX param pytree → the port's parameter tree on `device` (the card
    unless the caller asks for the CPU), floating
    leaves cast to `dtype` (int8 and group-affine scales stay float32,
    uint32 words become int32). A "weight" leaf under a key starting with
    "conv", or named in CONV_KEYS, is a convolution kernel and is
    transposed (K, I, O) → (O, I, K), as is a 3-D "weight_v" / "weight_g"
    under any key; a 3-D leaf under "convT" (a transposed convolution)
    becomes (I, O, K)."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out[name] = params_from_numpy(value, device, dtype,
                                          name.startswith("conv") or name in CONV_KEYS)
            if name == "convT":
                out[name] = {k: v.permute(1, 0, 2).contiguous() if v.dim() == 3 else v
                             for k, v in out[name].items()}
        else:
            perm = (2, 1, 0) if name in WN_KEYS or (_conv and name == "weight") else None
            out[name] = _leaf(value, perm, device,
                              torch.float32 if name in KEEP_F32 else dtype)
    return out


S3_CONV_T_KEYS = ("ups",)  # the S3 family's transposed convolutions
S3_KEEP_F32 = KEEP_F32 + ("running_mean", "running_var", "alpha")  # BatchNorm stats, Snake


def s3_perm(key: str, rank: int) -> tuple | None:
    """The permutation that takes the leaf at dotted `key` of an S3-family
    tree, of rank `rank`, from the JAX layout to torch's. Every 3-D "weight"
    there is a convolution kernel (K, I, O) and no linear weight is 3-D: it
    becomes (O, I, K), or (I, O, K) under "ups" (HiFT's transposed
    convolutions, ups.{i}.weight); a 4-D one (CAMPPlus's (KH, KW, I, O))
    becomes (O, I, KH, KW)."""
    parts = key.split(".")
    if parts[-1] != "weight" or rank not in (3, 4):
        return None
    if rank == 4:
        return (3, 2, 0, 1)
    parent = next((p for p in reversed(parts[:-1]) if not p.isdigit()), "")
    return (1, 2, 0) if parent in S3_CONV_T_KEYS else (2, 1, 0)


def s3_params_from_numpy(tree: dict, device: torch.device | str = "cuda",
                         dtype: torch.dtype = torch.float32) -> dict:
    """A JAX-layout tree of the S3 family (S3 tokenizer, S3Gen, CAMPPlus;
    numpy arrays, anything `np.asarray` takes, or tensors) → the port's
    tree on `device` (the card unless the caller asks for the CPU), by
    `s3_perm`, floating leaves in `dtype` but those of S3_KEEP_F32."""
    return pytree.unflatten({
        k: _leaf(v, s3_perm(k, np.ndim(v)), device,
                 torch.float32 if k.rsplit(".", 1)[-1] in S3_KEEP_F32 else dtype)
        for k, v in pytree.flatten(tree).items()})
