"""Parameter conversion from the JAX package's param trees.

`params_from_numpy` turns a tpu_audio param pytree (nested dicts whose
leaves are numpy arrays, or anything `np.asarray` accepts) into the port's
tree of torch tensors with the same keys. Stacked (L, …) layer leaves keep
their layout. Conv weights go from JAX's (kernel, in, out) to torch's
(out, in, kernel). Both packages then compute the same function from the
same weights.

Int8 serving trees (`load.serve_tree_int8`) carry across as they are:
`weight_i8` codes stay int8 and `scale_i8` scales stay float32 at any
target dtype, as the JAX tree keeps them. Group-affine q4/q8 trees
(`quant.quantize_tree`) too: their uint32 words become int32 tensors with
the same bits (torch has few uint32 operations), and their `scales` and
`biases` stay float32. FunASR's FSMN memory weight (`fsmn_block`, (K, 1, C)
in the JAX tree) becomes torch's depthwise (C, 1, K).
"""

from __future__ import annotations

import numpy as np
import torch


KEEP_F32 = ("scale_i8", "scales", "biases")  # float leaves that keep float32 at any dtype
CONV_KEYS = ("fsmn_block",)  # conv kernels under keys that do not start with "conv"


def _leaf(a, conv: bool, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:  # packed q4/q8 words: the same bits as int32
        a = np.ascontiguousarray(a).view(np.int32)
    elif a.dtype.kind not in "iub":
        a = a.astype(np.float32)  # also widens bfloat16 leaves, unknown to torch
    if conv and a.ndim == 3:
        a = a.transpose(2, 1, 0)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: dict, device: torch.device | str = "cuda",
                      dtype: torch.dtype = torch.float32,
                      _conv: bool = False) -> dict:
    """JAX param pytree → the port's parameter tree on `device` (the card
    unless the caller asks for the CPU), floating
    leaves cast to `dtype` (int8 and group-affine scales stay float32,
    uint32 words become int32). A "weight" leaf under a key starting with
    "conv", or named in CONV_KEYS, is a convolution kernel and is
    transposed (K, I, O) → (O, I, K)."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out[name] = params_from_numpy(value, device, dtype,
                                          name.startswith("conv") or name in CONV_KEYS)
        else:
            out[name] = _leaf(value, _conv and name == "weight", device,
                              torch.float32 if name in KEEP_F32 else dtype)
    return out
