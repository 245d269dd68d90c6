"""Parameter conversion from the JAX package's param trees.

`params_from_numpy` turns a tpu_audio param pytree (nested dicts whose
leaves are numpy arrays, or anything `np.asarray` accepts) into the port's
tree of torch tensors with the same keys. Stacked (L, …) layer leaves keep
their layout. Conv weights go from JAX's (kernel, in, out) to torch's
(out, in, kernel). Both packages then compute the same function from the
same weights.

Int8 serving trees (`load.serve_tree_int8`) carry across as they are:
`weight_i8` codes stay int8 and `scale_i8` scales stay float32 at any
target dtype, as the JAX tree keeps them.
"""

from __future__ import annotations

import numpy as np
import torch


KEEP_F32 = ("scale_i8",)  # float leaves that keep float32 at any dtype


def _leaf(a, conv: bool, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind not in "iub":
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
    leaves cast to `dtype` (int8 scales stay float32). A "weight" leaf
    under a key starting with "conv" is a convolution kernel and is
    transposed (K, I, O) → (O, I, K)."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out[name] = params_from_numpy(value, device, dtype,
                                          name.startswith("conv"))
        else:
            out[name] = _leaf(value, _conv and name == "weight", device,
                              torch.float32 if name in KEEP_F32 else dtype)
    return out
