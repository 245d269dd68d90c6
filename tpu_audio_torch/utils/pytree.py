"""Parameter-tree helpers (port of tpu_audio/utils/pytree.py: flatten,
unflatten, stack_layers, param_count).

Parameter trees are nested dicts whose leaves are numpy arrays (a
checkpoint on the host) or torch tensors (the port's parameters).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def flatten(tree: dict, prefix: str = "", sep: str = ".") -> dict[str, Any]:
    """Nested dict → {'a.b.c': leaf} flat dict."""
    out: dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key, sep))
        else:
            out[key] = v
    return out


def unflatten(flat: dict[str, Any], sep: str = ".") -> dict:
    """{'a.b.c': leaf} → nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def param_count(tree: dict) -> int:
    return sum(int(np.prod(v.shape)) for v in flatten(tree).values())


def stack_layers(layer_trees: list[dict]) -> dict:
    """Stack N per-layer trees into one tree with a leading (N, ...) axis on
    every leaf: np.stack for numpy leaves, torch.stack for tensors."""
    flats = [flatten(t) for t in layer_trees]
    out = {}
    for k, v in flats[0].items():
        leaves = [f[k] for f in flats]
        out[k] = torch.stack(leaves) if isinstance(v, torch.Tensor) else np.stack(leaves)
    return unflatten(out)
