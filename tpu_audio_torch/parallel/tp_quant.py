"""Tensor-parallel serving of a transformer stack, rank by rank (port of
tpu_audio/parallel/tp_quant.py's layout rules: local_config, the fused-row
permutation, the column and row rules per leaf key, the refusals).

The JAX module runs the stack under `shard_map` because GSPMD cannot
partition its Pallas calls. The port has one route for fp and quantised
trees alike: each rank keeps its own contiguous copy of its megatron shard
(`local_params`), runs the stack at `local_config`'s head counts through the
same kernels on the local shapes, and `nn/transformer.forward_hidden`
all-reduces the row-parallel partial sums over the tp group.

Layout (megatron):
  - column-parallel (q, k, v, qkv, gate, up, gateup, fc1): output channels
    split. Fused qkv and gateup leaves are row-permuted first, so that rank
    s's block is [q_s | k_s | v_s] (resp. [gate_s | up_s]): a plain block
    of the fused axis would cut across the sub-matrices.
  - row-parallel (o, down, fc2): input channels split. The kernels
    quantise each rank's rows of x on their own K slice, so at tp > 1 the
    sum of the partials rounds otherwise than the tp = 1 product does (the
    per-rank activation scale); the sum is exact relative to the shards.
    A row-parallel bias is refused: the all-reduce would add it tp times.
  - attention heads split; the KV cache holds the rank's local heads.
  - embed, lm_head and norms replicated: every rank computes the same
    logits.

A row shard keeps whole units of its format's K layout: the int8 kernel's
16 columns, a q4/q8 group of 64, a W4A8 pair of 128, a super-group of 256.
`check_tp_quant_supported` refuses any other tp at construction, naming the
leaf, the tp and the unit, so that no kernel meets a shard it cannot read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

COL_NAMES = ("qkv", "q", "k", "v", "gate", "up", "gateup", "fc1")
ROW_NAMES = ("o", "down", "fc2")
_WEIGHT_KEYS = ("weight", "weight_i8", "weight_q4p", "weight_q4s", "weight_q4", "weight_q8")
_SCALE_KEYS = ("scales", "biases", "scale_i8", "scales_sg")

# the input columns a row shard must keep whole, by the leaf's weight key
# (a q4/q8 leaf's unit is its group, read from its scales)
K_UNIT = {"weight": 1, "weight_i8": 16, "weight_q4p": 128, "weight_q4s": 256}


def tp_axis(mesh, axis: str = "tp"):
    """(the process group, this rank's index, the size) of `mesh`'s tp
    axis. A `DeviceMesh` from `parallel.make_mesh`; any other object is
    refused, naming its type."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (parallel.make_mesh), "
                        f"got {type(mesh).__name__}")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no {axis!r} axis: {mesh.mesh_dim_names}")
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)))


def local_config(cfg, tp: int):
    """Per-rank config: heads and hidden divided by tp; head_dim pinned so
    that `hd` stays the true head size."""
    if cfg.n_heads % tp or cfg.kv_heads % tp or cfg.hidden_dim % tp:
        raise ValueError(f"n_heads {cfg.n_heads} / kv {cfg.kv_heads} / "
                         f"hidden {cfg.hidden_dim} not divisible by tp={tp}")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.kv_heads // tp,
                               head_dim=cfg.hd, hidden_dim=cfg.hidden_dim // tp)


def _fused_perm(sections: list[int], tp: int) -> np.ndarray:
    """Row permutation turning [A|B|...] (each section split into tp equal
    parts) into [A_0|B_0|...|A_1|B_1|...], so that a block of the result
    gives shard s the rows [A_s|B_s|...]."""
    offs = np.cumsum([0] + sections)
    idx = []
    for s in range(tp):
        for sec, off in zip(sections, offs):
            per = sec // tp
            idx.append(np.arange(off + s * per, off + (s + 1) * per))
    return np.concatenate(idx)


def _permute_leaf(leaf: dict, perm: np.ndarray) -> dict:
    out = {}
    for k, v in leaf.items():
        if k in _WEIGHT_KEYS or k in _SCALE_KEYS:
            out[k] = v.index_select(-2, torch.as_tensor(perm, device=v.device))
        elif k == "bias":
            out[k] = v.index_select(-1, torch.as_tensor(perm, device=v.device))
        else:
            out[k] = v
    return out


def permute_fused(layers_tree: dict, cfg, tp: int) -> dict:
    """The shard-contiguity permutation of fused qkv / gateup leaves (once,
    at construction). Unfused leaves shard as they are."""
    out = dict(layers_tree)
    attn = dict(layers_tree.get("attn", {}))
    if "qkv" in attn:
        hd = cfg.hd
        perm = _fused_perm([cfg.n_heads * hd, cfg.kv_heads * hd, cfg.kv_heads * hd], tp)
        attn["qkv"] = _permute_leaf(attn["qkv"], perm)
        out["attn"] = attn
    mlp = dict(layers_tree.get("mlp", {}))
    if "gateup" in mlp:
        mlp["gateup"] = _permute_leaf(mlp["gateup"], _fused_perm([cfg.hidden_dim] * 2, tp))
        out["mlp"] = mlp
    return out


def _is_linear_leaf(d) -> bool:
    return isinstance(d, dict) and any(k in d for k in _WEIGHT_KEYS)


def _weight_key(leaf: dict) -> str:
    return next(k for k in _WEIGHT_KEYS if k in leaf)


def _block(v: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    """Rank's block of v along dim, as a contiguous tensor of its own."""
    n = v.shape[dim] // tp
    return v.narrow(dim, rank * n, n).contiguous()


def _leaf_local(leaf: dict, kind: str, rank: int, tp: int) -> dict:
    """One (stacked) linear leaf's shard: column-parallel splits the output
    rows of weights, scales and bias; row-parallel the input (last) axis of
    weights, scales, biases and scales_sg, with scale_i8 (O, 1) whole."""
    out = {}
    for k, v in leaf.items():
        if kind == "col":
            if k in _WEIGHT_KEYS or k in _SCALE_KEYS:
                out[k] = _block(v, -2, rank, tp)
            elif k == "bias":
                out[k] = _block(v, -1, rank, tp)
            else:
                out[k] = v
        elif k in _WEIGHT_KEYS or k in ("scales", "biases", "scales_sg"):
            out[k] = _block(v, -1, rank, tp)
        else:  # scale_i8 (O, 1): per output channel, whole (a bias was refused)
            out[k] = v
    return out


def check_tp_quant_supported(params: dict, cfg, tp: int) -> None:
    """Refuse what the per-rank kernels cannot serve: heads, hidden or dim
    not divisible by tp, a row-parallel bias, and a row shard that is not
    whole units of its format (`K_UNIT`) or a column shard that splits no
    whole rows."""
    local_config(cfg, tp)
    if cfg.dim % tp:
        raise ValueError(f"dim {cfg.dim} not divisible by tp={tp}")
    lay = params.get("layers", {})
    for sub in ("attn", "mlp"):
        for name, leaf in lay.get(sub, {}).items():
            if not _is_linear_leaf(leaf):
                continue
            key = _weight_key(leaf)
            if name in ROW_NAMES:
                if "bias" in leaf:
                    raise ValueError(f"{sub}.{name} has a bias: unsupported row-parallel "
                                     "under tensor parallelism (the all-reduce would add "
                                     "it tp times)")
                k_in = leaf[key].shape[-1] * {"weight_q4": 8, "weight_q8": 4, "weight_q4p": 2,
                                              "weight_q4s": 2}.get(key, 1)
                unit = (k_in // leaf["scales"].shape[-1] if key in ("weight_q4", "weight_q8")
                        else K_UNIT[key])
                if k_in % (tp * unit):
                    raise ValueError(
                        f"{sub}.{name} ({key}): K {k_in} over tp={tp} is {k_in / tp:g} "
                        f"columns a rank, not a whole number of its {unit}-column "
                        f"{'groups' if unit > 1 else 'columns'}")
            elif name in COL_NAMES and leaf[key].shape[-2] % tp:
                raise ValueError(f"{sub}.{name} ({key}): {leaf[key].shape[-2]} output rows "
                                 f"not divisible by tp={tp}")


def local_params(params: dict, cfg, tp: int, rank: int) -> dict:
    """Rank `rank` of `tp`'s tree: fused leaves permuted, the column- and
    row-parallel leaves of the layers cut to the rank's block, each its own
    contiguous tensor (the kernels read unit-stride, 16-byte-aligned
    operands); everything else (embed, head, norms) is the caller's
    tensor, shared. Refuses what `check_tp_quant_supported` refuses."""
    check_tp_quant_supported(params, cfg, tp)
    layers = permute_fused(params["layers"], cfg, tp)

    def rec(d):
        out = {}
        for k, v in d.items():
            if k in COL_NAMES and _is_linear_leaf(v):
                out[k] = _leaf_local(v, "col", rank, tp)
            elif k in ROW_NAMES and _is_linear_leaf(v):
                out[k] = _leaf_local(v, "row", rank, tp)
            elif isinstance(v, dict):
                out[k] = rec(v)
            else:
                out[k] = v
        return out

    return dict(params, layers=rec(layers))
