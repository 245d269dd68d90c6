"""Param-tree sharding rules, megatron-style TP + DP batch (port of
tpu_audio/parallel/shardings.py).

Rules are (path-regex, spec) pairs matched against flattened param paths;
a spec names the mesh axis of each of the leaf's LAST dims, and stacked
(L, …) `blocks`/`layers` leaves get their leading layer axis prepended as
unsharded. Column-parallel: q/k/v, gate/up, fc1 shard the output dim;
row-parallel: o, down, fc2 shard the input dim, and DTensor inserts the
sum over tp on their outputs.

The specs are written for the port's layouts (`convert.params_from_numpy`):
linear weights are (out, in) in both packages, but a conv weight is
(O, I, K) here and (K, I, O) in the JAX tree, so the convs' output-channel
shard is dim 0 here where JAX names dim 2. No other leaf of these rules is
permuted by the conversion.
"""

from __future__ import annotations

import re

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from tpu_audio_torch.nn.layers import TPLinear
from tpu_audio_torch.utils import pytree


class P(tuple):
    """A partition spec: the mesh axis name (or None) of each dim."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


# (regex on flat path, spec for the LAST ndims of the leaf)
transformer_rules: list[tuple[str, P]] = [
    (r"\.attn\.([qkv]|qkv)\.weight$", P("tp", None)),
    (r"\.attn\.([qkv]|qkv)\.bias$", P("tp")),
    (r"\.attn\.o\.weight$", P(None, "tp")),
    (r"\.mlp\.(gate|up|gateup|fc1)\.weight$", P("tp", None)),
    (r"\.mlp\.(gate|up|gateup|fc1)\.bias$", P("tp")),
    (r"\.mlp\.(down|fc2)\.weight$", P(None, "tp")),
    (r"(embed|token_embedding|lm_head)\.weight$", P(None, None)),
]

# S3Gen / CosyVoice flow graphs (conformer encoder + CFM estimator /
# CosyVoice3 DiT): attention and FFN projections shard megatron-style over
# tp; the conv stacks (HiFT, U-Net res blocks, CAMPPlus) stay replicated.
flow_rules: list[tuple[str, P]] = [
    # ESPnet rel-pos conformer attention
    (r"\.self_attn\.linear_[qkv]\.weight$", P("tp", None)),
    (r"\.self_attn\.linear_[qkv]\.bias$", P("tp")),
    (r"\.self_attn\.linear_pos\.weight$", P("tp", None)),
    (r"\.self_attn\.pos_bias_[uv]$", P("tp", None)),
    (r"\.self_attn\.linear_out\.weight$", P(None, "tp")),
    (r"\.feed_forward\.w_1\.weight$", P("tp", None)),
    (r"\.feed_forward\.w_1\.bias$", P("tp")),
    (r"\.feed_forward\.w_2\.weight$", P(None, "tp")),
    # Matcha-estimator / DiT transformer blocks (to_q/to_k/to_v/to_out naming)
    (r"\.attn\.(q|k|v|to_q|to_k|to_v)\.weight$", P("tp", None)),
    (r"\.attn\.(q|k|v|to_q|to_k|to_v)\.bias$", P("tp")),
    (r"\.attn\.(o|to_out)\.weight$", P(None, "tp")),
    (r"\.ff\.fc1\.weight$", P("tp", None)),
    (r"\.ff\.fc1\.bias$", P("tp")),
    (r"\.ff\.fc2\.weight$", P(None, "tp")),
]

whisper_rules: list[tuple[str, P]] = transformer_rules + [
    (r"\.cross_attn\.[qkv]\.weight$", P("tp", None)),
    (r"\.cross_attn\.[qkv]\.bias$", P("tp")),
    (r"\.cross_attn\.o\.weight$", P(None, "tp")),
    (r"conv[12]\.weight$", P("tp", None, None)),  # (O, I, K): output channels
    (r"conv[12]\.bias$", P("tp")),
]


def _spec_for(path: str, leaf, rules, layer_prefixes: tuple[str, ...]) -> P:
    ndim = getattr(leaf, "ndim", 0)
    stacked = any(p in path for p in layer_prefixes)
    for pat, spec in rules:
        if re.search(pat, path):
            parts = list(spec)
            if stacked:
                parts = [None] + parts
            # pad/crop to leaf rank
            while len(parts) < ndim:
                parts.append(None)
            parts = parts[:ndim]
            return P(*parts)
    return P(*([None] * ndim))


def placements(spec: P, mesh: DeviceMesh) -> tuple:
    """A spec as DTensor placements: for each mesh dimension, Shard(d) of
    the leaf dim d that names it, else Replicate()."""
    return tuple(Shard(spec.index(name)) if name in spec else Replicate()
                 for name in mesh.mesh_dim_names)


def param_shardings(tree, mesh: DeviceMesh, rules=None,
                    layer_prefixes: tuple[str, ...] = ("blocks", "layers")):
    """Return a tree of DTensor placements matching `tree`."""
    rules = rules if rules is not None else transformer_rules
    flat = pytree.flatten(tree)
    specs = {k: placements(_spec_for(k, v, rules, layer_prefixes), mesh)
             for k, v in flat.items()}
    return pytree.unflatten(specs)


def shard_tree(tree, mesh: DeviceMesh, rules=None, **kw):
    """`tree` with every leaf a DTensor placed by `param_shardings` (each
    rank passes the whole tree; rank 0's values are scattered)."""
    shardings = pytree.flatten(param_shardings(tree, mesh, rules, **kw))
    return pytree.unflatten({k: distribute_tensor(v, mesh, shardings[k])
                             for k, v in pytree.flatten(tree).items()})


def local_tree(tree, mesh: DeviceMesh, rules, layer_prefixes: tuple[str, ...] = (),
               axis: str = "tp"):
    """This rank's tree for serving by local shards (no DTensor): every leaf
    that `rules` shard over `axis` cut to the rank's block along that dim,
    each its own contiguous tensor, the rest the caller's tensors. A linear
    leaf dict whose weight is sharded on its output dim becomes a
    column-parallel `TPLinear`, on its input (last) dim a row-parallel one,
    which `nn.layers.linear` all-reduces over the axis's group; its bias
    stays on rank 0 only.

    layer_prefixes defaults to none: the flows keep their blocks as dicts
    keyed by index, not stacked (L, …) leaves. The JAX `shard_tree` passes
    ("blocks", "layers") for them too, so every leaf under a path holding
    "blocks" (the CFM estimator's down/mid/up blocks, the DiT's blocks) has
    its spec shifted by one dim (ROADMAP C34): harmless under GSPMD, which
    partitions any placement correctly, but not a megatron layout."""
    from tpu_audio_torch.parallel.tp_quant import tp_axis

    group, rank, tp = tp_axis(mesh, axis)

    def rec(d, prefix):
        out = {}
        for k, v in d.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = rec(v, path)
                w = v.get("weight")
                if w is None or w.dim() < 2:
                    continue
                spec = _spec_for(f"{path}.weight", w, rules, layer_prefixes)
                if spec[-1] == axis:
                    leaf = {n: t for n, t in out[k].items() if n != "bias" or rank == 0}
                    out[k] = TPLinear(leaf, rank, group)
                elif spec[-2] == axis:
                    out[k] = TPLinear(out[k], rank)
                continue
            spec = _spec_for(path, v, rules, layer_prefixes)
            if axis in spec:
                dim = spec.index(axis)
                if v.shape[dim] % tp:
                    raise ValueError(f"{path}: {v.shape[dim]} along dim {dim} not divisible "
                                     f"by tp={tp}")
                n = v.shape[dim] // tp
                v = v.narrow(dim, rank * n, n).contiguous()
            out[k] = v
        return out

    return rec(tree, "")
