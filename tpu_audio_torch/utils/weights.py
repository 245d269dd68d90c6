"""Checkpoint reading and key remapping (port of tpu_audio/utils/weights.py:
load_safetensors_dir, load_config_json, apply_rules, stack_numbered_layers,
LEAF_NAMES, module_prefixes, validate_tree, to_device), with a safetensors
reader of its own: the card's Python has no `safetensors` package.

A safetensors file is an 8-byte little-endian header length N, N bytes of
JSON ({name: {"dtype", "shape", "data_offsets": [begin, end]}}, and an
optional "__metadata__" of strings), then the data; offsets count from the
end of the header. `read_safetensors` maps the file and copies each tensor
out as a numpy array. BF16, which numpy lacks, is widened to float32 by its
bits (the bf16 pattern in the high half), so every value comes across
exactly; `convert.params_from_numpy` then casts to the target dtype. The
reader refuses a truncated file, a header that is not such JSON, an unknown
dtype, a byte range that does not match its shape, and ranges that leave
the data section or overlap, naming the file and the key.

A loader runs: snapshot → config.json → `load_safetensors_dir` (numpy, the
JAX package's layout) → the model's sanitize (key rules, transposes, layer
stacking) → `validate_tree` against the model's `numpy_params` schema →
`to_device` (the port's layout and dtype).
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import re
import struct
from typing import Callable

import numpy as np
import torch

from tpu_audio_torch.api.errors import ModelLoadError
from tpu_audio_torch.utils import pytree

# safetensors dtype → numpy dtype of its bytes (BF16 is read as its bits)
DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2", "I64": "<i8",
          "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1", "U32": "<u4", "BOOL": "?"}
_MAX_HEADER = 100 << 20  # the safetensors package's own limit


class SafetensorsError(ValueError):
    """A malformed safetensors file; the message names the file and key."""


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 patterns → float32 with the same value."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def read_safetensors(path: str) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """One safetensors file → ({name: array}, metadata), names sorted."""
    def fail(key, msg):
        raise SafetensorsError(f"{path}: {key}: {msg}")

    size = os.path.getsize(path)
    if size < 8:
        fail("header", f"file of {size} bytes is truncated")
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        (n,) = struct.unpack("<Q", mm[:8])
        if n > _MAX_HEADER or 8 + n > size:
            fail("header", f"header of {n} bytes does not fit the file's {size} bytes "
                           "(truncated)")
        try:
            header = json.loads(bytes(mm[8:8 + n]).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            fail("header", f"not JSON: {e}")
        if not isinstance(header, dict):
            fail("header", "not a JSON object")
        meta = header.pop("__metadata__", None) or {}
        if not isinstance(meta, dict) or not all(
                isinstance(v, str) for v in meta.values()):
            fail("__metadata__", "not a map of strings")
        data_len = size - 8 - n
        spans = []
        for key, info in header.items():
            if not isinstance(info, dict) or set(info) != {"dtype", "shape", "data_offsets"}:
                fail(key, f"entry {info!r} lacks dtype, shape or data_offsets")
            dt, shape, offs = info["dtype"], info["shape"], info["data_offsets"]
            if dt not in DTYPES:
                fail(key, f"unknown dtype {dt!r}; one of {sorted(DTYPES)}")
            if not (isinstance(shape, list) and all(
                    isinstance(d, int) and d >= 0 for d in shape)):
                fail(key, f"bad shape {shape!r}")
            if not (isinstance(offs, list) and len(offs) == 2
                    and all(isinstance(o, int) for o in offs)):
                fail(key, f"bad data_offsets {offs!r}")
            begin, end = offs
            if not 0 <= begin <= end <= data_len:
                fail(key, f"data_offsets {offs} outside the {data_len} data bytes "
                          "(truncated file or bad offsets)")
            want = int(np.prod(shape)) * np.dtype(DTYPES[dt]).itemsize
            if end - begin != want:
                fail(key, f"data_offsets {offs} hold {end - begin} bytes; "
                          f"{dt} {shape} needs {want}")
            spans.append((begin, end, key))
        spans.sort()
        for (b0, e0, k0), (b1, _, k1) in zip(spans, spans[1:]):
            if b1 < e0:
                fail(k1, f"bytes from {b1} overlap those of {k0!r} (to {e0})")
        out = {}
        for key in sorted(header):
            info = header[key]
            dt, shape = np.dtype(DTYPES[info["dtype"]]), tuple(info["shape"])
            begin = 8 + n + info["data_offsets"][0]
            count = int(np.prod(shape))
            a = (np.frombuffer(mm, dt, count, begin).copy() if count
                 else np.empty(0, dt)).reshape(shape)
            out[key] = bf16_to_f32(a) if info["dtype"] == "BF16" else a
    return out, meta


def load_safetensors_dir(path: str) -> dict[str, np.ndarray]:
    """Every *.safetensors under a directory, in sorted order, into one flat
    dict (a later file's key replaces an earlier one's)."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    flat: dict[str, np.ndarray] = {}
    for f in files:
        flat.update(read_safetensors(f)[0])
    return flat


def load_config_json(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def apply_rules(flat: dict[str, np.ndarray],
                rules: list[tuple[str, str]],
                transforms: dict[str, Callable] | None = None,
                drop: list[str] | None = None) -> dict[str, np.ndarray]:
    """Rename keys by regex rules applied in sequence (a key may be
    rewritten by several), apply per-key transforms (matched on the new key
    by regex) and drop the keys that match `drop`."""
    out = {}
    drop_res = [re.compile(d) for d in (drop or [])]
    transform_res = [(re.compile(k), fn) for k, fn in (transforms or {}).items()]
    for key, val in flat.items():
        if any(d.search(key) for d in drop_res):
            continue
        new_key = key
        for pat, repl in rules:
            new_key = re.sub(pat, repl, new_key)
        for pat, fn in transform_res:
            if pat.search(new_key):
                val = fn(val)
        out[new_key] = val
    return out


def stack_numbered_layers(flat: dict[str, np.ndarray], prefix: str) -> dict:
    """Collect '{prefix}.{i}.rest' keys into a tree whose leaves are stacked
    on a leading layer axis, beside all the other keys: the nested tree."""
    layer_re = re.compile(rf"^{re.escape(prefix)}\.(\d+)\.(.+)$")
    per_layer: dict[int, dict] = {}
    rest = {}
    for k, v in flat.items():
        m = layer_re.match(k)
        if m:
            per_layer.setdefault(int(m.group(1)), {})[m.group(2)] = v
        else:
            rest[k] = v
    tree = pytree.unflatten(rest)
    if per_layer:
        n = max(per_layer) + 1
        stacked = pytree.stack_layers([pytree.unflatten(per_layer[i]) for i in range(n)])
        node = tree
        parts = prefix.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = stacked
    return tree


# leaf names that may differ between a checkpoint and init_params (an fp
# "weight" against quantised triples or pairs)
LEAF_NAMES = {
    "weight", "bias", "weight_q4", "weight_q8", "weight_i8", "scales",
    "biases", "scale_i8", "weight_v", "weight_g", "alpha", "codebook",
    "running_mean", "running_var", "num_batches_tracked",
}


def module_prefixes(keys) -> set[str]:
    """Flat keys → module prefixes ('enc.blocks.attn.q.weight' →
    'enc.blocks.attn.q'); other leaves stay whole keys."""
    mods = set()
    for k in keys:
        head, _, leaf = k.rpartition(".")
        mods.add(head if leaf in LEAF_NAMES and head else k)
    return mods


class AbstractLeaf:
    """A leaf with a shape and no data: arithmetic and numpy's elementwise
    functions broadcast the shape, `sum` reduces it."""

    def __init__(self, shape, dtype=np.float32):
        self.shape, self.dtype = tuple(shape), np.dtype(dtype)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__" or ufunc.nout != 1 or kwargs:
            return NotImplemented
        return AbstractLeaf(np.broadcast_shapes(*(np.shape(x) if not isinstance(x, AbstractLeaf)
                                                  else x.shape for x in inputs)), self.dtype)

    def _binary(self, other):
        return self.__array_ufunc__(np.add, "__call__", self, other)

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _binary

    def sum(self, axis=None, keepdims=False):
        axes = range(len(self.shape)) if axis is None else np.atleast_1d(axis) % len(self.shape)
        shape = [1 if i in axes else d for i, d in enumerate(self.shape)] if keepdims else \
            [d for i, d in enumerate(self.shape) if i not in axes]
        return AbstractLeaf(shape, self.dtype)


class ShapeRNG:
    """Stands in for np.random.Generator in a model's `numpy_params`: each
    draw is an AbstractLeaf, so the schema of a 3B tree allocates nothing
    (the JAX loaders take it from jax.eval_shape)."""

    def random(self, shape, dtype=np.float32):
        return AbstractLeaf(shape, dtype)

    standard_normal = random


def validate_tree(loaded: dict, expected: dict, name: str = "model") -> None:
    """Compare a sanitised checkpoint tree with the model's schema and raise
    ModelLoadError on missing modules, unexpected keys or shape drift.

    Both trees are in the checkpoint's layout, the JAX package's: `loaded`
    as sanitize gives it and `expected` the model's `numpy_params` drawn
    from a ShapeRNG, before `to_device` moves conv kernels to torch's
    layout. Quantised checkpoints pass because the comparison is at module
    granularity (a module may carry {weight} or {weight_q4, scales,
    biases}); shapes are checked for the leaves both trees name."""
    want = {k: tuple(v.shape) for k, v in pytree.flatten(expected).items()}
    got = {k: tuple(v.shape) for k, v in pytree.flatten(loaded).items()}

    missing = sorted(module_prefixes(want) - module_prefixes(got))
    unexpected = sorted(module_prefixes(got) - module_prefixes(want))
    problems = []
    if missing:
        problems.append(f"{len(missing)} missing modules, e.g. {missing[:5]}")
    if unexpected:
        problems.append(
            f"{len(unexpected)} unexpected keys left after sanitize, "
            f"e.g. {unexpected[:5]}")
    bad = [f"{k}: checkpoint {got[k]} vs model {want[k]}"
           for k in sorted(set(got) & set(want)) if got[k] != want[k]]
    if bad:
        problems.append(f"{len(bad)} shape mismatches, e.g. {bad[:5]}")
    if problems:
        raise ModelLoadError(name, "; ".join(problems))


def to_device(tree: dict, dtype: torch.dtype = torch.float32,
              device: torch.device | str = "cuda") -> dict:
    """numpy tree in the JAX layout → the port's tree on `device` (the card
    unless the caller asks for the CPU): `convert.params_from_numpy`, float
    leaves cast to `dtype` (group-affine scales and biases stay float32)."""
    from tpu_audio_torch.convert import params_from_numpy

    return params_from_numpy(tree, device, dtype)
