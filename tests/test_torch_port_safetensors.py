"""The port's safetensors reader, parameter-tree helpers and hub resolution
(tpu_audio_torch/utils/weights.py, pytree.py, hub.py) against the
`safetensors` package, the JAX package's helpers and the Hugging Face cache
layout; and the port's imports with the packages the card lacks blocked.

The reader is held against `safetensors.numpy` on every dtype it reads,
0-d and empty tensors, several files and `__metadata__`, and against the
JAX `load_safetensors_dir` bit for bit (bf16 widened to f32 by its bits);
each malformed file is refused naming the file and the key. chip_smoke's
own writer (the card has no `safetensors`) is read back by the package.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file

import chip_smoke
from tpu_audio.utils import pytree as jpytree
from tpu_audio.utils import weights as jweights
from tpu_audio_torch.api.errors import ModelLoadError
from tpu_audio_torch.utils import hub, pytree, weights
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
          "BF16": ml_dtypes.bfloat16, "I64": np.int64, "I32": np.int32, "I16": np.int16,
          "I8": np.int8, "U8": np.uint8, "U32": np.uint32, "BOOL": np.bool_}


def _tensors(seed: int) -> dict[str, np.ndarray]:
    """One tensor of every dtype, plus 0-d and empty ones."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, dt in DTYPES.items():
        if dt is np.bool_:
            a = rng.random((3, 5)) > 0.5
        elif np.issubdtype(dt, np.integer):
            info = np.iinfo(dt)
            a = rng.integers(info.min, info.max, (3, 5), dtype=dt, endpoint=True)
        else:
            a = (rng.standard_normal((4, 3, 2)) * 100).astype(dt)
        out[f"t.{name.lower()}"] = a
    out["scalar.f32"] = np.array(3.5, np.float32)
    out["scalar.bf16"] = np.array(-1.25, ml_dtypes.bfloat16)
    out["empty.i8"] = np.zeros((0, 4), np.int8)
    out["empty.bf16"] = np.zeros((2, 0), ml_dtypes.bfloat16)
    return out


def _widened(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _same(got: np.ndarray, want: np.ndarray) -> bool:
    """Equal dtype, shape and bytes (NaN patterns included)."""
    return (got.dtype == want.dtype and got.shape == want.shape
            and got.tobytes() == want.tobytes())


def test_reader_matches_safetensors_package(tmp_path):
    tensors = _tensors(0)
    meta = {"format": "mlx", "note": "two files"}
    save_file(tensors, str(tmp_path / "a.safetensors"), metadata=meta)
    got, got_meta = weights.read_safetensors(str(tmp_path / "a.safetensors"))
    assert got_meta == meta
    with safe_open(str(tmp_path / "a.safetensors"), framework="numpy") as sf:
        assert sf.metadata() == meta
        keys = list(sf.keys())
        want = {k: sf.get_tensor(k) for k in keys}
    assert list(got) == keys == sorted(tensors)
    for k, a in want.items():
        assert _same(got[k], _widened(a)), k
    assert got["t.bf16"].dtype == np.float32  # bf16 comes across widened, exactly


def test_reader_several_files_later_wins(tmp_path):
    first, second = _tensors(1), _tensors(2)
    second = {k: v for i, (k, v) in enumerate(second.items()) if i % 2}
    second["only.second"] = np.arange(6, dtype=np.int32).reshape(2, 3)
    save_file(first, str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file(second, str(tmp_path / "model-00002-of-00002.safetensors"))
    got = weights.load_safetensors_dir(str(tmp_path))
    want = {**first, **second}
    assert set(got) == set(want)
    for k, a in want.items():
        assert _same(got[k], _widened(a)), k


def test_reader_matches_jax_loader(tmp_path):
    """Bit for bit against the JAX `load_safetensors_dir` (which returns
    numpy bf16 through ml_dtypes) after widening its bf16 leaves."""
    save_file(_tensors(3), str(tmp_path / "x.safetensors"))
    save_file({"y.w": np.ones((2, 2), ml_dtypes.bfloat16)}, str(tmp_path / "y.safetensors"))
    got = weights.load_safetensors_dir(str(tmp_path))
    want = jweights.load_safetensors_dir(str(tmp_path))
    assert list(got) == list(want)
    for k, a in want.items():
        assert _same(got[k], _widened(np.asarray(a))), k


def test_chip_smoke_writer_reads_back(tmp_path):
    """chip_smoke's writer, which the card uses, makes files the package
    and the port read alike, bf16 torch tensors as BF16."""
    tensors = {k: v for k, v in _tensors(4).items() if v.dtype != ml_dtypes.bfloat16}
    bf = torch.tensor([[1.5, -2.0], [3.0e-3, 7.0]], dtype=torch.bfloat16)
    path = tmp_path / "w.safetensors"
    n = chip_smoke.write_safetensors(path, {**tensors, "bf": bf}, {"format": "mlx"})
    assert n == path.stat().st_size
    with safe_open(str(path), framework="numpy") as sf:
        assert sf.metadata() == {"format": "mlx"}
        assert sf.get_tensor("bf").astype(np.float32).tobytes() == bf.float().numpy().tobytes()
        for k, a in tensors.items():
            assert _same(sf.get_tensor(k), a), k
    got, _ = weights.read_safetensors(str(path))
    assert got["bf"].tobytes() == bf.float().numpy().tobytes()


def _raw_file(path: Path, header: dict, data: bytes, pad: bool = True) -> None:
    head = json.dumps(header).encode()
    if pad:
        head += b" " * (-len(head) % 8)
    path.write_bytes(struct.pack("<Q", len(head)) + head + data)


def _bad_files():
    """(name, header, data, what the message names)."""
    ok = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    return [
        ("truncated", {"w": ok}, b"\0" * 6, "w"),
        ("offsets out of range", {"w": {**ok, "data_offsets": [8, 16]}}, b"\0" * 8, "w"),
        ("overlap", {"a": ok, "b": {**ok, "data_offsets": [4, 12]}}, b"\0" * 12, "b"),
        ("unknown dtype", {"w": {**ok, "dtype": "F8_E4M3"}}, b"\0" * 8, "w"),
        ("size against shape", {"w": {**ok, "shape": [3]}}, b"\0" * 8, "w"),
        ("bad shape", {"w": {**ok, "shape": [-1]}}, b"\0" * 8, "w"),
        ("metadata not strings", {"__metadata__": {"a": 1}, "w": ok}, b"\0" * 8,
         "__metadata__"),
    ]


@pytest.mark.parametrize("case", _bad_files(), ids=[c[0] for c in _bad_files()])
def test_reader_refuses_malformed(tmp_path, case):
    _, header, data, key = case
    path = tmp_path / "bad.safetensors"
    _raw_file(path, header, data)
    with pytest.raises(weights.SafetensorsError) as err:
        weights.read_safetensors(str(path))
    assert str(path) in str(err.value) and f": {key}:" in str(err.value)


@pytest.mark.parametrize("blob", [b"\1\0", struct.pack("<Q", 1000) + b"{}",
                                  struct.pack("<Q", 4) + b"{{{{"],
                         ids=["shorter than the length", "header past the end", "not JSON"])
def test_reader_refuses_bad_header(tmp_path, blob):
    path = tmp_path / "bad.safetensors"
    path.write_bytes(blob)
    with pytest.raises(weights.SafetensorsError, match="header"):
        weights.read_safetensors(str(path))


def test_empty_directory_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        weights.load_safetensors_dir(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        jweights.load_safetensors_dir(str(tmp_path))


# ------------------------------------------------------------ trees

def _nested(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": {"b": rng.standard_normal((2, 3)).astype(np.float32),
                  "c": {"d": np.arange(4, dtype=np.int32)}},
            "e": rng.standard_normal(5).astype(np.float32)}


def test_pytree_matches_jax():
    tree = _nested(0)
    flat, jflat = pytree.flatten(tree), jpytree.flatten(tree)
    assert list(flat) == list(jflat) == ["a.b", "a.c.d", "e"]
    assert pytree.flatten(tree, "p", "/") == jpytree.flatten(tree, "p", "/")
    back = pytree.unflatten(flat)
    assert jpytree.flatten(back) == jflat
    assert pytree.param_count(tree) == jpytree.param_count(tree) == 15
    trees = [_nested(i) for i in range(3)]
    got, want = pytree.flatten(pytree.stack_layers(trees)), jpytree.flatten(
        jpytree.stack_layers(trees))
    assert sorted(got) == sorted(want)
    for k in want:
        assert _same(got[k], np.asarray(want[k])), k
    tt = pytree.stack_layers([{"w": torch.ones(2)}, {"w": torch.zeros(2)}])
    assert torch.equal(tt["w"], torch.tensor([[1.0, 1.0], [0.0, 0.0]]))


def test_apply_rules_and_stack_numbered_layers_match_jax():
    rng = np.random.default_rng(1)
    flat = {f"model.layers.{i}.self_attn.q_proj.{leaf}": rng.standard_normal((3, 4)).astype(
        np.float32) for i in range(3) for leaf in ("weight", "bias")}
    flat["model.norm.weight"] = np.ones(4, np.float32)
    flat["model.rotary_emb.inv_freq"] = np.ones(2, np.float32)
    rules = [(r"^model\.", ""), (r"\.self_attn\.q_proj\.", ".attn.q.")]
    kw = dict(transforms={r"attn\.q\.weight": lambda v: v * 2},
              drop=[r"rotary_emb"])
    got = weights.apply_rules(flat, rules, **kw)
    want = jweights.apply_rules(flat, rules, **kw)
    assert list(got) == list(want)
    assert all(_same(got[k], want[k]) for k in want)
    tree = weights.stack_numbered_layers(got, "layers")
    jtree = jweights.stack_numbered_layers(want, "layers")
    g, j = pytree.flatten(tree), jpytree.flatten(jtree)
    assert sorted(g) == sorted(j)  # jax.tree_util orders dict keys
    assert all(_same(g[k], np.asarray(j[k])) for k in j)
    assert weights.module_prefixes(g) == jweights.module_prefixes(j)
    assert weights.LEAF_NAMES == jweights.LEAF_NAMES


def test_shape_rng_schema_allocates_nothing():
    """A 3B schema from ShapeRNG: every drawn leaf abstract, the shapes
    those of numpy_params at that config."""
    from tpu_audio_torch.models.orpheus.model import LLAMA_3B
    from tpu_audio_torch.nn import transformer

    schema = pytree.flatten(transformer.numpy_params(weights.ShapeRNG(), LLAMA_3B))
    drawn = [v for v in schema.values() if isinstance(v, weights.AbstractLeaf)]
    assert schema["layers.mlp.down.weight"].shape == (28, 3072, 8192)
    assert schema["embed.weight"].shape == (156940, 3072)
    assert sum(int(np.prod(v.shape)) for v in drawn) > 3e9


# ------------------------------------------------------------ hub

def _seed(root: Path, repo: str) -> Path:
    files = {"config.json": chip_smoke.write_text("{}")}
    snap, _ = chip_smoke.seed_cache(root, repo, files)
    return snap


def test_hub_directory_passes_through(tmp_path):
    assert hub.snapshot(str(tmp_path)) == str(tmp_path)


def test_hub_cached_snapshot(tmp_path, monkeypatch):
    """A repo id resolves to its snapshot under $TPU_AUDIO_CACHE, read at
    the call, where huggingface_hub's offline snapshot_download finds it."""
    snap = _seed(tmp_path, "org/model-4bit")
    monkeypatch.setenv("TPU_AUDIO_CACHE", str(tmp_path))
    assert hub.snapshot("org/model-4bit") == str(snap)
    from huggingface_hub import snapshot_download

    assert snapshot_download("org/model-4bit", cache_dir=str(tmp_path),
                             local_files_only=True) == str(snap)


def test_hub_missing_raises_model_load_error(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_AUDIO_CACHE", str(tmp_path / "empty"))
    with pytest.raises(ModelLoadError) as err:
        hub.snapshot("org/absent")
    msg = str(err.value)
    assert "org/absent" in msg and str(tmp_path / "empty") in msg
    assert "models--org--absent" in err.value.recovery_suggestion or "pre-seed" in msg


def test_hub_default_cache_is_read_at_call(tmp_path, monkeypatch):
    monkeypatch.delenv("TPU_AUDIO_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    root = tmp_path / ".cache" / "tpu_audio" / "hub"
    snap = _seed(root, "org/m")
    assert hub.cache_root() == str(root)
    assert hub.snapshot("org/m") == str(snap)


# ------------------------------------------------------------ imports

def test_port_imports_without_card_absent_packages():
    """`import tpu_audio_torch` and every module of the checkpoint layer
    import with jax, regex, tokenizers, safetensors, ml_dtypes and
    huggingface_hub blocked, and a tokenizer.json still encodes."""
    code = (
        "import sys\n"
        "for m in ('jax', 'regex', 'tokenizers', 'safetensors', 'ml_dtypes',\n"
        "          'huggingface_hub'):\n"
        "    sys.modules[m] = None\n"
        "import tpu_audio_torch\n"
        "from tpu_audio_torch.api import errors, results, stt, stt_funasr, tts\n"
        "from tpu_audio_torch.models.funasr import load as fload\n"
        "from tpu_audio_torch.models.orpheus import engine, load as oload\n"
        "from tpu_audio_torch.models.whisper import load as wload, tokenizer\n"
        "from tpu_audio_torch.nn import load_llama\n"
        "from tpu_audio_torch.ops import resample\n"
        "from tpu_audio_torch.utils import _unicode, audio_io, hub, pytree, weights\n"
        "from tpu_audio_torch.utils.tokenizer import HFTokenizer\n"
        "import json\n"
        "gold = json.load(open('tests/data/tokenizer_golden/golden.json'))\n"
        "tok = HFTokenizer('tests/data/tokenizer_golden/gpt2.json')\n"
        "assert tok.encode(gold['texts'][0]) == gold['ids']['gpt2'][0]\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'tpu_audio'], 'tpu_audio'\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
