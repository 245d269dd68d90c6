"""PyTorch port, the int8 (W8A8) serving format against the JAX package on
the CPU: conversion of int8 trees, `quantize_rows`, `quantize_array_int8`,
`serve_tree_int8`, the plain versions of the int8_matmul kernels against
the Pallas kernels in interpret mode, the large-M branch, and the layers'
dispatch on int8 dicts.

Codes and scales must equal the JAX package's exactly; products are held
at 1e-5 of max|ref| (f32; the int32 sums are exact on both sides, only the
f32 epilogue can round differently).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.models.whisper import load as jload
from tpu_audio.models.whisper import model as jmodel
from tpu_audio.models.whisper.config import WhisperConfig as JWhisperConfig
from tpu_audio.nn import layers as jlayers
from tpu_audio.ops import quant as jquant
from tpu_audio.ops.pallas import fused_whisper_step as jfws
from tpu_audio.ops.pallas import int8_matmul as ji8
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.whisper import load as tload
from tpu_audio_torch.nn import layers as tlayers
from tpu_audio_torch.ops import quant as tquant
from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DIMS = dict(n_mels=80, n_audio_ctx=64, n_audio_state=256, n_audio_head=4,
            n_audio_layer=1, n_vocab=500, n_text_ctx=16, n_text_state=256,
            n_text_head=4, n_text_layer=2)


@pytest.fixture
def jax_kernels(monkeypatch):
    """Run the JAX package's int8 matmul and fused-step Pallas kernels in
    interpret mode: their gates are off away from the TPU, and a parity
    test that left them off would compare plain with plain."""
    monkeypatch.setattr(ji8, "int8_matmul",
                        functools.partial(ji8.int8_matmul, interpret=True))
    monkeypatch.setattr(ji8, "int8_matmul_stacked",
                        functools.partial(ji8.int8_matmul_stacked, interpret=True))
    monkeypatch.setattr(ji8, "supported", lambda *a, **k: True)
    monkeypatch.setattr(ji8, "supported_stacked", lambda *a, **k: True)
    monkeypatch.setattr(jfws, "fused_whisper_decode_step",
                        functools.partial(jfws.fused_whisper_decode_step, interpret=True))
    monkeypatch.setattr(jfws, "decode_supported", lambda *a, **k: True)


def close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, err


def jax_tree(seed=1, **dims):
    return jmodel.init_params(jax.random.PRNGKey(seed), JWhisperConfig(**{**DIMS, **dims}))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_params_from_numpy_keeps_int8_codes_and_f32_scales():
    jq = jload.serve_tree_int8(jax_tree(), encoder=False)
    tq = params_from_numpy(numpy_tree(jq), dtype=torch.bfloat16, device="cpu")
    dec = tq["decoder"]
    fc1 = dec["blocks"]["mlp"]["fc1"]
    assert fc1["weight_i8"].dtype == torch.int8
    assert fc1["scale_i8"].dtype == torch.float32
    assert fc1["bias"].dtype == torch.bfloat16
    assert dec["token_embedding"]["scale_i8"].dtype == torch.float32
    assert dec["blocks"]["ln1"]["weight"].dtype == torch.bfloat16
    flat = jax.tree_util.tree_flatten_with_path(jq["decoder"])[0]
    n = 0
    for path, leaf in flat:
        keys = [p.key for p in path]
        if keys[-1] in ("weight_i8", "scale_i8"):
            node = dec
            for k in keys:
                node = node[k]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
            n += 1
    assert n == 2 * 11  # 10 block linears + the token embedding


def test_quantize_rows_matches_with_ties(rng):
    x = rng.standard_normal((5, 256)).astype(np.float32) * 3
    # row 0: max 127 gives scale 1, so these are exact .5 ties
    x[0] = 0.0
    x[0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    xq, sx = i8mm.quantize_rows(torch.from_numpy(x))
    jq, jsx = ji8.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    assert float(sx[0]) == 1.0
    assert xq[0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]  # half to even


@pytest.mark.parametrize("shape", [(48, 128), (3, 96, 256)])
def test_quantize_array_int8_matches_exactly(rng, shape):
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 0, :] = 0.0  # an all-zero channel takes the 1e-10 floor
    got = tquant.quantize_array_int8(torch.from_numpy(w))
    ref = jquant.quantize_array_int8(w)
    for k in ("weight_i8", "scale_i8"):
        assert got[k].dtype == torch.from_numpy(ref[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    np.testing.assert_array_equal(tquant.dequantize_int8(got).numpy(),
                                  np.asarray(jquant.dequantize_int8(ref)))


@pytest.mark.parametrize("encoder", [False, True])
def test_serve_tree_int8_matches_exactly(encoder):
    jp = jax_tree()
    ref = jax.tree_util.tree_flatten_with_path(
        jload.serve_tree_int8(jp, encoder=encoder))[0]
    got = tload.serve_tree_int8(params_from_numpy(numpy_tree(jp), device="cpu"), encoder=encoder)
    got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(got_flat) == len(ref)
    for path, leaf in ref:
        keys = [p.key for p in path]
        t = got_flat[path]
        if "conv" in "".join(keys) and keys[-1] == "weight":
            continue  # conv kernels are transposed by design
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf), err_msg=str(keys))
    assert "weight_i8" in got["decoder"]["blocks"]["attn"]["q"]
    assert got["decoder"]["positional_embedding"].dtype == torch.float32
    assert ("weight_i8" in got["encoder"]["blocks"]["mlp"]["fc1"]) == encoder


@pytest.mark.parametrize("b,i,o", [(1, 256, 512), (3, 256, 300), (16, 512, 1000),
                                   (32, 128, 257)])
def test_int8_matmul_plain_matches_pallas(rng, b, i, o):
    """Up to 32 rows, any O: a ragged O runs the kernel's tail on the JAX
    side and the same loop on the port's."""
    x = (rng.standard_normal((b, i)) * 0.5).astype(np.float32)
    w = rng.integers(-127, 128, (o, i)).astype(np.int8)
    s = rng.uniform(0.001, 0.02, (o, 1)).astype(np.float32)
    ref = ji8.int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                          block_o=256, interpret=True)
    got = i8mm.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s))
    assert got.dtype == torch.float32
    close(got, ref)


def test_int8_matmul_stacked_plain_matches_pallas(rng):
    lyr, b, i, o = 3, 4, 256, 512
    x = rng.standard_normal((b, i)).astype(np.float32)
    w = rng.integers(-127, 128, (lyr, o, i)).astype(np.int8)
    s = rng.uniform(0.001, 0.02, (lyr, o, 1)).astype(np.float32)
    for layer in (0, lyr - 1):
        ref = ji8.int8_matmul_stacked(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s[layer]),
                                      jnp.int32(layer), interpret=True)
        got = i8mm.int8_matmul_stacked(torch.from_numpy(x), torch.from_numpy(w),
                                       torch.from_numpy(s[layer]), layer)
        close(got, ref)
    wrong = i8mm.int8_matmul_stacked(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(s[layer]), 0)
    assert not np.allclose(wrong.numpy(), np.asarray(ref), atol=1e-2)


def test_bigm_matches_jax(rng):
    m, i, o = 300, 256, 387  # ragged O, as the lm head's 51866
    x = rng.standard_normal((m, i)).astype(np.float32)
    w = rng.integers(-127, 128, (o, i)).astype(np.int8)
    s = rng.uniform(0.001, 0.02, (o, 1)).astype(np.float32)
    ref = ji8.int8_matmul_bigm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s))
    close(i8mm.int8_matmul_bigm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s)),
          ref)


@pytest.mark.parametrize("rows", [1, 5, 32, 40])
def test_linear_and_head_dispatch_match(rng, jax_kernels, rows):
    """`linear`, `embedding` and `embedding_as_linear` on int8 dicts: the
    kernel up to 32 rows (the JAX one patched to interpret), the exact
    dequantised product above on the CPU, as the JAX package does."""
    w = (rng.standard_normal((384, 256)) * 0.05).astype(np.float32)
    q = jquant.quantize_array_int8(w)
    jp = {**{k: jnp.asarray(v) for k, v in q.items()},
          "bias": jnp.asarray(rng.standard_normal(384).astype(np.float32))}
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    x = rng.standard_normal((rows, 256)).astype(np.float32)
    close(tlayers.linear(tp, torch.from_numpy(x)), jlayers.linear(jp, jnp.asarray(x)))
    head = {k: v for k, v in tp.items() if k != "bias"}
    jhead = {k: v for k, v in jp.items() if k != "bias"}
    close(tlayers.embedding_as_linear(head, torch.from_numpy(x)),
          jlayers.embedding_as_linear(jhead, jnp.asarray(x)))
    ids = np.array([[1, 5], [383, 0]])
    rows_t = tlayers.embedding(head, torch.from_numpy(ids))
    assert rows_t.dtype == torch.float32
    np.testing.assert_array_equal(rows_t.numpy(),
                                  np.asarray(jlayers.embedding(jhead, jnp.asarray(ids))))


def test_stacked_leaf_takes_the_stacked_kernel_and_slices_for_many_rows(rng):
    w = (rng.standard_normal((2, 256, 128)) * 0.05).astype(np.float32)
    q = tquant.quantize_array_int8(torch.from_numpy(w))
    p = {"weight_i8_stacked": q["weight_i8"], "layer_idx": 1, "scale_i8": q["scale_i8"][1]}
    for rows in (4, 40):
        x = torch.from_numpy(rng.standard_normal((rows, 128)).astype(np.float32))
        flat = {"weight_i8": q["weight_i8"][1], "scale_i8": q["scale_i8"][1]}
        torch.testing.assert_close(tquant.int8_linear(p, x), tquant.int8_linear(flat, x))


def test_wrappers_launch_nothing_on_cpu_and_refuse_other_devices(rng):
    x = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (2, 64, 128)).astype(np.int8))
    s = torch.full((64, 1), 0.01)
    before = dict(i8mm.LAUNCHES)
    i8mm.int8_matmul(x, w[0], s)
    i8mm.int8_matmul_stacked(x, w, s, 1)
    assert i8mm.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        i8mm.int8_matmul(x.to("meta"), w[0], s)
    with pytest.raises(ValueError, match="CUDA"):
        i8mm.int8_matmul_stacked(x.to("meta"), w, s, 1)


def test_unported_formats_raise():
    """The group-affine q4/q8 and the W4A8 layouts are ported
    (tests/test_torch_port_quant_q4.py, test_torch_port_w4a8.py); what the
    port still refuses: a super-group embedding lookup, which the JAX
    package lacks too (ROADMAP C5). The int8 KV cache is ported (ROADMAP
    A9, tests/test_torch_port_speculative.py)."""
    from tpu_audio_torch.nn import transformer as tt
    from tpu_audio_torch.ops.kvcache import QuantizedKVCache

    q4s = {"weight_q4s": torch.zeros((4, 128), dtype=torch.int8), "scales_sg": torch.ones((4, 1))}
    with pytest.raises(ValueError, match="ROADMAP C5"):
        tquant.dequantize_rows(q4s, torch.tensor([0, 2]))
    cfg = tt.TransformerConfig(dim=64, n_layers=1, n_heads=2)
    cache = tt.make_cache(cfg, 1, 8, quantized=True, device="cpu")
    assert isinstance(cache, QuantizedKVCache) and cache.k_q.dtype == torch.int8


def test_new_modules_import_without_jax_nvcc_or_cuda():
    """The slice's modules import with jax blocked and no nvcc or card,
    and build nothing at import."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from tpu_audio_torch.api import stt\n"
        "from tpu_audio_torch.models.whisper import decoding, load, pipeline\n"
        "from tpu_audio_torch.ops import quant\n"
        "from tpu_audio_torch.ops.kernels import (_build, fused_encoder_int8,\n"
        "                                        fused_whisper_step, int8_matmul)\n"
        "assert _build._lib is None\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'tpu_audio']\n"
        "print('ok')\n")
    env = {**os.environ, "PATH": "/nonexistent", "CUDA_HOME": "/nonexistent",
           "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
