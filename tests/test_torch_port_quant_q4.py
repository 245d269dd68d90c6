"""PyTorch port, the group-affine q4/q8 format (MLX checkpoints) against
the JAX package on the CPU: packing, `quantize_array` / `quantize_tree`,
`dequantize` / `dequantize_rows`, the plain `quant_matmul` against the
Pallas kernel in interpret mode, the `quantized_linear` dispatch, and the
conversion to the int8 serving format (`requantize_tree_int8`,
`fuse_int8_tree`).

Codes, scales and biases must equal the JAX package's exactly (the same
f32 arithmetic). Products are held at 1e-5 of max|ref|: both sides sum the
same f32 terms in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.ops import quant as jquant
from tpu_audio.ops.pallas import quant_matmul as jqmm
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.nn import layers as tlayers
from tpu_audio_torch.ops import quant as tquant
from tpu_audio_torch.ops.kernels import quant_matmul as qmm


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Every pl.pallas_call of the JAX package in interpret mode, as
    tests/test_pallas_mel.py runs the quant_matmul kernel on the CPU."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp)


def close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, err


def to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(48, 128), (3, 40, 192)])
def test_quantize_array_matches_exactly(rng, bits, shape):
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 0, :64] = 0.25  # a constant group takes the 1e-8 scale floor
    ref = jquant.quantize_array(w, bits)
    got = tquant.quantize_array(torch.from_numpy(w), bits)
    key = f"weight_q{bits}"
    assert got[key].dtype == torch.int32
    np.testing.assert_array_equal(got[key].numpy(), ref[key].view(np.int32))
    for k in ("scales", "biases"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    np.testing.assert_array_equal(tquant.dequantize(got).numpy(),
                                  np.asarray(jquant.dequantize(
                                      {k: jnp.asarray(v) for k, v in ref.items()})))


@pytest.mark.parametrize("bits", [4, 8])
def test_pack_unpack_match_with_the_top_bit_set(rng, bits):
    vals = rng.integers(0, 1 << bits, (6, 64)).astype(np.uint32)
    vals[:, 32 // bits - 1] = (1 << bits) - 1  # sets bit 31 of each first word
    packed = jquant.pack_uint32(vals, bits)
    assert (packed[:, 0] >= 2 ** 31).all()
    got = tquant.pack_uint32(torch.from_numpy(vals.astype(np.int64)), bits)
    np.testing.assert_array_equal(got.numpy(), packed.view(np.int32))
    np.testing.assert_array_equal(tquant.unpack_uint32(got, bits).numpy(),
                                  np.asarray(jquant.unpack_uint32(jnp.asarray(packed), bits)))


@pytest.mark.parametrize("bits", [4, 8])
def test_dequantize_rows_matches(rng, bits):
    w = (rng.standard_normal((50, 128)) * 0.02).astype(np.float32)
    q = jquant.quantize_array(w, bits)
    jq = {k: jnp.asarray(v) for k, v in q.items()}
    tq = to_torch(q)
    ids = np.array([[0, 49, 7], [3, 3, 12]])
    got = tlayers.embedding(tq, torch.from_numpy(ids))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jquant.dequantize_rows(jq, ids)))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("b,i,o", [(1, 256, 300), (5, 128, 1000), (32, 192, 77)])
def test_quant_matmul_plain_matches_pallas(rng, interpret_pallas, bits, b, i, o):
    """Any O (the TPU kernel pads a ragged O to its block), 1 to 32 rows."""
    w = (rng.standard_normal((o, i)) * 0.05).astype(np.float32)
    q = jquant.quantize_array(w, bits)
    x = rng.standard_normal((b, i)).astype(np.float32)
    key = f"weight_q{bits}"
    ref = jqmm.quant_matmul(jnp.asarray(x), jnp.asarray(q[key]), jnp.asarray(q["scales"]),
                            jnp.asarray(q["biases"]), bits=bits)
    tq = to_torch(q)
    got = qmm.quant_matmul(torch.from_numpy(x), tq[key], tq["scales"], tq["biases"], bits=bits)
    assert got.dtype == torch.float32
    close(got, ref)


@pytest.mark.parametrize("rows", [1, 8, 40])
def test_quantized_linear_dispatch_matches(rng, rows):
    """`linear` and the tied head on q4 dicts with a bias: the kernel's
    plain version up to 32 rows, the dequantised product above, against
    the JAX package's dispatch (its dequantised product on the CPU)."""
    w = (rng.standard_normal((96, 128)) * 0.05).astype(np.float32)
    q = {**jquant.quantize_array(w, 4), "bias": rng.standard_normal(96).astype(np.float32)}
    jq = {k: jnp.asarray(v) for k, v in q.items()}
    tq = to_torch(q)
    x = rng.standard_normal((rows, 128)).astype(np.float32)
    close(tlayers.linear(tq, torch.from_numpy(x)), jquant.quantized_linear(jq, jnp.asarray(x)))
    head = {k: v for k, v in tq.items() if k != "bias"}
    jhead = {k: v for k, v in jq.items() if k != "bias"}
    close(tlayers.embedding_as_linear(head, torch.from_numpy(x)),
          jquant.quantized_linear(jhead, jnp.asarray(x)))


def _tree(rng):
    """A stacked two-layer LLM-like tree with q/k/v, gate/up, norms, an
    embedding and a 3-D conv-like leaf that quantize_tree must skip by name."""
    def w(*s):
        return (rng.standard_normal(s) * 0.05).astype(np.float32)
    return {"layers": {"attn": {"q": {"weight": w(2, 128, 128)},
                                "k": {"weight": w(2, 64, 128)},
                                "v": {"weight": w(2, 64, 128), "bias": w(2, 64)},
                                "o": {"weight": w(2, 128, 128)},
                                "q_norm": {"weight": np.ones((2, 64), np.float32)}},
                       "mlp": {"gate": {"weight": w(2, 256, 128)},
                               "up": {"weight": w(2, 256, 128)},
                               "down": {"weight": w(2, 128, 256)}},
                       "ln1": {"weight": np.ones((2, 128), np.float32)}},
            "conv1": {"weight": w(3, 128, 64)},
            "embed": {"weight": w(300, 128)}}


def _assert_trees_equal(got: dict, ref: dict):
    flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    ref_flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat) == len(ref_flat)
    for path, leaf in ref_flat:
        leaf = np.asarray(leaf)
        if path[0].key.startswith("conv"):
            leaf = leaf.transpose(2, 1, 0)  # conv kernels are transposed by design
        if leaf.dtype == np.uint32:
            leaf = leaf.view(np.int32)
        np.testing.assert_array_equal(flat[path].numpy(), leaf, err_msg=str(path))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_tree_matches_exactly(rng, bits):
    tree = _tree(rng)
    ref = jquant.quantize_tree(jax.tree.map(jnp.asarray, tree), bits=bits)
    got = tquant.quantize_tree(to_torch(tree), bits=bits)
    assert f"weight_q{bits}" in got["layers"]["attn"]["q"]
    assert "weight" in got["layers"]["ln1"] and "weight" in got["conv1"]
    _assert_trees_equal(got, ref)


@pytest.mark.parametrize("bits", [4, 8])
def test_requantize_tree_int8_and_fuse_match_exactly(rng, bits):
    """The JAX serving recipe on a q4/q8 tree: per-channel int8 of the
    dequantised weight, q/k/v and gate/up fused."""
    jq = jquant.quantize_tree(jax.tree.map(jnp.asarray, _tree(rng)), bits=bits)
    tq = to_torch(jq)
    ref = jquant.requantize_tree_int8(jq)
    got = tquant.requantize_tree_int8(tq)
    assert set(got["layers"]["attn"]) == {"qkv", "o", "q_norm"}
    assert set(got["layers"]["mlp"]) == {"gateup", "down"}
    assert "bias" not in got["layers"]["attn"]["qkv"]  # only v had one
    _assert_trees_equal(got, ref)
    unfused = tquant.requantize_tree_int8(tq, fuse=False)
    _assert_trees_equal(unfused, jquant.requantize_tree_int8(jq, fuse=False))
    _assert_trees_equal(tquant.fuse_int8_tree(unfused), ref)


def test_wrapper_launches_nothing_on_cpu_and_refuses_other_devices(rng):
    q = to_torch(jquant.quantize_array(rng.standard_normal((64, 128)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32))
    before = dict(qmm.LAUNCHES)
    qmm.quant_matmul(x, q["weight_q4"], q["scales"], q["biases"])
    assert qmm.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        qmm.quant_matmul(x.to("meta"), q["weight_q4"], q["scales"], q["biases"])
