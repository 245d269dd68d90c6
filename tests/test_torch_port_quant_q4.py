"""PyTorch port, the group-affine q4/q8 format (MLX checkpoints) against
the JAX package on the CPU: packing, `quantize_array` / `quantize_tree`,
`dequantize` / `dequantize_rows`, the plain `quant_matmul` against the
Pallas kernel in interpret mode, the `quantized_linear` dispatch, and the
conversion to the int8 serving format (`requantize_tree_int8`,
`fuse_int8_tree`).

Codes, scales and biases must equal the JAX package's exactly (the same
f32 arithmetic). Products are held at 1e-5 of max|ref|: both sides sum the
same f32 terms in another order.

Also the CUDA kernel's host-side rules on the CPU: its map of blocks to
spans of 16-channel tiles and column slices covers each (channel, column)
once at the shapes of `tools/quant_split.py` (the rows do not change it),
whose cuts apply to the repository's sources and to those of the previous
design (its `quant_matmul.cu` kept under `tests/data/`), as the stamps of
`tools/quant_timeline.py` apply to the repository's.
"""

from pathlib import Path

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
from tpu_audio_torch.tools import quant_split, quant_timeline
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

PARENT = Path(__file__).resolve().parent / "data" / "quant_matmul_parent"


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
@pytest.mark.parametrize("b,i,o", [(1, 256, 300), (5, 128, 1000), (16, 320, 130),
                                   (32, 192, 77)])
def test_quant_matmul_plain_matches_pallas(rng, interpret_pallas, bits, b, i, o):
    """Any O (the TPU kernel pads a ragged O to its block), 1 to 32 rows
    (16: Whisper's batch-16 q4 decode)."""
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


def test_leaf_made_under_inference_mode_runs_on_cpu(rng):
    """A q4 leaf quantised under `torch.inference_mode()` (inference
    tensors carry no version counter) goes through `linear` on the CPU, in
    and out of that mode, equal to the plain product bit for bit."""
    w = torch.from_numpy((rng.standard_normal((96, 128)) * 0.05).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    with torch.inference_mode():
        q = tquant.quantize_tree({"w": {"weight": w}}, bits=4)["w"]
        assert q["weight_q4"].is_inference()
        inside = tlayers.linear(q, x)
    ref = qmm.quant_matmul_plain(x, q["weight_q4"], q["scales"], q["biases"])
    assert torch.equal(inside, ref)
    assert torch.equal(tlayers.linear(q, x), ref)


@pytest.mark.parametrize("bits", [4, 8])
def test_bf16_rows_equal_their_f32_widening(rng, bits):
    """The wrapper reads bf16 x as it is and widens it exactly: the same
    product as on x.float(), bit for bit (the plain path; the kernel's
    terms of a bf16 x are x itself)."""
    q = to_torch(jquant.quantize_array((rng.standard_normal((96, 192)) * 0.05)
                                       .astype(np.float32), bits))
    x = torch.from_numpy(rng.standard_normal((16, 192)).astype(np.float32)).to(torch.bfloat16)
    args = (q[f"weight_q{bits}"], q["scales"], q["biases"])
    got = qmm.quant_matmul(x, *args, bits=bits)
    assert got.dtype == torch.float32
    assert torch.equal(got, qmm.quant_matmul(x.float(), *args, bits=bits))


@pytest.mark.parametrize("rows", [1, 16, 32])
@pytest.mark.parametrize("label", list(quant_split.SHAPES))
def test_block_map_covers_each_channel_and_column_once(label, rows):
    """Every (channel, group of 64 columns) of the split tool's shapes in
    exactly one block's (span, slice), for each span width (1, 2, 4, 8
    tiles) and slice count (1, 2, 4, 8) the launch can take, and grids of
    whole clusters up to the span count, on an H100 SXM (132 SMs) and a
    PCIe card (114)."""
    o, i = quant_split.SHAPES[label]
    groups, tiles = i // qmm.GROUP, -(-o // qmm.TILE)
    for slices in (1, 2, 4, 8):
        cols = [qmm.slice_groups(groups, slices, s) for s in range(slices)]
        assert sorted(g for r in cols for g in r) == list(range(groups))
        assert all(len(r) > 0 for r in cols)
    for tps, slices in [(8, 1), (4, 1), (2, 1), (1, 1), (1, 2), (1, 4), (1, 8)]:
        spans = -(-tiles // tps)
        chans = [qmm.span_channels(sp, tps, o) for sp in range(spans)]
        assert sorted(c for r in chans for c in r) == list(range(o))
        for clusters in {1, 7, 114 // slices, 132 * 2 // slices, 132 // slices, spans}:
            clusters = min(clusters, spans)
            grid = clusters * slices
            seen = np.zeros((spans, slices), np.int64)
            for block in range(grid):
                for span, s in qmm.block_work(block, grid, slices, spans):
                    seen[span, s] += 1
            assert (seen == 1).all(), (tps, slices, grid)
            # a cluster's blocks walk the same spans
            for block in range(0, grid, slices):
                walks = {tuple(sp for sp, _ in qmm.block_work(block + r, grid, slices, spans))
                         for r in range(slices)}
                assert len(walks) == 1


@pytest.mark.parametrize("csrc", [quant_split.CSRC, PARENT], ids=["repository", "parent"])
def test_quant_split_cuts_apply_to_the_sources(csrc):
    """tools/quant_split.py recognises both versions' sources, and each of
    its cuts changes them (its marks all match, or it would refuse)."""
    sources = quant_split.read_sources(csrc)
    name = quant_split.layout(sources)
    versions = quant_split.variants(sources)
    assert list(versions) == ["kernel", *quant_split.LAYOUTS[name]["cuts"], "all cut"]
    assert versions["kernel"] == sources
    for variant, files in versions.items():
        changed = {f for f in files if files[f] != sources[f]}
        assert changed == (set() if variant == "kernel" else {quant_split.SRC}), variant
    assert len(set(quant_split.LAYOUTS) - {name}) == 1


def test_quant_timeline_stamps_apply_to_the_sources():
    """tools/quant_timeline.py finds each of its marks once in the
    repository's kernel and writes every stamp in."""
    text = quant_timeline.SRC.read_text()
    got = quant_timeline.stamped(text)
    assert all(f"stamp({k});" in got for k in range(quant_timeline.STAMPS))
    assert "tpa_quant_stamps" in got and got.startswith(text[:100])
