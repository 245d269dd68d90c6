"""PyTorch port, the W4A8 serving formats against the JAX package on the
CPU: `pack_w4a8` and `requantize_w4a8_sg` byte for byte, the dequantisers
and the row lookup, the plain versions of the four W4A8 kernels against
the Pallas kernels in interpret mode, the tree repacks and fusions, the
linears' routing at ≤ 32 and > 32 rows, and the conversion of W4A8 trees;
the CUDA kernel's planes, k order and order of summation
(`tools/w4a8_order.py`) against the plain versions, and
`tools/w4a8_split.py`'s cuts.

The JAX W4A8 gates are off away from the TPU, and the JAX CPU path takes
the dequantised product without the int8 activation rounding: the
`jax_w4a8` fixture turns the kernels on in interpret mode, so the port's
plain versions are held against the Pallas kernels and not against another
plain product. Codes and scales must be equal; products are held at 1e-5
of max|ref| (f32: the integer dots are exact on both sides, only the f32
epilogue rounds in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.nn import transformer as jt
from tpu_audio.ops import quant as jquant
from tpu_audio.ops.pallas import w4a8_matmul as jw4
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.nn import layers as tlayers
from tpu_audio_torch.ops import quant as tquant
from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm
from tpu_audio_torch.tools import w4a8_order, w4a8_split
from tpu_audio_torch.utils import pytree
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

ENTRIES = ("w4a8_matmul", "w4a8_matmul_stacked", "w4a8_sg_matmul", "w4a8_sg_matmul_stacked")


@pytest.fixture
def jax_w4a8(monkeypatch):
    """Run the JAX package's four W4A8 Pallas kernels in interpret mode,
    with their TPU gates on."""
    for name in ENTRIES:
        monkeypatch.setattr(jw4, name, functools.partial(getattr(jw4, name), interpret=True))
    for gate in ("supported", "supported_stacked", "sg_supported"):
        monkeypatch.setattr(jw4, gate, lambda *a, **k: True)


def close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, err


def q4_leaf(rng, *shape):
    """A group-affine q4 dict of a (…, O, I) weight, by the JAX quantize_array."""
    return jquant.quantize_array((rng.standard_normal(shape) * 0.05).astype(np.float32), 4)


def to_torch(tree, dtype=torch.float32):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu", dtype=dtype)


def test_pack_and_requantize_are_byte_equal(rng):
    q = rng.integers(0, 16, (40, 512))
    q[0, :8] = [0, 7, 8, 15, 15, 8, 7, 0]
    got = w4mm.pack_w4a8(torch.from_numpy(q))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), jw4.pack_w4a8(q))
    leaf = q4_leaf(rng, 40, 512)
    codes = np.asarray(jquant.unpack_uint32(jnp.asarray(leaf["weight_q4"]), 4))
    wp, s = w4mm.requantize_w4a8_sg(torch.from_numpy(leaf["scales"]),
                                     torch.from_numpy(leaf["biases"]), torch.from_numpy(codes))
    jwp, js = jw4.requantize_w4a8_sg(leaf["scales"], leaf["biases"], codes)
    np.testing.assert_array_equal(wp.numpy(), jwp)
    np.testing.assert_array_equal(s.numpy(), js)
    xq = torch.from_numpy(rng.integers(-127, 128, (3, 256)).astype(np.int8))
    for g, r in zip(w4mm.split_activations(xq), jw4.split_activations(jnp.asarray(xq.numpy()))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_dequantizers_and_row_lookup_match(rng):
    jp = jquant.repack_w4a8(q4_leaf(rng, 2, 48, 256))
    tp = to_torch(jp)
    assert tp["weight_q4p"].dtype == torch.int8
    close(tquant.dequantize(tp), jquant.dequantize(jp), rel=1e-6)
    ids = np.array([[3, 0, 47], [5, 5, 1]])
    flat_j = {k: v[1] for k, v in jp.items()}
    flat_t = {k: v[1] for k, v in tp.items()}
    close(tquant.dequantize_rows(flat_t, torch.from_numpy(ids)),
          jquant.dequantize_rows(flat_j, jnp.asarray(ids)), rel=1e-6)
    js = jquant.requantize_w4a8_sg(q4_leaf(rng, 48, 512))
    ts = to_torch(js)
    assert ts["weight_q4s"].dtype == torch.int8 and ts["scales_sg"].dtype == torch.float32
    close(tquant.dequantize(ts), jquant.dequantize(js), rel=1e-6)


def test_super_group_row_lookup_raises_naming_c5(rng):
    ts = tquant.requantize_w4a8_sg(to_torch(q4_leaf(rng, 16, 256)))
    with pytest.raises(ValueError, match="C5"):
        tquant.dequantize_rows(ts, torch.tensor([0, 3]))


def _case(rng, entry: str, rows: int, i: int, o: int):
    """Inputs of one entry (stacked ones: 2 layers, layer 1 read) as
    (JAX args, port args)."""
    stacked, sg = entry.endswith("stacked"), "_sg_" in entry
    lead = (2,) if stacked else ()
    leaf = q4_leaf(rng, *lead, o, i)
    jp = jquant.requantize_w4a8_sg(leaf) if sg else jquant.repack_w4a8(leaf)
    tp = to_torch(jp)
    x = (rng.standard_normal((rows, i)) * 2).astype(np.float32)
    x[:, :64] += 3.0  # groups of large mean: the affine and −8 terms matter
    keys = ("weight_q4s", "scales_sg") if sg else ("weight_q4p", "scales", "biases")
    jargs = [jnp.asarray(x), jnp.asarray(jp[keys[0]])]
    targs = [torch.from_numpy(x), tp[keys[0]]]
    for k in keys[1:]:
        jargs.append(jnp.asarray(jp[k][1] if stacked else jp[k]))
        targs.append(tp[k][1] if stacked else tp[k])
    if stacked:
        jargs.append(jnp.int32(1))
        targs.append(1)
    return jargs, targs


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("rows,i", [(1, 1024), (3, 1536), (8, 1024), (32, 1536)])
def test_plain_matches_pallas(rng, jax_w4a8, entry, rows, i):
    """Each entry's plain version against the JAX kernel in interpret mode;
    the unstacked ones at O 512 and 640, the stacked ones on layer 1 of 2."""
    for o in ((512,) if entry.endswith("stacked") else (512, 640)):
        jargs, targs = _case(rng, entry, rows, i, o)
        ref = getattr(jw4, entry)(*jargs)
        got = getattr(w4mm, entry)(*targs)
        assert got.dtype == torch.float32
        close(got, ref)
        # and not the dequantised product: the int8 rounding of x shows
        if entry == "w4a8_matmul":
            w = w4mm.dequantize_w4a8(targs[1], targs[2], targs[3])
            exact = targs[0] @ w.T
            assert (got - exact).abs().max() > 1e-4 * exact.abs().max()


def test_tree_repacks_and_fusions_match(rng):
    cfg = jt.TransformerConfig(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=512,
                               vocab_size=200, tie_word_embeddings=True)
    jq = jquant.quantize_tree(jt.init_params(jax.random.PRNGKey(3), cfg), bits=4)
    tq = to_torch(jq)
    for jfn, tfn, key in ((jquant.repack_tree_w4a8, tquant.repack_tree_w4a8, "weight_q4p"),
                          (jquant.requantize_tree_w4a8_sg, tquant.requantize_tree_w4a8_sg,
                           "weight_q4s")):
        jr, tr = jfn(jq), tfn(tq)
        assert key in tr["layers"]["attn"]["qkv"] and key in tr["layers"]["mlp"]["gateup"]
        assert set(tr["layers"]["attn"]) == {"qkv", "o"}
        jflat = {"/".join(str(p.key) for p in path): np.asarray(v)
                 for path, v in jax.tree_util.tree_flatten_with_path(jr)[0]}
        tflat = pytree.flatten(tr)
        assert set(jflat) == {k.replace(".", "/") for k in tflat}
        for k, v in tflat.items():
            np.testing.assert_array_equal(v.numpy(), jflat[k.replace(".", "/")])


@pytest.mark.parametrize("sg", [False, True])
@pytest.mark.parametrize("rows", [1, 5, 32, 40])
def test_linears_route_as_the_jax_package(rng, jax_w4a8, sg, rows):
    """w4a8_linear / w4a8_sg_linear against the JAX ones: the kernel at
    ≤ 32 rows, the dequantised product above (a stacked leaf as the layer
    hands it over, with a bias), in x's dtype."""
    leaf = q4_leaf(rng, 2, 384, 512)
    jp = jquant.requantize_w4a8_sg(leaf) if sg else jquant.repack_w4a8(leaf)
    jp["bias"] = jnp.asarray(rng.standard_normal((2, 384)).astype(np.float32))
    tp = to_torch(jp)
    key = "weight_q4s" if sg else "weight_q4p"
    jl = {k + "_stacked" if k == key else k: v if k == key else v[1] for k, v in jp.items()}
    tl = {k + "_stacked" if k == key else k: v if k == key else v[1] for k, v in tp.items()}
    jl["layer_idx"], tl["layer_idx"] = jnp.int32(1), 1
    x = rng.standard_normal((1, rows, 512)).astype(np.float32)
    ref = jquant.quantized_linear(jl, jnp.asarray(x))
    got = tlayers.linear(tl, torch.from_numpy(x))
    close(got, ref)
    flat_t = {k: (v[1] if k != "layer_idx" else v) for k, v in tp.items()}
    close(tlayers.linear(flat_t, torch.from_numpy(x)), ref)


def test_params_from_numpy_keeps_codes_int8_and_scales_f32(rng):
    jp = {"a": jquant.repack_w4a8(q4_leaf(rng, 64, 128)),
          "b": jquant.requantize_w4a8_sg(q4_leaf(rng, 64, 256))}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.bfloat16)
    assert tp["a"]["weight_q4p"].dtype == torch.int8
    assert tp["a"]["scales"].dtype == tp["a"]["biases"].dtype == torch.float32
    assert tp["b"]["weight_q4s"].dtype == torch.int8
    assert tp["b"]["scales_sg"].dtype == torch.float32
    np.testing.assert_array_equal(tp["a"]["weight_q4p"].numpy(), np.asarray(jp["a"]["weight_q4p"]))
    np.testing.assert_array_equal(tp["b"]["scales_sg"].numpy(), np.asarray(jp["b"]["scales_sg"]))


def test_wrappers_launch_nothing_on_cpu_and_refuse_other_devices(rng):
    x = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32))
    tp = tquant.repack_w4a8(to_torch(q4_leaf(rng, 64, 256)))
    before = dict(w4mm.LAUNCHES)
    w4mm.w4a8_matmul(x, tp["weight_q4p"], tp["scales"], tp["biases"])
    assert w4mm.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        w4mm._launch("w4a8_matmul", x, tp["weight_q4p"][None], tp["scales"], tp["biases"], 0)


def test_mma_k_order_gives_each_lane_its_16_bytes():
    """The 64 k-slots of the kernel's two m16n8k32 steps take each byte of
    a 64-byte span once, lane t's slots (4t.., 16 + 4t.. of each step) its
    own 16 contiguous bytes."""
    order = w4a8_order.mma_k_order()
    assert sorted(order.tolist()) == list(range(64))
    for t in range(4):
        slots = [32 * step + 16 * half + 4 * t + i for step in (0, 1) for half in (0, 1)
                 for i in range(4)]
        assert sorted(order[slots].tolist()) == list(range(16 * t, 16 * t + 16))


@pytest.mark.parametrize("sg", [False, True])
@pytest.mark.parametrize("rows,i,o", [(1, 1024, 512), (5, 1536, 208), (8, 1024, 130),
                                      (32, 1536, 96)])
def test_kernel_order_matches_plain(rng, sg, rows, i, o):
    """The kernel's arithmetic modelled on the CPU: its planes (masks, no −8
    fold) give the plain version's integer dots exactly, per 64-column
    group (pair) or 256-column super-group, and its order of summation (8
    warps over interleaved pairs, scales per pair in f32, the warps' shares
    added in order) stays within 1e-5 of max|plain|, at any O."""
    leaf = q4_leaf(rng, o, i)
    jp = jquant.requantize_w4a8_sg(leaf) if sg else jquant.repack_w4a8(leaf)
    tp = to_torch(jp)
    wp = tp["weight_q4s" if sg else "weight_q4p"]
    x = torch.from_numpy((rng.standard_normal((rows, i)) * 2).astype(np.float32))
    x[:, :64] += 3.0
    xq, sx = w4mm.quantize_rows(x)
    x_lo, x_hi = w4mm.split_activations(xq)
    d_lo, d_hi = w4a8_order.mma_dots(xq, wp, sg)
    if sg:  # the plain version's exact super-group dot: low plane less its +8, high / 16
        ref = (w4mm._plane_dots(x_lo, wp & 15, w4mm.PAIR)
               - 8 * x_lo.float().reshape(rows, -1, w4mm.PAIR).sum(-1)[..., None]
               + w4mm._plane_dots(x_hi, wp & -16, w4mm.PAIR) / 16)
        got = ((d_lo + d_hi) / 16).reshape(rows, -1, 2, o).sum(2)
        assert torch.equal(got, ref.double())
        plain = w4mm.w4a8_sg_matmul_plain(x, wp, tp["scales_sg"])
        parts = w4a8_order.mma_partials(xq, sx, None, wp, tp["scales_sg"])
    else:  # the plain version's high plane: 16 (h − 8), less its −8 correction
        assert torch.equal(d_lo, w4mm._plane_dots(x_lo, wp & 15, w4mm.GROUP).double())
        ref_hi = (w4mm._plane_dots(x_hi, wp & -16, w4mm.GROUP) / 16
                  + 8 * x_hi.float().reshape(rows, -1, w4mm.GROUP).sum(-1)[..., None])
        assert torch.equal(d_hi, ref_hi.double())
        plain = w4mm.w4a8_matmul_plain(x, wp, tp["scales"], tp["biases"])
        xsum = x.reshape(rows, -1, w4mm.GROUP).sum(-1)
        parts = w4a8_order.mma_partials(xq, sx, xsum, wp, tp["scales"], tp["biases"])
    assert parts.shape == (rows, w4a8_order.WARPS, o)
    y = parts[:, 0]
    for w in range(1, w4a8_order.WARPS):
        y = y + parts[:, w]
    close(y, plain)
    # and a dropped warp's share does not pass
    assert (y - parts[:, 3] - plain).abs().max() > 1e-5 * plain.abs().max()


def test_w4a8_split_cuts_apply_to_the_sources():
    """tools/w4a8_split.py recognises the repository's sources, and each of
    its cuts changes them (its marks all match, or it would refuse)."""
    sources = w4a8_split.read_sources(w4a8_split.CSRC)
    name = w4a8_split.layout(sources)
    versions = w4a8_split.variants(sources)
    assert list(versions) == ["kernel", *w4a8_split.LAYOUTS[name]["cuts"], "all cut"]
    assert versions["kernel"] == sources
    for variant, files in versions.items():
        changed = {f for f in files if files[f] != sources[f]}
        assert changed == (set() if variant == "kernel" else {w4a8_split.SRC}), variant
