"""PyTorch port, the W8A8 weight-streaming matmul (`int8_matmul`,
`int8_matmul_stacked`) on the CPU: the plain version of its output in x's
dtype plus a bias against the JAX kernel in interpret mode, bit for bit;
`int8_linear`'s output on a bf16 tree as it was before the cast and the
bias moved into the kernel; the CUDA kernel's host-side rules: its map of
blocks (cluster ranks) to 16-channel tiles and column slices, `plan`'s
choice of slices at the shapes of `tools/int8_split.py`, the row maximum
merged over the slices; and that tool's cuts on the repository's source
and on the previous design's (its `int8_matmul.cu` kept under
`tests/data/`).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.ops.pallas import int8_matmul as ji8
from tpu_audio_torch.ops import quant as tquant
from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
from tpu_audio_torch.tools import int8_split
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

PARENT = Path(__file__).resolve().parent / "data" / "int8_matmul_parent"
H100_SMS = (132, 114)  # SXM, PCIe


@pytest.fixture
def rng():
    return np.random.default_rng(16)


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def jax_bf16_bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("rows", [1, 5, 16, 32])
def test_bf16_output_with_bias_matches_jax_bit_for_bit(rng, rows):
    """The plain version's x-dtype output: the f32 product cast once to
    bf16, then the bias cast to bf16 added with one rounding, as the JAX
    `int8_linear` does after `int8_matmul_stacked(..., interpret=True)`.
    The reference is that function's body run op by op: under `jax.jit`
    the CPU divides 32 rows' maxima by 127 otherwise than IEEE division
    (asserted below), while the port, like the TPU, rounds the quotient
    once."""
    lyr, i, o, layer = 3, 256, 384, 2
    x = rng.standard_normal((rows, i)).astype(np.float32)
    w = rng.integers(-127, 128, (lyr, o, i)).astype(np.int8)
    s = rng.uniform(0.001, 0.02, (lyr, o, 1)).astype(np.float32)
    bias = (rng.standard_normal(o) * 0.5).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    args = (xj, jnp.asarray(w), jnp.asarray(s[layer]), jnp.int32(layer))
    ref_f32 = ji8.int8_matmul_stacked.__wrapped__(*args, interpret=True)
    ref = ref_f32.astype(jnp.bfloat16) + jnp.asarray(bias).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt, st, bt = torch.from_numpy(w), torch.from_numpy(s[layer]), torch.from_numpy(bias)
    got = i8mm.int8_matmul_stacked(xt, wt, st, layer, bt.to(torch.bfloat16),
                                   out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16_bits(got), jax_bf16_bits(ref))
    # the f32 output, in the kernel's epilogue order, equals JAX's too
    f32 = i8mm.int8_matmul_stacked(xt, wt, st, layer)
    np.testing.assert_array_equal(f32.numpy(), np.asarray(ref_f32))
    jitted = np.asarray(ji8.int8_matmul_stacked(*args, interpret=True))
    ieee = np.array_equal(np.asarray(jax.jit(ji8.quantize_rows)(xj)[1]),
                          np.asarray(ji8.quantize_rows(xj)[1]))
    assert np.array_equal(jitted, f32.numpy()) == ieee
    assert ieee or rows == 32
    # a bias added before the cast rounds once less, and differs somewhere
    fused = (f32 + bt.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert not np.array_equal(bf16_bits(fused), bf16_bits(got))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stacked", [False, True])
def test_int8_linear_on_the_cpu_gives_what_it_gave_before(rng, dtype, stacked):
    """`int8_linear` with a bias: the cast and the bias, now inside the
    kernel's call, give on the CPU exactly the f32 product cast to x's
    dtype plus the bias cast to it, as two steps after the call did."""
    o, i = 96, 128
    w = (rng.standard_normal((2, o, i)) * 0.05).astype(np.float32)
    q = [tquant.quantize_array_int8(torch.from_numpy(w[k])) for k in range(2)]
    bias = torch.from_numpy(rng.standard_normal(o).astype(np.float32)).to(dtype)
    x = torch.from_numpy(rng.standard_normal((2, 3, i)).astype(np.float32)).to(dtype)
    if stacked:
        p = {"weight_i8_stacked": torch.stack([v["weight_i8"] for v in q]), "layer_idx": 1,
             "scale_i8": q[1]["scale_i8"], "bias": bias}
    else:
        p = {**q[1], "bias": bias}
    before = (i8mm.int8_matmul_plain(x.reshape(6, i), q[1]["weight_i8"], q[1]["scale_i8"])
              .to(dtype).reshape(2, 3, o) + bias.to(dtype))
    got = tquant.int8_linear(p, x)
    assert got.dtype == dtype and got.shape == (2, 3, o)
    assert torch.equal(got, before)
    no_bias = tquant.int8_linear({k: v for k, v in p.items() if k != "bias"}, x)
    assert torch.equal(no_bias, i8mm.int8_matmul_plain(
        x.reshape(6, i), q[1]["weight_i8"], q[1]["scale_i8"]).to(dtype).reshape(2, 3, o))


def test_plain_writes_into_a_given_output(rng):
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (48, 64)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.001, 0.02, (48, 1)).astype(np.float32))
    guard = torch.full((6, 48), 7.0)
    got = i8mm.int8_matmul(x, w, s, out=guard[:4])
    assert got.data_ptr() == guard.data_ptr()
    assert torch.equal(guard[:4], i8mm.int8_matmul_plain(x, w, s))
    assert (guard[4:] == 7.0).all()


@pytest.mark.parametrize("label", list(int8_split.SHAPES))
def test_block_map_covers_each_channel_and_column_once(label):
    """Every (channel, column) of the split tool's shapes in exactly one
    block's (tile, slice), for each slice count the launch can take, and
    grids of whole clusters up to the tile count; a cluster's blocks walk
    the same tiles."""
    o, i, _ = int8_split.SHAPES[label]
    tiles = -(-o // i8mm.TILE)
    chans = [i8mm.tile_channels(t, o) for t in range(tiles)]
    assert sorted(c for r in chans for c in r) == list(range(o))
    assert all(len(r) == i8mm.TILE for r in chans[:-1])
    for slices in i8mm.SLICES:
        cols = [i8mm.slice_columns(i, slices, r) for r in range(slices)]
        assert sorted(c for r in cols for c in r) == list(range(i))
        assert all(len(r) > 0 and r.start % i8mm.CHUNK == 0 for r in cols)
        for clusters in {1, 7, 114 // slices, 132 * 2 // slices, 132 // slices, tiles}:
            clusters = min(clusters, tiles)
            grid = clusters * slices
            seen = np.zeros((tiles, slices), np.int64)
            for block in range(grid):
                for tile, s in i8mm.block_work(block, grid, slices, tiles):
                    seen[tile, s] += 1
            assert (seen == 1).all(), (slices, grid)
            for block in range(0, grid, slices):
                walks = {tuple(t for t, _ in i8mm.block_work(block + r, grid, slices, tiles))
                         for r in range(slices)}
                assert len(walks) == 1


@pytest.mark.parametrize("n_sm", H100_SMS)
@pytest.mark.parametrize("label", list(int8_split.SHAPES))
def test_plan_bounds_the_codes_a_block_makes(label, n_sm):
    """`plan` at the split tool's shapes: the heads in one slice; a layer
    shape in the fewest slices at which a block codes at most QUANT_VALUES
    values of x and its codes and a stage fit, or in 8."""
    o, i, _ = int8_split.SHAPES[label]
    for rows in int8_split.ROWS:
        slices = i8mm.plan(rows, i, o, n_sm)
        assert slices in i8mm.SLICES and len(i8mm.slice_columns(i, slices, slices - 1)) > 0
        if "head" in label:
            assert slices == 1 and -(-o // i8mm.TILE) >= i8mm.HEAD_TILES * n_sm
            continue

        def fits(c):
            width = max(len(i8mm.slice_columns(i, c, r)) for r in range(c))
            return rows * width <= i8mm.QUANT_VALUES and (rows + 16) * width <= i8mm.ROW_BYTES
        assert fits(slices) or slices == 8
        assert slices == 1 or not fits(slices // 2)


@pytest.mark.parametrize("slices", [2, 4, 8])
def test_row_max_merged_over_slices_equals_the_row_max(rng, slices):
    """Each rank's |max| over its slice, merged by max in any order, is the
    row's |max| and so gives the plain version's scale and codes; a slice
    dropped from the merge (the row's max in it) does not."""
    i = 1280
    x = torch.from_numpy(rng.standard_normal((16, i)).astype(np.float32)).to(torch.bfloat16)
    cols = [i8mm.slice_columns(i, slices, r) for r in range(slices)]
    last = cols[-1]
    x[:, last.start + 3] = 40.0  # every row's max in the last slice
    parts = torch.stack([x[:, r.start:r.stop].float().abs().amax(dim=1) for r in cols])
    for order in (list(range(slices)), list(range(slices))[::-1]):
        merged = torch.zeros(16)
        for r in order:
            merged = torch.maximum(merged, parts[r])
        scale = torch.clamp(i8mm.true_div(merged[:, None], 127.0), min=1e-10)
        xq, sx = i8mm.quantize_rows(x)
        assert torch.equal(scale, sx)
        assert torch.equal(torch.clamp(torch.round(x.float() / scale), -127, 127)
                           .to(torch.int8), xq)
    dropped = parts[:-1].amax(dim=0)
    assert not torch.equal(torch.clamp(i8mm.true_div(dropped[:, None], 127.0), min=1e-10),
                           i8mm.quantize_rows(x)[1])


def kernel_codes(x: np.ndarray, s: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The .cu's codes of x (B, I) f32 at row scales s (B, 1) f32: t = x ·
    RN(1/s), rint(t) unless t lies within 2^-15 of a half-integer, where
    rint(x / s) by IEEE division; and where that fallback was taken."""
    r = (np.float32(1) / s).astype(np.float32)
    t = (x * r).astype(np.float32)
    near = np.abs(t - np.rint(t)) > np.float32(0.5) - np.float32(2.0 ** -15)
    q = np.where(near, np.rint((x / s).astype(np.float32)), np.rint(t))
    return np.clip(q, -127, 127).astype(np.int8), near


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_quotient_rule_gives_the_plain_codes(rng, dtype):
    """The kernel codes x by a product with the row scale's reciprocal and
    takes the IEEE quotient only within 2^-15 of a half-integer: the codes
    of `quantize_rows` (round half to even of the IEEE quotient), bit for
    bit, on random rows, rows of a wide range, and values on, and one ulp
    beside, every half-integer step of the scale."""
    rows = [rng.standard_normal((64, 1024)), rng.standard_normal((64, 1024))
            * np.exp(rng.uniform(-30, 30, (64, 1)))]
    s0 = np.float32(0.0371)
    half = (np.arange(-127, 127) + 0.5).astype(np.float32) * s0
    ties = np.concatenate([half, np.nextafter(half, np.float32(np.inf)),
                           np.nextafter(half, np.float32(-np.inf)), [127 * s0]])
    rows.append(np.tile(ties, (4, 1)))
    taken = 0
    for x in rows:
        xt = torch.from_numpy(x.astype(np.float32)).to(dtype)
        xq, sx = i8mm.quantize_rows(xt)
        got, near = kernel_codes(xt.float().numpy(), sx.numpy())
        np.testing.assert_array_equal(got, xq.numpy())
        taken += int(near.sum())
    assert taken > 0  # the ties took the IEEE quotient


@pytest.mark.parametrize("csrc", [int8_split.CSRC, PARENT], ids=["repository", "parent"])
def test_int8_split_cuts_apply_to_the_sources(csrc):
    """tools/int8_split.py recognises both versions' sources, and each of
    its cuts changes them (its marks all match, or it would refuse)."""
    sources = int8_split.read_sources(csrc)
    name = int8_split.layout(sources)
    versions = int8_split.variants(sources)
    assert list(versions) == ["kernel", *int8_split.LAYOUTS[name]["cuts"], "all cut"]
    assert versions["kernel"] == sources
    for variant, files in versions.items():
        changed = {f for f in files if files[f] != sources[f]}
        assert changed == (set() if variant == "kernel" else {int8_split.SRC}), variant
    assert len(set(int8_split.LAYOUTS) - {name}) == 1
    assert (name.startswith("one launch")) == (csrc == int8_split.CSRC)


def test_wrappers_launch_nothing_on_cpu_and_refuse_other_devices(rng):
    x = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (2, 32, 64)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.001, 0.02, (32, 1)).astype(np.float32))
    before = dict(i8mm.LAUNCHES)
    i8mm.int8_matmul(x, w[0], s, torch.zeros(32), out_dtype=torch.bfloat16)
    i8mm.int8_matmul_stacked(x, w, s, 1, torch.zeros(32, dtype=torch.bfloat16))
    assert i8mm.LAUNCHES == before
    with pytest.raises(ValueError):
        i8mm.int8_matmul(x.to("meta"), w[0], s)
    with pytest.raises(ValueError):
        i8mm.int8_matmul_stacked(x.to("meta"), w, s, 1, out_dtype=torch.bfloat16)
