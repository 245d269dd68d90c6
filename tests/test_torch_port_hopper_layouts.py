"""PyTorch port, the Python side of the TMA + wgmma kernels of
`tpu_audio_torch/csrc/` (`ln_qkv.cu`, `encoder_attention.cu`,
`fused_encoder.cu`, `fused_encoder_int8.cu`) on the CPU:

- `encoder_attention.tma_view`, the tensor-map description of each
  attention layout, read the way the TMA unit reads it ((64, 1, 128, 1)
  boxes of q, (64, 1, 64, 1) of k and v, zeros past each dimension's end):
  every head's rows and nothing else, at T = 1500 and T = 700 (neither a
  multiple of 128), and no row of the next batch; the same description
  through `torch.as_strided`;
- `ln_rows_plain`, `ln_qkv`'s LayerNorm pass, against the JAX kernel's
  `_ln_f32` at f32;
- `quant_rows_plain`, `fc1_gelu_int8`'s row-quantisation pass, against the
  JAX kernels' `_quant_rows` bit for bit (an all-zero row, exact ties);
- `ln_quant_rows_plain`, `ln_qkv_int8`'s first pass, against the JAX
  `_ln_f32` + `_quant_rows`: the codes bit for bit, the scales within an
  f32 ulp or two (the two frameworks sum a row in another order);
- `pair_codes_plain`, `attn_oproj_ln_int8`'s first pass, against the JAX
  `_quant_rows` of each head pair of the same attention output, bit for
  bit, keys past t_valid masked; `oproj_ln_int8_plain`, its second pass,
  against the TPU kernel's accumulation written in JAX: y bit for bit, h
  to the last bits of the LayerNorm;
- `attn_heads_plain` and `oproj_ln_plain`, the passes of the bf16
  `attn_oproj_ln`: composed, its plain version bit for bit (and so are the
  CPU wrappers); the second against the TPU kernel's f32 accumulation
  written in JAX;
- `fc1_split` and `oproj_split`, the cluster splits of FF and of D, take
  every Whisper width, for both o-projections;
- the wrappers refuse the shapes they refuse without launching anything,
  and launch what they accept with the scratch of their two passes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.ops.pallas import fused_encoder as jfe
from tpu_audio_torch.models.whisper.config import PRESETS
from tpu_audio_torch.ops.kernels import _build
from tpu_audio_torch.ops.kernels import encoder_attention as ea
from tpu_audio_torch.ops.kernels import fused_encoder as fe
from tpu_audio_torch.ops.kernels import fused_encoder_int8 as fe8
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

B, H, HD = 2, 4, 64


def layout(x: np.ndarray, kind: str) -> np.ndarray:
    """Head-major (B, H, T, hd) → the layout `kind`, contiguous."""
    b, h, t, hd = x.shape
    if kind == "bthd":
        return np.ascontiguousarray(x.transpose(0, 2, 1, 3))
    if kind == "pre_bh":
        return x.reshape(b * h, t, hd)
    return np.ascontiguousarray(
        x.reshape(b, h // 2, 2, t, hd).transpose(0, 1, 3, 2, 4).reshape(b * h // 2, t, 2 * hd))


def tma_box(flat: np.ndarray, dims, strides, coords, box):
    """What a TMA tile load of `box` elements at `coords` (innermost first)
    gives, and the element offsets it reads: elements past a dimension's
    end read as zero and touch no memory."""
    idx = np.meshgrid(*[c + np.arange(n) for c, n in zip(coords, box)], indexing="ij")
    inside = np.ones(idx[0].shape, bool)
    offset = np.zeros(idx[0].shape, np.int64)
    for i, d, s in zip(idx, dims, strides):
        inside &= i < d
        offset += i * s
    values = np.where(inside, flat[np.where(inside, offset, 0)], 0)
    return values, offset[inside]


@pytest.mark.parametrize("box_rows", [128, 64])  # the kernel's query and key tiles
@pytest.mark.parametrize("t", [1500, 700])
@pytest.mark.parametrize("kind", ["bthd", "pre_bh", "packed"])
def test_tma_view_reads_each_head_and_nothing_else(kind, t, box_rows):
    heads = np.arange(B * H * t * HD, dtype=np.float64).reshape(B, H, t, HD) + 1.0
    x = layout(heads, kind)
    flat = x.reshape(-1)
    dims, strides = ea.tma_view(kind, x.shape)
    _, inner, rows, outer = dims
    assert dims[0] == HD and rows == t and inner * outer == B * H
    reads = np.zeros(flat.size, np.int64)
    for n in range(B * H):
        hi, ho = n % inner, n // inner
        block = (ho * strides[3], (ho + 1) * strides[3])  # this batch or pair group
        b, h = divmod(n, H)
        for t0 in range(0, t, box_rows):
            box, offsets = tma_box(flat, dims, strides, (0, hi, t0, ho), (HD, 1, box_rows, 1))
            rows_in = min(box_rows, t - t0)
            np.testing.assert_array_equal(box[:, 0, :rows_in, 0].T, heads[b, h, t0:t0 + rows_in])
            assert not box[:, 0, rows_in:, 0].any()  # past T: zeros
            assert offsets.min() >= block[0] and offsets.max() < block[1]
            np.add.at(reads, offsets, 1)
    assert (reads == 1).all()  # every element read once, by its own head


@pytest.mark.parametrize("t", [1500, 700])
@pytest.mark.parametrize("kind", ["bthd", "pre_bh", "packed"])
def test_tma_view_as_strided_gathers_the_heads(kind, t):
    rng = np.random.default_rng(0)
    heads = torch.from_numpy(rng.standard_normal((B, H, t, HD)).astype(np.float32))
    x = torch.from_numpy(layout(heads.numpy(), kind))
    (hd, inner, rows, outer), (one, s_inner, ld, s_outer) = ea.tma_view(kind, x.shape)
    assert one == 1
    view = torch.as_strided(x, (outer, rows, inner, hd), (s_outer, ld, s_inner, 1))
    got = view.permute(0, 2, 1, 3).reshape(B, H, t, HD)
    torch.testing.assert_close(got, heads, rtol=0, atol=0)


@pytest.mark.parametrize("kind,shape", [("bthd", (16, 1500, 20, 64)),
                                        ("pre_bh", (320, 1500, 64)),
                                        ("packed", (160, 1500, 128))])
def test_tma_view_meets_the_tensor_map_rules(kind, shape):
    """cuTensorMapEncodeTiled takes byte strides that are nonzero multiples
    of 16 below 2^40, and a box of 128 bytes across at most under the
    128-byte swizzle; the wrapper's arguments are read from the same view."""
    dims, strides = ea.tma_view(kind, shape)
    assert dims[0] * 2 == 128
    for s in strides[1:]:
        assert s > 0 and (2 * s) % 16 == 0 and 2 * s < 2 ** 40
    assert int(np.prod(dims)) == int(np.prod(shape))


@pytest.mark.parametrize("d,offset", [(256, 0.0), (1280, 3.0)])
def test_ln_rows_plain_matches_jax_ln_f32(rng, d, offset):
    """ln_qkv's LayerNorm pass (its plain half) against the JAX kernel's
    f32 LayerNorm, rows offset from zero so the centring matters."""
    x = (rng.standard_normal((2, 37, d)) + offset * rng.standard_normal((2, 37, 1)))
    x = x.astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.5 * rng.standard_normal(d)).astype(np.float32)
    ref = jfe._ln_f32(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5)
    got = fe.ln_rows_plain(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def quant_rows_input(rng, rows: int, d: int) -> np.ndarray:
    """Seeded rows of bf16 values (as f32) with an offset of their own, an
    all-zero row (scale 1e-10), and two rows whose values land on exact
    ties: max 127 (scale 1) with ±k.5 entries, and max 63.5 (scale 0.5)
    with ±k.25 entries, which round half to even."""
    x = rng.standard_normal((rows, d)) * rng.uniform(0.1, 10, (rows, 1))
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).float().numpy()
    x[1] = 0.0
    ties = rng.integers(-60, 60, d) + 0.5
    x[2] = ties
    x[2, 0] = 127.0
    x[3] = ties / 2
    x[3, 0] = 63.5
    return x


@pytest.mark.parametrize("rows", [5, 37])
def test_quant_rows_plain_matches_jax_quant_rows(rng, rows):
    """fc1's row-quantisation pass (its plain half) against the JAX
    kernels' `_quant_rows`, bit for bit, at D = 1280."""
    x = quant_rows_input(rng, rows, 1280)
    codes, scales = fe8.quant_rows_plain(torch.from_numpy(x).to(torch.bfloat16).reshape(1, rows, -1))
    jcodes, jscales = jfe._quant_rows(jnp.asarray(x))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales).reshape(-1))
    assert scales[1].item() == np.float32(1e-10) and not codes[1].any()
    assert scales[2].item() == 1.0 and scales[3].item() == 0.5
    np.testing.assert_array_equal(codes[2, 1:].numpy(), np.round(x[2, 1:]))  # half to even
    np.testing.assert_array_equal(codes[3, 1:].numpy(), np.round(2 * x[3, 1:]))


@pytest.mark.parametrize("d,rows", [(256, 37), (1280, 5)])
def test_ln_quant_rows_plain_matches_jax_ln_and_quant_rows(rng, d, rows):
    """ln_qkv_int8's LayerNorm + row-quantisation pass against the JAX
    kernel's `_quant_rows(_ln_f32(x))` on rows offset from zero: the codes
    bit for bit, the scales within rel 1e-6 (the LayerNorm's sums are taken
    in another order by each framework, a last bit of a row's |max|)."""
    x = rng.standard_normal((1, rows, d)) * 2 + rng.standard_normal((1, rows, 1)) * 3
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.5 * rng.standard_normal(d)).astype(np.float32)
    codes, scales = fe8.ln_quant_rows_plain(x, torch.from_numpy(g), torch.from_numpy(b))
    jcodes, jscales = jfe._quant_rows(jfe._ln_f32(jnp.asarray(x.float().numpy()[0]),
                                                  jnp.asarray(g), jnp.asarray(b), 1e-5))
    assert codes.dtype == torch.int8 and tuple(codes.shape) == (rows, d)
    assert scales.dtype == torch.float32 and tuple(scales.shape) == (rows,)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(scales.numpy(), np.asarray(jscales).reshape(-1), rtol=1e-6, atol=0)


def attention_inputs(rng, b: int, t: int, heads: int = H):
    return [torch.from_numpy((rng.standard_normal((b, heads, t, HD)) * s).astype(np.float32))
            for s in (0.5, 0.5, 1.0)]


@pytest.mark.parametrize("t,t_valid", [(40, 25), (130, 130)])
def test_pair_codes_plain_matches_jax_quant_rows(rng, t, t_valid):
    """attn_oproj_ln_int8's first pass: the attention output of each head
    pair (heads 2g, 2g + 1 side by side, columns [128 g, 128 g + 128)) coded
    by the JAX `_quant_rows`, bit for bit; keys past t_valid change
    nothing."""
    q, k, v = attention_inputs(rng, 2, t)
    codes, scales = fe8.pair_codes_plain(q, k, v, t_valid)
    assert codes.dtype == torch.int8 and tuple(codes.shape) == (2, t, H * HD)
    assert scales.dtype == torch.float32 and tuple(scales.shape) == (2, t, H // 2)
    r = fe.attention_plain(q, k, v, t_valid).numpy()               # (B, H, T, hd) f32
    for g in range(H // 2):
        pair = np.concatenate([r[:, 2 * g], r[:, 2 * g + 1]], axis=-1)  # (B, T, 128)
        jc, js = jfe._quant_rows(jnp.asarray(pair.reshape(-1, 2 * HD)))
        np.testing.assert_array_equal(codes[..., g * 128:(g + 1) * 128].numpy(),
                                      np.asarray(jc).reshape(2, t, 128))
        np.testing.assert_array_equal(scales[..., g].numpy(), np.asarray(js).reshape(2, t))
    k2, v2 = k.clone(), v.clone()
    k2[:, :, t_valid:] = 50.0
    v2[:, :, t_valid:] = -50.0
    masked = fe8.pair_codes_plain(q, k2, v2, t_valid)
    assert torch.equal(masked[0], codes) and torch.equal(masked[1], scales)


def test_oproj_ln_int8_plain_matches_the_tpu_accumulation(rng):
    """attn_oproj_ln_int8's second pass against the TPU kernel's
    accumulation written in JAX: acc = x + bo, then pair by pair acc +=
    (int32 product · row scale) · cso; y bit for bit, h = `_ln_f32(acc)` to
    the last bits of the LayerNorm's sums."""
    b, t, d = 2, 37, H * HD
    codes = rng.integers(-127, 128, (b, t, d)).astype(np.int8)
    scales = rng.uniform(1e-3, 1e-2, (b, t, H // 2)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).to(torch.bfloat16)
    wo = rng.integers(-127, 128, (d, d)).astype(np.int8)
    cso, bo, g2, b2 = (rng.uniform(1e-3, 1e-2, d).astype(np.float32),
                       (0.1 * rng.standard_normal(d)).astype(np.float32),
                       (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
                       (0.1 * rng.standard_normal(d)).astype(np.float32))
    y, h = fe8.oproj_ln_int8_plain(torch.from_numpy(codes), torch.from_numpy(scales), x,
                                   torch.from_numpy(wo), *map(torch.from_numpy, (cso, bo, g2, b2)))
    acc = jnp.asarray(x.float().numpy()) + bo
    for g in range(H // 2):
        cols = slice(g * 128, (g + 1) * 128)
        part = jnp.einsum("btk,nk->btn", jnp.asarray(codes[..., cols]), jnp.asarray(wo[:, cols]),
                          preferred_element_type=jnp.int32)
        acc = acc + part.astype(jnp.float32) * scales[..., g:g + 1] * cso
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(acc.astype(jnp.bfloat16).astype(jnp.float32)))
    jh = np.asarray(jfe._ln_f32(acc, jnp.asarray(g2), jnp.asarray(b2), 1e-5))
    # one bf16 ulp (2^-8 to 2^-7 of the value), and 1e-5 where terms cancel
    np.testing.assert_allclose(h.float().numpy(), jh, rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attn_oproj_ln_plain_is_its_two_passes(rng, dtype):
    """The bf16 attn_oproj_ln's passes: `attn_heads_plain` puts head h's
    attention output, rounded to the input dtype, in columns [64 h, 64 h +
    64) of a token-major (B, T, D) tensor, keys past t_valid masked;
    `oproj_ln_plain` on it gives `attn_oproj_ln_plain` bit for bit, and so
    do the CPU wrappers of the entry and of each pass."""
    b, t, t_valid, d = 2, 40, 25, H * HD
    q, k, v = (a.to(dtype) for a in attention_inputs(rng, b, t))
    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).to(dtype)
    wo = torch.from_numpy((rng.standard_normal((d, d)) * 0.05).astype(np.float32)).to(dtype)
    bo, g2, b2 = (torch.from_numpy(a.astype(np.float32)) for a in (
        0.1 * rng.standard_normal(d), 1 + 0.1 * rng.standard_normal(d),
        0.1 * rng.standard_normal(d)))
    attn = fe.attn_heads_plain(q, k, v, t_valid)
    assert attn.dtype == dtype and tuple(attn.shape) == (b, t, d)
    r = fe.attention_plain(q, k, v, t_valid).to(dtype)
    for hh in range(H):
        assert torch.equal(attn[..., hh * HD:(hh + 1) * HD], r[:, hh])
    ref = fe.attn_oproj_ln_plain(q, k, v, x, wo, bo, g2, b2, t_valid)
    for got in (fe.oproj_ln_plain(attn, x, wo, bo, g2, b2),
                fe.oproj_ln(fe.attn_heads(q, k, v, t_valid), x, wo, bo, g2, b2),
                fe.attn_oproj_ln(q, k, v, x, wo, bo, g2, b2, t_valid)):
        assert all(torch.equal(g, e) and g.dtype == dtype for g, e in zip(got, ref))
    k2, v2 = k.clone(), v.clone()
    k2[:, :, t_valid:] = 50.0
    v2[:, :, t_valid:] = -50.0
    assert torch.equal(fe.attn_heads_plain(q, k2, v2, t_valid), attn)


def test_oproj_ln_plain_matches_the_tpu_accumulation(rng):
    """The bf16 attn_oproj_ln's second pass at f32 against the TPU kernel's
    accumulation written in JAX: acc = x + bo, then pair by pair acc += the
    pair's 128 attention columns · wo's 128 input channels of the pair
    (preferred_element_type f32); y = acc and h = `_ln_f32(acc)`, to the
    last bits of f32 sums taken in another order."""
    b, t, d = 2, 37, H * HD
    attn, x = (rng.standard_normal((b, t, d)).astype(np.float32) for _ in range(2))
    wo = (rng.standard_normal((d, d)) * 0.05).astype(np.float32)
    bo, g2, b2 = ((0.1 * rng.standard_normal(d)).astype(np.float32),
                  (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
                  (0.1 * rng.standard_normal(d)).astype(np.float32))
    y, h = fe.oproj_ln_plain(*map(torch.from_numpy, (attn, x, wo, bo, g2, b2)))
    acc = jnp.asarray(x) + bo
    for g in range(H // 2):
        cols = slice(g * 128, (g + 1) * 128)
        acc = acc + jnp.einsum("btk,nk->btn", jnp.asarray(attn[..., cols]),
                               jnp.asarray(wo[:, cols]), preferred_element_type=jnp.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(acc), rtol=1e-5, atol=1e-5)
    jh = np.asarray(jfe._ln_f32(acc, jnp.asarray(g2), jnp.asarray(b2), 1e-5))
    np.testing.assert_allclose(h.numpy(), jh, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("preset", list(PRESETS))
def test_bf16_oproj_split_takes_every_whisper_width(preset):
    """The bf16 o-projection splits each Whisper width as the int8 one does
    (one rule): hd 64, D = 64 H a multiple of 128, one cluster of ceil(D /
    256) blocks covering D; the heads of a width with no split refused."""
    cfg = PRESETS[preset]
    d, heads = cfg.n_audio_state, cfg.n_audio_head
    assert d == heads * HD and fe8.oproj_split is fe.oproj_split
    blocks = fe.oproj_split(d)
    assert blocks == {384: 2, 512: 2, 768: 3, 1024: 4, 1280: 5}[d]
    assert blocks * 256 - d in (0, 128) and blocks <= fe.OPROJ_CLUSTER_MAX
    assert fe.oproj_split(d + 64) is None and fe.oproj_split(0) is None


@pytest.mark.parametrize("preset", list(PRESETS))
def test_oproj_split_takes_every_whisper_width(preset):
    """Each Whisper width D splits into one cluster of ceil(D / 256) blocks
    of 256 columns (the last 128 at D = 384), at most 8 (a portable
    cluster); widths not a multiple of 128 or past 2048 are refused."""
    d = PRESETS[preset].n_audio_state
    blocks = fe8.oproj_split(d)
    assert blocks == {384: 2, 512: 2, 768: 3, 1024: 4, 1280: 5}[d]
    assert (blocks - 1) * 256 < d <= blocks * 256 and blocks <= fe8.OPROJ_CLUSTER_MAX
    assert fe8.oproj_split(d + 64) is None and fe8.oproj_split(2048 + 128) is None


@pytest.mark.parametrize("preset", list(PRESETS))
def test_fc1_split_takes_every_whisper_width(preset):
    """Each Whisper width's FF = 4 D splits into clusters of at most 16
    blocks of 2 × 160 or 2 × 128 columns, and D is a multiple of 128."""
    d = PRESETS[preset].n_audio_state
    nw, blocks = fe8.fc1_split(4 * d)
    assert d % 128 == 0 and blocks * 2 * nw == 4 * d and blocks <= fe8.CLUSTER_MAX
    assert nw == (160 if 4 * d == 5120 else 128)


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def ln_qkv_args(d=1280, heads=20, x_shape=None, x_dtype=torch.bfloat16, w_rows=None):
    x = meta(*(x_shape or (2, 1500, d)), dtype=x_dtype)
    return (x, meta(d, dtype=torch.float32), meta(d, dtype=torch.float32),
            meta(w_rows or 3 * d, d), meta(3 * d, dtype=torch.float32), heads)


def attn_args(shape, k_shape=None):
    return meta(*shape), meta(*(k_shape or shape)), meta(*shape)


def fc1_args(d=1280, ff=5120):
    return (meta(2, 1500, d), meta(ff, d, dtype=torch.int8), meta(ff, dtype=torch.float32),
            meta(ff, dtype=torch.float32))


def attn8_args(heads=20, t=1500, x_d=None, wo_d=None):
    d = heads * HD
    return (*attn_args((2, heads, t, HD)), meta(2, t, x_d or d), meta(wo_d or d, wo_d or d,
                                                                       dtype=torch.int8),
            *(meta(d, dtype=torch.float32) for _ in range(4)))


def oproj_args(d=1280, t=1500, x_d=None, wo_d=None, wo_int8=False):
    """x, wo, bo, ln2_w, ln2_b of the bf16 attn_oproj_ln at width D."""
    return (meta(2, t, x_d or d), meta(wo_d or d, wo_d or d,
                                       dtype=torch.int8 if wo_int8 else torch.bfloat16),
            *(meta(d, dtype=torch.float32) for _ in range(3)))


def fc2_args(d=1280, ff=5120):
    return (meta(2, 1500, ff, dtype=torch.int8), meta(2, 1500, 1, dtype=torch.float32),
            meta(2, 1500, d), meta(d, ff, dtype=torch.int8), meta(d, dtype=torch.float32),
            meta(d, dtype=torch.float32))


REFUSED = {
    "ln_qkv D not a multiple of 128": lambda: fe.ln_qkv(*ln_qkv_args(d=192, heads=3)),
    "ln_qkv D not a multiple of the heads": lambda: fe.ln_qkv(*ln_qkv_args(d=256, heads=3)),
    "ln_qkv x not (B, T, D)": lambda: fe.ln_qkv(*ln_qkv_args(x_shape=(3000, 1280))),
    "ln_qkv x not bf16": lambda: fe.ln_qkv(*ln_qkv_args(x_dtype=torch.float32)),
    "ln_qkv weight not (3D, D)": lambda: fe.ln_qkv(*ln_qkv_args(w_rows=1280)),
    "encoder_attention hd 32": lambda: ea.encoder_attention(*attn_args((2, 700, 8, 32))),
    "encoder_attention pre_bh hd 128": lambda: ea.encoder_attention(
        *attn_args((8, 700, 128)), pre_bh=True),
    "encoder_attention pre_bh given (B, T, H, D)": lambda: ea.encoder_attention(
        *attn_args((2, 700, 4, 64)), pre_bh=True),
    "encoder_attention_packed 2·hd 64": lambda: ea.encoder_attention_packed(
        *attn_args((4, 700, 64))),
    "encoder_attention t_valid 0": lambda: ea.encoder_attention(
        *attn_args((2, 700, 4, 64)), t_valid=0),
    "encoder_attention t_valid past T": lambda: ea.encoder_attention(
        *attn_args((2, 700, 4, 64)), t_valid=701),
    "encoder_attention k of another shape": lambda: ea.encoder_attention(
        *attn_args((2, 700, 4, 64), k_shape=(2, 600, 4, 64))),
    "fc1_gelu_int8 FF not a multiple of the cluster's split": lambda: fe8.fc1_gelu_int8(
        *fc1_args(ff=5000)),
    "fc1_gelu_int8 FF past 16 blocks a cluster": lambda: fe8.fc1_gelu_int8(*fc1_args(ff=5376)),
    "fc1_gelu_int8 D not a multiple of 128": lambda: fe8.fc1_gelu_int8(*fc1_args(d=1000)),
    "fc2_residual_int8 D not a multiple of 128": lambda: fe8.fc2_residual_int8(
        *fc2_args(d=1000)),
    "fc2_residual_int8 FF not a multiple of 128": lambda: fe8.fc2_residual_int8(
        *fc2_args(ff=5000)),
    "ln_qkv_int8 an odd head count": lambda: fe8.ln_qkv_int8(
        *ln_qkv_args(d=192 * 2, heads=3, w_rows=3 * 384)[:3], meta(3 * 384, 384, dtype=torch.int8),
        meta(3 * 384, dtype=torch.float32), meta(3 * 384, dtype=torch.float32), 3),
    "ln_quant_rows D not a multiple of 128": lambda: fe8.ln_quant_rows(
        *ln_qkv_args(d=1000)[:3]),
    "qkv_from_codes codes of another shape": lambda: fe8.qkv_from_codes(
        meta(2999, 1280, dtype=torch.int8), meta(3000, dtype=torch.float32),
        meta(3840, 1280, dtype=torch.int8), meta(3840, dtype=torch.float32),
        meta(3840, dtype=torch.float32), (2, 1500, 1280), 20),
    "attn_oproj_ln_int8 D past 2048": lambda: fe8.attn_oproj_ln_int8(
        *attn8_args(heads=34), t_valid=1500),
    "attn_oproj_ln_int8 hd 32": lambda: fe8.attn_oproj_ln_int8(
        *attn_args((2, 20, 700, 32)), meta(2, 700, 640), meta(640, 640, dtype=torch.int8),
        *(meta(640, dtype=torch.float32) for _ in range(4)), t_valid=700),
    "attn_oproj_ln_int8 t_valid past T": lambda: fe8.attn_oproj_ln_int8(
        *attn8_args(), t_valid=1501),
    "attn_oproj_ln_int8 x of another width": lambda: fe8.attn_oproj_ln_int8(
        *attn8_args(x_d=1024), t_valid=1500),
    "pair_codes t_valid 0": lambda: fe8.pair_codes(*attn_args((2, 20, 1500, HD)), 0),
    "oproj_ln_int8 scales not one a head pair": lambda: fe8.oproj_ln_int8(
        meta(2, 1500, 1280, dtype=torch.int8), meta(2, 1500, 20, dtype=torch.float32),
        *attn8_args()[3:]),
    "attn_oproj_ln hd 32": lambda: fe.attn_oproj_ln(
        *attn_args((2, 20, 700, 32)), *oproj_args(640, t=700), t_valid=700),
    "attn_oproj_ln D an odd multiple of 64": lambda: fe.attn_oproj_ln(
        *attn_args((2, 5, 700, HD)), *oproj_args(320, t=700), t_valid=700),
    "attn_oproj_ln D past 2048": lambda: fe.attn_oproj_ln(
        *attn_args((2, 34, 700, HD)), *oproj_args(34 * HD, t=700), t_valid=700),
    "attn_oproj_ln t_valid 0": lambda: fe.attn_oproj_ln(
        *attn_args((2, 20, 1500, HD)), *oproj_args(), t_valid=0),
    "attn_oproj_ln t_valid past T": lambda: fe.attn_oproj_ln(
        *attn_args((2, 20, 1500, HD)), *oproj_args(), t_valid=1501),
    "attn_oproj_ln x of another width": lambda: fe.attn_oproj_ln(
        *attn_args((2, 20, 1500, HD)), *oproj_args(x_d=1024), t_valid=1500),
    "attn_oproj_ln wo of another width": lambda: fe.attn_oproj_ln(
        *attn_args((2, 20, 1500, HD)), *oproj_args(wo_d=1024), t_valid=1500),
    "attn_heads t_valid 0": lambda: fe.attn_heads(*attn_args((2, 20, 1500, HD)), 0),
    "attn_heads hd 128": lambda: fe.attn_heads(*attn_args((2, 10, 1500, 128)), 1500),
    "oproj_ln attention output of another shape": lambda: fe.oproj_ln(
        meta(2, 1499, 1280), *oproj_args()),
    "oproj_ln D without a split": lambda: fe.oproj_ln(meta(2, 1500, 320),
                                                      *oproj_args(320)),
    "oproj_ln int8 weight": lambda: fe.oproj_ln(meta(2, 1500, 1280), *oproj_args(wo_int8=True)),
}


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors pass the wrappers' device rule, and every entry point
    records its call instead of launching."""
    monkeypatch.setattr(_build, "require_cuda", lambda name, *tensors: tensors[0].device)
    calls = []
    monkeypatch.setattr(fe, "_LN_QKV", lambda *a: calls.append("ln_qkv"))
    for name in ("_ATTN_HEADS", "_OPROJ"):
        monkeypatch.setattr(fe, name, lambda *a, name=name: calls.append(f"fe.{name}"))
    monkeypatch.setattr(ea, "_KERNEL", lambda *a: calls.append("encoder_attention"))
    monkeypatch.setattr(fe8, "_FC1", lambda *a: calls.append("fc1_gelu_int8"))
    monkeypatch.setattr(fe8, "_FC2", lambda *a: calls.append("fc2_residual_int8"))
    for name in ("_LN_QUANT", "_QKV", "_PAIR_CODES", "_OPROJ"):
        monkeypatch.setattr(fe8, name, lambda *a, name=name: calls.append(name))
    return calls


@pytest.mark.parametrize("case", list(REFUSED))
def test_wrappers_refuse_without_launching(fake_card, case):
    def counts():
        return [dict(c) for c in (fe.LAUNCHES, fe.PASS_LAUNCHES, ea.LAUNCHES, fe8.LAUNCHES,
                                  fe8.PASS_LAUNCHES)]

    before = counts()
    with pytest.raises(ValueError):
        REFUSED[case]()
    assert fake_card == []
    assert counts() == before


def test_wrappers_launch_what_they_accept(fake_card, monkeypatch):
    """The control of the refusals above: the same calls at accepted shapes
    reach the entry points, once each, and count one launch each."""
    monkeypatch.setattr(fe, "LAUNCHES", dict.fromkeys(fe.LAUNCHES, 0))
    monkeypatch.setattr(ea, "LAUNCHES", dict.fromkeys(ea.LAUNCHES, 0))
    q, k, v = fe.ln_qkv(*ln_qkv_args())
    assert tuple(q.shape) == (2, 20, 1500, 64)
    ea.encoder_attention(*attn_args((2, 700, 4, 64)), t_valid=700)
    ea.encoder_attention(*attn_args((8, 700, 64)), pre_bh=True, t_valid=1)
    ea.encoder_attention_packed(*attn_args((4, 700, 128)))
    assert fake_card == ["ln_qkv", "encoder_attention", "encoder_attention", "encoder_attention"]
    assert fe.LAUNCHES["ln_qkv"] == 1
    assert ea.LAUNCHES == {"encoder_attention": 2, "encoder_attention_packed": 1}


@pytest.mark.parametrize("d,ff", [(1280, 5120), (1024, 4096), (384, 1536)])
def test_fc_wrappers_launch_what_they_accept(fake_card, monkeypatch, d, ff):
    """The control of the fc1/fc2 refusals above: accepted shapes (large,
    medium and tiny Whisper widths) reach `_FC1` and `_FC2` once each and
    count one launch each; fc1 returns its codes and row scales."""
    monkeypatch.setattr(fe8, "LAUNCHES", dict.fromkeys(fe8.LAUNCHES, 0))
    codes, sg = fe8.fc1_gelu_int8(*fc1_args(d, ff))
    assert tuple(codes.shape) == (2, 1500, ff) and codes.dtype == torch.int8
    assert tuple(sg.shape) == (2, 1500, 1) and sg.dtype == torch.float32
    out = fe8.fc2_residual_int8(*fc2_args(d, ff))
    assert tuple(out.shape) == (2, 1500, d) and out.dtype == torch.bfloat16
    assert fake_card == ["fc1_gelu_int8", "fc2_residual_int8"]
    assert fe8.LAUNCHES == {"ln_qkv_int8": 0, "attn_oproj_ln_int8": 0, "fc1_gelu_int8": 1,
                            "fc2_residual_int8": 1}


@pytest.mark.parametrize("heads", [20, 16, 6])
def test_int8_attention_wrappers_launch_their_two_passes(fake_card, monkeypatch, heads):
    """The control of the ln_qkv_int8 / attn_oproj_ln_int8 refusals above, at
    the large, medium and tiny Whisper widths: each entry runs its two
    launches with the scratch between them (LayerNorm1's codes (M, D) and
    scales (M); the pair codes (B, T, D) and scales (B, T, H / 2)), counts
    one launch in LAUNCHES, and its passes called alone count in
    PASS_LAUNCHES only."""
    monkeypatch.setattr(fe8, "LAUNCHES", dict.fromkeys(fe8.LAUNCHES, 0))
    monkeypatch.setattr(fe8, "PASS_LAUNCHES", dict.fromkeys(fe8.PASS_LAUNCHES, 0))
    seen = {}
    for name in ("_LN_QUANT", "_QKV", "_PAIR_CODES", "_OPROJ"):
        monkeypatch.setattr(fe8, name, lambda dev, *a, name=name: (fake_card.append(name),
                                                                   seen.setdefault(name, a)))
    d, t = heads * HD, 1500
    q, k, v = fe8.ln_qkv_int8(*ln_qkv_args(d=d, heads=heads)[:3], meta(3 * d, d, dtype=torch.int8),
                              meta(3 * d, dtype=torch.float32), meta(3 * d, dtype=torch.float32),
                              heads)
    assert all(tuple(a.shape) == (2, heads, t, HD) and a.dtype == torch.bfloat16 for a in (q, k, v))
    xq, sx = seen["_LN_QUANT"][3:5]
    assert (xq.dtype, tuple(xq.shape), sx.dtype, tuple(sx.shape)) == (
        torch.int8, (2 * t, d), torch.float32, (2 * t,))
    assert seen["_QKV"][0] is xq and seen["_QKV"][1] is sx
    y, h = fe8.attn_oproj_ln_int8(q, k, v, *attn8_args(heads=heads)[3:], t_valid=t)
    assert tuple(y.shape) == tuple(h.shape) == (2, t, d) and y.dtype == torch.bfloat16
    codes, scales = seen["_PAIR_CODES"][3:5]
    assert (codes.dtype, tuple(codes.shape), scales.dtype, tuple(scales.shape)) == (
        torch.int8, (2, t, d), torch.float32, (2, t, heads // 2))
    assert seen["_OPROJ"][0] is codes and seen["_OPROJ"][1] is scales
    assert fake_card == ["_LN_QUANT", "_QKV", "_PAIR_CODES", "_OPROJ"]
    assert fe8.LAUNCHES == {"ln_qkv_int8": 1, "attn_oproj_ln_int8": 1, "fc1_gelu_int8": 0,
                            "fc2_residual_int8": 0}
    fe8.pair_codes(q, k, v, t)
    fe8.oproj_ln_int8(codes, scales, *attn8_args(heads=heads)[3:])
    fe8.ln_quant_rows(*ln_qkv_args(d=d, heads=heads)[:3])
    fe8.qkv_from_codes(xq, sx, meta(3 * d, d, dtype=torch.int8), meta(3 * d, dtype=torch.float32),
                       meta(3 * d, dtype=torch.float32), (2, t, d), heads)
    assert fe8.PASS_LAUNCHES == dict.fromkeys(fe8.PASS_LAUNCHES, 1)
    assert fe8.LAUNCHES["ln_qkv_int8"] == fe8.LAUNCHES["attn_oproj_ln_int8"] == 1


@pytest.mark.parametrize("preset", list(PRESETS))
def test_bf16_attention_wrapper_launches_its_two_passes(fake_card, monkeypatch, preset):
    """The control of the bf16 attn_oproj_ln refusals above, at every Whisper
    width: the entry runs attn_heads, then oproj_ln on the (B, T, D) bf16
    scratch that attn_heads wrote, counts one launch in LAUNCHES, and its
    passes called alone count in PASS_LAUNCHES only."""
    monkeypatch.setattr(fe, "LAUNCHES", dict.fromkeys(fe.LAUNCHES, 0))
    monkeypatch.setattr(fe, "PASS_LAUNCHES", dict.fromkeys(fe.PASS_LAUNCHES, 0))
    seen = {}
    for name in ("_ATTN_HEADS", "_OPROJ"):
        monkeypatch.setattr(fe, name, lambda dev, *a, name=name: (fake_card.append(name),
                                                                  seen.setdefault(name, a)))
    cfg = PRESETS[preset]
    d, heads, t = cfg.n_audio_state, cfg.n_audio_head, 1500
    qkv = attn_args((2, heads, t, HD))
    y, h = fe.attn_oproj_ln(*qkv, *oproj_args(d), t_valid=1000)
    assert tuple(y.shape) == tuple(h.shape) == (2, t, d) and y.dtype == h.dtype == torch.bfloat16
    attn = seen["_ATTN_HEADS"][3]
    assert (attn.dtype, tuple(attn.shape)) == (torch.bfloat16, (2, t, d))
    assert seen["_ATTN_HEADS"][4:] == (2, t, heads, 1000)
    assert seen["_OPROJ"][0] is attn and seen["_OPROJ"][6] is y and seen["_OPROJ"][7] is h
    assert seen["_OPROJ"][8:10] == (2 * t, d)
    assert fake_card == ["_ATTN_HEADS", "_OPROJ"]
    assert fe.LAUNCHES == {"ln_qkv": 0, "attn_oproj_ln": 1}
    assert fe.PASS_LAUNCHES == {"attn_heads": 0, "oproj_ln": 0}
    fe.attn_heads(*qkv, t)
    fe.oproj_ln(attn, *oproj_args(d))
    assert fe.PASS_LAUNCHES == {"attn_heads": 1, "oproj_ln": 1}
    assert fe.LAUNCHES["attn_oproj_ln"] == 1
