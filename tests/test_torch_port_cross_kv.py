"""PyTorch port, int8 cross-K/V decode attention: quantisation, the prefill
dequantisation and the plain version of the cross_attention_decode kernel
against the JAX package (its Pallas kernel in interpret mode).

The TPU kernel feeds bf16 dots while the port computes in f32, hence
atol 2e-2 and cosine > 0.999 against it; against the f32 numpy reference
of tests/test_cross_kv_attention.py the port is held to 1e-5.

The kernel's partition on the CPU: `cross_attention_chunks_plain` (each
(batch, head)'s keys in chunks, one a cluster rank, their (max, sum, P·V)
merged) against the unsplit plain version at 1, 2, 4, 13 and 32 chunks and
t_valid 1, 100 and 1500, empty chunks among them; one rank's partial
dropped moves it outside.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_cross_kv_attention import ref_attention
from tpu_audio.ops.pallas import cross_kv_attention as jckv
from tpu_audio_torch.ops.kernels import cross_kv_attention as ckv
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def cosine(a, b) -> float:
    a, b = np.ravel(a), np.ravel(b)
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def quantized(rng, lyr, b, t, h, hd):
    ck = (rng.standard_normal((lyr, b, t, h, hd)) * 0.3).astype(np.float32)
    cv = (rng.standard_normal((lyr, b, t, h, hd)) * 0.5).astype(np.float32)
    return ck, cv


def test_quantize_cross_kv_matches_exactly(rng):
    ck, cv = quantized(rng, 2, 3, 100, 4, 32)
    got = ckv.quantize_cross_kv(torch.from_numpy(ck), torch.from_numpy(cv))
    ref = jckv.quantize_cross_kv(jnp.asarray(ck), jnp.asarray(cv))
    assert tuple(got[0].shape) == (2, 3, 128, 128) and got[0].dtype == torch.int8
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_dequant_layer_matches(rng):
    ck, cv = quantized(rng, 1, 2, 100, 4, 64)
    k8, ks, _, _ = ckv.quantize_cross_kv(torch.from_numpy(ck), torch.from_numpy(cv))
    got = ckv.dequant_layer(k8[0], ks[0], 100, 4)
    ref = jckv.dequant_layer(jnp.asarray(k8[0].numpy()), jnp.asarray(ks[0].numpy()),
                             100, 4)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 100, 4, 64)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("b,h,hd,t", [(2, 4, 64, 100), (1, 8, 64, 300)])
def test_decode_matches_pallas(rng, b, h, hd, t):
    lyr = 3
    ck, cv = quantized(rng, lyr, b, t, h, hd)
    k8, ks, v8, vs = ckv.quantize_cross_kv(torch.from_numpy(ck), torch.from_numpy(cv))
    jk8, jks, jv8, jvs = (jnp.asarray(a.numpy()) for a in (k8, ks, v8, vs))
    q = (rng.standard_normal((b, h, hd)) * 0.2).astype(np.float32)
    for layer in (0, lyr - 1):
        got = ckv.cross_attention_decode(torch.from_numpy(q), k8, v8, ks[layer], vs[layer],
                                         layer, t_valid=t, n_heads=h).numpy()
        jax_out = np.asarray(jckv.cross_attention_decode(
            jnp.asarray(q), jk8, jv8, jks[layer], jvs[layer], jnp.int32(layer),
            t_valid=t, n_heads=h, interpret=True))
        np.testing.assert_allclose(got, jax_out, atol=2e-2, rtol=2e-2)
        assert cosine(got, jax_out) > 0.999
        ref = ref_attention(q, k8.numpy(), v8.numpy(), ks[layer].numpy(),
                            vs[layer].numpy(), layer, t)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_padded_rows_ignored(rng):
    """t_valid < T_pad: poisoned padded key/value rows must not leak in."""
    b, h, hd, t = 1, 4, 64, 64  # pads to 128
    ck, _ = quantized(rng, 1, b, t, h, hd)
    k8, ks, v8, vs = ckv.quantize_cross_kv(torch.from_numpy(ck), torch.from_numpy(ck))
    k8[:, :, t:] = 127
    v8[:, :, t:] = 127
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    got = ckv.cross_attention_decode(torch.from_numpy(q), k8, v8, ks[0], vs[0], 0,
                                     t_valid=t, n_heads=h).numpy()
    jax_out = np.asarray(jckv.cross_attention_decode(
        jnp.asarray(q), jnp.asarray(k8.numpy()), jnp.asarray(v8.numpy()),
        jnp.asarray(ks[0].numpy()), jnp.asarray(vs[0].numpy()), jnp.int32(0),
        t_valid=t, n_heads=h, interpret=True))
    np.testing.assert_allclose(got, jax_out, atol=5e-2)
    assert cosine(got, jax_out) > 0.999
    ref = ref_attention(q, k8.numpy(), v8.numpy(), ks[0].numpy(), vs[0].numpy(), 0, t)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    # the poisoned rows would shift the result if they were read
    bad = ckv.cross_attention_decode(torch.from_numpy(q), k8, v8, ks[0], vs[0], 0,
                                     t_valid=2 * t, n_heads=h).numpy()
    assert np.abs(bad - ref).max() > 0.1


def test_wrapper_launches_nothing_on_cpu_and_refuses_other_devices(rng):
    ck, cv = quantized(rng, 2, 2, 50, 2, 64)
    k8, ks, v8, vs = ckv.quantize_cross_kv(torch.from_numpy(ck), torch.from_numpy(cv))
    q = torch.from_numpy(rng.standard_normal((2, 2, 64)).astype(np.float32))
    before = dict(ckv.LAUNCHES)
    got = ckv.cross_attention_decode(q, k8, v8, ks[1], vs[1], 1, t_valid=50, n_heads=2)
    assert ckv.LAUNCHES == before
    torch.testing.assert_close(got, ckv.cross_attention_decode_plain(
        q, k8, v8, ks[1], vs[1], 1, t_valid=50, n_heads=2))
    with pytest.raises(ValueError, match="CUDA"):
        ckv.cross_attention_decode(q.to("meta"), k8, v8, ks[1], vs[1], 1, t_valid=50,
                                   n_heads=2)


@pytest.mark.parametrize("t_valid", [1, 100, 1500])
@pytest.mark.parametrize("split", [1, 2, ckv.RANKS, 13, 32])
def test_chunked_plain_matches_unsplit(rng, split, t_valid):
    """One pass a chunk, rescaled in the merge: equal up to the order of
    the f32 sums. The padded rows hold large codes that must not be read."""
    lyr, b, h, hd = 2, 2, 2, 64
    ck, cv = quantized(rng, lyr, b, 1500, h, hd)
    k8, ks, v8, vs = ckv.quantize_cross_kv(torch.from_numpy(ck), torch.from_numpy(cv))
    k8[:, :, t_valid:], v8[:, :, t_valid:] = 127, 127
    q = torch.from_numpy((rng.standard_normal((b, h, hd)) * 0.2).astype(np.float32))
    args = (q, k8, v8, ks[1], vs[1], 1)
    got = ckv.cross_attention_chunks_plain(*args, t_valid=t_valid, n_heads=h, ranks=split)
    ref = ckv.cross_attention_decode_plain(*args, t_valid=t_valid, n_heads=h)
    assert got.shape == ref.shape == (b, h, hd)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


def test_chunk_bounds_cover_the_keys():
    for n, split in ((1, ckv.RANKS), (1000, ckv.RANKS), (1500, ckv.RANKS), (9, 13)):
        bounds = ckv.chunk_bounds(n, split)
        assert len(bounds) == split and bounds[0][0] == 0 and bounds[-1][1] == n
        assert sum(b - a for a, b in bounds) == n


@pytest.mark.parametrize("t_valid", [1000, 1500])
def test_a_dropped_rank_is_visible(rng, t_valid):
    """The fault chip_smoke plants (one cluster rank's partial left out of
    the merge) lands far outside the tolerances the kernel is held to."""
    ck, cv = quantized(rng, 1, 2, t_valid, 2, 64)
    k8, ks, v8, vs = ckv.quantize_cross_kv(torch.from_numpy(ck), torch.from_numpy(cv))
    q = torch.from_numpy((rng.standard_normal((2, 2, 64)) * 0.2).astype(np.float32))
    args = (q, k8, v8, ks[0], vs[0], 0)
    ref = ckv.cross_attention_decode_plain(*args, t_valid=t_valid, n_heads=2)
    got = ckv.cross_attention_chunks_plain(*args, t_valid=t_valid, n_heads=2,
                                           drop_chunk=ckv.RANKS - 1)
    assert ((got - ref).abs().max() / ref.abs().max()).item() > 5e-2
