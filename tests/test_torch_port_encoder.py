"""PyTorch port, Whisper encoder: the layers and the fused encoder-block
phases (ln_qkv, attn_oproj_ln) against the JAX package, in f32 on the CPU,
and at bf16 the rounding of their plain versions against the JAX kernels'.

The JAX fused-encoder kernels run in interpret mode, as
tests/test_pallas_kernels.py runs them. Their q/k/v are pair-packed
(B, H/2, T_pad, 128); the port's are head-major (B, H, T, hd):
`packed_to_head_major` maps one onto the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.nn import attention as jattention
from tpu_audio.nn import layers as jlayers
from tpu_audio.ops.pallas import fused_encoder as jfe
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.nn import attention, layers
from tpu_audio_torch.ops.kernels import fused_encoder as fe
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=2e-4, atol=2e-4)


def packed_to_head_major(a, t: int) -> np.ndarray:
    """(B, G, T_pad, 2·hd) pair-packed → (B, 2G, t, hd) head-major."""
    a = np.asarray(a)[:, :, :t]
    b, g, _, lanes = a.shape
    hd = lanes // 2
    return a.reshape(b, g, t, 2, hd).transpose(0, 1, 3, 2, 4).reshape(b, 2 * g, t, hd)


def block_params(rng, d: int, k_bias: bool = True) -> dict:
    def lin(o, i, bias=True):
        p = {"weight": rng.standard_normal((o, i)).astype(np.float32) * 0.05}
        if bias:
            p["bias"] = rng.standard_normal((o,)).astype(np.float32) * 0.05
        return p

    def norm():
        return {"weight": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}

    return {"attn": {"q": lin(d, d), "k": lin(d, d, bias=k_bias), "v": lin(d, d),
                     "o": lin(d, d)},
            "ln1": norm(), "ln2": norm()}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# ------------------------------------------------------------------ layers

def test_linear_layer_norm_gelu_embedding(rng):
    p = {"weight": rng.standard_normal((48, 32)).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    ln = {"weight": rng.standard_normal(32).astype(np.float32),
          "bias": rng.standard_normal(32).astype(np.float32)}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    tp, tln = params_from_numpy(p, device="cpu"), params_from_numpy(ln, device="cpu")
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(layers.linear(tp, tx).numpy(),
                               np.asarray(jlayers.linear(to_jax(p), jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(layers.layer_norm(tln, tx).numpy(),
                               np.asarray(jlayers.layer_norm(to_jax(ln), jnp.asarray(x))),
                               **TOL)
    np.testing.assert_allclose(layers.gelu(tx).numpy(),
                               np.asarray(jlayers.gelu(jnp.asarray(x))), **TOL)
    ids = np.array([[3, 0, 47]])
    np.testing.assert_array_equal(layers.embedding(tp, torch.from_numpy(ids)).numpy(),
                                  np.asarray(jlayers.embedding(to_jax(p), jnp.asarray(ids))))
    np.testing.assert_allclose(
        layers.embedding_as_linear(params_from_numpy({"weight": p["weight"]}, device="cpu"),
                                   tx).numpy(),
        np.asarray(jlayers.embedding_as_linear({"weight": jnp.asarray(p["weight"])},
                                               jnp.asarray(x))), **TOL)
    assert np.array_equal(layers.sinusoidal_positions(300, 64),
                          jlayers.sinusoidal_positions(300, 64))


@pytest.mark.parametrize("stride", [1, 2])
def test_conv1d_matches_jax_layout(rng, stride):
    """JAX stores conv weights (K, I, O); params_from_numpy transposes them
    to torch's (O, I, K) under a 'conv*' key."""
    tree = {"conv1": {"weight": rng.standard_normal((3, 6, 10)).astype(np.float32),
                      "bias": rng.standard_normal(10).astype(np.float32)}}
    x = rng.standard_normal((2, 20, 6)).astype(np.float32)
    tp = params_from_numpy(tree, device="cpu")["conv1"]
    assert tuple(tp["weight"].shape) == (10, 6, 3)
    got = layers.conv1d(tp, torch.from_numpy(x), stride=stride, padding=1)
    ref = jlayers.conv1d_mxu(to_jax(tree["conv1"]), jnp.asarray(x), stride=stride,
                             padding=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_attend_and_decode_mask(rng):
    q, k, v = (rng.standard_normal((2, 3, 4, 16)).astype(np.float32) for _ in range(3))
    kk = rng.standard_normal((2, 10, 4, 16)).astype(np.float32)
    mask = attention.decode_mask(10, torch.tensor(5), 3)
    jmask = jattention.decode_mask(10, jnp.int32(5), 3)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    got = attention.attend(torch.from_numpy(q), torch.from_numpy(kk), torch.from_numpy(kk),
                           mask)
    ref = jattention.attend(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(kk), jmask,
                            q_scaled=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    got = attention.attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    ref = jattention.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_scaled=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ----------------------------------------------------- fused encoder phases

def test_pack_qkv_weights_is_the_packed_layout(rng):
    """Pair-packed columns [h2g | h2g+1] per group are head-major order, so
    the port's (3D, D) packed weight is exactly the TPU's (D, 3D) transposed."""
    p = block_params(rng, 256)["attn"]
    w, b = fe.pack_qkv_weights(params_from_numpy(p, device="cpu"), 4, torch.float32)
    jw, jb = jfe.pack_qkv_weights(to_jax(p), 4, jnp.float32)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw).T)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("t,k_bias", [(512, True), (600, False)])
def test_block_phases_match_pallas(rng, t, k_bias):
    """ln_qkv and attn_oproj_ln (the CUDA kernels' plain versions) against
    the TPU kernels in interpret mode: each phase on the same inputs, then
    the two phases chained."""
    b, d, n_heads = 2, 256, 4
    p = block_params(rng, d, k_bias)
    x = (rng.standard_normal((b, t, d)) * 0.3).astype(np.float32)
    jp = to_jax(p)
    jq, jk, jv = jfe.ln_qkv_packed(jnp.asarray(x), jp["ln1"], jp["attn"], n_heads,
                                   block_t=128, interpret=True)
    jy, jh = jfe.attn_oproj_ln(jq, jk, jv, jnp.asarray(x), jp["attn"]["o"], jp["ln2"],
                               t_valid=t, block_q=128, interpret=True)

    tp = params_from_numpy(p, device="cpu")
    w, bias = fe.pack_qkv_weights(tp["attn"], n_heads, torch.float32)
    tx = torch.from_numpy(x)
    q, k, v = fe.ln_qkv(tx, tp["ln1"]["weight"], tp["ln1"]["bias"], w, bias, n_heads)
    assert tuple(q.shape) == (b, n_heads, t, d // n_heads)
    for got, ref in zip((q, k, v), (jq, jk, jv)):
        np.testing.assert_allclose(got.numpy(), packed_to_head_major(ref, t), **TOL)

    o, ln2 = tp["attn"]["o"], tp["ln2"]
    qkv_jax = [torch.from_numpy(packed_to_head_major(a, t).copy()) for a in (jq, jk, jv)]
    for qkv in (qkv_jax, (q, k, v)):
        y, h = fe.attn_oproj_ln(*qkv, tx, o["weight"], o["bias"], ln2["weight"],
                                ln2["bias"], t_valid=t)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


def test_bf16_plain_versions_round_once_as_the_tpu_kernels(rng):
    """At bf16, ln_qkv_plain and attn_oproj_ln_plain keep each matrix product
    in f32 until the bias or the residual is added and round once, as the
    TPU kernels do (preferred_element_type=f32): at most 1 % of the q, k, v,
    y and h entries differ from the JAX kernels in interpret mode. A product
    rounded to bf16 before the addition moves 15-27 % of them by a bf16
    step. attn_oproj_ln_plain takes the JAX kernel's q, k, v, so that each
    phase is held alone."""
    b, t, d, n_heads = 2, 256, 256, 4
    p = block_params(rng, d)
    x = (rng.standard_normal((b, t, d)) * 0.3).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jp = to_jax(p)
    jq, jk, jv = jfe.ln_qkv_packed(jx, jp["ln1"], jp["attn"], n_heads, block_t=128,
                                   interpret=True)
    jy, jh = jfe.attn_oproj_ln(jq, jk, jv, jx, jp["attn"]["o"], jp["ln2"], t_valid=t,
                               block_q=128, interpret=True)

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    def bf16(a):
        return torch.from_numpy(np.array(a)).to(torch.bfloat16)

    tp = params_from_numpy(p, device="cpu")
    w, bias = fe.pack_qkv_weights(tp["attn"], n_heads, torch.bfloat16)
    tx = bf16(f32(jx))
    qkv = fe.ln_qkv_plain(tx, tp["ln1"]["weight"], tp["ln1"]["bias"], w, bias, n_heads)
    o, ln2 = tp["attn"]["o"], tp["ln2"]
    qkv_jax = [bf16(packed_to_head_major(f32(a), t)) for a in (jq, jk, jv)]
    y, h = fe.attn_oproj_ln_plain(*qkv_jax, tx, o["weight"].to(torch.bfloat16), o["bias"],
                                  ln2["weight"], ln2["bias"], t_valid=t)
    pairs = [*zip("qkv", qkv, (packed_to_head_major(f32(a), t) for a in (jq, jk, jv))),
             ("y", y, f32(jy)), ("h", h, f32(jh))]
    for name, got, ref in pairs:
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
        share = float(np.mean(got.float().numpy() != ref))
        assert share <= 0.01, f"{name}: {share:.2%} of the entries differ from JAX"


def test_attn_oproj_ln_masks_keys_past_t_valid(rng):
    """Keys at t >= t_valid must not change the result."""
    b, h, t, hd, t_valid = 1, 2, 40, 8, 25
    d = h * hd
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, hd)).astype(np.float32))
               for _ in range(3))
    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32))
    wo = torch.from_numpy(rng.standard_normal((d, d)).astype(np.float32) * 0.1)
    bo, g2, b2 = torch.zeros(d), torch.ones(d), torch.zeros(d)
    y, _ = fe.attn_oproj_ln(q, k, v, x, wo, bo, g2, b2, t_valid=t_valid)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, t_valid:] = 100.0
    v2[:, :, t_valid:] = -100.0
    y2, _ = fe.attn_oproj_ln(q, k2, v2, x, wo, bo, g2, b2, t_valid=t_valid)
    torch.testing.assert_close(y, y2)


def test_wrappers_launch_nothing_on_cpu_and_refuse_other_devices(rng):
    d, n_heads = 128, 2
    p = params_from_numpy(block_params(rng, d), device="cpu")
    w, bias = fe.pack_qkv_weights(p["attn"], n_heads, torch.float32)
    x = torch.from_numpy(rng.standard_normal((1, 8, d)).astype(np.float32))
    before = dict(fe.LAUNCHES)
    q, k, v = fe.ln_qkv(x, p["ln1"]["weight"], p["ln1"]["bias"], w, bias, n_heads)
    fe.attn_oproj_ln(q, k, v, x, p["attn"]["o"]["weight"], p["attn"]["o"]["bias"],
                     p["ln2"]["weight"], p["ln2"]["bias"], t_valid=8)
    assert fe.LAUNCHES == before
    meta = x.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        fe.ln_qkv(meta, p["ln1"]["weight"], p["ln1"]["bias"], w, bias, n_heads)
