"""PyTorch port, the whole-decoder B=1 step: the plain version of
`fused_whisper_decode_step` against the JAX Pallas kernel in interpret
mode, and the port's `decode_step` against the JAX package's over a greedy
rollout (JAX's fused-step and int8 kernels patched on, in interpret mode).

Tiny config as tests/test_pallas_kernels.py's fused-step test (d 256, 4
heads, 2 decoder layers, n_text_ctx 16, n_audio_ctx 64). The inputs make
every term of the step matter: a random history in the cache, random
LayerNorm parameters and a unit-scale residual. h and the new K/V slot are
held at 1e-4 of max|ref| with an f32 cache and f32 or int8 weights, and at
2e-2 with a bf16 cache or bf16 weights.

The kernel's algebra on the CPU: `self_attention_chunks` and
`cross_attention_chunks` (the keys split as the kernel splits them, each
chunk's (max, sum, P·V) merged as its last chunk merges them: one pass a
chunk at f32, two with bf16 rounding) against the unsplit plain attentions
at 1, 2, 13 and 32 chunks, empty chunks among them; the planted faults of
that merge change the result; `tools/step_split.py`'s cuts apply to the
kernel's sources.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_int8 import DIMS, jax_kernels, jax_tree, numpy_tree  # noqa: F401
from tpu_audio.models.whisper import load as jload
from tpu_audio.models.whisper import model as jmodel
from tpu_audio.models.whisper.config import WhisperConfig as JWhisperConfig
from tpu_audio.ops.pallas import cross_kv_attention as jckv
from tpu_audio.ops.pallas import fused_whisper_step as jfws
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.whisper import model as tmodel
from tpu_audio_torch.models.whisper.config import WhisperConfig
from tpu_audio_torch.ops.kernels import fused_whisper_step as fws
from tpu_audio_torch.tools import step_split
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CFG = WhisperConfig(**DIMS)
JCFG = JWhisperConfig(**DIMS)


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def decoder_tree(rng, int8: bool):
    """The JAX tree with random LayerNorm parameters (init_params sets them
    to 1 and 0, which would hide a swapped weight and bias)."""
    params = jax_tree()
    if int8:
        params = jload.serve_tree_int8(params, encoder=False)
    dec = params["decoder"]
    for name in ("ln1", "ln_cross", "ln2"):
        shape = dec["blocks"][name]["weight"].shape
        dec["blocks"][name] = {
            "weight": jnp.asarray(1 + 0.3 * rng.standard_normal(shape), jnp.float32),
            "bias": jnp.asarray(0.3 * rng.standard_normal(shape), jnp.float32)}
    dec["ln"] = {"weight": jnp.asarray(1 + 0.3 * rng.standard_normal(256), jnp.float32),
                 "bias": jnp.asarray(0.3 * rng.standard_normal(256), jnp.float32)}
    return params


@pytest.mark.parametrize("weights", ["int8", "float32", "bfloat16"])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 9])
def test_plain_step_matches_pallas(rng, weights, cache_dtype, pos):
    """bf16 weights come with bf16 activations, so the LN output, the
    attention probabilities and outputs and the GELU output are rounded to
    bf16 before each product on both sides; that case is held at 2e-2."""
    params = decoder_tree(rng, weights == "int8")
    act = jnp.bfloat16 if weights == "bfloat16" else jnp.float32
    params["decoder"] = jax.tree.map(
        lambda a: a.astype(act) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        params["decoder"])
    d, lyr, s_max, t = 256, CFG.n_text_layer, CFG.n_text_ctx, CFG.n_audio_ctx
    cache = np.zeros((2, lyr, s_max, d), np.float32)
    cache[:, :, :pos] = rng.standard_normal((2, lyr, pos, d))
    x = rng.standard_normal((1, d)).astype(np.float32)
    ck = (rng.standard_normal((lyr, 1, t, 4, 64)) * 0.5).astype(np.float32)
    cv = rng.standard_normal((lyr, 1, t, 4, 64)).astype(np.float32)
    k8, ksc, v8, vsc = (np.asarray(a) for a in jckv.quantize_cross_kv(
        jnp.asarray(ck), jnp.asarray(cv)))
    jdt = getattr(jnp, cache_dtype)
    h_ref, kc_ref, vc_ref = jfws.fused_whisper_decode_step(
        params["decoder"], jnp.asarray(x, act), jnp.int32(pos), jnp.asarray(cache[0], jdt),
        jnp.asarray(cache[1], jdt), jnp.asarray(k8), jnp.asarray(ksc), jnp.asarray(v8),
        jnp.asarray(vsc), n_heads=4, hd=64, t_valid=t, interpret=True)

    tact = torch.bfloat16 if weights == "bfloat16" else torch.float32
    dec = params_from_numpy(numpy_tree(params), dtype=tact, device="cpu")["decoder"]
    tdt = getattr(torch, cache_dtype)
    kc, vc = (torch.from_numpy(c).to(tdt) for c in cache)
    before = kc.clone()
    h = fws.fused_whisper_decode_step(
        fws.StepWeights.of(dec), torch.from_numpy(x).to(tact), torch.tensor(pos), kc, vc,
        *(torch.from_numpy(a) for a in (k8, ksc, v8, vsc)), n_heads=4, t_valid=t)
    tol = 1e-4 if cache_dtype == "float32" and weights != "bfloat16" else 2e-2
    assert h.dtype == torch.float32 and h.shape == (1, d)
    assert rel_err(h, h_ref) <= tol
    for got, ref in ((kc, kc_ref), (vc, vc_ref)):
        assert rel_err(got[:, pos].float(), np.asarray(ref, np.float32)[:, pos]) <= tol
    keep = [i for i in range(s_max) if i != pos]
    assert torch.equal(kc[:, keep], before[:, keep])  # only the slot is written


@pytest.mark.parametrize("int8", [True, False])
def test_decode_step_rollout_matches_jax(rng, jax_kernels, int8):  # noqa: F811
    """Prefill, then 6 greedy B=1 steps through the fused step on both
    sides: f32 logits within 1e-4 at every step, teacher-forced with the
    JAX tokens; the port's own greedy choice may differ from JAX's in at
    most one of the six (near-tie logits of random weights, as the JAX
    package's rollout test allows)."""
    params = decoder_tree(rng, int8)
    model = tmodel.Whisper(CFG, params_from_numpy(numpy_tree(params), device="cpu"))
    feats = (rng.standard_normal((1, CFG.n_audio_ctx, 256)) * 0.3).astype(np.float32)
    jstate = jmodel.init_state(params, JCFG, jnp.asarray(feats), kv_int8=True)
    tstate = model.init_state(torch.from_numpy(feats), kv_int8=True)
    launches = dict(fws.LAUNCHES)
    tokens, agree = [[3, 7, 9]], 0
    for step in range(7):
        jl, jstate = jmodel.decode_step(params, JCFG, jnp.asarray([tokens[-1]], jnp.int32),
                                        jstate)
        tl, tstate = model.decode_step(torch.tensor([tokens[-1]]), tstate)
        jl, tl = np.asarray(jl)[0, -1], tl[0, -1].numpy()
        assert rel_err(tl, jl) <= 1e-4, step
        if step:
            agree += int(tl.argmax() == jl.argmax())
        tokens.append([int(jl.argmax())])
    assert agree >= 5
    assert int(tstate.cache.pos) == int(jstate.cache.pos) == 9
    np.testing.assert_allclose(tstate.cache.k.numpy(), np.asarray(jstate.cache.k), atol=1e-4)
    assert fws.LAUNCHES == launches  # CPU tensors run the plain version


def test_wrapper_refuses_other_devices(rng):
    params = decoder_tree(rng, True)
    sw = fws.StepWeights.of(params_from_numpy(numpy_tree(params), device="cpu")["decoder"])
    d = 256
    kc = torch.zeros(2, 16, d, device="meta")
    k8 = torch.zeros(2, 1, 128, d, dtype=torch.int8, device="meta")
    sc = torch.ones(2, 1, d, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fws.fused_whisper_decode_step(sw, torch.zeros(1, d, device="meta"),
                                      torch.tensor(0, device="meta"), kc, kc, k8, sc, k8, sc,
                                      n_heads=4, t_valid=64)


def bf16_round(a):
    return a.to(torch.bfloat16).float()


def attention_inputs(rng, n: int, h: int = 4, hd: int = 64):
    """q, k, v (H, hd) of the current token and a history of n rows
    (n, H, hd), f32, with scores of std ~2 so that no key dominates."""
    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return (f(h, hd, scale=0.25), f(h, hd, scale=0.25), f(h, hd), f(n, h, hd), f(n, h, hd))


@pytest.mark.parametrize("rb", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 1, 9])
@pytest.mark.parametrize("split", [1, 2, 13, 32])
def test_self_attention_chunks_match_unsplit(rng, split, pos, rb):
    """At pos 9 and 13 or 32 chunks most chunks are empty; at pos 0 all are
    and only the fresh term is left. f32: one pass a chunk, equal up to the
    order of the sums (1e-5). bf16 (`rb`): two passes, each probability
    rounded against the head's max and sum, which the split sums in another
    order, so a probability may round one bf16 step apart (1e-2)."""
    q, k, v, kh, vh = attention_inputs(rng, pos)
    rnd = bf16_round if rb else (lambda a: a)
    if rb:
        vh = bf16_round(vh)
    got = fws.self_attention_chunks(q, k, v, kh, vh, rnd, split=split, rb=rb)
    ref = fws._self_attention(q, k, v, kh, vh, rnd)
    assert got.shape == ref.shape == (4, 64)
    assert rel_err(got, ref) <= (1e-2 if rb else 1e-5)


@pytest.mark.parametrize("rb", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("t_valid", [1, 100, 1500])
@pytest.mark.parametrize("split", [1, 2, 13, 32])
def test_cross_attention_chunks_match_unsplit(rng, split, t_valid, rb):
    """int8 keys and values over t_valid of 1536 padded rows (the padding
    large codes that must not be read); at t_valid 1 every chunk but the
    first is empty."""
    h, hd, t_pad = 4, 64, 1536
    k8 = torch.from_numpy(rng.integers(-127, 128, (t_pad, h, hd), dtype=np.int8))
    v8 = torch.from_numpy(rng.integers(-127, 128, (t_pad, h, hd), dtype=np.int8))
    k8[t_valid:], v8[t_valid:] = 127, 127
    qs = torch.from_numpy((rng.standard_normal((h, hd)) * 0.02).astype(np.float32))
    vsc = torch.from_numpy((rng.random((h, hd)) * 0.01 + 1e-3).astype(np.float32))
    rnd = bf16_round if rb else (lambda a: a)
    got = fws.cross_attention_chunks(qs, k8, v8, vsc, t_valid, rnd, split=split, rb=rb)
    ref = fws._cross_attention(qs, k8, v8, vsc, t_valid, rnd)
    assert rel_err(got, ref) <= (1e-2 if rb else 1e-5)


@pytest.mark.parametrize("fault", ["drop_sum", "drop_chunk"])
@pytest.mark.parametrize("rb", [False, True], ids=["f32", "bf16"])
def test_chunk_merge_faults_are_visible(rng, rb, fault):
    """The faults chip_smoke plants in the step's merge (a chunk's sum left
    out of the head's sum; a head's last chunk left out) move the self- and
    the cross-attention far outside the tolerances above."""
    q, k, v, kh, vh = attention_inputs(rng, 200)
    rnd = bf16_round if rb else (lambda a: a)
    split = 13  # the kernel's on an H100: 2 blocks an SM x 132 SMs / 20 heads
    last = len([b for a, b in fws.chunk_bounds(200, split) if b > a]) - 1
    kw = {fault: 0 if fault == "drop_sum" else last}
    ref = fws._self_attention(q, k, v, kh, vh, rnd)
    got = fws.self_attention_chunks(q, k, v, kh, vh, rnd, split=split, rb=rb, **kw)
    assert rel_err(got, ref) > 5e-2
    k8 = torch.from_numpy(rng.integers(-127, 128, (1536, 4, 64), dtype=np.int8))
    vsc = torch.ones(4, 64)
    qs = q * 0.01
    ref = fws._cross_attention(qs, k8, k8, vsc, 1500, rnd)
    got = fws.cross_attention_chunks(qs, k8, k8, vsc, 1500, rnd, split=split, rb=rb, **kw)
    assert rel_err(got, ref) > 5e-2


def test_chunk_bounds_partition_the_keys():
    """The partition covers [0, n) in order, with empty chunks at the end."""
    for n, split in ((0, 13), (1, 2), (9, 13), (447, 13), (1500, 13), (1500, 32)):
        bounds = fws.chunk_bounds(n, split)
        assert len(bounds) == split and bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a <= b and b == c for (a, b), (c, _) in zip(bounds, bounds[1:]))


def test_step_split_cuts_apply_to_the_sources():
    """tools/step_split.py recognises the repository's sources, and each of
    its cuts changes them (its marks all match, or it would refuse)."""
    sources = step_split.read_sources(step_split.CSRC)
    name = step_split.layout(sources)
    versions = step_split.variants(sources)
    assert list(versions) == ["kernel", *step_split.LAYOUTS[name], "all cut"]
    assert versions["kernel"] == sources
    for variant, files in versions.items():
        changed = {f for f in files if files[f] != sources[f]}
        assert bool(changed) == (variant != "kernel"), variant
        assert changed <= {step_split.STEP, "decode_step.cuh"}
