"""PyTorch port, the shared LLM decoder against the JAX package on the
CPU: `rope`, `rms_norm`, GQA `attend` and the masks, `forward_hidden` on
`KVCache` and on `FusedKVCache`, the plain whole-stack decode step against
the Pallas kernel in interpret mode, `sample` with the JAX package's own
noise, `decode_loop`, and the builders' card default.

Tiny stacks only (dim 128, 2 layers, 2 heads over 1 KV head, hd 64 or 128,
hidden 512): the shapes the kernel's gate takes. All f32. Tolerances:
elementwise functions 1e-6 of max|ref|; stacks 1e-5 (the same f32 terms
summed in another order); token ids and sampled tokens exact.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.nn import attention as jattn
from tpu_audio.nn import layers as jlayers
from tpu_audio.nn import rope as jrope
from tpu_audio.nn import transformer as jt
from tpu_audio.ops import decoding as jdec
from tpu_audio.ops import quant as jquant
from tpu_audio.ops import sampling as jsamp
from tpu_audio.ops.pallas import fused_step as jfs
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.funasr import model as tfmodel
from tpu_audio_torch.nn import attention as tattn
from tpu_audio_torch.nn import layers as tlayers
from tpu_audio_torch.nn import rope as trope
from tpu_audio_torch.nn import transformer as tt
from tpu_audio_torch.ops import decoding as tdec
from tpu_audio_torch.ops import sampling as tsamp
from tpu_audio_torch.ops.kernels import fused_step as fs
from tpu_audio_torch.ops.kvcache import FusedKVCache, QuantizedKVCache
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

LLM = dict(dim=128, n_layers=2, n_heads=2, n_kv_heads=1, hidden_dim=512, vocab_size=300,
           qk_norm=True, tie_word_embeddings=True, norm_eps=1e-6, rope_theta=1e6)


@pytest.fixture
def jax_fused(monkeypatch):
    """Turn the JAX package's whole-stack decode kernel on, in interpret
    mode: its gates test for a TPU backend and probe a compile, and a
    parity test that left them off would compare plain with plain."""
    monkeypatch.setattr(jfs, "fused_decode_step",
                        functools.partial(jfs.fused_decode_step, interpret=True))
    orig = jfs.choose_mode

    def choose_mode(*args, **kwargs):  # its shape rules, past the backend test
        backend = jax.default_backend
        jax.default_backend = lambda: "tpu"
        try:
            return orig(*args, **kwargs)
        finally:
            jax.default_backend = backend

    monkeypatch.setattr(jfs, "choose_mode", choose_mode)
    monkeypatch.setattr(jt, "fused_decode_supported", lambda *a, **k: True)


def close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, err


def configs(**over):
    kw = {**LLM, **over}
    return jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)


def to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("scaling", [None, {"rope_type": "llama3", "factor": 8.0,
                                            "original_max_position_embeddings": 64}])
def test_apply_rope_matches(rng, scaling):
    inv_j = jrope.make_inv_freq(64, 10000.0, scaling)
    inv_t = trope.make_inv_freq(64, 10000.0, scaling)
    np.testing.assert_array_equal(inv_t, inv_j)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    for pos in (np.arange(5) + 7, np.stack([np.arange(5), np.arange(5) + 40])):
        close(trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), inv_t),
              jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), inv_j), rel=1e-6)


def test_rms_norm_matches(rng):
    x = rng.standard_normal((3, 7, 128)).astype(np.float32) * 4
    w = rng.standard_normal(128).astype(np.float32)
    close(tlayers.rms_norm({"weight": torch.from_numpy(w)}, torch.from_numpy(x), 1e-6),
          jlayers.rms_norm({"weight": jnp.asarray(w)}, jnp.asarray(x), 1e-6), rel=1e-6)


@pytest.mark.parametrize("hkv", [1, 2, 4])
def test_attend_gqa_and_masks_match(rng, hkv):
    q = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 9, hkv, 32)).astype(np.float32) for _ in range(2))
    lengths = np.array([9, 6])
    jmask = jattn.padding_mask(jnp.asarray(lengths), 9) + jattn.causal_mask(5, 9, offset=4)
    tmask = (tattn.padding_mask(torch.from_numpy(lengths), 9)
             + tattn.causal_mask(5, 9, offset=4, device="cpu"))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    ref = jattn.attend(*(jnp.asarray(a) for a in (q, k, v)), jmask)
    got = tattn.attend(*(torch.from_numpy(a) for a in (q, k, v)), tmask, scale=32 ** -0.5)
    close(got, ref, rel=1e-6)


def _prefill_case(rng, jcfg, tcfg, fused: bool):
    jp = jt.init_params(jax.random.PRNGKey(3), jcfg)
    tp = to_torch(jp)
    x = rng.standard_normal((1, 6, jcfg.dim)).astype(np.float32)
    start = 2
    if fused:
        jc = jt.make_fused_cache(jcfg, 16, jnp.float32, start=start)
        tc = tt.make_fused_cache(tcfg, 16, torch.float32, start=start, device="cpu")
        jm = tm = None
    else:
        jc, jm = jt.decode_cache_and_mask(jcfg, 16, start, False, jnp.float32)
        tc, tm = tt.decode_cache_and_mask(tcfg, 16, start, False, torch.float32, device="cpu")
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    off = np.array([start])
    jh, jc = jt.forward_hidden(jp, jcfg, jnp.asarray(x), jc, jm, pos_offset=jnp.asarray(off))
    th, tc = tt.forward_hidden(tp, tcfg, torch.from_numpy(x), tc, tm,
                               pos_offset=torch.from_numpy(off))
    close(th, jh)
    close(tc.k, jc.k)
    close(tc.v, jc.v)
    assert int(tc.pos) == int(jc.pos) == 6
    return jp, tp, jc, tc, jm, tm


@pytest.mark.parametrize("head_dim", [64, 128])
def test_forward_hidden_prefill_and_steps_on_kvcache_match(rng, head_dim):
    """Prefill with a left-pad mask and pos_offset, then three steps."""
    jcfg, tcfg = configs(head_dim=head_dim)
    jp, tp, jc, tc, jm, tm = _prefill_case(rng, jcfg, tcfg, fused=False)
    for tok in (5, 17, 299):
        jl, jc = jt.forward(jp, jcfg, jnp.asarray([[tok]]), jc, jm)
        tl, tc = tt.forward(tp, tcfg, torch.tensor([[tok]]), tc, tm)
        close(tl, jl)
    close(tc.k, jc.k)


def test_forward_hidden_prefill_on_fused_cache_matches(rng):
    """Prefill on FusedKVCache runs the per-layer path on a layout view of
    the cache (in place here), with slots < start masked."""
    jcfg, tcfg = configs(head_dim=64)
    _prefill_case(rng, jcfg, tcfg, fused=True)


def test_fused_steps_match_the_pallas_kernel_end_to_end(rng, jax_fused):
    """forward on a FusedKVCache: three single-token steps through the JAX
    kernel (interpret mode) and the port's plain step, and one 2-token step
    (two launches), against the JAX stack."""
    jcfg, tcfg = configs(head_dim=128)
    jp = jt.fuse_fp_tree(jt.init_params(jax.random.PRNGKey(5), jcfg))
    tp = to_torch(jp)
    assert tt.fused_decode_supported(tcfg, tp)
    jc = jt.make_fused_cache(jcfg, 16, jnp.float32, start=1)
    tc = tt.make_fused_cache(tcfg, 16, torch.float32, start=1, device="cpu")
    x = rng.standard_normal((1, 5, jcfg.dim)).astype(np.float32)
    _, jc = jt.forward_hidden(jp, jcfg, jnp.asarray(x), jc)
    _, tc = tt.forward_hidden(tp, tcfg, torch.from_numpy(x), tc)
    for toks in ([[3]], [[40]], [[299]], [[7, 8]]):
        jl, jc = jt.forward(jp, jcfg, jnp.asarray(toks), jc)
        tl, tc = tt.forward(tp, tcfg, torch.tensor(toks), tc)
        close(tl, jl)
    close(tc.k, jc.k)
    close(tc.v, jc.v)
    assert int(tc.pos) == int(jc.pos) == 10


def _step_trees(rng, int8: bool, **over):
    jcfg, tcfg = configs(**over)
    jp = jt.init_params(jax.random.PRNGKey(7), jcfg)
    if int8:
        jp = jquant.fuse_int8_tree(jquant.quantize_tree_int8(
            jp, predicate=lambda k, v: k.startswith("layers.")))
    else:
        jp = jt.fuse_fp_tree(jp)
    # random norm weights, so that a norm applied in the wrong place shows
    lp = jp["layers"]
    for name in ("ln1", "ln2"):
        lp[name]["weight"] = jnp.asarray(1 + 0.3 * rng.standard_normal(
            lp[name]["weight"].shape).astype(np.float32))
    if "q_norm" in lp["attn"]:
        for name in ("q_norm", "k_norm"):
            lp["attn"][name]["weight"] = jnp.asarray(1 + 0.3 * rng.standard_normal(
                lp["attn"][name]["weight"].shape).astype(np.float32))
    return jcfg, tcfg, jp, to_torch(jp)


@pytest.mark.parametrize("int8,head_dim,over,grouped", [
    (False, 128, {}, False),
    (True, 128, {"n_heads": 4, "n_kv_heads": 2}, True),
    (False, 64, {"n_heads": 4, "n_kv_heads": 2}, False),
    (False, 64, {"qk_norm": False, "attn_qkv_bias": True}, False),
    (True, 64, {"qk_norm": False, "attn_qkv_bias": True}, False),
])
def test_fused_step_plain_matches_pallas(rng, int8, head_dim, over, grouped):
    """Five steps from pos 9 with start 3: h, and the cache slots written
    (the JAX kernel returns them; the port writes them in place). Two KV
    heads of two query heads each in two cases, so that a wrong head
    mapping shows."""
    jcfg, tcfg, jp, tp = _step_trees(rng, int8, head_dim=head_dim, **over)
    jstack = jfs.prepare_stack(jp, jcfg)
    tstack = fs.prepare_stack(tp)
    assert ("qknorm" in tstack) == jcfg.qk_norm and ("bqkv" in tstack) == jcfg.attn_qkv_bias
    shape = (jcfg.n_layers, jcfg.kv_heads, 20, head_dim)
    kc = np.zeros(shape, np.float32)
    vc = np.zeros(shape, np.float32)
    kc[:, :, :9] = rng.standard_normal((*shape[:2], 9, head_dim)) * 2
    vc[:, :, :9] = rng.standard_normal((*shape[:2], 9, head_dim))
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    start = 3
    for pos in range(9, 14):
        x = rng.standard_normal((1, jcfg.dim)).astype(np.float32)
        jcos, jsin = jfs.make_cos_sin(pos, jcfg.inv_freq(), head_dim)
        tcos, tsin = fs.make_cos_sin(torch.tensor(pos), tcfg.inv_freq())
        close(tcos[None], jcos, rel=1e-6)
        jh, jk, jv = jfs.fused_decode_step(
            jnp.asarray(x), pos, jcos, jsin, jstack, jk, jv, start=start, grouped=grouped,
            n_heads=jcfg.n_heads, n_kv_heads=jcfg.kv_heads, hd=head_dim, eps=jcfg.norm_eps,
            interpret=True)
        th = fs.fused_decode_step(tstack, torch.from_numpy(x), torch.tensor(pos),
                                  torch.tensor(start), tcos, tsin, tk, tv,
                                  n_heads=tcfg.n_heads, n_kv_heads=tcfg.kv_heads,
                                  hd=head_dim, eps=tcfg.norm_eps)
        assert th.dtype == torch.float32
        close(th, jh)
    close(tk, jk)
    close(tv, jv)


@pytest.mark.parametrize("cfg", [
    jsamp.SamplerConfig(temperature=0.0, repetition_penalty=1.3),
    jsamp.SamplerConfig(temperature=0.7, top_k=50),
    jsamp.SamplerConfig(temperature=1.0, top_p=0.9, repetition_penalty=1.2),
    jsamp.SamplerConfig(temperature=0.8, top_k=40, top_p=0.8, min_p=0.05),
])
def test_sample_matches_with_jax_noise(rng, cfg):
    """The JAX draw is argmax(warped + gumbel(key)); the port takes the
    same Gumbel noise, so the tokens agree exactly (V 1000: below the JAX
    module's approximate top-k)."""
    logits = (rng.standard_normal((3, 1000)) * 3).astype(np.float32)
    recent = np.full((3, 8), -1, np.int64)
    recent[0, -3:] = [5, int(logits[0].argmax()), 0]
    recent[1, -1] = int(logits[1].argmax())
    tcfg = tsamp.SamplerConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref = jsamp.sample(key, jnp.asarray(logits), cfg, jnp.asarray(recent, jnp.int32))
        noise = torch.from_numpy(np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32)))
        got = tsamp.sample(torch.from_numpy(logits), tcfg, torch.from_numpy(recent), noise=noise)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tsamp.update_recent(torch.from_numpy(recent), torch.tensor([1, 2, 3])).numpy(),
        np.asarray(jsamp.update_recent(jnp.asarray(recent), jnp.asarray([1, 2, 3]))))


@pytest.mark.parametrize("max_new,early_exit", [(20, True), (5, True), (12, False)])
def test_decode_loop_matches(max_new, early_exit):
    """A fixed next-token table as the model, greedy with a repetition
    penalty: tokens, lengths (EOS excluded, padding after it), the recent
    ring, `finished` and the last token equal the JAX loop's, with the
    port's early exit only every 8 steps."""
    table = np.random.default_rng(1).standard_normal((50, 50)).astype(np.float32)
    table[7, 2] = table[9, 2] = 20.0   # row 0 reaches EOS 2 via token 7 or 9
    table[:, 3] -= 30.0
    first = np.array([7, 11])
    cfg = dict(temperature=0.0, repetition_penalty=1.5, repetition_window=6)

    def jstep(tok, state):
        return jnp.asarray(table)[tok[:, 0]], state + 1

    def tstep(tok, state):
        return torch.from_numpy(table)[tok[:, 0]], state + 1

    ref = jdec.decode_loop(jax.random.PRNGKey(0), jstep, jnp.int32(0), jnp.asarray(first),
                           max_new, eos_ids=(2, 3), sampler=jsamp.SamplerConfig(**cfg),
                           pad_id=2, early_exit=early_exit)
    got = tdec.decode_loop(tstep, 0, torch.from_numpy(first), max_new, eos_ids=(2, 3),
                           sampler=tsamp.SamplerConfig(**cfg), pad_id=2, early_exit=early_exit)
    for name in ("tokens", "lengths", "recent", "finished", "last_token"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def test_decode_loop_hooks_and_resume_match():
    """min_tokens, a logit processor that reads the step and the recent
    ring, a token post-process, and a second span resumed from the first
    one's ring and `finished` flags: the same tokens, lengths and state."""
    table = np.random.default_rng(2).standard_normal((40, 40)).astype(np.float32)
    table[:, 2] += 1.5
    first = np.array([4, 9, 13])
    cfg = dict(temperature=0.0, repetition_penalty=1.2, repetition_window=5)

    def run(lib, arr, step_fn, proc, post, **kw):
        return lib.decode_loop(*kw.pop("lead"), step_fn, kw.pop("state"), arr(first), 10,
                               eos_ids=(2,), min_tokens=3, logit_processor=proc,
                               token_postprocess=post, pad_id=0, **kw)

    def jproc(logits, i, recent):
        return logits + 0.5 * (jnp.arange(40) == (i % 7)) - 0.1 * (recent[:, -1:] == 5)

    def tproc(logits, i, recent):
        return logits + 0.5 * (torch.arange(40) == (i % 7)) - 0.1 * (recent[:, -1:] == 5)

    jcfg, tcfg = jsamp.SamplerConfig(**cfg), tsamp.SamplerConfig(**cfg)
    jkw = dict(lead=(jax.random.PRNGKey(0),), state=jnp.int32(0), sampler=jcfg)
    tkw = dict(lead=(), state=0, sampler=tcfg)
    ref = run(jdec, jnp.asarray, lambda tok, st: (jnp.asarray(table)[tok[:, 0]], st + 1),
              jproc, lambda tok, i: jnp.where(tok == 7, 8, tok), **jkw)
    got = run(tdec, torch.from_numpy, lambda tok, st: (torch.from_numpy(table)[tok[:, 0]], st + 1),
              tproc, lambda tok, i: torch.where(tok == 7, 8, tok), **tkw)
    names = ("tokens", "lengths", "recent", "finished", "last_token")
    for name in names:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    ref2 = run(jdec, jnp.asarray, lambda tok, st: (jnp.asarray(table)[tok[:, 0]], st + 1),
               jproc, None, recent0=ref.recent, finished0=ref.finished, **jkw)
    got2 = run(tdec, torch.from_numpy, lambda tok, st: (torch.from_numpy(table)[tok[:, 0]], st + 1),
               tproc, None, recent0=got.recent, finished0=got.finished, **tkw)
    for name in names:
        np.testing.assert_array_equal(getattr(got2, name).numpy(),
                                      np.asarray(getattr(ref2, name)), err_msg=name)


def test_builders_default_to_the_card():
    """The slice's builders build on the card unless the caller asks for
    the CPU; without a card, leaving the device out fails."""
    for fn in (tfmodel.init_params, FusedKVCache.create, tt.make_cache, tt.make_fused_cache,
               tt.init_params, tt.decode_cache_and_mask):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        _, tcfg = configs()
        with pytest.raises((RuntimeError, AssertionError)):
            FusedKVCache.create(1, 4, 1, 64)
        with pytest.raises((RuntimeError, AssertionError)):
            tt.make_cache(tcfg, 1, 4)


def test_unported_parts_raise():
    _, tcfg = configs()
    # the int8 cache is ported (ROADMAP A9); tensor parallelism too (A19):
    # axis_name is the tp process group, and a name is refused, named
    assert isinstance(tt.make_cache(tcfg, 1, 4, quantized=True, device="cpu"),
                      QuantizedKVCache)
    cache = tt.make_cache(tcfg, 1, 4, device="cpu")
    with pytest.raises(TypeError, match="axis_name must be the tp process group.*'tp'"):
        tt.forward_hidden({}, tcfg, torch.zeros(1, 1, 128), cache, axis_name="tp")
    # RAS is ported (ROADMAP A11); its options without a recent window draw plainly
    assert tsamp.sample(torch.zeros(1, 10), tsamp.SamplerConfig(ras=True),
                        noise=torch.arange(10.0)[None]).tolist() == [9]
