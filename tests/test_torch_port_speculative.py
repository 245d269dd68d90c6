"""PyTorch port, speculative decoding and the int8 KV cache against the JAX
package on the CPU: `QuantizedKVCache` (codes and scales bit for bit),
the quantised `forward_hidden`, `warped_probs` and `mask_tokens`,
`propose_ngram` at the history's clamped edge, the accept step's emitted
marginal (a χ² test on 10⁵ rows in one batched call), and
`speculative_decode_loop` against JAX's on JAX's draws: prompt-lookup and
draft-model drafting, greedy and sampled under RAS. The generators' and
engines' speculative paths: tests/test_torch_port_speculative_engines.py.

Tiny Llama stacks (dim 64, 4 heads over 2 of hd 16, hidden 128, vocabulary
48), all f32. Tolerances: codes, scales, tokens, lengths, counters and
positions exact; stacks and probabilities rel 1e-5 (the same f32 terms
summed in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.nn import transformer as jt
from tpu_audio.ops import kvcache as jkv
from tpu_audio.ops import sampling as jsamp
from tpu_audio.ops import speculative as jspec
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.nn import transformer as tt
from tpu_audio_torch.ops import sampling as tsamp
from tpu_audio_torch.ops import speculative as tspec
from tpu_audio_torch.ops.kvcache import QuantizedKVCache
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

V = 48
LLAMA = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, hidden_dim=128,
             vocab_size=V, rope_theta=10000.0, norm_eps=1e-5)


def close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= rel * scale, np.abs(got - ref).max() / scale


def stack(seed: int, head_scale: float = 1.0, **over):
    """(JAX config, port config, JAX tree, port tree) of a tiny Llama whose
    embedding is unit-scale and head scaled by head_scale (peaked logits)."""
    kw = dict(LLAMA, **over)
    jcfg, tcfg = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = tt.numpy_params(rng, tcfg)
    tree["embed"]["weight"] = rng.standard_normal(tree["embed"]["weight"].shape, np.float32)
    tree["lm_head"]["weight"] = tree["lm_head"]["weight"] * np.float32(head_scale)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, device="cpu")


# ------------------------------------------------------------------ the int8 cache

def test_quantized_cache_matches_jax_bit_for_bit():
    """`_quantize`, a write at pos 3 of 5 rows (values over 6 decades and
    an all-zero row, the 1e-8 floor) and the dequantised read: codes and
    scales equal the JAX cache's bit for bit, reads exactly."""
    rng = np.random.default_rng(0)
    k = (rng.standard_normal((1, 5, 2, 16)) * 10.0 ** rng.integers(-3, 3, (1, 5, 2, 1))
         ).astype(np.float32)
    k[0, 2, 1] = 0.0
    v = rng.standard_normal((1, 5, 2, 16)).astype(np.float32)
    k[0, 0, 0, :4] = [0.5, -1.5, 2.5, 127.0]  # ties of round half to even, at scale 1
    jc = jkv.QuantizedKVCache.create(2, 1, 12, 2, 16)
    jc = jkv.QuantizedKVCache(k_q=jc.k_q, v_q=jc.v_q, k_s=jc.k_s, v_s=jc.v_s,
                              pos=jnp.int32(3))
    kq, vq, ks, vs = jc.update_layer(1, jnp.asarray(k), jnp.asarray(v))
    tc = QuantizedKVCache.create(2, 1, 12, 2, 16, device="cpu")
    tc.pos.fill_(3)
    tc.write(1, torch.from_numpy(k), torch.from_numpy(v))
    for got, ref in ((tc.k_q, kq), (tc.v_q, vq), (tc.k_s, ks), (tc.v_s, vs)):
        assert got.dtype == {np.int8: torch.int8, np.float32: torch.float32}[
            np.asarray(ref).dtype.type]
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    jq = jkv.QuantizedKVCache(k_q=kq, v_q=vq, k_s=ks, v_s=vs, pos=jnp.int32(8))
    for got, ref in zip(tc.read_layer(1, torch.float32), jq.read_layer(1, jnp.float32)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    q, s = QuantizedKVCache._quantize(torch.from_numpy(k))
    jq_, js_ = jkv.QuantizedKVCache._quantize(jnp.asarray(k))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js_))
    assert s.min() >= 1e-8 and tc.max_len == 12
    tc.advance(5)
    assert int(tc.pos) == 8


def test_quantized_forward_hidden_matches_jax():
    """A prefill of 7 rows then 3 one-token steps over the int8 cache,
    against the JAX quantised branch: hidden rel 1e-5, codes equal, pos."""
    jcfg, tcfg, jp, tp = stack(1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 10, 64)).astype(np.float32)
    jc = jt.make_cache(jcfg, 1, 16, quantized=True)
    tc = tt.make_cache(tcfg, 1, 16, quantized=True, device="cpu")
    assert isinstance(tc, QuantizedKVCache)
    for lo, hi in ((0, 7), (7, 8), (8, 9), (9, 10)):
        jh, jc = jt.forward_hidden(jp, jcfg, jnp.asarray(x[:, lo:hi]), jc)
        th, tc = tt.forward_hidden(tp, tcfg, torch.from_numpy(x[:, lo:hi]), tc)
        close(th, jh)
    assert int(tc.pos) == int(jc.pos) == 10
    np.testing.assert_array_equal(tc.k_q.numpy(), np.asarray(jc.k_q))
    close(tc.v_s, jc.v_s, 1e-6)


# ------------------------------------------------------------------ sampling

@pytest.mark.parametrize("ras", [False, True])
def test_warped_probs_and_mask_tokens_match(ras):
    """`warped_probs` against JAX's (repetition penalty, temperature,
    top-k with top-p, min-p; RAS's marginal) on 6 rows of logits whose
    recent windows repeat their likeliest tokens: rel 1e-5, rows sum to 1."""
    cfg = jsamp.SamplerConfig(temperature=0.8, top_k=20, top_p=0.9, min_p=0.02,
                              repetition_penalty=1.2, repetition_window=16, ras=ras,
                              ras_window=10, ras_max_repeats=2)
    tcfg = tsamp.SamplerConfig(**cfg.__dict__)
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((6, V)) * 3).astype(np.float32)
    recent = rng.integers(0, V, (6, 16)).astype(np.int32)
    for r in range(6):
        recent[r, -r - 1:] = int(np.argsort(logits[r])[-1 - r % 2])
    ref = jsamp.warped_probs(jnp.asarray(logits), cfg, jnp.asarray(recent))
    got = tsamp.warped_probs(torch.from_numpy(logits), tcfg, torch.from_numpy(recent).long())
    close(got, ref)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)
    mask = np.where(rng.random(V) < 0.3, np.float32(jsamp.NEG_INF), np.float32(0))
    np.testing.assert_array_equal(
        tsamp.mask_tokens(torch.from_numpy(logits), torch.from_numpy(mask)).numpy(),
        np.asarray(jsamp.mask_tokens(jnp.asarray(logits), jnp.asarray(mask))))


# ------------------------------------------------------------------ drafting

@pytest.mark.parametrize("hist_len", [5, 18, 20])
def test_propose_ngram_at_the_clamped_edge(hist_len):
    """Prompt lookup against JAX's: the bigram's last occurrence, the
    1-gram fallback and none, with the slice start clamped to H - gamma
    (histories of 20, the match near the end); exact."""
    h = np.array([[3, 7, 9, 3, 7, 1, 2, 3, 7, 4, 5, 6, 8, 9, 3, 7, 5, 0, 0, 0]], np.int32)
    for second, last in ((3, 7), (9, 3), (8, 7), (11, 12), (6, 8)):
        for gamma in (2, 5):
            args = (np.int32(hist_len), np.array([second], np.int32),
                    np.array([last], np.int32), gamma)
            ref = jspec.propose_ngram(jnp.asarray(h), *map(jnp.asarray, args[:3]), gamma)
            got = tspec.propose_ngram(torch.from_numpy(h).long(),
                                      torch.tensor(hist_len), torch.tensor([second]),
                                      torch.tensor([last]), gamma)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_accept_step_emits_the_target_marginal():
    """The accept step's first emitted token (x_0 if accepted, else the
    residual draw) over 10⁵ rows drawn from q: a χ² test against p at V 6,
    gamma 2 (5 dof, p-value > 1e-3), and the bonus row's draw from p_gamma
    after full acceptance (q = p)."""
    n, gamma, v = 100_000, 2, 6
    gen = torch.Generator().manual_seed(0)
    p = torch.tensor([0.30, 0.25, 0.20, 0.15, 0.07, 0.03])
    q = torch.tensor([0.05, 0.10, 0.15, 0.20, 0.25, 0.25])
    p_stack = torch.stack([p, p.flip(0), p]).expand(n, gamma + 1, v)
    q_stack = torch.stack([q, q, torch.zeros(v)]).expand(n, gamma + 1, v)
    x = torch.multinomial(q, n * gamma, replacement=True, generator=gen).reshape(n, gamma)
    u = torch.rand((n, gamma), generator=gen)
    g = tsamp.gumbel((n, v), gen, "cpu")
    n_acc, extra = tspec.accept(p_stack, q_stack, x, u, g)
    first = torch.where(n_acc > 0, x[:, 0], extra)
    counts = torch.bincount(first, minlength=v).double()
    chi2 = float(((counts - n * p.double()) ** 2 / (n * p.double())).sum())
    assert chi2 < 20.5, chi2  # χ²(5) at p-value 1e-3
    assert 0 < float((n_acc == 2).double().mean()) < 1
    full = torch.stack([p, p, p]).expand(n, 3, v).contiguous()
    n_acc, extra = tspec.accept(full, torch.cat([full[:, :2], torch.zeros(n, 1, v)], 1), x,
                                u, g)
    assert bool((n_acc == 2).all())
    counts = torch.bincount(extra, minlength=v).double()
    assert float(((counts - n * p.double()) ** 2 / (n * p.double())).sum()) < 20.5


# ------------------------------------------------------------------ the loop

def iteration_draws(key, iterations: int, gamma: int, draft: bool, sampled: bool, ras: bool,
                    v: int = V):
    """Each iteration's draws of the JAX loop from `key`, in its order: the
    draft's samples, u, the categorical's Gumbel noise."""
    out = []
    for _ in range(iterations):
        d = []
        if draft:
            for _ in range(gamma):
                key, sub = jax.random.split(key)
                if sampled:
                    ks = (sub, jax.random.fold_in(sub, 1)) if ras else (sub,)
                    g = np.stack([np.asarray(jax.random.gumbel(k, (1, v))) for k in ks])
                    d.append(torch.from_numpy(g if ras else g[0]))
        key, ku = jax.random.split(key)
        u = torch.from_numpy(np.array(jax.random.uniform(ku, (gamma,))))
        key, ke = jax.random.split(key)
        out.append({"draft": d, "u": u,
                    "g": torch.from_numpy(np.array(jax.random.gumbel(ke, (1, v))))})
    return out


SAMPLERS = {"greedy": dict(temperature=0.0),
            "ras": dict(temperature=1.0, top_k=12, top_p=0.95, ras=True, ras_window=10,
                        ras_max_repeats=1, repetition_window=24)}


@pytest.mark.parametrize("mode", ["ngram", "draft"])
@pytest.mark.parametrize("kind", ["greedy", "ras"])
def test_loop_matches_jax_on_jax_draws(mode, kind):
    """The eager loop against JAX's `speculative_decode_loop` on the same
    tiny target (and a draft: the target's tree with its head perturbed, so
    that drafts are accepted and rejected), each with its own f32 caches,
    the port fed the JAX loop's draws: tokens, lengths, iterations,
    drafted, accepted, emitted, the final target pos, last, second_last,
    the recent ring and the history equal; the draft's pos too."""
    gamma, max_new, prompt = 3, 40, [5, 9, 2, 7, 5, 9]
    jcfg, tcfg, jp, tp = stack(4, head_scale=4.0)
    sampler = jsamp.SamplerConfig(**SAMPLERS[kind])
    tsampler = tsamp.SamplerConfig(**SAMPLERS[kind])
    eos = (V - 1,)
    slots = len(prompt) + tspec.loop_slots(max_new, gamma)
    rng = np.random.default_rng(5)
    if mode == "draft":
        dtree = jax.tree.map(np.asarray, jp)
        dtree["lm_head"]["weight"] = dtree["lm_head"]["weight"] + rng.standard_normal(
            dtree["lm_head"]["weight"].shape).astype(np.float32) * np.float32(0.08)
        jdp, tdp = jax.tree.map(jnp.asarray, dtree), params_from_numpy(dtree, device="cpu")

    def jstep(params):
        def step(toks, c):
            lg, c = jt.forward(params, jcfg, toks, c)
            return lg.astype(jnp.float32), c
        return step

    def tstep(params):
        def step(toks, c):
            lg, c = tt.forward(params, tcfg, toks, c)
            return lg.float(), c
        return step

    ids = np.asarray(prompt, np.int32)[None]
    jlg, jc = jt.forward(jp, jcfg, jnp.asarray(ids), jt.make_cache(jcfg, 1, slots, jnp.float32))
    tlg, tc = tt.forward(tp, tcfg, torch.from_numpy(ids).long(),
                         tt.make_cache(tcfg, 1, slots, torch.float32, device="cpu"))
    first = jnp.argmax(jlg[:, -1], -1).astype(jnp.int32)
    assert int(first[0]) == int(tlg[:, -1].argmax(-1)[0])
    kw = dict(max_new_tokens=max_new, gamma=gamma, eos_ids=eos, pad_id=0)
    jkw, tkw = {}, {}
    if mode == "draft":
        _, jd = jt.forward(jdp, jcfg, jnp.asarray(ids), jt.make_cache(jcfg, 1, slots,
                                                                       jnp.float32))
        jd = jkv.KVCache(k=jd.k, v=jd.v, pos=jd.pos - 1)
        _, td = tt.forward(tdp, tcfg, torch.from_numpy(ids).long(),
                           tt.make_cache(tcfg, 1, slots, torch.float32, device="cpu"))
        td.pos -= 1
        jkw = dict(draft_step=jstep(jdp), draft_cache=jd)
        tkw = dict(draft_step=tstep(tdp), draft_cache=td)
    else:
        h = np.zeros((1, len(prompt) + max_new + 2 * gamma + 4), np.int32)
        h[0, :len(prompt)] = prompt
        jkw = dict(history=jnp.asarray(h), history_len=jnp.int32(len(prompt)))
        tkw = dict(history=torch.from_numpy(h).long(), history_len=torch.tensor(len(prompt)))
    key = jax.random.PRNGKey(7)
    ref = jspec.speculative_decode_loop(key, jstep(jp), jc, first, jnp.asarray(ids[:, -1]),
                                        sampler=sampler, **kw, **jkw)
    draws = iteration_draws(key, max_new, gamma, mode == "draft", kind != "greedy",
                            SAMPLERS[kind].get("ras", False))
    got = tspec.speculative_decode_loop(tstep(tp), tc, torch.from_numpy(np.asarray(first)).long(),
                                        torch.from_numpy(ids[:, -1]).long(), sampler=tsampler,
                                        draws=lambda i: draws[i], **kw, **tkw)
    for name in ("tokens", "lengths", "iterations", "drafted", "accepted", "emitted", "last",
                 "second_last", "recent", "history", "history_len", "finished"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert int(got.last_state.pos) == int(ref.last_state.pos)
    assert 0 < int(got.accepted) < int(got.drafted) or mode == "ngram" and kind == "greedy"
    if mode == "draft":
        assert int(tkw["draft_cache"].pos) == int(got.last_state.pos) - 1
        close(got.last_state.k[:, :, :int(got.last_state.pos)],
              ref.last_state.k[:, :, :int(ref.last_state.pos)])


def test_loop_refuses_a_batch_and_sampling_without_draws():
    _, tcfg, _, tp = stack(4)
    with pytest.raises(ValueError, match="single-stream"):
        tspec.speculative_decode_loop(None, None, torch.zeros(2, dtype=torch.long),
                                      torch.zeros(2, dtype=torch.long), 4, 2, (1,))
    cache = tt.make_cache(tcfg, 1, 32, torch.float32, device="cpu")

    def step(toks, c):
        lg, c = tt.forward(tp, tcfg, toks, c)
        return lg.float(), c
    with pytest.raises(ValueError, match="generator or draws"):
        tspec.speculative_decode_loop(step, cache, torch.tensor([3]), torch.tensor([2]), 4, 2,
                                      (1,), tsamp.SamplerConfig(temperature=1.0))


def test_new_modules_import_without_jax_nvcc_or_cuda():
    """The slice's modules (speculative decoding, CosyVoice3) import with
    jax blocked and no nvcc or card, and pull in nothing of the JAX
    package; chip_smoke.py names neither."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from tpu_audio_torch.ops import kvcache, sampling, speculative\n"
        "from tpu_audio_torch.models.cosyvoice3 import dit, engine, load, model\n"
        "from tpu_audio_torch.models.orpheus import engine as oe\n"
        "from tpu_audio_torch.models.outetts import engine as ue\n"
        "from tpu_audio_torch.ops.kernels import _build\n"
        "assert _build._lib is None\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'tpu_audio']\n"
        "print('ok')\n")
    env = {**os.environ, "PATH": "/nonexistent", "CUDA_HOME": "/nonexistent",
           "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    src = (root / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from jax" not in src and "tpu_audio." not in src.replace(
        "tpu_audio_torch", "")
