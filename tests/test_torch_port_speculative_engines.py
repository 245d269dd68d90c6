"""PyTorch port, the speculative paths and the int8 cache in the engines
against the JAX package on the CPU: Orpheus's `generate_speculative`
(prompt lookup and a `DraftModel`) against the JAX one greedily and
against the port's own greedy `generate` on the f32, int8 and W4A8 trees;
the Orpheus and OuteTTS engines' `speculative=`; CosyVoice2's speculative
`generate` on the JAX draws and its speculative stream against its
one-shot speculative `generate` under RAS; Marvis with `kv_quantized=True`
against the JAX engine.

Both packages' caches are f32 (the JAX builders patched), so that no bf16
rounding of a cache entry lands otherwise. Greedy decoding runs under a
strong repetition penalty (a random tied head repeats one token).
Tolerances: tokens equal; audio rel 1e-5.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_cosyvoice2 import (PROMPT_SPEECH, PROMPT_TEXT, TEXT,  # noqa: F401
                                              lm_parts)
from tests.test_torch_port_cosyvoice2 import V as CV_V
from tests.test_torch_port_cosyvoice2 import pair
from tests.test_torch_port_marvis import (MIMI, fused_params, jax_engine,  # noqa: F401
                                          jax_marvis_fused)
from tests.test_torch_port_marvis import close
from tests.test_torch_port_orpheus import PENALTY, PROMPT, SNAC, configs, engine_parts  # noqa: F401
from tests.test_torch_port_orpheus import jbase, to_torch, trees  # noqa: F401
from tests.test_torch_port_speculative import iteration_draws
from tpu_audio.codecs.mimi import model as jmimi
from tpu_audio.models.cosyvoice2 import lm as jlm
from tpu_audio.models.orpheus import model as jm
from tpu_audio.nn import transformer as jt
from tpu_audio.ops.sampling import SamplerConfig as JSampler
from tpu_audio_torch.api.tts import TTS, StreamingGranularity
from tpu_audio_torch.codecs.mimi import model as tmimi
from tpu_audio_torch.codecs.snac import model as tsnac
from tpu_audio_torch.models.cosyvoice2 import lm as tlm
from tpu_audio_torch.models.marvis.engine import MarvisEngine
from tpu_audio_torch.models.orpheus import model as tm
from tpu_audio_torch.models.outetts import engine as oengine
from tpu_audio_torch.ops.kvcache import QuantizedKVCache
from tpu_audio_torch.ops.sampling import SamplerConfig
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

GREEDY = dict(temperature=0.0, **PENALTY)


@pytest.fixture
def f32_caches(monkeypatch):
    """The JAX generators' caches in f32, as the port's here."""
    make = jt.make_cache
    monkeypatch.setattr(jt, "make_cache", lambda cfg, batch, max_len, dtype=None, **kw: make(
        cfg, batch, max_len, jnp.float32, **kw))
    monkeypatch.setattr(jt, "decode_cache_and_mask",
                        functools.partial(jt.decode_cache_and_mask, dtype=jnp.float32))


def draft_of(tree: dict, scale: float = 0.3, seed: int = 9) -> dict:
    """A draft that mostly agrees with its target: the tree with its
    embedding perturbed."""
    out = dict(tree, embed=dict(tree["embed"]))
    w = np.asarray(tree["embed"]["weight"], np.float32)
    out["embed"]["weight"] = jnp.asarray(
        w + np.random.default_rng(seed).standard_normal(w.shape).astype(np.float32) * scale)
    return out


# ------------------------------------------------------------------ Orpheus

@pytest.mark.parametrize("drafting", ["ngram", "draft"])
def test_orpheus_speculative_matches_jax_greedy(jbase, f32_caches, drafting):
    """`generate_speculative` (gamma 4) against the JAX one on the f32
    tree, greedy: the same tokens, iterations, drafted and accepted; the
    same tokens as the port's plain greedy `generate`."""
    jp = jbase[True]
    # no llama3 rope_scaling dict: the JAX generator keys its compiled
    # functions by the draft's config, which must hash
    jcfg, tcfg = configs(tie_word_embeddings=True, rope_scaling=None)
    tp = to_torch(jp)
    kw = dict(eos_ids=(1,), max_new=30, gamma=4)
    jgen = jm.CausalLMGenerator(jp, jcfg, max_cache=128)
    tgen = tm.CausalLMGenerator(tp, tcfg, max_cache=None, cache_dtype=torch.float32)
    jdraft = tdraft = None
    if drafting == "draft":
        jd = draft_of(jp)
        jdraft, tdraft = jm.DraftModel(jd, jcfg, max_cache=128), tm.DraftModel(to_torch(jd), tcfg)
    ref = jgen.generate_speculative(PROMPT, sampler=JSampler(**GREEDY), draft=jdraft, **kw)
    got = tgen.generate_speculative(PROMPT, sampler=SamplerConfig(**GREEDY), draft=tdraft, **kw)
    assert got == ref and len(got) == 30
    for name in ("iterations", "drafted", "accepted"):
        assert tgen.last_spec_stats[name] == jgen.last_spec_stats[name], name
    if drafting == "draft":
        assert 0 < tgen.last_spec_stats["accepted"] < tgen.last_spec_stats["drafted"]
    plain = tgen.generate(PROMPT, sampler=SamplerConfig(**GREEDY), eos_ids=(1,), max_new=30)
    assert got == plain


@pytest.mark.parametrize("kind", ["int8", "w4a8"])
def test_orpheus_speculative_equals_greedy_generate_on_quantised_trees(jbase, kind):
    """On the int8 and W4A8 trees the verify runs every linear at gamma + 1
    rows (the int8 and W4A8 matmuls' plain versions): greedy speculative
    tokens, by prompt lookup and by a draft (the same tree), equal the
    plain greedy `generate`'s (the whole-stack step, or per layer)."""
    _, tp, tied = trees(jbase, kind)
    _, tcfg = configs(tie_word_embeddings=tied)
    gen = tm.CausalLMGenerator(tp, tcfg, cache_dtype=torch.float32)
    kw = dict(sampler=SamplerConfig(**GREEDY), eos_ids=(1,), max_new=24)
    plain = gen.generate(PROMPT, **kw)
    assert gen.generate_speculative(PROMPT, gamma=3, **kw) == plain
    assert gen.generate_speculative(PROMPT, gamma=3, draft=tm.DraftModel(tp, tcfg), **kw) == plain
    assert gen.last_spec_stats["accept_rate"] == 1.0  # the draft is the target
    assert gen.last_spec_stats["tokens_per_iteration"] == 4.0 or len(plain) < 24


def test_speculative_engines_run_by_sentence(engine_parts):
    """The Orpheus engine (through `TTS.orpheus`) and the OuteTTS engine
    with `speculative=`: a sentence decoded by `generate_speculative` (TOKEN
    granularity keeps the sentence path), finite audio; the bad values
    refused."""
    lp, cfg, sp = engine_parts
    snac_cfg = tsnac.SNACConfig(**SNAC)
    calls = []
    for spec in ("ngram", tm.DraftModel(lp, cfg)):
        eng = TTS.orpheus(speculative=spec, device="cpu").from_params(
            lp, cfg, sp, snac_cfg, speculative=spec, gamma=3)
        orig = eng.lm.generate_speculative
        eng.lm.generate_speculative = lambda *a, **k: calls.append(k["gamma"]) or orig(*a, **k)
        chunks = list(eng.generate_streaming("Hello there.", max_new_tokens=21))
        assert chunks[-1].is_final and all(np.isfinite(c.samples).all() for c in chunks)
    assert calls == [3, 3]
    oute = oengine.OuteTTSEngine.from_params(lp, cfg, None, None, speculative="ngram", gamma=2)
    assert oute.speculative == "ngram" and oute.gamma == 2
    with pytest.raises(ValueError, match="speculative"):
        TTS.oute(speculative=object())


# ------------------------------------------------------------------ CosyVoice2

def spec_generate_draws(seed: int, iterations: int, gamma: int):
    """(noise(0, 0): the first token's JAX draw, draws(i): the JAX loop's
    iteration i) of the JAX speculative `generate` seeded with `seed`."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    first = pair(k1)
    loop = iteration_draws(k2, iterations, gamma, False, True, True, v=CV_V)
    return (lambda c, i: first), (lambda i: loop[i])


def test_cosyvoice2_speculative_generate_matches_jax(lm_parts, f32_caches):
    """`generate(speculative="ngram")` under RAS on the JAX generator's
    draws (the first token's, then each loop iteration's u and g): the same
    tokens and counters."""
    jcfg, tcfg, jp, tp = lm_parts
    jgen = jlm.CosyLMGenerator(jp, jcfg, max_cache=256)
    ref = jgen.generate(TEXT, PROMPT_TEXT, PROMPT_SPEECH, seed=4, max_new=40,
                        speculative="ngram", gamma=3)
    gen = tlm.CosyLMGenerator(tp, tcfg, cache_dtype=torch.float32)
    noise, draws = spec_generate_draws(4, 64, 3)
    got = gen.generate(TEXT, PROMPT_TEXT, PROMPT_SPEECH, seed=4, max_new=40,
                       speculative="ngram", gamma=3, noise=noise, draws=draws)
    assert got == ref and len(got) >= 12
    for name in ("iterations", "drafted", "accepted"):
        assert gen.last_spec_stats[name] == jgen.last_spec_stats[name], name


def test_cosyvoice2_speculative_stream_equals_speculative_generate_under_ras(lm_parts):
    """The speculative streamer (spans of 10, the first 10 + 3, resumed
    across spans) against the one-shot speculative `generate` on the same
    draws, numbered across spans, under RAS: the same tokens; the counters
    summed over the spans equal the one-shot's."""
    _, tcfg, _, tp = lm_parts
    gen = tlm.CosyLMGenerator(tp, tcfg, cache_dtype=torch.float32)
    rng = np.random.default_rng(8)
    loop = [{"draft": [], "u": torch.from_numpy(rng.random(3).astype(np.float32)),
             "g": torch.from_numpy(rng.gumbel(size=(1, 63)).astype(np.float32))}
            for _ in range(80)]
    first = torch.from_numpy(rng.gumbel(size=(2, 1, 63)).astype(np.float32))
    kw = dict(max_new=64, speculative="ngram", gamma=3, noise=lambda c, i: first,
              draws=lambda i: loop[i])
    one_shot = gen.generate(TEXT, PROMPT_TEXT, PROMPT_SPEECH, **kw)
    stats = dict(gen.last_spec_stats)
    streamer = tlm.CosyLMStreamer(gen, chunk=10, first_extra=3)
    spans = list(streamer.stream(TEXT, PROMPT_TEXT, PROMPT_SPEECH, **kw))
    assert sum(spans, []) == one_shot and len(one_shot) > 20 and len(spans) >= 3
    assert gen.last_spec_stats == stats
    assert stats["accepted"] > 0


# ------------------------------------------------------------------ Marvis

def test_marvis_int8_cache_matches_jax(jax_marvis_fused):
    """`kv_quantized=True` at the whole-stack step's widths: the backbone
    runs per layer over the int8 cache (no fused backbone), the depth
    decoder keeps the whole-stack step; FRAME audio equal to the JAX
    engine's with its int8 cache, greedy, at eight codebooks."""
    jcfg, jp, tcfg, tp = fused_params("fp", 5)
    mimi8 = {**MIMI, "n_q": 8}
    jmi = jmimi.init_params(jax.random.PRNGKey(0), jmimi.MimiConfig(**mimi8))
    tmi = tmimi.params_from_numpy(jax.tree.map(np.asarray, jmi), "cpu")
    eng = MarvisEngine.from_params(tp, tcfg, tmi, tmimi.MimiConfig(**mimi8), max_frames=7,
                                kv_quantized=True)
    eng.quality, eng.temperature = "low", 0.0
    ref = jax_engine(jp, jcfg, jmi, 7, "low", mimi=mimi8)
    ref.kv_quantized = True
    assert (eng._depth_fused, eng._bb_fused) == (True, False)
    caches = []
    orig = eng._prefill

    def spy(*a, **k):
        out = orig(*a, **k)
        caches.append(out[1])
        return out
    eng._prefill = spy
    got = np.concatenate([c.samples for c in eng.generate_streaming(
        "Hello there.", granularity=StreamingGranularity.FRAME)])
    want = np.concatenate([c.samples for c in ref.generate_streaming("Hello there.")])
    assert isinstance(caches[0], QuantizedKVCache)
    assert got.shape == want.shape == (7 * tmimi.MimiConfig(**MIMI).hop,)
    close(got, want)
