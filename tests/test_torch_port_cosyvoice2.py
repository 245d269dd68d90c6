"""PyTorch port, CosyVoice2's LM (tpu_audio_torch/models/cosyvoice2/lm.py,
RAS in ops/sampling.py) against the JAX package on the CPU: RAS, the
whole-stack step on Qwen2's head layout, the generator's and the
streamer's tokens, the streamer against the one-shot generate
under RAS, ROADMAP C18, the A9 options, the imports without JAX. The
synthesis and the engine: tests/test_torch_port_cosyvoice2_engine.py.

A tiny Qwen2 of the real head layout (dim 384, 2 layers, 6 query heads over
2 KV heads of hd 64, a group of 3, qkv bias, hidden 512, tied vocabulary
400; 60 speech tokens + 3 specials). The JAX package's draws are injected:
its `sample` is argmax(warped + gumbel(key)) and RAS's redraw uses
gumbel(fold_in(key, 1)). Both caches are f32 here (the JAX
generator's `decode_cache_and_mask` is patched to f32), so that no bf16
rounding of a cache entry lands differently in the two packages.

Tolerances: tokens equal; the whole-stack step rel 1e-5 (f32, another
order of the same sums).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_llm import jax_fused  # noqa: F401
from tests.test_torch_port_s3 import close, t
from tpu_audio.models.cosyvoice2 import lm as jlm
from tpu_audio.nn import transformer as jt
from tpu_audio.ops import sampling as jsamp
from tpu_audio.ops.pallas import fused_step as jfs
from tpu_audio_torch.api.tts import TTS
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.cosyvoice2 import engine as tengine
from tpu_audio_torch.models.cosyvoice2 import lm as tlm
from tpu_audio_torch.nn import transformer as tt
from tpu_audio_torch.ops import sampling as tsamp
from tpu_audio_torch.ops.kernels import fused_step as fs
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

QWEN = dict(dim=384, n_layers=2, n_heads=6, n_kv_heads=2, head_dim=64, hidden_dim=512,
            vocab_size=400, attn_qkv_bias=True, tie_word_embeddings=True, norm_eps=1e-6,
            rope_theta=1e6)
LM = dict(llm_input_size=384, speech_token_size=60)
V = LM["speech_token_size"] + 3
TEXT, PROMPT_TEXT, PROMPT_SPEECH = [5, 6, 7, 8, 9, 10], [20, 21], [3, 4, 5, 6, 7]


def lm_configs():
    return (jlm.CosyLMConfig(qwen=jt.TransformerConfig(**QWEN), **LM),
            tlm.CosyLMConfig(qwen=tt.TransformerConfig(**QWEN), **LM))


@pytest.fixture(scope="module")
def lm_parts():
    """The JAX LM tree with unit-scale embeddings and a head scaled up, so
    that the speech logits are peaked and tokens repeat (RAS redraws), the
    specials' made unlikely so that EOS comes late."""
    jcfg, tcfg = lm_configs()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    for name in ("speech_embedding", "llm_embedding"):
        jp[name]["weight"] = jnp.asarray(rng.standard_normal(jp[name]["weight"].shape)
                                         .astype(np.float32))
    jp["llm"]["embed"]["weight"] = jnp.asarray(
        rng.standard_normal((QWEN["vocab_size"], QWEN["dim"])).astype(np.float32))
    n = LM["speech_token_size"]
    jp["llm_decoder"]["weight"] = (jp["llm_decoder"]["weight"] * 8).at[n:].multiply(0.1)
    jp["llm_decoder"]["bias"] = jp["llm_decoder"]["bias"].at[n:].add(-2.0)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture
def f32_cache(monkeypatch):
    """The JAX generator's caches in f32, as the port's here."""
    monkeypatch.setattr(jt, "decode_cache_and_mask",
                        functools.partial(jt.decode_cache_and_mask, dtype=jnp.float32))


def pair(key):
    """A RAS step's two JAX draws, (2, 1, V)."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(k, (1, V), jnp.float32))
                                      for k in (key, jax.random.fold_in(key, 1))]))


def loop_draws(key, n):
    """The draws of a JAX decode_loop seeded with key, step by step."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(pair(sub))
    return out


def generate_draws(seed: int, n: int):
    """noise(0, i) of the JAX `generate`: the first token's, then the loop's."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    draws = [pair(k1)] + loop_draws(k2, n)
    return lambda c, i: draws[i]


def stream_draws(seed: int, sizes, extra: int = 8):
    """noise(c, i) of the JAX `CosyLMStreamer.stream`: chunk c's key split
    from the seed's, its first token's draw, then its loop's."""
    key, chunks = jax.random.PRNGKey(seed), []
    for size in sizes:
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        chunks.append([pair(k1)] + loop_draws(k2, size - 1 + extra))
    return lambda c, i: chunks[c][i]


# ------------------------------------------------------------------ RAS

def test_ras_sample_and_warped_probs_match():
    """RAS against the JAX `sample` on the same key: 40 rows of random
    logits whose recent windows repeat a token; the redraw taken where the
    JAX one is; tokens equal."""
    cfg = jsamp.SamplerConfig(temperature=1.0, top_k=25, top_p=0.8, ras=True, ras_window=10,
                              ras_max_repeats=2)
    tcfg = tsamp.SamplerConfig(**cfg.__dict__)
    rng = np.random.default_rng(2)
    redrawn = 0
    for s in range(40):
        logits = (rng.standard_normal((1, V)) * 3).astype(np.float32)
        top = int(np.argmax(logits))
        recent = np.full((1, 64), -1, np.int32)
        recent[0, -10:] = rng.integers(0, V, 10)
        recent[0, -10: -10 + s % 5] = top  # 0-4 repeats of the likeliest token
        key = jax.random.PRNGKey(s)
        ref = int(jsamp.sample(key, jnp.asarray(logits), cfg, jnp.asarray(recent))[0])
        got = int(tsamp.sample(t(logits), tcfg, torch.as_tensor(recent).long(),
                               noise=pair(key))[0])
        assert got == ref, s
        plain = int(jnp.argmax(jsamp.warp_logits(jnp.asarray(logits), cfg, jnp.asarray(recent))
                               + jax.random.gumbel(key, (1, V))))
        redrawn += plain != ref
    assert redrawn > 3
    gen = torch.Generator().manual_seed(0)
    assert tsamp.sample(torch.zeros(2, V), tcfg, torch.full((2, 10), -1), gen).shape == (2,)


# ------------------------------------------------------------------ the step

@pytest.mark.parametrize("int8", [False, True])
def test_whole_stack_step_on_the_qwen2_layout_matches_pallas(int8, jax_fused):  # noqa: F811
    """The plain whole-stack step on Qwen2's head layout (qkv bias, a GQA
    group of 3) against the JAX kernel in interpret mode, five steps from
    pos 9 with start 3: h and the written cache slots within rel 1e-5."""
    from tests.test_torch_port_llm import _step_trees

    rng = np.random.default_rng(3)
    over = {k: QWEN[k] for k in ("dim", "n_heads", "n_kv_heads")}
    jcfg, tcfg, jp, tp = _step_trees(rng, int8, head_dim=64, qk_norm=False,
                                     attn_qkv_bias=True, **over)
    jstack, tstack = jfs.prepare_stack(jp, jcfg), fs.prepare_stack(tp)
    assert "bqkv" in tstack and tcfg.n_heads // tcfg.kv_heads == 3
    shape = (jcfg.n_layers, jcfg.kv_heads, 20, 64)
    kc = (rng.standard_normal(shape) * 2).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    jk, jv, tk, tv = jnp.asarray(kc), jnp.asarray(vc), t(kc), t(vc)
    for pos in range(9, 14):
        x = rng.standard_normal((1, jcfg.dim)).astype(np.float32)
        jcos, jsin = jfs.make_cos_sin(pos, jcfg.inv_freq(), 64)
        tcos, tsin = fs.make_cos_sin(torch.tensor(pos), tcfg.inv_freq())
        jh, jk, jv = jfs.fused_decode_step(jnp.asarray(x), pos, jcos, jsin, jstack, jk, jv,
                                           start=3, n_heads=jcfg.n_heads,
                                           n_kv_heads=jcfg.kv_heads, hd=64, eps=jcfg.norm_eps,
                                           interpret=True)
        th = fs.fused_decode_step(tstack, t(x), torch.tensor(pos), torch.tensor(3), tcos, tsin,
                                  tk, tv, n_heads=tcfg.n_heads, n_kv_heads=tcfg.kv_heads, hd=64,
                                  eps=tcfg.norm_eps)
        close(th, jh, 1e-5)
    close(tk, jk, 1e-5)
    close(tv, jv, 1e-5)


# ------------------------------------------------------------------ the LM

def test_generate_tokens_match_with_jax_draws(lm_parts, f32_cache):
    """`CosyLMGenerator.generate` under RAS on the JAX generator's own
    draws: the same tokens (the port's T=1 steps through the plain
    whole-stack step, the JAX ones per layer)."""
    jcfg, tcfg, jp, tp = lm_parts
    ref = jlm.CosyLMGenerator(jp, jcfg, max_cache=256).generate(
        TEXT, PROMPT_TEXT, PROMPT_SPEECH, seed=4, max_new=40)
    gen = tlm.CosyLMGenerator(tp, tcfg, cache_dtype=torch.float32)
    assert gen.fused_ok()
    got = gen.generate(TEXT, PROMPT_TEXT, PROMPT_SPEECH, seed=4, max_new=40,
                       noise=generate_draws(4, 80))
    assert got == ref and len(got) >= 12


def test_streamer_chunks_match_jax_and_equal_one_shot_under_ras(lm_parts, f32_cache):
    """The chunked streamer (chunks of 10, the first 10 + 3) against the
    JAX streamer on its draws; then, on draws keyed by the token's
    position, the port's chunks joined against its one-shot `generate`
    (the RAS ring and the cache carried across chunks: ROADMAP's note on
    ee8e8fc). Without RAS the same draws give other tokens: RAS redraws."""
    jcfg, tcfg, jp, tp = lm_parts
    jgen = jlm.CosyLMGenerator(jp, jcfg, max_cache=256)
    ref = list(jlm.CosyLMStreamer(jgen, chunk=10, first_extra=3).stream(
        TEXT, PROMPT_TEXT, PROMPT_SPEECH, seed=5, max_new=64))
    gen = tlm.CosyLMGenerator(tp, tcfg, cache_dtype=torch.float32)
    streamer = tlm.CosyLMStreamer(gen, chunk=10, first_extra=3)
    got = list(streamer.stream(TEXT, PROMPT_TEXT, PROMPT_SPEECH, seed=5, max_new=64,
                               noise=stream_draws(5, [13] + [10] * 6)))
    assert got == ref and sum(map(len, got)) > 20

    rng = np.random.default_rng(6)
    draws = [torch.from_numpy(rng.gumbel(size=(2, 1, V)).astype(np.float32))
             for _ in range(140)]
    starts = [0] + [13 + 10 * c for c in range(10)]
    chunked = sum(streamer.stream(TEXT, PROMPT_TEXT, PROMPT_SPEECH, max_new=64,
                                  noise=lambda c, i: draws[starts[c] + i]), [])
    one_shot = gen.generate(TEXT, PROMPT_TEXT, PROMPT_SPEECH, max_new=64,
                            noise=lambda c, i: draws[i])
    assert chunked == one_shot and len(one_shot) > 20
    plain = gen.generate(TEXT, PROMPT_TEXT, PROMPT_SPEECH, max_new=64,
                         sampler=tsamp.SamplerConfig(temperature=1.0, top_k=25, top_p=0.8),
                         noise=lambda c, i: draws[i][0])
    assert plain != one_shot


def test_a_512_slot_cache_refuses_a_30_token_sentence(lm_parts):
    """ROADMAP C18: the JAX engine's `max_cache=512` against a prompt of
    2 + 32 + 32 slots and max_len 20 × 30 = 600 (rounded to 608): the JAX
    cache writes clamp at the last slot; the port refuses a given cache
    that small and sizes its own for the request."""
    _, tcfg, _, tp = lm_parts
    text = list(range(30, 60))
    with pytest.raises(ValueError, match="C18"):
        tlm.CosyLMGenerator(tp, tcfg, max_cache=512).generate(text, [], PROMPT_SPEECH)
    gen = tlm.CosyLMGenerator(tp, tcfg)
    logits, cache, _ = gen.prefill(text, [], PROMPT_SPEECH, 608)
    assert cache.max_len >= 2 + 32 + 32 + 608 and logits.shape == (1, V)


def test_unported_options_raise(lm_parts):
    _, tcfg, _, tp = lm_parts
    """mesh= (ROADMAP A19) takes a DeviceMesh only; speculative= takes
    "ngram" only (A9 is ported), and CosyVoice3's factory builds its engine
    (A12)."""
    gen = tlm.CosyLMGenerator(tp, tcfg)
    with pytest.raises(ValueError, match="speculative"):
        gen.generate(TEXT, [], [], speculative="draft")
    with pytest.raises(ValueError, match="speculative"):
        next(tlm.CosyLMStreamer(gen).stream(TEXT, [], [], speculative="draft"))
    with pytest.raises(TypeError, match="mesh must be a torch DeviceMesh.*got object"):
        tlm.CosyLMGenerator(tp, tcfg, mesh=object())
    with pytest.raises(TypeError, match="mesh must be a torch DeviceMesh.*got object"):
        TTS.cosyvoice2(mesh=object())
    with pytest.raises(ValueError, match="speculative"):
        TTS.cosyvoice2(speculative="draft")
    assert TTS.cosyvoice2(speculative="ngram", device="cpu").speculative == "ngram"
    with pytest.raises(ValueError, match="quantization"):
        TTS.cosyvoice2(quantization="int3")
    from tpu_audio_torch.models.cosyvoice3.engine import CosyVoice3Engine
    assert isinstance(TTS.cosyvoice3(device="cpu"), CosyVoice3Engine)
    assert isinstance(TTS.cosyvoice2(device="cpu"), tengine.CosyVoice2Engine)
    assert TTS.cosyvoice2().device == "cuda"


def test_slice_modules_import_without_jax_nvcc_or_cuda():
    """The slice's modules import with jax blocked and no nvcc or card,
    and build nothing at import."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from tpu_audio_torch.api import tts\n"
        "from tpu_audio_torch.codecs.s3gen import campplus, conformer, flow, hift, model, noise\n"
        "from tpu_audio_torch.codecs.s3tokenizer import load, model\n"
        "from tpu_audio_torch.models.cosyvoice2 import engine, lm, load, streaming\n"
        "from tpu_audio_torch.ops import frontends, sampling, stft\n"
        "from tpu_audio_torch.ops.kernels import _build\n"
        "assert _build._lib is None\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'tpu_audio']\n"
        "print('ok')\n")
    env = {**os.environ, "PATH": "/nonexistent", "CUDA_HOME": "/nonexistent",
           "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
