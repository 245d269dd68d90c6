"""PyTorch port, CosyVoice2's synthesis (tpu_audio_torch/models/cosyvoice2/
streaming.py, engine.py, load.py) against the JAX package on the CPU:
`CV2Synthesizer.stream`, the engine's speaker, voice conversion, token2wav
and modes, its token and sentence streaming, every public default, and
`load()` from a checkpoint the test writes.

The LM is tests/test_torch_port_cosyvoice2.py's tiny Qwen2 with the S3
tokenizer's 6561 speech tokens; S3Gen and the S3 tokenizer are
tests/test_torch_port_s3.py's tiny ones; the JAX draws are injected as
there. Tolerances: tokens equal, mels and x-vectors rel 1e-4, waveforms rel
2e-3 (HiFT's phase cumsum, see tests/test_torch_port_s3.py), converted
leaves bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_port_cosyvoice2 import PROMPT_SPEECH, QWEN, TEXT, lm_configs
from tests.test_torch_port_s3 import (HIFT_REL, TOK, JaxNoise, close, gen_parts,  # noqa: F401
                                      s3gen_configs, t, to_torch)
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401
from tpu_audio.codecs.s3tokenizer import model as js3model
from tpu_audio.models.cosyvoice2 import engine as jengine
from tpu_audio.models.cosyvoice2 import load as jload
from tpu_audio.models.cosyvoice2 import streaming as jstreaming
from tpu_audio.ops import quant as jquant
from tpu_audio_torch.api.tts import TTS, StreamingGranularity
from tpu_audio_torch.codecs.s3tokenizer import model as ts3tok
from tpu_audio_torch.convert import params_from_numpy, s3_params_from_numpy
from tpu_audio_torch.models.cosyvoice2 import engine as tengine
from tpu_audio_torch.models.cosyvoice2 import lm as tlm
from tpu_audio_torch.models.cosyvoice2 import load as tload
from tpu_audio_torch.models.cosyvoice2 import streaming as tstreaming
from tpu_audio_torch.nn import transformer as tt
from tpu_audio_torch.utils import pytree


# ------------------------------------------------------------------ streaming

def test_synthesizer_stream_matches_jax(gen_parts):  # noqa: F811
    """`CV2Synthesizer.stream` on the same 70 tokens in chunks of 28, 25, 17,
    a 6-token prompt, windows capped at 40 tokens with a rebase of 10 (the
    retire path runs), the JAX draws: every emitted chunk within rel 2e-3."""
    jcfg, tcfg, jp, tp = gen_parts
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 64, 70).tolist()
    chunks = [toks[:28], toks[28:53], toks[53:]]
    pt = rng.integers(0, 64, 6).tolist()
    pm = rng.standard_normal((1, 12, 16)).astype(np.float32)
    emb = rng.standard_normal((1, 24)).astype(np.float32)
    ref = list(jstreaming.CV2Synthesizer(jp, jcfg, max_window_tokens=40,
                                         rebase_prompt_tokens=10).stream(
        iter(chunks), pt, jnp.asarray(pm), jnp.asarray(emb), seed=3))
    key = jax.random.PRNGKey(3)
    got = list(tstreaming.CV2Synthesizer(tp, tcfg, max_window_tokens=40,
                                         rebase_prompt_tokens=10).stream(
        iter(chunks), pt, t(pm), t(emb), flow_noise=JaxNoise(key), hift_noise=JaxNoise(key)))
    assert [len(g) for g in got] == [len(r) for r in ref] and len(got) >= 3
    for g, r in zip(got, ref):
        close(torch.from_numpy(g), r, HIFT_REL)


# ------------------------------------------------------------------ the engine

@pytest.fixture(scope="module")
def engine_parts(gen_parts):  # noqa: F811
    """The engines' trees: the tiny Qwen2 with the S3 tokenizer's 6561
    speech tokens (the prompt's speech tokens are its codes), the tiny
    S3Gen and S3 tokenizer."""
    jcfg, tcfg = (c.__class__(qwen=c.qwen, llm_input_size=QWEN["dim"])
                  for c in lm_configs())
    np_lm = tlm.numpy_params(np.random.default_rng(10), tcfg)  # the JAX init's tree
    # EOS likely once allowed, so that a sentence ends at its min_len
    np_lm["llm_decoder"]["bias"][tcfg.eos_id] = 30.0
    jp = jax.tree.map(jnp.asarray, np_lm)
    tp = params_from_numpy(np_lm, device="cpu")
    js3cfg, ts3cfg, js3, ts3 = gen_parts
    jtcfg = js3model.S3TokenizerConfig(**TOK)
    jtok = jax.tree.map(jnp.asarray, ts3tok.numpy_params(np.random.default_rng(2),
                                                         ts3tok.S3TokenizerConfig(**TOK)))
    return (jp, jcfg, js3, js3cfg, jtok, jtcfg), (tp, tcfg, ts3, ts3cfg, to_torch(jtok),
                                                   ts3tok.S3TokenizerConfig(**TOK))


def engines(engine_parts):
    jparts, tparts = engine_parts
    return (jengine.CosyVoice2Engine.from_params(*jparts, max_cache=512),
            tengine.CosyVoice2Engine.from_params(*tparts))


def test_speaker_voice_conversion_and_token2wav_match(engine_parts, monkeypatch):
    """`prepare_conditionals` on 1.5 s of noise at 22.05 kHz (the resamples,
    the S3 tokens equal, the prompt mel and the x-vector within 1e-4),
    `voice_conversion` of 1 s and `token2wav` on the JAX draws, the modes'
    prompts."""
    ref, eng = engines(engine_parts)
    rng = np.random.default_rng(8)
    audio = (0.1 * rng.standard_normal(33075)).astype(np.float32)
    rs = ref.prepare_conditionals(audio, 22050, ref_text="Hello there")
    ts = eng.prepare_conditionals(audio, 22050, ref_text="Hello there")
    assert ts.speech_tokens == rs.speech_tokens and len(ts.speech_tokens) > 10
    assert ts.prompt_text_ids == rs.prompt_text_ids
    close(ts.prompt_mel, rs.prompt_mel)
    close(ts.embedding, rs.embedding)

    def jax_noises(seed):
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        return JaxNoise(k1), JaxNoise(k2)
    monkeypatch.setattr(eng, "noises", jax_noises)
    src = (0.1 * rng.standard_normal(16000)).astype(np.float32)
    close(torch.from_numpy(eng.voice_conversion(src, 16000)), ref.voice_conversion(src, 16000),
          HIFT_REL)
    toks = rng.integers(0, 64, 31).tolist()
    close(torch.from_numpy(eng.token2wav(toks, ts, 2)), ref._token2wav(toks, rs, 2), HIFT_REL)
    for mode in tengine.MODES:
        assert eng._mode_ids("Hi.", ts, mode, "Calm") == ref._mode_ids("Hi.", rs, mode, "Calm")
    with pytest.raises(ValueError, match="too short"):
        eng.prepare_conditionals(np.zeros(300, np.float32), 16000, ref_text="")
    assert eng.voice_conversion(np.zeros(300, np.float32), 16000).shape == (0,)


def test_engine_streams_tokens_and_sentences(engine_parts):
    """TOKEN granularity (the default) and SENTENCE: finite audio at 24 kHz,
    one final chunk; instruct and cross-lingual modes; the first token
    chunk faded in (its first 20 ms silent)."""
    _, eng = engines(engine_parts)
    eng.prepare_conditionals((0.1 * np.random.default_rng(9).standard_normal(16000))
                             .astype(np.float32), 16000, ref_text="Hi")
    text = ("This first sentence is long enough to stand alone here. "
            "And the second sentence follows it in the same request.")
    chunks = list(eng.generate_streaming(text))
    assert eng.default_streaming_granularity == StreamingGranularity.TOKEN
    assert [c.is_final for c in chunks] == [False] * (len(chunks) - 1) + [True]
    assert len(chunks) >= 3 and all(np.isfinite(c.samples).all() for c in chunks)
    assert not np.abs(chunks[0].samples[:480]).any()
    sent = list(eng.generate_streaming(text, granularity=StreamingGranularity.SENTENCE,
                                       mode="instruct", instruct_text="Speak slowly"))
    assert [c.text for c in sent] == [text[:55], text[56:]]
    res = eng.generate("Hello.", mode="cross_lingual")
    assert res.sample_rate == 24000 and len(res.samples) > 0 and np.isfinite(res.samples).all()


def test_engine_with_every_default(engine_parts):
    """ROADMAP C7/C18: `from_params` and `generate`, `generate_streaming`
    with their public defaults (the default speaker, max_len 20 × the
    text, the cache sized per request)."""
    _, tparts = engine_parts
    eng = tengine.CosyVoice2Engine.from_params(*tparts)
    assert eng.lm.max_cache is None and eng.quantization == "w8a8"
    res = eng.generate("Hello there, how are you?")
    assert res.sample_rate == 24000 and np.isfinite(res.samples).all() and len(res.samples)
    assert len(list(eng.generate_streaming("Hello there."))) >= 1


# ------------------------------------------------------------------ load

def test_convert_and_load_from_a_written_checkpoint(engine_parts, tmp_path, monkeypatch):
    """A checkpoint in the published layout (chip_smoke's writers: the Qwen2
    stack q4 under llm.llm.model.*, S3Gen's kernels in torch's layouts, the
    S3 tokenizer in MLX's): `convert_numpy` equals the JAX `convert` leaf
    for leaf, bit for bit; `load()` from a seeded cache gives the trees
    of `from_params`, on which the engine makes the same tokens."""
    (jp, _, js3, _, jtok, _), _ = engine_parts
    jq = dict(jp, llm=jquant.quantize_tree(jp["llm"], bits=4))
    lm_np = jax.tree.map(np.asarray, jq)
    s3_np = jax.tree.map(np.asarray, js3)
    flat = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in
            chip_smoke.cosyvoice2_flat(params_from_numpy(lm_np, device="cpu"), s3_np).items()}
    rl, rs = jload.convert(dict(flat))
    gl, gs = tload.convert_numpy(dict(flat))
    for got, ref in ((gl, rl), (gs, rs)):
        g, r = pytree.flatten(got), pytree.flatten(jax.tree.map(np.asarray, ref))
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_array_equal(np.asarray(g[k]), r[k], err_msg=k)
    tok_flat = chip_smoke.s3tokenizer_mlx_flat(jax.tree.map(np.asarray, jtok))
    root = tmp_path / "hub"
    chip_smoke.seed_cache(root, tload.REPO, {"model.safetensors": lambda p: chip_smoke.
                                             write_safetensors(p, flat)})
    chip_smoke.seed_cache(root, tload.S3TOK_REPO, {"model.safetensors": lambda p: chip_smoke.
                                                   write_safetensors(p, tok_flat)})
    monkeypatch.setenv("TPU_AUDIO_CACHE", str(root))
    lm_t, lm_cfg, s3_t, s3_cfg, tok_t, tok_cfg, _ = tload.load(device="cpu")
    assert lm_cfg == tlm.CosyLMConfig() and s3_cfg.mel_dim == 80
    want = {**pytree.flatten(params_from_numpy(rl, device="cpu")),
            **{"s3." + k: v for k, v in pytree.flatten(s3_params_from_numpy(
                jax.tree.map(np.asarray, rs), "cpu")).items()},
            **{"tok." + k: v for k, v in pytree.flatten(to_torch(jtok)).items()}}
    have = {**pytree.flatten(lm_t), **{"s3." + k: v for k, v in pytree.flatten(s3_t).items()},
            **{"tok." + k: v for k, v in pytree.flatten(tok_t).items()}}
    assert have.keys() == want.keys()
    for k in want:
        assert torch.equal(have[k], want[k]), k
    eng = TTS.cosyvoice2(quantization="q4", device="cpu")
    monkeypatch.setattr(tload, "load", lambda device: (lm_t, tlm.CosyLMConfig(
        qwen=tt.TransformerConfig(**QWEN), llm_input_size=QWEN["dim"]), s3_t,
        s3gen_configs()[1], tok_t, ts3tok.S3TokenizerConfig(**TOK), None))
    eng.load()
    assert eng.is_loaded and "weight_q4" in eng.lm.params["llm"]["layers"]["attn"]["q"]
    assert len(eng.lm.generate(TEXT, [], PROMPT_SPEECH, max_new=8)) > 0
