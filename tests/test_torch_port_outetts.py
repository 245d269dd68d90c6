"""PyTorch port, OuteTTS (tpu_audio_torch/models/outetts/) against the JAX
package on the CPU: the prompt grammar, speaker profiles and features;
`OuteTTSEngine` on a tiny Llama (dim 256, 2 layers, 4 heads over 2 of hd
64, hidden 512, vocabulary 512 over the byte-level stand-in tokenizer) on
its int8 and bf16 trees; `create_speaker`; `load()` from a pre-seeded cache;
and the engine with every public default.

The JAX side runs its whole-stack step (`jax_fused`) and its W8A8 matmuls
(`jax_kernels`) in interpret mode. Both engines' SAMPLER is patched to
greedy under a strong repetition penalty (random tied heads repeat one
token): the tokens are equal, and at f32 activations the logits along the
decode are within 1e-2 of max|ref| with every step's margin above the two
packages' differences, as tests/test_torch_port_orpheus.py holds them.
"""

from __future__ import annotations

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_port_int8 import jax_kernels  # noqa: F401
from tests.test_torch_port_llm import jax_fused  # noqa: F401
from tpu_audio.codecs import dac as jdac
from tpu_audio.models.outetts import engine as jengine
from tpu_audio.models.outetts import features as jfeatures
from tpu_audio.models.outetts import tokens as jtokens
from tpu_audio.nn import transformer as jt
from tpu_audio.ops import quant as jquant
from tpu_audio.ops.sampling import SamplerConfig as JSampler
from tpu_audio_torch.api.errors import ModelLoadError
from tpu_audio_torch.api.results import TranscriptionResult, TranscriptionSegment, Word
from tpu_audio_torch.api.stt import WhisperEngine
from tpu_audio_torch.api.tts import TTS, GenerationStopped
from tpu_audio_torch.codecs.dac import model as tdac
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.outetts import engine as tengine
from tpu_audio_torch.models.outetts import features as tfeatures
from tpu_audio_torch.models.outetts import tokens as ttokens
from tpu_audio_torch.models.whisper import model as twmodel
from tpu_audio_torch.models.whisper.config import WhisperConfig
from tpu_audio_torch.models.whisper.pipeline import WhisperPipeline
from tpu_audio_torch.models.whisper.tokenizer import BPE, WhisperTokenizer
from tpu_audio_torch.nn import transformer as tt
from tpu_audio_torch.ops import quant as tquant
from tpu_audio_torch.ops import sampling
from tpu_audio_torch.ops.sampling import SamplerConfig
from tpu_audio_torch.utils import pytree
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

LLM = dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64, hidden_dim=512,
           vocab_size=512, rope_theta=500000.0, tie_word_embeddings=True,
           rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                         "high_freq_factor": 4.0, "original_max_position_embeddings": 8192})
DAC = dict(encoder_dim=8, encoder_rates=(2, 4, 5, 8), decoder_dim=64, decoder_rates=(8, 5, 4, 2),
           n_codebooks=2, codebook_size=32, codebook_dim=4, latent_dim=128)
PENALTY = dict(repetition_penalty=50.0, repetition_window=20)
MAX_NEW = 10


def close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, err


def to_torch(tree, dtype=torch.float32):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu", dtype=dtype)


@pytest.fixture(scope="module")
def parts():
    """JAX and port trees of the tiny LM (unit-scale embeddings: the prompt,
    not the init's 0.02, drives the stack) and of TINY_DAC."""
    jp = jt.init_params(jax.random.PRNGKey(11), jt.TransformerConfig(**LLM))
    rng = np.random.default_rng(1)
    jp["embed"]["weight"] = jnp.asarray(
        rng.standard_normal((LLM["vocab_size"], LLM["dim"])).astype(np.float32))
    jd = jdac.init_params(jax.random.PRNGKey(0), jdac.DACConfig(**DAC))
    return jp, jd, to_torch(jd)


def lm_trees(jp, kind: str):
    """(JAX tree, port tree): "int8" (the q4 tree requantised and fused, the
    engine's w8a8 default) or "bf16"."""
    if kind == "bf16":
        jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jt.fuse_fp_tree(jp))
        return jb, to_torch(jb, torch.bfloat16)
    ji = jquant.requantize_tree_int8(jquant.quantize_tree(jp, bits=4))
    return ji, to_torch(ji)


def engines(parts, kind, monkeypatch, **kw):
    """(JAX engine, port engine) on the same trees, unconditioned, their
    SAMPLER greedy under the penalty."""
    jp, jd, td = parts
    jl, tl = lm_trees(jp, kind)
    monkeypatch.setattr(jengine, "SAMPLER", JSampler(temperature=0.0, **PENALTY))
    monkeypatch.setattr(tengine, "SAMPLER", SamplerConfig(temperature=0.0, **PENALTY))
    ref = jengine.OuteTTSEngine.from_params(jl, jt.TransformerConfig(**LLM), jd,
                                            jdac.DACConfig(**DAC), max_cache=256)
    eng = tengine.OuteTTSEngine.from_params(tl, tt.TransformerConfig(**LLM), td,
                                            tdac.DACConfig(**DAC), **kw)
    ref.speaker = eng.speaker = None
    return ref, eng


def spy(obj, name: str, log: list):
    """Record what obj.name returns."""
    fn = getattr(obj, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        log.append(out)
        return out
    setattr(obj, name, wrapped)


SPEAKER = ttokens.SpeakerProfile(
    text="Reference speech", words=[
        ttokens.WordData("Reference", 0.42, ttokens.AudioFeatures(10, 20, 30), [1, 2], [3, 4]),
        ttokens.WordData("speech", 0.31, c1=[5, 6, 7], c2=[8, 9, 10])],
    global_features=ttokens.AudioFeatures(40, 50, 60))


def jax_profile(p: ttokens.SpeakerProfile) -> jtokens.SpeakerProfile:
    return jtokens.SpeakerProfile(
        text=p.text, global_features=jtokens.AudioFeatures(**p.global_features.__dict__),
        words=[jtokens.WordData(w.word, w.duration, jtokens.AudioFeatures(**w.features.__dict__),
                                list(w.c1), list(w.c2)) for w in p.words])


@pytest.mark.parametrize("text", ["Hello  world…", "“Quoted” — and\ttabbed\x07 text.",
                                  "你好，世界。", ""])
def test_grammar_matches_jax(text):
    """normalize_text, build_prompt with and without a speaker, and
    merge_speaker_text on latin and CJK speakers with and without a closing
    mark."""
    assert tengine.normalize_text(text) == jengine.normalize_text(text)
    assert tengine.build_prompt(text, None) == jengine.build_prompt(text, None)
    assert tengine.build_prompt(text, SPEAKER) == jengine.build_prompt(text, jax_profile(SPEAKER))
    for sp in ("Reference speech", "Done.", "Really?", "参考音声", "参考音声。", "  "):
        assert tengine.merge_speaker_text(text, sp) == jengine.merge_speaker_text(text, sp)
    spk = ttokens.SpeakerProfile(text="参考",
                                 words=[ttokens.WordData("参考", 0.5, c1=[1], c2=[2])])
    assert tengine.build_prompt(text, spk) == jengine.build_prompt(text, jax_profile(spk))


def test_extract_codes_and_word_codes_match_jax():
    txt = ("<|c1_7|><|c2_8|>junk<|c1_9|><|c2_10|><|c1_11|><|word_end|>"
           "<|c2_12|><|c1_1023|><|c2_0|><|c1_x|>")
    for got, ref in zip(tengine.extract_codes(txt), jengine.extract_codes(txt)):
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    assert [list(a) for a in tengine.extract_codes(txt)] == [[7, 9, 11, 1023], [8, 10, 12, 0]]
    assert tengine.extract_codes("")[0].shape == (0,)
    for w, jw in zip(SPEAKER.words, jax_profile(SPEAKER).words):
        assert w.to_codes() == jw.to_codes()
    assert ttokens.format_time(0.245) == jtokens.format_time(0.245)
    assert SPEAKER.global_features.tokens() == jtokens.AudioFeatures(40, 50, 60).tokens()


def test_speaker_profile_round_trip_across_packages(tmp_path):
    path = SPEAKER.save(str(tmp_path / "port.json"))
    ref = jtokens.SpeakerProfile.load(path)
    assert ref == jax_profile(SPEAKER)
    jpath = ref.save(str(tmp_path / "jax.json"))
    assert ttokens.SpeakerProfile.load(jpath) == SPEAKER
    assert json.loads(open(path).read()) == json.loads(open(jpath).read())


@pytest.mark.parametrize("kind", ["tone", "noise", "short", "silence"])
def test_extract_features_matches_jax(kind):
    sr = 24000
    rng = np.random.default_rng(4)
    t = np.arange(sr // 2) / sr
    audio = {"tone": (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32),
             "noise": (rng.standard_normal(sr) * 0.05).astype(np.float32),
             "short": (rng.standard_normal(500) * 0.1).astype(np.float32),
             "silence": np.zeros(sr // 4, np.float32)}[kind]
    got, ref = tfeatures.extract_features(audio, sr), jfeatures.extract_features(audio, sr)
    assert isinstance(got, ttokens.AudioFeatures) and vars(got) == vars(ref)
    assert tfeatures.pitch_autocorr(audio, sr) == jfeatures.pitch_autocorr(audio, sr)
    assert tfeatures.spectral_centroid(audio, sr) == pytest.approx(
        jfeatures.spectral_centroid(audio, sr))
    assert tfeatures.energy_rms(audio) == pytest.approx(jfeatures.energy_rms(audio))


def path_logits(jp, tp, prompt: list[int], tokens: list[int]):
    """Teacher-forced logits along a greedy decode at f32 activations: the
    prompt left-padded to the generators' bucket of 32 (pos_offset), the
    single-stream cache, then one-token steps on tokens[:-1]: (JAX, port)
    (len(tokens), V)."""
    jcfg, tcfg = jt.TransformerConfig(**LLM), tt.TransformerConfig(**LLM)
    n = -(-len(prompt) // 32) * 32
    pad = n - len(prompt)
    ids = [0] * pad + prompt
    slots = n + len(tokens)
    jc, jx = jt.decode_cache_and_mask(jcfg, slots, pad,
                                      jt.fused_decode_supported(jcfg, jp, slots))
    tc, tx = tt.decode_cache_and_mask(tcfg, slots, pad, tt.fused_decode_supported(tcfg, tp),
                                      device="cpu")
    joff, toff = jnp.asarray([pad]), torch.tensor([pad])
    jl, jc = jt.forward(jp, jcfg, jnp.asarray([ids]), jc, jx, pos_offset=joff)
    tl, tc = tt.forward(tp, tcfg, torch.tensor([ids]), tc, tx, pos_offset=toff)
    jout, tout = [np.asarray(jl[0, -1], np.float32)], [tl[0, -1].float()]
    for t in tokens[:-1]:
        jl, jc = jt.forward(jp, jcfg, jnp.asarray([[t]]), jc, jx, pos_offset=joff)
        tl, tc = tt.forward(tp, tcfg, torch.tensor([[t]]), tc, tx, pos_offset=toff)
        jout.append(np.asarray(jl[0, -1], np.float32))
        tout.append(tl[0, -1].float())
    return np.stack(jout), torch.stack(tout).numpy()


def penalised(logits: np.ndarray, tokens: list[int]) -> np.ndarray:
    out = [logits[0]]
    recent = torch.full((1, PENALTY["repetition_window"]), -1)
    for i in range(1, len(tokens)):
        recent = sampling.update_recent(recent, torch.tensor([tokens[i - 1]]))
        out.append(sampling.apply_repetition_penalty(
            torch.from_numpy(logits[i][None]), recent, PENALTY["repetition_penalty"])[0].numpy())
    return np.stack(out)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_engine_tokens_match_jax_with_margins(parts, jax_fused, jax_kernels, monkeypatch,
                                              kind):
    """`generate` of two sentences through both engines: the same prompts,
    eos ids and tokens; at f32 activations the logits along the decode
    within 1e-2 and every step's margin above the packages' differences."""
    ref, eng = engines(parts, kind, monkeypatch)
    got_toks, ref_toks = [], []
    spy(eng.lm, "generate", got_toks)
    spy(ref.lm, "generate", ref_toks)
    text = "This first sentence is long enough to stand on its own. And a second one."
    chunks = list(eng.generate_streaming(text, max_new_tokens=MAX_NEW))
    ref_chunks = list(ref.generate_streaming(text, max_new_tokens=MAX_NEW))
    assert [c.text for c in chunks] == [c.text for c in ref_chunks]
    assert [c.is_final for c in chunks] == [False, True]
    assert eng._eos_ids() == ref._eos_ids() == (2,)
    assert got_toks == ref_toks and all(len(t) == MAX_NEW for t in got_toks)
    for c, rc in zip(chunks, ref_chunks):
        assert c.samples.shape == rc.samples.shape
    if kind == "bf16":  # bf16 logits tie often; the tokens are the check
        return
    prompt = eng.tokenizer.encode(tengine.build_prompt(chunks[0].text, None))
    jp, _ = lm_trees(parts[0], kind)
    jl, tl = path_logits(jp, eng.lm.params, prompt, got_toks[0])
    close(tl, jl, rel=1e-2)
    jl, tl = penalised(jl, got_toks[0]), penalised(tl, got_toks[0])
    np.testing.assert_array_equal(jl.argmax(-1), got_toks[0])
    dev = np.abs(jl - tl)
    a = np.asarray(got_toks[0])[:, None]
    gap = np.take_along_axis(jl, a, 1) - jl
    need = np.take_along_axis(dev, a, 1) + dev
    np.put_along_axis(gap, a, np.inf, 1)
    assert (gap > need).all(), np.argwhere(gap <= need)


def test_generate_batch_matches_jax_and_single_decodes(parts, jax_fused, jax_kernels,
                                                       monkeypatch):
    ref, eng = engines(parts, "int8", monkeypatch)
    got_rows, ref_rows = [], []
    spy(eng.lm, "generate_batch", got_rows)
    spy(ref.lm, "generate_batch", ref_rows)
    texts = ["One.", "Two words here.", "A third, longer text to say."]
    results = eng.generate_batch(texts, max_new_tokens=MAX_NEW)
    ref_results = ref.generate_batch(texts, max_new_tokens=MAX_NEW)
    assert got_rows == ref_rows
    assert len(results) == 3 and not eng.is_generating and eng.generation_time > 0
    for r, rr in zip(results, ref_results):
        assert r.sample_rate == 24000 and r.samples.shape == rr.samples.shape
    kw = dict(sampler=tengine.SAMPLER, eos_ids=eng._eos_ids(), max_new=MAX_NEW)
    prompts = [eng.tokenizer.encode(tengine.build_prompt(t, None)) for t in texts]
    assert got_rows[0] == [eng.lm.generate(p, **kw) for p in prompts]


def test_generated_codes_decode_as_jax(parts):
    """extract_codes → _decode_dac on a generated string with c1/c2 runs
    (random weights rarely emit code tokens)."""
    _, jd, td = parts
    rng = np.random.default_rng(9)
    c1, c2 = rng.integers(0, 32, 27), rng.integers(0, 32, 27)
    text = "<|audio_start|>" + "".join(
        f"<|word_start|>w<|features|><|t_0.10|><|code|>" + "".join(
            f"<|c1_{a}|><|c2_{b}|>" for a, b in zip(c1[i:i + 9], c2[i:i + 9])) + "<|word_end|>"
        for i in range(0, 27, 9))
    eng, ref = tengine.OuteTTSEngine(speaker=None, device="cpu"), jengine.OuteTTSEngine(None)
    eng.dac_params, eng.dac_cfg = td, tdac.DACConfig(**DAC)
    ref.dac_params, ref.dac_cfg = jd, jdac.DACConfig(**DAC)
    got, want = eng._decode_dac(*tengine.extract_codes(text)), ref._decode_dac(
        *jengine.extract_codes(text))
    assert got.shape == (27 * 320,)
    close(got, want)


class StubWhisper:
    """A Whisper engine that returns given words."""

    def __init__(self, words, text="stub text"):
        self.result = TranscriptionResult(text=text, segments=[TranscriptionSegment(
            id=0, seek=0, start=0.0, end=2.0, text=text, tokens=[], words=words)])
        self.calls = []

    def transcribe(self, audio, **kw):
        self.calls.append((len(audio), kw))
        return self.result


def test_create_speaker_matches_jax(parts, tmp_path):
    """Given the same word timestamps, both packages build the same profile:
    each word's DAC codes, duration and features, and the global features;
    at 44.1 kHz the audio is resampled to 16 kHz for Whisper and 24 kHz for
    DAC."""
    _, jd, td = parts
    sr = 44100
    rng = np.random.default_rng(5)
    audio = (rng.standard_normal(int(sr * 1.6)) * 0.2).astype(np.float32)
    words = [Word(" one", 0.1, 0.45), Word(" two", 0.5, 0.51), Word(" three", 0.7, 1.32)]
    eng, ref = tengine.OuteTTSEngine(speaker=None, device="cpu"), jengine.OuteTTSEngine(None)
    eng.dac_params, eng.dac_cfg = td, tdac.DACConfig(**DAC)
    ref.dac_params, ref.dac_cfg = jd, jdac.DACConfig(**DAC)
    stub = StubWhisper(words)
    got = eng.create_speaker(audio, sr, whisper_engine=stub)
    want = ref.create_speaker(audio, sr, whisper_engine=StubWhisper(words))
    assert stub.calls == [(int(np.ceil(len(audio) * 160 / 441)), {"word_timestamps": True})]
    assert [w.word for w in got.words] == [" one", " three"]  # " two" is under one hop
    assert got == ttokens.SpeakerProfile.load(want.save(str(tmp_path / "jax.json")))
    got = eng.create_speaker(audio, sr, transcript="given", whisper_engine=stub)
    assert got.text == "given"


def test_create_speaker_through_a_whisper_engine(parts):
    """create_speaker through a tiny `WhisperEngine.from_pipeline` (random
    weights: whatever words it finds), at 16 kHz."""
    _, _, td = parts
    cfg = WhisperConfig(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                        n_audio_layer=1, n_vocab=51865, n_text_ctx=16, n_text_state=64,
                        n_text_head=2, n_text_layer=1)
    model = twmodel.Whisper(cfg, twmodel.init_params(3, cfg, torch.float32, "cpu"))
    tok = WhisperTokenizer(BPE({bytes([i]): i for i in range(256)}), True, 99)
    whisper = WhisperEngine.from_pipeline(WhisperPipeline(model, tok))
    eng = tengine.OuteTTSEngine(speaker=None, device="cpu")
    eng.dac_params, eng.dac_cfg = td, tdac.DACConfig(**DAC)
    audio = (np.random.default_rng(6).standard_normal(16000 * 2) * 0.1).astype(np.float32)
    prof = eng.create_speaker(audio, 16000, transcript="hello", whisper_engine=whisper)
    assert isinstance(prof, ttokens.SpeakerProfile) and prof.text == "hello"
    from tpu_audio_torch.ops.resample import resample

    assert vars(prof.global_features) == vars(jfeatures.extract_features(
        resample(audio, 16000, 24000), 24000))
    for w in prof.words:
        assert len(w.c1) == len(w.c2) > 0 and all(0 <= c < 32 for c in w.c1 + w.c2)


def test_load_from_a_seeded_cache(parts, tmp_path, monkeypatch):
    """`load()` reads the mlx 4-bit Llama and the DAC checkpoint from a
    pre-seeded cache: w8a8 (the default) serves the requantised tree, q4
    the checkpoint's, both as `from_params` on those trees."""
    cfg = tt.TransformerConfig(**LLM)
    q4 = chip_smoke.bf16_affine(tquant.quantize_tree(tt.init_params(2, cfg, device="cpu"),
                                                     bits=4))
    llm_files = {"model.safetensors": lambda p: chip_smoke.write_safetensors(
                     p, chip_smoke.llama_flat(q4), {"format": "mlx"}),
                 "config.json": chip_smoke.write_text(json.dumps(
                     {**chip_smoke.hf_config(cfg, "llama"),
                      "quantization": {"group_size": 64, "bits": 4}}))}
    dac_files = {"model.safetensors": lambda p: chip_smoke.write_safetensors(
                     p, chip_smoke.dac_torch_flat(parts[2])),
                 "config.json": chip_smoke.write_text(json.dumps(
                     {k: list(v) if isinstance(v, tuple) else v for k, v in DAC.items()}))}
    chip_smoke.seed_cache(tmp_path, tengine.LLM_REPO, llm_files)
    chip_smoke.seed_cache(tmp_path, tengine.DAC_REPO, dac_files)
    monkeypatch.setenv("TPU_AUDIO_CACHE", str(tmp_path))
    for quantization, want in (("w8a8", tquant.requantize_tree_int8(q4)), ("q4", q4)):
        eng = TTS.oute(device="cpu")
        eng.quantization = quantization
        eng.load()
        assert eng.is_loaded and eng.dac_cfg == tdac.DACConfig(**DAC)
        got = pytree.flatten(eng.lm.params)
        want = pytree.flatten(tt.fuse_fp_tree(want))
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want), quantization
        assert eng.lm.max_cache == 4096
        dac_got, dac_want = pytree.flatten(eng.dac_params), pytree.flatten(parts[2])
        assert sorted(dac_got) == sorted(dac_want)
        assert all(torch.equal(dac_got[k], v) for k, v in dac_want.items())
    eng.speaker = None
    res = eng.generate("Hi.", max_new_tokens=4)
    assert res.sample_rate == 24000 and np.isfinite(res.samples).all()


def test_unported_options_and_factories(tmp_path, monkeypatch):
    assert tengine.OuteTTSEngine(speculative="ngram").speculative == "ngram"  # A9 ported
    with pytest.raises(ValueError, match="speculative"):
        tengine.OuteTTSEngine(speculative="draft")
    with pytest.raises(ValueError, match="quantization"):
        tengine.OuteTTSEngine(quantization="q3")
    eng = TTS.oute(device="cpu")
    assert isinstance(eng, tengine.OuteTTSEngine) and eng.device == "cpu"
    assert TTS.oute().device == "cuda"
    monkeypatch.setenv("TPU_AUDIO_CACHE", str(tmp_path / "empty"))
    with pytest.raises(ModelLoadError, match="Llama-OuteTTS-1.0-1B-4bit"):
        eng.load()
    with pytest.raises(ModelLoadError, match="whisper"):
        eng.create_speaker(np.zeros(1600, np.float32), 16000)
    from tpu_audio_torch.models.kokoro.engine import KokoroEngine  # A14 ported
    assert isinstance(TTS.kokoro(device="cpu"), KokoroEngine)
    assert TTS.kokoro(device="cpu").device == "cpu" and TTS.kokoro().device == "cuda"
    assert TTS.chatterbox(device="cpu").device == "cpu"  # A13 ported


def test_stop_between_sentences(parts, monkeypatch):
    ref, eng = engines(parts, "int8", monkeypatch)
    stream = eng.generate_streaming("This first sentence is long enough to stand on its own. "
                                    "And a second one.", max_new_tokens=4)
    first = next(stream)
    assert not first.is_final
    eng.stop()
    with pytest.raises(GenerationStopped):
        next(stream)


def test_engine_with_every_default(parts, caplog):
    """`from_params` and `generate` with their public defaults: the default
    speaker (absent: the loud warning, then unconditioned), up to 2048 new
    tokens at the reference sampler, the cache sized per request (ROADMAP
    C7). The untied head leans toward the stand-in eos id 2, so the decode
    ends on it after a few dozen tokens instead of running to the cap."""
    _, _, td = parts
    cfg = tt.TransformerConfig(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128,
                               vocab_size=512)
    params = tt.init_params(4, cfg, device="cpu")
    params["lm_head"]["weight"][2] += 0.25
    with caplog.at_level(logging.WARNING, logger="tpu_audio_torch.tts"):
        eng = tengine.OuteTTSEngine.from_params(params, cfg, td, tdac.DACConfig(**DAC))
    assert "UNCONDITIONED" in caplog.text and eng.speaker is None
    assert eng.lm.max_cache is None and eng.quantization == "w8a8"
    toks = []
    spy(eng.lm, "generate", toks)
    res = eng.generate("Hello there.")
    assert res.sample_rate == 24000 and np.isfinite(res.samples).all()
    assert len(res.samples) % eng.dac_cfg.hop == 0
    assert len(toks) == 1 and 1 < len(toks[0]) < 2048  # ended on eos
