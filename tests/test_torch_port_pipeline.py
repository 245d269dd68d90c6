"""PyTorch port, single-stream Whisper on the CPU against the JAX package:
`SegmentDecoder.decode` (greedy and sampled), `detect_language`,
`WhisperPipeline.transcribe` and the `STT.whisper` engine, with the JAX
fused-step and int8 kernels patched on in interpret mode
(`jax_kernels`).

Tiny config (d 256, 4 heads, 2 + 2 layers, n_text_ctx 16) with the
multilingual vocabulary, so the byte-level tokenizer's special tokens
exist; n_audio_ctx 64 for the decoder tests, 1500 (a real 30 s window)
for the pipeline. f32 throughout: tokens must be equal, log-probs within
1e-4 and language probabilities within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_int8 import jax_kernels  # noqa: F401
from tpu_audio.models.whisper import decoding as jdecoding
from tpu_audio.models.whisper import load as jload
from tpu_audio.models.whisper import model as jmodel
from tpu_audio.models.whisper import pipeline as jpipeline
from tpu_audio.models.whisper.config import WhisperConfig as JWhisperConfig
from tpu_audio.models.whisper.tokenizer import BPE as JBPE
from tpu_audio.models.whisper.tokenizer import WhisperTokenizer as JWhisperTokenizer
from tpu_audio_torch.api.results import TranscriptionResult
from tpu_audio_torch.api.errors import ModelLoadError
from tpu_audio_torch.api.stt import STT, WhisperEngine
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.whisper import decoding as tdecoding
from tpu_audio_torch.models.whisper import model as tmodel
from tpu_audio_torch.models.whisper import pipeline as tpipeline
from tpu_audio_torch.models.whisper.config import WhisperConfig
from tpu_audio_torch.models.whisper.tokenizer import BPE, WhisperTokenizer
from tpu_audio_torch.ops.kernels import fused_whisper_step as fws
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DIMS = dict(n_mels=80, n_audio_ctx=64, n_audio_state=256, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=16, n_text_state=256,
            n_text_head=4, n_text_layer=2)
RANKS = {bytes([i]): i for i in range(256)}


def tokenizers():
    return WhisperTokenizer(BPE(RANKS), True, 99), JWhisperTokenizer(JBPE(RANKS), True, 99)


def build(int8: bool, **dims):
    """(JAX params, JAX config, the port's model) on the same weights."""
    jcfg = JWhisperConfig(**{**DIMS, **dims})
    params = jmodel.init_params(jax.random.PRNGKey(2), jcfg)
    if int8:
        params = jload.serve_tree_int8(params, encoder=False)
    model = tmodel.Whisper(WhisperConfig(**{**DIMS, **dims}),
                           params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"))
    return params, jcfg, model


@pytest.fixture(scope="module")
def trees():
    return {int8: build(int8) for int8 in (False, True)}


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((2 * DIMS["n_audio_ctx"], DIMS["n_mels"])) * 0.5
            ).astype(np.float32)


def same_features(monkeypatch, model, params, jcfg, mel):
    """Give both packages' decoders the JAX encoder's features of `mel`, the
    one window these tests decode. The encoders agree to ~1e-6
    (tests/test_torch_port_whisper.py), and the JAX decode, which jits its
    encoder with the rest of the segment, rounds differently again; but an
    int8 decoder quantises its activation rows, and a difference that small
    can move a value across a rounding boundary and change a whole code.
    The decoders are what these tests hold."""
    feats = jmodel.encode(params, jcfg, jnp.asarray(mel)[None])
    monkeypatch.setattr(model, "encode",
                        lambda m: torch.from_numpy(np.asarray(feats)).to(m.dtype))
    monkeypatch.setattr(jmodel, "encode", lambda *args: feats)


def decoders(trees, mel, int8: bool, kv_int8: bool, monkeypatch):
    params, jcfg, model = trees[int8]
    ttok, jtok = tokenizers()
    same_features(monkeypatch, model, params, jcfg, mel)
    return (tdecoding.SegmentDecoder(model, ttok, torch.float32, kv_int8=kv_int8),
            jdecoding.SegmentDecoder(params, jcfg, jtok, jnp.float32, kv_int8=kv_int8))


@pytest.mark.parametrize("int8,kv_int8", [(False, False), (False, True), (True, False),
                                          (True, True)])
def test_greedy_decode_matches(trees, mel, jax_kernels, monkeypatch, int8, kv_int8):  # noqa: F811
    """Tokens equal; mean log-prob and no-speech probability within 1e-4."""
    got_dec, ref_dec = decoders(trees, mel, int8, kv_int8, monkeypatch)
    launches = dict(fws.LAUNCHES)
    for kw in (dict(), dict(timestamps=False, language="de", prompt=[40, 41])):
        got = got_dec.decode(mel, temperature=0.0, **kw)
        ref = ref_dec.decode(mel, temperature=0.0, **kw)
        assert got.tokens == ref.tokens and got.text == ref.text
        assert len(got.tokens) > 0
        assert got.avg_logprob == pytest.approx(ref.avg_logprob, abs=1e-4)
        assert got.no_speech_prob == pytest.approx(ref.no_speech_prob, abs=1e-4)
        assert got.compression_ratio == ref.compression_ratio
    assert fws.LAUNCHES == launches  # CPU tensors run the plain versions


def test_detect_language_matches(trees, mel, jax_kernels, monkeypatch):  # noqa: F811
    got_dec, ref_dec = decoders(trees, mel, True, True, monkeypatch)
    got_lang, got = got_dec.detect_language(mel)
    ref_lang, ref = ref_dec.detect_language(mel)
    assert got_lang == ref_lang and got.keys() == ref.keys()
    for lang, p in ref.items():
        assert got[lang] == pytest.approx(p, abs=1e-5), lang


def test_sampled_decode_with_the_jax_noise_matches(trees, mel, jax_kernels, monkeypatch):  # noqa: F811
    """At temperature 0.6 JAX samples argmax(logits / T + g) with g from
    one key split per step; fed the same g, the port picks the same
    tokens."""
    got_dec, ref_dec = decoders(trees, mel, True, True, monkeypatch)
    seed, vocab = 6, DIMS["n_vocab"]
    key, draws = jax.random.PRNGKey(seed), []
    for _ in range(DIMS["n_text_ctx"]):
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.asarray(jax.random.gumbel(sub, (vocab,), jnp.float32))))
    noise = iter(draws)
    got_dec.gumbel = lambda generator, n: next(noise)
    got = got_dec.decode(mel, temperature=0.6, seed=seed)
    ref = ref_dec.decode(mel, temperature=0.6, seed=seed)
    greedy = ref_dec.decode(mel, temperature=0.0)
    assert got.tokens == ref.tokens and ref.tokens != greedy.tokens
    assert got.avg_logprob == pytest.approx(ref.avg_logprob, abs=1e-4)


def test_gumbel_draws_from_the_generator():
    a = tdecoding.gumbel(torch.Generator().manual_seed(1), 50000)
    b = tdecoding.gumbel(torch.Generator().manual_seed(1), 50000)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert float(a.mean()) == pytest.approx(0.5772, abs=0.02)  # Euler's constant


@pytest.fixture(scope="module")
def window_trees():
    return build(True, n_audio_ctx=1500)


def test_transcribe_matches(window_trees, jax_kernels):  # noqa: F811
    params, jcfg, model = window_trees
    ttok, jtok = tokenizers()
    audio = (np.random.default_rng(4).standard_normal(16000 * 5) * 0.1).astype(np.float32)
    kw = dict(temperature=(0.0,), no_speech_threshold=None)
    got = tpipeline.WhisperPipeline(model, ttok, kv_int8=True).transcribe(audio, **kw)
    ref = jpipeline.WhisperPipeline(params, jcfg, jtok, kv_int8=True).transcribe(audio, **kw)
    assert got.language == ref.language and got.text == ref.text
    assert got.duration == ref.duration == 5.0
    assert len(got.segments) == len(ref.segments) > 0
    for g, r in zip(got.segments, ref.segments):
        assert (g.id, g.seek, g.tokens, g.text) == (r.id, r.seek, r.tokens, r.text)
        assert g.start == pytest.approx(r.start) and g.end == pytest.approx(r.end)
        assert g.avg_logprob == pytest.approx(r.avg_logprob, abs=1e-4)


def test_stt_engine_routes_to_the_pipeline(window_trees, tmp_path, monkeypatch):
    _, _, model = window_trees
    ttok, _ = tokenizers()
    pipe = tpipeline.WhisperPipeline(model, ttok, kv_int8=True)
    audio = np.zeros(16000 * 2, np.float32)

    monkeypatch.setenv("TPU_AUDIO_CACHE", str(tmp_path / "empty"))
    engine = STT.whisper("large-v3-turbo", "w8a8")
    assert isinstance(engine, WhisperEngine) and not engine.is_loaded
    with pytest.raises(ModelLoadError, match="whisper-large-v3-turbo-8bit"):
        engine.load()
    with pytest.raises(ModelLoadError):
        engine.transcribe(audio)

    engine = WhisperEngine.from_pipeline(pipe)
    kw = dict(language="en", temperature=(0.0,))
    got = engine.transcribe(audio, **kw)
    assert isinstance(got, TranscriptionResult) and not engine.is_transcribing
    assert engine.transcription_time > 0
    assert [s.tokens for s in got.segments] == [
        s.tokens for s in pipe.transcribe(audio, **kw).segments]
    assert engine.detect_language(audio) == pipe.detect_language(audio)
    texts = engine.transcribe_batch([audio, audio], batch_size=2, kv_int8=True)
    assert len(texts) == 2 and texts[0] == texts[1]
    # word timestamps reach the pipeline: the same segments, now with words
    timed = engine.transcribe(audio, word_timestamps=True, **kw)
    assert [s.tokens for s in timed.segments] == [s.tokens for s in got.segments]
    assert all(s.words is not None for s in timed.segments)
    kept = engine.transcribe(audio, word_timestamps=True, hallucination_silence_threshold=2.0,
                             **kw)
    assert {s.id for s in kept.segments} <= {s.id for s in timed.segments}
    with pytest.raises(FileNotFoundError):
        engine.transcribe(str(tmp_path / "clip.wav"))


def test_decode_steps_do_not_wait_for_the_device(trees, mel, monkeypatch):
    """The B=1 loop reads nothing back to the host but `finished`, once
    every SYNC_EVERY steps: counted on the aten ops dispatched while the
    loop runs decoder steps 2 to 10 of an int8 decode (a read is `item`,
    `is_nonzero` or `_local_scalar_dense`). The kernel wrappers are left
    out: on the CPU they run their plain versions, which may read (the
    step's position); the CUDA kernels read it on the device."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm

    _, _, model = trees[True]
    ttok, _ = tokenizers()
    reads, steps, inside = [], {"n": 0}, [False]

    class Reads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__.split(".")[0]
            if (2 <= steps["n"] <= 10 and not inside[0]
                    and name in ("item", "is_nonzero", "_local_scalar_dense")):
                reads.append((steps["n"], name))
            return func(*args, **(kwargs or {}))

    def opaque(fn):
        def run(*args, **kwargs):
            inside[0] = True
            try:
                return fn(*args, **kwargs)
            finally:
                inside[0] = False
        return run

    for mod, name in ((fws, "fused_whisper_decode_step"), (i8mm, "int8_matmul"),
                      (i8mm, "int8_matmul_stacked")):
        monkeypatch.setattr(mod, name, opaque(getattr(mod, name)))

    step = model.decode_step

    def counted(*args, **kwargs):
        steps["n"] += 1
        return step(*args, **kwargs)

    monkeypatch.setattr(model, "decode_step", counted)
    dec = tdecoding.SegmentDecoder(model, ttok, torch.float32, kv_int8=True)
    with Reads():
        dec.decode(mel, timestamps=False)
    assert steps["n"] == DIMS["n_text_ctx"] - 4  # prefill + every step of the window
    assert reads == [(tdecoding.SYNC_EVERY, "is_nonzero")]  # the read of `finished`
