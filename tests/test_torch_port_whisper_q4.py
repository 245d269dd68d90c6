"""PyTorch port, Whisper on the mlx group-affine q4/q8 trees and the per-op
encoder against the JAX package on the CPU: the per-op `encode` (fp tree
with the fused encoder off, both attention packings; q4, q8 and mixed
int8/fp trees), decoding on q4/q8 decoders (teacher-forced logits, greedy
`SegmentDecoder` tokens, the B=1 int8 cross-K/V state over a q4 decoder),
`forward_cross_qk`, the word-timing helpers, the word timestamps of given
byte-level text (random weights emit ids that the byte tokenizer decodes to
nothing, so a transcript's words are empty), and `WhisperEngine.transcribe`
with word timestamps and the hallucination filter.

The JAX encoder-attention kernels run in interpret mode with their gate's
shape rule on (`jax_attention`), and so does its q4/q8 dequant-matmul
where a test holds the port's plain `quant_matmul` against it
(`jax_quant_matmul`). Tiny configs: d 256, 4 heads of 64, 2 + 2 layers,
T = 600 for the encoders (≥ 512, the kernel's threshold), 1500 for the
pipeline. f32 throughout: features, logits and cross-attention scores
within 1e-5 of max|ref|, tokens and words equal, log-probs within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_encoder_attention import jax_attention, spy  # noqa: F401
from tests.test_torch_port_encoder_attention import without_tpu_check
from tests.test_torch_port_pipeline import same_features, tokenizers
from tests.test_torch_port_quant_q4 import interpret_pallas  # noqa: F401
from tpu_audio import native
from tpu_audio.models.whisper import decoding as jdecoding
from tpu_audio.models.whisper import load as jload
from tpu_audio.models.whisper import model as jmodel
from tpu_audio.models.whisper import pipeline as jpipeline
from tpu_audio.models.whisper import timing as jtiming
from tpu_audio.models.whisper.config import WhisperConfig as JWhisperConfig
from tpu_audio.ops import quant as jquant
from tpu_audio.ops.pallas import quant_matmul as jqmm
from tpu_audio_torch.api.stt import WhisperEngine
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.whisper import decoding as tdecoding
from tpu_audio_torch.models.whisper import model as tmodel
from tpu_audio_torch.models.whisper import pipeline as tpipeline
from tpu_audio_torch.models.whisper import timing as ttiming
from tpu_audio_torch.models.whisper.config import WhisperConfig
from tpu_audio_torch.ops.kernels import cross_kv_attention as ckv
from tpu_audio_torch.ops.kernels import fused_whisper_step as fws
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DIMS = dict(n_mels=80, n_audio_ctx=600, n_audio_state=256, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=64, n_text_state=256,
            n_text_head=4, n_text_layer=2)


@pytest.fixture
def jax_quant_matmul(monkeypatch, interpret_pallas):  # noqa: F811
    """The JAX q4/q8 dequant-matmul kernel in interpret mode, its gate's
    shape rule on: up to 32 rows take it, as on the TPU."""
    monkeypatch.setattr(jqmm, "supported", without_tpu_check(jqmm.supported))


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def jax_tree(kind: str, seed: int = 0, **dims):
    """A JAX init in one format: "fp", "q4", "q8" (the mlx group-affine
    trees: every eligible linear and the tied embedding) or "mixed" (the
    w8a8 serving tree with the encoder's fc2 left fp)."""
    jcfg = JWhisperConfig(**{**DIMS, **dims})
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    if kind in ("q4", "q8"):
        return jquant.quantize_tree(jp, bits=int(kind[1])), jcfg
    if kind == "mixed":
        mixed = jload.serve_tree_int8(jp)
        mixed["encoder"]["blocks"]["mlp"]["fc2"] = jp["encoder"]["blocks"]["mlp"]["fc2"]
        return mixed, jcfg
    return jp, jcfg


def build(kind: str, seed: int = 0, **dims):
    """(JAX params, JAX config, the port's model) on the same weights."""
    jp, jcfg = jax_tree(kind, seed, **dims)
    model = tmodel.Whisper(WhisperConfig(**{**DIMS, **dims}),
                           params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    return jp, jcfg, model


# ------------------------------------------------------- the per-op encoder

ENCODERS = [("fp", True, "encoder_attention_packed"), ("fp", False, "encoder_attention"),
            ("q4", True, "encoder_attention"), ("q8", True, "encoder_attention"),
            ("mixed", True, "encoder_attention")]


@pytest.mark.parametrize("kind,packed,entry", ENCODERS)
def test_per_op_encode_matches(jax_attention, monkeypatch, kind, packed, entry):  # noqa: F811
    """The per-op `encode` against the JAX per-op `encode`, each through its
    encoder-attention kernel (the JAX one traced once inside its scan; the
    port's called once per block): fp weights take the packed or the
    head-major entry by PACKED_ATTN, quantised ones `attend`'s route."""
    jp, jcfg, model = build(kind)
    assert model.encoder_kind == ("fp" if kind == "fp" else None)
    for mod in (tmodel, jmodel):
        monkeypatch.setattr(mod, "FUSED_ENC", False)
        monkeypatch.setattr(mod, "PACKED_ATTN", packed)
    calls = spy(monkeypatch)
    mel = (np.random.default_rng(1).standard_normal((1, 1200, 80)) * 0.5).astype(np.float32)
    got = model.encode(torch.from_numpy(mel))
    ref = jmodel.encode(jp, jcfg, jnp.asarray(mel))
    assert rel_err(got.numpy(), ref) <= 1e-5
    assert calls == {name: DIMS["n_audio_layer"] * (name == entry) for name in calls}
    assert jax_attention[entry] >= 1 and sum(jax_attention.values()) == jax_attention[entry]


def test_fused_gates():
    """fp and int8 trees keep their fused encoders and the B=1 step; q4/q8
    and mixed trees pack nothing and take the per-op path."""
    kinds = {}
    for kind in ("fp", "q4", "q8", "mixed"):
        _, _, model = build(kind, n_audio_ctx=64, n_text_ctx=16)
        kinds[kind] = (model.encoder_kind, model.fused_step, hasattr(model, "qkv_weight"))
        assert model.device == torch.device("cpu")
    assert kinds == {"fp": ("fp", True, True), "q4": (None, False, False),
                     "q8": (None, False, False), "mixed": (None, True, False)}


# -------------------------------------------------------------- decoding

@pytest.mark.parametrize("kind", ["q4", "q8"])
def test_teacher_forced_logits_match(jax_quant_matmul, kind):
    """Prefill of the start sequence and three forced steps over f32
    cross-K/V: every decoder linear and the tied head at ≤ 32 rows through
    the dequant-matmul (the port's plain version, the JAX kernel)."""
    jp, jcfg, model = build(kind, n_audio_ctx=64, n_text_ctx=16)
    feats = (np.random.default_rng(2).standard_normal((1, 64, 256)) * 0.5).astype(np.float32)
    state = model.init_state(torch.from_numpy(feats), dtype=torch.float32)
    jstate = jmodel.init_state(jp, jcfg, jnp.asarray(feats), dtype=jnp.float32)
    for tokens in ([[50258, 50259, 50359]], [[50364]], [[300]]):
        got, state = model.decode_step(torch.tensor(tokens), state)
        ref, jstate = jmodel.decode_step(jp, jcfg, jnp.asarray(tokens), jstate)
        assert rel_err(got.numpy(), ref) <= 1e-5, tokens


@pytest.mark.parametrize("kind,kv_int8", [("q4", False), ("q8", False), ("q4", True)])
def test_greedy_decode_matches(monkeypatch, kind, kv_int8):
    """Greedy B=1 decoding, both packages fed the same features: tokens
    equal, log-probs within 1e-4. Over an int8 cross-K/V state the q4
    decoder takes the per-layer path with the cross-attention kernel, not
    the whole-decoder step, which reads only fp or int8 weights. The JAX
    side runs its CPU path here (the dequantised product; the kernel is held
    against the port by the test above)."""
    jp, jcfg, model = build(kind, n_audio_ctx=64, n_text_ctx=16)
    mel = (np.random.default_rng(3).standard_normal((128, 80)) * 0.5).astype(np.float32)
    same_features(monkeypatch, model, jp, jcfg, mel)
    ttok, jtok = tokenizers()
    steps = {"fused": 0, "cross": 0}
    for mod, name, key in ((fws, "fused_whisper_decode_step", "fused"),
                           (ckv, "cross_attention_decode", "cross")):
        def counted(*a, _fn=getattr(mod, name), _key=key, **k):
            steps[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    got = tdecoding.SegmentDecoder(model, ttok, torch.float32, kv_int8=kv_int8).decode(
        mel, temperature=0.0)
    ref = jdecoding.SegmentDecoder(jp, jcfg, jtok, jnp.float32, kv_int8=kv_int8).decode(
        mel, temperature=0.0)
    assert got.tokens == ref.tokens and len(got.tokens) > 0
    assert got.avg_logprob == pytest.approx(ref.avg_logprob, abs=1e-4)
    assert got.no_speech_prob == pytest.approx(ref.no_speech_prob, abs=1e-4)
    assert steps["fused"] == 0
    assert (steps["cross"] > 0) == kv_int8


# ------------------------------------------------------- word timestamps

@pytest.mark.parametrize("kind", ["fp", "q4"])
def test_forward_cross_qk_matches(kind):
    jp, jcfg, model = build(kind, n_audio_ctx=64, n_text_ctx=16)
    feats = (np.random.default_rng(4).standard_normal((1, 64, 256)) * 0.5).astype(np.float32)
    tokens = [[50258, 50259, 50359, 50363, 300, 301, 1200, 50257]]
    logits, qk = model.forward_cross_qk(torch.tensor(tokens), torch.from_numpy(feats))
    rlogits, rqk = jmodel.forward_cross_qk(jp, jcfg, jnp.asarray(tokens), jnp.asarray(feats))
    assert tuple(qk.shape) == (2, 1, 4, 8, 64) and qk.dtype == torch.float32
    assert rel_err(logits.numpy(), rlogits) <= 1e-5
    assert rel_err(qk.numpy(), rqk) <= 1e-5


def test_timing_helpers_match(rng):
    """median_filter, dtw (against the numpy and the native JAX-package
    versions, on costs with ties) and the token splits give the same
    arrays and groups."""
    x = rng.standard_normal((3, 20, 40)).astype(np.float32)
    np.testing.assert_array_equal(ttiming.median_filter(x), jtiming.median_filter(x))
    np.testing.assert_array_equal(ttiming.median_filter(x, 1), x)
    for cost in (rng.standard_normal((12, 50)).astype(np.float32),
                 rng.integers(0, 3, (12, 50)).astype(np.float32)):  # ties
        got = ttiming.dtw(cost)
        for ref in (jtiming.dtw(cost), native.dtw(cost)):
            np.testing.assert_array_equal(got[0], ref[0])
            np.testing.assert_array_equal(got[1], ref[1])
    ttok, jtok = tokenizers()
    tokens = ttok.encode(" héllo wörld, 日本語 is (ok)!") + [ttok.eot]
    for fn in ("split_tokens_on_unicode", "split_tokens_on_spaces"):
        got = getattr(ttiming, fn)(ttok, list(tokens))
        ref = getattr(jtiming, fn)(jtok, list(tokens))
        assert got == ref, fn
    assert ttiming.default_alignment_heads(WhisperConfig(**DIMS)) == \
        jtiming.default_alignment_heads(JWhisperConfig(**DIMS))


@pytest.fixture(scope="module")
def window_q4():
    """The q4 tree at n_audio_ctx 1500 (a real 30 s window) in both packages."""
    return build("q4", n_audio_ctx=1500)


def test_word_timestamps_of_given_tokens_match(window_q4):
    """`add_word_timestamps` (so `find_alignment`, `forward_cross_qk`, the
    DTW and the punctuation merges) on two segments of real byte-level
    text, against the JAX package on the same q4 weights and mel: the same
    words and times, probabilities within 1e-4."""
    from tpu_audio.api.results import TranscriptionSegment as JSegment
    from tpu_audio_torch.api.results import TranscriptionSegment

    jp, jcfg, model = window_q4
    ttok, jtok = tokenizers()
    mel = (np.random.default_rng(6).standard_normal((3000, 80)) * 0.5).astype(np.float32)
    ts = ttok.timestamp_begin
    texts = (ttok.encode(" Hello, world! (It's) a test."), ttok.encode(" Fine -- \"ok\" then?"))
    tokens = [[ts, *texts[0], ts + 60], [ts + 60, *texts[1], ts + 120]]
    segs = {pkg: [cls(id=i, seek=0, start=0.0, end=1.0, text="", tokens=list(t))
                  for i, t in enumerate(tokens)]
            for pkg, cls in (("port", TranscriptionSegment), ("jax", JSegment))}
    ttiming.add_word_timestamps(segs["port"], model=model, tokenizer=ttok, mel=mel,
                                language="en", time_offset=30.0)
    jtiming.add_word_timestamps(segs["jax"], params=jp, cfg=jcfg, tokenizer=jtok, mel=mel,
                                language="en", time_offset=30.0)
    words = [w for s in segs["port"] for w in s.words]
    assert len(words) >= 8 and len({w.start for w in words}) > 2
    for g, r in zip(segs["port"], segs["jax"]):
        assert (g.start, g.end) == (r.start, r.end)
        assert [(w.word, w.start, w.end) for w in g.words] == [
            (w.word, w.start, w.end) for w in r.words]
        for gw, rw in zip(g.words, r.words):
            assert gw.probability == pytest.approx(rw.probability, abs=1e-4)


def test_engine_word_timestamps_match(window_q4):
    """`WhisperEngine.transcribe(word_timestamps=True)` on the q4 tree at
    n_audio_ctx 1500 against the JAX pipeline on the same weights: the
    same segments, the same words with probabilities within 1e-4 and the
    same times. (A DTW tie that f32 rounding breaks the other way would
    move a time by one 0.02 s frame; none does on this clip.) With
    hallucination_silence_threshold the engine keeps the segments that the
    JAX filter keeps of the JAX transcript. The JAX side
    runs its CPU paths here (the kernels are held above), which keeps its
    jit compile short."""
    jp, jcfg, model = window_q4
    ttok, jtok = tokenizers()
    audio = (np.random.default_rng(5).standard_normal(16000 * 5) * 0.1).astype(np.float32)
    engine = WhisperEngine.from_pipeline(tpipeline.WhisperPipeline(model, ttok))
    kw = dict(language="en", temperature=(0.0,), word_timestamps=True)
    got = engine.transcribe(audio, **kw)
    ref = jpipeline.WhisperPipeline(jp, jcfg, jtok).transcribe(audio, **kw)
    assert got.text == ref.text and len(got.segments) == len(ref.segments) > 0
    for g, r in zip(got.segments, ref.segments):
        assert (g.id, g.seek, g.tokens) == (r.id, r.seek, r.tokens)
        assert g.start == pytest.approx(r.start) and g.end == pytest.approx(r.end)
        assert [w.word for w in g.words] == [w.word for w in r.words]
        for gw, rw in zip(g.words, r.words):
            assert (gw.start, gw.end) == (rw.start, rw.end)
            assert gw.probability == pytest.approx(rw.probability, abs=1e-4)
    assert sum(len(g.words) for g in got.segments) > 0
    # the JAX pipeline filters its segments last, as this does
    kept = engine.transcribe(audio, hallucination_silence_threshold=2.0, **kw).segments
    ref_kept = jtiming.filter_hallucinated_segments(ref.segments, 2.0, ref.duration)
    assert [g.id for g in kept] == [r.id for r in ref_kept]
