"""PyTorch port, the Whisper slice end to end on the CPU: the port's model,
decode loop and batch transcription against the JAX package on the same
weights (moved by `convert.params_from_numpy`), plus the port's import
isolation and tokenizer.

Tiny config as tests/test_pallas_kernels.py's fused-encoder test (d 256,
4 heads, n_audio_ctx 300), 2 + 2 layers, with the multilingual vocabulary
so the byte-level tokenizer's special tokens exist.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.models.whisper import batch as jbatch
from tpu_audio.models.whisper import model as jmodel
from tpu_audio.models.whisper.config import WhisperConfig as JWhisperConfig
from tpu_audio.models.whisper.tokenizer import BPE as JBPE
from tpu_audio.models.whisper.tokenizer import WhisperTokenizer as JWhisperTokenizer
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.whisper import batch as tbatch
from tpu_audio_torch.models.whisper import model as tmodel
from tpu_audio_torch.models.whisper import tokenizer as ttokenizer
from tpu_audio_torch.models.whisper.config import WhisperConfig
from tpu_audio_torch.ops.kvcache import KVCache
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]
DIMS = dict(n_mels=80, n_audio_ctx=300, n_audio_state=256, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=32, n_text_state=256,
            n_text_head=4, n_text_layer=2)
CFG = WhisperConfig(**DIMS)
JCFG = JWhisperConfig(**DIMS)
PROMPT = [50258, 50259, 50360]          # sot, <|en|>, transcribe
FORCED = [50364, 400, 1200, 50414]      # teacher-forced decode tokens


def cosine(a, b) -> float:
    a, b = np.ravel(a), np.ravel(b)
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


@pytest.fixture(scope="module")
def setup():
    jparams = jmodel.init_params(jax.random.PRNGKey(0), JCFG)
    model = tmodel.Whisper(CFG, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"))
    rng = np.random.default_rng(0)
    mel = (rng.standard_normal((2, 2 * CFG.n_audio_ctx, CFG.n_mels)) * 0.1).astype(np.float32)
    feats = np.array(jmodel.encode(jparams, JCFG, jnp.asarray(mel)))
    return jparams, model, mel, feats


def byte_tokenizers():
    ranks = {bytes([i]): i for i in range(256)}
    return (ttokenizer.WhisperTokenizer(ttokenizer.BPE(ranks), True, 99),
            JWhisperTokenizer(JBPE(ranks), True, 99))


def test_params_from_numpy_keeps_the_tree(setup):
    jparams, model, _, _ = setup
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        node = model.encoder if keys[0] == "encoder" else model.decoder
        for k in keys[1:]:
            node = node[k]
        want = leaf.shape if not keys[-2].startswith("conv") or leaf.ndim != 3 \
            else leaf.shape[::-1]
        assert tuple(node.shape) == tuple(want), keys
    assert tuple(model.encoder["blocks"]["attn"]["q"]["weight"].shape) == (2, 256, 256)


def test_init_params_has_the_jax_tree():
    jparams = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), JCFG))
    tparams = tmodel.init_params(0, CFG, device="cpu")
    jflat = {jax.tree_util.keystr(p): leaf.shape
             for p, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tflat = {jax.tree_util.keystr(p): tuple(leaf.shape)
             for p, leaf in jax.tree_util.tree_flatten_with_path(tparams)[0]}
    assert jflat.keys() == tflat.keys()
    for k, shape in jflat.items():
        assert tflat[k] == (shape[::-1] if "conv" in k and "weight" in k else shape), k


def test_encode_matches(setup):
    _, model, mel, feats = setup
    got = model.encode(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), feats, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_prefill_and_decode_steps_match(setup, kv_int8):
    """Prefill then 4 teacher-forced single-token steps: f32 logits within
    1e-4 of JAX with float cross-K/V; cosine > 0.999 with int8 cross-K/V
    (the JAX CPU path dequantises to bf16, the port's decode kernel
    computes in f32)."""
    jparams, model, _, feats = setup
    jstate = jmodel.init_state(jparams, JCFG, jnp.asarray(feats), batch=2, kv_int8=kv_int8)
    tstate = model.init_state(torch.from_numpy(feats), batch=2, kv_int8=kv_int8)
    tokens = [np.array([PROMPT, PROMPT[:2] + [50361]])] + \
        [np.array([[t], [t + 1]]) for t in FORCED]
    for toks in tokens:
        jl, jstate = jmodel.decode_step(jparams, JCFG, jnp.asarray(toks, jnp.int32), jstate)
        tl, tstate = model.decode_step(torch.from_numpy(toks), tstate)
        jl, tl = np.asarray(jl), tl.numpy()
        assert tl.shape == jl.shape
        if kv_int8:
            assert cosine(tl[:, -1], jl[:, -1]) > 0.999
        else:
            np.testing.assert_allclose(tl, jl, atol=1e-4)
    assert int(tstate.cache.pos) == int(jstate.cache.pos) == 3 + len(FORCED)


def _padded_tokens(results, eot, length):
    return np.array([r.tokens + [eot] * (length - len(r.tokens)) for r in results])


def test_decode_batch_matches(setup):
    """Greedy batch decode with timestamp rules: identical tokens to JAX with
    float cross-K/V; >= 0.9 token agreement with int8 cross-K/V (int8
    rounding flips near-tie argmaxes of random weights)."""
    jparams, model, mel, _ = setup
    ttok, jtok = byte_tokenizers()
    length = CFG.n_text_ctx
    out = {}
    for kv_int8 in (False, True):
        ref = jbatch.BatchSegmentDecoder(jparams, JCFG, jtok, batch_size=2,
                                         compute_dtype=jnp.float32, kv_int8=kv_int8
                                         ).decode_batch(mel, temperature=0.0)
        got = tbatch.BatchSegmentDecoder(model, ttok, batch_size=2,
                                         compute_dtype=torch.float32, kv_int8=kv_int8
                                         ).decode_batch(mel, temperature=0.0)
        out[kv_int8] = (_padded_tokens(got, ttok.eot, length),
                        _padded_tokens(ref, jtok.eot, length))
        for g, r in zip(got, ref):
            assert np.isfinite(g.avg_logprob) and 0 <= g.no_speech_prob <= 1
            if not kv_int8:
                assert g.tokens == r.tokens
                assert g.avg_logprob == pytest.approx(r.avg_logprob, abs=1e-4)
                assert g.no_speech_prob == pytest.approx(r.no_speech_prob, abs=1e-5)
    assert (out[True][0] == out[True][1]).mean() >= 0.9


def test_temperature_sampling_uses_the_generator(setup):
    _, model, mel, _ = setup
    ttok, _ = byte_tokenizers()
    dec = tbatch.BatchSegmentDecoder(model, ttok, batch_size=2, compute_dtype=torch.float32)
    a = dec.decode_batch(mel, temperature=1.0, seed=7, timestamps=False)
    b = dec.decode_batch(mel, temperature=1.0, seed=7, timestamps=False)
    assert [r.tokens for r in a] == [r.tokens for r in b]
    assert all(0 <= t < CFG.n_vocab for r in a for t in r.tokens)


def test_transcribe_windows_multi_clip():
    ttok, _ = byte_tokenizers()
    cfg = WhisperConfig(**{**DIMS, "n_audio_ctx": 1500})
    full = tmodel.Whisper(cfg, tmodel.init_params(1, cfg, device="cpu"))
    rng = np.random.default_rng(1)
    clips = [np.zeros(16000 * 2, np.float32),
             (rng.standard_normal(16000 * 35) * 0.1).astype(np.float32)]
    texts, results = tbatch.transcribe_windows(full, ttok, clips, batch_size=4,
                                               kv_int8=True, return_results=True)
    assert len(texts) == 2 and all(isinstance(t, str) for t in texts)
    assert len(results) == 3  # 1 window + 2 windows


def test_kv_cache_updates_in_place():
    cache = KVCache.create(2, 1, 8, 2, 4, dtype=torch.float32, device="cpu")
    k = torch.ones(1, 3, 2, 4)
    cache.write(1, k, 2 * k)
    cache.advance(3)
    cache.write(1, 3 * k[:, :1], 4 * k[:, :1])
    assert int(cache.pos) == 3
    assert cache.k[1, 0, :3].eq(1).all() and cache.k[1, 0, 3].eq(3).all()
    assert cache.v[1, 0, 3].eq(4).all() and cache.k[0].eq(0).all()


def test_tokenizer_matches_jax():
    ttok, jtok = byte_tokenizers()
    for name in ("eot", "sot", "transcribe", "no_timestamps", "timestamp_begin"):
        assert getattr(ttok, name) == getattr(jtok, name)
    assert ttok.non_speech_tokens == jtok.non_speech_tokens
    text = "Hello, world! It's 2024 -- don't_stop\n  ♪ naïve 東京"
    assert ttok.encode(text) == jtok.encode(text)


def test_re_fallback_pattern_splits_like_regex():
    """The pattern the tokenizer compiles without `regex` (`_unicode`'s
    translation of GPT2_PAT for `re`) splits as `regex` does, also on the
    numerals of categories No and Nl and on U+001C..U+001F (ROADMAP C10)."""
    import regex

    from tpu_audio_torch.utils import _unicode

    texts = ["Hello, world! It's 2024 -- don't_stop\n  ♪", "a_b  c\t\td  ", "x1y2 (z)",
             "x² 3½", "Ⅻa", "a\x1c\x1d b\xa0c"]
    for text in texts:
        assert (_unicode.compile(ttokenizer.GPT2_PAT).findall(text)
                == regex.compile(ttokenizer.GPT2_PAT).findall(text)), text


def _run_isolated(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, **env})


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from tpu_audio_torch.models.whisper import batch, model\n"
        "from tpu_audio_torch.models.whisper.config import WhisperConfig\n"
        "cfg = WhisperConfig(n_audio_state=64, n_audio_head=2, n_audio_layer=1,\n"
        "                    n_text_state=64, n_text_head=2, n_text_layer=1)\n"
        "m = model.Whisper(cfg, model.init_params(0, cfg, device='cpu'))\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'tpu_audio'], 'tpu_audio'\n"
        "print('ok', sum(p.numel() for p in m.parameters()))\n")
    proc = _run_isolated(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_kernel_modules_import_without_nvcc_or_cuda():
    code = (
        "from tpu_audio_torch.ops.kernels import _build, cross_kv_attention, "
        "fused_encoder, fused_mel\n"
        "assert _build._lib is None\n"
        "print(_build.library_path().name)\n")
    proc = _run_isolated(code, PATH="/nonexistent", CUDA_HOME="/nonexistent",
                         CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("libtpu_audio_torch_")
