"""PyTorch port, Chatterbox (tpu_audio_torch/nn/lstm.py,
models/chatterbox/) against the JAX package on the CPU: the LSTMs, the
voice encoder, the perceiver and the conditioning, T3's CFG decode on the
fp and q4 trees (its merged logits and tokens), the engine's speaker and
audio, every public default, ROADMAP C22 and C23, and `load()` from a
checkpoint the test writes.

Tiny configs: T3 a Llama of dim 64 × 2 layers (4 heads of 16), 300 text
and 80 speech tokens, 4 perceiver queries (tests/test_chatterbox.py's);
the voice encoder at 16 hidden, partials of 40 frames at a hop of 20;
S3Gen and the S3 tokenizer tests/test_torch_port_s3.py's. The trees are
drawn by the port's `numpy_params` (the JAX init's tree) and moved to JAX.
The JAX draws are injected: T3 samples argmax(warped + gumbel(sub)), one
`split` of the key a token; S3Gen's z and HiFT's noise as in
tests/test_torch_port_s3.py. T3's cache is f32 in both packages (the JAX
generator's `make_cache` patched). On the q4 tree the JAX `quant_matmul`
runs in interpret mode (tests/test_torch_port_whisper_q4.py's
`jax_quant_matmul`).

Tolerances: modules f32 rel 1e-5 of max|ref| (the log-mel 1e-5, the
perceiver and the LSTMs 1e-5); T3's merged logits rel 1e-5 on both trees
and its tokens equal; the engine's S3 tokens equal, its mels and vectors
rel 1e-4 and its waveforms rel 2e-3 (HiFT's phase, tests/test_torch_port_s3.py);
converted leaves bit for bit.
"""

from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_port_s3 import (HIFT_REL, TOK, JaxNoise, close, gen_parts,  # noqa: F401
                                      s3gen_configs, t, to_torch)
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401
from tests.test_torch_port_whisper_q4 import jax_quant_matmul  # noqa: F401
from tests.test_torch_port_quant_q4 import interpret_pallas  # noqa: F401
from tpu_audio.codecs.s3tokenizer import model as js3model
from tpu_audio.models.chatterbox import engine as jengine
from tpu_audio.models.chatterbox import load as jload
from tpu_audio.models.chatterbox import t3 as jt3
from tpu_audio.models.chatterbox import voice_encoder as jve
from tpu_audio.nn import lstm as jlstm
from tpu_audio.nn import transformer as jt
from tpu_audio.ops import quant as jquant
from tpu_audio_torch.api.tts import TTS
from tpu_audio_torch.codecs.s3tokenizer import model as ts3tok
from tpu_audio_torch.convert import params_from_numpy, s3_params_from_numpy
from tpu_audio_torch.models.chatterbox import engine as tengine
from tpu_audio_torch.models.chatterbox import load as tload
from tpu_audio_torch.models.chatterbox import t3 as tt3
from tpu_audio_torch.models.chatterbox import voice_encoder as tve
from tpu_audio_torch.nn import lstm as tlstm
from tpu_audio_torch.nn import transformer as tt
from tpu_audio_torch.utils import pytree

LLAMA = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=4, hidden_dim=128)
T3 = dict(text_tokens_dict_size=300, speech_tokens_dict_size=80, start_speech_token=70,
          stop_speech_token=71, speaker_embed_size=32, perceiver_tokens=4,
          max_text_seq_len=128, max_mel_seq_len=256)
VE = dict(num_mels=40, ve_hidden_size=16, speaker_embed_size=32, partial_frames=40,
          partial_hop=20)
V = T3["speech_tokens_dict_size"]
TEXT = [255, 12, 40, 7, 99, 3, 0]


def t3_configs():
    return (jt3.T3Config(llama=jt.TransformerConfig(**LLAMA), **T3),
            tt3.T3Config(llama=tt.TransformerConfig(**LLAMA), **T3))


def jitter(tree: dict, rng, names=("bias", "bias_ih", "bias_hh")) -> dict:
    """Random biases and norm weights in place of the init's zeros and
    ones, so that a misplaced one shows."""
    for k, v in tree.items():
        if isinstance(v, dict):
            jitter(v, rng, names)
        elif k in names or (k == "weight" and v.ndim == 1):
            tree[k] = (0.1 * rng.standard_normal(v.shape) + (k == "weight")).astype(np.float32)
    return tree


def both(np_tree: dict):
    return jax.tree.map(jnp.asarray, np_tree), params_from_numpy(np_tree, device="cpu")


@pytest.fixture(scope="module")
def t3_parts():
    jcfg, tcfg = t3_configs()
    rng = np.random.default_rng(0)
    np_tree = jitter(tt3.numpy_params(rng, tcfg), rng)
    return (jcfg, tcfg, *both(np_tree))


@pytest.fixture
def f32_cache(monkeypatch):
    """The JAX generator's KV cache in f32, as the port's here."""
    monkeypatch.setattr(jt3.transformer, "make_cache",
                        functools.partial(jt.make_cache, dtype=jnp.float32))


# ------------------------------------------------------------------ modules

def test_lstm_bilstm_and_masked_bilstm_match_jax():
    rng = np.random.default_rng(1)

    def direction(d, h):
        return {"wx": rng.standard_normal((4 * h, d)).astype(np.float32) * 0.3,
                "wh": rng.standard_normal((4 * h, h)).astype(np.float32) * 0.3,
                "bias_ih": rng.standard_normal(4 * h).astype(np.float32) * 0.1,
                "bias_hh": rng.standard_normal(4 * h).astype(np.float32) * 0.1}
    p = {"fwd": direction(6, 5), "bwd": direction(6, 5)}
    jp, tp = both(p)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    close(tlstm.lstm(tp["fwd"], t(x)), jlstm.lstm(jp["fwd"], jnp.asarray(x)), 1e-5)
    close(tlstm.lstm(tp["fwd"], t(x), reverse=True),
          jlstm.lstm(jp["fwd"], jnp.asarray(x), reverse=True), 1e-5)
    close(tlstm.bilstm(tp, t(x)), jlstm.bilstm(jp, jnp.asarray(x)), 1e-5)
    got = tlstm.masked_bilstm(tp, t(x), 6)
    close(got, jlstm.masked_bilstm(jp, jnp.asarray(x), 6), 1e-5)
    assert not got[:, 6:].any()


def test_voice_encoder_matches_jax():
    """melspec, embed_partials and embed_utterance (1.3 s: 5 partials; and
    0.2 s, one zero-padded partial) with random LSTM biases."""
    jcfg, tcfg = jve.VoiceEncConfig(**VE), tve.VoiceEncConfig(**VE)
    rng = np.random.default_rng(2)
    jp, tp = both(jitter(tve.numpy_params(rng, tcfg), rng))
    for seconds in (1.3, 0.2):
        audio = (0.1 * rng.standard_normal(int(16000 * seconds))).astype(np.float32)
        ref_mel = jve.melspec(jnp.asarray(audio), jcfg)
        close(tve.melspec(t(audio), tcfg), ref_mel, 1e-5)
        parts = tve.partials(t(np.asarray(ref_mel)), tcfg)
        assert parts.shape[0] == (5 if seconds > 1 else 1)
        close(tve.embed_partials(tp, tcfg, parts), jve.embed_partials(
            jp, jcfg, jnp.asarray(parts.numpy())), 1e-5)
        got = tve.embed_utterance(tp, tcfg, audio)
        close(got, jve.embed_utterance(jp, jcfg, audio), 1e-5)
        assert abs(float(got.norm()) - 1.0) < 1e-5


def test_perceiver_and_conditioning_match_jax(t3_parts):
    jcfg, tcfg, jp, tp = t3_parts
    rng = np.random.default_rng(3)
    h = rng.standard_normal((1, 7, 64)).astype(np.float32)
    close(tt3._perceiver(tp["cond_enc"]["perceiver"], t(h)),
          jt3._perceiver(jp["cond_enc"]["perceiver"], jnp.asarray(h)), 1e-5)
    spk = rng.standard_normal((1, 32)).astype(np.float32)
    toks = rng.integers(0, V, (1, 9))
    for cond_tokens in (toks, None):
        got = tt3.prepare_conditioning(tp, tcfg, t(spk), None if cond_tokens is None
                                       else torch.from_numpy(cond_tokens), 0.7)
        ref = jt3.prepare_conditioning(jp, jcfg, jnp.asarray(spk), None if cond_tokens is None
                                       else jnp.asarray(cond_tokens, jnp.int32), 0.7)
        assert got.shape == (1, 6 if cond_tokens is not None else 2, 64)
        close(got, ref, 1e-5)


# ------------------------------------------------------------------ T3

def jax_draws(seed: int, n: int):
    """The JAX generator's Gumbel draws: token i's from the i-th split of
    PRNGKey(seed)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.gumbel(sub, (V,))))[None])
    return lambda i: out[i]


def record_jax_logits(monkeypatch, mod):
    """The CFG-merged logits the JAX `_select` hands its sampler, one array
    a token, recorded from inside its jitted loop."""
    seen, real = [], mod.sampling.apply_repetition_penalty

    def penalty(lg, recent, p):
        jax.debug.callback(lambda a: seen.append(np.asarray(a)[0]), lg)
        return real(lg, recent, p)
    monkeypatch.setattr(mod, "sampling", types.SimpleNamespace(
        **{**vars(mod.sampling), "apply_repetition_penalty": penalty}))
    return seen


def record_port_logits(gen):
    """The port generator's merged logits a token (the prefill's, then each step's)."""
    seen = []
    prefill, step_fn = gen.prefill, gen.step_fn

    def rec_prefill(*a):
        out = prefill(*a)
        seen.append(out[0][0].numpy().copy())
        return out

    def rec_step_fn(*a):
        step = step_fn(*a)

        def run(tok, cache):
            logits, cache = step(tok, cache)
            seen.append(logits[0].numpy().copy())
            return logits, cache
        return run
    gen.prefill, gen.step_fn = rec_prefill, rec_step_fn
    return seen


@pytest.mark.parametrize("tree", ["fp", "q4"])
def test_t3_generate_matches_jax_on_its_draws(t3_parts, f32_cache, monkeypatch, request, tree):
    """The CFG decode (cfg_weight 0.5, the default sampler) on the JAX
    draws: every token's merged logits within rel 1e-5 and the tokens
    equal, the text in a bucket of 32 with its pad slots masked. On the q4
    tree (every linear, the embeddings and the heads group-affine; the
    position tables fp, which the JAX generator reads as weights) the JAX
    linears of ≤ 32 rows run its `quant_matmul` kernel in interpret mode."""
    jcfg, tcfg, jp, tp = t3_parts
    if tree == "q4":
        request.getfixturevalue("jax_quant_matmul")
        jp = jquant.quantize_tree(jp, bits=4, predicate=lambda k, v: "pos_emb" not in k)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        assert "weight_q4" in tp["speech_head"] and "weight_q4" in tp["tfmr"]["layers"]["mlp"][
            "gate"]
    rng = np.random.default_rng(4)
    spk, cond_toks = rng.standard_normal((1, 32)).astype(np.float32), rng.integers(0, V, (1, 9))
    jcond = jt3.prepare_conditioning(jp, jcfg, jnp.asarray(spk), jnp.asarray(cond_toks), 0.5)
    tcond = tt3.prepare_conditioning(tp, tcfg, t(spk), torch.from_numpy(cond_toks), 0.5)
    close(tcond, jcond, 1e-5)
    ref_logits = record_jax_logits(monkeypatch, jt3)
    ref = jt3.T3Generator(jp, jcfg, max_cache=128).generate(jcond, TEXT, max_new=24, seed=3)
    gen = tt3.T3Generator(tp, tcfg, cache_dtype=torch.float32)
    got_logits = record_port_logits(gen)
    got = gen.generate(tcond, TEXT, max_new=24, noise=jax_draws(3, 24))
    assert got == ref and len(got) >= 6
    assert len(got_logits) >= len(ref_logits) >= len(got)
    for g, r in zip(got_logits, ref_logits):
        close(g, r, 1e-5)


def test_t3_bucket_and_the_first_steps_speech_position(t3_parts):
    """The prefill's logits do not depend on the text bucket (32 or 64
    slots); the first generated token is fed at speech position 2
    (STEP_POS0, ROADMAP C23): its step's logits equal a fresh prefill of
    [cond | text | BOS | token] with the token's row read at position 2,
    and differ from one at position 1."""
    _, tcfg, _, tp = t3_parts
    cond = tt3.prepare_conditioning(tp, tcfg, torch.zeros(1, 32), None, 0.5)
    gen = tt3.T3Generator(tp, tcfg, cache_dtype=torch.float32)
    logits, cache, extra, total = gen.prefill(cond, TEXT, 8, 0.5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt3, "text_bucket", lambda n: 64)
        wide, _, _, total64 = gen.prefill(cond, TEXT, 8, 0.5)
    assert total64 == total + 32
    close(wide, logits, 1e-5)
    tok = torch.tensor([[17]])
    step, _ = gen.step_fn(extra, total, 0.5)(tok, cache)
    assert tt3.STEP_POS0 == 2

    def fresh(pos: int):
        with pytest.MonkeyPatch.context() as mp:
            real = gen.speech_rows
            rows = real(tok.expand(2, 1), torch.tensor(pos))
            mp.setattr(gen, "speech_rows", lambda t_, p_: torch.cat(
                [real(t_, p_), rows], dim=1))
            out, _, _, _ = gen.prefill(cond, TEXT, 8, 0.5)
        return out
    close(step, fresh(2), 1e-5)
    assert np.abs((fresh(1) - step).numpy()).max() > 1e-3


def test_c22_caches_sized_for_the_request_or_refused(t3_parts):
    """ROADMAP C22: a given cache too small for the prefill + max_new + the
    loop's check interval is refused; by default the cache takes what the
    request needs (the JAX engine's 512 slots clamp a 600-token sentence)."""
    _, tcfg, _, tp = t3_parts
    cond = tt3.prepare_conditioning(tp, tcfg, torch.zeros(1, 32), None, 0.5)
    with pytest.raises(ValueError, match="C22"):
        tt3.T3Generator(tp, tcfg, max_cache=64).generate(cond, TEXT, max_new=40)
    gen = tt3.T3Generator(tp, tcfg)
    _, cache, _, total = gen.prefill(cond, TEXT, 600 + 8, 0.5)
    assert cache.max_len >= total + 608 and cache.k.shape[1] == 2  # the CFG batch


# ------------------------------------------------------------------ engine

@pytest.fixture(scope="module")
def engine_parts(t3_parts, gen_parts):  # noqa: F811
    jcfg, tcfg, jp, tp = t3_parts
    js3cfg, ts3cfg, js3, ts3 = gen_parts
    rng = np.random.default_rng(5)
    jvcfg, tvcfg = jve.VoiceEncConfig(**VE), tve.VoiceEncConfig(**VE)
    jv, tv = both(jitter(tve.numpy_params(rng, tvcfg), rng))
    tok_np = ts3tok.numpy_params(np.random.default_rng(2), ts3tok.S3TokenizerConfig(**TOK))
    jtok = jax.tree.map(jnp.asarray, tok_np)
    return ((jp, jcfg, js3, js3cfg, jtok, js3model.S3TokenizerConfig(**TOK), jv, jvcfg),
            (tp, tcfg, ts3, ts3cfg, to_torch(jtok), ts3tok.S3TokenizerConfig(**TOK), tv, tvcfg))


def jax_noises(seed):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return JaxNoise(k1), JaxNoise(k2)


def test_speaker_and_audio_match_jax(engine_parts, f32_cache, monkeypatch):
    """`prepare_conditionals` on 1.5 s of noise at 22.05 kHz (the resamples,
    both crops' S3 tokens equal, the prompt mel, the x-vector and the voice
    encoder's embedding within 1e-4), then `generate` of two sentences
    with exaggeration 0.7 on the JAX draws (T3's and S3Gen's): each
    sentence's audio within rel 2e-3."""
    jparts, tparts = engine_parts
    ref = jengine.ChatterboxEngine.from_params(*jparts, max_cache=256)
    eng = tengine.ChatterboxEngine.from_params(*tparts)
    eng.t3_gen.cache_dtype = torch.float32
    audio = (0.1 * np.random.default_rng(6).standard_normal(33075)).astype(np.float32)
    rc = ref.prepare_conditionals(audio, 22050, exaggeration=0.7)
    tc = eng.prepare_conditionals(audio, 22050, exaggeration=0.7)
    assert tc.t3_cond_tokens.tolist() == np.asarray(rc.t3_cond_tokens).tolist()
    assert tc.prompt_tokens.tolist() == np.asarray(rc.prompt_tokens).tolist()
    for name in ("prompt_mel", "embedding", "speaker_emb"):
        close(getattr(tc, name), getattr(rc, name))
    assert tc.prompt_mel.shape[1] == 2 * tc.prompt_tokens.shape[1]
    monkeypatch.setattr(eng, "noises", jax_noises)
    generate = eng.t3_gen.generate
    monkeypatch.setattr(eng.t3_gen, "generate", lambda *a, seed, **k: generate(
        *a, seed=seed, noise=jax_draws(seed, k["max_new"]), **k))
    text = ("This first sentence is long enough to stand alone here. "
            "And the second sentence follows it in the same request.")
    got = list(eng.generate_streaming(text, max_new_tokens=30))
    want = list(ref.generate_streaming(text, max_new_tokens=30))
    assert [c.text for c in got] == [c.text for c in want] and len(got) == 2
    assert [c.is_final for c in got] == [False, True]
    for g, r in zip(got, want):
        assert len(g.samples) > 0
        close(torch.from_numpy(g.samples), r.samples, HIFT_REL)


def test_engine_with_every_default(engine_parts):
    """ROADMAP C7/C22: `from_params` and `generate` with their public
    defaults (the zero speaker, max_new_tokens 600, the cache sized per
    request, the byte-level tokenizer): finite audio at 24 kHz; the
    factory's engine on the card by default."""
    _, tparts = engine_parts
    eng = tengine.ChatterboxEngine.from_params(*tparts)
    assert eng.t3_gen.max_cache is None and eng.cfg_weight == 0.5
    res = eng.generate("Hello there, how are you?")
    assert res.sample_rate == 24000 and len(res.samples) and np.isfinite(res.samples).all()
    assert TTS.chatterbox().device == "cuda" and TTS.chatterbox(device="cpu").variant == "fp16"
    assert tengine.punc_norm("hello world") == "Hello world." == jengine.punc_norm("hello world")
    assert "add some text" in tengine.punc_norm("")


# ------------------------------------------------------------------ load

def test_convert_and_load_from_a_written_checkpoint(engine_parts, tmp_path, monkeypatch):
    """A 4-bit checkpoint in the published layout (chip_smoke's
    `chatterbox_flat`: T3 q4 under t3.tfmr.*, S3Gen's kernels in torch's
    layouts, the voice encoder as it is): `convert_numpy` equals the JAX
    rules leaf for leaf, bit for bit; `load("4bit")` from a seeded cache
    gives the trees of `from_params`, whose T3 makes the same tokens."""
    (jp, _, js3, _, jtok, _, jv, _), (_, tcfg, _, ts3cfg, _, tokcfg, _, tvcfg) = engine_parts
    jq = jquant.quantize_tree(jp, bits=4, predicate=lambda k, v: "pos_emb" not in k)
    t3_np, s3_np, ve_np = (jax.tree.map(np.asarray, x) for x in (jq, js3, jv))
    flat = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in
            chip_smoke.chatterbox_flat(params_from_numpy(t3_np, device="cpu"), s3_np,
                                       ve_np).items()}
    groups = jload._split_prefixes(dict(flat))
    for got, ref in zip(tload.convert_numpy(dict(flat)),
                        (jload._convert_t3(groups["t3"]),
                         pytree.unflatten(jload._convert_conv_layouts(groups["s3gen"])),
                         pytree.unflatten(groups["ve"]))):
        g, r = pytree.flatten(got), pytree.flatten(ref)
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(r[k]), err_msg=k)
    root = tmp_path / "hub"
    chip_smoke.seed_cache(root, tload.REPOS["4bit"], {
        "model.safetensors": lambda p: chip_smoke.write_safetensors(p, flat)})
    chip_smoke.seed_cache(root, tload.S3TOK_REPO, {
        "model.safetensors": lambda p: chip_smoke.write_safetensors(
            p, chip_smoke.s3tokenizer_mlx_flat(jax.tree.map(np.asarray, jtok)))})
    monkeypatch.setenv("TPU_AUDIO_CACHE", str(root))
    t3_t, cfg, s3_t, s3cfg, tok_t, _, ve_t, vcfg, _ = tload.load("4bit", device="cpu")
    assert cfg == tt3.T3Config() and s3cfg.mel_dim == 80 and vcfg == tve.VoiceEncConfig()
    for got, want in ((t3_t, params_from_numpy(t3_np, device="cpu")),
                      (s3_t, s3_params_from_numpy(s3_np, "cpu")), (tok_t, to_torch(jtok)),
                      (ve_t, params_from_numpy(ve_np, device="cpu"))):
        g, w = pytree.flatten(got), pytree.flatten(want)
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k], w[k]), k
    eng = TTS.chatterbox("4bit", device="cpu")
    monkeypatch.setattr(tload, "load", lambda variant, device: (
        t3_t, tcfg, s3_t, ts3cfg, tok_t, tokcfg, ve_t, tvcfg, None))
    eng.load()
    cond = tt3.prepare_conditioning(t3_t, tcfg, torch.zeros(1, 32), None, 0.5)
    want = tt3.T3Generator(params_from_numpy(t3_np, device="cpu"), tcfg).generate(
        cond, TEXT, max_new=12, seed=1)
    assert eng.is_loaded and eng.t3_gen.generate(cond, TEXT, max_new=12, seed=1) == want
