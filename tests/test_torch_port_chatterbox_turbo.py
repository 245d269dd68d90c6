"""PyTorch port, Chatterbox Turbo (tpu_audio_torch/models/chatterbox_turbo/,
the meanflow estimator of codecs/s3gen/flow.py) against the JAX package on
the CPU: the meanflow estimator with and without its mixer and
`meanflow_inference`, the GPT-2 T3's decode on the fp and q4 trees (its
logits and tokens, its positions), the chunked streamer, the streamed
synthesis, the engine at SENTENCE and TOKEN granularity, every public
default, ROADMAP C22 and C24, and `load()` from checkpoints the test
writes.

Tiny configs: the GPT-2 T3 at dim 48 × 2 layers (4 heads of 12, hidden 96;
tests/test_chatterbox_turbo.py's), and at dim 64 (hidden 128) where a tree
is quantised (48 is no multiple of the group of 64); S3Gen, the S3
tokenizer and the voice encoder those of tests/test_torch_port_s3.py and
tests/test_torch_port_chatterbox.py, the estimator with a random
`time_embed_mixer`. The JAX draws are injected as there; the streamer's
are chunk c's key's splits. T3's caches are f32 in both packages.

Tolerances: modules f32 rel 1e-5 (the estimator and the meanflow solve
1e-4: tests/test_torch_port_s3.py's for the flow); logits rel 1e-5 and
tokens equal; waveforms rel 2e-3 (HiFT's phase); converted leaves bit for
bit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_port_chatterbox import (VE, both, engine_parts, f32_cache,  # noqa: F401
                                              jax_noises, jitter, record_jax_logits,
                                              record_port_logits, t3_parts)
from tests.test_torch_port_quant_q4 import interpret_pallas  # noqa: F401
from tests.test_torch_port_s3 import (EST, HIFT_REL, JaxNoise, close, gen_parts,  # noqa: F401
                                      t, to_torch)
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401
from tests.test_torch_port_whisper_q4 import jax_quant_matmul  # noqa: F401
from tpu_audio.codecs.s3gen import flow as jflow
from tpu_audio.models.chatterbox_turbo import engine as jengine
from tpu_audio.models.chatterbox_turbo import load as jload
from tpu_audio.models.chatterbox_turbo import model as jturbo
from tpu_audio.models.chatterbox_turbo import streaming as jstreaming
from tpu_audio.nn import transformer as jt
from tpu_audio.ops import quant as jquant
from tpu_audio_torch.api.tts import TTS, StreamingGranularity
from tpu_audio_torch.codecs.s3gen import flow as tflow
from tpu_audio_torch.convert import params_from_numpy, s3_params_from_numpy
from tpu_audio_torch.models.chatterbox import load as cload
from tpu_audio_torch.models.chatterbox_turbo import engine as tengine
from tpu_audio_torch.models.chatterbox_turbo import load as tload
from tpu_audio_torch.models.chatterbox_turbo import model as tturbo
from tpu_audio_torch.models.chatterbox_turbo import streaming as tstreaming
from tpu_audio_torch.nn import transformer as tt
from tpu_audio_torch.utils import pytree

GPT2 = dict(dim=48, n_layers=2, n_heads=4, n_kv_heads=4, hidden_dim=96, mlp="gelu_new",
            norm="ln", pos_emb="none")
GPT2_64 = dict(GPT2, dim=64, hidden_dim=128)
TURBO = dict(text_tokens_dict_size=300, speech_tokens_dict_size=80, start_speech_token=70,
             stop_speech_token=71, speaker_embed_size=32, max_positions=512)
V = TURBO["speech_tokens_dict_size"]
TEXT = [5, 6, 7, 8, 9]


def turbo_parts(gpt2: dict, seed: int = 0):
    """(JAX cfg, port cfg, JAX tree, port tree) with random biases (q, k,
    v and o too, as the published GPT-2 has them) and norms."""
    jcfg = jturbo.T3TurboConfig(gpt2=jt.TransformerConfig(**gpt2), **TURBO)
    tcfg = tturbo.T3TurboConfig(gpt2=tt.TransformerConfig(**gpt2), **TURBO)
    rng = np.random.default_rng(seed)
    biased = dataclasses.replace(tcfg.gpt2, attn_qkv_bias=True, attn_o_bias=True)
    np_tree = jitter(tturbo.numpy_params(rng, dataclasses.replace(tcfg, gpt2=biased)), rng)
    return (jcfg, tcfg, *both(np_tree))


@pytest.fixture(scope="module")
def parts():
    return turbo_parts(GPT2)


def jax_draws(seed: int, n: int):
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.gumbel(sub, (1, V)))))
    return lambda i: out[i]


def stream_draws(seed: int, sizes: list[int]):
    """The JAX streamer's draws: chunk c's key is the c-th split of
    PRNGKey(seed), its token i's draw the i-th split of that."""
    key, chunks = jax.random.PRNGKey(seed), []
    for size in sizes:
        key, sub = jax.random.split(key)
        k, row = sub, []
        for _ in range(size):
            k, s = jax.random.split(k)
            row.append(torch.from_numpy(np.array(jax.random.gumbel(s, (1, V)))))
        chunks.append(row)
    return lambda c, i: chunks[c][i]


# ------------------------------------------------------------------ meanflow

@pytest.fixture(scope="module")
def mixer_tree(gen_parts):  # noqa: F811
    """The tiny S3Gen with a random time_embed_mixer in its estimator."""
    jcfg, tcfg, jp, tp = gen_parts
    ch4 = EST["channels"] * 4
    w = (np.random.default_rng(9).random((ch4, 2 * ch4), dtype=np.float32) * 2 - 1) / np.sqrt(
        2 * ch4)
    jp = dict(jp, flow=dict(jp["flow"], decoder_estimator=dict(
        jp["flow"]["decoder_estimator"], time_embed_mixer={"weight": jnp.asarray(w)})))
    return jcfg, tcfg, jp, to_torch(jp)


def test_numpy_estimator_carries_the_mixer():
    cfg = tflow.EstimatorConfig(**EST, meanflow=True)
    p = tflow.numpy_estimator(np.random.default_rng(0), cfg)
    assert p["time_embed_mixer"]["weight"].shape == (128, 256)
    assert "bias" not in p["time_embed_mixer"]
    assert "time_embed_mixer" not in tflow.numpy_estimator(np.random.default_rng(0),
                                                           tflow.EstimatorConfig(**EST))
    jp = jax.eval_shape(lambda: jflow.init_estimator(jax.random.PRNGKey(0),
                                                     jflow.EstimatorConfig(**EST, meanflow=True)))
    assert jp["time_embed_mixer"]["weight"].shape == p["time_embed_mixer"]["weight"].shape


def test_meanflow_estimator_and_inference_match_jax(mixer_tree, gen_parts):  # noqa: F811
    """estimator_forward with r through the mixer, and without a mixer in
    the tree (r ignored: the t-only estimator, as the JAX callers drop r);
    `meanflow_inference` (2 steps, linear grid, no CFG) on the JAX key's z,
    streaming masks on and off."""
    jcfg, tcfg, jp, tp = mixer_tree
    jest, test_ = jp["flow"]["decoder_estimator"], tp["flow"]["decoder_estimator"]
    rng = np.random.default_rng(4)
    x, mu, cond = (rng.standard_normal((2, 20, 16)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((2, 16)).astype(np.float32)
    ml, tv, rv = np.array([20, 13]), np.array([0.0, 0.3], np.float32), np.array([0.5, 1.0],
                                                                                np.float32)
    ref = jflow.estimator_forward(jest, jcfg.estimator, *map(jnp.asarray, (x, ml, mu, tv, spks,
                                                                            cond)), r=rv)
    got = tflow.estimator_forward(test_, tcfg.estimator, *map(torch.from_numpy, (x, ml, mu, tv,
                                                                              spks, cond)),
                                  r=torch.from_numpy(rv))
    close(got, ref, 1e-4)
    plain = {k: v for k, v in test_.items() if k != "time_embed_mixer"}
    t_only = jflow.estimator_forward(gen_parts[2]["flow"]["decoder_estimator"], jcfg.estimator,
                                     *map(jnp.asarray, (x, ml, mu, tv, spks, cond)))
    close(tflow.estimator_forward(plain, tcfg.estimator, *map(torch.from_numpy, (
        x, ml, mu, tv, spks, cond)), r=torch.from_numpy(rv)), t_only, 1e-4)
    assert np.abs(np.asarray(ref) - np.asarray(t_only)).max() > 1e-2

    def jest_fn(x_, ml_, mu_, t_, s_, c_, stream, r=None):
        return jflow.estimator_forward(jest, jcfg.estimator, x_, ml_, mu_, t_, s_, c_, stream,
                                       r=r)

    def test_fn(x_, ml_, mu_, t_, s_, c_, stream, r):
        return tflow.estimator_forward(test_, tcfg.estimator, x_, ml_, mu_, t_, s_, c_, stream,
                                       r=r)
    key = jax.random.PRNGKey(5)
    for streaming in (False, True):
        ref = jturbo.meanflow_inference(jest_fn, jnp.asarray(mu[:1]), jnp.asarray([17]),
                                        jnp.asarray(spks[:1]), jnp.asarray(cond[:1]), key,
                                        n_timesteps=2, streaming=streaming)
        got = tturbo.meanflow_inference(test_fn, t(mu[:1]), torch.tensor([17]), t(spks[:1]),
                                        t(cond[:1]), JaxNoise(key).z((1, 20, 16), "cpu"),
                                        n_timesteps=2, streaming=streaming)
        close(got, ref, 1e-4)


# ------------------------------------------------------------------ T3

@pytest.mark.parametrize("tree", ["fp", "q4"])
def test_turbo_generate_matches_jax_on_its_draws(f32_cache, monkeypatch, request, tree):
    """The decode (the default sampler) on the JAX draws: each token's
    logits within rel 1e-5 and the tokens equal. q4: the 64-wide GPT-2
    with every linear, table and the head group-affine (the position
    table fp, which the JAX generator reads as a weight), the JAX linears
    of ≤ 32 rows through its `quant_matmul` in interpret mode."""
    jcfg, tcfg, jp, tp = turbo_parts(GPT2 if tree == "fp" else GPT2_64)
    if tree == "q4":
        request.getfixturevalue("jax_quant_matmul")
        jp = jquant.quantize_tree(jp, bits=4, predicate=lambda k, v: not k.startswith("wpe"))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        assert "weight_q4" in tp["speech_head"] and "bias" in tp["tfmr"]["layers"]["attn"]["q"]
    spk = np.random.default_rng(6).standard_normal((1, 32)).astype(np.float32)
    ref_logits = record_jax_logits(monkeypatch, jturbo)
    ref = jturbo.T3TurboGenerator(jp, jcfg, max_cache=128).generate(jnp.asarray(spk), TEXT,
                                                                    max_new=24, seed=2)
    gen = tturbo.T3TurboGenerator(tp, tcfg, cache_dtype=torch.float32)
    got_logits = record_port_logits(gen)
    got = gen.generate(t(spk), TEXT, max_new=24, noise=jax_draws(2, 24))
    assert got == ref and len(got) >= 6
    assert len(got_logits) >= len(ref_logits) >= len(got)
    for g, r in zip(got_logits, ref_logits):
        close(g, r, 1e-5)


def test_positions_match_a_teacher_forced_recompute(parts):
    """Generated token k is read at position n_text + 2 + k: greedy
    incremental tokens equal those of re-running the whole sequence with
    consecutive positions 0 … L−1 each step (the JAX package's own check,
    on the port), and the prefill's logits do not depend on the bucket."""
    _, tcfg, _, tp = parts
    near_greedy = tturbo.TurboSampler(temperature=1e-4, top_p=1.0, min_p=0.0,
                                      repetition_penalty=1.0)
    gen = tturbo.T3TurboGenerator(tp, tcfg, cache_dtype=torch.float32)
    spk = torch.randn(1, 32, generator=torch.Generator().manual_seed(3))
    got = gen.generate(spk, TEXT, sampler=near_greedy, max_new=8)
    from tpu_audio_torch.nn import layers

    ref, out = [], []
    for _ in range(8):
        seq = torch.tensor([[tcfg.start_speech_token] + out])
        x = torch.cat([layers.linear(tp["cond_enc"]["spkr_enc"], spk)[:, None],
                       layers.embedding(tp["text_emb"], torch.tensor([TEXT])),
                       layers.embedding(tp["speech_emb"], seq)], dim=1)
        x = x + layers.embedding(tp["wpe"], torch.arange(x.shape[1]))[None]
        cache = tt.make_cache(tcfg.gpt2, 1, x.shape[1], torch.float32, device="cpu")
        h, _ = tt.forward_hidden(tp["tfmr"], tcfg.gpt2, x, cache)
        out.append(int(layers.linear(tp["speech_head"], h[0, -1]).argmax()))
        if out[-1] == tcfg.stop_speech_token:
            break
    ref = [t_ for t_ in out if t_ < tcfg.start_speech_token]
    assert got == ref[: len(got)] and len(got) >= 4
    logits, _, _, _ = gen.prefill(spk, TEXT, 4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tturbo, "text_bucket", lambda n: 64)
        wide, _, _, total = gen.prefill(spk, TEXT, 4)
    assert total == 66
    close(wide, logits, 1e-5)


def test_streamer_matches_jax_and_generate(parts, f32_cache):
    """The chunked streamer (chunks of 5, the first 5 + 3, max_new 17 so
    the last chunk is trimmed) against the JAX streamer on its draws, and
    against the port's one-shot `generate` from the same seed (the same
    draws in the same order)."""
    jcfg, tcfg, jp, tp = parts
    spk = np.random.default_rng(7).standard_normal((1, 32)).astype(np.float32)
    sampler = tturbo.TurboSampler(repetition_penalty=1.3)
    jsampler = jturbo.TurboSampler(repetition_penalty=1.3)
    ref = list(jturbo.T3TurboStreamer(jturbo.T3TurboGenerator(jp, jcfg, max_cache=128), chunk=5,
                                      first_extra=3).stream(jnp.asarray(spk), TEXT,
                                                            sampler=jsampler, max_new=17,
                                                            seed=4))
    gen = tturbo.T3TurboGenerator(tp, tcfg, cache_dtype=torch.float32)
    streamer = tturbo.T3TurboStreamer(gen, chunk=5, first_extra=3)
    got = list(streamer.stream(t(spk), TEXT, sampler=sampler, max_new=17,
                               noise=stream_draws(4, [8, 5, 5, 5])))
    assert got == ref and sum(map(len, got)) >= 8
    assert all(len(c) <= 5 for c in got[1:]) and len(got[0]) <= 8
    one_shot = gen.generate(t(spk), TEXT, sampler=sampler, max_new=17, seed=9)
    assert sum(streamer.stream(t(spk), TEXT, sampler=sampler, max_new=17, seed=9), []) == one_shot


def test_c22_cache_refused_or_sized(parts):
    _, tcfg, _, tp = parts
    with pytest.raises(ValueError, match="C22"):
        tturbo.T3TurboGenerator(tp, tcfg, max_cache=64).generate(torch.zeros(1, 32), TEXT,
                                                                 max_new=40)
    _, cache, _, total = tturbo.T3TurboGenerator(tp, tcfg).prefill(torch.zeros(1, 32), TEXT,
                                                                   608)
    assert total == 34 and cache.max_len >= 34 + 608


# ------------------------------------------------------------------ synthesis

def test_turbo_synthesizer_matches_jax(mixer_tree):
    """`TurboSynthesizer.stream` (the meanflow window) on 50 tokens in chunks
    of 25, 15, 10 with 3 silence tokens among them (`drop_silence`), a
    6-token prompt, windows capped at 30 tokens with a rebase of 10 (the
    second window retires the first 25), the JAX draws: every emitted chunk
    within rel 2e-3."""
    jcfg, tcfg, jp, tp = mixer_tree
    rng = np.random.default_rng(8)
    toks = rng.integers(0, 64, 53).tolist()
    for i in (3, 30, 47):
        toks[i] = tturbo.SILENCE_TOKEN
    chunks = [toks[:26], toks[26:42], toks[42:]]
    pt = rng.integers(0, 64, 6).tolist()
    pm = rng.standard_normal((1, 12, 16)).astype(np.float32)
    emb = rng.standard_normal((1, 24)).astype(np.float32)
    js = jstreaming.TurboSynthesizer(jp, jcfg, n_timesteps=2)
    js.max_window_tokens, js.rebase_prompt_tokens = 30, 10
    ref = list(js.stream(jstreaming.drop_silence(iter(chunks)), pt, jnp.asarray(pm),
                         jnp.asarray(emb), seed=3))
    ts = tstreaming.TurboSynthesizer(tp, tcfg, n_timesteps=2)
    ts.max_window_tokens, ts.rebase_prompt_tokens = 30, 10
    key = jax.random.PRNGKey(3)
    got = list(ts.stream(tstreaming.drop_silence(iter(chunks)), pt, t(pm), t(emb),
                         flow_noise=JaxNoise(key), hift_noise=JaxNoise(key)))
    assert [len(g) for g in got] == [len(r) for r in ref] and len(got) >= 2
    for g, r in zip(got, ref):
        close(torch.from_numpy(g), r, HIFT_REL)


# ------------------------------------------------------------------ engine

@pytest.fixture(scope="module")
def turbo_engine_parts(parts, mixer_tree, engine_parts):  # noqa: F811
    jcfg, tcfg, jp, tp = parts
    js3cfg, ts3cfg, js3, ts3 = mixer_tree
    (_, _, _, _, jtok, jtokcfg, jv, jvcfg), (_, _, _, _, ttok, ttokcfg, tv, tvcfg) = engine_parts
    return ((jp, jcfg, js3, js3cfg, jtok, jtokcfg, jv, jvcfg),
            (tp, tcfg, ts3, ts3cfg, ttok, ttokcfg, tv, tvcfg))


def test_engine_matches_jax_at_sentence_and_token_granularity(turbo_engine_parts, f32_cache,
                                                              monkeypatch):
    """A speaker from 1.2 s of noise, then `generate` of two sentences
    (SENTENCE: one decode and one meanflow pass a sentence) and
    `generate_streaming` of one at TOKEN granularity (the streamer's
    chunks, the windowed flow, the first chunk faded in, the last marked
    final) on the JAX draws: each chunk's audio within rel 2e-3 of the JAX
    engine's."""
    jparts, tparts = turbo_engine_parts
    ref = jengine.ChatterboxTurboEngine.from_turbo_params(*jparts, max_cache=256)
    eng = tengine.ChatterboxTurboEngine.from_turbo_params(*tparts)
    eng.turbo_gen.cache_dtype = torch.float32
    audio = (0.1 * np.random.default_rng(10).standard_normal(19200)).astype(np.float32)
    ref.prepare_conditionals(audio, 16000)
    eng.prepare_conditionals(audio, 16000)
    text = ("This first sentence is long enough to stand alone here. "
            "And the second sentence follows it in the same request.")
    generate = eng.turbo_gen.generate
    monkeypatch.setattr(eng.turbo_gen, "generate", lambda *a, seed, **k: generate(
        *a, seed=seed, noise=jax_draws(seed, k["max_new"]), **k))
    monkeypatch.setattr(eng, "noises", jax_noises)
    got, want = eng.generate(text, max_new_tokens=30), ref.generate(text, max_new_tokens=30)
    assert len(got.samples) > 0
    close(torch.from_numpy(got.samples), want.samples, HIFT_REL)

    stream = eng.streamer().stream
    monkeypatch.setattr(eng.streamer(), "stream", lambda *a, seed, **k: stream(
        *a, seed=seed, noise=stream_draws(seed, [28, 25]), **k))
    monkeypatch.setattr(eng, "noises", lambda seed: (JaxNoise(jax.random.PRNGKey(seed)),) * 2)
    first = text[: text.index(".") + 1]
    got = list(eng.generate_streaming(first, max_new_tokens=33))
    want = list(ref.generate_streaming(first, max_new_tokens=33))
    assert eng.default_streaming_granularity == StreamingGranularity.TOKEN
    assert [c.is_final for c in got] == [c.is_final for c in want] == [False] * (
        len(got) - 1) + [True]
    assert [c.text for c in got] == [c.text for c in want] and len(got) >= 2
    assert not np.abs(got[0].samples[:480]).any()
    for g, r in zip(got, want):
        close(torch.from_numpy(g.samples), r.samples, HIFT_REL)


def test_engine_with_every_default(turbo_engine_parts):
    """ROADMAP C7/C22: `from_turbo_params`, `generate` and
    `generate_streaming` (TOKEN) with their public defaults (the zero
    speaker, max_new_tokens 600, 2 meanflow steps, the cache sized per
    request): finite audio at 24 kHz; the factory's engine on the card by
    default. The speech head gets a bias that makes the stop token likely
    (+2.5 on its logit), so that a sentence ends within ~50 tokens."""
    (tp, *rest), = turbo_engine_parts[1:]
    bias = torch.zeros(V)
    bias[TURBO["stop_speech_token"]] = 2.5
    tp = dict(tp, speech_head=dict(tp["speech_head"], bias=bias))
    eng = tengine.ChatterboxTurboEngine.from_turbo_params(tp, *rest)
    assert eng.turbo_gen.max_cache is None and eng.meanflow_steps == 2
    res = eng.generate("Hello there, how are you?")
    assert res.sample_rate == 24000 and len(res.samples) and np.isfinite(res.samples).all()
    text = ("This first sentence is long enough to stand alone here. "
            "And the second sentence follows it in the same request.")
    chunks = list(eng.generate_streaming(text))
    assert [c.is_final for c in chunks] == [False] * (len(chunks) - 1) + [True]
    assert {c.text for c in chunks} == {text[:55], text[56:]}
    assert all(np.isfinite(c.samples).all() for c in chunks)
    assert TTS.chatterbox_turbo().device == "cuda"


# ------------------------------------------------------------------ load

def seeded(root, repo, flat, tok_np) -> dict:
    """A cache under root holding the checkpoint and S3TokenizerV2: {repo:
    its snapshot directory}."""
    return {repo: chip_smoke.seed_cache(root, repo, {
        "model.safetensors": lambda p: chip_smoke.write_safetensors(p, flat)})[0],
        cload.S3TOK_REPO: chip_smoke.seed_cache(root, cload.S3TOK_REPO, {
            "model.safetensors": lambda p: chip_smoke.write_safetensors(
                p, chip_smoke.s3tokenizer_mlx_flat(tok_np))})[0]}


def numpy_flat(flat: dict) -> dict:
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in flat.items()}


def test_load_from_written_checkpoints(engine_parts, mixer_tree, tmp_path,  # noqa: F811
                                       monkeypatch):
    """fp16 and 4-bit checkpoints in the published layout (chip_smoke's
    `turbo_flat`): the port's `load` gives the T3 trees that were written,
    and S3Gen, the S3 tokenizer and the voice encoder equal to the JAX
    `load`'s bit for bit (in the port's layouts); on the 4-bit tree the
    engine decodes as `from_turbo_params` does. ROADMAP C24, pinned: the
    JAX loader's T3 holds no GPT-2 stack (T3's own leaves, nested under
    "tfmr.", replace it), and it refuses the 4-bit file (it splits the
    packed c_attn words as Conv1D floats)."""
    (_, _, _, _, jtok, _, jv, _), (_, _, _, _, ttok, ttokcfg, tv, tvcfg) = engine_parts
    _, s3cfg, js3, ts3 = mixer_tree
    s3_np, ve_np, tok_np = (jax.tree.map(np.asarray, x) for x in (js3, jv, jtok))
    jcfg, tcfg, jp, tp = turbo_parts(GPT2_64, seed=1)
    for variant in ("fp16", "4bit"):
        jtree = jp if variant == "fp16" else jquant.quantize_tree(
            jp, bits=4, predicate=lambda k, v: not k.startswith("wpe"))
        t3_np = jax.tree.map(np.asarray, jtree)
        flat = numpy_flat(chip_smoke.turbo_flat(params_from_numpy(t3_np, device="cpu"), s3_np,
                                                ve_np))
        root = tmp_path / variant
        snap = seeded(root, tload.REPOS[variant], flat, tok_np)
        monkeypatch.setenv("TPU_AUDIO_CACHE", str(root))
        got = tload.load(variant, device="cpu")
        assert got[1] == tturbo.T3TurboConfig() and got[3].estimator.meanflow
        want = [params_from_numpy(t3_np, device="cpu"), s3_params_from_numpy(s3_np, "cpu"),
                to_torch(tok_np), params_from_numpy(ve_np, device="cpu")]
        monkeypatch.setattr(jload.hub, "snapshot",
                            lambda repo, matching=None, snap=snap, **k: str(snap[repo]))
        if variant == "fp16":
            jgot = jload.load(variant)
            assert "layers" not in jgot[0]["tfmr"] and "speech_emb" in jgot[0]["tfmr"]
            want[1:] = [s3_params_from_numpy(jax.tree.map(np.asarray, jgot[2]), "cpu"),
                        to_torch(jgot[4]),
                        params_from_numpy(jax.tree.map(np.asarray, jgot[6]), device="cpu")]
        else:
            with pytest.raises(ValueError):
                jload.load(variant)
        for g_tree, w_tree in zip((got[0], got[2], got[4], got[6]), want):
            g, w = pytree.flatten(g_tree), pytree.flatten(w_tree)
            assert g.keys() == w.keys(), sorted(set(g) ^ set(w))[:6]
            for k in w:
                assert torch.equal(g[k], w[k]), k
    eng = TTS.chatterbox_turbo("4bit", device="cpu")
    monkeypatch.setattr(tload, "load", lambda variant, device: (
        got[0], tcfg, got[2], s3cfg, got[4], ttokcfg, got[6], tvcfg, None))
    eng.load()
    spk = torch.zeros(1, 32)
    want = tturbo.T3TurboGenerator(params_from_numpy(t3_np, device="cpu"), tcfg).generate(
        spk, TEXT, max_new=12, seed=1)
    assert eng.is_loaded and eng.turbo_gen.generate(spk, TEXT, max_new=12, seed=1) == want
    assert "weight_q4" in eng.turbo_gen.params["tfmr"]["layers"]["attn"]["q"]
