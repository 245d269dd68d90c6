"""PyTorch port, CosyVoice3 (tpu_audio_torch/models/cosyvoice3/) against the
JAX package on the CPU: the DiT's `forward` (full and chunk-causal masks),
`forward_chunk` over aligned and ragged chunks with its frozen keys,
values and conv tails, `roll_stream_caches`, `cfm_solve_chunk`,
`flow_chunk`, `CV3Synthesizer.stream` on both flow policies and across
the auto switch, the engine (speaker, voice conversion, token and sentence
streaming on the same LM tokens, every public default, speculative="ngram")
and `load()` from a checkpoint the test writes.

A tiny flow (DiT 64 wide, 2 blocks of 4 heads of 16, chunks of 8 frames;
mel 16; the S3 tests' tiny HiFT and tokenizer; 2 Euler steps). The JAX
draws are injected: the full window's z is `normal(PRNGKey(seed))`, a
cached chunk's `normal(fold_in(PRNGKey(seed + 7), lo))`, HiFT's as in
tests/test_torch_port_s3.py. Tolerances: the DiT and the flow rel 1e-5
(f32, other summation orders), waveforms rel 2e-3 (HiFT's phase cumsum,
tests/test_torch_port_s3.py), tokens and converted leaves exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_port_cosyvoice2 import PROMPT_SPEECH, TEXT, lm_configs
from tests.test_torch_port_s3 import HIFT, HIFT_REL, TOK, JaxNoise, close, t, to_torch
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401
from tpu_audio.codecs.s3gen import flow as jflow
from tpu_audio.codecs.s3gen import hift as jhift
from tpu_audio.codecs.s3tokenizer import model as js3model
from tpu_audio.models.cosyvoice3 import dit as jdit
from tpu_audio.models.cosyvoice3 import engine as jengine
from tpu_audio.models.cosyvoice3 import load as jload
from tpu_audio.models.cosyvoice3 import model as jcv3
from tpu_audio.ops import quant as jquant
from tpu_audio_torch.api.tts import TTS, StreamingGranularity
from tpu_audio_torch.codecs.s3gen import flow as tflow
from tpu_audio_torch.codecs.s3gen import hift as thift
from tpu_audio_torch.codecs.s3tokenizer import model as ts3tok
from tpu_audio_torch.convert import params_from_numpy, s3_params_from_numpy
from tpu_audio_torch.models.cosyvoice2 import lm as tlm
from tpu_audio_torch.models.cosyvoice3 import dit as tdit
from tpu_audio_torch.models.cosyvoice3 import engine as tengine
from tpu_audio_torch.models.cosyvoice3 import load as tload
from tpu_audio_torch.models.cosyvoice3 import model as tcv3
from tpu_audio_torch.utils import pytree

DIT = dict(mel_dim=16, dim=64, depth=2, heads=4, head_dim=16, mu_dim=32, spk_dim=16,
           conv_pos_groups=4, static_chunk_size=8)
FLOW = dict(vocab_size=64, input_dim=32, spk_dim=24, mel_dim=16)


def flow_configs(**dit_over):
    def cfg(mod, dit, flow, hift):
        return mod.CV3FlowConfig(dit=dit.DiTConfig(**{**DIT, **dit_over}),
                                 cfm=flow.CFMConfig(n_timesteps=2),
                                 hift=hift.HiFTConfig(**HIFT), **FLOW)
    return cfg(jcv3, jdit, jflow, jhift), cfg(tcv3, tdit, tflow, thift)


@pytest.fixture(scope="module")
def flow_parts():
    """(JAX config, port config, JAX tree, port tree): the JAX init's tree
    drawn by the port's `numpy_params`, biases and the DiT's modulation
    made larger so that a misplaced shift, scale or gate shows."""
    jcfg, tcfg = flow_configs()
    tree = tcv3.numpy_params(np.random.default_rng(4), tcfg)
    rng = np.random.default_rng(5)
    for leaf in pytree.flatten(tree["decoder_estimator"]).values():
        if leaf.ndim == 1:
            leaf[:] = rng.standard_normal(leaf.shape).astype(np.float32) * 0.3
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), to_torch(tree)


def inputs(rng, b, n, cfg):
    x, cond = (rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32) for _ in range(2))
    mu = rng.standard_normal((b, n, cfg.mu_dim)).astype(np.float32)
    spk = rng.standard_normal((b, cfg.spk_dim)).astype(np.float32)
    return x, mu, cond, spk


# ------------------------------------------------------------------ the DiT

@pytest.mark.parametrize("streaming,left", [(False, -1), (True, -1), (True, 1)])
def test_dit_forward_matches_jax(flow_parts, streaming, left):
    """`forward` on 2 rows of 21 frames (mask_len 21 and 15) against the
    JAX one: full masks, chunk-causal, and a left window of one chunk."""
    _, _, jp, tp = flow_parts
    jc, tc = (m.DiTConfig(**{**DIT, "num_left_chunks": left}) for m in (jdit, tdit))
    x, mu, cond, spk = inputs(np.random.default_rng(6), 2, 21, jc)
    tm = np.asarray([0.3, 0.8], np.float32)
    ref = jdit.forward(jp["decoder_estimator"], jc, *map(jnp.asarray, (x, [21, 15], mu, tm,
                                                                       spk, cond)), streaming)
    got = tdit.forward(tp["decoder_estimator"], tc, t(x), torch.tensor([21, 15]), t(mu), t(tm),
                       t(spk), t(cond), streaming)
    close(got, ref, 1e-5)
    assert not got[1, 15:].any()


def stack1(cache):
    """A one-timestep stack of a JAX stream cache (roll_stream_caches' layout)."""
    return jax.tree.map(lambda a: a[None], cache)


def test_forward_chunk_and_roll_match_jax(flow_parts):
    """`forward_chunk` over chunks of 8, 8, 8 and a ragged 8 (5 valid) in a
    ring of 24 slots with a left window of 2 chunks, the ring rolled by 8
    before the fourth: each chunk's velocity, the keys, values, conv tails
    (but the ragged chunk's, ROADMAP C21), pos and base against the JAX
    ones; the aligned chunks equal the chunk-causal `forward` over the
    whole."""
    _, _, jp, tp = flow_parts
    jc, tc = (m.DiTConfig(**{**DIT, "num_left_chunks": 2}) for m in (jdit, tdit))
    x, mu, cond, spk = inputs(np.random.default_rng(7), 2, 32, jc)
    tm = np.asarray([0.4, 0.4], np.float32)
    jcache = stack1(jdit.make_stream_cache(jc, 2, 24))
    tcache = tcv3.make_flow_stream_caches(tcv3.CV3FlowConfig(dit=tc), 24, n_timesteps=1,
                                          device="cpu")
    outs = []
    for lo in (0, 8, 16, 24):
        valid = 5 if lo == 24 else 8
        if lo == 24:
            jcache, tcache = jcv3.roll_stream_caches(jcache, jnp.int32(8)), \
                tcv3.roll_stream_caches(tcache, 8)
        sl = slice(lo, lo + 8)
        jv, jcc = jdit.forward_chunk(jp["decoder_estimator"], jc, jnp.asarray(x[:, sl]),
                                     jnp.asarray(mu[:, sl]), jnp.asarray(tm), jnp.asarray(spk),
                                     jnp.asarray(cond[:, sl]),
                                     jax.tree.map(lambda a: a[0], jcache), jnp.int32(valid))
        jcache = stack1(jcc)
        tv = tdit.forward_chunk(tp["decoder_estimator"], tc, t(x[:, sl]), t(mu[:, sl]), t(tm),
                                t(spk), t(cond[:, sl]), tcv3._step_cache(tcache, 0), valid)
        close(tv[:, :valid], jv[:, :valid], 1e-5)
        outs.append(tv[:, :valid])
        # the ragged chunk's tails differ from JAX's by design (ROADMAP C21)
        for name in ("k", "v") + (("conv1_tail", "conv2_tail") if valid == 8 else ()):
            close(getattr(tcache, name), getattr(jcache, name), 1e-5)
        assert (int(tcache.pos[0]), int(tcache.base[0])) == (int(jcache.pos[0]),
                                                              int(jcache.base[0]))
    assert (int(tcache.pos[0]), int(tcache.base[0])) == (21, 8)
    full = tdit.forward(tp["decoder_estimator"], tc, t(x[:, :24]), torch.tensor([24, 24]),
                        t(mu[:, :24]), t(tm), t(spk), t(cond[:, :24]), True)
    close(torch.cat(outs[:3], 1), full, 1e-5)


def test_padded_chunks_carry_their_real_frames_tails(flow_parts):
    """ROADMAP C21: the synthesizer pads a chunk's frames to a multiple of 32
    (50 to 64), and the JAX `forward_chunk` carries the padded chunk's last
    frames as the conv tails, so the next chunk's position embedding reads
    the pads. The port carries the real frames' tails: three chunks of 8
    frames padded to 16 give the unpadded chunks' velocities and tails (rel
    1e-5), where the JAX ones move (> 1e-2)."""
    _, _, jp, tp = flow_parts
    jc, tc = (m.DiTConfig(**{**DIT, "num_left_chunks": 2}) for m in (jdit, tdit))
    x, mu, cond, spk = inputs(np.random.default_rng(15), 2, 24, jc)
    tm = np.asarray([0.6, 0.6], np.float32)
    runs = {}
    for pad in (8, 16):
        jcache, tcache = jdit.make_stream_cache(jc, 2, 48), tdit.make_stream_cache(
            tc, 2, 48, device="cpu")
        jo, to = [], []
        for lo in (0, 8, 16):
            args = [np.pad(a[:, lo:lo + 8], ((0, 0), (0, pad - 8), (0, 0))) for a in (x, mu)]
            c = np.pad(cond[:, lo:lo + 8], ((0, 0), (0, pad - 8), (0, 0)))
            jv, jcache = jdit.forward_chunk(jp["decoder_estimator"], jc, *map(jnp.asarray, (
                *args, tm, spk, c)), jcache, jnp.int32(8))
            to.append(tdit.forward_chunk(tp["decoder_estimator"], tc, t(args[0]), t(args[1]),
                                         t(tm), t(spk), t(c), tcache, 8)[:, :8])
            jo.append(np.asarray(jv)[:, :8])
        runs[pad] = (np.concatenate(jo, 1), torch.cat(to, 1), tcache.conv2_tail.clone())
    close(runs[16][1], runs[8][1], 1e-5)
    close(runs[16][2], runs[8][2], 1e-5)
    close(runs[8][1], runs[8][0], 1e-5)
    j_err = np.abs(runs[16][0] - runs[8][0]).max() / np.abs(runs[8][0]).max()
    assert j_err > 1e-2, j_err


def test_cfm_solve_chunk_matches_jax(flow_parts):
    """`cfm_solve_chunk` over three chunks (the last ragged) against the
    JAX one, each timestep's cache carried: the chunks' mels and the
    caches; one chunk covering all equals the streaming `cfm_solve`."""
    jcfg, tcfg, jp, tp = flow_parts
    rng = np.random.default_rng(8)
    z, _, cond, _ = inputs(rng, 1, 24, jcfg.dit)
    mu = rng.standard_normal((1, 24, jcfg.input_dim)).astype(np.float32)
    emb = rng.standard_normal((1, jcfg.dit.spk_dim)).astype(np.float32)
    jcache = jcv3.make_flow_stream_caches(jcfg, 32)
    tcache = tcv3.make_flow_stream_caches(tcfg, 32, device="cpu")
    for lo, hi, valid in ((0, 8, 8), (8, 16, 8), (16, 24, 5)):
        sl = slice(lo, hi)
        ref, jcache = jcv3.cfm_solve_chunk(jp, jcfg, *map(jnp.asarray, (
            z[:, sl], mu[:, sl], emb, cond[:, sl])), jcache, valid_new=jnp.int32(valid))
        got = tcv3.cfm_solve_chunk(tp, tcfg, t(z[:, sl]), t(mu[:, sl]), t(emb), t(cond[:, sl]),
                                   tcache, valid_new=valid)
        close(got[:, :valid], ref[:, :valid], 1e-5)
    close(tcache.k, jcache.k, 1e-5)
    assert tcache.pos.tolist() == np.asarray(jcache.pos).tolist() == [21, 21]

    def est(x, ml, mu_, tt, spks, cnd, stream):
        return tdit.forward(tp["decoder_estimator"], tcfg.dit, x, ml, mu_, tt, spks, cnd, stream)
    whole = tflow.cfm_solve(est, tcfg.cfm, t(mu), torch.tensor([24]), t(emb), t(cond), t(z),
                            streaming=True)
    one = tcv3.cfm_solve_chunk(tp, tcfg, t(z), t(mu), t(emb), t(cond),
                               tcv3.make_flow_stream_caches(tcfg, 32, device="cpu"))
    close(one, whole, 1e-5)


class JaxFlowNoise:
    """The JAX synthesizer's flow draws behind `noise.Noise`'s z methods."""

    def __init__(self, seed):
        self.seed = seed

    def z(self, shape, device):
        return t(jax.random.normal(jax.random.PRNGKey(self.seed), shape))

    def z_chunk(self, lo, shape, device):
        return t(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(self.seed + 7), lo),
                                   shape))


@pytest.mark.parametrize("streaming", [True, False])
def test_flow_chunk_matches_jax(flow_parts, streaming):
    """`flow_chunk` on 30 tokens (6 of prompt, 12 prompt mel frames, values
    past the vocabulary clamped) against the JAX one on its z: rel 1e-5."""
    jcfg, tcfg, jp, tp = flow_parts
    rng = np.random.default_rng(9)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :30] = rng.integers(0, 70, 30)
    pm = rng.standard_normal((1, 12, 16)).astype(np.float32)
    emb = rng.standard_normal((1, 24)).astype(np.float32)
    ref = jcv3.flow_chunk(jp, jcfg, jnp.asarray(toks), jnp.asarray([30]), jnp.asarray(pm),
                          jnp.asarray([12]), jnp.asarray(emb), jax.random.PRNGKey(2), streaming)
    got = tcv3.flow_chunk(tp, tcfg, torch.from_numpy(toks).long(), 30, t(pm), 12, t(emb),
                          JaxFlowNoise(2), streaming)
    close(got, ref, 1e-5)


def stream_pair(flow_parts, chunks, **kw):
    """The JAX and the port synthesizers' chunks on the same tokens and
    draws (seed 3), with static chunks of 32 frames, a prompt of 16 tokens
    and chunks of 16 tokens: every O(1) chunk but the last is 32 frames, so
    that no chunk the JAX stream carries on from is padded (ROADMAP C21)."""
    _, _, jp, tp = flow_parts
    jcfg, tcfg = flow_configs(static_chunk_size=32)
    rng = np.random.default_rng(11)
    pt = rng.integers(0, 64, 16).tolist()
    pm = rng.standard_normal((32, 16)).astype(np.float32)
    emb = rng.standard_normal((1, 24)).astype(np.float32)
    ref = list(jcv3.CV3Synthesizer(jp, jcfg, **kw).stream(iter(chunks), pt, pm,
                                                            jnp.asarray(emb), seed=3,
                                                            chunk_size=16))
    got = list(tcv3.CV3Synthesizer(tp, tcfg, **kw).stream(
        iter(chunks), pt, t(pm), t(emb), chunk_size=16, flow_noise=JaxFlowNoise(3),
        hift_noise=JaxNoise(jax.random.PRNGKey(3))))
    return got, ref


@pytest.mark.parametrize("policy", [
    dict(o1_flow=False), dict(o1_flow=True, stream_cache_frames=96),
    dict(o1_flow="auto", o1_switch_frames=70, stream_cache_frames=96)])
def test_synthesizer_stream_matches_jax(flow_parts, policy):
    """`CV3Synthesizer.stream` on 66 tokens in chunks of 20, 16, 14 and 16
    (a silent run of 10 filtered to 5), against the JAX one: the full
    window, the O(1) flow from the first chunk (its ring of 96 slots
    rolled), and "auto" switching at 70 frames (the horizon primed): every
    chunk's samples within rel 2e-3."""
    rng = np.random.default_rng(10)
    toks = rng.integers(3, 64, 66).tolist()
    toks[22:32] = [1] * 10
    chunks = [toks[:20], toks[20:36], toks[36:50], toks[50:]]
    got, ref = stream_pair(flow_parts, chunks, **policy)
    assert [len(g) for g in got] == [len(r) for r in ref] and len(got) >= 4
    for g, r in zip(got, ref):
        close(torch.from_numpy(g), r, HIFT_REL)


# ------------------------------------------------------------------ the engine

@pytest.fixture(scope="module")
def engine_parts(flow_parts):
    """The engines' trees: CosyVoice2's tiny Qwen2 LM (60 speech tokens),
    the tiny flow and S3 tokenizer."""
    jlcfg, tlcfg = lm_configs()
    np_lm = tlm.numpy_params(np.random.default_rng(12), tlcfg)
    np_lm["llm_decoder"]["bias"][tlcfg.eos_id] = 30.0  # EOS likely once allowed
    jfcfg, tfcfg, jfp, tfp = flow_parts
    tok_np = ts3tok.numpy_params(np.random.default_rng(2), ts3tok.S3TokenizerConfig(**TOK))
    return ((jax.tree.map(jnp.asarray, np_lm), jlcfg, jfp, jfcfg,
             jax.tree.map(jnp.asarray, tok_np), js3model.S3TokenizerConfig(**TOK)),
            (params_from_numpy(np_lm, device="cpu"), tlcfg, tfp, tfcfg, to_torch(tok_np),
             ts3tok.S3TokenizerConfig(**TOK)))


def engines(engine_parts):
    jparts, tparts = engine_parts
    return (jengine.CosyVoice3Engine.from_params(*jparts, max_cache=512),
            tengine.CosyVoice3Engine.from_params(*tparts))


def jax_noises(seed):
    return JaxFlowNoise(seed), JaxNoise(jax.random.PRNGKey(seed))


def test_speaker_and_voice_conversion_match(engine_parts, monkeypatch):
    """`prepare_conditionals` on 1.5 s of noise at 22.05 kHz (the S3 tokens
    equal, the prompt mel rel 1e-4, a zero x-vector) and
    `voice_conversion` of 1 s on the JAX draws (one finalize pass)."""
    ref, eng = engines(engine_parts)
    rng = np.random.default_rng(13)
    audio = (0.1 * rng.standard_normal(33075)).astype(np.float32)
    rs = ref.prepare_conditionals(audio, 22050, ref_text="Hello there")
    ts = eng.prepare_conditionals(audio, 22050, ref_text="Hello there")
    assert ts.speech_tokens == rs.speech_tokens and len(ts.speech_tokens) > 10
    assert ts.prompt_text_ids == rs.prompt_text_ids
    close(ts.prompt_mel, rs.prompt_mel)
    assert not ts.embedding.any() and ts.embedding.shape == (1, 24)
    monkeypatch.setattr(eng, "noises", jax_noises)
    src = (0.1 * rng.standard_normal(16000)).astype(np.float32)
    close(torch.from_numpy(eng.voice_conversion(src, 16000)), ref.voice_conversion(src, 16000),
          HIFT_REL)
    assert eng.voice_conversion(np.zeros(300, np.float32), 16000).shape == (0,)
    with pytest.raises(ValueError, match="too short"):
        eng.prepare_conditionals(np.zeros(300, np.float32), 16000, ref_text="")


@pytest.mark.parametrize("granularity", ["token", "sentence"])
def test_engine_streams_match_jax_on_the_same_tokens(engine_parts, monkeypatch, granularity):
    """Both engines' `generate_streaming` on two sentences, each LM stream
    replaced by the same token chunks (the LMs draw otherwise), on the JAX
    draws: the chunks' texts, finality and samples (rel 2e-3); the modes'
    prompts equal the JAX engine's."""
    ref, eng = engines(engine_parts)
    rng = np.random.default_rng(14)
    streams = {}

    def fixed(text_ids, prompt_ids, speech, seed=0, **kw):
        key = (tuple(text_ids), seed)
        if key not in streams:
            streams[key] = [rng.integers(3, 60, 8).tolist() for _ in range(3)]
        return iter(streams[key])
    monkeypatch.setattr(ref.streamer, "stream", fixed)
    monkeypatch.setattr(eng.streamer, "stream", fixed)
    monkeypatch.setattr(eng, "noises", jax_noises)
    text = "This first sentence is long enough to stand on its own. And a second one."
    from tpu_audio.api.tts import StreamingGranularity as JG
    got = list(eng.generate_streaming(text, granularity=StreamingGranularity(granularity)))
    want = list(ref.generate_streaming(text, granularity=JG(granularity)))
    assert [(c.text, c.is_final) for c in got] == [(c.text, c.is_final) for c in want]
    assert sum(c.is_final for c in got) == 1 and len(got) >= 2
    for c, r in zip(got, want):
        if len(r.samples):
            close(torch.from_numpy(c.samples), r.samples, HIFT_REL)
        else:
            assert len(c.samples) == 0
    spk = eng.default_speaker()
    for mode in ("zero_shot", "cross_lingual", "instruct"):
        assert eng._prompt_ids(spk, mode, "Calm") == (
            [] if mode != "instruct" else eng.tokenizer.encode("Calm<|endofprompt|>"))
    with pytest.raises(ValueError, match="mode"):
        eng._prompt_ids(spk, "whisper", None)


def test_engine_with_every_default_and_speculative(engine_parts):
    """ROADMAP C7/C18: `from_params` and `generate` with their public
    defaults (the default speaker, TOKEN granularity, the LM cache sized per
    request, chunks of 8); the factory's defaults; speculative="ngram"
    through the streamer's speculative spans."""
    _, tparts = engine_parts
    eng = tengine.CosyVoice3Engine.from_params(*tparts)
    assert eng.lm.max_cache is None and eng.streamer.chunk == 8
    assert eng.streamer.first_extra == tcv3.PRE_LOOKAHEAD == 3
    res = eng.generate("Hello there, how are you?")
    assert res.sample_rate == 24000 and np.isfinite(res.samples).all() and len(res.samples)
    fac = TTS.cosyvoice3()
    assert (fac.quantization, fac.speculative, fac.device) == ("w8a8", None, "cuda")
    assert fac.default_streaming_granularity == StreamingGranularity.TOKEN
    spec = tengine.CosyVoice3Engine.from_params(*tparts, speculative="ngram", gamma=3)
    chunks = list(spec.generate_streaming("Hello there."))
    assert chunks[-1].is_final and spec.lm.last_spec_stats["iterations"] > 0
    with pytest.raises(ValueError, match="speculative"):
        TTS.cosyvoice3(speculative="draft")


# ------------------------------------------------------------------ load

def test_convert_and_load_from_a_written_checkpoint(engine_parts, tmp_path, monkeypatch):
    """A checkpoint in the published layout (chip_smoke's `cosyvoice3_flat`:
    the Qwen2 stack q4 under llm.llm.model.*, the DiT under upstream
    CosyVoice's names with a rotary table, kernels in torch's layouts; the
    S3 tokenizer in MLX's): `convert_numpy` equals the JAX `convert` leaf
    for leaf, bit for bit; `load()` from a seeded cache gives the trees of
    `from_params`."""
    (jp, _, jfp, _, jtok, _), _ = engine_parts
    jq = dict(jp, llm=jquant.quantize_tree(jp["llm"], bits=4))
    flat = chip_smoke.cosyvoice3_flat(params_from_numpy(jax.tree.map(np.asarray, jq),
                                                        device="cpu"),
                                      jax.tree.map(np.asarray, jfp))
    flat = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in flat.items()}
    assert any(".transformer_blocks.1.ff.ff.0.0." in k for k in flat)
    rl, rf = jload.convert(dict(flat))
    gl, gf = tload.convert_numpy(dict(flat))
    for got, ref in ((gl, rl), (gf, rf)):
        g, r = pytree.flatten(got), pytree.flatten(jax.tree.map(np.asarray, ref))
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_array_equal(np.asarray(g[k]), r[k], err_msg=k)
    assert pytree.flatten(gf).keys() == pytree.flatten(jax.tree.map(np.asarray, jfp)).keys()
    root = tmp_path / "hub"
    tok_flat = chip_smoke.s3tokenizer_mlx_flat(jax.tree.map(np.asarray, jtok))
    chip_smoke.seed_cache(root, tload.REPO, {"model.safetensors": lambda p: chip_smoke.
                                             write_safetensors(p, flat)})
    chip_smoke.seed_cache(root, tload.S3TOK_V3_REPO, {"model.safetensors": lambda p: chip_smoke.
                                                      write_safetensors(p, tok_flat)})
    monkeypatch.setenv("TPU_AUDIO_CACHE", str(root))
    lm_t, lm_cfg, flow_t, flow_cfg, tok_t, tok_cfg, _ = tload.load(device="cpu")
    assert lm_cfg == tlm.CosyLMConfig() and flow_cfg == tcv3.CV3FlowConfig()
    want = {**pytree.flatten(params_from_numpy(rl, device="cpu")),
            **{"f." + k: v for k, v in pytree.flatten(s3_params_from_numpy(
                jax.tree.map(np.asarray, rf), "cpu")).items()},
            **{"tok." + k: v for k, v in pytree.flatten(to_torch(jtok)).items()}}
    have = {**pytree.flatten(lm_t), **{"f." + k: v for k, v in pytree.flatten(flow_t).items()},
            **{"tok." + k: v for k, v in pytree.flatten(tok_t).items()}}
    assert have.keys() == want.keys()
    for k in want:
        assert torch.equal(have[k], want[k]), k
    eng = TTS.cosyvoice3(quantization="q4", device="cpu")
    monkeypatch.setattr(tload, "load", lambda device: (lm_t, lm_configs()[1], flow_t,
                                                       engine_parts[1][3], tok_t,
                                                       ts3tok.S3TokenizerConfig(**TOK), None))
    eng.load()
    assert eng.is_loaded and "weight_q4" in eng.lm.params["llm"]["layers"]["attn"]["q"]
    assert eng.streamer.chunk == 25
    assert len(eng.lm.generate(TEXT, [], PROMPT_SPEECH, max_new=8)) > 0
