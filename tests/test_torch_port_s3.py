"""PyTorch port, the S3 family (tpu_audio_torch/codecs/s3tokenizer/,
codecs/s3gen/, the S3 and Kaldi front-ends) against the JAX package on the
CPU, on tiny configs with inputs from a numpy seed.

Tolerances (f32): module outputs within rel 1e-4 of max|ref| (the same f32
terms summed in another order), the S3 codes equal. The HiFT phase is a
cumsum over 480 samples a frame: the two packages sum it in another order,
and its error (rel ~1e-6 of a phase that grows to ~1e2 cycles) moves the
sines by ~1e-4; HiFT's waveform holds to rel 2e-3 (measured 1.1e-4 — 2.6e-4),
everything before the sines to 1e-4. The random draws (the flow's z,
HiFT's phase offsets and noise) are the JAX package's own, handed in
through a source with `noise.Noise`'s methods.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.codecs import s3tokenizer as js3tok
from tpu_audio.codecs.s3gen import campplus as jcamp
from tpu_audio.codecs.s3gen import conformer as jconf
from tpu_audio.codecs.s3gen import flow as jflow
from tpu_audio.codecs.s3gen import hift as jhift
from tpu_audio.codecs.s3gen import model as js3gen
from tpu_audio.codecs.s3tokenizer import load as js3load
from tpu_audio.codecs.s3tokenizer import model as js3model
from tpu_audio.ops import frontends as jfront
from tpu_audio.ops import stft as jstft
from tpu_audio_torch.codecs.s3gen import campplus as tcamp
from tpu_audio_torch.codecs.s3gen import conformer as tconf
from tpu_audio_torch.codecs.s3gen import flow as tflow
from tpu_audio_torch.codecs.s3gen import hift as thift
from tpu_audio_torch.codecs.s3gen import model as ts3gen
from tpu_audio_torch.codecs.s3gen.noise import Noise
from tpu_audio_torch.codecs.s3tokenizer import load as ts3load
from tpu_audio_torch.codecs.s3tokenizer import model as ts3tok
from tpu_audio_torch.convert import s3_params_from_numpy
from tpu_audio_torch.ops import frontends as tfront
from tpu_audio_torch.ops import stft as tstft
from tpu_audio_torch.ops import windows
from tpu_audio_torch.utils import pytree
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

TOK = dict(n_mels=128, n_audio_state=64, n_audio_head=4, n_audio_layer=2)
CONF = dict(input_size=32, output_size=32, heads=4, linear_units=64, num_blocks=1,
            num_up_blocks=1, static_chunk_size=8)
EST = dict(in_channels=64, out_channels=16, channels=32, n_blocks=1, num_mid_blocks=1,
           num_heads=4, static_chunk_size=8)
CFM = dict(n_timesteps=2)
HIFT = dict(in_channels=16, base_channels=32, upsample_rates=(4, 3), upsample_kernels=(8, 7),
            source_resblock_kernels=(7, 11), source_resblock_dilations=((1, 3, 5), (1, 3, 5)),
            resblock_kernels=(3,), resblock_dilations=((1, 3, 5),))
CAMP = dict(feat_dim=80, embedding_size=24, growth_rate=8, bn_size=2, init_channels=16,
            blocks=(2, 2), kernels=(3, 3), dilations=(1, 2))
GEN = dict(vocab_size=64, input_dim=32, spk_dim=24, mel_dim=16, pre_lookahead_len=3)


def s3gen_configs():
    """(JAX S3GenConfig, port S3GenConfig) of the tiny S3Gen."""
    def cfg(mod):
        return mod.S3GenConfig(
            conformer=mod.conformer.ConformerConfig(**CONF),
            estimator=mod.flow.EstimatorConfig(**EST), cfm=mod.flow.CFMConfig(**CFM),
            hift=mod.hift.HiFTConfig(**HIFT), campplus=mod.campplus.CAMPPlusConfig(**CAMP), **GEN)
    return cfg(js3gen), cfg(ts3gen)


def close(got, ref, rel=1e-4):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, err
    return err


def to_torch(tree):
    return s3_params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


class JaxNoise:
    """The JAX package's draws behind `noise.Noise`'s methods: z of
    `jax.random.normal(key)`; HiFT's of `sine_source`'s split of `key`
    (the phase offsets of its first half, the position-keyed noise of its
    second)."""

    def __init__(self, key):
        self.key = key

    def z(self, shape, device):
        return t(jax.random.normal(self.key, shape))

    def rand_ini(self, b, h, device):
        k1, _ = jax.random.split(self.key)
        return t(jax.random.uniform(k1, (b, h)).at[:, 0].set(0.0))

    def frames(self, start_frame, n_frames, b, per, h, device):
        _, k2 = jax.random.split(self.key)
        return t(jhift._position_noise(k2, start_frame, n_frames, b, per, h))


@pytest.fixture(scope="module")
def gen_parts():
    jcfg, tcfg = s3gen_configs()
    # the JAX tree drawn by the port's `numpy_params` (the JAX init's tree,
    # shapes and ranges: test_numpy_params_have_the_jax_trees_shapes), which
    # takes milliseconds where the JAX init's eager draws take ~30 s
    rng = np.random.default_rng(3)
    jp = jax.tree.map(jnp.asarray, ts3gen.numpy_params(rng, tcfg))
    # random norms, biases and BN stats, so that a misplaced one shows

    def jitter(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                jitter(v, path + k + ".")
            elif k in ("pos_bias_u", "pos_bias_v", "running_mean") or (
                    k == "bias" and v.ndim == 1 and "norm" in path):
                tree[k] = jnp.asarray(0.1 * rng.standard_normal(v.shape).astype(np.float32))
            elif k in ("running_var", "alpha") or (k == "weight" and "norm" in path
                                                    and v.ndim == 1) or path.endswith("bn."):
                tree[k] = jnp.asarray((1 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32))
    jitter(jp)
    return jcfg, tcfg, jp, to_torch(jp)


# ------------------------------------------------------------------ front-ends

@pytest.mark.parametrize("center,magnitude", [(True, False), (False, True)])
def test_stft_power_center_and_magnitude(center, magnitude):
    x = np.random.default_rng(0).standard_normal(4000).astype(np.float32)
    win = windows.hann(400, periodic=True)
    ref = jstft.stft_power(jnp.asarray(x), win, 400, 160, center=center, magnitude=magnitude)
    close(tstft.stft_power(t(x), win, 400, 160, center=center, magnitude=magnitude), ref, 1e-5)


def test_s3_log_mel_s3gen_mel_and_kaldi_fbank():
    rng = np.random.default_rng(1)
    a16 = (0.1 * rng.standard_normal(16000)).astype(np.float32)
    a24 = (0.1 * rng.standard_normal(24000)).astype(np.float32)
    close(tfront.s3_log_mel(t(a16)), jfront.s3_log_mel(jnp.asarray(a16)))
    close(tfront.s3_log_mel(t(a16), padding=800), jfront.s3_log_mel(jnp.asarray(a16), padding=800))
    close(tfront.s3gen_mel(t(a24)), jfront.s3gen_mel(jnp.asarray(a24)))
    close(tfront.s3gen_mel(t(a24), n_mels=16), jfront.s3gen_mel(jnp.asarray(a24), n_mels=16))
    close(tfront.kaldi_fbank(t(a16)), jfront.kaldi_fbank(jnp.asarray(a16)))


# ------------------------------------------------------------------ S3 tokenizer

@pytest.fixture(scope="module")
def tok_parts():
    jcfg, tcfg = js3model.S3TokenizerConfig(**TOK), ts3tok.S3TokenizerConfig(**TOK)
    jp = jax.tree.map(jnp.asarray, ts3tok.numpy_params(np.random.default_rng(2), tcfg))
    return jcfg, tcfg, jp, to_torch(jp)


def test_s3_rotary_is_the_reference_convention():
    cos, sin = ts3tok.freqs_cis(16, 40)
    jcos, jsin = js3model._freqs_cis(16, 40)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    x = np.random.default_rng(4).standard_normal((2, 40, 3, 16)).astype(np.float32)
    close(ts3tok.apply_rotary_half(t(x), t(cos), t(sin)),
          js3model._apply_rotary_half(jnp.asarray(x), cos, sin), 1e-6)


def test_s3_tokenizer_codes_and_hidden_match(tok_parts):
    """Two clips of 300 and 217 valid frames in one batch (the masks of the
    convolutions, the keys and the FSMN memory): the hidden states within
    rel 1e-4, the codes equal, the lengths equal."""
    jcfg, tcfg, jp, tp = tok_parts
    mel = np.random.default_rng(5).standard_normal((2, 300, 128)).astype(np.float32)
    lens = np.array([300, 217])
    jh, jl = js3model.encode_hidden(jp, jcfg, jnp.asarray(mel), jnp.asarray(lens))
    th, tl = ts3tok.encode_hidden(tp, tcfg, t(mel), torch.as_tensor(lens))
    close(th, jh)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    jc, _ = js3model.quantize(jp, jcfg, jnp.asarray(mel), jnp.asarray(lens))
    tc, _ = ts3tok.quantize(tp, tcfg, t(mel), torch.as_tensor(lens))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.max() < 6561 and len(set(tc.flatten().tolist())) > 5


def test_s3_tokenizer_convert_matches_jax_bit_for_bit(tok_parts):
    """The MLX layout (O, K, I) of a 3-D weight: the JAX rule's tree, then
    torch's layout, every leaf bit for bit."""
    _, _, jp, tp = tok_parts
    flat = {k: np.asarray(v) for k, v in pytree.flatten(jax.tree.map(np.asarray, jp)).items()}
    mlx = {k: (v.transpose(2, 0, 1) if v.ndim == 3 else v) for k, v in flat.items()}
    ref = pytree.flatten(to_torch(js3load.convert(mlx)))
    got = pytree.flatten(ts3load.convert(mlx, device="cpu"))
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    for k, v in pytree.flatten(tp).items():
        assert torch.equal(got[k], v), k


# ------------------------------------------------------------------ CAMPPlus

def test_campplus_embedding_matches(gen_parts):
    jcfg, tcfg, jp, tp = gen_parts
    fb = np.random.default_rng(6).standard_normal((2, 230, 80)).astype(np.float32)
    ref = jcamp.embed(jp["speaker_encoder"], jcfg.campplus, jnp.asarray(fb))
    close(tcamp.embed(tp["speaker_encoder"], tcfg.campplus, t(fb)), ref)
    close(ts3gen.embed_ref_mel(tp, tcfg, t(fb)), js3gen.embed_ref_mel(jp, jcfg, jnp.asarray(fb)))


# ------------------------------------------------------------------ conformer

@pytest.mark.parametrize("streaming", [False, True])
def test_conformer_matches(gen_parts, streaming):
    """Two rows of 13 and 9 valid tokens; with streaming, chunks of 4
    tokens (8 frames after the upsample)."""
    jcfg, tcfg, jp, tp = gen_parts
    x = np.random.default_rng(7).standard_normal((2, 13, 32)).astype(np.float32)
    lens = np.array([13, 9])
    jh, jl = jconf.forward(jp["flow"]["encoder"], jcfg.conformer, jnp.asarray(x),
                           jnp.asarray(lens), streaming=streaming)
    th, tl = tconf.forward(tp["flow"]["encoder"], tcfg.conformer, t(x), torch.as_tensor(lens),
                           streaming=streaming)
    close(th, jh)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    close(tconf.rel_pos_emb(7, 32, "cpu"), jconf._rel_pos_emb(7, 32), 1e-6)


# ------------------------------------------------------------------ flow

@pytest.mark.parametrize("streaming", [False, True])
def test_estimator_and_cfm_match(gen_parts, streaming):
    jcfg, tcfg, jp, tp = gen_parts
    rng = np.random.default_rng(8)
    x, mu, cond = (rng.standard_normal((2, 20, 16)).astype(np.float32) for _ in range(3))
    spk = rng.standard_normal((2, 16)).astype(np.float32)
    ml, tt_ = np.array([20, 15]), np.array([0.3, 0.8], np.float32)
    je, te = jp["flow"]["decoder_estimator"], tp["flow"]["decoder_estimator"]
    ref = jflow.estimator_forward(je, jcfg.estimator, jnp.asarray(x), jnp.asarray(ml),
                                  jnp.asarray(mu), jnp.asarray(tt_), jnp.asarray(spk),
                                  jnp.asarray(cond), streaming=streaming)
    got = tflow.estimator_forward(te, tcfg.estimator, t(x), torch.as_tensor(ml), t(mu), t(tt_),
                                  t(spk), t(cond), streaming=streaming)
    close(got, ref)
    key = jax.random.PRNGKey(9)
    ref = jflow.cfm_inference(je, jcfg.estimator, jcfg.cfm, jnp.asarray(mu[:1]),
                              jnp.asarray(ml[:1]), jnp.asarray(spk[:1]), jnp.asarray(cond[:1]),
                              key, streaming=streaming)
    got = tflow.cfm_inference(te, tcfg.estimator, tcfg.cfm, t(mu[:1]), torch.as_tensor(ml[:1]),
                              t(spk[:1]), t(cond[:1]), JaxNoise(key).z((1, 20, 16), "cpu"),
                              streaming=streaming)
    close(got, ref)
    close(tflow.t_span(tcfg.cfm, 10, "cpu"), 1 - np.cos(np.linspace(0, 1, 11) * 0.5 * np.pi),
          1e-6)


# ------------------------------------------------------------------ HiFT

HIFT_REL = 2e-3  # the phase cumsum's order (module docstring)


@pytest.fixture(scope="module")
def hift_ref(gen_parts):
    """The JAX vocoder on one mel of 30 frames: (mel, key, f0, audio, source)."""
    jcfg, _, jp, _ = gen_parts
    mel = (np.random.default_rng(10).standard_normal((1, 30, 16)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(11)
    audio, source = jhift.generate(jp["mel2wav"], jcfg.hift, jnp.asarray(mel), key)
    f0 = jhift.f0_predict(jp["mel2wav"]["f0_predictor"], jnp.asarray(mel))
    return mel, key, f0, audio, source


def test_hift_f0_source_and_generate_match(gen_parts, hift_ref):
    jcfg, tcfg, jp, tp = gen_parts
    mel, key, f0, audio, source = hift_ref
    close(thift.f0_predict(tp["mel2wav"]["f0_predictor"], t(mel)), f0)
    got, src = thift.generate(tp["mel2wav"], tcfg.hift, t(mel), JaxNoise(key))
    close(src, source, HIFT_REL)
    close(got, audio, HIFT_REL)
    # the decoder alone, on the JAX source: every term before the sines
    close(thift.decode(tp["mel2wav"], tcfg.hift, t(mel), t(source)),
          jhift.decode(jp["mel2wav"], jcfg.hift, jnp.asarray(mel), source))
    a = np.linspace(-3, 3, 50, dtype=np.float32)[None, :, None]
    for alpha in (np.float32([0.5]), np.float32([0.0]), np.float32([-1e-6])):
        close(thift.snake(t(a), t(alpha)), jhift._snake(jnp.asarray(a), jnp.asarray(alpha)), 1e-6)


def test_vocode_window_chained_equals_generate(gen_parts):
    """Windows ending at frames 30, 60 and 80 (LOOKBACK_FRAMES of lookback,
    the phase and the source tail carried) against one `generate` of the
    same 80 frames, both on the port's own position-keyed noise: rel 1e-4
    (measured 0) outside the 15 frames before each window's right edge,
    where a window lacks the mel after it (the JAX vocode_window's, and the
    reference's, property: the stack's right receptive field is ~14 frames
    here)."""
    _, tcfg, _, tp = gen_parts
    mel = t((np.random.default_rng(16).standard_normal((1, 80, 16)) * 2).astype(np.float32))
    noise = Noise(5)
    ups = tcfg.hift.upsample_scale
    full, _ = thift.generate(tp["mel2wav"], tcfg.hift, mel, noise)
    phase = torch.zeros((1, tcfg.hift.nb_harmonics + 1), dtype=torch.float64)
    tail, done, parts = torch.zeros((1, 0)), 0, []
    for end in (30, 60, 80):
        lb = min(thift.LOOKBACK_FRAMES, done)
        audio, phase, src = thift.vocode_window(tp["mel2wav"], tcfg.hift, mel[:, done - lb: end],
                                                noise, phase, tail[:, tail.shape[1] - lb * ups:],
                                                done)
        parts.append(audio[0, lb * ups:])
        tail = src[:, (lb + end - done - min(thift.LOOKBACK_FRAMES, end)) * ups:]
        done = end
    got = torch.cat(parts)
    assert got.shape == full[0].shape
    for a, b in ((0, 15), (30, 45), (60, 80)):
        close(got[a * ups: b * ups], full[0, a * ups: b * ups], 1e-4)


# ------------------------------------------------------------------ S3Gen

def test_flow_inference_and_token2wav_match(gen_parts):
    """Prompt 5 tokens with 10 mel frames, 9 target tokens bucketed to 12,
    streaming and not; token2wav's audio and its bounds."""
    jcfg, tcfg, jp, tp = gen_parts
    rng = np.random.default_rng(12)
    toks = np.zeros((1, 12), np.int32)
    toks[0, :9] = rng.integers(0, 64, 9)
    pt = rng.integers(0, 64, (1, 5)).astype(np.int32)
    pm = rng.standard_normal((1, 10, 16)).astype(np.float32)
    emb = rng.standard_normal((1, 24)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    for streaming in (False, True):
        ref, (start, valid) = js3gen.flow_inference(
            jp, jcfg, jnp.asarray(toks), jnp.asarray([9]), jnp.asarray(pt), jnp.asarray([5]),
            jnp.asarray(pm), jnp.asarray([10]), jnp.asarray(emb), key, streaming=streaming)
        got, bounds = ts3gen.flow_inference(tp, tcfg, torch.as_tensor(toks), 9,
                                            torch.as_tensor(pt), 5, t(pm), 10, t(emb),
                                            JaxNoise(key), streaming=streaming)
        close(got, ref)
        assert bounds == (int(start), int(valid)) == (10, 18)
    key = jax.random.PRNGKey(14)
    ref, rs, rv = js3gen.token2wav(jp, jcfg, jnp.asarray(toks), jnp.asarray([9]),
                                   jnp.asarray(pt), jnp.asarray([5]), jnp.asarray(pm),
                                   jnp.asarray([10]), jnp.asarray(emb), key)
    k1, k2 = jax.random.split(key)
    got, gs, gv = ts3gen.token2wav(tp, tcfg, torch.as_tensor(toks), 9, torch.as_tensor(pt), 5,
                                   t(pm), 10, t(emb), JaxNoise(k1), JaxNoise(k2))
    assert (gs, gv) == (int(rs), int(rv))
    close(got, ref, HIFT_REL)
    x = np.random.default_rng(15).standard_normal(2000).astype(np.float32)
    close(ts3gen.fade_in(t(x)), js3gen.fade_in(jnp.asarray(x)), 1e-6)


def test_noise_is_keyed_by_position():
    """Noise(seed): any window of frames draws what the whole pass draws
    there; z and the phase offsets are pure functions of the seed."""
    n = Noise(3)
    whole = n.frames(0, 10, 1, 48, 9, "cpu")
    np.testing.assert_array_equal(n.frames(4, 3, 1, 48, 9, "cpu"), whole[:, 4 * 48: 7 * 48])
    assert abs(float(whole.mean())) < 0.05 and abs(float(whole.std()) - 1) < 0.05
    assert torch.equal(n.z((1, 6, 4), "cpu"), Noise(3).z((1, 6, 4), "cpu"))
    assert not torch.equal(n.z((1, 6, 4), "cpu"), Noise(4).z((1, 6, 4), "cpu"))
    ri = n.rand_ini(1, 9, "cpu")
    assert float(ri[0, 0]) == 0.0 and 0 < float(ri[0, 1:].min()) and float(ri.max()) < 1


def test_numpy_params_have_the_jax_trees_shapes():
    """Each module's `numpy_params` has the JAX `init_params` tree's keys
    and shapes (the full-width configs through jax.eval_shape)."""
    from tpu_audio_torch.utils.weights import ShapeRNG

    cases = [(ts3tok.numpy_params, ts3tok.S3TokenizerConfig(),
              lambda: js3model.init_params(jax.random.PRNGKey(0), js3tok.S3TokenizerConfig())),
             (ts3gen.numpy_params, ts3gen.S3GenConfig(),
              lambda: js3gen.init_params(jax.random.PRNGKey(0), js3gen.S3GenConfig()))]
    for fn, cfg, jinit in cases:
        want = {k: tuple(v.shape) for k, v in pytree.flatten(jax.eval_shape(jinit)).items()}
        got = {k: tuple(v.shape) for k, v in pytree.flatten(fn(ShapeRNG(), cfg)).items()}
        assert got == want


def test_bf16_conversion_keeps_bn_stats_and_alphas_f32():
    """`s3_params_from_numpy` at bf16 on the tiny S3Gen's tree: BatchNorm
    statistics and Snake alphas stay f32 with the values they had, every
    other floating leaf is bf16, and each kernel takes its torch layout
    (a conv (K, I, O) → (O, I, K), HiFT's `ups` (K, I, O) → (I, O, K),
    CAMPPlus's 2-D (KH, KW, I, O) → (O, I, KH, KW))."""
    _, tcfg = s3gen_configs()
    flat = pytree.flatten(ts3gen.numpy_params(np.random.default_rng(5), tcfg))
    got = pytree.flatten(s3_params_from_numpy(pytree.unflatten(flat), "cpu", torch.bfloat16))
    assert got.keys() == flat.keys()
    kept = 0
    for k, a in flat.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("running_mean", "running_var", "alpha"):
            kept += 1
            assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), a), k
        else:
            assert got[k].dtype == torch.bfloat16, k
        perm = {3: (1, 2, 0) if ".ups." in k else (2, 1, 0), 4: (3, 2, 0, 1)}.get(a.ndim)
        if leaf == "weight" and perm:
            assert got[k].shape == a.transpose(perm).shape, k
            want = torch.from_numpy(np.ascontiguousarray(a.transpose(perm))).to(torch.bfloat16)
            assert torch.equal(got[k], want), k
    assert kept > 0


def test_configs_match_the_jax_defaults():
    for jc, tc in ((js3model.S3TokenizerConfig(), ts3tok.S3TokenizerConfig()),
                   (js3gen.S3GenConfig(), ts3gen.S3GenConfig())):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
