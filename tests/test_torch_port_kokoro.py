"""PyTorch port, Kokoro (tpu_audio_torch/models/kokoro/, ops/interpolate.py,
the Kokoro additions to nn/layers.py and utils/text.py) against the JAX
package on the CPU: the interpolations, masked norms and transposed
convolutions; Kokoro's conversion rule key by key; ALBERT; each stage at
f32 and the durations exactly; the sine source on JAX's draws and its
STFT; the generator and `decode` on a shared source spectrum;
`KokoroSynthesizer` whole; the phonemizer and the 450-token split;
`load()` from files the test writes; the engine against the JAX engine and
with every public default; phase 18's planted faults.

The tiny config: ALBERT 2 layers of 32 (2 heads, embedding 16) over the
178 symbols and 512 positions, d_model 32, style 16, decoder 64, the
generator at 32 channels with rates (5, 4), kernels (10, 8), resblocks k3
and k7, n_fft 16, hop 4, 4 harmonics (160 samples a frame). The tree is
drawn by the port's `numpy_params` (the JAX init's tree) and moved to JAX;
duration_proj's bias is set to −2.75 (~3 frames a token) and the LSTMs'
biases drawn uniform in ±1/√H, as phase 18 sets them (`kokoro_params`:
with the init's zero biases a padded tail leaves the state at zero).
Stage 1 runs at TOKEN_PAD = 512 and stage 2 at FRAME_BUCKET = 240 frames,
the JAX shapes.

Tolerances, rel of max|ref| unless said, each ~10× the difference
measured on this host: the layers 1e-6; ALBERT and the stages 1e-5
(measured 3e-7–3.4e-6); the durations equal (the nearest value before
rounding 0.43 from a half); the sine source atol 1e-6 (measured 9e-8: its
phase is a cumsum of 2F frame increments, summed in another order by each
library) and its STFT as (mag, cos φ, sin φ) atol 5e-3 (measured 1e-4;
the near-silent bins' phase, tests/test_torch_parity_audio.py); the
generator, `decode` and the audio 1e-5 on a shared spectrum (measured
9e-7); converted leaves bit for bit.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401
from tpu_audio.models.kokoro import albert as jalbert
from tpu_audio.models.kokoro import engine as jengine
from tpu_audio.models.kokoro import load as jload
from tpu_audio.models.kokoro import model as jkm
from tpu_audio.models.kokoro import phonemize as jphon
from tpu_audio.models.kokoro import synth as jsynth
from tpu_audio.models.kokoro import voices as jvoices
from tpu_audio.models.kokoro.config import AlbertConfig as JAlbertConfig
from tpu_audio.models.kokoro.config import KokoroConfig as JKokoroConfig
from tpu_audio.nn import layers as jlayers
from tpu_audio.ops import interpolate as jinterp
from tpu_audio.utils import text as jtext
from tpu_audio_torch import convert
from tpu_audio_torch.api.tts import TTS
from tpu_audio_torch.models.kokoro import albert as talbert
from tpu_audio_torch.models.kokoro import config as tconfig
from tpu_audio_torch.models.kokoro import engine as tengine
from tpu_audio_torch.models.kokoro import load as tload
from tpu_audio_torch.models.kokoro import model as tkm
from tpu_audio_torch.models.kokoro import phonemize as tphon
from tpu_audio_torch.models.kokoro import synth as tsynth
from tpu_audio_torch.models.kokoro import voices as tvoices
from tpu_audio_torch.nn import layers as tlayers
from tpu_audio_torch.ops import interpolate as tinterp
from tpu_audio_torch.utils import pytree
from tpu_audio_torch.utils import text as ttext

TINY_KW = dict(d_model=32, style_dim=16, decoder_hidden=64, upsample_initial_channel=32,
               resblock_kernels=(3, 7), resblock_dilations=((1, 3, 5), (1, 3, 5)),
               upsample_rates=(5, 4), upsample_kernels=(10, 8), istft_n_fft=16, istft_hop=4,
               harmonic_num=4)
ALBERT_KW = dict(num_hidden_layers=2, num_attention_heads=2, hidden_size=32,
                 intermediate_size=64, embedding_size=16)
TINY = tconfig.KokoroConfig(albert=tconfig.AlbertConfig(**ALBERT_KW), **TINY_KW)
JTINY = JKokoroConfig(albert=JAlbertConfig(**ALBERT_KW), **TINY_KW)
DUR_BIAS = chip_smoke.KOKORO_DUR_BIAS
IDS = [50, 83, 54, 57, 16, 65, 123, 54, 46, 4, 16, 43, 55, 102, 156, 62]  # 16 phoneme ids
STAGE_REL = 1e-5
AUDIO_REL = 1e-5
SOURCE_ATOL = 1e-6
PHASE_ATOL = 5e-3


def t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a)).to(dtype)


def close(got, ref, rel, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())
    return err / np.abs(ref).max()


@pytest.fixture(scope="module")
def trees():
    """(numpy tree in the JAX layout, the JAX tree, the port's CPU tree)."""
    rng = np.random.default_rng(0)
    np_tree = tkm.numpy_params(rng, TINY)
    np_tree["predictor"]["duration_proj"]["bias"][:] = DUR_BIAS
    flat = pytree.flatten(np_tree)
    for k, v in flat.items():
        if k.endswith((".bias_ih", ".bias_hh")):
            v[:] = rng.uniform(-1, 1, v.shape) / np.sqrt(v.shape[0] // 4)
    return (np_tree, jax.tree_util.tree_map(jnp.asarray, np_tree),
            tkm.params_from_numpy(np_tree, "cpu"))


def jax_draws(seed: int, b: int, t_len: int, h: int):
    """JAX's draws of `sine_source` from PRNGKey(seed): (rand_ini, noise)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    r = jax.random.normal(k1, (b, h)).at[:, 0].set(0.0)
    return np.asarray(r), np.asarray(jax.random.normal(k2, (b, t_len, h)))


@pytest.fixture(scope="module")
def ref(trees):
    """One sentence through the JAX stages, jitted stage 1 as its
    synthesizer runs it, stage 2's pieces with JAX's draws from PRNGKey(0)
    and its spectrum; then `KokoroSynthesizer.synthesize` on that spectrum
    (`generator` given har_override)."""
    _, jp, _ = trees
    pack = jvoices.random_voice(3)
    js = jsynth.KokoroSynthesizer(jp, JTINY)
    ids = [0] + IDS + [0]
    tokens = np.zeros((1, jsynth.TOKEN_PAD), np.int32)
    tokens[0, : len(ids)] = ids
    ref_s = pack[len(IDS) - 1]
    sd = JTINY.style_dim
    style_sd, style_dec = jnp.asarray(ref_s[:, sd: 2 * sd]), jnp.asarray(ref_s[:, :sd])
    d, durations, t_en = js._stage1(jp, jnp.asarray(tokens), jnp.int32(len(ids)), style_sd,
                                    jnp.float32(1.0))
    x = jax.jit(lambda p, d: jkm.lstm.masked_bilstm(p["predictor"]["lstm"], d, len(ids)))(jp, d)
    pre = jax.nn.sigmoid(jkm.layers.linear(jp["predictor"]["duration_proj"], x)).sum(-1)
    total = int(np.asarray(durations).sum())
    frames_pad = max(jsynth.FRAME_BUCKET, -(-total // jsynth.FRAME_BUCKET) * jsynth.FRAME_BUCKET)
    align = jkm.alignment_matrix(durations, frames_pad)
    en = jnp.einsum("btc,tf->bfc", d, align)
    f0, n, _ = jax.jit(lambda p, en: jkm.f0n_predict(p, JTINY, en, style_sd, total))(jp, en)
    up = int(np.prod(JTINY.upsample_rates)) * JTINY.istft_hop
    f0_up = jnp.repeat(f0[..., None], up, axis=1)
    rand_ini, noise = jax_draws(0, 1, f0_up.shape[1], JTINY.harmonic_num + 1)
    gp = jp["decoder"]["generator"]
    source = jkm.sine_source(gp, JTINY, f0_up, jax.random.PRNGKey(0),
                             rand_ini=jnp.asarray(rand_ini), noise=jnp.asarray(noise))[..., 0]
    mag, phase = jkm._kokoro_stft(source, JTINY.istft_n_fft, JTINY.istft_hop)
    har = jnp.concatenate([mag, phase], axis=-1)
    asr = jnp.einsum("btc,tf->bfc", t_en, align)
    generator = jkm.generator

    def shared(*a, **k):
        return generator(*a, **k, har_override=har)
    jkm.generator = shared
    try:
        audio = js.synthesize(IDS, pack)
    finally:
        jkm.generator = generator
    return dict(pack=pack, tokens=tokens, n=len(ids), style_sd=np.asarray(style_sd),
                style_dec=np.asarray(style_dec), d=np.asarray(d),
                durations=np.asarray(durations), t_en=np.asarray(t_en), pre=np.asarray(pre),
                total=total, frames_pad=frames_pad, f0=np.asarray(f0), n_curve=np.asarray(n),
                asr=np.asarray(asr), rand_ini=rand_ini, noise=noise, source=np.asarray(source),
                har=np.asarray(har), mag=np.asarray(mag), phase=np.asarray(phase), audio=audio)


# --------------------------------------------------------------- layers


@pytest.mark.parametrize("t_in,out_len", [(7, 3), (20, 20), (10, 37), (480, 2)])
def test_interpolate_against_jax_and_f_interpolate(t_in, out_len):
    x = np.random.default_rng(t_in).standard_normal((2, t_in, 3)).astype(np.float32)
    got = tinterp.linear_resize(t(x), out_len)
    close(got, jinterp.linear_resize(jnp.asarray(x), out_len), 1e-6, "jax")
    lib = F.interpolate(t(x).transpose(1, 2), size=out_len, mode="linear",
                        align_corners=False).transpose(1, 2)
    close(got, lib, 1e-6, "F.interpolate")
    np.testing.assert_array_equal(tinterp.nearest_2x(t(x)), jinterp.nearest_2x(jnp.asarray(x)))


def test_masked_norms_pads_and_activations():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 16, 5)).astype(np.float32) * 3 + 1
    for valid in (11, torch.tensor(11), 16):
        v = int(valid)
        close(tlayers.masked_instance_norm(t(x), valid),
              jlayers.masked_instance_norm(jnp.asarray(x), v), 1e-6, "instance norm")
        np.testing.assert_array_equal(tlayers.zero_pad_tail(t(x), valid),
                                      jlayers.zero_pad_tail(jnp.asarray(x), v))
    # statistics from the valid frames only: the exact-length norm
    exact = tlayers.masked_instance_norm(t(x[:, :11]), 11)
    close(tlayers.masked_instance_norm(t(x), 11)[:, :11], exact, 1e-6)
    close(tlayers.layer_norm(None, t(x)), jlayers.layer_norm(None, jnp.asarray(x)), 1e-6)
    close(tlayers.leaky_relu(t(x), 0.2), jlayers.leaky_relu(jnp.asarray(x), 0.2), 0)
    f64 = tlayers.masked_instance_norm(t(x, torch.float64), 11)
    assert f64.dtype == torch.float64 and tlayers.layer_norm(None, f64).dtype == torch.float64


@pytest.mark.parametrize("depthwise", [False, True])
def test_conv_transpose1d_dense_and_depthwise(depthwise):
    rng = np.random.default_rng(2)
    c, k = 6, 3
    x = rng.standard_normal((1, 9, c)).astype(np.float32)
    w = rng.standard_normal((k, 1 if depthwise else c, c)).astype(np.float32)  # JAX (K, I/g, O)
    b = rng.standard_normal(c).astype(np.float32)
    want = jlayers.conv_transpose1d({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                    jnp.asarray(x), stride=2, padding=1)
    got = tlayers.conv_transpose1d({"weight": t(w.transpose(1, 2, 0)), "bias": t(b)}, t(x),
                                   stride=2, padding=1)
    close(got, want, 1e-6)
    if depthwise:  # torch's own depthwise layout with the caller's groups
        same = tlayers.conv_transpose1d({"weight": t(w.transpose(2, 1, 0)), "bias": t(b)}, t(x),
                                        stride=2, padding=1, groups=c)
        close(same, want, 1e-6)
    with pytest.raises(NotImplementedError, match="depthwise"):
        tlayers.conv_transpose1d({"weight": torch.zeros(2, c, k)}, t(x))


def test_split_at_punctuation_boundary_against_jax():
    texts = ["short one", "A sentence, with a comma in the middle of it.",
             "No punctuation at all here just words and more words",
             "First part; second part: third part.", "Ends early. Then goes on for a while!",
             "x" * 40]
    for text in texts:
        assert ttext.split_at_punctuation_boundary(text) == \
            jtext.split_at_punctuation_boundary(text), text


# --------------------------------------------------------------- conversion


def test_params_from_numpy_key_by_key(trees):
    """Every leaf of Kokoro's tree: (1, 2, 0) under ups and pool, (2, 1, 0)
    for the other convolutions (noise_convs and F0_proj under keys that do
    not start with "conv" among them), the alphas and 2-D leaves as they
    are, bit for bit. The generic rule gets pool wrong silently (a square
    pool passes the shape check with each tap transposed) and leaves the
    noise convolutions unturned."""
    np_tree, _, tp = trees
    flat_np, flat_t = pytree.flatten(np_tree), pytree.flatten(tp)
    assert set(flat_np) == set(flat_t)
    seen = set()
    for k, v in flat_np.items():
        if v.ndim == 3:
            perm = ((1, 2, 0) if (".ups." in k or ".pool." in k) and "weight_" in k
                    else None if ".alpha" in k else (2, 1, 0))
            seen.add(perm)
            v = v if perm is None else v.transpose(perm)
        assert flat_t[k].shape == v.shape, k
        np.testing.assert_array_equal(flat_t[k].numpy(), v, err_msg=k)
    assert seen == {(1, 2, 0), (2, 1, 0), None}
    generic = pytree.flatten(convert.params_from_numpy(np_tree, "cpu"))
    pool = "predictor.F0.1.pool.weight_v"
    assert generic[pool].shape == flat_t[pool].shape
    assert not torch.equal(generic[pool], flat_t[pool])
    noise = "decoder.generator.noise_convs.0.weight"
    assert generic[noise].shape != flat_t[noise].shape


# --------------------------------------------------------------- modules


def test_albert_against_jax(trees):
    _, jp, tp = trees
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 178, (1, 40))
    mask = (np.arange(40) < 29)[None].astype(np.int32)
    want = jalbert.forward(jp["bert"], JTINY.albert, jnp.asarray(ids), jnp.asarray(mask))
    got = talbert.forward(tp["bert"], TINY.albert, torch.as_tensor(ids), torch.as_tensor(mask))
    close(got, want, STAGE_REL)


def test_stage1_against_jax_and_durations_exact(trees, ref):
    _, _, tp = trees
    tokens, n = torch.as_tensor(ref["tokens"]).long(), torch.tensor(ref["n"])
    style = t(ref["style_sd"])
    d_en = tkm.bert_duration_features(tp, TINY, tokens, n)
    d = tkm.duration_encode(tp, TINY, d_en, style, n)
    close(d, ref["d"], STAGE_REL, "d")
    pre = tkm.duration_sums(tp, TINY, d, n, 1.0)
    dur = tkm.predict_durations(tp, TINY, d, n, 1.0)
    bad = np.nonzero(dur.numpy() != ref["durations"])[1]
    assert not len(bad), ("durations differ", bad, pre[0, bad], ref["pre"][0, bad])
    assert 2 < ref["total"] / ref["n"] < 4  # the bias gives ~3 frames a token
    close(pre, ref["pre"], STAGE_REL, "before rounding")
    close(tkm.text_encode(tp, TINY, tokens, n), ref["t_en"], STAGE_REL, "t_en")


def test_alignment_and_prosody_against_jax(trees, ref):
    _, _, tp = trees
    align = tkm.alignment_matrix(torch.as_tensor(ref["durations"]), ref["frames_pad"])
    np.testing.assert_array_equal(align, jkm.alignment_matrix(jnp.asarray(ref["durations"]),
                                                              ref["frames_pad"]))
    en = torch.matmul(align.T, t(ref["d"]))
    f0, n, v2 = tkm.f0n_predict(tp, TINY, en, t(ref["style_sd"]), torch.tensor(ref["total"]))
    close(f0, ref["f0"], STAGE_REL, "F0")
    close(n, ref["n_curve"], STAGE_REL, "N")
    assert int(v2) == 2 * ref["total"]


def test_sine_source_on_jax_draws_and_stft(trees, ref):
    _, _, tp = trees
    up = int(np.prod(TINY.upsample_rates)) * TINY.istft_hop
    f0_up = torch.repeat_interleave(t(ref["f0"])[..., None], up, dim=1)
    source = tkm.sine_source(tp["decoder"]["generator"], TINY, f0_up, rand_ini=t(ref["rand_ini"]),
                             noise=t(ref["noise"]))[..., 0]
    np.testing.assert_allclose(source, ref["source"], atol=SOURCE_ATOL)
    mag, phase = tkm.kokoro_stft(t(ref["source"]), TINY.istft_n_fft, TINY.istft_hop)
    close(mag, ref["mag"], 1e-5, "mag")
    np.testing.assert_allclose(np.cos(phase.numpy()), np.cos(ref["phase"]), atol=PHASE_ATOL)
    np.testing.assert_allclose(np.sin(phase.numpy()), np.sin(ref["phase"]), atol=PHASE_ATOL)
    # drawn from a torch.Generator where not injected: harmonic 0's phase is 0
    g = torch.Generator().manual_seed(0)
    drawn = tkm.sine_source(tp["decoder"]["generator"], TINY, f0_up, g)
    assert drawn.shape == (1, f0_up.shape[1], 1) and torch.isfinite(drawn).all()


def test_decode_and_generator_on_a_shared_spectrum(trees, ref):
    _, jp, tp = trees
    total = ref["total"]
    generator = jkm.generator
    jkm.generator = lambda *a, **k: generator(*a, **k, har_override=jnp.asarray(ref["har"]))
    try:
        jaudio = jax.jit(lambda p, asr, f0, n, s: jkm.decode(p, JTINY, asr, f0, n, s, total, None))(
            jp, jnp.asarray(ref["asr"]), jnp.asarray(ref["f0"]), jnp.asarray(ref["n_curve"]),
            jnp.asarray(ref["style_dec"]))
    finally:
        jkm.generator = generator
    got = tkm.decode(tp, TINY, t(ref["asr"]), t(ref["f0"]), t(ref["n_curve"]),
                     t(ref["style_dec"]), torch.tensor(total), t(ref["har"]))
    close(got, jaudio, AUDIO_REL, "decode")


def test_generator_ups_g_in_both_orientations(trees):
    """ROADMAP C25: the JAX module multiplies `weight_g` in the orientation
    it is stored in, per output (1, 1, O) from init_params or per input
    (1, I, 1) as a torch checkpoint stores a transposed conv's; the port
    follows it in both (the generator alone, a random spectrum)."""
    np_tree, _, _ = trees
    rng = np.random.default_rng(5)
    per_input = pytree.flatten(np_tree)
    for i in range(2):
        v = per_input[f"decoder.generator.ups.{i}.weight_v"]
        per_input[f"decoder.generator.ups.{i}.weight_g"] = (
            rng.uniform(0.5, 2.0, (1, v.shape[1], 1)).astype(np.float32))
    per_input = pytree.unflatten(per_input)
    x = rng.standard_normal((1, 12, 32)).astype(np.float32)
    s = rng.standard_normal((1, 16)).astype(np.float32)
    f0 = rng.uniform(0, 200, (1, 12)).astype(np.float32)
    har = np.concatenate([np.abs(rng.standard_normal((1, 12 * 20 + 1, 9))),
                          rng.uniform(-3, 3, (1, 12 * 20 + 1, 9))], -1).astype(np.float32)
    for tree in (np_tree, per_input):
        want = jkm.generator(jax.tree_util.tree_map(jnp.asarray, tree), JTINY, jnp.asarray(x),
                             jnp.asarray(s), jnp.asarray(f0), 10, None,
                             har_override=jnp.asarray(har))
        got = tkm.generator(tkm.params_from_numpy(tree, "cpu"), TINY, t(x), t(s),
                            torch.tensor(10), t(har))
        close(got, want, AUDIO_REL)


def test_depthwise_pool_against_jax():
    """A StyleTTS2-style depthwise pool ((K, 1, C) in the JAX tree) through
    the upsampling AdainResBlk1d: groups inferred in both packages."""
    rng = np.random.default_rng(6)
    blk = tkm.numpy_params(np.random.default_rng(7), TINY)["predictor"]["F0"]["1"]
    v = rng.uniform(-0.5, 0.5, (3, 1, 32)).astype(np.float32)
    blk["pool"] = {"weight_v": v, "weight_g": np.sqrt((v * v).sum(axis=(0, 1), keepdims=True)),
                   "bias": rng.uniform(-0.1, 0.1, 32).astype(np.float32)}
    x = rng.standard_normal((1, 20, 32)).astype(np.float32)
    s = rng.standard_normal((1, 16)).astype(np.float32)
    want, _ = jkm.adain_res_blk1d(jax.tree_util.tree_map(jnp.asarray, blk), JTINY,
                                  jnp.asarray(x), jnp.asarray(s), 13, upsample=True)
    tblk = tkm.params_from_numpy({"b": blk}, "cpu")["b"]
    assert tblk["pool"]["weight_v"].shape == (1, 32, 3)
    got, valid = tkm.adain_res_blk1d(tblk, TINY, t(x), t(s), 13, upsample=True)
    close(got, want, STAGE_REL)
    assert valid == 26


def test_synthesizer_whole_against_jax(trees, ref):
    """`KokoroSynthesizer.run` against the JAX `synthesize` (hazards 4–6):
    JAX's draws injected, the durations equal, d, t_en, F0 and N within
    STAGE_REL; the port's own spectrum from those draws as (mag, cos φ,
    sin φ); the audio on JAX's spectrum within AUDIO_REL."""
    _, _, tp = trees
    synth = tsynth.KokoroSynthesizer(tp, TINY)
    s = synth.run(IDS, ref["pack"], draws=(ref["rand_ini"], ref["noise"]))
    np.testing.assert_array_equal(s.durations.numpy(), ref["durations"])
    assert (s.total, s.frames_pad) == (ref["total"], ref["frames_pad"]) and s.frames_pad == 240
    for name, got in (("d", s.d), ("t_en", s.t_en), ("f0", s.f0), ("n_curve", s.n)):
        close(got, ref[name], STAGE_REL, name)
    k = TINY.istft_n_fft // 2 + 1
    np.testing.assert_allclose(s.har[..., :k], ref["mag"], atol=SOURCE_ATOL * 10)
    np.testing.assert_allclose(np.cos(s.har[..., k:].numpy()), np.cos(ref["phase"]),
                               atol=PHASE_ATOL)
    audio = synth.synthesize(IDS, ref["pack"], har=t(ref["har"]))
    assert audio.dtype == np.float32 and len(audio) == ref["total"] * TINY.samples_per_frame
    close(audio, ref["audio"], AUDIO_REL, "audio")


# --------------------------------------------------------------- phase 18's faults


@pytest.mark.parametrize("index", range(5))
def test_planted_fault_lands_outside_the_tolerance(trees, ref, index):
    """Each of chip_smoke phase 18's planted faults, run as phase 18 runs it
    (`kokoro_fault_run`), lands outside the port's tolerance against the JAX
    reference on the output where its term matters."""
    _, _, tp = trees
    fault = chip_smoke.kokoro_faults()[index]
    synth = tsynth.KokoroSynthesizer(tp, TINY)
    s = synth.stage1(synth.prepare(IDS, ref["pack"]))
    synth.stage2(s, har=t(ref["har"]))
    outs = chip_smoke.kokoro_fault_run(synth, tp, s, IDS, ref["pack"], fault)
    refs = {"d": ref["d"], "t_en": ref["t_en"], "F0": ref["f0"], "N": ref["n_curve"],
            "audio": ref["audio"]}
    worst = max(np.abs(v.numpy() - refs[k]).max() / np.abs(refs[k]).max()
                for k, v in outs.items())
    assert worst > 100 * STAGE_REL, (fault[0], worst)


# --------------------------------------------------------------- text front-end


def test_phonemizer_ids_against_jax(caplog):
    texts = ["Hello world.", "The quick brown fox jumps over the lazy dog!",
             "Numbers like 42, and symbols (brackets) — dashes; colons: quotes \"x\".",
             "Thought, through, church; school — phone, whistle."]
    with caplog.at_level(logging.WARNING, logger="tpu_audio_torch.tts"):
        ph = tphon.Phonemizer("en-us", None)
    assert ph.kind == "rules" and "rule-based" in caplog.text
    jp = jphon.Phonemizer("en-us", None)
    for text in texts:
        assert ph.to_ids(text) == jp.to_ids(text), text
        assert all(0 < i < 178 for i in ph.to_ids(text))
    assert tphon.VOCAB == jphon.VOCAB and len(tphon.VOCAB) == len(jphon.VOCAB)
    assert tphon.tokenize("ˈhəloʊ") == jphon.tokenize("ˈhəloʊ") == [156, 50, 83, 54, 57, 135]


def test_lexicon_backend_against_jax(tmp_path):
    (tmp_path / "us_gold.json").write_text('{"hello": "həlˈO", "world": {"DEFAULT": "wˈɜɹld"}}')
    ph, jp = tphon.Phonemizer("en-us", str(tmp_path)), jphon.Phonemizer("en-us", str(tmp_path))
    assert ph.kind == jp.kind == "lexicon"
    for text in ("Hello world, hello there.", "World."):
        assert ph.to_ids(text) == jp.to_ids(text)


def test_450_token_split_against_jax(trees):
    """A sentence over SAFE_TOKEN_LIMIT ids splits where the JAX engine's
    does: at the punctuation nearest its middle, recursively, and a piece
    without punctuation on the token boundary."""
    _, jp, tp = trees
    long = ("This clause is long enough to count, " * 14).strip() + "."
    unbroken = "x" * 1200
    eng = tengine.KokoroEngine.from_params(tp, TINY)
    jeng = jengine.KokoroEngine.from_params(jp, JTINY)
    for text in (long, unbroken, "Short."):
        got = eng._tokenize_bounded(text)
        assert got == jeng._tokenize_bounded(text), text
        assert all(len(p) <= tengine.SAFE_TOKEN_LIMIT for p in got)
    n_ids = len(eng.phonemizer.to_ids(unbroken))  # "x" reads "ks": two ids a letter
    assert len(eng._tokenize_bounded(long)) > 1
    assert len(eng._tokenize_bounded(unbroken)) == -(-n_ids // tengine.SAFE_TOKEN_LIMIT) > 1


def test_voices_against_jax(tmp_path):
    assert tvoices.VOICES == jvoices.VOICES and len(tvoices.VOICES) == 52
    assert tvoices.voice_language("bf_emma") == jvoices.voice_language("bf_emma") == "en-gb"
    np.testing.assert_array_equal(tvoices.random_voice(4), jvoices.random_voice(4))
    vdir = tmp_path / "voices"
    vdir.mkdir()
    packs = {name: tvoices.random_voice(i) for i, name in
             enumerate(("af_heart", "am_adam", "bf_emma"))}
    np.save(vdir / "af_heart.npy", packs["af_heart"])
    chip_smoke.write_safetensors(vdir / "am_adam.safetensors", {"voice": packs["am_adam"]})
    packs["bf_emma"].tofile(vdir / "bf_emma.bin")
    for name, pack in packs.items():
        np.testing.assert_array_equal(tvoices.load_voice(name, str(tmp_path)), pack)
        np.testing.assert_array_equal(jvoices.load_voice(name, str(tmp_path)), pack)
    with pytest.raises(KeyError):
        tvoices.load_voice("xx_nobody", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tvoices.load_voice("af_bella", str(tmp_path))


# --------------------------------------------------------------- load, engine


def test_load_from_a_written_checkpoint(trees, tmp_path, monkeypatch):
    """The MLX layout written by chip_smoke's `kokoro_mlx_flat` (what phase
    11 writes at full width) → `TTS.kokoro(device="cpu").load()` from a
    pre-seeded cache: the tree equals the written one bit for bit, and the
    JAX `convert` of the same file gives the same numbers; the voice pack
    is read from voices/; a missing module is refused."""
    np_tree, _, tp = trees
    flat = chip_smoke.kokoro_mlx_flat(chip_smoke.kokoro_jax_layout(tp))
    voice = tvoices.random_voice(9)
    hub = tmp_path / "hub"

    def write_voice(path):
        path.parent.mkdir(exist_ok=True)
        return chip_smoke.write_safetensors(path, {"af_heart": voice})
    chip_smoke.seed_cache(hub, tload.REPO, {
        tload.WEIGHTS_FILE: lambda p: chip_smoke.write_safetensors(p, flat),
        "voices/af_heart.safetensors": write_voice})
    monkeypatch.setenv("TPU_AUDIO_CACHE", str(hub))
    monkeypatch.setattr(tload, "KokoroConfig", lambda: TINY)
    eng = TTS.kokoro(device="cpu")
    eng.load()
    got = pytree.flatten(eng.synth.params)
    for k, v in pytree.flatten(tp).items():
        assert torch.equal(got[k], v), k
    jflat = pytree.flatten(jload.convert({k: np.asarray(v) for k, v in flat.items()}))
    for k, v in pytree.flatten(np_tree).items():
        np.testing.assert_array_equal(jflat[k], v, err_msg=k)
    np.testing.assert_array_equal(eng._voice_pack(), voice)
    assert eng.phonemizer.kind == "rules"
    ref = tengine.KokoroEngine.from_params(tp, TINY, voice)
    np.testing.assert_array_equal(eng.generate("Hello there.").samples,
                                  ref.generate("Hello there.").samples)
    del flat["predictor.N_proj.weight"], flat["predictor.N_proj.bias"]
    chip_smoke.write_safetensors(tmp_path / "broken.safetensors", flat)
    (tmp_path / "broken").mkdir()
    (tmp_path / "broken.safetensors").rename(tmp_path / "broken" / "model.safetensors")
    from tpu_audio_torch.api.errors import ModelLoadError
    with pytest.raises(ModelLoadError, match="missing"):
        tload.load(str(tmp_path / "broken"), "cpu")


def test_engine_against_the_jax_engine(trees, monkeypatch):
    """Two sentences through `KokoroEngine.generate_streaming` in both
    packages, each sentence's spectrum injected into both: JAX's, from its
    own F0 and its draws (PRNGKey(0)); the durations equal (the chunk
    lengths) and the audio within AUDIO_REL."""
    _, jp, tp = trees
    text = ("This first sentence is long enough to stand on its own here. "
            "And here is the second one, long enough to stay apart.")
    pack = jvoices.random_voice(0)
    jeng = jengine.KokoroEngine.from_params(jp, JTINY, pack)
    eng = TTS.kokoro(device="cpu").from_params(tp, TINY, pack)
    spectra = {}
    jsyn = jeng.synth

    def jax_spectrum(ids):
        """The JAX synthesizer's stage 1 and F0, then the spectrum of JAX's
        draws (as `sine_source` takes them from PRNGKey(0))."""
        toks = np.zeros((1, jsynth.TOKEN_PAD), np.int32)
        toks[0, : len(ids) + 2] = [0] + ids + [0]
        ref_s = pack[len(ids) - 1]
        sd = JTINY.style_dim
        d, dur, _ = jsyn._stage1(jp, jnp.asarray(toks), jnp.int32(len(ids) + 2),
                                 jnp.asarray(ref_s[:, sd: 2 * sd]), jnp.float32(1.0))
        total = int(np.asarray(dur).sum())
        pad = max(jsynth.FRAME_BUCKET, -(-total // jsynth.FRAME_BUCKET) * jsynth.FRAME_BUCKET)
        en = jnp.einsum("btc,tf->bfc", d, jkm.alignment_matrix(dur, pad))
        f0, _, _ = jkm.f0n_predict(jp, JTINY, en, jnp.asarray(ref_s[:, sd: 2 * sd]), total)
        up = int(np.prod(JTINY.upsample_rates)) * JTINY.istft_hop
        f0_up = jnp.repeat(f0[..., None], up, axis=1)
        r, n = jax_draws(0, 1, f0_up.shape[1], JTINY.harmonic_num + 1)
        src = jkm.sine_source(jp["decoder"]["generator"], JTINY, f0_up, jax.random.PRNGKey(0),
                              rand_ini=jnp.asarray(r), noise=jnp.asarray(n))[..., 0]
        mag, ph = jkm._kokoro_stft(src, JTINY.istft_n_fft, JTINY.istft_hop)
        return np.asarray(jnp.concatenate([mag, ph], -1)), np.asarray(dur)

    jsyn_synth, generator = jsyn.synthesize, jkm.generator

    def jax_synth(ids, voice_style, speed=1.0, seed=0):
        har, dur = jax_spectrum(ids)
        spectra[tuple(ids)] = (har, dur)
        jkm.generator = lambda *a, **k: generator(*a, **k, har_override=jnp.asarray(har))
        try:
            return jsyn_synth(ids, voice_style, speed, seed)
        finally:
            jkm.generator = generator
    monkeypatch.setattr(jsyn, "synthesize", jax_synth)
    want = list(jeng.generate_streaming(text))
    runs = []

    def shared(ids, voice_style, speed=1.0, seed=0):
        s = eng.synth.run(ids, voice_style, speed, seed, har=t(spectra[tuple(ids)][0]))
        runs.append(s)
        return s.audio.numpy()
    monkeypatch.setattr(eng.synth, "synthesize", shared)
    got = list(eng.generate_streaming(text))
    assert len(got) == len(want) == 2
    for g, w, s in zip(got, want, runs):
        assert (g.text, g.is_final, g.sample_rate) == (w.text, w.is_final, w.sample_rate)
        np.testing.assert_array_equal(s.durations.numpy(), spectra[tuple(
            eng.phonemizer.to_ids(g.text))][1])
        close(g.samples, w.samples, AUDIO_REL, g.text)


def test_engine_with_every_default(trees):
    """`TTS.kokoro(device="cpu")` → `from_params(tree, cfg)` with the
    default voice pack, device and speed → `generate` of a short text, its
    default granularity: one sentence of finite 24 kHz audio, a multiple of
    samples_per_frame; `set_voice`, the factory's card default, `stop`."""
    _, _, tp = trees
    factory = TTS.kokoro(device="cpu")
    assert isinstance(factory, tengine.KokoroEngine) and factory.voice == "af_heart"
    assert TTS.kokoro().device == "cuda"
    eng = factory.from_params(tp, TINY)
    assert eng.device == torch.device("cpu")
    np.testing.assert_array_equal(eng._voice_pack(), tvoices.random_voice())
    res = eng.generate("Hi there, from Kokoro.")
    assert res.sample_rate == 24000 and res.duration > 0
    assert len(res.samples) % TINY.samples_per_frame == 0 and np.isfinite(res.samples).all()
    eng.set_voice("bf_emma")
    assert eng.voice == "bf_emma" and eng.phonemizer.kind == "rules"
    eng.set_voice("af_heart")
    stream = eng.generate_streaming("This first sentence is long enough to stand on its own "
                                    "here. And a second one follows it, long enough too.")
    next(stream)
    eng.stop()
    from tpu_audio_torch.api.tts import GenerationStopped
    with pytest.raises(GenerationStopped):
        next(stream)
