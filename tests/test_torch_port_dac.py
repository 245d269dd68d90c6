"""PyTorch port, the DAC codec (tpu_audio_torch/codecs/dac/) against the
JAX package on the CPU: `encode_latent`, `quantize`, `encode`,
`decode_codes` at TINY_DAC (the JAX suite's tiny config) in f32, the
checkpoint conversion and `load_dir` on files written here in torch DAC's
layout (chip_smoke's writer), and the OuteTTS engine's 25-frame decode
bucket.

Tolerances: latents and waveforms within 1e-5 of max|ref| (the two
packages' convolutions sum in other orders: ~1e-6 measured). Codes equal
wherever the JAX distance margin between the best and the second code
exceeds the two packages' measured distance difference; such near ties
are asserted rare (none at these seeds).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_audio.codecs import dac as jdac
from tpu_audio.codecs.dac import load as jload
from tpu_audio.models.outetts.engine import OuteTTSEngine as JOuteTTSEngine
from tpu_audio_torch.api.errors import ModelLoadError
from tpu_audio_torch.codecs.dac import load as tload
from tpu_audio_torch.codecs.dac import model as tdac
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.outetts.engine import OuteTTSEngine
from tpu_audio_torch.nn import layers as tlayers
from tpu_audio_torch.utils import pytree, weights
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

TINY = dict(encoder_dim=8, encoder_rates=(2, 4, 5, 8), decoder_dim=64, decoder_rates=(8, 5, 4, 2),
            n_codebooks=2, codebook_size=32, codebook_dim=4, latent_dim=128)


def close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, err


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX params, port config, port params) on one tree."""
    jcfg, tcfg = jdac.DACConfig(**TINY), tdac.DACConfig(**TINY)
    jp = jdac.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def audio(seed: int, frames: int, hop: int, batch: int = 2) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((batch, frames * hop)) * 0.3
            ).astype(np.float32)


def _stage_dists(q, residual, l2n, wn) -> np.ndarray:
    """One stage's distances (B, T, N) as `quantize` forms them, by a
    package's own normalisation and projection, summed in float64."""
    enc_n = np.asarray(l2n(wn(q["in_proj"], residual)), np.float64)
    cb_n = np.asarray(l2n(q["codebook"]["weight"]), np.float64)
    return (enc_n ** 2).sum(-1, keepdims=True) - 2 * enc_n @ cb_n.T + (cb_n ** 2).sum(-1)


def test_numpy_params_match_the_jax_init(pair):
    """The port's schema (keys, shapes) is the JAX `init_params` tree's, at
    TINY_DAC and at the published DACConfig()."""
    for cfg in (TINY, {}):
        want = jax.eval_shape(lambda: jdac.init_params(jax.random.PRNGKey(0),
                                                       jdac.DACConfig(**cfg)))
        got = tdac.numpy_params(weights.ShapeRNG(), tdac.DACConfig(**cfg))
        want = {k: tuple(v.shape) for k, v in pytree.flatten(want).items()}
        assert {k: tuple(v.shape) for k, v in pytree.flatten(got).items()} == want
    assert tdac.DACConfig().hop == jdac.DACConfig().hop == 320


@pytest.mark.parametrize("frames", [5, 12])
def test_encode_latent_and_quantize_match(pair, frames):
    jcfg, jp, tcfg, tp = pair
    x = audio(frames, frames, jcfg.hop)
    zj = jdac.model.encode_latent(jp, jcfg, jnp.asarray(x))
    zt = tdac.encode_latent(tp, tcfg, torch.from_numpy(x))
    close(zt, zj)
    # each stage on the JAX residual: codes equal beyond the measured difference
    codes_j, zq_j = jdac.model.quantize(jp, jcfg, zj)
    codes_t, zq_t = tdac.quantize(tp, tcfg, torch.from_numpy(np.array(zj)))
    codes_j = np.asarray(codes_j)
    residual_j = np.array(zj)
    ties = 0
    for i in range(jcfg.n_codebooks):
        qj, qt = jp["quantizer"][str(i)], tp["quantizer"][str(i)]
        dj = _stage_dists(qj, jnp.asarray(residual_j), jdac.model._l2n, jdac.model._wn)
        dt = _stage_dists(qt, torch.from_numpy(residual_j), tdac._l2n,
                          tlayers.weight_norm_conv1d)
        diff = np.abs(dj - dt).max()
        best = np.sort(dj, -1)
        clear = best[..., 1] - best[..., 0] > 2 * diff
        ties += int((~clear).sum())
        np.testing.assert_array_equal(dj.argmin(-1)[clear], codes_j[:, i][clear])
        np.testing.assert_array_equal(codes_t[:, i].numpy()[clear], codes_j[:, i][clear])
        z_qi = jdac.model._wn(qj["out_proj"], jnp.asarray(qj["codebook"]["weight"])[codes_j[:, i]])
        residual_j = residual_j - np.asarray(z_qi)
    assert ties <= codes_j.size // 100, ties  # near ties are rare
    assert codes_t.dtype == torch.int64 and tuple(codes_t.shape) == (2, 2, frames)
    close(zq_t, zq_j)
    assert torch.equal(tdac.encode(tp, tcfg, torch.from_numpy(x)), codes_t) or ties


@pytest.mark.parametrize("frames", [1, 7])
def test_decode_codes_matches(pair, frames):
    jcfg, jp, tcfg, tp = pair
    codes = np.random.default_rng(frames).integers(0, jcfg.codebook_size, (2, 2, frames))
    ref = jdac.decode_codes(jp, jcfg, jnp.asarray(codes))
    got = tdac.decode_codes(tp, tcfg, torch.from_numpy(codes))
    assert tuple(got.shape) == (2, frames * jcfg.hop)
    close(got, ref)
    close(tdac.codes_to_latent(tp, tcfg, torch.from_numpy(codes)),
          jdac.model.codes_to_latent(jp, jcfg, jnp.asarray(codes)))


def test_codes_past_the_codebook_read_its_last_row(pair):
    """As the JAX gather clamps an index past the table."""
    jcfg, jp, tcfg, tp = pair
    codes = np.array([[[0, 31, 40, 1000], [5, 32, 31, 7]]])
    close(tdac.codes_to_latent(tp, tcfg, torch.from_numpy(codes)),
          jdac.model.codes_to_latent(jp, jcfg, jnp.asarray(codes)))


def test_convert_dac_matches_jax_but_the_alpha(pair):
    """ROADMAP C12: on a flat dict in torch DAC's layout, every leaf equals
    the JAX `convert`'s bit for bit except the Snake alphas: the JAX ones
    stay (1, C, 1), the port's are (1, 1, C), the model's layout, and equal
    the original tree's."""
    _, jp, _, tp = pair
    flat = {k: v.numpy() for k, v in chip_smoke.dac_torch_flat(tp).items()}
    assert all(v.shape[:1] + v.shape[2:] == (1, 1) for k, v in flat.items()
               if k.endswith(".alpha"))
    ref = pytree.flatten(jload.convert(flat))
    got = pytree.flatten(tload.convert_dac(flat))
    assert sorted(got) == sorted(ref)
    alphas = [k for k in ref if k.endswith(".alpha")]
    assert len(alphas) == 2 + 4 * 7 * 2  # in/out snakes, 4 blocks of 1 + 3 × 2 on both sides
    for k in ref:
        if k in alphas:
            c = got[k].shape[2]
            assert ref[k].shape == (1, c, 1) and got[k].shape == (1, 1, c), k
            np.testing.assert_array_equal(got[k], ref[k].transpose(0, 2, 1))
        else:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    orig = pytree.flatten(jax.tree.map(np.asarray, jp))
    assert all(np.array_equal(got[k], orig[k]) for k in orig)


def write_dac(path, flat: dict, cfg: dict):
    path.mkdir(parents=True, exist_ok=True)
    chip_smoke.write_safetensors(path / "model.safetensors", flat)
    (path / "config.json").write_text(json.dumps(cfg))
    return path


def test_load_dir_reads_a_written_checkpoint_and_refuses_other_alphas(pair, tmp_path,
                                                                      monkeypatch):
    _, _, tcfg, tp = pair
    flat = chip_smoke.dac_torch_flat(tp)
    raw = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()}
    path = write_dac(tmp_path / "dac", flat, raw)
    got, cfg = tload.load_dir(str(path), device="cpu")
    assert cfg == tcfg
    want = pytree.flatten(tp)
    assert sorted(pytree.flatten(got)) == sorted(want)
    assert all(torch.equal(v, want[k]) for k, v in pytree.flatten(got).items())
    got16, _ = tload.load(str(path), dtype=torch.bfloat16, device="cpu")
    assert got16["decoder"]["conv_in"]["weight_v"].dtype == torch.bfloat16
    # an alpha stored channels-last turns to (1, C, 1): refused as shape drift
    bad = dict(flat)
    key = next(k for k in bad if k.endswith(".alpha"))
    bad[key] = bad[key].permute(0, 2, 1)
    with pytest.raises(ModelLoadError, match="shape mismatches"):
        tload.load_dir(str(write_dac(tmp_path / "bad", bad, raw)), device="cpu")
    # and so is the JAX rule, which leaves every alpha (1, C, 1)
    monkeypatch.setattr(tload, "convert_dac", jload.convert)
    with pytest.raises(ModelLoadError, match="alpha"):
        tload.load_dir(str(path), device="cpu")
    monkeypatch.setenv("TPU_AUDIO_CACHE", str(tmp_path / "empty"))
    with pytest.raises(ModelLoadError, match="dac-speech-24khz"):
        tload.load()


def test_decode_bucket_of_25_frames(pair):
    """The engine pads the codes with code 0 to a multiple of 25 frames, as
    the JAX engine does; DAC is not causal, so the padding reaches the last
    real frames and an unpadded decode differs there."""
    jcfg, jp, tcfg, tp = pair
    eng, ref_eng = OuteTTSEngine(speaker=None, device="cpu"), JOuteTTSEngine(speaker=None)
    eng.dac_params, eng.dac_cfg = tp, tcfg
    ref_eng.dac_params, ref_eng.dac_cfg = jp, jcfg
    rng = np.random.default_rng(3)
    c1, c2 = (rng.integers(0, 32, 30).astype(np.int32) for _ in range(2))
    got, ref = eng._decode_dac(c1, c2), ref_eng._decode_dac(c1, c2)
    assert got.dtype == np.float32 and got.shape == ref.shape == (30 * jcfg.hop,)
    close(got, ref)
    assert eng._decode_dac(c1[:0], c2[:0]).shape == (0,)
    bare = tdac.decode_codes(tp, tcfg, torch.from_numpy(np.stack([c1, c2])[None].astype(
        np.int64)))[0].numpy()
    scale = np.abs(ref).max()
    tail = slice(27 * jcfg.hop, None)  # the last 3 frames
    assert np.abs(bare[tail] - got[tail]).max() > 1e-3 * scale
    head = slice(0, 20 * jcfg.hop)  # far from the padding: the receptive field ends
    assert np.abs(bare[head] - got[head]).max() <= 1e-5 * scale
