"""PyTorch port, the Mimi codec (tpu_audio_torch/codecs/mimi/) against the
JAX package on the CPU at TINY_MIMI (the JAX suite's tiny config): encode
and decode (with fewer codebooks too), the exact streaming decoder against
the one-shot decode at a chunk of one frame and of a span, across the
transformer's context window, the layout of every 3-D leaf after Mimi's own
conversion, and `convert_mimi` / `load_mimi_dir` on files written here.

Tolerances: waveforms within 1e-5 of max|ref| (~7e-7 measured: the
convolutions sum in other orders); codes equal; the streaming decoder
within 1e-5 of max|one-shot| (it takes the same products, in other
groupings).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_audio.codecs import mimi as jmimi
from tpu_audio.codecs.mimi import streaming as jstreaming
from tpu_audio.models.marvis import load as jload
from tpu_audio_torch.api.errors import ModelLoadError
from tpu_audio_torch.codecs.mimi import model as tmimi
from tpu_audio_torch.codecs.mimi import streaming as tstreaming
from tpu_audio_torch.models.marvis import load as tload
from tpu_audio_torch.utils import pytree, weights
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

TINY = dict(dimension=32, n_filters=4, ratios=(4, 3, 2), t_layers=2, t_heads=4, t_ff=64, n_q=4,
            bins=16, q_dim=8)


def close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, err


def build(seed: int = 0, **over):
    """(JAX config, JAX params, port config, port params) on one tree."""
    kw = {**TINY, **over}
    jcfg, tcfg = jmimi.MimiConfig(**kw), tmimi.MimiConfig(**kw)
    jp = jmimi.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, tcfg, tmimi.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def pair():
    return build()


def test_numpy_params_match_the_jax_init():
    for cfg in (TINY, {}):
        want = jax.eval_shape(lambda: jmimi.init_params(jax.random.PRNGKey(0),
                                                        jmimi.MimiConfig(**cfg)))
        got = tmimi.numpy_params(weights.ShapeRNG(), tmimi.MimiConfig(**cfg))
        want = {k: tuple(v.shape) for k, v in pytree.flatten(want).items()}
        assert {k: tuple(v.shape) for k, v in pytree.flatten(got).items()} == want
    cfg = tmimi.MimiConfig()
    assert (cfg.hop, cfg.downsample_stride, cfg.seanet_hop) == (1920, 2, 960)


@pytest.mark.parametrize("frames", [1, 6])
def test_encode_matches(pair, frames):
    jcfg, jp, tcfg, tp = pair
    audio = (np.random.default_rng(frames).standard_normal((2, jcfg.hop * frames)) * 0.3
             ).astype(np.float32)
    ref = np.asarray(jmimi.encode(jp, jcfg, jnp.asarray(audio)))
    got = tmimi.encode(tp, tcfg, torch.from_numpy(audio))
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, jcfg.n_q, frames)
    np.testing.assert_array_equal(got.numpy(), ref)
    z = jmimi.model.seanet_encode(jp, jcfg, jnp.asarray(audio))
    close(tmimi.seanet_encode(tp, tcfg, torch.from_numpy(audio)), z)
    close(tmimi.transformer_apply(tp["encoder_transformer"], tcfg, torch.from_numpy(np.array(z))),
          jmimi.model.transformer_apply(jp["encoder_transformer"], jcfg, z))


@pytest.mark.parametrize("n_q", [4, 2, 1])
def test_decode_matches_with_fewer_codebooks(pair, n_q):
    jcfg, jp, tcfg, tp = pair
    codes = np.random.default_rng(n_q).integers(0, jcfg.bins, (2, n_q, 7))
    ref = jmimi.decode(jp, jcfg, jnp.asarray(codes))
    got = tmimi.decode(tp, tcfg, torch.from_numpy(codes))
    assert tuple(got.shape) == (2, 7 * jcfg.hop)
    close(got, ref)


def test_padding_does_not_reach_earlier_frames(pair):
    """Mimi is causal: the engine's bucket of 8 frames (code 0 after the
    last) leaves the real frames' samples as they are, up to the rounding
    of convolutions over other lengths (DAC's padding moves them by 1e-3)."""
    _, _, tcfg, tp = pair
    codes = torch.from_numpy(np.random.default_rng(3).integers(0, tcfg.bins, (1, 4, 5)))
    bare = tmimi.decode(tp, tcfg, codes)[0]
    padded = tmimi.decode(tp, tcfg, torch.cat([codes, torch.zeros(1, 4, 3, dtype=torch.int64)],
                                              dim=2))[0]
    assert padded.shape[0] == 8 * tcfg.hop
    close(padded[: 5 * tcfg.hop], bare, rel=1e-6)


def stream(cfg, params, codes: np.ndarray, chunk: int) -> np.ndarray:
    state = tstreaming.init_state(params, cfg, batch=codes.shape[0], chunk_frames=chunk)
    outs = []
    for s in range(0, codes.shape[-1], chunk):
        audio, state = tstreaming.decode_stream(params, cfg, torch.from_numpy(
            codes[:, :, s: s + chunk]), state)
        outs.append(audio.numpy())
    assert int(state.tf_pos) == codes.shape[-1] * cfg.downsample_stride
    return np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("chunk", [1, 4, 6])
def test_decode_stream_equals_one_shot(pair, chunk):
    """At a chunk of one frame, of a span (4) and of the engine's 6, over 14
    frames (a partial last chunk at 4 and 6): the chunks concatenated equal
    the one-shot decode, and the JAX streaming decoder's."""
    jcfg, jp, tcfg, tp = pair
    codes = np.random.default_rng(chunk).integers(0, jcfg.bins, (1, jcfg.n_q, 14))
    full = tmimi.decode(tp, tcfg, torch.from_numpy(codes)).numpy()
    got = stream(tcfg, tp, codes, chunk)
    assert got.shape == full.shape
    close(got, full)
    state = jstreaming.init_state(jp, jcfg, batch=1, chunk_frames=chunk)
    ref = []
    for s in range(0, 14, chunk):
        audio, state = jstreaming.decode_stream(jp, jcfg, jnp.asarray(codes[:, :, s: s + chunk]),
                                                state)
        ref.append(np.asarray(audio))
    close(got, np.concatenate(ref, -1))


def test_decode_stream_across_the_context_window():
    """A context of 4 25 Hz frames: chunks of 3 frames cross it, and the
    sliding K/V cache still matches the one-shot pass's window mask."""
    jcfg, jp, tcfg, tp = build(3, n_q=2, t_context=4)
    codes = np.random.default_rng(3).integers(0, jcfg.bins, (1, 2, 9))
    full = tmimi.decode(tp, tcfg, torch.from_numpy(codes)).numpy()
    close(full, jmimi.decode(jp, jcfg, jnp.asarray(codes)))
    close(stream(tcfg, tp, codes, 3), full)
    # the window matters here: a context of 250 decodes otherwise
    wide = tmimi.decode(tp, tmimi.MimiConfig(**{**TINY, "n_q": 2}), torch.from_numpy(codes))
    assert np.abs(wide.numpy() - full).max() > 1e-4 * np.abs(full).max()


def test_every_3d_leaf_gets_its_layout():
    """Trap: `convert.params_from_numpy`'s key rule does not reach Mimi's
    kernels. Each 3-D leaf of the tree, at TINY_MIMI and at the published
    MimiConfig(): the decoder's upsampling convolutions (I, O, K), the
    depthwise ×2 upsampler (C, 1, K), every other kernel (O, I, K)."""
    for kw in (TINY, {}):
        cfg = tmimi.MimiConfig(**kw)
        jax_shapes = {k: tuple(v.shape) for k, v in pytree.flatten(
            tmimi.numpy_params(weights.ShapeRNG(), cfg)).items()}
        layouts = {k: tmimi.conv_layout(k) for k, s in jax_shapes.items() if len(s) == 3}
        ratios = len(cfg.ratios)
        assert sorted(k for k, v in layouts.items() if v == "transposed") == [
            f"decoder.layers.{2 * i}.weight" for i in range(ratios)]
        assert [k for k, v in layouts.items() if v == "depthwise"] == ["upsample.convtr.weight"]
        # 2 SEANet ends a side, 2 convs a resblock, a strided conv a ratio
        # (the encoder's), the 4 RVQ projections and the downsampler
        assert sum(v == "conv" for v in layouts.values()) == 4 + 4 * ratios + ratios + 4 + 1
    cfg = tmimi.MimiConfig(**TINY)
    rng = np.random.default_rng(0)
    tree = tmimi.numpy_params(rng, cfg)
    flat = pytree.flatten(tree)
    got = pytree.flatten(tmimi.params_from_numpy(tree, "cpu"))
    perm = {"conv": (2, 1, 0), "transposed": (1, 2, 0), "depthwise": (2, 1, 0)}
    for k, v in flat.items():
        want = v.transpose(perm[tmimi.conv_layout(k)]) if v.ndim == 3 else v
        assert tuple(got[k].shape) == want.shape and np.array_equal(got[k].numpy(), want), k
    up = got["upsample.convtr.weight"]
    assert tuple(up.shape) == (cfg.dimension, 1, 2 * cfg.downsample_stride)
    tr = got["decoder.layers.0.weight"]  # torch ConvTranspose1d: (in, out, K)
    assert tuple(tr.shape) == (4 * 8, 4 * 4, 2 * cfg.ratios[0])  # 32 → 16 channels


def test_convert_mimi_and_load_mimi_dir(pair, tmp_path, monkeypatch):
    """A file in the kyutai layout (chip_smoke's writer): `convert_mimi`
    equals the JAX function bit for bit and the original tree; `load_mimi_dir`
    gives the port's tree at MimiConfig(); a transposed conv stored as a
    plain one is refused as shape drift."""
    _, jp, _, tp = pair
    flat = {k: v.numpy() for k, v in chip_smoke.mimi_torch_flat(tp).items()}
    assert "decoder.model.0.convtr.convtr.weight" in flat
    assert "upsample.convtr.convtr.convtr.weight" in flat
    assert "encoder.model.1.conv.conv.weight" in flat
    ref, got = pytree.flatten(jload.convert_mimi(flat)), pytree.flatten(tload.convert_mimi(flat))
    orig = pytree.flatten(jax.tree.map(np.asarray, jp))
    assert sorted(got) == sorted(ref) == sorted(orig)
    assert all(np.array_equal(got[k], ref[k]) and np.array_equal(got[k], orig[k]) for k in orig)

    cfg = tmimi.MimiConfig(n_filters=4, t_layers=1, t_ff=64, n_q=2, bins=16, q_dim=8)
    full = tmimi.init_params(1, cfg, device="cpu")
    path = tmp_path / "mimi"
    path.mkdir()
    chip_smoke.write_safetensors(path / "tokenizer.safetensors", chip_smoke.mimi_torch_flat(full))
    monkeypatch.setattr(tload, "MimiConfig", lambda: cfg)
    params, got_cfg = tload.load_mimi_dir(str(path), device="cpu")
    assert got_cfg == cfg
    want = pytree.flatten(full)
    assert sorted(pytree.flatten(params)) == sorted(want)
    assert all(torch.equal(v, want[k]) for k, v in pytree.flatten(params).items())
    bad = chip_smoke.mimi_torch_flat(full)
    w = bad.pop("decoder.model.2.convtr.convtr.weight")
    bad["decoder.model.2.conv.conv.weight"] = w
    (path / "tokenizer.safetensors").unlink()
    chip_smoke.write_safetensors(path / "tokenizer.safetensors", bad)
    with pytest.raises(ModelLoadError, match="shape mismatches"):
        tload.load_mimi_dir(str(path), device="cpu")
