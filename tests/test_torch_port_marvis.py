"""PyTorch port, Marvis (tpu_audio_torch/models/marvis/) against the JAX
package on the CPU: `frame_step` per op at TINY_MARVIS (the JAX suite's
tiny config), greedy and with the JAX package's own Gumbel draws injected;
the whole-stack step's two routes (the depth decoder a launch a codebook,
`_depth_fused_decode`, and the backbone's one-token frame step,
`frame_step_fused_bb`) through their plain versions against the JAX fused
path with `fused_decode_step(interpret=True)`, through the logits of every
codebook; the engine at FRAME and SENTENCE granularity; `_quantize("w8a8")`;
the loader, the 6-bit refusal, the unported int8 KV cache and one call with
every default.

Tolerances: logits within 1e-5 of max|ref| at f32 (the stacks sum in other
orders); tokens equal (their margins asserted over the logits' difference
where the path is held through logits); waveforms within 1e-5 of max|ref|.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_audio.codecs import mimi as jmimi
from tpu_audio.models.marvis import model as jmodel
from tpu_audio.models.marvis.engine import MarvisEngine as JMarvisEngine
from tpu_audio.nn import transformer as jt
from tpu_audio.ops import quant as jquant
from tpu_audio.ops.pallas import fused_step as jfs
from tpu_audio_torch.api.tts import TTS, StreamingGranularity
from tpu_audio_torch.codecs.mimi import model as tmimi
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.marvis import load as tload
from tpu_audio_torch.models.marvis import model as tmodel
from tpu_audio_torch.models.marvis.engine import MarvisEngine
from tpu_audio_torch.nn import transformer as tt
from tpu_audio_torch.utils import pytree, weights
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

MIMI = dict(dimension=32, n_filters=4, ratios=(4, 3, 2), t_layers=2, t_heads=4, t_ff=64, n_q=4,
            bins=16, q_dim=8)
TINY = dict(backbone=dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=64),
            decoder=dict(dim=16, n_layers=1, n_heads=2, n_kv_heads=2, hidden_dim=32),
            text_vocab_size=300, audio_vocab_size=32, n_codebooks=4)
# the whole-stack step's widths: hd 64 on both stacks (the JAX suite's
# TestFusedDepthPath config, with the backbone's heads halved)
FUSED = dict(backbone=dict(dim=128, n_layers=2, n_heads=2, n_kv_heads=1, hidden_dim=256),
             decoder=dict(dim=128, n_layers=2, n_heads=2, n_kv_heads=1, hidden_dim=512),
             text_vocab_size=300, audio_vocab_size=64, n_codebooks=8)


def close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, err


def configs(spec: dict):
    kw = {k: v for k, v in spec.items() if k not in ("backbone", "decoder")}
    return (jmodel.MarvisConfig(backbone=jt.TransformerConfig(**spec["backbone"]),
                                decoder=jt.TransformerConfig(**spec["decoder"]), **kw),
            tmodel.MarvisConfig(backbone=tt.TransformerConfig(**spec["backbone"]),
                                decoder=tt.TransformerConfig(**spec["decoder"]), **kw))


def to_torch(tree, dtype=torch.float32):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu", dtype=dtype)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = configs(TINY)
    jp = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    jm = jmimi.init_params(jax.random.PRNGKey(0), jmimi.MimiConfig(**MIMI))
    return (jcfg, jp, tcfg, to_torch(jp), jm,
            tmimi.params_from_numpy(jax.tree.map(np.asarray, jm), "cpu"))


@pytest.fixture
def jax_marvis_fused(monkeypatch):
    """The JAX package's whole-stack step on, in interpret mode: its gates
    test for a TPU and probe a compile."""
    monkeypatch.setattr(jfs, "fused_decode_step",
                        functools.partial(jfs.fused_decode_step, interpret=True))
    monkeypatch.setattr(jfs, "supported", lambda *a, **k: True)
    monkeypatch.setattr(jfs, "probe_compile", lambda *a, **k: True)


@pytest.fixture
def logits_log(monkeypatch):
    """Record the logits every draw of both packages' samplers sees."""
    log = {"jax": [], "port": []}
    orig = jmodel._sampler

    def sampler(temperature, top_k):
        inner = orig(temperature, top_k)

        def sample(key, logits):  # traced inside the depth scan: a callback
            jax.debug.callback(lambda lg: log["jax"].append(np.asarray(lg, np.float32)), logits)
            return inner(key, logits)
        return sample

    monkeypatch.setattr(jmodel, "_sampler", sampler)
    call = tmodel.Sampler.__call__

    def record(self, logits):
        log["port"].append(logits.float().numpy().copy())
        return call(self, logits)

    monkeypatch.setattr(tmodel.Sampler, "__call__", record)
    return log


def held_through_logits(log, frames_j, frames_t):
    """Every codebook's logits within 1e-5, the greedy tokens equal, and
    each token's margin over the runner-up above the two packages'
    difference."""
    assert len(log["jax"]) == len(log["port"]) > 0
    for lj, lt in zip(log["jax"], log["port"]):
        close(lt, lj)
        top2 = np.sort(lj, -1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0] > 2 * np.abs(lt - lj).max()).all()
    np.testing.assert_array_equal(np.asarray(frames_t), np.asarray(frames_j))


def test_configs_and_schema_match_jax():
    assert tmodel.BACKBONE_250M == tt.TransformerConfig(**{
        k: getattr(jmodel.BACKBONE_250M, k) for k in tt.TransformerConfig.__dataclass_fields__})
    assert tmodel.DECODER_250M == tt.TransformerConfig(**{
        k: getattr(jmodel.DECODER_250M, k) for k in tt.TransformerConfig.__dataclass_fields__})
    for spec in (TINY, None):
        jcfg, tcfg = configs(spec) if spec else (jmodel.MarvisConfig(), tmodel.MarvisConfig())
        want = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jcfg))
        got = tmodel.numpy_params(weights.ShapeRNG(), tcfg)
        assert ({k: tuple(v.shape) for k, v in pytree.flatten(got).items()}
                == {k: tuple(v.shape) for k, v in pytree.flatten(want).items()})
        assert tmodel.depth_ring_len(tcfg) == jmodel.depth_ring_len(jcfg)
    assert tmodel.backbone_ring_len(32, 25, 6) == jmodel.backbone_ring_len(32, 25, 6) == 72
    for flavor in ("llama-1B", "llama-100M", "llama-250M", "llama-60M"):
        j, t = (jmodel_load().backbone_config_from_flavor(flavor),
                tload.backbone_config_from_flavor(flavor))
        assert dataclasses.asdict(t) == {k: getattr(j, k) for k in dataclasses.asdict(t)}


def jmodel_load():
    from tpu_audio.models.marvis import load as jload

    return jload


@pytest.mark.parametrize("sampled", [False, True])
def test_frame_step_matches_jax(tiny, logits_log, sampled):
    """The per-op frame: the prompt through the backbone, codebook 0, the
    depth decoder over [h, c0, …]; greedy, or at temperature 0.9 / top-k 8
    with the JAX keys' Gumbel draws injected."""
    jcfg, jp, tcfg, tp, _, _ = tiny
    k = jcfg.n_codebooks
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 32, (1, 5, k + 1))
    tokens[..., -1] = rng.integers(0, 300, 5)
    mask = rng.random((1, 5, k + 1)) < 0.7
    key = jax.random.PRNGKey(3)
    kw = dict(max_codebooks=k, temperature=0.9 if sampled else 0.0, top_k=8 if sampled else 0)
    jc = jt.make_cache(jcfg.backbone, 1, 16, dtype=jnp.float32)
    fj, jc = jmodel.frame_step(jp, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(mask), jc,
                               key, **kw)
    noises = torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(kk, (1, 32)))
                                        for kk in jax.random.split(key, k)]))
    tc = tt.make_cache(tcfg.backbone, 1, 16, dtype=torch.float32, device="cpu")
    ft, tc = tmodel.frame_step(tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(mask), tc,
                               noises=noises if sampled else None, **kw)
    assert int(tc.pos) == int(jc.pos) == 5 and ft.dtype == torch.int64
    close(tc.k[:, :, :5], np.asarray(jc.k[:, :, :5]))
    if sampled:
        for lj, lt in zip(logits_log["jax"], logits_log["port"]):
            close(lt, lj)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    else:
        held_through_logits(logits_log, fj, ft)
    ft2, _ = tmodel.frame_step(tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(mask),
                               tt.make_cache(tcfg.backbone, 1, 16, torch.float32, device="cpu"),
                               max_codebooks=2, temperature=0.0, top_k=0)
    assert tuple(ft2.shape) == (1, 2)


def fused_params(kind: str, seed: int):
    jcfg, tcfg = configs(FUSED)
    jp = JMarvisEngine._fuse(jmodel.init_params(jax.random.PRNGKey(seed), jcfg))
    if kind == "int8":
        jp = dict(jp, decoder=jquant.fuse_int8_tree(jquant.quantize_tree_int8(
            jmodel.init_params(jax.random.PRNGKey(seed), jcfg)["decoder"])))
    return jcfg, jp, tcfg, to_torch(jp)


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_fused_depth_decode_matches_jax_fused(jax_marvis_fused, logits_log, kind):
    """`frame_step(depth_fused=True)`: the depth decoder a step launch a
    codebook (here its plain version) against the JAX whole-stack kernel in
    interpret mode, on the fp and the int8 depth stacks."""
    jcfg, jp, tcfg, tp = fused_params(kind, 7)
    k = jcfg.n_codebooks
    tokens = np.zeros((1, 5, k + 1), np.int64)
    tokens[0, :, -1] = np.arange(10, 15)
    mask = np.ones((1, 5, k + 1), bool)
    kw = dict(max_codebooks=k, temperature=0.0, top_k=0, depth_fused=True)
    fj, _ = jmodel.frame_step(jp, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(mask),
                              jt.make_cache(jcfg.backbone, 1, 32, dtype=jnp.float32),
                              jax.random.PRNGKey(3), **kw)
    tc = tt.make_cache(tcfg.backbone, 1, 32, dtype=torch.float32, device="cpu")
    ft, _ = tmodel.frame_step(tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(mask), tc,
                              **kw)
    held_through_logits(logits_log, fj, ft)
    # and the per-op depth decode of the port agrees with its fused route
    logits_log["port"].clear()
    ref = logits_log["port"]
    tc = tt.make_cache(tcfg.backbone, 1, 32, dtype=torch.float32, device="cpu")
    fp, _ = tmodel.frame_step(tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(mask), tc,
                              **{**kw, "depth_fused": False})
    assert len(ref) == k
    if kind == "fp":
        np.testing.assert_array_equal(fp.numpy(), ft.numpy())


def test_fused_backbone_frames_match_jax_fused(jax_marvis_fused, logits_log):
    """`frame_step_fused_bb` over three frames after a left-padded prefill:
    the backbone's one-token step and every depth step through the
    whole-stack step, its cache in the kernel's layout (`cache_to_fused`),
    the pad masked by `start`."""
    jcfg, jp, tcfg, tp = fused_params("fp", 11)
    k = jcfg.n_codebooks
    n, pad, s_max = 5, 8, 24
    tokens = np.zeros((1, pad, k + 1), np.int64)
    mask = np.zeros((1, pad, k + 1), bool)
    tokens[0, pad - n:, -1] = np.arange(10, 10 + n)
    mask[0, pad - n:, -1] = True
    extra_j = jnp.where(jnp.arange(s_max) >= pad - n, 0.0, -1e30)[None, None, None, :]
    extra_t = torch.from_numpy(np.asarray(extra_j))
    kw = dict(max_codebooks=k, temperature=0.0, top_k=0)
    jc = jt.make_cache(jcfg.backbone, 1, s_max, dtype=jnp.float32)
    fj, jc = jmodel.frame_step(jp, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(mask), jc,
                               jax.random.PRNGKey(0), extra_mask=extra_j, **kw)
    tc = tt.make_cache(tcfg.backbone, 1, s_max, dtype=torch.float32, device="cpu")
    ft, tc = tmodel.frame_step(tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(mask), tc,
                               extra_mask=extra_t, **kw)
    jkc, jvc, jpos = jmodel.cache_to_fused(jc)
    kc, vc, pos = tmodel.cache_to_fused(tc)
    assert tuple(kc.shape) == tuple(jkc.shape) and int(pos) == int(jpos) == pad
    close(kc, jkc)
    start_j, start_t = jnp.int32(pad - n), torch.tensor(pad - n)
    msk = np.concatenate([np.ones((1, 1, k), bool), np.zeros((1, 1, 1), bool)], -1)
    for i in range(3):
        tok_j = jnp.concatenate([fj, jnp.zeros((1, 1), jnp.int32)], -1)[:, None]
        fj, jkc, jvc = jmodel.frame_step_fused_bb(jp, jcfg, tok_j, jnp.asarray(msk), jkc, jvc,
                                                  jpos, start_j, jax.random.PRNGKey(i + 1), **kw)
        jpos = jpos + 1
        tok_t = torch.cat([ft, torch.zeros((1, 1), dtype=torch.int64)], -1)[:, None]
        ft, kc, vc = tmodel.frame_step_fused_bb(tp, tcfg, tok_t, torch.from_numpy(msk), kc, vc,
                                                pos, start_t, **kw)
        pos += 1
    assert int(pos) == pad + 3
    held_through_logits(logits_log, fj, ft)
    close(kc[:, :, : pad + 3], np.asarray(jkc[:, :, : pad + 3]))


def jax_engine(jp, jcfg, jm, max_frames, quality, mimi=MIMI):
    eng = JMarvisEngine.from_params(jp, jcfg, jm, jmimi.MimiConfig(**mimi),
                                    max_frames=max_frames)
    eng.quality, eng.temperature = quality, 0.0
    return eng


def port_engine(tp, tcfg, tm, max_frames, quality, mimi=MIMI):
    eng = MarvisEngine.from_params(tp, tcfg, tm, tmimi.MimiConfig(**mimi), max_frames=max_frames)
    eng.quality, eng.temperature = quality, 0.0
    return eng


TEXT = "This first sentence is long enough to stand on its own. And a second one."


@pytest.mark.parametrize("granularity", ["frame", "sentence"])
def test_engine_matches_jax(tiny, granularity):
    """Greedy: the same chunks and audio as the JAX engine; FRAME's chunks
    concatenated equal SENTENCE's whole-sentence decode."""
    jcfg, jp, tcfg, tp, jm, tm = tiny
    g = StreamingGranularity(granularity)
    eng = port_engine(tp, tcfg, tm, 9, "low")
    assert eng.n_codebooks == 4 and not eng._depth_fused
    got = list(eng.generate_streaming(TEXT, granularity=g))
    from tpu_audio.api.tts import StreamingGranularity as JG

    ref = list(jax_engine(jp, jcfg, jm, 9, "low").generate_streaming(TEXT, granularity=JG(
        granularity)))
    assert [(c.text, c.is_final) for c in got] == [(c.text, c.is_final) for c in ref]
    assert sum(c.is_final for c in got) == 1 and got[-1].is_final
    for c, r in zip(got, ref):
        close(c.samples, r.samples)
    if g == StreamingGranularity.FRAME:
        assert len(got) == 2 * (1 + 9 // 6)  # each sentence: one chunk of 6, then the rest
        other = list(eng.generate_streaming(TEXT, granularity=StreamingGranularity.SENTENCE))
        close(np.concatenate([c.samples for c in got]),
              np.concatenate([c.samples for c in other]))


def test_engine_fused_paths_match_jax(jax_marvis_fused):
    """At the whole-stack step's widths both stacks take it (the depth
    decoder and the backbone after the prefill): FRAME audio equal to the
    JAX engine's on its fused paths, greedy, at eight codebooks."""
    jcfg, jp, tcfg, tp = fused_params("fp", 5)
    mimi8 = {**MIMI, "n_q": 8}  # a codebook for each of the frame's
    jm = jmimi.init_params(jax.random.PRNGKey(0), jmimi.MimiConfig(**mimi8))
    tm = tmimi.params_from_numpy(jax.tree.map(np.asarray, jm), "cpu")
    eng = port_engine(tp, tcfg, tm, 7, "low", mimi=mimi8)
    ref = jax_engine(jp, jcfg, jm, 7, "low", mimi=mimi8)
    assert (eng._depth_fused, eng._bb_fused) == (ref._depth_fused, ref._bb_fused) == (True, True)
    got = np.concatenate([c.samples for c in eng.generate_streaming("Hello there.")])
    want = np.concatenate([c.samples for c in ref.generate_streaming("Hello there.")])
    assert got.shape == want.shape == (7 * tmimi.MimiConfig(**MIMI).hop,)
    close(got, want)


def test_quantize_w8a8_and_serve(tiny):
    """`_quantize("w8a8")`: the backbone and depth stacks to fused
    per-channel int8, as the JAX function builds them (codes equal but for
    rare one-step rounding, scales within 1e-6); the rest kept; then the
    engine serves it."""
    cfg_j, cfg_t = configs(FUSED)
    jp = jmodel.init_params(jax.random.PRNGKey(3), cfg_j)
    ref = pytree.flatten(jax.tree.map(np.asarray, JMarvisEngine._quantize(jp, "w8a8")))
    got = pytree.flatten(MarvisEngine._quantize(to_torch(jp), "w8a8"))
    assert sorted(got) == sorted(ref)
    assert any(k.endswith("attn.qkv.weight_i8") for k in got)
    for k, v in ref.items():
        g = got[k].numpy()
        if k.endswith("weight_i8"):
            assert np.abs(g.astype(int) - v).max() <= 1 and (g != v).mean() < 1e-3, k
        else:
            close(g, v, rel=1e-6)
    assert MarvisEngine._quantize(jp, None) is jp
    with pytest.raises(ValueError, match="w8a8"):
        MarvisEngine._quantize(jp, "q4")
    mimi8 = tmimi.MimiConfig(**{**MIMI, "n_q": 8})
    eng = MarvisEngine.from_params(to_torch(jp), cfg_t, tmimi.init_params(0, mimi8, device="cpu"),
                                   mimi8, max_frames=4, quantization="w8a8")
    assert eng._depth_fused and eng._bb_fused  # the int8 stacks take the step too
    res = eng.generate("Hello.")
    assert res.sample_rate == 24000 and np.isfinite(res.samples).all() and len(res.samples)


def marvis_flat(tree: dict) -> dict:
    """A port Marvis tree → a checkpoint's flat dict: both stacks in the HF
    Llama naming under backbone. / decoder., the rest as named."""
    flat = {}
    for side in ("backbone", "decoder"):
        flat.update(chip_smoke.llama_flat(tree[side], side + "."))
    flat.update({k: v for k, v in pytree.flatten(tree).items()
                 if not k.startswith(("backbone.", "decoder."))})
    return flat


def test_load_reads_a_written_checkpoint_and_refuses_6_bits(tiny, tmp_path, monkeypatch):
    tm = tiny[5]
    monkeypatch.setitem(tload._FLAVORS, "llama-250M", TINY["backbone"])
    monkeypatch.setitem(tload._FLAVORS, "llama-100M", TINY["decoder"])
    mimi_cfg = tmimi.MimiConfig(**MIMI)
    monkeypatch.setattr(tload, "MimiConfig", lambda: mimi_cfg)
    cfg = tmodel.MarvisConfig(backbone=tload.backbone_config_from_flavor("llama-250M"),
                              decoder=tload.backbone_config_from_flavor("llama-100M"),
                              text_vocab_size=300, audio_vocab_size=32, n_codebooks=4)
    params = tmodel.init_params(4, cfg, device="cpu")
    config = {"backbone_flavor": "llama-250M", "decoder_flavor": "llama-100M",
              "text_vocab_size": 300, "audio_vocab_size": 32, "audio_num_codebooks": 4}
    files = {"model.safetensors": lambda p: chip_smoke.write_safetensors(p, marvis_flat(params)),
             "config.json": chip_smoke.write_text(json.dumps(config))}
    chip_smoke.seed_cache(tmp_path, "Marvis-AI/marvis-tts-250m-v0.2-MLX-6bit", files)
    chip_smoke.seed_cache(tmp_path, tload.MIMI_REPO, {
        "tokenizer.safetensors": lambda p: chip_smoke.write_safetensors(
            p, chip_smoke.mimi_torch_flat(tm))})
    monkeypatch.setenv("TPU_AUDIO_CACHE", str(tmp_path))
    eng = TTS.marvis(device="cpu")
    eng.load()
    assert eng.cfg == cfg and eng.mimi_cfg == mimi_cfg and eng.params["backbone"]
    want = pytree.flatten(MarvisEngine._fuse(params))
    got = pytree.flatten(eng.params)
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(v, pytree.flatten(tm)[k])
               for k, v in pytree.flatten(eng.mimi_params).items())
    eng.max_frames = 3
    assert np.isfinite(eng.generate("Hi.").samples).all()
    # a 6-bit leaf (the MLX repos' format): refused with the bits named
    flat = marvis_flat(params)
    for i in range(cfg.backbone.n_layers):
        down = f"backbone.model.layers.{i}.mlp.down_proj."
        assert flat[down + "weight"].shape == (32, 64)
        flat[down + "weight"] = np.zeros((32, 12), np.uint32)  # 64 inputs at 6 bits
        flat[down + "scales"] = np.ones((32, 1), np.float32)
        flat[down + "biases"] = np.zeros((32, 1), np.float32)
    path = tmp_path / "q6"
    path.mkdir()
    chip_smoke.write_safetensors(path / "model.safetensors", flat)
    (path / "config.json").write_text(json.dumps(config))
    with pytest.raises(ValueError, match="6-bit"):
        tload.load(str(path), torch.float32, "cpu")
    q6 = dict(params, backbone=dict(params["backbone"], extra={"weight_q6": torch.zeros(1)}))
    with pytest.raises(ValueError, match="weight_q6"):
        MarvisEngine._quantize(q6, "w8a8")
    with pytest.raises(ValueError, match="6-bit"):
        MarvisEngine.from_params(q6, cfg, tm, mimi_cfg)


def test_unported_options_and_factory():
    assert MarvisEngine(kv_quantized=True).kv_quantized  # ROADMAP A9 is ported
    eng = TTS.marvis("max", device="cpu")
    assert isinstance(eng, MarvisEngine) and eng.quality == "max" and eng.device == "cpu"
    assert eng.n_codebooks == 32 and eng.frame_span == 6
    assert TTS.marvis().quality == "high"


def test_engine_with_every_default(tiny):
    """`from_params` and `generate` with their public defaults: quality high
    (24 codebooks, clipped to the model's 4), FRAME streaming, 64 frames,
    temperature 0.9, top-k 50."""
    _, _, tcfg, tp, _, tm = tiny
    eng = MarvisEngine.from_params(tp, tcfg, tm, tmimi.MimiConfig(**MIMI))
    assert (eng.max_frames, eng.quality, eng.n_codebooks) == (64, "high", 4)
    res = eng.generate("Hello there.")
    assert res.sample_rate == 24000 and np.isfinite(res.samples).all()
    hop = tmimi.MimiConfig(**MIMI).hop
    assert len(res.samples) % hop == 0 and len(res.samples) <= 64 * hop


def test_new_modules_import_without_jax_nvcc_or_cuda():
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from tpu_audio_torch.codecs.dac import load, model\n"
        "from tpu_audio_torch.codecs.mimi import model, streaming\n"
        "from tpu_audio_torch.models.outetts import engine, features, tokens\n"
        "from tpu_audio_torch.models.marvis import engine, load, model\n"
        "from tpu_audio_torch.utils import constants\n"
        "from tpu_audio_torch.ops.kernels import _build\n"
        "assert _build._lib is None\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'tpu_audio']\n"
        "print('ok')\n")
    env = {**os.environ, "PATH": "/nonexistent", "CUDA_HOME": "/nonexistent",
           "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
