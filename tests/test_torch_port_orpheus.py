"""PyTorch port, Orpheus against the JAX package on the CPU: the stack's
teacher-forced logits and `CausalLMGenerator` (single, spanned, streamed,
batched, bucketed) on the W4A8, super-group, int8 and bf16 trees, the
frame parsing, SNAC, and the engine.

The JAX side runs its W4A8 kernels in interpret mode (`jax_w4a8`), its
whole-stack step (`jax_fused`) and its W8A8 matmuls (`jax_kernels`), so
the port's plain versions are held against the Pallas kernels end to end.
Tiny configs: a Llama with llama3 RoPE scaling at dim 256, 2 layers, 4
heads over 2 of hd 64, hidden 512, so that every stacked output width is a
multiple of the JAX stacked kernels' 256-row block; vocabulary 640.
Tolerances: logits 1e-2 of max|ref| at f32 activations: the two sides
sum in other orders (1e-7), an int8 activation code can then round the
other way, and at dim 256 one such code moves the logits by ~1e-3 of their
max (a 1e-7 relative perturbation of the input embedding moved the port's
own W4A8 logits by 2.6e-3); the fp stack agrees to 3.5e-7. Tokens exact,
with the margin of every step asserted above the two packages'
differences. SNAC 1e-4 of max|ref| in f32 with the same injected noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_int8 import jax_kernels  # noqa: F401
from tests.test_torch_port_llm import jax_fused  # noqa: F401
from tests.test_torch_port_w4a8 import jax_w4a8  # noqa: F401
from tpu_audio.codecs import snac as jsnac
from tpu_audio.models.orpheus import model as jm
from tpu_audio.nn import layers as jlayers
from tpu_audio.nn import transformer as jt
from tpu_audio.ops import quant as jquant
from tpu_audio.ops.sampling import SamplerConfig as JSampler
from tpu_audio_torch.api.errors import ModelLoadError
from tpu_audio_torch.api.tts import TTS, StreamingGranularity
from tpu_audio_torch.codecs.snac import model as tsnac
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.orpheus import model as tm
from tpu_audio_torch.models.orpheus.engine import OrpheusEngine
from tpu_audio_torch.nn import layers as tlayers
from tpu_audio_torch.nn import transformer as tt
from tpu_audio_torch.ops import sampling
from tpu_audio_torch.ops.sampling import SamplerConfig
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

LLM = dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64, hidden_dim=512,
           vocab_size=640, rope_theta=500000.0, rope_scaling=dict(jm.LLAMA_3B.rope_scaling),
           norm_eps=1e-5)
SNAC = dict(decoder_dim=64, decoder_rates=(4, 4, 2, 2), latent_dim=32, codebook_size=64,
            codebook_dim=4, vq_strides=(4, 2, 1))
# the engine's LM: the Orpheus vocabulary, so that prompts and codes are ids
ENGINE_LM = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128,
                 vocab_size=jm.CODE_OFFSET + 7 * jm.CODEBOOK_SIZE, tie_word_embeddings=True)
# greedy with a strong repetition penalty: a random tiny stack with a tied
# head repeats the last prompt token forever, which would hide a wrong step
PENALTY = dict(repetition_penalty=50.0, repetition_window=20)
GREEDY = dict(eos_ids=(1,), max_new=10)
PROMPT = [5, 77, 300, 12, 9, 613, 41]


def close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, err


def to_torch(tree, dtype=torch.float32):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu", dtype=dtype)


def configs(**over):
    kw = {**LLM, **over}
    return jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)


@pytest.fixture(scope="module")
def jbase():
    """f32 JAX params (tied and untied) with unit-scale embeddings: the
    prompt, not the init's 0.02, drives the stack."""
    out = {}
    for tied in (True, False):
        p = jt.init_params(jax.random.PRNGKey(11), configs(tie_word_embeddings=tied)[0])
        rng = np.random.default_rng(1)
        p["embed"]["weight"] = jnp.asarray(
            rng.standard_normal((LLM["vocab_size"], LLM["dim"])).astype(np.float32))
        out[tied] = p
    return out


def trees(jbase, kind: str):
    """(JAX tree, port tree, tied) of one kind: "w4a8" (the q4 tree, the
    embedding included, repacked), "sg" (super-group, untied head, f32
    embedding), "int8" (the q4 tree requantised, fused), "bf16"."""
    if kind == "sg":
        q4 = jquant.quantize_tree(jbase[False], bits=4,
                                  predicate=lambda k, v: not k.startswith("embed"))
        jp = jquant.requantize_tree_w4a8_sg(q4)
        return jp, to_torch(jp), False
    jp = jbase[True]
    if kind == "bf16":
        jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jt.fuse_fp_tree(jp))
        return jb, to_torch(jb, torch.bfloat16), True
    q4 = jquant.quantize_tree(jp, bits=4)
    jp = jquant.repack_tree_w4a8(q4) if kind == "w4a8" else jquant.requantize_tree_int8(q4)
    return jp, to_torch(jp), True


def path_logits(jp, tp, tied: bool, tokens: list[int]):
    """Teacher-forced logits along a greedy decode: PROMPT left-padded to
    the generators' bucket of 32 (pos_offset), the single-stream cache each
    package's generator takes (the whole-stack step where it serves, the
    bf16 cache), then one-token steps on tokens[:-1]: (JAX, port) f32
    (len(tokens), V), row i the logits that chose tokens[i]."""
    jcfg, tcfg = configs(tie_word_embeddings=tied)
    pad = 32 - len(PROMPT)
    ids = [0] * pad + PROMPT
    jc, jx = jt.decode_cache_and_mask(jcfg, 64, pad, jt.fused_decode_supported(jcfg, jp, 64))
    tc, tx = tt.decode_cache_and_mask(tcfg, 64, pad, tt.fused_decode_supported(tcfg, tp),
                                      device="cpu")
    joff, toff = jnp.asarray([pad]), torch.tensor([pad])
    jl, jc = jt.forward(jp, jcfg, jnp.asarray([ids]), jc, jx, pos_offset=joff)
    tl, tc = tt.forward(tp, tcfg, torch.tensor([ids]), tc, tx, pos_offset=toff)
    jout, tout = [np.asarray(jl[0, -1], np.float32)], [tl[0, -1].float()]
    for t in tokens[:-1]:
        jl, jc = jt.forward(jp, jcfg, jnp.asarray([[t]]), jc, jx, pos_offset=joff)
        tl, tc = tt.forward(tp, tcfg, torch.tensor([[t]]), tc, tx, pos_offset=toff)
        jout.append(np.asarray(jl[0, -1], np.float32))
        tout.append(tl[0, -1].float())
    return np.stack(jout), torch.stack(tout).numpy()


def penalised(logits: np.ndarray, tokens: list[int]) -> np.ndarray:
    """Each row as the sampler sees it: row 0 (the prefill's) as it is,
    row i penalised over the tokens before it (the ring holds the first)."""
    out = [logits[0]]
    recent = torch.full((1, PENALTY["repetition_window"]), -1)
    for i in range(1, len(tokens)):
        recent = sampling.update_recent(recent, torch.tensor([tokens[i - 1]]))
        out.append(sampling.apply_repetition_penalty(
            torch.from_numpy(logits[i][None]), recent, PENALTY["repetition_penalty"])[0].numpy())
    return np.stack(out)


@pytest.mark.parametrize("kind", ["w4a8", "sg", "int8", "bf16"])
def test_generate_matches_with_margins(jbase, jax_w4a8, jax_fused, jax_kernels, kind):
    """Greedy `generate` against the JAX generator, exact; then, at f32
    activations, both packages' logits along that decode: within 1e-2 of
    max|ref|, and at every step no other token closer to the chosen one
    than the two packages' differences at both, so equal tokens are no
    luck."""
    jp, tp, tied = trees(jbase, kind)
    jcfg, tcfg = configs(tie_word_embeddings=tied)
    ref = jm.CausalLMGenerator(jp, jcfg, max_cache=64).generate(
        PROMPT, sampler=JSampler(temperature=0.0, **PENALTY), **GREEDY)
    gen = tm.CausalLMGenerator(tp, tcfg, max_cache=64)
    assert gen._fused_ok() == (kind in ("int8", "bf16"))
    got = gen.generate(PROMPT, sampler=SamplerConfig(temperature=0.0, **PENALTY), **GREEDY)
    assert len(set(got)) == len(got) == GREEDY["max_new"]  # the penalty: no token twice
    assert got == ref
    if kind == "bf16":  # bf16 logits tie often; the tokens are the check
        return
    jl, tl = path_logits(jp, tp, tied, ref)
    close(tl, jl, rel=1e-2)
    jl, tl = penalised(jl, ref), penalised(tl, ref)
    np.testing.assert_array_equal(jl.argmax(-1), ref)
    # no other token b can overtake the chosen a: jl[a] - jl[b] > |Δa| + |Δb|
    dev = np.abs(jl - tl)
    a = np.asarray(ref)[:, None]
    gap = np.take_along_axis(jl, a, 1) - jl
    need = np.take_along_axis(dev, a, 1) + dev
    np.put_along_axis(gap, a, np.inf, 1)
    assert (gap > need).all(), np.argwhere(gap <= need)


@pytest.mark.parametrize("kind", ["w4a8", "sg"])
def test_spans_batches_and_buckets(jbase, kind):
    """On the W4A8 trees: the spanned decode and `stream_spans` equal the
    single loop; a smaller bucket gives the same tokens and bit-equal
    logits (pos_offset); `generate_batch` rows equal their single decodes."""
    _, tp, tied = trees(jbase, kind)
    gen = tm.CausalLMGenerator(tp, configs(tie_word_embeddings=tied)[1], max_cache=64)
    kw = dict(sampler=SamplerConfig(temperature=0.0, **PENALTY), **GREEDY)
    ref = gen.generate(PROMPT, **kw)
    for span in (4, 5):
        assert gen.generate(PROMPT, should_stop=lambda: False, span=span, **kw) == ref
    assert sum(gen.stream_spans(PROMPT, span=4, **kw), []) == ref
    assert gen.generate(PROMPT, bucket=8, **kw) == ref
    lg = []
    for bucket in (8, 32):
        prompt, start = gen._prompt(PROMPT, bucket)
        c, x = tt.decode_cache_and_mask(gen.cfg, 64, start, False, device="cpu")
        out, _ = tt.forward(gen.params, gen.cfg, prompt[None], c, x,
                            pos_offset=torch.tensor([start]))
        lg.append(out[0, -1])
    assert torch.equal(lg[0], lg[1])
    prompts = [PROMPT, [600, 3, 3, 8], list(range(20, 45))]
    batch = gen.generate_batch(prompts, **kw)
    assert batch == [gen.generate(p, **kw) for p in prompts]


def test_sampled_stream_equals_generate(jbase):
    """At temperature 0.6 / top-p 0.8 with a repetition penalty: one
    generator draws in the same order for `stream_spans` and `generate`."""
    _, tp, tied = trees(jbase, "w4a8")
    gen = tm.CausalLMGenerator(tp, configs(tie_word_embeddings=tied)[1], max_cache=None)
    sampler = SamplerConfig(temperature=0.6, top_p=0.8, **PENALTY)
    kw = dict(sampler=sampler, eos_ids=(1,), max_new=12, seed=3)
    ref = gen.generate(PROMPT, **kw)
    assert sum(gen.stream_spans(PROMPT, span=5, **kw), []) == ref
    assert ref != gen.generate(PROMPT, **{**kw, "seed": 4})
    assert len(set(ref)) > 2


def test_frames_prompts_and_unported_paths(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    toks = [jm.AUDIO_MARKER] + [int(t) for t in rng.integers(jm.CODE_OFFSET, jm.CODE_OFFSET
                                                             + 7 * jm.CODEBOOK_SIZE, 40)]
    toks += [jm.END_TOKEN, jm.CODE_OFFSET + 5]
    for got, ref in zip(tm.parse_frames(toks), jm.parse_frames(toks)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    assert tm.build_prompt_ids([1, 2]) == jm.build_prompt_ids([1, 2])
    assert tm.LLAMA_3B == tt.TransformerConfig(**{
        k: getattr(jm.LLAMA_3B, k) for k in tt.TransformerConfig.__dataclass_fields__})
    cfg = configs()[1]
    params = tt.init_params(0, cfg, device="cpu")
    with pytest.raises(TypeError, match="mesh must be a torch DeviceMesh.*got object"):
        tm.CausalLMGenerator(params, cfg, mesh=object())  # mesh= is served (A19): a mesh only
    # speculative decoding is ported (ROADMAP A9): the options are taken
    draft = tm.DraftModel(params, cfg)
    assert TTS.orpheus(speculative=draft).speculative is draft
    assert TTS.orpheus(speculative="ngram", gamma=3).gamma == 3
    with pytest.raises(ValueError, match="speculative"):
        TTS.orpheus(speculative="draft")
    monkeypatch.setenv("TPU_AUDIO_CACHE", str(tmp_path / "empty"))
    with pytest.raises(ModelLoadError, match="orpheus-3b-0.1-ft-4bit"):
        TTS.orpheus().load()
    with pytest.raises(TypeError, match="mesh must be a torch DeviceMesh.*got object"):
        TTS.orpheus(mesh=object())
    assert isinstance(TTS.orpheus(), OrpheusEngine)


@pytest.fixture(scope="module")
def snac_pair():
    cfg = jsnac.SNACConfig(**SNAC)
    jp = jsnac.init_params(jax.random.PRNGKey(3), cfg)
    return cfg, jp, to_torch(jp)


def test_snac_decode_matches_with_injected_noise(snac_pair):
    cfg, jp, tp = snac_pair
    tcfg = tsnac.SNACConfig(**SNAC)
    rng = np.random.default_rng(2)
    frames = 16
    codes = [rng.integers(0, 64, (2, frames // s)) for s in cfg.vq_strides]
    z_ref = jsnac.model.embed_codes(jp, cfg, [jnp.asarray(c) for c in codes])
    z = tsnac.embed_codes(tp, tcfg, [torch.from_numpy(c) for c in codes])
    close(z, z_ref)
    t, noises = frames, []
    for stride in cfg.decoder_rates:
        t *= stride
        noises.append(rng.standard_normal((2, t, 1)).astype(np.float32))
    ref = jsnac.model.decode_latent(jp, cfg, z_ref, noises=noises)
    got = tsnac.decode_latent(tp, tcfg, torch.from_numpy(np.asarray(z_ref)), noises=noises)
    assert tuple(got.shape) == (2, frames * cfg.hop)
    close(got, ref, rel=1e-4)


def test_snac_layers_match(rng):
    """conv1d with dilation, the transposed conv and the weight-normalised
    conv against the JAX layers, through the conversion's layouts."""
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((5, 6, 4)).astype(np.float32)
    v = rng.standard_normal((4, 6, 3)).astype(np.float32)
    jtree = {"conv1": {"weight": w}, "convT": {"weight_v": v, "weight_g": np.abs(v).sum(
        axis=(0, 2), keepdims=True), "bias": np.ones(3, np.float32)},
        "lin": {"weight_v": w, "weight_g": np.abs(w).sum(axis=(0, 1), keepdims=True)}}
    tp = to_torch(jtree)
    xt = torch.from_numpy(x)
    close(tlayers.conv1d(tp["conv1"], xt, padding=6, dilation=3),
          jlayers.conv1d({"weight": jnp.asarray(w)}, jnp.asarray(x), padding=6, dilation=3))
    close(tlayers.weight_norm_conv1d(tp["lin"], xt, padding=2),
          jlayers.weight_norm_conv1d(jax.tree.map(jnp.asarray, jtree["lin"]), jnp.asarray(x),
                                     padding=2))
    jw = jax.tree.map(jnp.asarray, jtree["convT"])
    close(tsnac._conv_transpose(tp["convT"], xt, stride=2, padding=1),
          jsnac.model._wn_transpose(jw, jnp.asarray(x), stride=2, padding=1))


def test_position_noise_is_window_invariant(snac_pair):
    _, _, tp = snac_pair
    tcfg = tsnac.SNACConfig(**SNAC)
    rng = np.random.default_rng(7)
    frames = 16
    codes = [torch.from_numpy(rng.integers(0, 64, (1, frames // s))) for s in (4, 2, 1)]
    full = tsnac.decode_codes(tp, tcfg, codes, seed=7)[0].numpy()
    off = 8
    win = tsnac.decode_codes(tp, tcfg, [c[:, off // s:] for c, s in zip(codes, (4, 2, 1))],
                             seed=7, noise_pos=off)[0].numpy()
    rf = 12 * tcfg.hop
    np.testing.assert_allclose(win[rf:], full[off * tcfg.hop + rf:], atol=1e-5)
    z = tsnac.position_noise(7, 2, 1000, 50_000)
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1) < 0.02
    np.testing.assert_array_equal(tsnac.position_noise(7, 2, 1010, 10)[0, :, 0],
                                  z[0, 10:20, 0])
    assert not torch.equal(tsnac.position_noise(8, 2, 1000, 10), z[:, :10])


@pytest.fixture(scope="module")
def engine_parts():
    lm_cfg = tt.TransformerConfig(**ENGINE_LM)
    return (tt.init_params(2, lm_cfg, device="cpu"), lm_cfg,
            tsnac.init_params(3, tsnac.SNACConfig(**SNAC), device="cpu"))


def _frame_tokens(rng, frames: int) -> list[int]:
    toks = []
    for _ in range(frames):
        toks.extend(jm.CODE_OFFSET + page * jm.CODEBOOK_SIZE + int(v)
                    for page, v in enumerate(rng.integers(0, 64, 7)))
    return toks


@pytest.mark.parametrize("frames", [23, 40])
def test_token_streaming_equals_one_shot(engine_parts, frames):
    """TOKEN streaming over given spans: the chunks concatenate to the
    one-shot decode of the same tokens, the last chunk alone final, and
    audio comes before the LM ends."""
    lp, cfg, sp = engine_parts
    eng = OrpheusEngine.from_params(lp, cfg, sp, tsnac.SNACConfig(**SNAC))
    toks = _frame_tokens(np.random.default_rng(frames), frames)

    def fake_spans(*a, **k):
        span = k.get("span", 28)
        for i in range(0, len(toks), span):
            yield toks[i: i + span]

    eng.lm.stream_spans = fake_spans
    chunks = list(eng.generate_streaming("Hello there.", granularity=StreamingGranularity.TOKEN))
    assert chunks[-1].is_final and sum(c.is_final for c in chunks) == 1
    assert len(chunks) >= 3
    got = np.concatenate([c.samples for c in chunks])
    ref = eng._decode_snac(tm.parse_frames(toks), seed=0)
    assert got.shape == ref.shape == (frames * 4 * eng.snac_cfg.hop,)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_engine_batch_and_sentence_streaming(engine_parts):
    lp, cfg, sp = engine_parts
    eng = OrpheusEngine.from_params(lp, cfg, sp, tsnac.SNACConfig(**SNAC))
    results = eng.generate_batch(["One.", "Two two."], max_new_tokens=28, seed=1)
    assert len(results) == 2 and not eng.is_generating and eng.generation_time > 0
    for r in results:
        assert r.sample_rate == 24000 and np.isfinite(r.samples).all()
    text = "This first sentence is long enough to stand on its own. And a second one."
    chunks = list(eng.generate_streaming(text, granularity=StreamingGranularity.SENTENCE,
                                         max_new_tokens=16))
    assert [c.is_final for c in chunks] == [False, True]


def test_engine_with_every_default(engine_parts):
    """`from_params` and `generate` with their public defaults (full SNAC,
    1200 new tokens, token streaming): the cache is sized per request."""
    lp, cfg, _ = engine_parts
    eng = OrpheusEngine.from_params(lp, cfg, tsnac.init_params(4, tsnac.SNACConfig(),
                                                               device="cpu"))
    assert eng.lm.max_cache is None and eng.snac_cfg == tsnac.SNACConfig()
    result = eng.generate("Hello there.")
    assert result.sample_rate == 24000 and np.isfinite(result.samples).all()
    assert len(result.samples) % 2048 == 0


def test_slice_modules_import_without_jax_nvcc_or_cuda():
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from tpu_audio_torch.api import tts\n"
        "from tpu_audio_torch.codecs.snac import model\n"
        "from tpu_audio_torch.models.orpheus import engine, model\n"
        "from tpu_audio_torch.ops.kernels import _build, w4a8_matmul\n"
        "from tpu_audio_torch.utils import text\n"
        "assert _build._lib is None\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'tpu_audio']\n"
        "print('ok')\n")
    env = {**os.environ, "PATH": "/nonexistent", "CUDA_HOME": "/nonexistent",
           "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
