"""PyTorch port, tensor-parallel serving (`parallel/tp_quant.py`,
`transformer.forward_hidden(axis_name=)`, the `mesh=` of
`CausalLMGenerator`, `OrpheusEngine`, `CosyLMGenerator`, the CosyVoice2
engine and CosyVoice3's `from_params`) at tp = 2 against the JAX package
under `make_mesh(dp=4, tp=2)` on the same trees, on the CPU.

One module-scoped spawn of 2 gloo ranks (a `FileStore` under tmp_path)
serves, on the trees this process writes for it: the Orpheus generator's
tiny Llama (tests/test_torch_port_orpheus.py's, dim 256, 4 heads over 2 of
hd 64, hidden 512) on fp, int8 fused and unfused, W4A8, q4 and, at dim
512 (hd 128, hidden 1024, so that a rank's o-projection K is one whole
super-group), the super-group tree: greedy `generate` under a strong
repetition penalty, the teacher-forced logits along it, `generate_batch`,
`stream_spans` and a spanned `generate` cancelled after two spans,
`generate_speculative` with a replicated draft, a sampled `generate`; the
Orpheus engine; CosyVoice2's LM on the JAX draws, its engine's `token2wav`
and CosyVoice3's engine stream on the JAX draws. Each rank writes what it
got; the tests hold the ranks against each other and against JAX.

Which rounding each side takes on the CPU: the JAX int8 and W4A8 matmuls
take the exact dequantised product off the TPU (no activation codes),
under `shard_map` as on one device; the port's plain versions of
`int8_matmul` and the W4A8 kernels quantise each row of x, and a
row-parallel rank quantises its own K slice with its own scale. So the
tokens are held equal, and the port's logits at tp = 2 within 1e-2 of
max|ref| of the JAX unsharded logits (fp: 1e-5), with every greedy step's
margin above the difference of the two, as tests/test_torch_port_orpheus.py
holds the unsharded port. Waveforms: rel 2e-3 (HiFT_REL), the engines'
Orpheus audio at tp = 2 equal to the unsharded port's. The layout rules
(`local_config`, the fused-row permutation, the per-key shards) against
the JAX module bit for bit, without a spawn.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.test_torch_port_orpheus import ENGINE_LM, LLM, PENALTY, PROMPT, SNAC
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401
from tpu_audio.models.orpheus import model as jm
from tpu_audio.nn import transformer as jt
from tpu_audio.ops import quant as jquant
from tpu_audio.ops.sampling import SamplerConfig as JSampler
from tpu_audio.parallel import make_mesh as jmesh
from tpu_audio.parallel import tp_quant as jtpq
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.nn import transformer as tt
from tpu_audio_torch.parallel import tp_quant

WORLD = 2
LOGIT_REL = {"fp": 1e-5}  # the others 1e-2 (the module docstring)
SG_LLM = {**LLM, "dim": 512, "n_heads": 4, "n_kv_heads": 2, "head_dim": 128, "hidden_dim": 1024}
DRAFT = dict(dim=128, n_layers=1, n_heads=2, n_kv_heads=1, head_dim=64, hidden_dim=256,
             vocab_size=LLM["vocab_size"], tie_word_embeddings=True)
GREEDY = dict(eos_ids=(1,), max_new=10)
PROMPTS = [PROMPT, [600, 3, 3, 8], list(range(20, 45))]
CV2_SEED, CV2_NEW = 4, 40


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def orpheus_trees() -> dict:
    """{kind: (JAX tree, numpy tree, cfg kwargs)}: the unit-scale-embedding
    Llama of tests/test_torch_port_orpheus.py (tied), its q4 tree and its
    serving formats; "sg" at SG_LLM's widths (untied, the embedding f32)."""
    out = {}
    for width in (LLM, SG_LLM):
        tied = width is LLM
        kw = {**width, "tie_word_embeddings": tied}
        p = jt.init_params(jax.random.PRNGKey(11), jt.TransformerConfig(**kw))
        p["embed"]["weight"] = jnp.asarray(np.random.default_rng(1).standard_normal(
            (width["vocab_size"], width["dim"])).astype(np.float32))
        if not tied:
            q4 = jquant.quantize_tree(p, bits=4, predicate=lambda k, v: not k.startswith("embed"))
            kinds = {"sg": jquant.requantize_tree_w4a8_sg(q4)}
        else:
            q4 = jquant.quantize_tree(p, bits=4)
            kinds = {"fp": p, "int8": jquant.requantize_tree_int8(q4),
                     "int8u": jquant.requantize_tree_int8(q4, fuse=False),
                     "w4a8": jquant.repack_tree_w4a8(q4), "q4": q4}
        out.update({k: (v, _np(v), kw) for k, v in kinds.items()})
    return out


def _greedy(**kw):
    from tpu_audio_torch.ops.sampling import SamplerConfig
    return SamplerConfig(temperature=0.0, **PENALTY, **kw)


def _teacher_forced(gen, tokens):
    """The rank's f32 logits along `tokens` (prefill of PROMPT in the
    generator's bucket of 32, then one-token steps), row i choosing
    tokens[i]."""
    prompt, start = gen._prompt(PROMPT, 32)
    cache, extra = tt.decode_cache_and_mask(gen.cfg_run, 64, start, False, dtype=torch.float32,
                                            device="cpu")
    off = torch.tensor([start])
    lg, cache = gen._forward(prompt[None], cache, extra, off)
    out = [lg[0, -1].float()]
    for tok in tokens[:-1]:
        lg, cache = gen._forward(torch.tensor([[tok]]), cache, extra, off)
        out.append(lg[0, -1].float())
    return torch.stack(out).numpy()


def _orpheus(res: dict, parts: dict, mesh) -> None:
    from tpu_audio_torch.models.orpheus import model as tm
    from tpu_audio_torch.ops.sampling import SamplerConfig

    for kind, (tree, kw) in parts["orpheus"].items():
        cfg = tt.TransformerConfig(**kw)
        gen = tm.CausalLMGenerator(params_from_numpy(tree, "cpu"), cfg, max_cache=64,
                                   cache_dtype=torch.float32, mesh=mesh)
        toks = gen.generate(PROMPT, sampler=_greedy(), **GREEDY)
        res["generate", kind] = toks
        res["logits", kind] = _teacher_forced(gen, toks)
        attn = gen.params["layers"]["attn"]
        res["local", kind] = {k: tuple(next(t for n, t in v.items() if n.startswith("weight"))
                                       .shape) for k, v in attn.items()}
        res["contiguous", kind] = all(t.is_contiguous() for t in _leaves(gen.params["layers"]))
        if kind != "int8":
            continue
        res["batch"] = gen.generate_batch(PROMPTS, sampler=_greedy(), **GREEDY)
        calls = []
        res["cancelled"] = gen.generate(PROMPT, sampler=_greedy(), should_stop=lambda: len(
            calls.append(1) or calls) > 2, span=3, **GREEDY)
        res["stream"] = list(gen.stream_spans(PROMPT, sampler=_greedy(), span=4, **GREEDY))
        draft = tm.DraftModel(params_from_numpy(parts["draft"], "cpu"),
                              tt.TransformerConfig(**DRAFT))
        res["speculative"] = gen.generate_speculative(PROMPT, sampler=_greedy(), gamma=3,
                                                      draft=draft, **GREEDY)
        res["draft replicated"] = draft.params["layers"]["attn"]["qkv"]["weight"].shape
        res["sampled"] = gen.generate(PROMPT, sampler=SamplerConfig(
            temperature=1.0, top_p=0.95, **PENALTY), eos_ids=(1,), max_new=16, seed=3)


def _recorded(stream_spans, out: list):
    """stream_spans that appends each call's tokens, as one list, to out."""
    def wrapped(*a, **k):
        out.append([])
        for span in stream_spans(*a, **k):
            out[-1].extend(span)
            yield span
    return wrapped


def _leaves(d):
    for v in d.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def _engines(res: dict, parts: dict, mesh) -> None:
    """The Orpheus engine, CosyVoice2's LM and token2wav, CosyVoice3's
    stream, at tp = 2 on the JAX draws."""
    jax.config.update("jax_platforms", "cpu")
    from tests.test_torch_port_cosyvoice2 import generate_draws
    from tests.test_torch_port_cosyvoice3 import jax_noises as cv3_noises
    from tests.test_torch_port_s3 import JaxNoise
    from tpu_audio_torch.codecs.snac import model as tsnac
    from tpu_audio_torch.models.cosyvoice2 import engine as cv2e
    from tpu_audio_torch.models.cosyvoice2 import lm as tlm
    from tpu_audio_torch.models.cosyvoice3 import engine as cv3e
    from tpu_audio_torch.models.orpheus.engine import OrpheusEngine

    lp, sp = parts["engine"]
    eng = OrpheusEngine.from_params(lp, tt.TransformerConfig(**ENGINE_LM), sp,
                                    tsnac.SNACConfig(**SNAC), mesh=mesh)
    eng.temperature = 0.0
    toks = []
    eng.lm.stream_spans = _recorded(eng.lm.stream_spans, toks)
    res["orpheus audio"] = eng.generate("Hello there.", max_new_tokens=48).samples
    res["orpheus tokens"] = toks

    lm_tree, lm_cfg = parts["cv2 lm"]
    gen = tlm.CosyLMGenerator(lm_tree, lm_cfg, cache_dtype=torch.float32, mesh=mesh)
    res["cv2 lm local"] = tuple(gen.params["llm"]["layers"]["attn"]["qkv"]["weight"].shape)
    res["cv2 lm"] = gen.generate(*parts["cv2 text"], seed=CV2_SEED, max_new=CV2_NEW,
                                 noise=generate_draws(CV2_SEED, 2 * CV2_NEW))

    def jax_noises(seed):
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        return JaxNoise(k1), JaxNoise(k2)
    cv2 = cv2e.CosyVoice2Engine.from_params(*parts["cv2 engine"], mesh=mesh)
    cv2.noises = jax_noises
    spk = cv2.prepare_conditionals(parts["ref audio"], 22050, ref_text="Hello there")
    res["cv2 wav"] = cv2.token2wav(parts["tokens"], spk, 2)
    w1 = cv2.s3gen_params["flow"]["encoder"]["encoders"]["0"]["feed_forward"]["w_1"]["weight"]
    res["cv2 flow local"] = (tuple(w1.shape), cv2.s3gen_cfg.conformer.heads)

    cv3 = cv3e.CosyVoice3Engine.from_params(*parts["cv3 engine"], mesh=mesh)
    cv3.noises = cv3_noises
    streams = parts["cv3 streams"]
    cv3.streamer.stream = lambda text_ids, *a, seed=0, **k: iter(streams[(tuple(text_ids), seed)])
    res["cv3 chunks"] = [(c.text, c.is_final, c.samples) for c in cv3.generate_streaming(
        parts["cv3 text"])]
    to_q = cv3.flow_params["decoder_estimator"]["blocks"]["0"]["attn"]["to_q"]
    res["cv3 dit local"] = (tuple(to_q["weight"].shape), to_q.rank, cv3.flow_cfg.dit.heads)


def _rank(rank: int, store: str, parts_path: str, out: str) -> None:
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD)
    try:
        from tpu_audio_torch.parallel import make_mesh

        parts = torch.load(parts_path, weights_only=False)
        mesh = make_mesh(tp=WORLD)
        res: dict = {}
        with torch.inference_mode():
            _orpheus(res, parts, mesh)
        _engines(res, parts, mesh)
        torch.save(res, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def trees():
    return orpheus_trees()


@pytest.fixture(scope="module")
def cv_parts():
    """(JAX parts, port parts) of the CosyVoice tests' engines and LM."""
    from tests.test_torch_port_cosyvoice2 import PROMPT_SPEECH, PROMPT_TEXT, TEXT, lm_configs
    from tests.test_torch_port_cosyvoice2_engine import engine_parts as cv2_parts
    from tests.test_torch_port_cosyvoice3 import engine_parts as cv3_parts
    from tests.test_torch_port_cosyvoice3 import flow_parts
    from tests.test_torch_port_s3 import gen_parts
    from tpu_audio.models.cosyvoice2 import lm as jlm
    from tpu_audio_torch.models.cosyvoice2 import lm as tlm

    jcfg, tcfg = lm_configs()
    np_lm = tlm.numpy_params(np.random.default_rng(0), tcfg)
    rng = np.random.default_rng(1)
    for name in ("speech_embedding", "llm_embedding"):
        np_lm[name]["weight"] = rng.standard_normal(np_lm[name]["weight"].shape
                                                    ).astype(np.float32)
    np_lm["llm"]["embed"]["weight"] = rng.standard_normal(
        np_lm["llm"]["embed"]["weight"].shape).astype(np.float32)
    n = tcfg.speech_token_size
    np_lm["llm_decoder"]["weight"] *= 8
    np_lm["llm_decoder"]["weight"][n:] *= 0.1
    np_lm["llm_decoder"]["bias"][n:] -= 2.0
    del jlm
    cv2 = cv2_parts.__wrapped__(gen_parts.__wrapped__())
    cv3 = cv3_parts.__wrapped__(flow_parts.__wrapped__())
    return {"lm": (jax.tree.map(jnp.asarray, np_lm), jcfg, params_from_numpy(np_lm, "cpu"), tcfg),
            "text": (TEXT, PROMPT_TEXT, PROMPT_SPEECH), "cv2": cv2, "cv3": cv3}


CV3_TEXT = "This first sentence is long enough to stand on its own. And a second one."


@pytest.fixture(scope="module")
def gloo(tmp_path_factory, trees, cv_parts):
    from tpu_audio_torch.codecs.snac import model as tsnac
    from tpu_audio_torch.models.cosyvoice3 import engine as cv3e

    d = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(14)
    jparts3, tparts3 = cv_parts["cv3"]
    tok = cv3e.CosyVoice3Engine.from_params(*tparts3).tokenizer
    streams = {}
    from tpu_audio_torch.utils import text as textutils
    for si, sentence in enumerate(textutils.split_into_sentences(CV3_TEXT)):
        ids = tok.encode(sentence)
        streams[(tuple(ids), si)] = [rng.integers(3, 60, 8).tolist() for _ in range(3)]
    _, lcfg, lm_tree, tcfg = cv_parts["lm"]
    draft = jt.init_params(jax.random.PRNGKey(5), jt.TransformerConfig(**DRAFT))
    parts = {
        "orpheus": {k: (npt, kw) for k, (_, npt, kw) in trees.items()},
        "draft": _np(draft),
        "engine": (tt.init_params(2, tt.TransformerConfig(**ENGINE_LM), device="cpu"),
                   tsnac.init_params(3, tsnac.SNACConfig(**SNAC), device="cpu")),
        "cv2 lm": (lm_tree, tcfg), "cv2 text": cv_parts["text"],
        "cv2 engine": cv_parts["cv2"][1],
        "ref audio": (0.1 * np.random.default_rng(8).standard_normal(33075)).astype(np.float32),
        "tokens": np.random.default_rng(9).integers(0, 64, 31).tolist(),
        "cv3 engine": tparts3, "cv3 streams": streams, "cv3 text": CV3_TEXT,
    }
    torch.save(parts, d / "parts")
    torch.multiprocessing.spawn(_rank, args=(str(d / "store"), str(d / "parts"), str(d / "out")),
                                nprocs=WORLD)
    return parts, [torch.load(d / f"out.{r}", weights_only=False) for r in range(WORLD)]


def jax_mesh():
    return jmesh(dp=4, tp=2)


# ------------------------------------------------------------------ layout rules

@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_local_config_and_permutation_equal_jax(tp):
    from tpu_audio_torch.models.orpheus.model import LLAMA_3B

    got = tp_quant.local_config(LLAMA_3B, tp)
    ref = jtpq.local_config(jm.LLAMA_3B, tp)
    assert {f: getattr(got, f) for f in tt.TransformerConfig.__dataclass_fields__} == {
        f: getattr(ref, f) for f in tt.TransformerConfig.__dataclass_fields__}
    for sections in ([24 * 128, 8 * 128, 8 * 128], [8192, 8192], [8, 4, 4]):
        np.testing.assert_array_equal(tp_quant._fused_perm(sections, tp),
                                      jtpq._fused_perm(sections, tp))


@pytest.mark.parametrize("kind", ["fp", "int8", "int8u", "w4a8", "q4", "sg"])
def test_local_params_are_the_jax_shards(trees, kind):
    """Each rank's leaves against the JAX tree permuted by `permute_fused`
    and cut by `param_specs`' spec (the block of the "tp" axis), bit for
    bit; each its own contiguous tensor."""
    jp, npt, kw = trees[kind]
    cfg = tt.TransformerConfig(**kw)
    port = tt.fuse_fp_tree(params_from_numpy(npt, "cpu"))
    jtree = jt.fuse_fp_tree(jp) if kind == "fp" else jp
    jlayers = jtpq.permute_fused(jtree["layers"], jt.TransformerConfig(**kw), 2)
    specs = jtpq.param_specs({"layers": jlayers})["layers"]
    flat_j = {k: np.asarray(v) for k, v in _flat(jlayers).items()}
    flat_s = _flat(specs)
    for rank in range(2):
        local = _flat(tp_quant.local_params(port, cfg, 2, rank)["layers"])
        assert local.keys() == flat_j.keys()
        for key, v in local.items():
            ref, spec = flat_j[key], tuple(flat_s[key])
            if "tp" in spec:
                dim = spec.index("tp")
                n = ref.shape[dim] // 2
                ref = np.take(ref, np.arange(rank * n, (rank + 1) * n), axis=dim)
                assert v.is_contiguous() and v.data_ptr() % 16 == 0, key
            np.testing.assert_array_equal(v.numpy(), ref.astype(v.numpy().dtype), err_msg=key)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_refusals_name_the_leaf_the_tp_and_the_unit(trees):
    """Heads or hidden not divisible by tp, a row-parallel bias, a row shard
    that is not whole units of its format; a mesh that is no DeviceMesh;
    `axis_name` that is no process group; a FusedKVCache under tp."""
    from tpu_audio_torch.models.orpheus import model as tm
    from tpu_audio_torch.ops.kvcache import FusedKVCache

    cfg = tt.TransformerConfig(**{**LLM, "tie_word_embeddings": True})
    fp = params_from_numpy(trees["fp"][1], "cpu")
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        tp_quant.local_params(fp, cfg, 3, 0)
    biased = {**fp, "layers": {**fp["layers"], "attn": {**fp["layers"]["attn"], "o": {
        **fp["layers"]["attn"]["o"], "bias": torch.zeros(2, LLM["dim"])}}}}
    with pytest.raises(ValueError, match="attn.o has a bias"):
        tp_quant.local_params(biased, cfg, 2, 0)
    sg = params_from_numpy(trees["sg"][1], "cpu")
    sg_cfg4 = tt.TransformerConfig(**{**trees["sg"][2], "n_kv_heads": 4})  # heads split by 4
    with pytest.raises(ValueError, match=r"attn.o \(weight_q4s\): K 512 over tp=4 is 128 columns "
                                         r"a rank, not a whole number of its 256-column groups"):
        tp_quant.check_tp_quant_supported(sg, sg_cfg4, 4)
    w4 = params_from_numpy(trees["w4a8"][1], "cpu")
    with pytest.raises(ValueError, match=r"attn.o \(weight_q4p\): K 256 over tp=4 .* 128-column"):
        tp_quant.check_tp_quant_supported(w4, tt.TransformerConfig(
            **{**LLM, "n_kv_heads": 4}), 4)
    q4 = params_from_numpy(trees["q4"][1], "cpu")
    with pytest.raises(ValueError, match=r"attn.o \(weight_q4\): K 256 over tp=8 is 32 columns "
                                         r"a rank, not a whole number of its 64-column groups"):
        tp_quant.check_tp_quant_supported(q4, tt.TransformerConfig(
            **{**LLM, "n_heads": 8, "n_kv_heads": 8, "head_dim": 32}), 8)
    i8 = params_from_numpy(trees["int8"][1], "cpu")
    with pytest.raises(ValueError, match=r"attn.o \(weight_i8\): K 256 over tp=32"):
        tp_quant.check_tp_quant_supported(i8, tt.TransformerConfig(
            **{**LLM, "n_heads": 32, "n_kv_heads": 32, "head_dim": 8}), 32)
    with pytest.raises(TypeError, match="DeviceMesh.*got object"):
        tm.CausalLMGenerator(fp, cfg, mesh=object())
    cache = tt.make_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(TypeError, match="process group.*got str 'tp'"):
        tt.forward_hidden(fp, cfg, torch.zeros(1, 1, LLM["dim"]), cache, axis_name="tp")
    from tpu_audio_torch.parallel import make_mesh
    assert not dist.is_initialized()
    try:
        group = make_mesh(devices="cpu").get_group("tp")
        with pytest.raises(ValueError, match="FusedKVCache does not support tensor parallelism"):
            tt.forward_hidden(fp, cfg, torch.zeros(1, 1, LLM["dim"]),
                              FusedKVCache.create(2, 4, 2, 64, device="cpu"), axis_name=group)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ Orpheus's generator

def jax_path_logits(jp, kw, tokens):
    """The JAX unsharded f32 logits along `tokens` (prefill of PROMPT left
    padded to 32, then one-token steps), row i choosing tokens[i]."""
    cfg = jt.TransformerConfig(**kw)
    pad = 32 - len(PROMPT)
    cache, extra = jt.decode_cache_and_mask(cfg, 64, pad, False, dtype=jnp.float32)
    off = jnp.asarray([pad])
    lg, cache = jt.forward(jp, cfg, jnp.asarray([[0] * pad + PROMPT]), cache, extra,
                           pos_offset=off)
    out = [np.asarray(lg[0, -1], np.float32)]
    for tok in tokens[:-1]:
        lg, cache = jt.forward(jp, cfg, jnp.asarray([[tok]]), cache, extra, pos_offset=off)
        out.append(np.asarray(lg[0, -1], np.float32))
    return np.stack(out)


def jax_generator(jp, kw):
    return jm.CausalLMGenerator(jp, jt.TransformerConfig(**kw), max_cache=64, mesh=jax_mesh())


@pytest.mark.parametrize("kind", ["fp", "int8", "int8u", "w4a8", "q4", "sg"])
def test_generate_at_tp2_matches_jax_mesh_with_margins(gloo, trees, kind):
    """Greedy tokens at tp = 2 equal the JAX generator's under (dp 4, tp 2)
    on both ranks; the ranks' logits equal each other bit for bit and lie
    within LOGIT_REL of the JAX unsharded logits, with every step's margin
    above the two's difference."""
    from tests.test_torch_port_orpheus import penalised

    _, outs = gloo
    jp, _, kw = trees[kind]
    ref = jax_generator(jp, kw).generate(PROMPT, sampler=JSampler(temperature=0.0, **PENALTY),
                                         **GREEDY)
    assert len(set(ref)) == len(ref) == GREEDY["max_new"]
    for res in outs:
        assert res["generate", kind] == ref
    np.testing.assert_array_equal(outs[0]["logits", kind], outs[1]["logits", kind])
    jl, tl = jax_path_logits(jp, kw, ref), outs[0]["logits", kind]
    err = np.abs(tl - jl).max() / np.abs(jl).max()
    assert err <= LOGIT_REL.get(kind, 1e-2), err
    jl, tl = penalised(jl, ref), penalised(tl, ref)
    dev = np.abs(jl - tl)
    a = np.asarray(ref)[:, None]
    gap = np.take_along_axis(jl, a, 1) - jl
    need = np.take_along_axis(dev, a, 1) + dev
    np.put_along_axis(gap, a, np.inf, 1)
    assert (gap > need).all(), np.argwhere(gap <= need)


def test_local_shapes_and_a_replicated_draft(gloo):
    """Each rank's attention leaves hold its heads, its own contiguous
    tensors; the draft model stays whole."""
    _, outs = gloo
    n, hd, h, kvh, d = (LLM[k] for k in ("n_layers", "head_dim", "n_heads", "n_kv_heads",
                                            "dim"))
    for res in outs:
        assert res["local", "int8"] == {"qkv": (n, (h + 2 * kvh) * hd // 2, d),
                                        "o": (n, d, h * hd // 2)}
        assert res["local", "int8u"]["k"] == (n, kvh * hd // 2, d)
        assert res["local", "w4a8"]["o"] == (n, d, h * hd // 4)  # pair-packed bytes
        assert res["local", "q4"]["o"] == (n, d, h * hd // 16)   # 32-bit words of 4 bits
        assert all(res["contiguous", k] for k in ("fp", "int8", "int8u", "w4a8", "q4", "sg"))
        assert tuple(res["draft replicated"]) == (
            DRAFT["n_layers"], (DRAFT["n_heads"] + 2 * DRAFT["n_kv_heads"]) * DRAFT["head_dim"],
            DRAFT["dim"])


def test_batch_spans_cancellation_and_speculative_match_jax_mesh(gloo, trees):
    """On the int8 tree: `generate_batch`, `stream_spans`, a spanned
    `generate` whose should_stop fires before its third span, and
    `generate_speculative` with a replicated draft, each equal to the JAX
    generator's under its mesh (greedy: the speculative tokens are the
    plain ones)."""
    _, outs = gloo
    jp, _, kw = trees["int8"]
    gen = jax_generator(jp, kw)
    greedy = JSampler(temperature=0.0, **PENALTY)
    batch = gen.generate_batch(PROMPTS, sampler=greedy, **GREEDY)
    calls = []
    cancelled = gen.generate(PROMPT, sampler=greedy, span=3, should_stop=lambda: len(
        calls.append(1) or calls) > 2, **GREEDY)
    stream = list(gen.stream_spans(PROMPT, sampler=greedy, span=4, **GREEDY))
    draft = jm.DraftModel(jt.init_params(jax.random.PRNGKey(5), jt.TransformerConfig(**DRAFT)),
                          jt.TransformerConfig(**DRAFT), max_cache=64)
    spec = gen.generate_speculative(PROMPT, sampler=greedy, gamma=3, draft=draft, **GREEDY)
    assert len(cancelled) == 7 and spec == gen.generate(PROMPT, sampler=greedy, **GREEDY)
    for res in outs:
        assert res["batch"] == batch
        assert res["cancelled"] == cancelled
        assert res["stream"] == stream
        assert res["speculative"] == spec


def test_ranks_emit_the_same_tokens(gloo):
    """Every token list of the two ranks equal, a sampled decode (temperature
    1, top-p 0.95, the penalty, the same seed on both ranks) included."""
    _, (r0, r1) = gloo
    keys = [k for k in r0 if not (isinstance(k, tuple) and k[0] in ("logits", "local"))]
    for k in keys:
        a, b = r0[k], r1[k]
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif k == "cv3 chunks":
            for (ta, fa, sa), (tb, fb, sb) in zip(a, b):
                assert (ta, fa) == (tb, fb)
                np.testing.assert_array_equal(sa, sb)
        elif k not in ("cv2 flow local", "cv3 dit local"):
            assert a == b, k
    assert len(set(r0["sampled"])) > 3


# ------------------------------------------------------------------ engines

def test_orpheus_engine_tokens_match_jax_mesh_and_audio_the_unsharded(gloo):
    """`OrpheusEngine.from_params(mesh=)` greedily: its LM tokens equal the
    JAX engine's under its mesh; its audio equals the port's unsharded
    engine's on the same trees bit for bit (SNAC runs whole)."""
    from tpu_audio.codecs import snac as jsnac
    from tpu_audio.models.orpheus.engine import OrpheusEngine as JEngine
    from tpu_audio_torch.codecs.snac import model as tsnac
    from tpu_audio_torch.models.orpheus.engine import OrpheusEngine

    parts, outs = gloo
    lp, sp = parts["engine"]
    kw = {**ENGINE_LM}
    jlp = jax.tree.map(jnp.asarray, tt.numpy_params(np.random.default_rng(2),
                                                    tt.TransformerConfig(**kw)))
    jcfg = jt.TransformerConfig(**kw)
    jeng = JEngine.from_params(jlp, jcfg, jsnac.init_params(jax.random.PRNGKey(3),
                                                            jsnac.SNACConfig(**SNAC)),
                               jsnac.SNACConfig(**SNAC), max_cache=256, mesh=jax_mesh())
    jeng.temperature = 0.0
    toks = []
    jeng.lm.stream_spans = _recorded(jeng.lm.stream_spans, toks)
    jeng.generate("Hello there.", max_new_tokens=48)
    eng = OrpheusEngine.from_params(lp, tt.TransformerConfig(**kw), sp, tsnac.SNACConfig(**SNAC))
    eng.temperature = 0.0
    audio = eng.generate("Hello there.", max_new_tokens=48).samples
    for res in outs:
        assert res["orpheus tokens"] == toks and len(toks) == 1 and len(toks[0]) == 48
        np.testing.assert_array_equal(res["orpheus audio"], audio)


@pytest.fixture
def f32_cache(monkeypatch):
    monkeypatch.setattr(jt, "decode_cache_and_mask",
                        functools.partial(jt.decode_cache_and_mask, dtype=jnp.float32))


def test_cosyvoice2_lm_and_token2wav_match_jax_mesh(gloo, cv_parts, f32_cache):
    """CosyVoice2 at tp = 2: the LM's tokens under RAS on the JAX draws equal
    the JAX generator's under its mesh (f32 caches on both); the engine's
    `token2wav` (the conformer and the CFM estimator by local shards,
    HiFT whole) within HIFT_REL of the JAX engine's under its mesh."""
    from tests.test_torch_port_s3 import HIFT_REL
    from tpu_audio.models.cosyvoice2 import engine as jengine
    from tpu_audio.models.cosyvoice2 import lm as jlm

    parts, outs = gloo
    jlp, jcfg, _, _ = cv_parts["lm"]
    ref = jlm.CosyLMGenerator(jlp, jcfg, max_cache=256, mesh=jax_mesh()).generate(
        *cv_parts["text"], seed=CV2_SEED, max_new=CV2_NEW)
    jparts, _ = cv_parts["cv2"]
    jeng = jengine.CosyVoice2Engine.from_params(*jparts, max_cache=512, mesh=jax_mesh())
    rs = jeng.prepare_conditionals(parts["ref audio"], 22050, ref_text="Hello there")
    wav = np.asarray(jeng._token2wav(parts["tokens"], rs, 2))
    d = parts["cv2 engine"][3].conformer
    for res in outs:
        assert res["cv2 lm"] == ref and len(ref) >= 12
        assert res["cv2 lm local"][1] == (6 + 2 * 2) * 64 // 2
        assert res["cv2 flow local"] == ((d.linear_units // 2, d.output_size), d.heads // 2)
        err = np.abs(res["cv2 wav"] - wav).max() / np.abs(wav).max()
        assert res["cv2 wav"].shape == wav.shape and err <= HIFT_REL, err


def test_cosyvoice3_from_params_mesh_matches_jax_mesh(gloo, cv_parts):
    """ROADMAP C32: `CosyVoice3Engine.from_params(mesh=)` serves. Its stream
    of two sentences on the same token chunks and the JAX draws (the DiT by
    local shards, only rank 0 rotating head 0) against the JAX engine's
    under its mesh: texts, finality, samples within HIFT_REL."""
    from tests.test_torch_port_s3 import HIFT_REL
    from tpu_audio.api.tts import StreamingGranularity as JG
    from tpu_audio.models.cosyvoice3 import engine as jengine

    parts, outs = gloo
    jparts, _ = cv_parts["cv3"]
    jeng = jengine.CosyVoice3Engine.from_params(*jparts, max_cache=512, mesh=jax_mesh())
    streams = parts["cv3 streams"]
    jeng.streamer.stream = lambda text_ids, *a, seed=0, **k: iter(
        streams[(tuple(text_ids), seed)])
    want = list(jeng.generate_streaming(parts["cv3 text"], granularity=JG.TOKEN))
    dit = parts["cv3 engine"][3].dit
    for rank, res in enumerate(outs):
        got = res["cv3 chunks"]
        assert [(t, f) for t, f, _ in got] == [(c.text, c.is_final) for c in want]
        assert len(got) >= 3
        for (_, _, s), c in zip(got, want):
            if len(c.samples):
                err = np.abs(s - np.asarray(c.samples)).max() / np.abs(c.samples).max()
                assert err <= HIFT_REL, err
        assert res["cv3 dit local"] == ((dit.heads * dit.head_dim // 2, dit.dim), rank,
                                        dit.heads // 2)


def test_c33_fun_asr_is_the_reference_name():
    """ROADMAP C33: `STT.fun_asr` with the reference's parameters (and the
    port's device), `STT.funasr` its alias."""
    import inspect

    from tpu_audio.api.stt import STT as JSTT
    from tpu_audio_torch.api.stt import STT

    got = inspect.signature(STT.fun_asr).parameters
    ref = inspect.signature(JSTT.fun_asr).parameters
    assert list(got)[:len(ref)] == list(ref) and list(got)[len(ref):] == ["device"]
    assert all(got[k].default == ref[k].default for k in ref)
    assert STT.funasr is STT.fun_asr
    eng = STT.fun_asr(quantization="int8", device="cpu")
    assert (eng.quantization, str(eng.device)) == ("int8", "cpu")


def test_c36_quant_matmul_rows_go_in_launches_a_plan_holds(monkeypatch):
    """ROADMAP C36: where no single launch's plan holds a call's rows (f32 x
    of 32 rows at K 8192), `rows_a_launch` halves them until one does; a
    plan that holds them all keeps one launch."""
    from tpu_audio_torch.ops.kernels import quant_matmul as qmm

    seen = []

    def plan(device, rows, i, o, *, bits, x_dtype):
        seen.append(rows)
        if rows * (3 if x_dtype == torch.float32 else 1) * i > 16 * 3 * 8192:
            raise RuntimeError("tpa_quant_matmul_plan: CUDA error 1 (invalid argument)")
        return {}
    monkeypatch.setattr(qmm, "launch_plan", plan)
    qmm.rows_a_launch.cache_clear()
    try:
        assert qmm.rows_a_launch(torch.device("cpu"), 32, 8192, 3072, 4, torch.float32) == 16
        assert seen == [32, 16]
        assert qmm.rows_a_launch(torch.device("cpu"), 32, 8192, 3072, 4, torch.bfloat16) == 32
        assert qmm.rows_a_launch(torch.device("cpu"), 31, 1 << 20, 8, 4, torch.float32) == 1
    finally:
        qmm.rows_a_launch.cache_clear()


def test_c35_fp_quantizations_dequantise_the_lm_and_a_mesh_needs_one(trees):
    """ROADMAP C35: `load()` under "bf16", "fp16" or "none" serves the LM
    dequantised to that dtype (the JAX engine serves the 4-bit tree as it
    is); a mesh with a quantised LM is refused, as in JAX."""
    from tpu_audio_torch.models.cosyvoice2 import engine as cv2e
    from tpu_audio_torch.ops import quant

    q4 = params_from_numpy(trees["q4"][1], "cpu")
    for name, dtype in (("bf16", torch.bfloat16), ("fp16", torch.float16),
                        ("none", torch.float32)):
        fp = cv2e.fp_lm(q4, name, "cpu")
        o = fp["layers"]["attn"]["o"]
        assert set(o) == {"weight"} and o["weight"].dtype == dtype
        assert torch.equal(o["weight"], quant.dequantize(q4["layers"]["attn"]["o"]).to(dtype))
        assert fp["embed"]["weight"].shape == (LLM["vocab_size"], LLM["dim"])
    from tpu_audio_torch.parallel import make_mesh
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(devices="cpu")
        with pytest.raises(ValueError, match="mesh serving needs an fp LM.*'w8a8'"):
            cv2e.CosyVoice2Engine(quantization="w8a8", mesh=mesh, device="cpu")
        assert cv2e.CosyVoice2Engine(quantization="bf16", mesh=mesh, device="cpu").mesh is mesh
    finally:
        dist.destroy_process_group()
