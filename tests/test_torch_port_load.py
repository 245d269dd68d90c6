"""The port's checkpoint loaders (tpu_audio_torch/models/whisper/load.py,
nn/load_llama.py, models/funasr/load.py, models/orpheus/load.py) and the
engines' `load()` against the JAX package, on checkpoints written here in
the published layouts from seeded random weights (chip_smoke's writers).

Sizes are tiny: the 2-layer, 64-wide configs of test_loader_manifests.py
(Whisper at n_audio_ctx 300 for the model comparisons, 1500 where the
engine transcribes 30 s windows). `sanitize`, `convert_llama`,
`convert_gpt2`, the Fun-ASR `convert` and `convert_snac` are held against
the JAX functions key for key and bit for bit; the loaded trees against
`convert.params_from_numpy` of the JAX-loaded ones; the models on them at
f32 within 2e-4 (the tolerance of test_torch_port_whisper.py); each engine's
`load()` against `from_params` / `from_pipeline` on the same tree, token for
token. The JAX Fun-ASR loader, like the port's, takes only the LLM's config
from config.json: the tiny encoder and adaptor come in through
`FunASRConfig`, patched here.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_audio.models.funasr import load as jfload
from tpu_audio.models.orpheus import load as joload
from tpu_audio.models.whisper import load as jwload
from tpu_audio.models.whisper import model as jwmodel
from tpu_audio.nn import load_llama as jload_llama
from tpu_audio.utils import weights as jweights
from tpu_audio_torch.api.errors import ModelLoadError
from tpu_audio_torch.api.stt import STT, WhisperEngine
from tpu_audio_torch.api.tts import TTS
from tpu_audio_torch.codecs.snac import model as tsnac
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.funasr import load as tfload
from tpu_audio_torch.models.funasr import model as tfmodel
from tpu_audio_torch.models.orpheus import load as toload
from tpu_audio_torch.models.orpheus import model as tomodel
from tpu_audio_torch.models.whisper import load as twload
from tpu_audio_torch.models.whisper import model as twmodel
from tpu_audio_torch.models.whisper.config import WhisperConfig
from tpu_audio_torch.models.whisper.pipeline import WhisperPipeline
from tpu_audio_torch.nn import load_llama as tload_llama
from tpu_audio_torch.nn import transformer as ttransformer
from tpu_audio_torch.nn.transformer import TransformerConfig
from tpu_audio_torch.ops import quant
from tpu_audio_torch.ops.sampling import SamplerConfig
from tpu_audio_torch.utils import pytree, weights
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False

GOLD = Path(__file__).resolve().parent / "data" / "tokenizer_golden"
WDIMS = dict(n_mels=80, n_audio_ctx=300, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
             n_vocab=51866, n_text_ctx=32, n_text_state=64, n_text_head=4, n_text_layer=2)
HF_NAMES = [(".cross_attn.q.", ".encoder_attn.q_proj."), (".cross_attn.k.", ".encoder_attn.k_proj."),
            (".cross_attn.v.", ".encoder_attn.v_proj."),
            (".cross_attn.o.", ".encoder_attn.out_proj."),
            (".attn.q.", ".self_attn.q_proj."), (".attn.k.", ".self_attn.k_proj."),
            (".attn.v.", ".self_attn.v_proj."), (".attn.o.", ".self_attn.out_proj."),
            (".ln1.", ".self_attn_layer_norm."), (".ln_cross.", ".encoder_attn_layer_norm."),
            (".ln2.", ".final_layer_norm."), (".mlp.fc1.", ".fc1."), (".mlp.fc2.", ".fc2.")]
LLAMA = TransformerConfig(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
                          hidden_dim=128, vocab_size=300, rope_theta=500000.0, norm_eps=1e-5,
                          tie_word_embeddings=False)
GREEDY = SamplerConfig(temperature=0.0)


def np_tree(tree: dict) -> dict:
    """A tree of tensors or jax arrays → numpy leaves (bf16 widened)."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        a = np.asarray(v)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return {k: leaf(v) for k, v in pytree.flatten(tree).items()}


def same_trees(got: dict, want: dict) -> None:
    """Key for key and bit for bit (bf16 compared by its f32 widening)."""
    g, w = np_tree(got), np_tree(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert g[k].tobytes() == w[k].tobytes(), k


def same_torch_trees(got: dict, want: dict) -> None:
    g, w = pytree.flatten(got), pytree.flatten(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def same_config(got, want) -> None:
    """A port TransformerConfig equal to the JAX one on every field the
    port has (the JAX one also carries `scan_unroll`, a lax.scan setting)."""
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert set(g) <= set(w) and g == {k: w[k] for k in g}


def write_checkpoint(path: Path, flat: dict, config: dict, extra: dict | None = None) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    chip_smoke.write_safetensors(path / "model.safetensors", flat, {"format": "mlx"})
    (path / "config.json").write_text(json.dumps(config))
    for name, text in (extra or {}).items():
        (path / name).write_text(text)
    return path


# ------------------------------------------------------------ Whisper

def whisper_tree(cfg, quantization: str, seed: int = 0) -> dict:
    """The port's tree at f32 (q4/q8: group-affine, scales and biases
    rounded to bf16 as the published files store them)."""
    tree = twmodel.init_params(seed, cfg, torch.float32, "cpu")
    if quantization == "fp":
        return tree
    return chip_smoke.bf16_affine(quant.quantize_tree(tree, bits=int(quantization[1])))


def whisper_hf_flat(tree: dict, cfg) -> dict:
    """A port Whisper tree → an HF-transformers checkpoint's flat dict
    (convs in torch's (O, I, K), as the port holds them)."""
    from tpu_audio_torch.nn.layers import sinusoidal_positions

    flat = chip_smoke.packed_weights(chip_smoke.unstacked(chip_smoke.unstacked(
        pytree.flatten(tree), "encoder.blocks", "model.encoder.layers"),
        "decoder.blocks", "model.decoder.layers"))
    out = {}
    for k, v in flat.items():
        k = chip_smoke.renamed(k, HF_NAMES)
        for ours, theirs in ((r"^encoder\.ln_post\.", "model.encoder.layer_norm."),
                             (r"^decoder\.ln\.", "model.decoder.layer_norm."),
                             (r"^encoder\.conv", "model.encoder.conv"),
                             (r"^decoder\.token_embedding\.", "model.decoder.embed_tokens."),
                             (r"^decoder\.positional_embedding$",
                              "model.decoder.embed_positions.weight")):
            k = re.sub(ours, theirs, k)
        out[k] = v
    out["model.encoder.embed_positions.weight"] = sinusoidal_positions(
        cfg.n_audio_ctx, cfg.n_audio_state)
    return out


def whisper_flat(tree: dict, cfg, layout: str) -> dict:
    return np_tree(chip_smoke.whisper_mlx_flat(tree, cfg) if layout == "mlx"
                   else whisper_hf_flat(tree, cfg))


def mlx_config(cfg, bits: int | None) -> dict:
    d = {k: getattr(cfg, k) for k in WDIMS}
    return {"model_type": "whisper", **d, **({"quantization": {"group_size": 64, "bits": bits}}
                                              if bits else {})}


@pytest.mark.parametrize("layout", ["mlx", "hf"])
@pytest.mark.parametrize("quantization", ["fp", "q4", "q8"])
def test_whisper_sanitize_matches_jax(layout, quantization):
    cfg = WhisperConfig(**WDIMS)
    flat = whisper_flat(whisper_tree(cfg, quantization), cfg, layout)
    assert any(k.startswith("model.encoder") for k in flat) == (layout == "hf")
    got, want = twload.sanitize(dict(flat)), jwload.sanitize(dict(flat))
    same_trees(got, want)
    leaf = got["decoder"]["blocks"]["attn"]["q"]
    assert set(leaf) == ({"weight", "bias"} if quantization == "fp"
                         else {f"weight_{quantization}", "scales", "biases", "bias"})
    weights.validate_tree(got, twmodel.numpy_params(weights.ShapeRNG(), cfg))


def _sanitized() -> tuple[dict, WhisperConfig]:
    cfg = WhisperConfig(**WDIMS)
    return twload.sanitize(whisper_flat(whisper_tree(cfg, "fp"), cfg, "mlx")), cfg


@pytest.mark.parametrize("fault, message", [
    (lambda t: t["decoder"]["blocks"]["cross_attn"].pop("k"), "missing modules"),
    (lambda t: t["encoder"].update(extra={"weight": np.zeros(3, np.float32)}),
     "unexpected keys"),
    (lambda t: t["decoder"]["ln"].update(weight=np.ones(65, np.float32)), "shape mismatches"),
], ids=["missing", "unexpected", "shape drift"])
def test_whisper_validate_refusals(fault, message):
    """The three refusals, as ModelLoadError, as the JAX validate_tree
    raises them on the same tree."""
    tree, cfg = _sanitized()
    fault(tree)
    with pytest.raises(ModelLoadError, match=message):
        weights.validate_tree(tree, twmodel.numpy_params(weights.ShapeRNG(), cfg), name="w")
    from tpu_audio.api.errors import ModelLoadError as JModelLoadError
    from tpu_audio.models.whisper.config import WhisperConfig as JWhisperConfig

    with pytest.raises(JModelLoadError, match=message):
        jweights.validate_tree(tree, functools.partial(
            jwmodel.init_params, jax.random.PRNGKey(0), JWhisperConfig(**WDIMS)), name="w")


def test_whisper_load_matches_jax(tmp_path):
    """`load` of a written mlx fp checkpoint: the tree against
    params_from_numpy of the JAX-loaded one; encoder features and
    first-step logits of the two models at f32 within 2e-4; greedy tokens
    equal over 8 steps."""
    cfg = WhisperConfig(**WDIMS)
    d = write_checkpoint(tmp_path / "w", whisper_flat(whisper_tree(cfg, "fp", 1), cfg, "mlx"),
                         mlx_config(cfg, None))
    shutil.copy(GOLD / "whisper.tiktoken", d / "multilingual.tiktoken")
    params, tcfg, ttok = twload.load(repo=str(d), device="cpu")
    jparams, jcfg, jtok = jwload.load(repo=str(d))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    same_torch_trees(params, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"))
    assert ttok.encode("x² 3½ Ⅻa") == jtok.encode("x² 3½ Ⅻa")
    model = twmodel.Whisper(tcfg, params)
    mel = (np.random.default_rng(2).standard_normal((1, 2 * cfg.n_audio_ctx, cfg.n_mels))
           * 0.1).astype(np.float32)
    feats = model.encode(torch.from_numpy(mel))
    jfeats = jwmodel.encode(jparams, jcfg, jnp.asarray(mel))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=2e-4, atol=2e-4)
    state = model.init_state(feats, batch=1)
    jstate = jwmodel.init_state(jparams, jcfg, jfeats, batch=1)
    toks, jtoks = [ttok.sot_sequence()], [jtok.sot_sequence()]
    for step in range(8):
        logits, state = model.decode_step(torch.tensor([toks[-1]]), state)
        jlogits, jstate = jwmodel.decode_step(jparams, jcfg, jnp.asarray([jtoks[-1]], jnp.int32),
                                              jstate)
        if step == 0:
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=2e-4)
        toks.append([int(logits[0, -1].argmax())])
        jtoks.append([int(np.asarray(jlogits)[0, -1].argmax())])
    assert toks == jtoks


def test_whisper_engine_load_w8a8(tmp_path):
    """`STT.whisper(..., "w8a8", repo=dir).load()` of a written mlx q8
    checkpoint: the tree `serve_tree_int8` makes of the same q8 tree, bit for
    bit, and the tokens of `from_pipeline` on it, also for a WAV's path."""
    cfg = WhisperConfig(**{**WDIMS, "n_audio_ctx": 1500})
    q8 = whisper_tree(cfg, "q8", 2)
    d = write_checkpoint(tmp_path / "w8", whisper_flat(q8, cfg, "mlx"), mlx_config(cfg, 8),
                         {"multilingual.tiktoken": (GOLD / "whisper.tiktoken").read_text()})
    engine = STT.whisper("tiny", "w8a8", repo=str(d), device="cpu")
    engine.load()
    ref_tree = twload.serve_tree_int8(q8)
    model = engine.pipeline.model
    same_torch_trees(pytree.unflatten({k: v.data for k, v in model.named_parameters()}),
                     ref_tree)
    ref = WhisperEngine.from_pipeline(WhisperPipeline(twmodel.Whisper(cfg, ref_tree),
                                                      engine.pipeline.tok, kv_int8=True))
    assert engine.pipeline.kv_int8
    clip = (np.random.default_rng(3).standard_normal(16000) * 0.1).astype(np.float32)
    kw = dict(language="en", temperature=(0.0,))
    got, want = engine.transcribe(clip, **kw), ref.transcribe(clip, **kw)
    assert [s.tokens for s in got.segments] == [s.tokens for s in want.segments]
    from tpu_audio_torch.utils import audio_io

    wav = tmp_path / "clip.wav"
    audio_io.write_wav(str(wav), clip, 16000)
    by_path = engine.transcribe(str(wav), **kw)
    assert [s.tokens for s in by_path.segments] == [s.tokens for s in got.segments]


# ------------------------------------------------------------ Llama family

def llama_dict(model_type: str) -> dict:
    cfg = LLAMA if model_type == "llama" else dataclasses.replace(LLAMA, vocab_size=320)
    return chip_smoke.hf_config(cfg, model_type, attention_bias=False)


@pytest.mark.parametrize("model_type", ["llama", "qwen2", "qwen3"])
def test_config_from_hf_matches_jax(model_type):
    d = llama_dict(model_type)
    got = tload_llama.config_from_hf(d)
    same_config(got, jload_llama.config_from_hf(d))
    assert got.qk_norm == (model_type == "qwen3")
    assert got.attn_qkv_bias == (model_type == "qwen2")


def llama_tree(cfg, seed: int, bits: int | None) -> dict:
    tree = ttransformer.init_params(seed, cfg, torch.float32, "cpu")
    return tree if bits is None else chip_smoke.bf16_affine(quant.quantize_tree(tree, bits=bits))


@pytest.mark.parametrize("model_type, bits", [("llama", None), ("llama", 4), ("qwen2", 8),
                                              ("qwen3", 4)])
def test_convert_llama_matches_jax(model_type, bits):
    cfg = tload_llama.config_from_hf(llama_dict(model_type))
    flat = np_tree(chip_smoke.llama_flat(llama_tree(cfg, 0, bits)))
    flat["model.rotary_emb.inv_freq"] = np.ones(8, np.float32)
    same_trees(tload_llama.convert_llama(dict(flat)), jload_llama.convert_llama(dict(flat)))


def test_convert_gpt2_matches_jax():
    rng = np.random.default_rng(0)
    d, flat = 16, {"wte.weight": rng.standard_normal((50, 16)).astype(np.float32),
                   "wpe.weight": rng.standard_normal((8, 16)).astype(np.float32),
                   "ln_f.weight": np.ones(16, np.float32), "ln_f.bias": np.zeros(16, np.float32)}
    for i in range(2):
        for name, shape in (("attn.c_attn.weight", (d, 3 * d)), ("attn.c_attn.bias", (3 * d,)),
                            ("attn.c_proj.weight", (d, d)), ("attn.c_proj.bias", (d,)),
                            ("mlp.c_fc.weight", (d, 4 * d)), ("mlp.c_proj.weight", (4 * d, d)),
                            ("ln_1.weight", (d,)), ("ln_2.bias", (d,))):
            flat[f"h.{i}.{name}"] = rng.standard_normal(shape).astype(np.float32)
    got, want = tload_llama.convert_gpt2(dict(flat)), jload_llama.convert_gpt2(dict(flat))
    same_trees(got, want)
    assert got["layers"]["attn"]["q"]["weight"].shape == (2, d, d)


@pytest.mark.parametrize("bits", [None, 4])
def test_load_llama_dir_matches_jax(tmp_path, bits):
    cfg = LLAMA
    d = write_checkpoint(tmp_path / "llama", chip_smoke.llama_flat(llama_tree(cfg, 1, bits)),
                         chip_smoke.hf_config(cfg, "llama"))
    got, tcfg = tload_llama.load_llama_dir(str(d), device="cpu")
    want, jcfg = jload_llama.load_llama_dir(str(d))
    same_config(tcfg, jcfg)
    same_torch_trees(got, params_from_numpy(jax.tree.map(np.asarray, want), "cpu",
                                            torch.bfloat16))
    bad = tmp_path / "bad"
    shutil.copytree(d, bad)
    (bad / "config.json").write_text(json.dumps(chip_smoke.hf_config(
        dataclasses.replace(cfg, n_layers=3), "llama")))  # the norms' (L, D) leaves drift
    with pytest.raises(ModelLoadError, match="shape mismatches"):
        tload_llama.load_llama_dir(str(bad), device="cpu")


# ------------------------------------------------------------ Fun-ASR

FUN_ENC = dict(num_encoders=1, num_tp_encoders=1)
FUN_ADAPT = dict(llm_dim=128, n_layer=1)
FUN_LLM = TransformerConfig(dim=128, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=64,
                            hidden_dim=256, vocab_size=151936, rope_theta=1e6, qk_norm=True,
                            norm_eps=1e-6, tie_word_embeddings=True)
FUN_ADDED = {"<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645,
             "<|startofspeech|>": 151646, "<|endofspeech|>": 151647}


FunASRConfig = tfmodel.FunASRConfig


def fun_cfg(llm=FUN_LLM):
    return FunASRConfig(encoder=tfmodel.SenseVoiceConfig(**FUN_ENC),
                                adaptor=tfmodel.AdaptorConfig(**FUN_ADAPT), llm=llm)


@pytest.fixture(scope="module")
def funasr_dir(tmp_path_factory):
    """An mlx 4-bit Fun-ASR checkpoint (tiny encoder, Qwen3 stack) in a
    Hugging Face cache, with a tokenizer.json of Qwen's pattern and NFC."""
    params = tfmodel.init_params(0, fun_cfg(), torch.float32, "cpu")
    params["llm"] = chip_smoke.bf16_affine(quant.quantize_tree(params["llm"], bits=4))
    root = tmp_path_factory.mktemp("hub")
    tok = chip_smoke.tokenizer_json(chip_smoke.QWEN2_PAT, FUN_ADDED, ["speech", " the"],
                                    nfc=True, ignore_merges=False)
    snap, _ = chip_smoke.seed_cache(root, "mlx-community/Fun-ASR-Nano-4bit", {
        "model.safetensors": lambda p: chip_smoke.write_safetensors(
            p, chip_smoke.funasr_flat(params)),
        "config.json": chip_smoke.write_text(json.dumps(
            {"llm_config": chip_smoke.hf_config(FUN_LLM, "qwen3")})),
        "tokenizer.json": chip_smoke.write_text(tok)})
    return root, snap, params


def test_funasr_convert_and_load_match_jax(funasr_dir, monkeypatch):
    _, snap, params = funasr_dir
    flat = weights.load_safetensors_dir(str(snap))
    same_trees(tfload.convert(dict(flat)), jfload.convert(dict(flat)))
    monkeypatch.setattr(tfmodel, "FunASRConfig", lambda llm=FUN_LLM: fun_cfg(llm))
    got, cfg, tok = tfload.load(str(snap), torch.float32, "cpu")
    want, jcfg, _ = jfload.load(str(snap))
    same_config(cfg.llm, jcfg.llm)
    same_torch_trees(got, params_from_numpy(jax.tree.map(np.asarray, want), "cpu"))
    same_torch_trees(got, params)
    assert tok.encode("<|im_end|>") == [151645]


def test_funasr_engine_load(funasr_dir, monkeypatch):
    """`STT.funasr().load()` from the pre-seeded cache: eos ids from the
    added tokens, the tokens of `from_params` on the same tree."""
    root, _, params = funasr_dir
    monkeypatch.setenv("TPU_AUDIO_CACHE", str(root))
    monkeypatch.setattr(tfmodel, "FunASRConfig", lambda llm=FUN_LLM: fun_cfg(llm))
    engine = STT.funasr(device="cpu")
    engine.load()
    assert engine._eos_ids == (151643, 151645)
    assert engine.generator.max_cache is None
    ref = STT.funasr().from_params(params, fun_cfg(), tokenizer=engine.tokenizer)
    clip = (np.random.default_rng(4).standard_normal(16000) * 0.1).astype(np.float32)
    got = engine.transcribe(clip, max_new_tokens=12)
    want = ref.transcribe(clip, max_new_tokens=12)
    assert got.text == want.text


# ------------------------------------------------------------ Orpheus

SNAC = dict(decoder_dim=64, decoder_rates=(4, 4, 2, 2), latent_dim=32, codebook_size=64,
            codebook_dim=4)
ORPHEUS = dataclasses.replace(tomodel.LLAMA_3B, dim=64, n_layers=2, n_heads=2, n_kv_heads=1,
                              head_dim=32, hidden_dim=128)


def snac_config_json(cfg) -> str:
    return json.dumps({"sampling_rate": cfg.sampling_rate, "encoder_dim": cfg.latent_dim // 16,
                       "decoder_dim": cfg.decoder_dim, "decoder_rates": list(cfg.decoder_rates),
                       "codebook_size": cfg.codebook_size, "codebook_dim": cfg.codebook_dim,
                       "vq_strides": list(cfg.vq_strides), "noise": cfg.noise,
                       "depthwise": cfg.depthwise})


@pytest.fixture(scope="module")
def orpheus_cache(tmp_path_factory):
    """The mlx 4-bit Orpheus LM (tiny Llama, the Orpheus vocabulary, a
    tokenizer.json of Llama-3's pattern with ignore_merges) and SNAC in the
    torch layout, in a Hugging Face cache."""
    q4 = chip_smoke.bf16_affine(quant.quantize_tree(
        ttransformer.init_params(0, ORPHEUS, torch.float32, "cpu"), bits=4))
    scfg = tsnac.SNACConfig(**SNAC)
    snac_params = tsnac.init_params(0, scfg, torch.float32, "cpu")
    root = tmp_path_factory.mktemp("hub")
    tok = chip_smoke.tokenizer_json(chip_smoke.LLAMA3_PAT, {"<|begin_of_text|>": 128000},
                                    ["tara", " the"], nfc=False, ignore_merges=True)
    lm, _ = chip_smoke.seed_cache(root, toload.LLM_REPO, {
        "model.safetensors": lambda p: chip_smoke.write_safetensors(p, chip_smoke.llama_flat(q4)),
        "config.json": chip_smoke.write_text(json.dumps(chip_smoke.hf_config(ORPHEUS, "llama"))),
        "tokenizer.json": chip_smoke.write_text(tok)})
    sn, _ = chip_smoke.seed_cache(root, toload.SNAC_REPO, {
        "model.safetensors": lambda p: chip_smoke.write_safetensors(
            p, chip_smoke.snac_torch_flat(snac_params)),
        "config.json": chip_smoke.write_text(snac_config_json(scfg))})
    return root, lm, sn, q4, snac_params, scfg


def snac_alphas_channels_last(tree: dict) -> dict:
    """The JAX SNAC tree with its one intended difference from the port's
    undone (ROADMAP C11): the JAX `convert_snac` leaves each torch Snake
    alpha (1, C, 1), the port turns it to the decoder's (1, 1, C). Every
    alpha must come out of JAX as (1, C, 1), so a change of the reference
    shows here."""
    flat = pytree.flatten(jax.tree.map(np.asarray, tree))
    for k, v in flat.items():
        if k.endswith(".alpha"):
            assert v.shape[0] == v.shape[2] == 1 and v.shape[1] > 1, (k, v.shape)
            flat[k] = np.ascontiguousarray(v.transpose(0, 2, 1))
    return pytree.unflatten(flat)


def test_convert_snac_and_orpheus_load_match_jax(orpheus_cache):
    """The port's SNAC conversion and loader against the JAX ones: every
    leaf bit for bit, the alphas after C11's transpose; the alphas as the
    port's own tree has them."""
    _, lm, sn, q4, snac_params, scfg = orpheus_cache
    flat = weights.load_safetensors_dir(str(sn))
    assert all(v.shape == (1, v.size, 1) for k, v in flat.items() if k.endswith(".alpha"))
    flat["encoder.block.0.weight"] = np.zeros((2, 2, 3), np.float32)  # dropped by both
    same_trees(toload.convert_snac(dict(flat)),
               snac_alphas_channels_last(joload.convert_snac(dict(flat))))
    got = toload.load(str(lm), str(sn), torch.bfloat16, "cpu")
    want = joload.load(str(lm), str(sn))
    lm_t, cfg, tok, snac_t, snac_cfg = got
    same_config(cfg, want[1])
    assert cfg == ORPHEUS
    assert snac_cfg == scfg
    same_torch_trees(lm_t, params_from_numpy(jax.tree.map(np.asarray, want[0]), "cpu",
                                             torch.bfloat16))
    same_torch_trees(snac_t, params_from_numpy(snac_alphas_channels_last(want[3]), "cpu"))
    same_torch_trees(snac_t, snac_params)
    assert tok.encode("tara: hi") == want[2].encode("tara: hi")


def test_load_snac_validates_the_alpha_layout(orpheus_cache, tmp_path):
    """`load_snac` holds the converted tree against the SNAC schema: an
    alpha stored channels-last (1, 1, C), not torch's (1, C, 1), comes out
    (1, C, 1) and is refused as shape drift (ROADMAP C11)."""
    _, _, sn, _, _, scfg = orpheus_cache
    flat = weights.load_safetensors_dir(str(sn))
    flat = {k: np.ascontiguousarray(v.transpose(0, 2, 1)) if k.endswith(".alpha") else v
            for k, v in flat.items()}
    chip_smoke.write_safetensors(tmp_path / "model.safetensors", flat)
    (tmp_path / "config.json").write_text(snac_config_json(scfg))
    with pytest.raises(ModelLoadError, match=r"shape mismatches.*alpha"):
        toload.load_snac(str(tmp_path), device="cpu")
    shutil.copy(sn / "model.safetensors", tmp_path / "model.safetensors")
    params, cfg = toload.load_snac(str(tmp_path), device="cpu")
    assert cfg == scfg


@pytest.mark.parametrize("quantization, serve", [("w8a8", quant.requantize_tree_int8),
                                                 ("w4a8", quant.repack_tree_w4a8)])
def test_orpheus_engine_load(orpheus_cache, monkeypatch, quantization, serve):
    """`TTS.orpheus(quantization=...).load()` from the pre-seeded cache:
    the served tree and the greedy tokens of `from_params` on the same
    served tree; the LM cache sized per request."""
    root, _, _, q4, snac_params, scfg = orpheus_cache
    monkeypatch.setenv("TPU_AUDIO_CACHE", str(root))
    engine = TTS.orpheus(quantization=quantization, device="cpu")
    engine.load()
    assert engine.lm.max_cache is None
    ref = TTS.orpheus().from_params(serve(q4), ORPHEUS, snac_params, scfg)
    same_torch_trees(engine.lm.params, ref.lm.params)
    prompt = engine._prompt("Hello there.")
    got = engine.lm.generate(prompt, sampler=GREEDY, eos_ids=(), max_new=12)
    want = ref.lm.generate(prompt, sampler=GREEDY, eos_ids=(), max_new=12)
    assert got == want and len(got) == 12
