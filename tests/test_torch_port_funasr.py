"""PyTorch port, Fun-ASR against the JAX package on the CPU: parameter
conversion (packed words, the FSMN weight), `funasr_features`, the SANM
`encode` and `adapt`, `FunASRGenerator.generate` on the bf16, q4 and int8
trees, and the engine's transcribe / translate / transcribe_streaming.

The JAX side runs its whole-stack decode kernel and its W8A8 matmuls in
interpret mode (the `jax_fused` and `jax_kernels` fixtures turn their gates
on), so the port's plain versions are held against the Pallas kernels end
to end, and both packages take the same int8 semantics: W8A16 in the step,
W8A8 in a ≤ 32-row product, the dequantised product above. Tiny configs: the encoder of
tests/test_funasr.py, the LLM at dim 128, 2 layers, 2 heads over 1 KV head,
hidden 512. The decoder's head is untied here: with a tied head and random
weights a token's own embedding dominates its logits and greedy decoding
repeats one token, which would hide a wrong step. Tolerances: features
1e-5 of max|ref|, encoder and adaptor 1e-5 (f32); tokens and text exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_int8 import jax_kernels  # noqa: F401
from tests.test_torch_port_llm import jax_fused  # noqa: F401
from tpu_audio.api import stt_funasr as jstt
from tpu_audio.models.funasr import model as jm
from tpu_audio.nn import layers as jlayers
from tpu_audio.nn import transformer as jt
from tpu_audio.ops import frontends as jfront
from tpu_audio.ops import quant as jquant
from tpu_audio_torch.api import stt_funasr as tstt
from tpu_audio_torch.api.errors import ModelLoadError
from tpu_audio_torch.api.stt import STT
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.funasr import model as tm
from tpu_audio_torch.nn import layers as tlayers
from tpu_audio_torch.nn import transformer as tt
from tpu_audio_torch.ops import frontends as tfront
from tpu_audio_torch.ops import quant as tquant
from tpu_audio_torch.utils.tokenizer import load_tokenizer
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

ENC = dict(input_dim=560, encoder_dim=32, num_heads=4, ffn_dim=64, num_encoders0=1,
           num_encoders=2, num_tp_encoders=1, kernel_size=5)
ADAPT = dict(encoder_dim=32, downsample_rate=2, ffn_dim=64, llm_dim=128, n_layer=1,
             attention_heads=4)
LLM = dict(dim=128, n_layers=2, n_heads=2, n_kv_heads=1, hidden_dim=512, vocab_size=300,
           qk_norm=True, tie_word_embeddings=False)
JCFG = jm.FunASRConfig(encoder=jm.SenseVoiceConfig(**ENC), adaptor=jm.AdaptorConfig(**ADAPT),
                       llm=jt.TransformerConfig(**LLM))
TCFG = tm.FunASRConfig(encoder=tm.SenseVoiceConfig(**ENC), adaptor=tm.AdaptorConfig(**ADAPT),
                       llm=tt.TransformerConfig(**LLM))


def close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, err


def to_torch(tree, dtype=torch.float32):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu", dtype=dtype)


@pytest.fixture(scope="module")
def jparams():
    p = jm.init_params(jax.random.PRNGKey(4), JCFG)
    # embeddings of unit scale: the prompt, not the init's 0.02, drives the decoder
    rng = np.random.default_rng(0)
    p["llm"]["embed"]["weight"] = jnp.asarray(
        rng.standard_normal((LLM["vocab_size"], LLM["dim"])).astype(np.float32))
    return p


def trees(jp, kind: str):
    """(JAX tree, port tree) of one kind: "bf16" (the whole tree cast),
    "q4" (the LLM subtree group-affine, by each package's quantize_tree),
    "int8" (that q4 subtree requantised to fused per-channel int8)."""
    if kind == "bf16":
        jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        return jb, to_torch(jb, torch.bfloat16)
    tp = to_torch(jp)
    jq = dict(jp, llm=jquant.quantize_tree(jp["llm"], bits=4))
    tq = dict(tp, llm=tquant.quantize_tree(tp["llm"], bits=4))
    if kind == "q4":
        return jq, tq
    return (dict(jp, llm=jquant.requantize_tree_int8(jq["llm"])),
            dict(tp, llm=tquant.requantize_tree_int8(tq["llm"])))


def test_params_from_numpy_packed_words_and_fsmn(rng):
    """uint32 words become int32 with the same bits and group scales stay
    f32 at bf16; the FSMN weight (K, 1, C) becomes (C, 1, K), and the
    depthwise conv over it equals the JAX package's shifted FMAs."""
    w = rng.standard_normal((8, 128)).astype(np.float32)
    q = jquant.quantize_array(w, 4)
    q["weight_q4"][0, 0] = 0xF0000001  # bit 31 set
    tq = params_from_numpy({"lin": q}, device="cpu", dtype=torch.bfloat16)["lin"]
    assert tq["weight_q4"].dtype == torch.int32 and tq["scales"].dtype == torch.float32
    np.testing.assert_array_equal(tq["weight_q4"].numpy(), q["weight_q4"].view(np.int32))
    np.testing.assert_array_equal(tquant.unpack_uint32(tq["weight_q4"], 4).numpy(),
                                  np.asarray(jquant.unpack_uint32(jnp.asarray(q["weight_q4"]), 4)))

    k, c = 5, 16
    fsmn = {"weight": rng.standard_normal((k, 1, c)).astype(np.float32)}
    conv = params_from_numpy({"self_attn": {"fsmn_block": fsmn}}, device="cpu")
    weight = conv["self_attn"]["fsmn_block"]["weight"]
    assert tuple(weight.shape) == (c, 1, k)
    x = rng.standard_normal((2, 12, c)).astype(np.float32)
    ref = jlayers.depthwise_conv1d_shifted({"weight": jnp.asarray(fsmn["weight"])},
                                           jnp.asarray(x), padding=(2, 2))
    got = tlayers.conv1d({"weight": weight}, torch.from_numpy(x), padding=(2, 2), groups=c)
    close(got, ref)


@pytest.mark.parametrize("seconds", [1.0, 2.37])
def test_funasr_features_match(rng, seconds):
    audio = (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)
    ref = jfront.funasr_features(jnp.asarray(audio))
    close(tfront.funasr_features(torch.from_numpy(audio)), ref)


def test_encode_and_adapt_match(rng, jparams, jax_kernels):
    """SANM with padded frames (lengths 18 and 11 of 20), the adaptor on
    the result, and the adaptor with fused int8 q/k/v (the w8a8 tree's)."""
    tp = to_torch(jparams)
    feats = rng.standard_normal((2, 20, 560)).astype(np.float32)
    lengths = np.array([18, 11])
    ref = jm.encode(jparams["encoder"], JCFG.encoder, jnp.asarray(feats), jnp.asarray(lengths))
    got = tm.encode(tp["encoder"], TCFG.encoder, torch.from_numpy(feats),
                    torch.from_numpy(lengths))
    close(got, ref)
    ra, rl = jm.adapt(jparams["adaptor"], JCFG.adaptor, ref, jnp.asarray(lengths))
    ga, gl = tm.adapt(tp["adaptor"], TCFG.adaptor, got, torch.from_numpy(lengths))
    close(ga, ra)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
    jq = jquant.fuse_int8_tree(jquant.quantize_tree_int8(jparams["adaptor"]))
    assert "qkv" in jq["blocks"]["0"]["attn"]
    ra, _ = jm.adapt(jq, JCFG.adaptor, ref, jnp.asarray(lengths))
    ga, _ = tm.adapt(to_torch(jq), TCFG.adaptor, torch.from_numpy(np.asarray(ref)),
                     torch.from_numpy(lengths))
    close(ga, ra)


@pytest.mark.parametrize("kind", ["bf16", "q4", "int8"])
def test_generate_tokens_match(rng, jparams, jax_fused, jax_kernels, kind):
    """Greedy tokens of FunASRGenerator, exact: the bf16 and int8 trees
    decode through the whole-stack step (the JAX kernel in interpret mode,
    the port's plain version), the q4 tree through the per-layer path and
    the q4 product's plain version."""
    jp, tp = trees(jparams, kind)
    feats = rng.standard_normal((20, 560)).astype(np.float32)
    gen = tm.FunASRGenerator(tp, TCFG, max_cache=256)
    assert gen.fused == (kind != "q4")
    got = gen.generate([1, 2, 3], [4, 5], feats, eos_ids=(7,), max_new=12)
    ref = jm.FunASRGenerator(jp, JCFG, max_cache=256).generate([1, 2, 3], [4, 5], feats,
                                                               eos_ids=(7,), max_new=12)
    assert len(set(ref)) > 3  # the decoder does not repeat one token
    assert got == ref


def test_engine_text_matches(jparams, jax_fused, jax_kernels):
    """STT.funasr's engine on the int8 tree: transcribe, translate and
    transcribe_streaming give the JAX engine's text."""
    jp, tp = trees(jparams, "int8")
    audio = (0.1 * np.sin(np.linspace(0, 400 * np.pi, 16000))).astype(np.float32)
    assert isinstance(STT.funasr(), tstt.FunASREngine)
    eng = tstt.FunASREngine.from_params(tp, TCFG, max_cache=768)
    ref_eng = jstt.FunASREngine.from_params(jp, JCFG, max_cache=768)
    assert eng._eos_ids == ref_eng._eos_ids == (2,)
    res = eng.transcribe(audio, language="en", max_new_tokens=8)
    assert res.text == ref_eng.transcribe(audio, language="en", max_new_tokens=8).text
    assert res.duration == pytest.approx(1.0) and res.segments[0].text == res.text
    half = audio[:8000]
    assert (eng.translate(half, target_language="es", max_new_tokens=8).text
            == ref_eng.translate(half, target_language="es", max_new_tokens=8).text)
    assert (list(eng.transcribe_streaming(half, max_new_tokens=8))
            == list(ref_eng.transcribe_streaming(half, max_new_tokens=8)))
    assert tstt.build_prompt_text("translate", "de", "fr") == jstt.build_prompt_text(
        "translate", "de", "fr")
    assert tstt.clean_output("<|im_start|>hi<|im_end|> ") == "hi"


def test_engine_defaults_fit_the_default_request(jparams):
    """ROADMAP C1: `from_params` with every default serves the default
    request, a byte-level prompt of ~260 slots plus max_new_tokens 256:
    transcribe, translate and warmup run, the cache sized per request."""
    eng = tstt.FunASREngine.from_params(to_torch(jparams), TCFG)
    assert eng.generator.max_cache is None
    audio = (0.1 * np.sin(np.linspace(0, 400 * np.pi, 16000))).astype(np.float32)
    assert isinstance(eng.transcribe(audio).text, str)
    assert isinstance(eng.translate(audio).text, str)
    assert set(eng.warmup()) == {"short"}


def test_checkpoints_and_tokenizer_files_raise(tmp_path, monkeypatch):
    """No checkpoint in an empty cache: ModelLoadError naming the repo; a
    tokenizer.json the reader cannot take: ValueError; no file: the stand-in."""
    monkeypatch.setenv("TPU_AUDIO_CACHE", str(tmp_path / "empty"))
    with pytest.raises(ModelLoadError, match="Fun-ASR-Nano-4bit"):
        STT.funasr().load()
    (tmp_path / "tokenizer.json").write_text("{}")
    with pytest.raises(ValueError, match="tokenizer.json"):
        load_tokenizer(str(tmp_path))
    assert load_tokenizer(None).encode("<|im_end|>") == list(b"<|im_end|>")


def test_generator_refuses_a_prompt_past_the_cache(jparams):
    gen = tm.FunASRGenerator(to_torch(jparams), TCFG, max_cache=64)
    with pytest.raises(ValueError, match="max_cache"):
        gen.generate(list(range(40)), [4, 5], np.zeros((20, 560), np.float32), eos_ids=(7,),
                     max_new=16)


def test_slice_modules_import_without_jax_nvcc_or_cuda():
    """The slice's modules import with jax blocked and no nvcc or card,
    and build nothing at import."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from tpu_audio_torch.api import stt_funasr\n"
        "from tpu_audio_torch.models.funasr import model\n"
        "from tpu_audio_torch.nn import rope, transformer\n"
        "from tpu_audio_torch.ops import decoding, frontends, quant, sampling\n"
        "from tpu_audio_torch.ops.kernels import _build, fused_step, quant_matmul\n"
        "assert _build._lib is None\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'tpu_audio']\n"
        "print('ok')\n")
    env = {**os.environ, "PATH": "/nonexistent", "CUDA_HOME": "/nonexistent",
           "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
