"""PyTorch port, Whisper fine-tuning (training/) against the JAX package's
training/ on the CPU, at the JAX test's TINY config (tests/test_training.py).

The same weights (the JAX init moved by `convert.params_from_numpy`: conv
kernels (K, I, O) → (O, I, K)) and the same numpy-seeded batch, with an
unequal mask, go through both packages' `loss_fn`; the port differentiates
its training route (`encode_xla`, `forward_cross_qk`), the JAX package
`jax.value_and_grad` of its XLA formulation (no JAX kernel runs on the
CPU). Tolerances: the loss and each leaf's gradient within 1e-5 of the
largest |value| of the JAX leaf (f32 products over a few hundred terms).
After 3 AdamW steps (lr 3e-3), each leaf's update within 1e-3 of its norm
(the norm of the difference): the first Adam steps move an element by
about lr · sign(g), so an element whose gradient lies within the two
packages' f32 rounding of zero may move otherwise (at most 4.8e-5 off
here, in 1-4 of a leaf's elements; the others within 2e-6).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401
from tpu_audio.models.whisper import model as jmodel
from tpu_audio.models.whisper.config import WhisperConfig as JConfig
from tpu_audio.training import Batcher as JBatcher
from tpu_audio.training import Example as JExample
from tpu_audio.training import evaluate as jevaluate
from tpu_audio.training import featurize as jfeaturize
from tpu_audio.training import make_train_step as jmake_train_step
from tpu_audio.training.whisper import loss_fn as jloss_fn
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.whisper import model as wmodel
from tpu_audio_torch.models.whisper.config import WhisperConfig
from tpu_audio_torch.models.whisper.tokenizer import BPE, WhisperTokenizer
from tpu_audio_torch.ops.kernels import _build
from tpu_audio_torch.training import Batcher, Example, evaluate, featurize, make_train_step, train
from tpu_audio_torch.training.data import evaluate_model, put
from tpu_audio_torch.training.whisper import adamw, loss_fn
from tpu_audio_torch.utils import pytree

DIMS = dict(n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
            n_vocab=128, n_text_ctx=16, n_text_state=64, n_text_head=4, n_text_layer=2)
TINY, JTINY = WhisperConfig(**DIMS), JConfig(**DIMS)
GRAD_REL = 1e-5
UPDATE_REL = 1e-3


def synthetic_examples(rng, n=6, tok_len=8, cls=Example):
    """tests/test_training.py's overfittable set: distinct random mels, each
    mapped to a distinct token pattern."""
    out = []
    for i in range(n):
        mel = rng.standard_normal((2 * TINY.n_audio_ctx, TINY.n_mels)) * 0.5
        toks = np.concatenate([[1], 10 + (np.arange(tok_len) * (i + 2)) % (TINY.n_vocab - 12),
                               [2]]).astype(np.int32)
        out.append(cls(mel=mel.astype(np.float32), tokens=toks))
    return out


def uneven_examples(rng, lengths=(5, 11, 8, 14)):
    """Examples whose token streams differ in length: the batch's rows then
    carry unequal masks."""
    return [Example(mel=(rng.standard_normal((2 * TINY.n_audio_ctx, TINY.n_mels)) * 0.5
                         ).astype(np.float32),
                    tokens=rng.integers(3, TINY.n_vocab, n).astype(np.int32))
            for n in lengths]


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(jax.random.PRNGKey(0), JTINY)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def batch():
    ex = uneven_examples(np.random.default_rng(7))
    b = Batcher(ex, batch_size=4, max_tokens=16, seed=3)
    out = next(b.batches(epochs=1))
    assert len(set(out["mask"].sum(axis=1).tolist())) == 4
    return out


def as_jax_layout(flat: dict) -> dict:
    """The port's leaves in the JAX layout: conv kernels back to (K, I, O)."""
    return {k: v.permute(2, 1, 0) if ".conv" in k and k.endswith("weight") else v
            for k, v in flat.items()}


def trainable(params):
    return wmodel.ParamTree(pytree.unflatten(
        {k: v.clone() for k, v in pytree.flatten(params).items()})).requires_grad_(True)


def test_loss_and_every_gradient_match_jax(jparams, params, batch):
    jl, jg = jax.value_and_grad(jloss_fn)(jparams, JTINY, *(jnp.asarray(batch[k]) for k in (
        "mel", "tokens_in", "tokens_out", "mask")))
    tree = trainable(params)
    tb = put(batch, "cpu")
    loss = loss_fn(tree, TINY, tb["mel"], tb["tokens_in"], tb["tokens_out"], tb["mask"])
    loss.backward()
    assert abs(loss.item() - float(jl)) <= GRAD_REL * abs(float(jl))
    grads = as_jax_layout({k: p.grad for k, p in tree.named_parameters()})
    jflat = pytree.flatten(jax.tree_util.tree_map(np.asarray, jg))
    assert set(grads) == set(jflat) and len(grads) == 49
    for k, g in grads.items():
        ref = jflat[k]
        assert g.shape == ref.shape, k
        assert np.abs(ref).max() > 0, k
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=GRAD_REL * np.abs(ref).max(),
                                   err_msg=k)


def test_training_route_launches_no_kernel(params, batch, monkeypatch):
    """The route reaches no wrapper of ops/kernels, so no kernel on a card:
    every wrapper's device rule is made to raise."""
    def refuse(name, *tensors):
        raise AssertionError(f"{name} reached on the training route")

    monkeypatch.setattr(_build, "require_cuda", refuse)
    from tpu_audio_torch.ops.kernels import encoder_attention as ea
    from tpu_audio_torch.ops.kernels import fused_encoder as fe
    for mod, name in ((ea, "encoder_attention"), (ea, "encoder_attention_packed"),
                      (fe, "ln_qkv"), (fe, "attn_oproj_ln")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: refuse(_n))
    cfg = WhisperConfig(**{**DIMS, "n_audio_ctx": 600})  # long enough for ea.supported
    tree = trainable(wmodel.init_params(0, cfg, device="cpu"))
    mel = torch.randn(1, 1200, 80)
    tb = put(batch, "cpu")
    loss = loss_fn(tree, cfg, mel, tb["tokens_in"][:1], tb["tokens_out"][:1], tb["mask"][:1])
    loss.backward()
    assert all(p.grad is not None for p in tree.parameters())


@pytest.mark.parametrize("decay", [0.01, 1e-4])
def test_three_steps_match_optax_adamw(jparams, params, decay):
    ex = uneven_examples(np.random.default_rng(11), lengths=(6, 12, 9, 15, 4, 10))
    batches = list(Batcher(ex, batch_size=2, max_tokens=16, seed=5).batches(epochs=1))
    assert len(batches) == 3
    init_j, step_j = jmake_train_step(JTINY, optax.adamw(3e-3, weight_decay=decay))
    step_j = jax.jit(step_j)
    jp, js = jparams, init_j(jparams)
    init_t, step_t = make_train_step(TINY, lambda ps: adamw(ps, lr=3e-3, weight_decay=decay))
    tree = trainable(params)
    opt = init_t(tree)
    for b in batches:
        jp, js, jl = step_j(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        loss = step_t(tree, opt, put(b, "cpu"))
        assert loss.dim() == 0 and abs(loss.item() - float(jl)) <= GRAD_REL * float(jl)
    got = {k: v.numpy() for k, v in as_jax_layout(
        {k: p.detach() for k, p in tree.named_parameters()}).items()}
    start = pytree.flatten(jax.tree_util.tree_map(np.asarray, jparams))
    for k, ref in pytree.flatten(jax.tree_util.tree_map(np.asarray, jp)).items():
        off = np.abs(got[k] - ref)
        assert np.linalg.norm(off) <= UPDATE_REL * np.linalg.norm(ref - start[k]), k


def test_default_optimizer_is_adamw_at_the_jax_default():
    opt = make_train_step(TINY)[0](trainable(wmodel.init_params(0, TINY, device="cpu")))
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW)
    assert (group["lr"], group["weight_decay"], group["betas"], group["eps"]) == (
        1e-5, 0.01, (0.9, 0.999), 1e-8)


def test_batcher_matches_jax_batches_order_and_drops(caplog):
    rng = np.random.default_rng(3)
    ex = synthetic_examples(rng, n=7) + uneven_examples(rng, lengths=(4, 40, 9, 30))
    jex = [JExample(mel=e.mel, tokens=e.tokens) for e in ex]
    with caplog.at_level("WARNING", logger="tpu_audio_torch.training"):
        b = Batcher(ex, batch_size=3, max_tokens=16, seed=4)
    assert "dropping 2/11" in caplog.text
    jb = JBatcher(jex, batch_size=3, max_tokens=16, seed=4)
    assert len(b._pool) == len(jb._pool) == 9
    got, ref = list(b.batches(epochs=2)), list(jb.batches(epochs=2))
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            assert g[k].dtype == r[k].dtype
            np.testing.assert_array_equal(g[k], r[k])
    with pytest.raises(ValueError, match="no examples fit"):
        Batcher(ex[-3:-2], batch_size=1, max_tokens=16)


def test_featurize_matches_jax_at_44k():
    tok = WhisperTokenizer(BPE({bytes([i]): i for i in range(256)}), True, 99)
    t = np.arange(44100 * 2) / 44100
    audio = (0.1 * np.sin(2 * np.pi * 440 * t) + 0.01 * np.random.default_rng(0)
             .standard_normal(t.size)).astype(np.float32)
    got = featurize(audio, 44100, "hello world", tok, TINY, language="de", device="cpu")
    ref = jfeaturize(audio, 44100, "hello world", tok, JTINY, language="de")
    assert got.mel.shape == ref.mel.shape == (2 * TINY.n_audio_ctx, TINY.n_mels)
    np.testing.assert_allclose(got.mel, ref.mel, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert got.tokens[:3].tolist() == tok.sot_sequence("de") and got.tokens[-1] == tok.eot


def test_evaluate_matches_jax(jparams, params):
    b = Batcher(uneven_examples(np.random.default_rng(5)), batch_size=2, max_tokens=16, seed=2)
    got = evaluate(params, TINY, b.batches(epochs=1))
    ref = jevaluate(jparams, JTINY, b.batches(epochs=1))
    assert got["batches"] == ref["batches"] == 2
    assert abs(got["loss"] - ref["loss"]) <= GRAD_REL * ref["loss"]
    assert got["token_acc"] == ref["token_acc"]


def test_overfit_synthetic_set(params):
    """tests/test_training.py's convergence check on the port: 60 steps of
    AdamW at 3e-3 (optax's default decay 1e-4) on 6 examples."""
    batcher = Batcher(synthetic_examples(np.random.default_rng(42)), batch_size=6,
                      max_tokens=16, seed=1)
    before = pytree.flatten(params)["encoder.conv1.weight"].clone()
    trained, losses = train(params, TINY, batcher, steps=60,
                            optimizer=lambda ps: adamw(ps, lr=3e-3, weight_decay=1e-4),
                            log_every=0)
    assert torch.equal(pytree.flatten(params)["encoder.conv1.weight"], before)  # a copy trained
    assert losses[0] > 2.0, losses[0]
    assert losses[-1] < 0.3, f"did not converge: {losses[0]:.3f} → {losses[-1]:.3f}"
    m = evaluate(trained, TINY, batcher.batches(epochs=1), max_batches=1)
    assert m["token_acc"] > 0.95, m


def test_evaluate_serves_a_fresh_model_and_a_stale_one_differs(params):
    """`evaluate` builds its `Whisper` from the tree it is given, so it reads
    the trained leaves; a `Whisper` built before the steps whose leaves are
    then updated in place keeps its packed QKV from before (ROADMAP C31)."""
    batcher = Batcher(uneven_examples(np.random.default_rng(9)), batch_size=2,
                      max_tokens=16, seed=0)
    trained, _ = train(params, TINY, batcher, steps=3,
                       optimizer=lambda ps: adamw(ps, lr=1e-2), log_every=0)
    got = evaluate(trained, TINY, batcher.batches(epochs=1))
    assert got == evaluate_model(wmodel.Whisper(TINY, trained), batcher.batches(epochs=1))
    stale = wmodel.Whisper(TINY, pytree.unflatten(
        {k: v.clone() for k, v in pytree.flatten(params).items()}))
    with torch.no_grad():
        for k, p in stale.tree()["encoder"].named_parameters(prefix="encoder"):
            p.copy_(pytree.flatten(trained)[k])
        for k, p in stale.tree()["decoder"].named_parameters(prefix="decoder"):
            p.copy_(pytree.flatten(trained)[k])
    assert evaluate_model(stale, batcher.batches(epochs=1))["loss"] != got["loss"]
    mel = put(next(batcher.batches(epochs=1)), "cpu")["mel"]
    fresh = wmodel.Whisper(TINY, trained).encode(mel)
    ref = wmodel.encode_xla(trained, TINY, mel)
    assert (fresh - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert (stale.encode(mel) - ref).abs().max() >= 0.1 * ref.abs().max()


def test_grad_guard_refuses_a_tensor_that_needs_a_gradient():
    """A kernel's output has no grad_fn: the wrappers' device rule refuses a
    tensor that requires a gradient under grad mode (ROADMAP C30), before it
    looks at devices; under no_grad the same call reaches the device rule."""
    w = torch.zeros(4, requires_grad=True)
    x = torch.zeros(4)
    with pytest.raises(RuntimeError, match="ln_qkv: the kernel has no backward"):
        _build.require_cuda("ln_qkv", x, w)
    with torch.no_grad(), pytest.raises(ValueError, match="expected CUDA tensors"):
        _build.require_cuda("ln_qkv", x, w)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        _build.require_cuda("ln_qkv", x, w.detach())
    with torch.inference_mode(), pytest.raises(ValueError, match="expected CUDA tensors"):
        _build.require_cuda("ln_qkv", x, w)


def test_trainable_tree_and_the_serving_default():
    tree = wmodel.ParamTree(wmodel.init_params(0, TINY, device="cpu"))
    assert not any(p.requires_grad for p in tree.parameters())
    tree.requires_grad_(True)
    assert all(p.requires_grad for p in tree.parameters())


def test_training_and_parallel_import_no_jax():
    code = ("import sys\n"
            "from tpu_audio_torch.training import (Batcher, Example, evaluate, featurize, "
            "make_train_step, shard, train)\n"
            "from tpu_audio_torch.training.whisper import loss_fn\n"
            "from tpu_audio_torch.parallel import (flow_rules, make_mesh, param_shardings, "
            "shard_tree, transformer_rules, whisper_rules)\n"
            "from tpu_audio_torch.parallel.sp import encode_sequence_parallel\n"
            "assert 'jax' not in sys.modules and 'tpu_audio' not in sys.modules\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
