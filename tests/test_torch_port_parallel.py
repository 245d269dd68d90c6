"""PyTorch port, parallel/ (mesh, sharding rules, sequence-parallel encode)
and `training.train` over a mesh, against the JAX package's rules and the
port's own single-process results, on the CPU.

One module-scoped spawn of 2 gloo ranks (a `FileStore` under tmp_path)
computes, at the training tests' TINY config on the port's own seeded
init: the meshes `make_mesh` builds; the tp = 2 forward of the training
route (`encode_xla` + `forward_cross_qk` on `shard_tree(whisper_rules)`
leaves); `encode_sequence_parallel` at sp = 2; `train` for 3 AdamW steps at
dp = 2 and at tp = 2 on a batch whose rows carry unequal masks (so the two
dp ranks hold different token counts, ROADMAP A19's fault of a mean of
per-rank means); and `param_shardings` of the three rule sets on the
(1, 2) mesh. The tests hold these against the same computations in this
process without a mesh. Tolerances: forward outputs within 2e-5 of their
largest |value| (the sum over tp reorders the row-parallel products); the
losses within 1e-5; each trained leaf's update within 1e-3 of its norm, as
in tests/test_torch_port_training.py.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401
from tpu_audio.parallel import shardings as jsh
from tpu_audio_torch.codecs.s3gen import model as ts3gen
from tpu_audio_torch.convert import params_from_numpy, s3_params_from_numpy, s3_perm
from tpu_audio_torch.models.cosyvoice3 import model as tcv3
from tpu_audio_torch.models.whisper import model as wmodel
from tpu_audio_torch.models.whisper.config import WhisperConfig
from tpu_audio_torch.nn import transformer as tt
from tpu_audio_torch.parallel import (flow_rules, make_mesh, param_shardings, shard_tree,
                                      transformer_rules, whisper_rules)
from tpu_audio_torch.parallel.shardings import P, _spec_for
from tpu_audio_torch.parallel.sp import encode_sequence_parallel
from tpu_audio_torch.training import Batcher, Example, train
from tpu_audio_torch.training.whisper import adamw
from tpu_audio_torch.utils import pytree

CFG = WhisperConfig(n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
                    n_audio_layer=2, n_vocab=128, n_text_ctx=16, n_text_state=64,
                    n_text_head=4, n_text_layer=2)
WORLD = 2
FWD_REL = 2e-5
LOSS_REL = 1e-5
UPDATE_REL = 1e-3
LR = 3e-3
STEPS = 3


def mel_and_tokens():
    rng = np.random.default_rng(1)
    mel = torch.from_numpy((rng.standard_normal((2, 2 * CFG.n_audio_ctx, CFG.n_mels)) * 0.5
                            ).astype(np.float32))
    return mel, torch.from_numpy(rng.integers(0, CFG.n_vocab, (2, 9)))


def batcher():
    """4-row batches whose halves (the dp ranks' rows) hold unequal masks."""
    rng = np.random.default_rng(7)
    ex = [Example(mel=(rng.standard_normal((2 * CFG.n_audio_ctx, CFG.n_mels)) * 0.5
                       ).astype(np.float32),
                  tokens=rng.integers(3, CFG.n_vocab, n).astype(np.int32))
          for n in (5, 14, 8, 11, 16, 4, 12, 7)]
    return Batcher(ex, batch_size=4, max_tokens=16, seed=2)


def rule_trees() -> dict:
    """{name: (rules, tree in the JAX layout (numpy), the port's tree, the
    conversion's perm of a leaf)} for the three rule sets."""
    from tests.test_torch_port_cosyvoice3 import flow_configs
    from tests.test_torch_port_s3 import s3gen_configs

    tcfg = tt.TransformerConfig(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128,
                                vocab_size=97)
    s3cfg, cv3cfg = s3gen_configs()[1], flow_configs()[1]
    whisper = wmodel.numpy_params(np.random.default_rng(0), CFG)
    llm = tt.numpy_params(np.random.default_rng(0), tcfg)
    s3 = {"s3gen": ts3gen.numpy_params(np.random.default_rng(0), s3cfg),
          "cv3": tcv3.numpy_params(np.random.default_rng(0), cv3cfg)}

    def conv_perm(key, rank):
        return (2, 1, 0) if ".conv" in key and key.endswith("weight") and rank == 3 else None

    return {"whisper": (whisper_rules, jsh.whisper_rules, whisper,
                        params_from_numpy(whisper, "cpu"), conv_perm),
            "transformer": (transformer_rules, jsh.transformer_rules, llm,
                            params_from_numpy(llm, "cpu"), lambda key, rank: None),
            "flow": (flow_rules, jsh.flow_rules, s3, s3_params_from_numpy(s3, "cpu"), s3_perm)}


def _rank(rank: int, store: str, out: str) -> None:
    """One gloo rank: what the tests read, written by each rank to out.{rank}."""
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD)
    try:
        res = {"meshes": {name: (tuple(m.mesh.shape), m.mesh_dim_names, m.device_type)
                          for name, m in (("default", make_mesh()), ("dp2", make_mesh(dp=2)),
                                          ("tp2", make_mesh(tp=2)))}}
        for dp, tp in ((2, 2), (3, None)):
            with pytest.raises(ValueError) as err:
                make_mesh(dp=dp, tp=tp)
            res[f"error {dp} {tp}"] = str(err.value)
        tp_mesh, dp_mesh = make_mesh(tp=2), make_mesh(dp=2)
        tree = wmodel.init_params(0, CFG, device="cpu")
        mel, tokens = mel_and_tokens()
        sharded = shard_tree(tree, tp_mesh, whisper_rules)
        res["q local"] = tuple(sharded["encoder"]["blocks"]["attn"]["q"]["weight"]
                               .to_local().shape)
        res["conv1 local"] = tuple(sharded["encoder"]["conv1"]["weight"].to_local().shape)
        from torch.distributed.tensor.experimental import implicit_replication

        with torch.no_grad(), implicit_replication():
            feats = wmodel.encode_xla(sharded, CFG, mel)
            logits, qk = wmodel.forward_cross_qk(sharded, CFG, tokens, feats)
        res["tp2"] = [t.full_tensor() for t in (feats, logits, qk)]
        sp = encode_sequence_parallel(tree, CFG, mel, tp_mesh)
        res["sp local"] = tuple(sp.to_local().shape)
        res["sp2"] = sp.full_tensor()
        for name, mesh in (("dp", dp_mesh), ("tp", tp_mesh)):
            trained, losses = train(tree, CFG, batcher(), STEPS, mesh=mesh, log_every=0,
                                    optimizer=lambda ps: adamw(ps, lr=LR))
            res[f"train {name}"] = (pytree.flatten(trained), losses)
        res["placements"] = {name: pytree.flatten(param_shardings(port, tp_mesh, rules))
                             for name, (rules, _, _, port, _) in rule_trees().items()}
        torch.save(res, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo")
    torch.multiprocessing.spawn(_rank, args=(str(d / "store"), str(d / "out")), nprocs=WORLD)
    return [torch.load(d / f"out.{r}", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def tree():
    return wmodel.init_params(0, CFG, device="cpu")


def close(got, ref, rel):
    assert got.shape == ref.shape
    assert (got - ref).abs().max() <= rel * ref.abs().max()


def test_make_mesh_shapes_and_refusals(gloo):
    for res in gloo:
        assert res["meshes"] == {"default": ((1, 2), ("dp", "tp"), "cpu"),
                                 "dp2": ((2, 1), ("dp", "tp"), "cpu"),
                                 "tp2": ((1, 2), ("dp", "tp"), "cpu")}
        assert res["error 2 2"] == "dp(2)×tp(2) != device count 2"
        assert res["error 3 None"] == "dp(3)×tp(0) != device count 2"


def test_make_mesh_world_of_one():
    """No process group: the mesh is this process alone, on a HashStore."""
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(devices="cpu")
        assert (tuple(mesh.mesh.shape), mesh.mesh_dim_names) == ((1, 1), ("dp", "tp"))
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert tuple(make_mesh(dp=1).mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match=r"dp\(2\)×tp\(0\) != device count 1"):
            make_mesh(dp=2)
    finally:
        dist.destroy_process_group()


def test_tp2_forward_matches_replicated(gloo, tree):
    mel, tokens = mel_and_tokens()
    with torch.no_grad():
        feats = wmodel.encode_xla(tree, CFG, mel)
        logits, qk = wmodel.forward_cross_qk(tree, CFG, tokens, feats)
    for res in gloo:
        assert res["q local"] == (CFG.n_audio_layer, CFG.n_audio_state // 2, CFG.n_audio_state)
        assert res["conv1 local"] == (CFG.n_audio_state // 2, CFG.n_mels, 3)  # (O, I, K) on O
        for got, ref in zip(res["tp2"], (feats, logits, qk)):
            close(got, ref, FWD_REL)


def test_sp2_encode_matches_encode(gloo, tree):
    mel, _ = mel_and_tokens()
    with torch.no_grad():
        ref = wmodel.Whisper(CFG, tree).encode(mel)
    for res in gloo:
        assert res["sp local"] == (2, CFG.n_audio_ctx // 2, CFG.n_audio_state)
        close(res["sp2"], ref, FWD_REL)


@pytest.mark.parametrize("axis", ["dp", "tp"])
def test_train_over_a_mesh_matches_one_process(gloo, tree, axis):
    batch = next(batcher().batches(epochs=1))
    halves = batch["mask"].reshape(2, -1).sum(axis=1)
    assert halves[0] != halves[1], halves  # the dp ranks hold unequal token counts
    trained, losses = train(tree, CFG, batcher(), STEPS, log_every=0,
                            optimizer=lambda ps: adamw(ps, lr=LR))
    start, ref = pytree.flatten(tree), pytree.flatten(trained)
    for res in gloo:
        got, got_losses = res[f"train {axis}"]
        np.testing.assert_allclose(got_losses, losses, rtol=LOSS_REL, atol=0)
        assert got.keys() == ref.keys()
        for k, v in got.items():
            assert (v - ref[k]).norm() <= UPDATE_REL * (ref[k] - start[k]).norm(), k


def test_a_mean_of_per_rank_means_is_another_loss(tree):
    """What the dp test guards against: on this batch the mean of the two
    halves' masked means is another number than the global masked mean, by
    more than 10× the dp test's tolerance on the losses (1.4e-4 of it at
    init, where every token's loss is near ln 128)."""
    from tpu_audio_torch.training.data import put
    from tpu_audio_torch.training.whisper import loss_fn

    b = put(next(batcher().batches(epochs=1)), "cpu")
    with torch.no_grad():
        whole = loss_fn(tree, CFG, b["mel"], b["tokens_in"], b["tokens_out"], b["mask"])
        halves = [loss_fn(tree, CFG, *(b[k][s] for k in ("mel", "tokens_in", "tokens_out",
                                                          "mask")))
                  for s in (slice(0, 2), slice(2, 4))]
    assert abs(sum(halves).item() / 2 - whole.item()) > 10 * LOSS_REL * whole.item()


@pytest.mark.parametrize("name", ["whisper", "transformer", "flow"])
def test_specs_and_placements_against_jax(gloo, name):
    """Every leaf's spec against the JAX `_spec_for` on the same path,
    turned by the conversion's permutation of that leaf; its placements on
    the (1, 2) mesh: Shard(the dim the spec gives "tp") on tp, Replicate on dp."""
    from torch.distributed.tensor import Replicate, Shard

    rules, jrules, jtree, port, perm = rule_trees()[name]
    jflat, flat = pytree.flatten(jtree), pytree.flatten(port)
    assert jflat.keys() == flat.keys()
    sharded = 0
    for k, v in flat.items():
        jspec = jsh._spec_for(k, jflat[k], jrules, ("blocks", "layers"))
        order = perm(k, v.dim()) or tuple(range(v.dim()))
        want = P(*(jspec[i] for i in order))
        assert _spec_for(k, v, rules, ("blocks", "layers")) == want, k
        tp_dim = [Shard(want.index("tp"))] if "tp" in want else [Replicate()]
        for res in gloo:
            assert res["placements"][name][k] == (Replicate(), *tp_dim), k
        sharded += "tp" in want
    assert sharded == {"whisper": 28, "transformer": 7, "flow": 55}[name], sharded
