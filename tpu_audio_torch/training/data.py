"""Fine-tuning data pipeline and loop (port of tpu_audio/training/data.py):
(audio, transcript) pairs → static-shape batches for
`whisper.make_train_step`.

Every batch has identical shapes (the mel at the model's 30 s window, token
tensors padded to a fixed `max_tokens` with a loss mask), as in the JAX
package. Host-side work (mel, tokenization, shuffling) is NumPy; the
`Batcher` draws from the same `default_rng(seed)` stream as the JAX one, so
both yield the same batches in the same order. `shard` places a batch over
a (dp, tp) mesh with rows on dp.

The trained tree is served by a `Whisper` built from it (`evaluate`): a
`Whisper` keeps packed copies of its attention weights, which an update of
the leaves in place would leave stale.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch

from tpu_audio_torch.models.whisper.config import WhisperConfig

SAMPLE_RATE = 16000


@dataclass
class Example:
    """One training utterance, already featurized to static shapes."""
    mel: np.ndarray        # (2*n_audio_ctx, n_mels) f32
    tokens: np.ndarray     # (<= max_tokens+1,) int32 incl. SOT..EOT


def featurize(audio: np.ndarray, sample_rate: int, text: str, tokenizer,
              cfg: WhisperConfig, language: str = "en",
              task: str = "transcribe", device: torch.device | str = "cuda") -> Example:
    """Raw audio + transcript → Example (NumPy in and out; the mel is
    computed on `device`, the card unless the caller asks for the CPU).

    Audio is resampled to 16 kHz, padded/trimmed to the model's 30 s
    window; the token stream is [sot, lang, task] + text + [eot]."""
    from tpu_audio_torch.ops import frontends
    from tpu_audio_torch.ops.resample import resample

    if sample_rate != SAMPLE_RATE:
        audio = resample(audio, sample_rate, SAMPLE_RATE)
    want = 2 * cfg.n_audio_ctx * 160  # hop 160, mel drops the last frame
    if len(audio) < want:
        audio = np.pad(audio.astype(np.float32), (0, want - len(audio)))
    else:
        audio = audio[:want].astype(np.float32)
    mel = frontends.whisper_log_mel(torch.from_numpy(audio).to(device),
                                    n_mels=cfg.n_mels).cpu().numpy()
    sot_seq = list(tokenizer.sot_sequence(language=language, task=task))
    toks = sot_seq + list(tokenizer.encode(" " + text.strip())) + [tokenizer.eot]
    return Example(mel=mel, tokens=np.asarray(toks, np.int32))


@dataclass
class Batcher:
    """Static-shape batches with shuffling; drops examples whose token
    stream exceeds max_tokens (loudly, once)."""
    examples: Sequence[Example]
    batch_size: int
    max_tokens: int = 128
    seed: int = 0

    def __post_init__(self):
        dropped = [i for i, e in enumerate(self.examples)
                   if len(e.tokens) > self.max_tokens + 1]
        if dropped:
            from tpu_audio_torch.utils.logging import get_logger

            get_logger("training").warning(
                "Batcher: dropping %d/%d examples longer than max_tokens=%d",
                len(dropped), len(self.examples), self.max_tokens)
        self._pool = [e for e in self.examples
                      if len(e.tokens) <= self.max_tokens + 1]
        if not self._pool:
            raise ValueError("no examples fit max_tokens")

    def batches(self, epochs: int | None = None) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(self._pool))
            for start in range(0, len(order) - self.batch_size + 1,
                               self.batch_size):
                idx = order[start:start + self.batch_size]
                yield self._collate([self._pool[i] for i in idx])
            epoch += 1

    def _collate(self, batch: list[Example]) -> dict:
        b, t = len(batch), self.max_tokens
        mel = np.stack([e.mel for e in batch])
        tin = np.zeros((b, t), np.int32)
        tout = np.zeros((b, t), np.int32)
        mask = np.zeros((b, t), np.float32)
        for i, e in enumerate(batch):
            n = len(e.tokens) - 1
            tin[i, :n] = e.tokens[:-1]
            tout[i, :n] = e.tokens[1:]
            mask[i, :n] = 1.0
        return {"mel": mel.astype(np.float32), "tokens_in": tin,
                "tokens_out": tout, "mask": mask}


def _tensor(v, device) -> torch.Tensor:
    """A batch entry as a tensor on `device`; token ids as int64."""
    t = torch.as_tensor(v, device=device)
    return t.long() if not t.is_floating_point() else t


def put(batch: dict, device) -> dict:
    """A host batch as tensors on `device`."""
    return {k: _tensor(v, device) for k, v in batch.items()}


def shard(batch: dict, mesh) -> dict:
    """Place a host batch on a (dp, tp) mesh: rows sharded over dp,
    replicated over tp (each rank passes the whole batch)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    place = [Shard(0) if name == "dp" else Replicate() for name in mesh.mesh_dim_names]
    return {k: distribute_tensor(_tensor(v, mesh.device_type), mesh, place)
            for k, v in batch.items()}


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole; a tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


@torch.no_grad()
def evaluate_model(model, batches: Iterator[dict], max_batches: int = 8) -> dict:
    """Teacher-forced eval of a `Whisper` as it stands: its `encode` (the
    kernels on the card) and `forward_cross_qk`; mean loss and next-token
    accuracy over the mask, per batch, then over batches."""
    dtype = model.encoder["conv1"]["weight"].dtype
    losses, accs = [], []
    for i, b in enumerate(batches):
        if i >= max_batches:
            break
        b = put(b, model.device)
        feats = model.encode(b["mel"].to(dtype))
        logits, _ = model.forward_cross_qk(b["tokens_in"], feats)
        logp = torch.log_softmax(logits.float(), -1)
        nll = -torch.gather(logp, -1, b["tokens_out"][..., None])[..., 0]
        hits = (logits.argmax(-1) == b["tokens_out"]).float()
        denom = torch.clamp(b["mask"].sum(), min=1)
        losses.append(float((nll * b["mask"]).sum() / denom))
        accs.append(float((hits * b["mask"]).sum() / denom))
    return {"loss": float(np.mean(losses)), "token_acc": float(np.mean(accs)),
            "batches": len(losses)}


def evaluate(params, cfg: WhisperConfig, batches: Iterator[dict],
             max_batches: int = 8) -> dict:
    """Teacher-forced eval: mean loss + next-token accuracy over the mask.
    Serves the tree as the engines do, through a `Whisper` built from it:
    on the card a bf16 copy (`convert.serving_dtype`), so `encode` runs the
    fused bf16 encoder kernels; on the CPU the f32 tree."""
    from tpu_audio_torch.convert import serving_dtype, tree_device
    from tpu_audio_torch.models.whisper.model import Whisper
    from tpu_audio_torch.utils import pytree

    dtype = serving_dtype(tree_device(params))
    served = pytree.unflatten({k: _full(v).detach().to(dtype)
                               for k, v in pytree.flatten(params).items()})
    return evaluate_model(Whisper(cfg, served), batches, max_batches)


def train(params, cfg: WhisperConfig, batcher: Batcher, steps: int,
          optimizer=None, mesh=None, eval_every: int = 0,
          log_every: int = 10) -> tuple[dict, list[float]]:
    """Minimal training loop around `whisper.make_train_step`.

    The caller's tree is not updated: the loop trains a copy (a
    `ParamTree` made trainable). mesh: optional (dp, tp) `DeviceMesh`:
    leaves are sharded with `whisper_rules` and batches over dp (`shard`);
    every rank passes the same tree and batcher. The host reads the loss
    once a step. Returns (trained tree, whole leaves on the tree's device;
    per-step losses)."""
    from tpu_audio_torch.models.whisper.model import ParamTree
    from tpu_audio_torch.training.whisper import make_train_step
    from tpu_audio_torch.utils import pytree
    from tpu_audio_torch.utils.logging import get_logger

    log = get_logger("training")
    device = next(iter(pytree.flatten(params).values())).device
    tree = pytree.unflatten({k: v.detach().clone() for k, v in pytree.flatten(params).items()})
    if mesh is not None:
        from tpu_audio_torch.parallel import shard_tree, whisper_rules

        tree = shard_tree(tree, mesh, whisper_rules)
    model = ParamTree(tree).requires_grad_(True)
    init_opt, train_step = make_train_step(cfg, optimizer)
    opt = init_opt(model)

    def trained() -> dict:
        return pytree.unflatten({k: _full(v.detach()).to(device)
                                 for k, v in model.named_parameters()})

    losses: list[float] = []
    it = batcher.batches(epochs=None)
    for step in range(steps):
        batch = next(it)
        batch = shard(batch, mesh) if mesh is not None else put(batch, device)
        losses.append(float(_full(train_step(model, opt, batch))))
        if log_every and step % log_every == 0:
            log.info("step %d loss %.4f", step, losses[-1])
        if eval_every and step and step % eval_every == 0:
            m = evaluate(trained(), cfg, batcher.batches(epochs=1))
            log.info("eval @%d: loss %.4f acc %.3f", step, m["loss"], m["token_acc"])
    return trained(), losses
