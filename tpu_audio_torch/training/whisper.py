"""Whisper fine-tuning step (port of tpu_audio/training/whisper.py):
cross-entropy over decoder tokens with teacher forcing, AdamW.

The step differentiates the training route (`models/whisper/model.
encode_xla`, `forward_cross_qk`): the JAX XLA formulation, which is what
`jax.value_and_grad` differentiates in the JAX package, since none of its
kernels has a backward. The kernels serve the trained tree
(`data.evaluate`). Leaves may be DTensors (`parallel.shard_tree`); the
batch then shards over dp (`data.shard`), and the loss stays the global
masked mean.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from tpu_audio_torch.models.whisper import model as wmodel
from tpu_audio_torch.models.whisper.config import WhisperConfig


def _params(model_or_tree):
    """A `Whisper` as the tree its training route reads; a tree as it is."""
    return model_or_tree.tree() if isinstance(model_or_tree, wmodel.Whisper) else model_or_tree


def loss_fn(model_or_tree, cfg: WhisperConfig, mel, tokens_in, tokens_out, mask):
    """mel (B, 2·n_audio_ctx, n_mels); tokens (B, T) int64; mask (B, T) 1
    for real tokens → sum(nll·mask) / max(sum(mask), 1), the log-softmax
    taken in f32 (f64 for f64 logits). The sums run over the whole batch
    before the division, also where its rows are sharded over dp."""
    params = _params(model_or_tree)
    mel = mel.to(params["encoder"]["conv1"]["weight"].dtype)
    with implicit_replication():  # constants (positions, masks) beside DTensor leaves
        feats = wmodel.encode_xla(params, cfg, mel)
        logits, _ = wmodel.forward_cross_qk(params, cfg, tokens_in, feats)
        logp = torch.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), -1)
        nll = -torch.gather(logp, -1, tokens_out[..., None])[..., 0]
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)


def adamw(params, lr: float = 1e-5, weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW with optax's betas (0.9, 0.999) and eps 1e-8, at the JAX
    `make_train_step`'s default decay 0.01. optax's own `adamw` default is
    1e-4 and torch's 1e-2: a port of `optax.adamw(lr)` passes 1e-4."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def make_train_step(cfg: WhisperConfig, optimizer=None):
    """(init_opt, train_step). `optimizer`: a callable from the named
    parameters to a `torch.optim.Optimizer`; default `adamw` (lr 1e-5,
    decay 0.01, the JAX default). `init_opt(params)` takes a trainable
    `ParamTree` (`requires_grad_(True)`); `train_step(params, opt, batch)`
    zeroes the gradients, computes the loss, back-propagates, brings each
    DTensor gradient to its leaf's placement (the sum over dp), steps, and
    returns the loss as a 0-d tensor; the host reads it when it asks."""
    optimizer = optimizer or adamw

    def init_opt(params):
        return optimizer(list(params.named_parameters()))

    def train_step(params, opt, batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, cfg, batch["mel"], batch["tokens_in"],
                       batch["tokens_out"], batch["mask"])
        loss.backward()
        for p in params.parameters():
            if isinstance(p.grad, DTensor) and p.grad.placements != p.placements:
                p.grad = p.grad.redistribute(p.device_mesh, p.placements)
        opt.step()
        return loss.detach()

    return init_opt, train_step
