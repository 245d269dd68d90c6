"""Sequence parallelism for long-audio encoding (port of
tpu_audio/parallel/sp.py).

The JAX package shards the mel's time axis and lets GSPMD insert the
collectives. Here they are written out: each rank of the mesh axis computes
its T/sp frames of the conv stem from the whole mel it holds (the conv
halos read locally), runs its rows through every block with the keys and
values all-gathered over the axis, and keeps its rows of the features.
Inference only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from tpu_audio_torch.models.whisper import model as wmodel
from tpu_audio_torch.nn.attention import attend
from tpu_audio_torch.nn.layers import conv1d, gelu, layer_norm, linear


def _stem_rows(p: dict, cfg, mel: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Output frames [r·n, (r+1)·n) of the stem: conv2 (stride 2, pad 1)
    reads conv1 frames 2rn − 1 … 2(r+1)n − 1, each of which reads mel frames
    one either side; a frame outside the sequence is conv padding (zero)."""
    lo, hi = 2 * r * n - 1, 2 * (r + 1) * n         # conv1 frames [lo, hi)
    a = max(lo, 0)
    m_lo, m_hi = a - 1, min(hi + 1, mel.shape[1])   # mel frames [m_lo, m_hi)
    seg = mel[:, max(m_lo, 0):m_hi]
    seg = F.pad(seg, (0, 0, max(-m_lo, 0), hi + 1 - m_hi))
    c1 = gelu(conv1d(p["conv1"], seg, stride=1, padding=0))  # frames [a, hi)
    c1 = F.pad(c1, (0, 0, a - lo, 0))                # conv2's left padding
    x = gelu(conv1d(p["conv2"], c1, stride=2, padding=0))
    pos = wmodel._audio_positions(cfg.n_audio_ctx, cfg.n_audio_state)[r * n:(r + 1) * n]
    return x + pos.to(device=x.device, dtype=x.dtype)


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


@torch.no_grad()
def encode_sequence_parallel(model_or_tree, cfg, mel: torch.Tensor, mesh: DeviceMesh,
                             axis: str = "tp"):
    """Whisper encoder with the frame axis sharded over `axis`.

    mel (B, 2·n_audio_ctx, n_mels), whole on every rank → features (B,
    n_audio_ctx, D) as a DTensor sharded over time on `axis`. At sp = 1 it
    is `Whisper.encode`, kernels included (a tree is wrapped in a
    `Whisper`). At sp > 1 a rank's q holds T/sp rows against T keys, so
    `attend` takes its einsum (the JAX formulation)."""
    sp = mesh.size(mesh.mesh_dim_names.index(axis))
    place = [Shard(1) if name == axis else Replicate() for name in mesh.mesh_dim_names]
    if sp == 1:
        model = (model_or_tree if isinstance(model_or_tree, wmodel.Whisper)
                 else wmodel.Whisper(cfg, model_or_tree))
        return DTensor.from_local(model.encode(mel), mesh, place)
    params = (model_or_tree.tree() if isinstance(model_or_tree, wmodel.Whisper)
              else model_or_tree)
    if cfg.n_audio_ctx % sp:
        raise ValueError(f"n_audio_ctx {cfg.n_audio_ctx} does not split over {sp} ranks")
    n, r = cfg.n_audio_ctx // sp, mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    p = params["encoder"]
    x = _stem_rows(p, cfg, mel, r, n)
    b, t, d = x.shape
    h = cfg.n_audio_head
    scale = (d // h) ** -0.25
    for i in range(cfg.n_audio_layer):
        bp = wmodel.layer_of(p["blocks"], i)
        hn = layer_norm(bp["ln1"], x)
        q = wmodel._heads(linear(bp["attn"]["q"], hn), h) * scale
        k = _gather_rows(wmodel._heads(linear(bp["attn"]["k"], hn), h) * scale, group)
        v = _gather_rows(wmodel._heads(linear(bp["attn"]["v"], hn), h), group)
        x = x + linear(bp["attn"]["o"], attend(q, k, v).reshape(b, t, d))
        hn = layer_norm(bp["ln2"], x)
        x = x + linear(bp["mlp"]["fc2"], gelu(linear(bp["mlp"]["fc1"], hn)))
    return DTensor.from_local(layer_norm(p["ln_post"], x), mesh, place)
