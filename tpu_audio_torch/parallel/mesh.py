"""Device-mesh construction (port of tpu_audio/parallel/mesh.py).

A 2-D (dp, tp) `DeviceMesh` over the world of torch.distributed: one card a
rank on NCCL, or the CPU on gloo. The JAX package's collectives are what
GSPMD inserts; here DTensor inserts them for the sharded leaves
(`shardings.py`), and `training.train` and `sp.py` add the few it cannot
infer.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type(devices) -> str:
    """"cuda" or "cpu": `devices` itself, or else the default group's (gloo:
    the CPU), or else the card."""
    if devices is not None:
        return torch.device(devices).type
    if dist.is_initialized() and dist.get_backend() == "gloo":
        return "cpu"
    return "cuda"


def make_mesh(dp: int | None = None, tp: int | None = None,
              devices: str | None = None) -> DeviceMesh:
    """Build a (dp, tp) mesh over the world's ranks, dimensions named
    ("dp", "tp"). Defaults, as in JAX: tp = every rank, dp = 1; the missing
    one derived from the other; ValueError when dp × tp is not the world
    size. `devices`: the ranks' device type, "cuda" (NCCL, a card a rank;
    the default) or "cpu" (gloo). With no process group initialised, the
    world is this process alone: a single-rank group on an in-process
    `HashStore` (NCCL on the card, gloo on the CPU), which opens no port."""
    kind = _device_type(devices)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    if tp is None and dp is None:
        dp, tp = 1, n
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp})×tp({tp}) != device count {n}")
    if kind == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(kind, torch.arange(n).reshape(dp, tp), mesh_dim_names=("dp", "tp"))
