"""Static-shape self-attention KV caches (port of tpu_audio/ops/kvcache.py:
KVCache, FusedKVCache; QuantizedKVCache is not ported yet, ROADMAP A9).

A preallocated (layers, batch, max_len, heads, head_dim) buffer pair with
the write position kept as a 0-d tensor on the device, so a decode loop
never reads it back to the host. Unlike the JAX cache, which returns new
buffers, `write` and `advance` update the cache IN PLACE.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class KVCache:
    k: torch.Tensor    # (L, B, S_max, H, D)
    v: torch.Tensor
    pos: torch.Tensor  # 0-d int64 on the device: number of valid positions

    @staticmethod
    def create(layers: int, batch: int, max_len: int, heads: int,
               head_dim: int, dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cuda") -> "KVCache":
        shape = (layers, batch, max_len, heads, head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       pos=torch.zeros((), dtype=torch.int64, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def write(self, layer: int, k_new: torch.Tensor,
              v_new: torch.Tensor) -> None:
        """Write (B, T, H, D) keys/values of one layer at slots pos..pos+T-1,
        in place."""
        idx = self.pos + torch.arange(k_new.shape[1], device=self.pos.device)
        self.k[layer].index_copy_(1, idx, k_new.to(self.k.dtype))
        self.v[layer].index_copy_(1, idx, v_new.to(self.v.dtype))

    def advance(self, t: int) -> None:
        """Move the write position on by t, in place."""
        self.pos += t


@dataclass
class FusedKVCache:
    """The single-stream cache in the whole-stack decode kernel's layout
    (`ops/kernels/fused_step.py`): (L, H_kv, S_max, D) with B=1 implicit.
    Left-pad prompt masking rides `start`, the first valid key slot,
    instead of an additive mask. `pos` and `start` are 0-d int64 tensors on
    the device; the buffers and `pos` are updated in place."""

    k: torch.Tensor      # (L, H_kv, S_max, D)
    v: torch.Tensor
    pos: torch.Tensor    # 0-d int64: number of valid positions
    start: torch.Tensor  # 0-d int64: first valid key slot

    @staticmethod
    def create(layers: int, max_len: int, heads: int, head_dim: int,
               dtype: torch.dtype = torch.bfloat16, start=0,
               device: torch.device | str = "cuda") -> "FusedKVCache":
        shape = (layers, heads, max_len, head_dim)
        return FusedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                            v=torch.zeros(shape, dtype=dtype, device=device),
                            pos=torch.zeros((), dtype=torch.int64, device=device),
                            start=torch.as_tensor(start, dtype=torch.int64,
                                                  device=device).reshape(()))

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def advance(self, t: int) -> None:
        self.pos += t
