"""Static-shape self-attention KV cache (port of tpu_audio/ops/kvcache.py:
KVCache).

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
