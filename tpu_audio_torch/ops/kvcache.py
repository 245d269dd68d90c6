"""Static-shape self-attention KV caches (port of tpu_audio/ops/kvcache.py:
KVCache, FusedKVCache, QuantizedKVCache).

A preallocated (layers, batch, max_len, heads, head_dim) buffer pair with
the write position kept as a 0-d tensor on the device, so a decode loop
never reads it back to the host. Unlike the JAX cache, which returns new
buffers, `write` and `advance` update the cache IN PLACE. A speculative
loop rewinds a cache by copying a smaller position into `pos`.

`QuantizedKVCache` holds int8 codes with one f32 scale (absmax / 127,
floored at 1e-8) a token and head; reads dequantise a layer into the
attention's dtype. The codes divide by the scale, as the JAX cache does
(no reciprocal product), and round half to even as `jnp.round` does.
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


@dataclass
class QuantizedKVCache:
    """int8 KV cache: per-token-per-head absmax scales, half the bytes of
    a bf16 cache. `write` quantises and writes in place; `read_layer`
    dequantises one layer."""

    k_q: torch.Tensor  # (L, B, S_max, H_kv, D) int8
    v_q: torch.Tensor
    k_s: torch.Tensor  # (L, B, S_max, H_kv, 1) f32 absmax/127 scales
    v_s: torch.Tensor
    pos: torch.Tensor  # 0-d int64 on the device

    @staticmethod
    def create(layers: int, batch: int, max_len: int, kv_heads: int, head_dim: int,
               device: torch.device | str = "cuda") -> "QuantizedKVCache":
        shape, sshape = ((layers, batch, max_len, kv_heads, n) for n in (head_dim, 1))
        return QuantizedKVCache(
            k_q=torch.zeros(shape, dtype=torch.int8, device=device),
            v_q=torch.zeros(shape, dtype=torch.int8, device=device),
            k_s=torch.zeros(sshape, dtype=torch.float32, device=device),
            v_s=torch.zeros(sshape, dtype=torch.float32, device=device),
            pos=torch.zeros((), dtype=torch.int64, device=device))

    @property
    def max_len(self) -> int:
        return self.k_q.shape[2]

    @staticmethod
    def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(codes int8, scales f32 (..., 1)) of x over its last axis."""
        xf = x.float()
        s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
        q = torch.clamp(torch.round(xf / s), -127, 127)
        return q.to(torch.int8), s

    def write(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        """Quantise (B, T, H, D) keys/values of one layer and write them at
        slots pos..pos+T-1, in place."""
        idx = self.pos + torch.arange(k_new.shape[1], device=self.pos.device)
        for new, q_buf, s_buf in ((k_new, self.k_q, self.k_s), (v_new, self.v_q, self.v_s)):
            q, s = self._quantize(new)
            q_buf[layer].index_copy_(1, idx, q)
            s_buf[layer].index_copy_(1, idx, s)

    def read_layer(self, layer: int, dtype: torch.dtype = torch.bfloat16):
        """Dequantised (B, S_max, H, D) keys and values of one layer."""
        return ((self.k_q[layer].float() * self.k_s[layer]).to(dtype),
                (self.v_q[layer].float() * self.v_s[layer]).to(dtype))

    def advance(self, t: int) -> None:
        self.pos += t
