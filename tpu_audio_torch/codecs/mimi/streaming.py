"""Exact stateful streaming Mimi decoder (port of
tpu_audio/codecs/mimi/streaming.py: conv_stream, conv_tail_init,
conv_transpose_stream, conv_transpose_carry_init, transformer_stream,
MimiDecState, init_state, decode_stream).

The whole decode path is causal (stride-1 left-padded convs, causal
transposed convs, a transformer over a 250-frame window), so a per-chunk
decoder that carries
  - each conv's input tail (k_eff − 1 samples at that conv's rate),
  - each transposed conv's partial-output overlap (K − stride samples,
    without bias, so the next chunk adds the bias once),
  - a sliding K/V cache for the decoder transformer (the window),
reproduces the one-shot `model.decode` (the same products for every output
sample) at O(chunk) cost a call. The state is tensors on the parameters'
device, updated IN PLACE by `decode_stream`, where the JAX package returns
new arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tpu_audio_torch.codecs.mimi.model import (MimiConfig, split_rvq_decode, transformer_layer,
                                               window_mask)
from tpu_audio_torch.convert import tree_device
from tpu_audio_torch.nn import layers


# ---------------------------------------------------------------- primitives

def conv_stream(p, x: torch.Tensor, tail: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """Stride-1 causal conv over a chunk x (B, T, Ci) → (B, T, Co); `tail`
    (B, k_eff − 1, Ci), the last inputs before the chunk, becomes the last
    of this one, in place."""
    k_eff = (p["weight"].shape[-1] - 1) * dilation + 1
    if k_eff == 1:
        return layers.conv1d(p, x)
    xe = torch.cat([tail, x], dim=1)
    y = layers.conv1d(p, xe, dilation=dilation)
    tail.copy_(xe[:, xe.shape[1] - (k_eff - 1):])
    return y


def conv_tail_init(p, batch: int, dilation: int = 1, dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    k_eff = (p["weight"].shape[-1] - 1) * dilation + 1
    return torch.zeros((batch, max(k_eff - 1, 0), p["weight"].shape[1]), dtype=dtype,
                       device=device or p["weight"].device)


def conv_transpose_stream(p, x: torch.Tensor, carry: torch.Tensor, stride: int,
                          groups: int = 1) -> torch.Tensor:
    """Causal transposed conv over a chunk x (B, T, Ci) → (B, T·stride, Co);
    `carry` (B, K − stride, Co), the bias-free overlap of the chunk before,
    is added to this chunk's head and replaced by its tail, in place."""
    over = p["weight"].shape[-1] - stride
    raw = layers.conv_transpose1d(p, x, stride=stride, groups=groups)
    # raw length (T − 1)·stride + K = T·stride + over
    raw[:, :over] += carry
    carry.copy_(raw[:, raw.shape[1] - over:])
    if "bias" in p:
        carry -= p["bias"].to(carry.dtype)
    return raw[:, : raw.shape[1] - over]


def conv_transpose_carry_init(p, stride: int, batch: int, groups: int = 1,
                              dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    w = p["weight"]  # (I, O/groups, K)
    return torch.zeros((batch, max(w.shape[-1] - stride, 0), w.shape[1] * groups), dtype=dtype,
                       device=device or w.device)


# ---------------------------------------------------------------- transformer

def transformer_stream(params, cfg: MimiConfig, x: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The windowed causal transformer over a chunk x (B, T, D) at absolute
    positions pos … pos + T − 1 (`pos` a 0-d tensor); k_cache / v_cache
    (L, B, C, H, hd) hold the last C positions before it and slide by T, in
    place. C ≥ t_context − 1 + T gives every query its whole window."""
    t = x.shape[1]
    c = k_cache.shape[2]
    steps = torch.arange(t, device=x.device)
    q_pos = pos + steps
    key_pos = pos + t - c + torch.arange(c, device=x.device)  # the cache after the append
    mask = window_mask(q_pos, key_pos, cfg.t_context)
    for i in range(cfg.t_layers):
        def kv(k, v, i=i):
            for cache, new in ((k_cache, k), (v_cache, v)):
                cache[i] = torch.cat([cache[i, :, t:], new.to(cache.dtype)], dim=1)
            return k_cache[i].to(k.dtype), v_cache[i].to(v.dtype)

        x = transformer_layer(params["layers"][str(i)], cfg, x, q_pos, kv, mask)
    return x


# ---------------------------------------------------------------- state

@dataclass
class MimiDecState:
    up_carry: torch.Tensor
    tf_k: torch.Tensor
    tf_v: torch.Tensor
    tf_pos: torch.Tensor  # 0-d int64: absolute 25 Hz position of the next chunk
    conv_tails: dict
    tr_carries: dict


def init_state(params, cfg: MimiConfig, batch: int = 1, chunk_frames: int = 8,
               dtype: torch.dtype = torch.float32) -> MimiDecState:
    """The zero state of a stream decoded `chunk_frames` 12.5 Hz frames a
    call (at most), on the parameters' device."""
    dev = tree_device(params)
    c = cfg.t_context - 1 + chunk_frames * cfg.downsample_stride
    hd = cfg.dimension // cfg.t_heads
    dec = params["decoder"]
    tails = {"init": conv_tail_init(dec["init_conv1d"], batch, dtype=dtype)}
    carries = {}
    for ri, ratio in enumerate(cfg.ratios):
        carries[f"tr{ri}"] = conv_transpose_carry_init(dec["layers"][str(2 * ri)], ratio, batch,
                                                       dtype=dtype)
        rb = dec["layers"][str(2 * ri + 1)]["block"]
        tails[f"rb{ri}a"] = conv_tail_init(rb["0"], batch, dtype=dtype)
        tails[f"rb{ri}b"] = conv_tail_init(rb["1"], batch, dtype=dtype)
    tails["final"] = conv_tail_init(dec["final_conv1d"], batch, dtype=dtype)
    kv_shape = (cfg.t_layers, batch, c, cfg.t_heads, hd)
    return MimiDecState(
        up_carry=conv_transpose_carry_init(params["upsample"]["convtr"], cfg.downsample_stride,
                                           batch, groups=cfg.dimension, dtype=dtype),
        tf_k=torch.zeros(kv_shape, dtype=dtype, device=dev),
        tf_v=torch.zeros(kv_shape, dtype=dtype, device=dev),
        tf_pos=torch.zeros((), dtype=torch.int64, device=dev),
        conv_tails=tails, tr_carries=carries)


# ---------------------------------------------------------------- decode

def decode_stream(params, cfg: MimiConfig, codes: torch.Tensor,
                  state: MimiDecState) -> tuple[torch.Tensor, MimiDecState]:
    """codes (B, n_q, F) chunk → (audio (B, F·hop), state advanced in
    place). The chunks' outputs concatenated equal `model.decode` of the
    codes concatenated."""
    tails, carries = state.conv_tails, state.tr_carries
    z = split_rvq_decode(params, cfg, codes)
    z = conv_transpose_stream(params["upsample"]["convtr"], z, state.up_carry,
                              cfg.downsample_stride, groups=cfg.dimension)
    z = transformer_stream(params["decoder_transformer"], cfg, z, state.tf_k, state.tf_v,
                           state.tf_pos)
    dec = params["decoder"]
    x = conv_stream(dec["init_conv1d"], z, tails["init"])
    for ri, ratio in enumerate(cfg.ratios):
        x = conv_transpose_stream(dec["layers"][str(2 * ri)], F.elu(x), carries[f"tr{ri}"],
                                  ratio)
        rb = dec["layers"][str(2 * ri + 1)]["block"]
        y = conv_stream(rb["0"], F.elu(x), tails[f"rb{ri}a"])
        y = conv_stream(rb["1"], F.elu(y), tails[f"rb{ri}b"])
        x = x + y
    audio = conv_stream(dec["final_conv1d"], F.elu(x), tails["final"])
    state.tf_pos += z.shape[1]
    return audio[..., 0], state
