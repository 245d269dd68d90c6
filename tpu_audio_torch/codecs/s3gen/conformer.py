"""S3Gen's upsampling conformer encoder: speech-token embeddings →
mel-rate features (port of tpu_audio/codecs/s3gen/conformer.py:
ConformerConfig, init_params, forward).

A linear embed (LayerNorm, × sqrt(d)) → a pre-lookahead conv pair (k4
peeking 3 frames ahead, leaky ReLU 0.01, then a causal k3 without
activation) → 6 pre-LN layers of relative-position attention + a SiLU FFN
→ a ×2 nearest upsample with a causal k5 conv → a second embed → 4 more
layers → LayerNorm. The reference's conventions, kept from the JAX
module: the relative positions are POSITIVE only, [0, T), with the sin and
cos halves concatenated, and no rel-shift (the position table has T rows,
so the reference takes its no-shift branch); with streaming, a query
attends keys of its own chunk and the earlier ones (25 tokens, 50 frames
after the upsample). Plain torch: the JAX package runs no Pallas kernel
here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch.codecs.s3gen.params import Init
from tpu_audio_torch.nn import attention, layers


@dataclass(frozen=True)
class ConformerConfig:
    input_size: int = 512
    output_size: int = 512
    heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    num_up_blocks: int = 4
    pre_lookahead_len: int = 3
    upsample_stride: int = 2
    static_chunk_size: int = 25 * 2  # the streaming chunk (tokens × 2 after the upsample)


def numpy_params(rng: np.random.Generator, cfg: ConformerConfig) -> dict:
    init, d = Init(rng), cfg.output_size

    def layer():
        return {"self_attn": {
                    "linear_q": init.linear(d, d), "linear_k": init.linear(d, d),
                    "linear_v": init.linear(d, d), "linear_out": init.linear(d, d),
                    "linear_pos": init.linear(d, d, False),
                    "pos_bias_u": np.zeros((cfg.heads, d // cfg.heads), np.float32),
                    "pos_bias_v": np.zeros((cfg.heads, d // cfg.heads), np.float32)},
                "feed_forward": {"w_1": init.linear(d, cfg.linear_units),
                                 "w_2": init.linear(cfg.linear_units, d)},
                "norm_ff": init.norm(d), "norm_mha": init.norm(d)}

    return {"embed": {"out": init.linear(cfg.input_size, d), "norm": init.norm(d)},
            "pre_lookahead_layer": {"conv1": init.conv(d, d, cfg.pre_lookahead_len + 1),
                                    "conv2": init.conv(d, d, 3)},
            "encoders": {str(i): layer() for i in range(cfg.num_blocks)},
            "up_layer": {"conv": init.conv(d, d, 5)},
            "up_embed": {"out": init.linear(d, d), "norm": init.norm(d)},
            "up_encoders": {str(i): layer() for i in range(cfg.num_up_blocks)},
            "after_norm": init.norm(d)}


def rel_pos_emb(t: int, d: int, device) -> torch.Tensor:
    """(1, T, D): positions 0 .. T-1, [sin | cos] concatenated."""
    pos = np.arange(t, dtype=np.float64)
    inv = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    ang = pos[:, None] * inv[None, :]
    pe = np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)
    return torch.as_tensor(pe[None], device=device)


def _rel_attention(p, x: torch.Tensor, pos_emb: torch.Tensor, bias: torch.Tensor,
                   heads: int) -> torch.Tensor:
    b, t, _ = x.shape
    hd = p["pos_bias_u"].shape[-1]  # the head size (heads may be a rank's share)
    q = layers.linear(p["linear_q"], x).reshape(b, t, heads, hd)
    k = layers.linear(p["linear_k"], x).reshape(b, t, heads, hd)
    v = layers.linear(p["linear_v"], x).reshape(b, t, heads, hd)
    pe = layers.linear(p["linear_pos"], pos_emb.to(x.dtype)).reshape(1, -1, heads, hd)
    q_u = q + p["pos_bias_u"].to(x.dtype)[None, None]
    q_v = q + p["pos_bias_v"].to(x.dtype)[None, None]
    ac = torch.einsum("bqhd,bkhd->bhqk", q_u.float(), k.float())
    bd = torch.einsum("bqhd,pkhd->bhqk", q_v.float(), pe.float())
    w = torch.softmax((ac + bd) / math.sqrt(hd) + bias, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)
    return layers.linear(p["linear_out"], o.reshape(b, t, heads * hd))


def _encoder_layer(p, x, pos_emb, bias, heads):
    x = x + _rel_attention(p["self_attn"], layers.layer_norm(p["norm_mha"], x), pos_emb, bias,
                           heads)
    h = layers.layer_norm(p["norm_ff"], x)
    return x + layers.linear(p["feed_forward"]["w_2"],
                             F.silu(layers.linear(p["feed_forward"]["w_1"], h)))


def chunk_bias(t: int, lengths: torch.Tensor, chunk: int, streaming: bool) -> torch.Tensor:
    """(B, 1, T, T) or (B, 1, 1, T) f32: padded keys masked, and with
    streaming, keys of later chunks than the query's."""
    bias = attention.padding_mask(lengths, t)
    if streaming and chunk > 0:
        idx = torch.arange(t, device=lengths.device)
        zero = torch.zeros((), device=lengths.device)
        bias = bias + torch.where(idx[None, :] // chunk <= idx[:, None] // chunk, zero,
                                  attention.NEG_INF)[None, None]
    return bias


def forward(params, cfg: ConformerConfig, x: torch.Tensor, lengths: torch.Tensor,
            streaming: bool = False):
    """Embedded tokens (B, T, input) and valid lengths (B,) → (features
    (B, 2T, output), lengths · 2)."""
    t, d = x.shape[1], cfg.output_size
    sqrt_d = torch.tensor(np.sqrt(d), dtype=x.dtype)
    x = layers.layer_norm(params["embed"]["norm"], layers.linear(params["embed"]["out"], x))
    x = x * sqrt_d
    pl = params["pre_lookahead_layer"]
    h = F.leaky_relu(layers.conv1d(pl["conv1"], x, padding=(0, cfg.pre_lookahead_len)), 0.01)
    x = x + layers.conv1d(pl["conv2"], h, padding=(2, 0))

    pos = rel_pos_emb(t, d, x.device)
    bias = chunk_bias(t, lengths, cfg.static_chunk_size // cfg.upsample_stride, streaming)
    for i in range(cfg.num_blocks):
        x = _encoder_layer(params["encoders"][str(i)], x, pos, bias, cfg.heads)

    x = x.repeat_interleave(cfg.upsample_stride, dim=1)
    x = layers.conv1d(params["up_layer"]["conv"], x, padding=(2 * cfg.upsample_stride, 0))
    lengths2 = lengths * cfg.upsample_stride
    t2 = x.shape[1]
    x = layers.layer_norm(params["up_embed"]["norm"], layers.linear(params["up_embed"]["out"], x))
    x = x * sqrt_d
    pos2 = rel_pos_emb(t2, d, x.device)
    bias2 = chunk_bias(t2, lengths2, cfg.static_chunk_size, streaming)
    for i in range(cfg.num_up_blocks):
        x = _encoder_layer(params["up_encoders"][str(i)], x, pos2, bias2, cfg.heads)
    return layers.layer_norm(params["after_norm"], x), lengths2
