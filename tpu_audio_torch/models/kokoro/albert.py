"""ALBERT text encoder for Kokoro's duration predictor (port of
tpu_audio/models/kokoro/albert.py: init_params, forward).

One transformer layer's parameters applied num_hidden_layers times (a
Python loop over the same tree, where the JAX module scans), over a
128-wide embedding factorised up to 768; exact (erf) GELU. The padding
mask always goes to `attention.attend`, so the attention is the plain
computation, never the `encoder_attention` kernel (that route is for
unmasked self-attention only).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_audio_torch.codecs.s3gen.params import Init
from tpu_audio_torch.models.kokoro.config import AlbertConfig
from tpu_audio_torch.nn import attention, layers


def numpy_params(rng: np.random.Generator, cfg: AlbertConfig) -> dict:
    """The JAX `init_params` tree as f32 numpy arrays (no convolutions:
    the layouts are torch's too)."""
    init, e, h = Init(rng), cfg.embedding_size, cfg.hidden_size
    return {
        "embeddings": {
            "word_embeddings": init.embedding(cfg.vocab_size, e),
            "position_embeddings": init.embedding(cfg.max_position_embeddings, e),
            "token_type_embeddings": init.embedding(cfg.type_vocab_size, e),
            "LayerNorm": init.norm(e),
        },
        "encoder": {
            "embedding_hidden_mapping_in": init.linear(e, h),
            "albert_layer_groups": {"0": {"albert_layers": {"0": {
                "attention": {"query": init.linear(h, h), "key": init.linear(h, h),
                              "value": init.linear(h, h), "dense": init.linear(h, h),
                              "LayerNorm": init.norm(h)},
                "ffn": init.linear(h, cfg.intermediate_size),
                "ffn_output": init.linear(cfg.intermediate_size, h),
                "full_layer_layer_norm": init.norm(h),
            }}}},
        },
        "pooler": init.linear(h, h),
    }


def forward(p: dict, cfg: AlbertConfig, ids: torch.Tensor,
            attn_mask: torch.Tensor) -> torch.Tensor:
    """ids (B, T), attn_mask (B, T) 1 = valid → sequence output (B, T, hidden)."""
    emb = p["embeddings"]
    b, t = ids.shape
    x = layers.embedding(emb["word_embeddings"], ids)
    x = x + emb["position_embeddings"]["weight"][None, :t]
    x = x + emb["token_type_embeddings"]["weight"][0][None, None]
    x = layers.layer_norm(emb["LayerNorm"], x, cfg.layer_norm_eps)
    x = layers.linear(p["encoder"]["embedding_hidden_mapping_in"], x)

    lp = p["encoder"]["albert_layer_groups"]["0"]["albert_layers"]["0"]
    heads = cfg.num_attention_heads
    hd = cfg.hidden_size // heads
    zero = torch.zeros((), dtype=torch.float32, device=ids.device)
    add_mask = torch.where(attn_mask[:, None, None, :] > 0, zero, attention.NEG_INF)
    for _ in range(cfg.num_hidden_layers):
        q = layers.linear(lp["attention"]["query"], x).reshape(b, t, heads, hd)
        k = layers.linear(lp["attention"]["key"], x).reshape(b, t, heads, hd)
        v = layers.linear(lp["attention"]["value"], x).reshape(b, t, heads, hd)
        o = attention.attend(q, k, v, add_mask, scale=1.0 / math.sqrt(hd))
        att = layers.linear(lp["attention"]["dense"], o.reshape(b, t, -1))
        x = layers.layer_norm(lp["attention"]["LayerNorm"], x + att, cfg.layer_norm_eps)
        h = layers.gelu(layers.linear(lp["ffn"], x))
        h = layers.linear(lp["ffn_output"], h)
        x = layers.layer_norm(lp["full_layer_layer_norm"], x + h, cfg.layer_norm_eps)
    return x
