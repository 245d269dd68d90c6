"""Functional layers over param dicts (port of tpu_audio/nn/layers.py:
linear, layer_norm, rms_norm, gelu, silu, conv1d, embedding,
embedding_as_linear, sinusoidal_positions).

Conventions kept from the JAX module:
  - linear weights are (out_features, in_features);
  - sequence tensors are channels-last, (B, T, C);
  - a param dict without "weight" is quantised (`ops/quant.py`).
Changed for PyTorch: conv1d weights are (out, in, kernel), torch's own
layout (the JAX tree stores (kernel, in, out); `convert.params_from_numpy`
transposes).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch.ops import quant


def linear(p, x: torch.Tensor) -> torch.Tensor:
    if "weight" not in p:
        return quant.quantized_linear(p, x)
    bias = p["bias"].to(x.dtype) if "bias" in p else None
    return F.linear(x, p["weight"].to(x.dtype), bias)


def embedding(p, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table; an int8 table's rows are dequantised to f32."""
    if "weight" not in p:
        return quant.dequantize_rows(p, ids)
    return p["weight"][ids]


def embedding_as_linear(p, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding output head: logits = x @ E.T (an int8 table goes
    through the int8 matmul, never dequantised whole)."""
    if "weight" not in p:
        return quant.quantized_linear(p, x)
    return x @ p["weight"].to(x.dtype).T


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32, returned in x's dtype."""
    bias = p["bias"].float() if "bias" in p else None
    return F.layer_norm(x.float(), (x.shape[-1],), p["weight"].float(), bias,
                        eps).to(x.dtype)


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, computed in f32, returned in x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * p["weight"].float()).to(x.dtype)


def conv1d(p, x: torch.Tensor, stride: int = 1, padding: int | tuple = 0,
           groups: int = 1) -> torch.Tensor:
    """1-D convolution over (B, T, C_in) → (B, T', C_out); weight
    (O, I/groups, K). `padding` is one int or a (left, right) pair; a
    depthwise conv (FunASR's FSMN memory) has groups = C and weight (C, 1, K)."""
    bias = p["bias"].to(x.dtype) if "bias" in p else None
    xt = x.transpose(1, 2)
    if not isinstance(padding, int):
        xt, padding = F.pad(xt, tuple(padding)), 0
    y = F.conv1d(xt, p["weight"].to(x.dtype), bias, stride=stride,
                 padding=padding, groups=groups)
    return y.transpose(1, 2).contiguous()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def sinusoidal_positions(length: int, dim: int,
                         max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper-style sinusoidal embeddings (length, dim), [sin | cos] halves."""
    log_inc = np.log(max_timescale) / (dim // 2 - 1)
    inv = np.exp(-log_inc * np.arange(dim // 2))
    ang = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)
