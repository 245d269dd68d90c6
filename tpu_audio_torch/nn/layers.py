"""Functional layers over param dicts (port of tpu_audio/nn/layers.py:
linear, layer_norm, rms_norm, gelu, silu, conv1d, conv_transpose1d,
weight_norm_conv1d, embedding, embedding_as_linear, sinusoidal_positions,
masked_instance_norm, zero_pad_tail, leaky_relu).

Conventions kept from the JAX module:
  - linear weights are (out_features, in_features);
  - sequence tensors are channels-last, (B, T, C);
  - a param dict without "weight" is quantised (`ops/quant.py`);
  - a `TPLinear` is one rank's block of a linear under tensor parallelism
    (`parallel.shardings.local_tree`): a row-parallel one's product is
    all-reduced over its group.
Changed for PyTorch: conv1d weights are (out, in/groups, kernel) and
transposed-conv weights (in, out/groups, kernel), torch's own layouts (the
JAX tree stores (kernel, in, out); `convert.params_from_numpy` transposes).
The convolutions are `F.conv1d` / `F.conv_transpose1d`: XLA convolutions
in the JAX package, not Pallas kernels. The norms compute in f32, or in
f64 for f64 inputs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_audio_torch.ops import quant


class TPLinear(dict):
    """A linear leaf's block on rank `rank` of a tensor-parallel group. A
    column-parallel block (`group` None) holds the rank's output channels;
    a row-parallel one holds its input columns, and `linear` all-reduces
    its partial product over `group` (its bias, whole, is kept on rank 0
    only, inside that rank's product)."""

    def __init__(self, leaf: dict, rank: int, group=None):
        super().__init__(leaf)
        self.rank, self.group = rank, group


def linear(p, x: torch.Tensor) -> torch.Tensor:
    if "weight" not in p:
        y = quant.quantized_linear(p, x)
    else:
        bias = p["bias"].to(x.dtype) if "bias" in p else None
        y = F.linear(x, p["weight"].to(x.dtype), bias)
    if getattr(p, "group", None) is not None:
        dist.all_reduce(y, group=p.group)
    return y


def embedding(p, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table; a quantised table's rows (int8, q4/q8, W4A8
    pair-packed) are dequantised to f32."""
    if "weight" not in p:
        return quant.dequantize_rows(p, ids)
    return p["weight"][ids]


def embedding_as_linear(p, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding output head: logits = x @ E.T (a quantised table goes
    through `quant.quantized_linear` and its decode kernels, never
    dequantised whole at ≤ 32 rows)."""
    if "weight" not in p:
        return quant.quantized_linear(p, x)
    return x @ p["weight"].to(x.dtype).T


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a norm computes in: f32, or f64 for f64 inputs."""
    return torch.promote_types(x.dtype, torch.float32)


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32 (f64 for f64 x),
    returned in x's dtype; p None: no affine (Kokoro's AdaLayerNorm)."""
    ct = _compute_dtype(x)
    weight = None if p is None else p["weight"].to(ct)
    bias = p["bias"].to(ct) if p is not None and "bias" in p else None
    return F.layer_norm(x.to(ct), (x.shape[-1],), weight, bias, eps).to(x.dtype)


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, computed in f32, returned in x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * p["weight"].float()).to(x.dtype)


def conv1d(p, x: torch.Tensor, stride: int = 1, padding: int | tuple = 0,
           dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """1-D convolution over (B, T, C_in) → (B, T', C_out); weight
    (O, I/groups, K). `padding` is one int or a (left, right) pair; a
    depthwise conv (FunASR's FSMN memory) has groups = C and weight (C, 1, K)."""
    bias = p["bias"].to(x.dtype) if "bias" in p else None
    xt = x.transpose(1, 2)
    if not isinstance(padding, int):
        xt, padding = F.pad(xt, tuple(padding)), 0
    y = F.conv1d(xt, p["weight"].to(x.dtype), bias, stride=stride,
                 padding=padding, dilation=dilation, groups=groups)
    return y.transpose(1, 2).contiguous()


def conv_transpose1d(p, x: torch.Tensor, stride: int = 1, padding: int = 0,
                     groups: int = 1) -> torch.Tensor:
    """Transposed 1-D convolution over (B, T, C_in) → (B, T', C_out) with
    T' = (T − 1)·stride − 2·padding + K; weight (I, O/groups, K). A weight
    (1, C, K), the (1, 2, 0) image of the JAX depthwise (K, 1, C), is
    depthwise with groups = C, inferred from its singleton input axis as
    the JAX function infers it; torch's own depthwise (C, 1, K) takes
    `groups` from the caller."""
    w = p["weight"]
    c = x.shape[-1]
    if groups == 1 and w.shape[0] != c:
        if w.shape[0] != 1 or w.shape[1] != c:
            raise NotImplementedError(f"only dense or depthwise transposed conv supported; "
                                      f"weight {tuple(w.shape)} vs input C={c}")
        w, groups = w.transpose(0, 1), c
    bias = p["bias"].to(x.dtype) if "bias" in p else None
    y = F.conv_transpose1d(x.transpose(1, 2), w.to(x.dtype), bias, stride=stride,
                           padding=padding, groups=groups)
    return y.transpose(1, 2).contiguous()


def weight_norm(v: torch.Tensor, g: torch.Tensor, dims: tuple) -> torch.Tensor:
    """g · v / ‖v‖ in f32 (f64 for f64 v), the norm over `dims` (+1e-12
    under the root)."""
    ct = _compute_dtype(v)
    vf = v.to(ct)
    return vf / torch.sqrt((vf * vf).sum(dim=dims, keepdim=True) + 1e-12) * g.to(ct)


def weight_norm_conv1d(p, x: torch.Tensor, **kw) -> torch.Tensor:
    """conv1d with a weight-normalised kernel: weight_v (O, I/g, K), weight_g
    (O, 1, 1), the norm over (I/g, K) of each output channel."""
    q = {"weight": weight_norm(p["weight_v"], p["weight_g"], (1, 2)).to(x.dtype)}
    if "bias" in p:
        q["bias"] = p["bias"]
    return conv1d(q, x, **kw)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def _valid_frames(x: torch.Tensor, valid_len) -> torch.Tensor:
    """(1, T, 1) bool: frame t of (B, T, C) is below valid_len (an int or
    a 0-d tensor)."""
    return (torch.arange(x.shape[-2], device=x.device) < valid_len)[None, :, None]


def masked_instance_norm(x: torch.Tensor, valid_len, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm1d over (B, T, C) with statistics from the first
    valid_len frames only (padded synthesis: statistics over the padded
    tail would move every valid frame); frames past valid_len come out
    zero. Computed in f32 (f64 for f64 x)."""
    xf = x.to(_compute_dtype(x))
    mask = _valid_frames(x, valid_len).to(xf.dtype)
    n = torch.clamp(mask.sum(), min=1.0)
    mu = (xf * mask).sum(dim=-2, keepdim=True) / n
    var = (((xf - mu) ** 2) * mask).sum(dim=-2, keepdim=True) / n
    return ((xf - mu) * torch.rsqrt(var + eps) * mask).to(x.dtype)


def zero_pad_tail(x: torch.Tensor, valid_len) -> torch.Tensor:
    """Zero the frames at and beyond valid_len along axis -2 of (B, T, C)."""
    return torch.where(_valid_frames(x, valid_len), x, torch.zeros((), dtype=x.dtype,
                                                                   device=x.device))


def sinusoidal_positions(length: int, dim: int,
                         max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper-style sinusoidal embeddings (length, dim), [sin | cos] halves."""
    log_inc = np.log(max_timescale) / (dim // 2 - 1)
    inv = np.exp(-log_inc * np.arange(dim // 2))
    ang = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)
