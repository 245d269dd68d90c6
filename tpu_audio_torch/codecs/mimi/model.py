"""Mimi neural codec, Kyutai, 24 kHz at 12.5 Hz (port of
tpu_audio/codecs/mimi/model.py: MimiConfig, init_params, causal_conv,
causal_conv_transpose, seanet_encode, seanet_decode, transformer_apply,
rvq_encode, rvq_decode, split_rvq_encode, split_rvq_decode, encode,
decode).

A causal SEANet encoder and decoder (ratios 8/6/5/4, ELU, residual
blocks), an 8-layer RoPE transformer on each side with layer scale and a
context of 250 frames, a ×2 conv down/upsample to 12.5 Hz, and a split
residual VQ (semantic codebook 0 + acoustic 1..31) whose Euclidean
codebooks are stored as embedding_sum / cluster_usage. Sequences are
channels-last (B, T, C) at the public functions, as in the JAX module. The
convolutions are `F.conv1d` / `F.conv_transpose1d` (XLA convolutions in
the JAX package, no Pallas kernel) with torch's weight layouts: conv
(O, I, K), transposed conv (I, O, K), the depthwise ×2 upsampler (C, 1, K).

Mimi's kernels sit under names that `convert.params_from_numpy`'s rule
does not reach (`init_conv1d`, `layers.N`, `block.N`, `input_proj`), and
its stacked-free tree has no other 3-D leaves, so `params_from_numpy`
here applies Mimi's own rule: `conv_layout` names the layout of each
kernel by its key.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch import convert
from tpu_audio_torch.nn import attention, layers, rope
from tpu_audio_torch.utils import pytree


@dataclass(frozen=True)
class MimiConfig:
    sample_rate: int = 24000
    frame_rate: float = 12.5
    dimension: int = 512
    n_filters: int = 64
    ratios: tuple = (8, 6, 5, 4)
    ksize: int = 7
    residual_ksize: int = 3
    last_ksize: int = 3
    compress: int = 2
    # transformer
    t_layers: int = 8
    t_heads: int = 8
    t_ff: int = 2048
    t_context: int = 250
    layer_scale: float = 0.01
    # quantizer
    n_q: int = 32
    bins: int = 2048
    q_dim: int = 256

    @property
    def seanet_hop(self) -> int:
        return math.prod(self.ratios)  # 960 → 25 Hz

    @property
    def downsample_stride(self) -> int:
        return int(self.sample_rate / self.seanet_hop / self.frame_rate)  # 2

    @property
    def hop(self) -> int:
        return self.seanet_hop * self.downsample_stride  # 1920 samples a frame


# ------------------------------------------------------------------ params

def numpy_params(rng: np.random.Generator, cfg: MimiConfig) -> dict:
    """The JAX `init_params` tree (JAX layouts: conv kernels (K, I, O), the
    depthwise upsampler (K, 1, d)) as f32 numpy arrays with its
    initialisation ranges."""
    nf, d = cfg.n_filters, cfg.dimension

    def conv(i, o, k, bias=True):
        scale = np.float32(1.0 / math.sqrt(i * k))
        p = {"weight": (rng.random((k, i, o), dtype=np.float32) * 2 - 1) * scale}
        if bias:
            p["bias"] = (rng.random((o,), dtype=np.float32) * 2 - 1) * scale
        return p

    def linear(i, o):
        scale = np.float32(1.0 / math.sqrt(i))
        return {"weight": (rng.random((o, i), dtype=np.float32) * 2 - 1) * scale}

    def resblock(dim):
        hidden = dim // cfg.compress
        return {"block": {"0": conv(dim, hidden, cfg.residual_ksize), "1": conv(hidden, dim, 1)}}

    enc = {"init_conv1d": conv(1, nf, cfg.ksize), "layers": {}}
    mult, li = 1, 0
    for ratio in reversed(cfg.ratios):
        enc["layers"][str(li)] = resblock(nf * mult)
        enc["layers"][str(li + 1)] = conv(nf * mult, nf * mult * 2, ratio * 2)
        li += 2
        mult *= 2
    enc["final_conv1d"] = conv(nf * mult, d, cfg.last_ksize)

    dec = {"init_conv1d": conv(d, nf * mult, cfg.ksize), "layers": {}}
    li = 0
    for ratio in cfg.ratios:
        dec["layers"][str(li)] = conv(nf * mult, nf * mult // 2, ratio * 2)  # transposed
        dec["layers"][str(li + 1)] = resblock(nf * mult // 2)
        li += 2
        mult //= 2
    dec["final_conv1d"] = conv(nf, 1, cfg.last_ksize)

    def norm():
        return {"weight": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}

    def xformer():
        return {"layers": {str(i): {
            "self_attn": {n: linear(d, d) for n in ("q", "k", "v", "o")},
            "norm1": norm(), "norm2": norm(),
            "gamma_1": np.full((d,), cfg.layer_scale, np.float32),
            "gamma_2": np.full((d,), cfg.layer_scale, np.float32),
            "mlp": {"fc1": linear(d, cfg.t_ff), "fc2": linear(cfg.t_ff, d)},
        } for i in range(cfg.t_layers)}}

    def rvq(n):
        return {"vq": {"layers": {str(i): {"codebook": {
                    "embedding_sum": rng.standard_normal((cfg.bins, cfg.q_dim), dtype=np.float32),
                    "cluster_usage": np.ones((cfg.bins,), np.float32)}} for i in range(n)}},
                "input_proj": conv(d, cfg.q_dim, 1, bias=False),
                "output_proj": conv(cfg.q_dim, d, 1, bias=False)}

    return {"encoder": enc, "decoder": dec,
            "encoder_transformer": xformer(), "decoder_transformer": xformer(),
            "quantizer": {"rvq_first": rvq(1), "rvq_rest": rvq(cfg.n_q - 1)},
            "downsample": {"conv": conv(d, d, 2 * cfg.downsample_stride, bias=False)},
            # depthwise (groups = d), weight (K, 1, d)
            "upsample": {"convtr": conv(1, d, 2 * cfg.downsample_stride, bias=False)}}


_TRANSPOSED = re.compile(r"^decoder\.layers\.\d+\.weight$")


def conv_layout(key: str) -> str:
    """The torch layout of the 3-D leaf at dotted `key` of a Mimi tree:
    "transposed" (I, O, K) for the decoder's upsampling convolutions,
    "depthwise" (C, 1, K) for the ×2 upsampler, "conv" (O, I, K) for every
    other kernel."""
    if key == "upsample.convtr.weight":
        return "depthwise"
    if _TRANSPOSED.match(key):
        return "transposed"
    return "conv"


_PERMS = {"conv": (2, 1, 0), "transposed": (1, 2, 0), "depthwise": (2, 1, 0)}


def params_from_numpy(tree: dict, device: torch.device | str = "cuda",
                      dtype: torch.dtype = torch.float32) -> dict:
    """A Mimi tree in the JAX layout → the port's, by `conv_layout`: (K, I, O)
    → (O, I, K), a transposed (K, I, O) → (I, O, K), the depthwise (K, 1, d)
    → (d, 1, K)."""
    flat = pytree.flatten(tree)
    return pytree.unflatten({
        k: convert._leaf(v, _PERMS[conv_layout(k)] if np.ndim(v) == 3 else None, device, dtype)
        for k, v in flat.items()})


def init_params(seed: int, cfg: MimiConfig, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters from a numpy seed with the JAX tree's keys, shapes
    and initialisation ranges, in torch's layouts, on the card unless
    `device` says otherwise."""
    return params_from_numpy(numpy_params(np.random.default_rng(seed), cfg), device, dtype)


# ------------------------------------------------------------------ causal convs

def causal_conv(p, x: torch.Tensor, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """Left-padded conv over (B, T, C): out length T // stride."""
    k_eff = (p["weight"].shape[-1] - 1) * dilation + 1
    return layers.conv1d(p, x, stride=stride, padding=(k_eff - stride, 0), dilation=dilation)


def causal_conv_transpose(p, x: torch.Tensor, stride: int, groups: int = 1) -> torch.Tensor:
    """Causal transposed conv: the full output (T − 1)·s + K cut on the
    right to T·s."""
    y = layers.conv_transpose1d(p, x, stride=stride, groups=groups)
    trim = p["weight"].shape[-1] - stride
    return y[:, : y.shape[1] - trim] if trim > 0 else y


# ------------------------------------------------------------------ pieces

def _resblock(rb, x: torch.Tensor) -> torch.Tensor:
    y = causal_conv(rb["0"], F.elu(x))
    return x + causal_conv(rb["1"], F.elu(y))


def seanet_encode(params, cfg: MimiConfig, audio: torch.Tensor) -> torch.Tensor:
    """(B, T) → (B, T/960, dimension)."""
    p = params["encoder"]
    x = causal_conv(p["init_conv1d"], audio[..., None])
    for i, ratio in enumerate(reversed(cfg.ratios)):
        x = _resblock(p["layers"][str(2 * i)]["block"], x)
        x = causal_conv(p["layers"][str(2 * i + 1)], F.elu(x), stride=ratio)
    return causal_conv(p["final_conv1d"], F.elu(x))


def seanet_decode(params, cfg: MimiConfig, z: torch.Tensor) -> torch.Tensor:
    """(B, T, dimension) → (B, T·960)."""
    p = params["decoder"]
    x = causal_conv(p["init_conv1d"], z)
    for i, ratio in enumerate(cfg.ratios):
        x = causal_conv_transpose(p["layers"][str(2 * i)], F.elu(x), stride=ratio)
        x = _resblock(p["layers"][str(2 * i + 1)]["block"], x)
    return causal_conv(p["final_conv1d"], F.elu(x))[..., 0]


def transformer_layer(lp, cfg: MimiConfig, x: torch.Tensor, q_pos: torch.Tensor, kv, mask):
    """One pre-norm layer with layer scale: x (B, T, D) at RoPE positions
    q_pos (T,); kv(k, v) returns the keys and values to attend."""
    b, t, d = x.shape
    heads = cfg.t_heads
    hd = d // heads
    inv = rope.base_inv_freq(hd, 10000.0)
    h = layers.layer_norm(lp["norm1"], x)
    q = rope.apply_rope(layers.linear(lp["self_attn"]["q"], h).reshape(b, t, heads, hd),
                        q_pos, inv)
    k = rope.apply_rope(layers.linear(lp["self_attn"]["k"], h).reshape(b, t, heads, hd),
                        q_pos, inv)
    v = layers.linear(lp["self_attn"]["v"], h).reshape(b, t, heads, hd)
    k, v = kv(k, v)
    o = attention.attend(q, k, v, mask, scale=1.0 / math.sqrt(hd))
    x = x + lp["gamma_1"].to(x.dtype) * layers.linear(lp["self_attn"]["o"], o.reshape(b, t, d))
    h = layers.layer_norm(lp["norm2"], x)
    h = layers.linear(lp["mlp"]["fc2"],
                      F.gelu(layers.linear(lp["mlp"]["fc1"], h), approximate="tanh"))
    return x + lp["gamma_2"].to(x.dtype) * h


def window_mask(q_pos: torch.Tensor, key_pos: torch.Tensor, context: int) -> torch.Tensor:
    """Additive (1, 1, Tq, Tk) f32 mask: query at q attends keys at
    max(0, q − context + 1) … q."""
    ok = ((key_pos[None, :] >= 0) & (key_pos[None, :] <= q_pos[:, None])
          & (key_pos[None, :] > q_pos[:, None] - context))
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, attention.NEG_INF)[None, None]


def transformer_apply(params, cfg: MimiConfig, x: torch.Tensor) -> torch.Tensor:
    """The causal RoPE transformer with layer scale over a context window."""
    pos = torch.arange(x.shape[1], device=x.device)
    mask = window_mask(pos, pos, cfg.t_context)
    for i in range(cfg.t_layers):
        x = transformer_layer(params["layers"][str(i)], cfg, x, pos, lambda k, v: (k, v), mask)
    return x


def _codebook_embed(cb) -> torch.Tensor:
    return cb["embedding_sum"] / torch.clamp(cb["cluster_usage"], min=1e-5)[:, None]


def rvq_encode(q, x: torch.Tensor, n: int) -> torch.Tensor:
    """x (B, T, D) → codes (B, n, T): each stage the code nearest to the
    residual (argmax of x·e − |e|²/2)."""
    if "input_proj" in q:
        x = layers.conv1d(q["input_proj"], x)
    residual = x
    codes = []
    for i in range(n):
        emb = _codebook_embed(q["vq"]["layers"][str(i)]["codebook"])
        c2 = (emb * emb).sum(-1) / 2
        idx = (residual @ emb.T - c2[None, None, :]).argmax(dim=-1)
        residual = residual - emb[idx]
        codes.append(idx)
    return torch.stack(codes, dim=1)


def rvq_decode(q, codes: torch.Tensor, n: int) -> torch.Tensor:
    """codes (B, n, T) → (B, T, D). Codes past a codebook read its last row,
    as the JAX gather clamps them."""
    z = None
    for i in range(n):
        emb = _codebook_embed(q["vq"]["layers"][str(i)]["codebook"])
        quant = emb[codes[:, i].clamp(0, emb.shape[0] - 1)]
        z = quant if z is None else z + quant
    if "output_proj" in q:
        z = layers.conv1d(q["output_proj"], z)
    return z


def split_rvq_encode(params, cfg: MimiConfig, z: torch.Tensor) -> torch.Tensor:
    first = rvq_encode(params["quantizer"]["rvq_first"], z, 1)
    rest = rvq_encode(params["quantizer"]["rvq_rest"], z, cfg.n_q - 1)
    return torch.cat([first, rest], dim=1)


def split_rvq_decode(params, cfg: MimiConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, n_q ≤ cfg.n_q, T) → (B, T, D): fewer codebooks than
    cfg.n_q decode the first n_q stages."""
    n_q = codes.shape[1]
    z = rvq_decode(params["quantizer"]["rvq_first"], codes[:, :1], 1)
    if n_q > 1:
        z = z + rvq_decode(params["quantizer"]["rvq_rest"], codes[:, 1:], n_q - 1)
    return z


# ------------------------------------------------------------------ top level

def encode(params, cfg: MimiConfig, audio: torch.Tensor) -> torch.Tensor:
    """(B, T samples) → codes (B, n_q, T/1920)."""
    z = transformer_apply(params["encoder_transformer"], cfg, seanet_encode(params, cfg, audio))
    # the ×2 downsample pads by repeating the first frame, not with zeros
    pad = params["downsample"]["conv"]["weight"].shape[-1] - cfg.downsample_stride
    z = torch.cat([z[:, :1].expand(-1, pad, -1), z], dim=1)
    z = layers.conv1d(params["downsample"]["conv"], z, stride=cfg.downsample_stride)
    return split_rvq_encode(params, cfg, z)


def decode(params, cfg: MimiConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, n_q, T) → waveform (B, T·1920)."""
    z = split_rvq_decode(params, cfg, codes)
    z = causal_conv_transpose(params["upsample"]["convtr"], z, cfg.downsample_stride,
                              groups=cfg.dimension)
    z = transformer_apply(params["decoder_transformer"], cfg, z)
    return seanet_decode(params, cfg, z)
