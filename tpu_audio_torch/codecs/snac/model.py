"""SNAC decoder, 24 kHz (port of tpu_audio/codecs/snac/model.py:
SNACConfig, init_params, embed_codes, decode_latent, decode_codes).

Hierarchical RVQ with per-level temporal strides (4/2/1), weight-normalised
out-projections, then a conv decoder: depthwise k7 + pointwise 1×1 in, 4
blocks of [snake → transposed conv (2·stride) → noise → 3 dilated residual
units], a final snake → conv k7 → tanh. Sequences are channels-last
(B, T, C) at the public functions, as in the JAX module; the convolutions
are `F.conv1d` / `F.conv_transpose1d` (XLA convolutions in the JAX
package, no Pallas kernel), with torch's weight layouts
(`convert.params_from_numpy` transposes the JAX tree's).

Noise: the JAX package draws N(0, 1) per (block, absolute upsampled
position) with its PRNG, which torch cannot reproduce. The port draws its
own, keyed the same way (`position_noise`: a 32-bit counter hash of
(seed, block, position) into Box–Muller), identical on the CPU and the card
up to float64 rounding. So a window decode is sample-identical to the
one-shot decode over the same region, as the engine's streaming needs.
Parity with the JAX decoder runs through `noises=`, which both take.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.nn import layers


@dataclass(frozen=True)
class SNACConfig:
    sampling_rate: int = 24000
    decoder_dim: int = 1024
    decoder_rates: tuple = (8, 8, 4, 2)
    latent_dim: int = 768
    codebook_size: int = 4096
    codebook_dim: int = 8
    vq_strides: tuple = (4, 2, 1)
    noise: bool = True
    depthwise: bool = True

    @property
    def hop(self) -> int:
        return math.prod(self.decoder_rates)  # 512 samples per latent frame


# ------------------------------------------------------------------ params

def numpy_params(rng: np.random.Generator, cfg: SNACConfig) -> dict:
    """The JAX `init_params` tree (JAX layouts: conv kernels (K, I, O)) as
    f32 numpy arrays with its initialisation ranges."""
    def uniform(shape, scale):
        return (rng.random(shape, dtype=np.float32) * 2 - 1) * np.float32(scale)

    def wn_conv(i, o, k, bias=True, groups=1):
        scale = 1.0 / math.sqrt(i // groups * k)
        v = uniform((k, i // groups, o), scale)
        p = {"weight_v": v, "weight_g": np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))}
        if bias:
            p["bias"] = uniform((o,), scale)
        return p

    def ones(c):
        return {"alpha": np.ones((1, 1, c), np.float32)}

    quant = {str(i): {"codebook": {"weight": rng.standard_normal(
                          (cfg.codebook_size, cfg.codebook_dim), dtype=np.float32)
                          * np.float32(0.02)},
                      "out_proj": wn_conv(cfg.codebook_dim, cfg.latent_dim, 1)}
             for i in range(len(cfg.vq_strides))}
    dec = {"depthwise_conv": wn_conv(cfg.latent_dim, cfg.latent_dim, 7, groups=cfg.latent_dim),
           "pointwise_conv": wn_conv(cfg.latent_dim, cfg.decoder_dim, 1),
           "blocks": {},
           "final_conv": wn_conv(cfg.decoder_dim // 16, 1, 7),
           "final_snake": ones(cfg.decoder_dim // 16)}
    for i, stride in enumerate(cfg.decoder_rates):
        in_dim, out_dim = cfg.decoder_dim // 2 ** i, cfg.decoder_dim // 2 ** (i + 1)
        groups = out_dim if cfg.depthwise else 1
        scale = 1.0 / math.sqrt(in_dim * 2 * stride)
        v = uniform((2 * stride, in_dim, out_dim), scale)
        blk = {"snake": ones(in_dim),
               "convT": {"weight_v": v,  # weight norm per input channel
                         "weight_g": np.sqrt((v * v).sum(axis=(0, 2), keepdims=True)),
                         "bias": uniform((out_dim,), scale)},
               "residuals": {}}
        if cfg.noise:
            blk["noise"] = {"linear": wn_conv(out_dim, 1, 1, bias=False)}
        for j in range(3):
            blk["residuals"][str(j)] = {"snake1": ones(out_dim),
                                        "conv1": wn_conv(out_dim, out_dim, 7, groups=groups),
                                        "snake2": ones(out_dim),
                                        "conv2": wn_conv(out_dim, out_dim, 1)}
        dec["blocks"][str(i)] = blk
    return {"quantizer": quant, "decoder": dec}


def init_params(seed: int, cfg: SNACConfig, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters from a numpy seed with the JAX tree's keys, shapes
    and initialisation ranges, in torch's layouts, on the card unless
    `device` says otherwise."""
    return params_from_numpy(numpy_params(np.random.default_rng(seed), cfg), device, dtype)


# ------------------------------------------------------------------ noise

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """h · c mod 2^32 for int64 h in [0, 2^32), without int64 overflow."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix(h):
    """A 32-bit avalanche hash (lowbias32), on a python int or an int64 tensor."""
    mul = _mul32 if isinstance(h, torch.Tensor) else (lambda v, c: v * c & _M32)
    h = h ^ (h >> 16)
    h = mul(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = mul(h, 0x846CA68B)
    return h ^ (h >> 16)


def position_noise(seed: int, block: int, start: int, length: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """N(0, 1) draws at absolute positions start .. start+length-1 of one
    decoder block, (1, length, 1) f32: each a pure function of (seed,
    block, position), so any window of a stream draws what the whole
    stream draws there."""
    pos = (start + torch.arange(length, device=device, dtype=torch.int64)) & _M32
    u = []
    for stream in (0, 1):
        key = _mix(_mix(_mix(seed & _M32) ^ block) ^ stream)
        h = _mix(pos ^ key)
        u.append(((h >> 8).double() + 0.5) / 2.0 ** 24)  # (0, 1)
    z = torch.sqrt(-2.0 * torch.log(u[0])) * torch.cos(2.0 * math.pi * u[1])
    return z.float()[None, :, None]


# ------------------------------------------------------------------ decode

def _snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    a, xf = alpha.float(), x.float()
    return (xf + torch.sin(a * xf) ** 2 / (a + 1e-9)).to(x.dtype)


def _conv_transpose(p, x: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """Weight-normalised transposed conv: weight_v (I, O, K), the norm per
    input channel."""
    q = {"weight": layers.weight_norm(p["weight_v"], p["weight_g"], (1, 2)).to(x.dtype)}
    if "bias" in p:
        q["bias"] = p["bias"]
    return layers.conv_transpose1d(q, x, stride=stride, padding=padding)


def embed_codes(params, cfg: SNACConfig, codes: list[torch.Tensor]) -> torch.Tensor:
    """codes[i]: (B, T_i) ints with T_i = T / vq_strides[i] → latent
    (B, T, latent_dim), summed over the levels. Codes past the codebook
    read its last row, as the JAX gather clamps them."""
    total = codes[-1].shape[1]  # the stride-1 level sets the frame count
    z = None
    for i, stride in enumerate(cfg.vq_strides):
        q = params["quantizer"][str(i)]
        ids = codes[i].clamp(0, q["codebook"]["weight"].shape[0] - 1)
        proj = layers.weight_norm_conv1d(q["out_proj"], layers.embedding(q["codebook"], ids))
        if stride > 1:
            proj = proj.repeat_interleave(stride, dim=1)
        proj = proj[:, :total]
        z = proj if z is None else z + proj
    return z


def decode_latent(params, cfg: SNACConfig, z: torch.Tensor, seed: int | None = None,
                  noises: list | None = None, noise_pos: int = 0) -> torch.Tensor:
    """latent (B, T, latent_dim) → waveform (B, T·hop).

    noises: per-block (B, T_i, 1) arrays replacing the draw (parity tests
    inject the JAX package's). Otherwise with a seed, `position_noise` from
    absolute latent frame `noise_pos` of z[:, 0], shared over the batch;
    with neither, no noise."""
    p = params["decoder"]
    x = layers.weight_norm_conv1d(p["depthwise_conv"], z, padding=3, groups=cfg.latent_dim)
    x = layers.weight_norm_conv1d(p["pointwise_conv"], x)
    upsample = 1
    for i, stride in enumerate(cfg.decoder_rates):
        blk = p["blocks"][str(i)]
        groups = cfg.decoder_dim // 2 ** (i + 1) if cfg.depthwise else 1
        x = _snake(x, blk["snake"]["alpha"])
        x = _conv_transpose(blk["convT"], x, stride, -(-stride // 2))
        if stride % 2 == 1:  # output_padding = stride % 2
            x = F.pad(x, (0, 0, 0, 1))
        upsample *= stride
        if cfg.noise and "noise" in blk:
            h = layers.weight_norm_conv1d(blk["noise"]["linear"], x)
            if noises is not None:
                noise = torch.as_tensor(np.asarray(noises[i]), dtype=x.dtype, device=x.device)
            elif seed is not None:
                noise = position_noise(seed, i, noise_pos * upsample, x.shape[1],
                                       x.device).to(x.dtype)
            else:
                noise = torch.zeros((1, x.shape[1], 1), dtype=x.dtype, device=x.device)
            x = x + noise * h
        for j, dil in enumerate((1, 3, 9)):
            r = blk["residuals"][str(j)]
            y = _snake(x, r["snake1"]["alpha"])
            y = layers.weight_norm_conv1d(r["conv1"], y, padding=3 * dil, dilation=dil,
                                          groups=groups)
            y = _snake(y, r["snake2"]["alpha"])
            x = x + layers.weight_norm_conv1d(r["conv2"], y)
    x = _snake(x, p["final_snake"]["alpha"])
    x = layers.weight_norm_conv1d(p["final_conv"], x, padding=3)
    return torch.tanh(x)[..., 0]


def decode_codes(params, cfg: SNACConfig, codes: list[torch.Tensor], seed: int | None = None,
                 noise_pos: int = 0) -> torch.Tensor:
    return decode_latent(params, cfg, embed_codes(params, cfg, codes), seed, noise_pos=noise_pos)
