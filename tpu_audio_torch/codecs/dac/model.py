"""Descript Audio Codec (DAC), encode, residual VQ and decode (port of
tpu_audio/codecs/dac/model.py: DACConfig, init_params, encode_latent,
quantize, encode, codes_to_latent, decode_latent, decode_codes).

Snake-activated weight-normalised convolutions: an encoder of 4 strided
blocks (3 dilated residual units each), a residual VQ whose nearest code is
found on L2-normalised vectors through per-stage in/out projections, and a
mirrored decoder of transposed convolutions, then tanh. Sequences are
channels-last (B, T, C) at the public functions, as in the JAX module; the
convolutions are `F.conv1d` / `F.conv_transpose1d` (XLA convolutions in the
JAX package, no Pallas kernel) with torch's weight layouts
(`convert.params_from_numpy` turns the JAX tree's). The Snake activation
and the weight-normalised transposed convolution are SNAC's
(`codecs/snac/model.py`).

The OuteTTS engine decodes in buckets of 25 frames: DAC's convolutions are
not causal, so the padded frames reach the last real ones, and the port
pads as the JAX engine does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch.codecs.snac.model import _conv_transpose, _snake
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.nn import layers


@dataclass(frozen=True)
class DACConfig:
    sampling_rate: int = 24000
    encoder_dim: int = 64
    encoder_rates: tuple = (2, 4, 5, 8)
    decoder_dim: int = 1536
    decoder_rates: tuple = (8, 5, 4, 2)
    n_codebooks: int = 2
    codebook_size: int = 1024
    codebook_dim: int = 8
    latent_dim: int = 1024  # encoder_dim * 2**len(rates)

    @property
    def hop(self) -> int:
        return math.prod(self.encoder_rates)  # 320 samples per frame


# ------------------------------------------------------------------ params

def numpy_params(rng: np.random.Generator, cfg: DACConfig) -> dict:
    """The JAX `init_params` tree (JAX layouts: conv kernels (K, I, O), Snake
    alphas (1, 1, C)) as f32 numpy arrays with its initialisation ranges."""
    def wn_conv(i, o, k, transpose=False):
        scale = np.float32(1.0 / math.sqrt(i * k))
        v = (rng.random((k, i, o), dtype=np.float32) * 2 - 1) * scale
        axes = (0, 2) if transpose else (0, 1)  # a transposed conv: the norm per input channel
        return {"weight_v": v, "weight_g": np.sqrt((v * v).sum(axis=axes, keepdims=True)),
                "bias": (rng.random((o,), dtype=np.float32) * 2 - 1) * scale}

    def snake(c):
        return {"alpha": np.ones((1, 1, c), np.float32)}

    def res_unit(dim):
        return {"snake1": snake(dim), "conv1": wn_conv(dim, dim, 7),
                "snake2": snake(dim), "conv2": wn_conv(dim, dim, 1)}

    enc = {"conv_in": wn_conv(1, cfg.encoder_dim, 7), "blocks": {}}
    dim = cfg.encoder_dim
    for i, stride in enumerate(cfg.encoder_rates):
        dim *= 2
        enc["blocks"][str(i)] = {
            "residuals": {str(j): res_unit(dim // 2) for j in range(3)},
            "snake": snake(dim // 2),
            "conv": wn_conv(dim // 2, dim, 2 * stride)}
    enc["snake_out"] = snake(dim)
    enc["conv_out"] = wn_conv(dim, cfg.latent_dim, 3)

    quant = {str(i): {
        "in_proj": wn_conv(cfg.latent_dim, cfg.codebook_dim, 1),
        "out_proj": wn_conv(cfg.codebook_dim, cfg.latent_dim, 1),
        "codebook": {"weight": rng.standard_normal((cfg.codebook_size, cfg.codebook_dim),
                                                   dtype=np.float32) * np.float32(0.02)},
    } for i in range(cfg.n_codebooks)}

    dec = {"conv_in": wn_conv(cfg.latent_dim, cfg.decoder_dim, 7), "blocks": {}}
    dim = cfg.decoder_dim
    for i, stride in enumerate(cfg.decoder_rates):
        out_dim = dim // 2
        dec["blocks"][str(i)] = {
            "snake": snake(dim),
            "convT": wn_conv(dim, out_dim, 2 * stride, transpose=True),
            "residuals": {str(j): res_unit(out_dim) for j in range(3)}}
        dim = out_dim
    dec["snake_out"] = snake(dim)
    dec["conv_out"] = wn_conv(dim, 1, 7)
    return {"encoder": enc, "quantizer": quant, "decoder": dec}


def init_params(seed: int, cfg: DACConfig, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters from a numpy seed with the JAX tree's keys, shapes
    and initialisation ranges, in torch's layouts, on the card unless
    `device` says otherwise."""
    return params_from_numpy(numpy_params(np.random.default_rng(seed), cfg), device, dtype)


# ------------------------------------------------------------------ forward

def _residual_unit(p, x: torch.Tensor, dilation: int) -> torch.Tensor:
    y = _snake(x, p["snake1"]["alpha"])
    y = layers.weight_norm_conv1d(p["conv1"], y, padding=3 * dilation, dilation=dilation)
    y = _snake(y, p["snake2"]["alpha"])
    return x + layers.weight_norm_conv1d(p["conv2"], y)


def encode_latent(params, cfg: DACConfig, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, T) → latent (B, T/hop, latent_dim)."""
    p = params["encoder"]
    x = layers.weight_norm_conv1d(p["conv_in"], audio[..., None], padding=3)
    for i, stride in enumerate(cfg.encoder_rates):
        blk = p["blocks"][str(i)]
        for j, dil in enumerate((1, 3, 9)):
            x = _residual_unit(blk["residuals"][str(j)], x, dil)
        x = _snake(x, blk["snake"]["alpha"])
        x = layers.weight_norm_conv1d(blk["conv"], x, stride=stride, padding=-(-stride // 2))
    x = _snake(x, p["snake_out"]["alpha"])
    return layers.weight_norm_conv1d(p["conv_out"], x, padding=1)


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def quantize(params, cfg: DACConfig, z: torch.Tensor):
    """Residual VQ: latent (B, T, D) → (codes (B, n_q, T) int64, z_q (B, T, D)).
    Each stage takes the code nearest to its projected residual after both
    are L2-normalised (the first of equal distances)."""
    residual = z
    z_q = torch.zeros_like(z)
    codes = []
    for i in range(cfg.n_codebooks):
        q = params["quantizer"][str(i)]
        enc_n = _l2n(layers.weight_norm_conv1d(q["in_proj"], residual))  # (B, T, cd)
        cb_n = _l2n(q["codebook"]["weight"].to(enc_n.dtype))
        dist = ((enc_n ** 2).sum(-1, keepdim=True) - 2 * enc_n @ cb_n.T
                + (cb_n ** 2).sum(-1)[None, None, :])
        idx = dist.argmin(dim=-1)  # (B, T)
        out = layers.weight_norm_conv1d(q["out_proj"], layers.embedding(q["codebook"], idx))
        z_q = z_q + out
        residual = residual - out
        codes.append(idx)
    return torch.stack(codes, dim=1), z_q


def encode(params, cfg: DACConfig, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, T) → codes (B, n_codebooks, T/hop)."""
    return quantize(params, cfg, encode_latent(params, cfg, audio))[0]


def decode_latent(params, cfg: DACConfig, z_q: torch.Tensor) -> torch.Tensor:
    """latent (B, T, latent_dim) → waveform (B, T·hop)."""
    p = params["decoder"]
    x = layers.weight_norm_conv1d(p["conv_in"], z_q, padding=3)
    for i, stride in enumerate(cfg.decoder_rates):
        blk = p["blocks"][str(i)]
        x = _snake(x, blk["snake"]["alpha"])
        x = _conv_transpose(blk["convT"], x, stride, -(-stride // 2))
        if stride % 2 == 1:  # torch output_padding = stride % 2
            x = F.pad(x, (0, 0, 0, 1))
        for j, dil in enumerate((1, 3, 9)):
            x = _residual_unit(blk["residuals"][str(j)], x, dil)
    x = _snake(x, p["snake_out"]["alpha"])
    x = layers.weight_norm_conv1d(p["conv_out"], x, padding=3)
    return torch.tanh(x)[..., 0]


def codes_to_latent(params, cfg: DACConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, n_q, T) → the summed projected latent (B, T, D). Codes past
    the codebook read its last row, as the JAX gather clamps them."""
    z_q = None
    for i in range(cfg.n_codebooks):
        q = params["quantizer"][str(i)]
        ids = codes[:, i].clamp(0, q["codebook"]["weight"].shape[0] - 1)
        out = layers.weight_norm_conv1d(q["out_proj"], layers.embedding(q["codebook"], ids))
        z_q = out if z_q is None else z_q + out
    return z_q


def decode_codes(params, cfg: DACConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, n_q, T) → waveform (B, T·hop)."""
    return decode_latent(params, cfg, codes_to_latent(params, cfg, codes))
