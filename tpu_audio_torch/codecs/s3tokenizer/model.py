"""S3 speech tokenizer, V2 25 Hz (port of
tpu_audio/codecs/s3tokenizer/model.py: S3TokenizerConfig, init_params,
encode_hidden, fsq_encode, quantize).

100 Hz log-mel (B, T, n_mels) → two k3 convs (stride 2 each, GELU) → 6
blocks of pre-LN attention with rotary q/k and an FSMN memory (a depthwise
k31 conv over v) → FSQ: a projection to 8 dims, round(tanh · 0.999) + 1,
a base-3 sum → codes in [0, 6561) at 25 Hz. As in the JAX module:
  - the rotary frequencies use the exponent i/dim, not 2i/dim, and rotate
    halves (i, i + D/2);
  - q and k are each scaled by hd^-0.25 before the product;
  - padded frames are masked out of the keys, the convolutions' inputs and
    the FSMN memory.
Plain torch: the JAX package runs no Pallas kernel here.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from tpu_audio_torch.codecs.s3gen.params import Init
from tpu_audio_torch.convert import s3_params_from_numpy
from tpu_audio_torch.nn import attention, layers


@dataclass(frozen=True)
class S3TokenizerConfig:
    n_mels: int = 128
    n_audio_state: int = 1280
    n_audio_head: int = 20
    n_audio_layer: int = 6
    n_codebook_size: int = 6561
    stride: int = 2  # the first conv's stride; the total downsampling is stride · 2
    fsmn_kernel: int = 31


@functools.lru_cache(maxsize=None)
def freqs_cis(dim: int = 64, end: int = 2048, theta: float = 10000.0):
    """(cos, sin), each (end, dim/2) f32, at the reference's exponent i/dim."""
    half = dim // 2
    freqs = 1.0 / (theta ** (np.arange(half, dtype=np.float64) / dim))
    ang = np.outer(np.arange(end, dtype=np.float64), freqs)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def apply_rotary_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate dims (i, i + D/2) of x (B, T, H, D) by cos/sin (T, D/2)."""
    c = torch.cat([cos, cos], dim=-1)[None, :, None, :]
    s = torch.cat([sin, sin], dim=-1)[None, :, None, :]
    xf = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * c + rot * s).to(x.dtype)


def numpy_params(rng: np.random.Generator, cfg: S3TokenizerConfig) -> dict:
    """The JAX `init_params` tree (JAX layouts) as f32 numpy arrays."""
    init, d = Init(rng), cfg.n_audio_state
    blocks = {str(i): {
        "attn": {"query": init.linear(d, d), "key": init.linear(d, d, False),
                 "value": init.linear(d, d), "out": init.linear(d, d),
                 "fsmn_block": init.conv(1, d, cfg.fsmn_kernel, bias=False)},
        "attn_ln": init.norm(d),
        "mlp": {"fc1": init.linear(d, 4 * d), "fc2": init.linear(4 * d, d)},
        "mlp_ln": init.norm(d)} for i in range(cfg.n_audio_layer)}
    return {"encoder": {"conv1": init.conv(cfg.n_mels, d, 3), "conv2": init.conv(d, d, 3),
                        "blocks": blocks},
            "quantizer": {"fsq_codebook": {"project_down": init.linear(d, 8)}}}


def init_params(seed: int, cfg: S3TokenizerConfig, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters from a numpy seed, on the card unless `device`
    says otherwise."""
    return s3_params_from_numpy(numpy_params(np.random.default_rng(seed), cfg), device, dtype)


def _row_mask(n: int, lens: torch.Tensor) -> torch.Tensor:
    return (torch.arange(n, device=lens.device)[None, :] < lens[:, None])[..., None]


def _fsmn(p, v: torch.Tensor, pad_mask: torch.Tensor, kernel: int) -> torch.Tensor:
    """The depthwise memory over the value heads merged back to (B, T, D)."""
    b, t, h, hd = v.shape
    x = v.reshape(b, t, h * hd) * pad_mask
    left = (kernel - 1) // 2
    y = layers.conv1d(p, x, padding=(left, kernel - 1 - left), groups=h * hd)
    return (y + x) * pad_mask


def encode_hidden(params, cfg: S3TokenizerConfig, mel: torch.Tensor, mel_len):
    """mel (B, T, n_mels) 100 Hz with valid lengths mel_len (an int or
    (B,)) → (hidden (B, T/4, D), token lengths (B,))."""
    p = params["encoder"]
    b, t, _ = mel.shape
    mel_len = torch.as_tensor(mel_len, device=mel.device).reshape(-1).expand(b)
    x = layers.gelu(layers.conv1d(p["conv1"], mel * _row_mask(t, mel_len).to(mel.dtype),
                                  stride=cfg.stride, padding=1))
    len1 = (mel_len - 1) // cfg.stride + 1
    x = layers.gelu(layers.conv1d(p["conv2"], x * _row_mask(x.shape[1], len1).to(x.dtype),
                                  stride=2, padding=1))
    len2 = (len1 - 1) // 2 + 1
    t2 = x.shape[1]
    pad_mask = _row_mask(t2, len2).to(x.dtype)
    bias = attention.padding_mask(len2, t2)
    h, d = cfg.n_audio_head, cfg.n_audio_state
    hd = d // h
    cos, sin = (torch.as_tensor(a[:t2], device=x.device) for a in freqs_cis(hd, max(2048, t2)))
    scale = hd ** -0.25
    for i in range(cfg.n_audio_layer):
        bp = p["blocks"][str(i)]
        hx = layers.layer_norm(bp["attn_ln"], x)
        q = layers.linear(bp["attn"]["query"], hx).reshape(b, t2, h, hd)
        k = layers.linear(bp["attn"]["key"], hx).reshape(b, t2, h, hd)
        v = layers.linear(bp["attn"]["value"], hx).reshape(b, t2, h, hd)
        q = apply_rotary_half(q, cos, sin) * scale
        k = apply_rotary_half(k, cos, sin) * scale
        mem = _fsmn(bp["attn"]["fsmn_block"], v, pad_mask, cfg.fsmn_kernel)
        o = attention.attend(q, k, v, bias)
        x = x + layers.linear(bp["attn"]["out"], o.reshape(b, t2, d)) + mem
        hx = layers.layer_norm(bp["mlp_ln"], x)
        x = x + layers.linear(bp["mlp"]["fc2"], layers.gelu(layers.linear(bp["mlp"]["fc1"], hx)))
    return x, len2


def fsq_encode(params, hidden: torch.Tensor) -> torch.Tensor:
    """(B, T, D) → codes (B, T) int64 in [0, 6561)."""
    h = layers.linear(params["quantizer"]["fsq_codebook"]["project_down"], hidden).float()
    h = torch.round(torch.tanh(h) * 0.9990000128746033) + 1
    powers = 3.0 ** torch.arange(8, dtype=torch.float32, device=h.device)
    return (h * powers).sum(dim=-1).to(torch.int64)


def quantize(params, cfg: S3TokenizerConfig, mel: torch.Tensor, mel_len):
    """mel (B, T, n_mels) → (tokens (B, T/4), token lengths (B,))."""
    hidden, code_len = encode_hidden(params, cfg, mel, mel_len)
    return fsq_encode(params, hidden), code_len
