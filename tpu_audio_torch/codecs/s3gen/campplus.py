"""CAMPPlus x-vector speaker embedder (port of
tpu_audio/codecs/s3gen/campplus.py: CAMPPlusConfig, init_params, embed).

Mean-normalised Kaldi fbank (B, T, 80) → the FCM head (2-D convolutions
over (mel bin, frame) with residual blocks, batch-norm in eval) → a TDNN
stem (k5, stride 2, BN before ReLU) → three dense TDNN blocks of
context-aware-masked layers (a local conv gated by the sigmoid of
100-frame segment means plus the global mean) with transit layers → stats
pooling (mean, sqrt(var + 1e-5)) → a dense 192-d embedding. Plain torch
(`F.conv2d`, `F.conv1d`): the JAX package runs no Pallas kernel here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch.codecs.s3gen.params import Init
from tpu_audio_torch.convert import s3_params_from_numpy
from tpu_audio_torch.nn import layers


@dataclass(frozen=True)
class CAMPPlusConfig:
    feat_dim: int = 80
    embedding_size: int = 192
    growth_rate: int = 32
    bn_size: int = 4
    init_channels: int = 128
    blocks: tuple = (12, 24, 16)
    kernels: tuple = (3, 3, 3)
    dilations: tuple = (1, 2, 2)


def numpy_params(rng: np.random.Generator, cfg: CAMPPlusConfig) -> dict:
    """The JAX `init_params` tree (JAX layouts: 2-D kernels (KH, KW, I, O))
    as f32 numpy arrays."""
    init = Init(rng)

    def bn(c):
        return {"weight": np.ones(c, np.float32), "bias": np.zeros(c, np.float32),
                "running_mean": np.zeros(c, np.float32), "running_var": np.ones(c, np.float32)}

    def conv2d(i, o, k=3):
        return {"weight": init.uniform((k, k, i, o), 1.0 / np.sqrt(i * k * k))}

    def res2d(cin, cout, stride):
        p = {"conv1": conv2d(cin, cout), "bn1": bn(cout), "conv2": conv2d(cout, cout),
             "bn2": bn(cout)}
        if stride != 1 or cin != cout:
            p["shortcut"] = {"0": {"weight": init.uniform((1, 1, cin, cout), 0.1)}, "1": bn(cout)}
        return p

    head = {"conv1": conv2d(1, 32), "bn1": bn(32),
            "layer1": {"0": res2d(32, 32, 2), "1": res2d(32, 32, 1)},
            "layer2": {"0": res2d(32, 32, 2), "1": res2d(32, 32, 1)},
            "conv2": conv2d(32, 32), "bn2": bn(32)}
    fcm_out = 32 * ((cfg.feat_dim + 7) // 8)
    ch = cfg.init_channels
    blocks, transits = {}, {}
    for bi, (n_layers, k) in enumerate(zip(cfg.blocks, cfg.kernels)):
        inner = cfg.bn_size * cfg.growth_rate
        blk = {}
        for li in range(n_layers):
            blk[str(li)] = {
                "nonlinear1_bn": bn(ch), "linear1": init.conv(ch, inner, 1, bias=False),
                "nonlinear2_bn": bn(inner),
                "cam_layer": {"linear_local": init.conv(inner, cfg.growth_rate, k, bias=False),
                              "linear1": init.conv(inner, inner // cfg.bn_size, 1),
                              "linear2": init.conv(inner // cfg.bn_size, cfg.growth_rate, 1)}}
            ch += cfg.growth_rate
        blocks[str(bi)] = blk
        transits[str(bi)] = {"nonlinear_bn": bn(ch),
                             "linear": init.conv(ch, ch // 2, 1, bias=False)}
        ch //= 2
    return {"head": head,
            "tdnn": {"linear": init.conv(fcm_out, cfg.init_channels, 5, bias=False),
                     "bn": bn(cfg.init_channels)},
            "blocks": blocks, "transits": transits, "out_nonlinear_bn": bn(ch),
            "dense": {"linear": init.conv(ch * 2, cfg.embedding_size, 1, bias=False),
                      "nonlinear_bn": bn(cfg.embedding_size)}}


def init_params(seed: int, cfg: CAMPPlusConfig, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    return s3_params_from_numpy(numpy_params(np.random.default_rng(seed), cfg), device, dtype)


def batch_norm(p, x: torch.Tensor, eps: float = 1e-5, dim: int = -1) -> torch.Tensor:
    """Batch-norm in eval over channel axis `dim`, from the running stats, in f32."""
    shape = [1] * x.dim()
    shape[dim] = -1

    def stat(name):
        return p[name].float().reshape(shape)
    y = (x.float() - stat("running_mean")) * torch.rsqrt(stat("running_var") + eps)
    return (y * stat("weight") + stat("bias")).to(x.dtype)


def _conv2d(p, x: torch.Tensor, stride=(1, 1), padding=1) -> torch.Tensor:
    """x (B, C, F, T), weight (O, I, KH, KW): F is the JAX NHWC's H."""
    return F.conv2d(x, p["weight"].to(x.dtype), stride=stride, padding=padding)


def _res2d(p, x: torch.Tensor, stride: int) -> torch.Tensor:
    y = F.relu(batch_norm(p["bn1"], _conv2d(p["conv1"], x, (stride, 1)), dim=1))
    y = batch_norm(p["bn2"], _conv2d(p["conv2"], y), dim=1)
    if "shortcut" in p:
        sc = batch_norm(p["shortcut"]["1"],
                        _conv2d(p["shortcut"]["0"], x, (stride, 1), padding=0), dim=1)
    else:
        sc = x
    return F.relu(y + sc)


def _fcm(p, fbank: torch.Tensor) -> torch.Tensor:
    """(B, T, F) → (B, T, 32 · F/8), the channels of each bin together."""
    x = fbank.transpose(1, 2)[:, None]  # (B, 1, F, T)
    x = F.relu(batch_norm(p["bn1"], _conv2d(p["conv1"], x), dim=1))
    for name in ("layer1", "layer2"):
        x = _res2d(p[name]["0"], x, 2)
        x = _res2d(p[name]["1"], x, 1)
    x = F.relu(batch_norm(p["bn2"], _conv2d(p["conv2"], x, (2, 1)), dim=1))
    b, c, f, t = x.shape
    return x.permute(0, 3, 1, 2).reshape(b, t, c * f)


def _cam_layer(p, x: torch.Tensor, k: int, dil: int = 1) -> torch.Tensor:
    """The context-aware mask: a local conv times sigmoid of the 100-frame
    segment means plus the global mean."""
    local = layers.conv1d(p["linear_local"], x, padding=(k - 1) * dil // 2, dilation=dil)
    seg, t = 100, x.shape[1]
    n_seg = -(-t // seg)
    xp = F.pad(x, (0, 0, 0, n_seg * seg - t))
    context = xp.reshape(x.shape[0], n_seg, seg, -1).mean(dim=2) + x.mean(dim=1, keepdim=True)
    m = torch.sigmoid(layers.conv1d(p["linear2"], F.relu(layers.conv1d(p["linear1"], context))))
    return local * m.repeat_interleave(seg, dim=1)[:, :t]


def embed(params, cfg: CAMPPlusConfig, fbank: torch.Tensor) -> torch.Tensor:
    """fbank (B, T, feat_dim), mean-normalised → x-vector (B, 192)."""
    x = _fcm(params["head"], fbank)
    x = F.relu(batch_norm(params["tdnn"]["bn"],
                          layers.conv1d(params["tdnn"]["linear"], x, stride=2, padding=2)))
    for bi, (n_layers, k, dil) in enumerate(zip(cfg.blocks, cfg.kernels, cfg.dilations)):
        blk = params["blocks"][str(bi)]
        for li in range(n_layers):
            lp = blk[str(li)]
            h = layers.conv1d(lp["linear1"], F.relu(batch_norm(lp["nonlinear1_bn"], x)))
            h = _cam_layer(lp["cam_layer"], F.relu(batch_norm(lp["nonlinear2_bn"], h)), k, dil)
            x = torch.cat([x, h], dim=-1)
        tp = params["transits"][str(bi)]
        x = layers.conv1d(tp["linear"], F.relu(batch_norm(tp["nonlinear_bn"], x)))
    x = F.relu(batch_norm(params["out_nonlinear_bn"], x))
    stats = torch.cat([x.mean(dim=1), torch.sqrt(x.var(dim=1, unbiased=False) + 1e-5)],
                      dim=-1)[:, None, :]
    out = batch_norm(params["dense"]["nonlinear_bn"],
                     layers.conv1d(params["dense"]["linear"], stats))
    return out[:, 0]
