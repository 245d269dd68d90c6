"""Conditional flow matching: the CFG Euler solver and the causal U-Net
estimator (port of tpu_audio/codecs/s3gen/flow.py: EstimatorConfig,
CFMConfig, init_estimator, estimator_forward, cfm_solve, cfm_inference).

The estimator, channels-last, at full temporal resolution: a down stage
(causal resnet + 4 transformer blocks + a causal k3 conv), 12 mid stages
(resnet + 4 blocks), an up stage over the skip concat (resnet + 4 blocks
+ a causal k3 conv), a causal final block and a 1×1 projection; the time
embedding is a sinusoid at in_channels (× 1000) through a SiLU MLP. With
streaming, attention is chunk-causal at static_chunk_size 50 frames; as in
the JAX module (and the reference's subsequentChunkMask), num_left_chunks
(2) is carried but not applied, so a chunk sees its whole left context.

`cfm_solve`: z ~ N(0, 1) (from `noise`, an injectable source, or the
caller's tensor), a cosine t-schedule, and classifier-free guidance as
one batch of 2 a step (conditioned, and with mu, speaker and cond zeroed):
v = (1 + rate)·v_c − rate·v_u. The meanflow-distilled estimator
(Chatterbox Turbo, `EstimatorConfig(meanflow=True)`) carries a
`time_embed_mixer` (a Linear from 2·time_dim to time_dim, no bias) and
conditions on each Euler step's start t and end r: t_emb =
mixer([emb(t) | emb(r)]). `meanflow_inference` in
`models/chatterbox_turbo/model.py` drives it. The overlap `flow_cache` of
the JAX module is not ported: no caller passes it. Plain torch: the JAX
package runs no Pallas kernel here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch.codecs.s3gen.conformer import chunk_bias
from tpu_audio_torch.codecs.s3gen.params import Init
from tpu_audio_torch.nn import attention, layers

HEAD_DIM = 64


@dataclass(frozen=True)
class EstimatorConfig:
    in_channels: int = 320  # x(80) + mu(80) + spk(80) + cond(80)
    out_channels: int = 80
    channels: int = 256
    n_blocks: int = 4  # transformer blocks a stage
    num_mid_blocks: int = 12
    num_heads: int = 8
    static_chunk_size: int = 50
    num_left_chunks: int = 2
    meanflow: bool = False


@dataclass(frozen=True)
class CFMConfig:
    sigma_min: float = 1e-6
    t_scheduler: str = "cosine"
    inference_cfg_rate: float = 0.7
    n_timesteps: int = 10


def numpy_estimator(rng: np.random.Generator, cfg: EstimatorConfig) -> dict:
    """The JAX `init_estimator` tree (JAX layouts) as f32 numpy arrays."""
    init, ch = Init(rng), cfg.channels
    time_dim, inner = ch * 4, cfg.num_heads * HEAD_DIM

    def tblock():
        return {"norm1": init.norm(ch),
                "attn": {"q": init.linear(ch, inner, False), "k": init.linear(ch, inner, False),
                         "v": init.linear(ch, inner, False), "o": init.linear(inner, ch)},
                "norm3": init.norm(ch),
                "ff": {"fc1": init.linear(ch, ch * 4), "fc2": init.linear(ch * 4, ch)}}

    def resnet(dim, dim_out):
        return {"mlp_linear": init.linear(time_dim, dim_out),
                "block1": {"conv": init.conv(dim, dim_out, 3), "norm": init.norm(dim_out)},
                "block2": {"conv": init.conv(dim_out, dim_out, 3), "norm": init.norm(dim_out)},
                "res_conv": init.conv(dim, dim_out, 1)}

    def stage(dim):
        return {"resnet": resnet(dim, ch),
                "transformers": {str(i): tblock() for i in range(cfg.n_blocks)}}

    p = {"time_mlp": {"linear_1": init.linear(cfg.in_channels, time_dim),
                      "linear_2": init.linear(time_dim, time_dim)},
         "down": {**stage(cfg.in_channels), "downsample": init.conv(ch, ch, 3)},
         "mid": {str(m): stage(ch) for m in range(cfg.num_mid_blocks)},
         "up": {**stage(ch * 2), "upsample": init.conv(ch, ch, 3)},
         "final_block": {"conv": init.conv(ch, ch, 3), "norm": init.norm(ch)},
         "final_proj": init.conv(ch, cfg.out_channels, 1)}
    if cfg.meanflow:
        p["time_embed_mixer"] = init.linear(time_dim * 2, time_dim, False)
    return p


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _causal_conv(p, x, mask):
    return layers.conv1d(p, x * mask, padding=(p["weight"].shape[-1] - 1, 0))


def _causal_block(p, x, mask):
    return mish(layers.layer_norm(p["norm"], _causal_conv(p["conv"], x, mask))) * mask


def _resnet(p, x, mask, t_emb):
    h = _causal_block(p["block1"], x, mask)
    h = h + layers.linear(p["mlp_linear"], mish(t_emb))[:, None, :]
    h = _causal_block(p["block2"], h, mask)
    return h + layers.conv1d(p["res_conv"], x * mask)


def _tblock(p, x, bias, heads):
    b, t, _ = x.shape
    h = layers.layer_norm(p["norm1"], x)
    inner = p["attn"]["q"]["weight"].shape[0]
    hd = inner // heads
    q, k, v = (layers.linear(p["attn"][n], h).reshape(b, t, heads, hd) for n in "qkv")
    o = attention.attend(q, k, v, bias, scale=hd ** -0.5)
    x = x + layers.linear(p["attn"]["o"], o.reshape(b, t, inner))
    h = layers.layer_norm(p["norm3"], x)
    return x + layers.linear(p["ff"]["fc2"], layers.gelu(layers.linear(p["ff"]["fc1"], h)))


def _time_embed(params, dim: int, t: torch.Tensor) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, device=t.device) * (-np.log(10000.0) / (half - 1)))
    ang = 1000.0 * t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(t.dtype)
    return layers.linear(params["time_mlp"]["linear_2"],
                         F.silu(layers.linear(params["time_mlp"]["linear_1"], emb)))


def estimator_forward(params, cfg: EstimatorConfig, x, mask_len, mu, t, spks=None, cond=None,
                      streaming: bool = False, r=None):
    """x, mu, cond (B, T, 80); spks (B, 80); t (B,); mask_len (B,) →
    velocity (B, T, 80). r (B,): a meanflow step's end time, read through
    the tree's `time_embed_mixer`; without a mixer in the tree r is
    ignored, as both JAX callers drop it."""
    b, tlen, _ = x.shape
    mask = (torch.arange(tlen, device=x.device)[None, :] < mask_len[:, None])[..., None]
    mask = mask.to(x.dtype)
    t_emb = _time_embed(params, cfg.in_channels, t)
    if r is not None and "time_embed_mixer" in params:
        t_emb = layers.linear(params["time_embed_mixer"],
                              torch.cat([t_emb, _time_embed(params, cfg.in_channels, r)], dim=-1))
    parts = [x, mu]
    if spks is not None:
        parts.append(spks[:, None, :].expand(b, tlen, spks.shape[-1]))
    if cond is not None:
        parts.append(cond)
    h = torch.cat(parts, dim=-1)
    bias = chunk_bias(tlen, mask_len, cfg.static_chunk_size, streaming)

    def stage(p, h):
        h = _resnet(p["resnet"], h, mask, t_emb)
        for i in range(cfg.n_blocks):
            h = _tblock(p["transformers"][str(i)], h, bias, cfg.num_heads)
        return h

    h = stage(params["down"], h)
    skip = h
    h = _causal_conv(params["down"]["downsample"], h, mask)
    for m in range(cfg.num_mid_blocks):
        h = stage(params["mid"][str(m)], h)
    h = stage(params["up"], torch.cat([h, skip], dim=-1))
    h = _causal_conv(params["up"]["upsample"], h, mask)
    h = _causal_block(params["final_block"], h, mask)
    return layers.conv1d(params["final_proj"], h * mask) * mask


def t_span(cfm: CFMConfig, n_steps: int, device) -> torch.Tensor:
    """The solver's n_steps + 1 times in f32: linear, or cosine-warped."""
    ts = torch.linspace(0.0, 1.0, n_steps + 1, device=device)
    if cfm.t_scheduler == "cosine":
        ts = 1 - torch.cos(ts * 0.5 * torch.pi)
    return ts


def cfm_solve(estimator_fn, cfm: CFMConfig, mu, mask_len, spks, cond, z: torch.Tensor,
              streaming: bool = False, n_timesteps: int | None = None) -> torch.Tensor:
    """The CFG Euler solve from z (B, T, D): estimator_fn(x, mask_len, mu,
    t, spks, cond, streaming) → velocity; each step one batch of 2."""
    n_steps = n_timesteps or cfm.n_timesteps
    b = mu.shape[0]
    ts = t_span(cfm, n_steps, mu.device)
    rate = cfm.inference_cfg_rate
    mu_in = torch.cat([mu, torch.zeros_like(mu)])
    spk_in = None if spks is None else torch.cat([spks, torch.zeros_like(spks)])
    cond_in = None if cond is None else torch.cat([cond, torch.zeros_like(cond)])
    len_in = torch.cat([mask_len, mask_len])
    x = z.to(mu.dtype)
    for i in range(n_steps):
        t_in = ts[i].to(mu.dtype).expand(2 * b)
        v = estimator_fn(torch.cat([x, x]), len_in, mu_in, t_in, spk_in, cond_in, streaming)
        v_cfg = (1.0 + rate) * v[:b] - rate * v[b:]
        x = (x.float() + (ts[i + 1] - ts[i]) * v_cfg.float()).to(x.dtype)
    return x


def cfm_inference(params, est_cfg: EstimatorConfig, cfm: CFMConfig, mu, mask_len, spks, cond,
                  z: torch.Tensor, streaming: bool = False,
                  n_timesteps: int | None = None) -> torch.Tensor:
    """ConditionalCFM.forward with the causal U-Net estimator, from z."""
    def est(x, ml, mu_, t, spks_, cond_, stream):
        return estimator_forward(params, est_cfg, x, ml, mu_, t, spks_, cond_, stream)
    return cfm_solve(est, cfm, mu, mask_len, spks, cond, z, streaming, n_timesteps)
