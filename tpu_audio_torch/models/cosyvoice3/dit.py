"""CosyVoice3's DiT flow estimator (port of tpu_audio/models/cosyvoice3/dit.py:
DiTConfig, init_params, forward, the stream cache and forward_chunk).

The time t goes through a sinusoid of 256 (scale 1000, frequencies over
half_dim − 1) and a SiLU MLP; the input embedding projects [x, cond, mu,
spk] and adds a causal position embedding (two grouped k31 convolutions,
mish after each); each block modulates its affine-free LayerNorms
(eps 1e-6) by shift, scale and gate from SiLU(t) (AdaLayerNormZero),
attends with RoPE on the first head_dim channels of the flat projection
only (`_rope_flat`, GPT-J pairs), and runs a tanh-GELU MLP; a final
modulated LayerNorm and a projection give the velocity. Streaming masks
are chunk-causal at static_chunk_size frames, unbounded on the left unless
num_left_chunks ≥ 0.

`forward_chunk` computes the velocity of the new frames only: each frame's
keys and values are computed once, when its chunk runs, and kept in a
`DiTStreamCache` with the two convolutions' tails; the mask runs over
absolute positions (slot + base), so sliding the ring keeps chunk
boundaries and RoPE distances. A chunk padded past its real frames (the
synthesizer pads 50 to 64) carries the tails of its real frames: the JAX
module carries the padded chunk's last frames, so its next chunk's
position embedding reads the pads (ROADMAP C21). Attention always carries a mask here, so
it is the plain `attend`: the JAX package runs no Pallas kernel in the DiT.

Under tensor parallelism (`parallel.shardings.local_tree` with flow_rules,
cfg.heads a rank's share) only the rank holding head 0 rotates.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch.codecs.s3gen.flow import mish
from tpu_audio_torch.codecs.s3gen.params import Init
from tpu_audio_torch.nn import attention, layers


@dataclass(frozen=True)
class DiTConfig:
    mel_dim: int = 80
    dim: int = 1024
    depth: int = 22
    heads: int = 16
    head_dim: int = 64
    ff_mult: int = 2
    mu_dim: int = 512
    spk_dim: int = 80
    conv_pos_kernel: int = 31
    conv_pos_groups: int = 16
    static_chunk_size: int = 50
    num_left_chunks: int = -1  # -1: unbounded

    @property
    def in_concat(self) -> int:
        return self.mel_dim * 2 + self.mu_dim + self.spk_dim


def numpy_params(rng: np.random.Generator, cfg: DiTConfig) -> dict:
    """The JAX `init_params` tree (JAX layouts, grouped conv kernels
    (k, dim/groups, dim)) as f32 numpy arrays."""
    init, d = Init(rng), cfg.dim
    inner, gi = cfg.heads * cfg.head_dim, d // cfg.conv_pos_groups

    def conv():  # the JAX init_conv1d's (k, in/groups, out) with its fan-in
        return init.conv(gi, d, cfg.conv_pos_kernel)
    blocks = {str(i): {"attn_norm": {"linear": init.linear(d, d * 6)},
                       "attn": {"to_q": init.linear(d, inner), "to_k": init.linear(d, inner),
                                "to_v": init.linear(d, inner), "to_out": init.linear(inner, d)},
                       "ff": {"fc1": init.linear(d, d * cfg.ff_mult),
                              "fc2": init.linear(d * cfg.ff_mult, d)}}
              for i in range(cfg.depth)}
    return {"time_embed": {"time_mlp_0": init.linear(256, d), "time_mlp_2": init.linear(d, d)},
            "input_embed": {"proj": init.linear(cfg.in_concat, d), "conv1": conv(),
                            "conv2": conv()},
            "blocks": blocks, "final_norm": {"linear": init.linear(d, d * 2)},
            "proj_out": init.linear(d, cfg.mel_dim)}


def _ln(x: torch.Tensor) -> torch.Tensor:
    """Affine-free LayerNorm, eps 1e-6, in f32."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(x.dtype)


def _time_embed(p, t: torch.Tensor, dim_freq: int = 256) -> torch.Tensor:
    half = dim_freq // 2
    freqs = torch.exp(-np.log(10000.0) * torch.arange(half, device=t.device) / (half - 1))
    ang = 1000.0 * t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(t.dtype)
    return layers.linear(p["time_mlp_2"], F.silu(layers.linear(p["time_mlp_0"], emb)))


def _conv_pos(p, x: torch.Tensor, cfg: DiTConfig) -> torch.Tensor:
    k, g = cfg.conv_pos_kernel, cfg.conv_pos_groups
    h = mish(layers.conv1d(p["conv1"], x, padding=(k - 1, 0), groups=g))
    return mish(layers.conv1d(p["conv2"], h, padding=(k - 1, 0), groups=g))


def _rope_flat(x: torch.Tensor, pos: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Rotary on the flat projection (B, T, inner): only its first head_dim
    channels (head 0 after the reshape) rotate, in GPT-J pairs (2i, 2i+1)
    at frequency 10000^(−2i/head_dim)."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, head_dim, 2, device=x.device) / head_dim))
    ang = pos[:, None].float() * inv[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    rot = x[..., :head_dim].float()
    a, b = rot[..., 0::2], rot[..., 1::2]
    rotated = torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1).reshape(rot.shape)
    return torch.cat([rotated.to(x.dtype), x[..., head_dim:]], dim=-1)


def _modulation(linear_p, t_emb, n: int):
    return layers.linear(linear_p, F.silu(t_emb)).chunk(n, dim=-1)


def _blocks(params, cfg: DiTConfig, h, t_emb, pos, bias, kv=None):
    """The DiT blocks over h (B, T, dim) at positions pos (T,); kv(i, k, v)
    returns the keys and values block i attends (the cache's, or k, v)."""
    b, t, _ = h.shape
    hd = cfg.head_dim
    for i in range(cfg.depth):
        bp = params["blocks"][str(i)]
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = _modulation(
            bp["attn_norm"]["linear"], t_emb, 6)
        hn = _ln(h) * (1 + sc_msa[:, None]) + sh_msa[:, None]
        q, k = layers.linear(bp["attn"]["to_q"], hn), layers.linear(bp["attn"]["to_k"], hn)
        if getattr(bp["attn"]["to_q"], "rank", 0) == 0:  # the rank holding head 0
            q, k = _rope_flat(q, pos, hd), _rope_flat(k, pos, hd)
        q, k = q.reshape(b, t, cfg.heads, hd), k.reshape(b, t, cfg.heads, hd)
        v = layers.linear(bp["attn"]["to_v"], hn).reshape(b, t, cfg.heads, hd)
        if kv is not None:
            k, v = kv(i, k, v)
        o = attention.attend(q, k.to(q.dtype), v.to(q.dtype), bias, scale=1.0 / math.sqrt(hd))
        h = h + g_msa[:, None] * layers.linear(bp["attn"]["to_out"], o.reshape(b, t, -1))
        hn = _ln(h) * (1 + sc_mlp[:, None]) + sh_mlp[:, None]
        ff = layers.linear(bp["ff"]["fc2"], F.gelu(layers.linear(bp["ff"]["fc1"], hn),
                                                   approximate="tanh"))
        h = h + g_mlp[:, None] * ff
    scale, shift = _modulation(params["final_norm"]["linear"], t_emb, 2)
    h = _ln(h) * (1 + scale[:, None]) + shift[:, None]
    return layers.linear(params["proj_out"], h)


def _embed(params, x, cond, mu, spks):
    b, t, _ = x.shape
    spk = spks[:, None, :].expand(b, t, spks.shape[-1])
    return layers.linear(params["input_embed"]["proj"], torch.cat([x, cond, mu, spk], dim=-1))


def _neg(ok: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, attention.NEG_INF)


def forward(params, cfg: DiTConfig, x, mask_len, mu, t, spks, cond,
            streaming: bool = False) -> torch.Tensor:
    """The velocity (B, T, mel) of x, cond (B, T, mel), mu (B, T, mu_dim),
    spks (B, spk), t (B,), mask_len (B,); zero past mask_len."""
    b, tlen, _ = x.shape
    dev = x.device
    t_emb = _time_embed(params["time_embed"], t)
    h = _embed(params, x, cond, mu, spks)
    h = h + _conv_pos(params["input_embed"], h, cfg)
    ki = torch.arange(tlen, device=dev)
    bias = _neg(ki[None, :] < mask_len[:, None])[:, None, None, :]
    if streaming:
        qc, kc = ki[:, None] // cfg.static_chunk_size, ki[None, :] // cfg.static_chunk_size
        ok = kc <= qc
        if cfg.num_left_chunks >= 0:
            ok &= kc >= qc - cfg.num_left_chunks
        bias = bias + _neg(ok)[None, None]
    out = _blocks(params, cfg, h, t_emb, ki, bias)
    return torch.where((ki[None, :] < mask_len[:, None])[..., None], out, torch.zeros_like(out))


# ------------------------------------------------------------- streaming

@dataclass
class DiTStreamCache:
    """Frozen keys and values a flow timestep, with the convolutions'
    tails, for streaming at a fixed cost a chunk. Updated in place."""

    k: torch.Tensor           # (depth, B, S_max, H, hd)
    v: torch.Tensor
    conv1_tail: torch.Tensor  # (B, k − 1, dim): the input history feeding conv1
    conv2_tail: torch.Tensor  # (B, k − 1, dim): conv1's output history
    pos: torch.Tensor         # 0-d int64: the next free slot
    base: torch.Tensor        # 0-d int64: the absolute frame of slot 0


def make_stream_cache(cfg: DiTConfig, batch: int, s_max: int, dtype=torch.float32,
                      device: torch.device | str = "cuda") -> DiTStreamCache:
    kt = cfg.conv_pos_kernel - 1
    shape = (cfg.depth, batch, s_max, cfg.heads, cfg.head_dim)

    def zeros(*s):
        return torch.zeros(s, dtype=dtype, device=device)
    return DiTStreamCache(k=zeros(*shape), v=zeros(*shape), conv1_tail=zeros(batch, kt, cfg.dim),
                          conv2_tail=zeros(batch, kt, cfg.dim),
                          pos=torch.zeros((), dtype=torch.int64, device=device),
                          base=torch.zeros((), dtype=torch.int64, device=device))


def forward_chunk(params, cfg: DiTConfig, x, mu, t, spks, cond, cache: DiTStreamCache,
                  valid_new=None) -> torch.Tensor:
    """The velocity (B, Tn, mel) of the new frames x / cond (B, Tn, mel),
    mu (B, Tn, mu_dim): their keys and values go into the cache at pos,
    attention reads the cache under a chunk-causal mask over absolute
    positions, and the conv tails carry. valid_new (int or 0-d tensor):
    the real frames of the Tn (a ragged last chunk; the pad slots are
    masked and later overwritten). The cache advances by valid_new, in
    place."""
    b, tn, _ = x.shape
    s_max, dev = cache.k.shape[2], x.device
    pos = cache.pos
    valid = tn if valid_new is None else valid_new
    t_emb = _time_embed(params["time_embed"], t)
    h = _embed(params, x, cond, mu, spks)
    kk, g = cfg.conv_pos_kernel, cfg.conv_pos_groups
    ie = params["input_embed"]
    h1_in = torch.cat([cache.conv1_tail.to(h.dtype), h], dim=1)
    c1 = mish(layers.conv1d(ie["conv1"], h1_in, groups=g))
    h2_in = torch.cat([cache.conv2_tail.to(h.dtype), c1], dim=1)
    c2 = mish(layers.conv1d(ie["conv2"], h2_in, groups=g))
    h = h + c2

    slots = torch.arange(s_max, device=dev)
    qpos = cache.base + pos + torch.arange(tn, device=dev)
    qc = qpos[:, None] // cfg.static_chunk_size
    kc = (cache.base + slots)[None, :] // cfg.static_chunk_size
    ok = (kc <= qc) & (slots[None, :] < pos + valid)
    if cfg.num_left_chunks >= 0:
        ok &= kc >= qc - cfg.num_left_chunks
    bias = _neg(ok)[None, None]
    idx = pos + torch.arange(tn, device=dev)

    def kv(i, k, v):
        cache.k[i].index_copy_(1, idx, k.to(cache.k.dtype))
        cache.v[i].index_copy_(1, idx, v.to(cache.v.dtype))
        return cache.k[i], cache.v[i]

    out = _blocks(params, cfg, h, t_emb, qpos, bias, kv)
    # the tails end at the last real frame: [tail, chunk][valid : valid + k − 1]
    # (the JAX module keeps the padded chunk's last k − 1, ROADMAP C21)
    tail = torch.arange(kk - 1, device=dev) + valid
    cache.conv1_tail.copy_(h1_in.index_select(1, tail))
    cache.conv2_tail.copy_(h2_in.index_select(1, tail))
    cache.pos += valid
    return out
