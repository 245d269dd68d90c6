"""Marvis TTS, a CSM-style dual transformer over Mimi frames (port of
tpu_audio/models/marvis/model.py: BACKBONE_250M, DECODER_250M,
MarvisConfig, init_params, embed_frame_tokens, depth_ring_len,
backbone_ring_len, the sampler, frame_step, cache_to_fused,
frame_step_fused_bb).

A Llama backbone predicts codebook 0 from the summed text and audio
embeddings of a frame; a small depth decoder, with a fresh cache each
frame, predicts codebooks 1 … K−1 one after another, each through its own
output head (`audio_head`). Frames are K + 1 columns wide: K audio
codebooks and the text id, masked per row.

Two routes through the whole-stack step kernel (`ops/kernels/fused_step.py`,
one launch a token at B=1), as in the JAX package: `_depth_fused_decode`
runs each depth-decoder token as one launch on a ring of `depth_ring_len`
slots, and `frame_step_fused_bb` runs the backbone's one-token frame step
as one launch on its cache in the kernel's layout (`cache_to_fused`, after
the prefill). The kernel's cache is bf16 on the card; on the CPU the plain
version takes the activations' dtype, as the JAX package does.

Sampling: temperature, then top-k, then a categorical draw as the Gumbel
argmax (`ops/sampling.sample`), from a `torch.Generator` or from noise
handed in (a test feeds `jax.random.gumbel` of the JAX keys); temperature
0 is the argmax. The tensors stay on the device through a frame.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.nn import layers, transformer
from tpu_audio_torch.ops import sampling
from tpu_audio_torch.ops.kernels import fused_step as fs
from tpu_audio_torch.ops.kvcache import KVCache

# marvis-tts-250m flavors
BACKBONE_250M = transformer.TransformerConfig(
    dim=1024, n_layers=16, n_heads=16, n_kv_heads=8, hidden_dim=4096,
    rope_theta=500000.0,
    rope_scaling={"rope_type": "llama3", "factor": 32.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192})
DECODER_250M = transformer.TransformerConfig(
    dim=1024, n_layers=4, n_heads=8, n_kv_heads=2, hidden_dim=4096,
    rope_theta=500000.0)


@dataclass(frozen=True)
class MarvisConfig:
    backbone: transformer.TransformerConfig = BACKBONE_250M
    decoder: transformer.TransformerConfig = DECODER_250M
    text_vocab_size: int = 128256
    audio_vocab_size: int = 2048
    n_codebooks: int = 32
    sample_rate: int = 24000
    frame_rate: float = 12.5


def numpy_params(rng: np.random.Generator, cfg: MarvisConfig) -> dict:
    """The JAX `init_params` tree (stacked (L, …) backbone and decoder
    layers; `audio_head` (K − 1, D_dec, V)) as f32 numpy arrays with its
    initialisation ranges."""
    def table(rows, dim):
        return {"weight": rng.standard_normal((rows, dim), dtype=np.float32) * np.float32(0.02)}

    def linear(i, o):
        return {"weight": (rng.random((o, i), dtype=np.float32) * 2 - 1)
                * np.float32(1.0 / math.sqrt(i))}

    bd, dd, v = cfg.backbone.dim, cfg.decoder.dim, cfg.audio_vocab_size
    return {
        "backbone": transformer.numpy_params(rng, cfg.backbone),
        "decoder": transformer.numpy_params(rng, cfg.decoder),
        "text_embeddings": table(cfg.text_vocab_size, bd),
        "audio_embeddings": table(v * cfg.n_codebooks, bd),
        "projection": linear(bd, dd),
        "codebook0_head": linear(bd, v),
        "audio_head": rng.standard_normal((cfg.n_codebooks - 1, dd, v), dtype=np.float32)
        * np.float32(0.02),
    }


def init_params(seed: int, cfg: MarvisConfig, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters from a numpy seed with the JAX tree's keys, shapes
    and initialisation ranges, on the card unless `device` says otherwise."""
    return params_from_numpy(numpy_params(np.random.default_rng(seed), cfg), device, dtype)


def embed_frame_tokens(params, cfg: MarvisConfig, tokens: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """tokens (B, T, K+1) ints, mask (B, T, K+1) → the summed embeddings
    (B, T, D). Column K is the text id; columns 0 … K−1 are audio codes
    offset by their codebook's index into the one audio table."""
    k = cfg.n_codebooks
    offsets = torch.arange(k, device=tokens.device) * cfg.audio_vocab_size
    audio_emb = layers.embedding(params["audio_embeddings"], tokens[..., :k] + offsets)
    text_emb = layers.embedding(params["text_embeddings"], tokens[..., k])
    embeds = torch.cat([audio_emb, text_emb[..., None, :]], dim=-2)
    return (embeds * mask[..., None].to(embeds.dtype)).sum(dim=-2)


def depth_ring_len(cfg: MarvisConfig) -> int:
    """The depth decoder's cache ring a frame (8-aligned)."""
    return -(-(cfg.n_codebooks + 1) // 8) * 8


def backbone_ring_len(prompt_pad: int, max_frames: int, frame_span: int) -> int:
    """The backbone cache ring of one sentence's prompt bucket (8-aligned)."""
    return -(-(prompt_pad + max_frames + frame_span + 8) // 8) * 8


def fused_cache_dtype(device: torch.device, dtype: torch.dtype) -> torch.dtype:
    """The dtype of a cache the whole-stack step writes: bf16 on the card
    (the kernel's), `dtype` on the CPU (the JAX package's)."""
    return torch.bfloat16 if device.type == "cuda" else dtype


class Sampler:
    """Temperature → top-k → categorical, as the JAX `_sampler`. Each draw
    takes the next row of `noises` (Gumbel noise, (draws, B, V)) where
    given, else Gumbel noise from `generator`."""

    def __init__(self, temperature: float, top_k: int, generator: torch.Generator | None = None,
                 noises: torch.Tensor | None = None):
        self.cfg = sampling.SamplerConfig(temperature=temperature, top_k=top_k)
        self.generator, self.noises, self.draws = generator, noises, 0

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        noise = None
        if self.noises is not None and self.cfg.temperature != 0.0:
            noise = self.noises[self.draws].to(logits.device)
        self.draws += 1
        return sampling.sample(logits.float(), self.cfg, generator=self.generator, noise=noise)


@functools.lru_cache(maxsize=None)
def _depth_table(inv_freq: tuple, s_pad: int) -> tuple[np.ndarray, np.ndarray]:
    ang = np.arange(s_pad)[:, None] * np.asarray(inv_freq)[None, :]
    ang = np.concatenate([ang, ang], -1).astype(np.float32)
    return np.cos(ang), np.sin(ang)


def _depth_fused_decode(params, cfg: MarvisConfig, last_h: torch.Tensor, c0: torch.Tensor,
                        c0_embed: torch.Tensor, sample: Sampler,
                        max_codebooks: int) -> torch.Tensor:
    """The depth decode through the whole-stack step: one launch a codebook
    on a zeroed ring of `depth_ring_len` slots, with the cos/sin table of
    the static depth positions. Returns the frame (1, max_codebooks)."""
    dcfg, dev = cfg.decoder, last_h.device
    s_pad = depth_ring_len(cfg)
    shape = (dcfg.n_layers, dcfg.kv_heads, s_pad, dcfg.hd)
    kc = torch.zeros(shape, dtype=fused_cache_dtype(dev, last_h.dtype), device=dev)
    vc = torch.zeros_like(kc)
    cos_t, sin_t = (torch.as_tensor(t, device=dev)
                    for t in _depth_table(tuple(dcfg.inv_freq().tolist()), s_pad))
    slots = torch.arange(s_pad, device=dev)
    stack = fs.prepare_stack(params["decoder"])

    def dstep(x, i):
        return fs.fused_decode_step(stack, x, slots[i], slots[0], cos_t[i], sin_t[i], kc, vc,
                                    n_heads=dcfg.n_heads, n_kv_heads=dcfg.kv_heads, hd=dcfg.hd,
                                    eps=dcfg.norm_eps)

    dstep(layers.linear(params["projection"], last_h), 0)
    dh = dstep(layers.linear(params["projection"], c0_embed[:, 0]), 1)
    ci = sample(dh @ params["audio_head"][0].to(dh.dtype))
    frame = [c0, ci]
    for i in range(2, max_codebooks):
        emb = layers.embedding(params["audio_embeddings"],
                               (ci + (i - 1) * cfg.audio_vocab_size)[:, None])
        dh = dstep(layers.linear(params["projection"], emb[:, 0]), i)
        ci = sample(dh @ params["audio_head"][i - 1].to(dh.dtype))
        frame.append(ci)
    return torch.stack(frame, dim=1)


def _depth_decode(params, cfg: MarvisConfig, last_h: torch.Tensor, c0: torch.Tensor,
                  c0_embed: torch.Tensor, sample: Sampler, max_codebooks: int) -> torch.Tensor:
    """The per-op depth decode: a fresh cache, the sequence [h, c0, c1, …]
    projected, the first step over [h, c0] (T = 2)."""
    dcache = transformer.make_cache(cfg.decoder, last_h.shape[0], cfg.n_codebooks + 1,
                                    dtype=last_h.dtype, device=last_h.device)
    curr = torch.cat([last_h[:, None], c0_embed], dim=1)
    dh, dcache = transformer.forward_hidden(params["decoder"], cfg.decoder,
                                            layers.linear(params["projection"], curr), dcache)
    ci = sample(dh[:, -1] @ params["audio_head"][0].to(dh.dtype))
    frame = [c0, ci]
    for i in range(2, max_codebooks):
        emb = layers.embedding(params["audio_embeddings"],
                               (ci + (i - 1) * cfg.audio_vocab_size)[:, None])
        dh, dcache = transformer.forward_hidden(params["decoder"], cfg.decoder,
                                                layers.linear(params["projection"], emb), dcache)
        ci = sample(dh[:, -1] @ params["audio_head"][i - 1].to(dh.dtype))
        frame.append(ci)
    return torch.stack(frame, dim=1)


def _codebooks(params, cfg: MarvisConfig, last_h: torch.Tensor, sample: Sampler,
               max_codebooks: int, depth_fused: bool) -> torch.Tensor:
    """Codebook 0 from the backbone's last hidden state, then the depth
    decoder's: the frame (B, max_codebooks)."""
    c0 = sample(layers.linear(params["codebook0_head"], last_h))
    if max_codebooks == 1:
        return c0[:, None]
    c0_embed = layers.embedding(params["audio_embeddings"], c0[:, None])
    depth = _depth_fused_decode if depth_fused else _depth_decode
    return depth(params, cfg, last_h, c0, c0_embed, sample, max_codebooks)


def frame_step(params, cfg: MarvisConfig, tokens: torch.Tensor, mask: torch.Tensor,
               bb_cache: KVCache, *, max_codebooks: int, temperature: float = 0.9,
               top_k: int = 50, extra_mask: torch.Tensor | None = None,
               depth_fused: bool = False, generator: torch.Generator | None = None,
               noises: torch.Tensor | None = None):
    """One K-codebook frame. tokens (B, T, K+1) is the new input (the prompt
    at prefill, the previous frame after it); the backbone runs per op
    (`transformer.forward_hidden`) and advances bb_cache in place. Returns
    (frame (B, max_codebooks), bb_cache).

    depth_fused: each depth-decoder token as one whole-stack step launch
    (B=1). noises: (max_codebooks, B, V) Gumbel noise for the draws, in
    place of `generator`'s."""
    h = embed_frame_tokens(params, cfg, tokens, mask)
    h, bb_cache = transformer.forward_hidden(params["backbone"], cfg.backbone, h, bb_cache,
                                             extra_mask)
    sample = Sampler(temperature, top_k, generator, noises)
    return _codebooks(params, cfg, h[:, -1], sample, max_codebooks, depth_fused), bb_cache


def cache_to_fused(bb_cache: KVCache, dtype: torch.dtype | None = None):
    """KVCache (L, B=1, S, KVH, hd) → the step kernel's (L, KVH, S, hd)
    buffers (copies, in `dtype` or the cache's) and the position tensor:
    one transpose a sentence, after the prefill."""
    dtype = dtype or bb_cache.k.dtype
    kc = bb_cache.k[:, 0].transpose(1, 2).contiguous().to(dtype)
    vc = bb_cache.v[:, 0].transpose(1, 2).contiguous().to(dtype)
    return kc, vc, bb_cache.pos.clone()


def frame_step_fused_bb(params, cfg: MarvisConfig, tokens: torch.Tensor, mask: torch.Tensor,
                        kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor,
                        start: torch.Tensor, *, max_codebooks: int, temperature: float = 0.9,
                        top_k: int = 50, generator: torch.Generator | None = None,
                        noises: torch.Tensor | None = None):
    """A frame with the backbone's one-token step AND every depth-decoder
    step as whole-stack launches (1 + max_codebooks − 1 a frame).

    tokens/mask (1, 1, K+1): the previous frame; kc/vc: the backbone cache
    in the kernel's (L, KVH, S, hd) layout (`cache_to_fused`), slot `pos`
    written in place; pos, start: 0-d int64 tensors, the write slot and the
    first valid prompt slot (the left-pad mask). The caller advances pos.
    Returns (frame (1, max_codebooks), kc, vc)."""
    bcfg = cfg.backbone
    h = embed_frame_tokens(params, cfg, tokens, mask)[:, 0]  # (1, D)
    cos, sin = fs.make_cos_sin(pos, bcfg.inv_freq())
    last_h = fs.fused_decode_step(fs.prepare_stack(params["backbone"]), h, pos, start, cos, sin,
                                  kc, vc, n_heads=bcfg.n_heads, n_kv_heads=bcfg.kv_heads,
                                  hd=bcfg.hd, eps=bcfg.norm_eps).to(h.dtype)
    sample = Sampler(temperature, top_k, generator, noises)
    return _codebooks(params, cfg, last_h, sample, max_codebooks, True), kc, vc
