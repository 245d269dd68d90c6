"""Whisper encoder/decoder (port of tpu_audio/models/whisper/model.py:
init_params, encode, precompute_cross_kv, init_state, decode_step).

Architecture (reference: package/STT/Whisper/Layers/AudioEncoder.swift:16-96,
TextDecoder.swift:17-97, MultiHeadAttention.swift:85-135):
  encoder: conv1(k3,s1,p1)+gelu → conv2(k3,s2,p1)+gelu → +sinusoids →
           pre-norm blocks → ln_post
  decoder: tok_emb + learned pos_emb → blocks [self-attn (KV cache),
           cross-attn (precomputed encoder K/V), mlp] → ln → logits = h @ E.T
  attention scale (d/h)^-0.25 applied to BOTH q and k before the product.

`Whisper` holds the JAX tree's parameters with the same keys and the
stacked (L, …) block layout. The encoder takes one of three paths, as the
JAX `encode` does:
  - fp attention weights: the two bf16 fused-encoder kernels
    (`ops/kernels/fused_encoder.py`) and torch's GELU MLP;
  - all six block linears int8 (`load.serve_tree_int8`, the w8a8 serving
    tree): the four W8A8 kernels (`ops/kernels/fused_encoder_int8.py`:
    LN + QKV, attention + o-projection + LN2, fc1 + GELU, fc2 + residual);
  - any other tree (the mlx group-affine q4/q8 trees, mixed int8/fp trees),
    or any tree with `FUSED_ENC` off: the per-op blocks, whose projections
    and MLP are plain large products (cuBLAS, as the JAX package leaves them
    to XLA) around the `encoder_attention` kernel
    (`ops/kernels/encoder_attention.py`, `_self_attention`).
Over an int8 cross-K/V state, a single-token step at B=1 runs the whole
decoder in one launch (`ops/kernels/fused_whisper_step.py`) for fp and
int8 decoder weights; any other decoder (q4/q8) and B ≥ 2 run the
cross-attention kernel (`ops/kernels/cross_kv_attention.py`) per layer;
prefill dequantises per layer.

Quantised decoder linears and the tied lm head go through `nn.layers`: int8
to the int8 matmul kernels (`ops/kernels/int8_matmul.py`), q4/q8 to the
dequant-matmul kernel (`ops/kernels/quant_matmul.py`) up to 32 rows.
`forward_cross_qk` is the full-sequence decoder pass of word timestamps
(`timing.py`).

The training route (`encode_xla`, `forward_cross_qk`) is the JAX XLA
formulation in autograd ops; it reaches no kernel (below).
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.whisper.config import WhisperConfig
from tpu_audio_torch.nn.attention import attend, attend_plain, causal_mask, decode_mask
from tpu_audio_torch.nn.layers import (conv1d, embedding, embedding_as_linear,
                                       gelu, layer_norm, linear,
                                       sinusoidal_positions)
from tpu_audio_torch.ops.kernels import cross_kv_attention as ckv
from tpu_audio_torch.ops.kernels import encoder_attention as ea
from tpu_audio_torch.ops.kernels import fused_encoder as fe
from tpu_audio_torch.ops.kernels import fused_encoder_int8 as fe8
from tpu_audio_torch.ops.kernels import fused_whisper_step as fws
from tpu_audio_torch.ops.kvcache import KVCache


# The fused encoder blocks, or the per-op path for every tree (the JAX
# package's TPU_AUDIO_FUSED_ENC=0 A/B switch); on the per-op path, head
# pairs packed per row for the attention kernel, or head-major
# (TPU_AUDIO_PACKED_ATTN=0). The same names and meaning as the JAX module's.
FUSED_ENC = os.environ.get("TPU_AUDIO_FUSED_ENC", "1") != "0"
PACKED_ATTN = os.environ.get("TPU_AUDIO_PACKED_ATTN", "1") != "0"


def _encoder_kind(blocks: dict) -> str | None:
    """Which fused encoder the blocks can take: "int8" when all six block
    linears are int8, "fp" when the attention's four are fp (the bf16
    kernels read the packed q/k/v and o weights; the MLP goes through
    `linear`), else None: the per-op path."""
    attn = [blocks["attn"][n] for n in "qkvo"]
    if all("weight_i8" in p for p in attn + [blocks["mlp"][n] for n in ("fc1", "fc2")]):
        return "int8"
    return "fp" if all("weight" in p for p in attn) else None


# ------------------------------------------------------------------ params

def init_params(seed: int, cfg: WhisperConfig, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters from a numpy seed, with the tree, shapes and
    initialisation ranges of the JAX `init_params`, converted by
    `params_from_numpy` (so conv weights come out as (O, I, K)), on the card
    unless `device` says otherwise."""
    return params_from_numpy(numpy_params(np.random.default_rng(seed), cfg), device, dtype)


def numpy_params(rng: np.random.Generator, cfg: WhisperConfig) -> dict:
    """The tree of `init_params` in the JAX layout (conv kernels (K, I, O))
    as f32 numpy arrays drawn from `rng`."""
    def uniform(shape, fan_in):
        scale = np.float32(1.0 / math.sqrt(fan_in))
        return (rng.random(shape, dtype=np.float32) * 2 - 1) * scale

    def lin(lyr, fan_in, fan_out, bias=True):
        p = {"weight": uniform((lyr, fan_out, fan_in), fan_in)}
        if bias:
            p["bias"] = uniform((lyr, fan_out), fan_in)
        return p

    def norm(shape):
        return {"weight": np.ones(shape, np.float32),
                "bias": np.zeros(shape, np.float32)}

    def blocks(lyr, d, cross):
        def attn():
            return {"q": lin(lyr, d, d), "k": lin(lyr, d, d, bias=False),
                    "v": lin(lyr, d, d), "o": lin(lyr, d, d)}

        p = {"attn": attn(), "ln1": norm((lyr, d)),
             "mlp": {"fc1": lin(lyr, d, 4 * d), "fc2": lin(lyr, 4 * d, d)},
             "ln2": norm((lyr, d))}
        if cross:
            p["cross_attn"] = attn()
            p["ln_cross"] = norm((lyr, d))
        return p

    def conv(c_in, c_out):
        return {"weight": uniform((3, c_in, c_out), 3 * c_in),
                "bias": uniform((c_out,), 3 * c_in)}

    da, dt = cfg.n_audio_state, cfg.n_text_state
    return {
        "encoder": {"conv1": conv(cfg.n_mels, da), "conv2": conv(da, da),
                    "blocks": blocks(cfg.n_audio_layer, da, False),
                    "ln_post": norm((da,))},
        "decoder": {
            "token_embedding": {"weight": rng.standard_normal(
                (cfg.n_vocab, dt), dtype=np.float32) * np.float32(0.02)},
            "positional_embedding": rng.standard_normal(
                (cfg.n_text_ctx, dt), dtype=np.float32) * np.float32(0.02),
            "blocks": blocks(cfg.n_text_layer, dt, True),
            "ln": norm((dt,))},
    }


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: sub-dicts become submodules and
    leaves non-trainable parameters. `tree["name"]` and `"name" in tree`
    read it like the JAX param dicts; `layer(i)` slices the stacked leaves
    into a plain dict of views. A stacked int8 weight is not sliced: the
    layer's dict carries the whole "weight_i8_stacked" and "layer_idx" i,
    which `int8_linear` hands to the stacked kernel. `requires_grad_(True)`
    (nn.Module's) makes every leaf trainable, as `training.train` does."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def layer(self, i: int) -> dict:
        out = {name: m.layer(i) for name, m in self._modules.items()}
        for name, p in self._parameters.items():
            if name == "weight_i8":
                out.update(weight_i8_stacked=p, layer_idx=i)
            else:
                out[name] = p[i]
        return out


# ------------------------------------------------------------------ state

@dataclass
class DecoderState:
    cache: KVCache          # self-attention cache (L, B, n_text_ctx, H, hd)
    cross_k: torch.Tensor   # (L, B, 1500, H, hd), already scaled by (d/h)^-0.25
    cross_v: torch.Tensor


@dataclass
class DecoderStateQ8:
    """Decoder state with int8 cross-K/V (per-channel scales over T), read
    by the cross_kv_attention kernel at each single-token step."""

    cache: KVCache
    cross_k8: torch.Tensor   # (L, B, T_pad, H·hd) int8
    cross_v8: torch.Tensor
    cross_ksc: torch.Tensor  # (L, B, H·hd) f32
    cross_vsc: torch.Tensor


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads)


def _self_attention(p, x: torch.Tensor, n_heads: int, mask=None) -> torch.Tensor:
    """The per-op encoder's (and `forward_cross_qk`'s) self-attention, with
    the JAX function's three branches: fp weights and a long unmasked
    sequence (`ea.supported`) go to `encoder_attention_packed` when
    PACKED_ATTN is on, the head count is even and 2·hd = 128, else to the
    head-major `encoder_attention(pre_bh=True)`; quantised weights or a mask
    take `attend`, which routes long unmasked attention to the same kernel.
    hd^-0.25 scales q and k before the product, so the kernels' scale is 1."""
    b, t, d = x.shape
    hd = d // n_heads
    scale = hd ** -0.25
    q = _heads(linear(p["q"], x), n_heads) * scale
    k = _heads(linear(p["k"], x), n_heads) * scale
    v = _heads(linear(p["v"], x), n_heads)
    if mask is None and "weight" in p["q"] and ea.supported(q, k, mask):
        if PACKED_ATTN and n_heads % 2 == 0 and 2 * hd == 128:
            g = n_heads // 2

            def pairs(a):  # (B, T, H, hd) → (B·H/2, T, 2·hd)
                return a.reshape(b, t, g, 2 * hd).transpose(1, 2).reshape(b * g, t, 2 * hd)

            o = ea.encoder_attention_packed(pairs(q), pairs(k), pairs(v), scale=1.0)
            o = o.reshape(b, g, t, 2 * hd).transpose(1, 2)
        else:
            def bh(a):  # (B, T, H, hd) → (B·H, T, hd)
                return a.transpose(1, 2).reshape(b * n_heads, t, hd)

            o = ea.encoder_attention(bh(q), bh(k), bh(v), pre_bh=True, scale=1.0)
            o = o.reshape(b, n_heads, t, hd).transpose(1, 2)
    else:
        o = attend(q, k, v, mask)
    return linear(p["o"], o.reshape(b, t, d))


# ------------------------------------------------------------------ model

class Whisper(nn.Module):
    """Whisper over a parameter tree from `init_params` or
    `convert.params_from_numpy`.

    A tree that a fused encoder can take (`encoder_kind` "fp" or "int8")
    has the packed QKV weight of every block, attention scale folded in,
    computed once here: for fp blocks in f32 and stored in the parameters'
    dtype (`fe.pack_qkv_weights`); for int8 blocks as int8 codes with f32
    column scales (`fe8.pack_qkv_weights_int8`). The per-op path reads the
    tree's own leaves. The packed QKV and the B=1 step's f32 vectors are
    copies: an update of the leaves in place (an optimizer's) leaves them
    stale, so a trained tree is served by a `Whisper` built from it
    (`training.evaluate` builds one)."""

    def __init__(self, cfg: WhisperConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.encoder = ParamTree(params["encoder"])
        self.decoder = ParamTree(params["decoder"])
        # the B=1 step's small vectors in f32, as buffers so .to() moves them
        self._step_keys = []
        for name, t in fws.step_vectors(self.decoder).items():
            self.register_buffer(f"step_{name}", t, persistent=False)
            self._step_keys.append(name)
        self.fused_step = fws.decoder_supported(params["decoder"]["blocks"])
        attn = params["encoder"]["blocks"]["attn"]
        self.encoder_kind = _encoder_kind(params["encoder"]["blocks"])
        if self.encoder_kind == "int8":
            w, cs, b = fe8.pack_qkv_weights_int8(attn, cfg.n_audio_head)
            self.register_buffer("qkv_scale", cs, persistent=False)  # (L, 3D) f32
        elif self.encoder_kind == "fp":
            w, b = fe.pack_qkv_weights(attn, cfg.n_audio_head, attn["q"]["weight"].dtype)
        if self.encoder_kind is not None:
            self.register_buffer("qkv_weight", w, persistent=False)  # (L, 3D, D)
            self.register_buffer("qkv_bias", b, persistent=False)    # (L, 3D) f32
        pos = sinusoidal_positions(cfg.n_audio_ctx, cfg.n_audio_state)
        self.register_buffer("audio_positions", torch.from_numpy(pos).to(
            params["encoder"]["conv1"]["weight"].device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.audio_positions.device

    def step_weights(self) -> fws.StepWeights:
        """What `fused_whisper_decode_step` reads: views of the decoder's
        weights and the f32 vector buffers."""
        return fws.StepWeights.of(self.decoder, {
            name: getattr(self, f"step_{name}") for name in self._step_keys})

    # -------------------------------------------------------------- encoder

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, 2·n_audio_ctx, n_mels) → audio features (B, n_audio_ctx, D)
        in mel's dtype."""
        cfg, p = self.cfg, self.encoder
        x = stem_conv(p["conv2"], stem_conv(p["conv1"], mel, stride=1), stride=2)
        x = x + self.audio_positions.to(x.dtype)
        if not FUSED_ENC or self.encoder_kind is None:
            return layer_norm(p["ln_post"], self._encode_blocks_per_op(x))
        if self.encoder_kind == "int8":
            return layer_norm(p["ln_post"], self._encode_blocks_int8(x))
        blocks = p["blocks"]
        w_qkv = self.qkv_weight.to(x.dtype)
        ln1, ln2, o = blocks["ln1"], blocks["ln2"], blocks["attn"]["o"]
        for i in range(cfg.n_audio_layer):
            q, k, v = fe.ln_qkv(x, ln1["weight"][i].float(), ln1["bias"][i].float(),
                                w_qkv[i], self.qkv_bias[i], cfg.n_audio_head)
            y, hn = fe.attn_oproj_ln(q, k, v, x, o["weight"][i].to(x.dtype),
                                     o["bias"][i].float(), ln2["weight"][i].float(),
                                     ln2["bias"][i].float(), t_valid=x.shape[1])
            mlp = blocks["mlp"].layer(i)
            x = y + linear(mlp["fc2"], gelu(linear(mlp["fc1"], hn)))
        return layer_norm(p["ln_post"], x)

    def _encode_blocks_per_op(self, x: torch.Tensor) -> torch.Tensor:
        """The JAX per-op block body: self-attention (`_self_attention`),
        then the GELU MLP, each pre-norm with a residual."""
        cfg, blocks = self.cfg, self.encoder["blocks"]
        for i in range(cfg.n_audio_layer):
            bp = blocks.layer(i)
            x = x + _self_attention(bp["attn"], layer_norm(bp["ln1"], x), cfg.n_audio_head)
            hn = layer_norm(bp["ln2"], x)
            x = x + linear(bp["mlp"]["fc2"], gelu(linear(bp["mlp"]["fc1"], hn)))
        return x

    def _encode_blocks_int8(self, x: torch.Tensor) -> torch.Tensor:
        """The w8a8 blocks: four kernels per block on layer i's views of the
        stacked int8 leaves."""
        cfg, blocks = self.cfg, self.encoder["blocks"]
        ln1, ln2 = blocks["ln1"], blocks["ln2"]
        o, fc1, fc2 = blocks["attn"]["o"], blocks["mlp"]["fc1"], blocks["mlp"]["fc2"]
        for i in range(cfg.n_audio_layer):
            q, k, v = fe8.ln_qkv_int8(x, ln1["weight"][i].float(), ln1["bias"][i].float(),
                                      self.qkv_weight[i], self.qkv_scale[i],
                                      self.qkv_bias[i], cfg.n_audio_head)
            y, hn = fe8.attn_oproj_ln_int8(q, k, v, x, o["weight_i8"][i], o["scale_i8"][i],
                                           o["bias"][i].float(), ln2["weight"][i].float(),
                                           ln2["bias"][i].float(), t_valid=x.shape[1])
            g, sg = fe8.fc1_gelu_int8(hn, fc1["weight_i8"][i], fc1["scale_i8"][i],
                                      fc1["bias"][i].float())
            x = fe8.fc2_residual_int8(g, sg, y, fc2["weight_i8"][i], fc2["scale_i8"][i],
                                      fc2["bias"][i].float())
        return x

    # -------------------------------------------------------------- decoder

    def precompute_cross_kv(self, audio_features: torch.Tensor):
        """Project encoder output into per-layer cross K/V once per window:
        two (L, B, T, H, hd) tensors, K already scaled."""
        return precompute_cross_kv(self.tree(), self.cfg, audio_features)

    def init_state(self, audio_features: torch.Tensor, batch: int = 1,
                   dtype: torch.dtype = torch.float32,
                   kv_int8: bool = False) -> DecoderState | DecoderStateQ8:
        """kv_int8=True quantizes the cross-K/V to int8 at per-channel
        scales, once per window."""
        cfg = self.cfg
        ck, cv = self.precompute_cross_kv(audio_features)
        cache = KVCache.create(cfg.n_text_layer, batch, cfg.n_text_ctx,
                               cfg.n_text_head, cfg.n_text_state // cfg.n_text_head,
                               dtype=dtype, device=audio_features.device)
        if kv_int8:
            k8, ks, v8, vs = ckv.quantize_cross_kv(ck, cv)
            return DecoderStateQ8(cache=cache, cross_k8=k8, cross_v8=v8,
                                  cross_ksc=ks, cross_vsc=vs)
        return DecoderState(cache=cache, cross_k=ck, cross_v=cv)

    def decode_step(self, tokens: torch.Tensor, state: DecoderState | DecoderStateQ8):
        """tokens (B, T) fed at positions state.cache.pos.. → (logits (B, T, V),
        state). Serves prefill (T = n_init) and decode (T = 1). The state's
        self-attention cache is updated IN PLACE; the same state object is
        returned."""
        cfg, p = self.cfg, self.decoder
        b, t = tokens.shape
        h, d = cfg.n_text_head, cfg.n_text_state
        scale = (d // h) ** -0.25
        cache = state.cache
        q8 = isinstance(state, DecoderStateQ8)

        x = embedding(p["token_embedding"], tokens)
        idx = cache.pos + torch.arange(t, device=tokens.device)
        x = x + p["positional_embedding"].index_select(0, idx)[None].to(x.dtype)

        if q8 and b == 1 and t == 1 and self.fused_step:
            # single-stream serving on an fp or int8 decoder: the whole
            # decoder step in one launch, which writes this token's K/V slot
            # into the cache
            lyr = cfg.n_text_layer
            hfin = fws.fused_whisper_decode_step(
                self.step_weights(), x[:, 0], cache.pos,
                cache.k.view(lyr, cache.max_len, d), cache.v.view(lyr, cache.max_len, d),
                state.cross_k8, state.cross_ksc, state.cross_v8, state.cross_vsc,
                n_heads=h, t_valid=cfg.n_audio_ctx)
            cache.advance(1)
            return embedding_as_linear(p["token_embedding"],
                                       hfin[:, None].to(x.dtype)), state

        mask = decode_mask(cache.max_len, cache.pos, t)

        for i in range(cfg.n_text_layer):
            bp = p["blocks"].layer(i)
            # self-attention with cache
            hn = layer_norm(bp["ln1"], x)
            q = _heads(linear(bp["attn"]["q"], hn), h) * scale
            k = _heads(linear(bp["attn"]["k"], hn), h) * scale
            v = _heads(linear(bp["attn"]["v"], hn), h)
            cache.write(i, k, v)
            o = attend(q, cache.k[i].to(q.dtype), cache.v[i].to(q.dtype), mask)
            x = x + linear(bp["attn"]["o"], o.reshape(b, t, d))
            # cross-attention (K/V precomputed)
            hn = layer_norm(bp["ln_cross"], x)
            qc = _heads(linear(bp["cross_attn"]["q"], hn), h) * scale
            if q8 and t == 1:
                oc = ckv.cross_attention_decode(
                    qc[:, 0].float(), state.cross_k8, state.cross_v8,
                    state.cross_ksc[i], state.cross_vsc[i], i,
                    t_valid=cfg.n_audio_ctx, n_heads=h)[:, None].to(qc.dtype)
            elif q8:
                ckl = ckv.dequant_layer(state.cross_k8[i], state.cross_ksc[i],
                                        cfg.n_audio_ctx, h)
                cvl = ckv.dequant_layer(state.cross_v8[i], state.cross_vsc[i],
                                        cfg.n_audio_ctx, h)
                oc = attend(qc, ckl.to(qc.dtype), cvl.to(qc.dtype))
            else:
                oc = attend(qc, state.cross_k[i].to(qc.dtype),
                            state.cross_v[i].to(qc.dtype))
            x = x + linear(bp["cross_attn"]["o"], oc.reshape(b, t, d))
            # mlp
            hn = layer_norm(bp["ln2"], x)
            x = x + linear(bp["mlp"]["fc2"], gelu(linear(bp["mlp"]["fc1"], hn)))

        cache.advance(t)
        x = layer_norm(p["ln"], x)
        return embedding_as_linear(p["token_embedding"], x), state

    def forward_cross_qk(self, tokens: torch.Tensor, audio_features: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """The full-sequence decoder pass of word timestamps (module
        `forward_cross_qk`); kept off the decode path, as in the JAX package."""
        return forward_cross_qk(self.tree(), self.cfg, tokens, audio_features)

    def tree(self) -> dict:
        """The parameters as the training route's functions take them."""
        return {"encoder": self.encoder, "decoder": self.decoder}


# ------------------------------------------------------------ training route
#
# The JAX package's XLA formulation in autograd ops: the formulation its
# `jax.value_and_grad` differentiates, since no JAX kernel has a backward
# and every kernel gate is off on the CPU where its training runs. The conv
# stem, per-op blocks with q·k in f32 through `attend_plain`, and the
# decoder of `forward_cross_qk`: no function here reaches a wrapper of
# `ops/kernels` (on a card they refuse a tensor that needs a gradient),
# and nothing switches to the route by itself: `training.loss_fn` asks for
# `encode_xla` by name. Each function takes a parameter tree (nested dicts,
# `ParamTree`s, or `Whisper.tree()`) of fp leaves, which may be DTensors
# (`parallel.shard_tree`).

def layer_of(tree, i: int) -> dict:
    """Layer i of a stacked (L, ...) subtree: `ParamTree.layer`, or each
    leaf's [i] of a dict."""
    if isinstance(tree, ParamTree):
        return tree.layer(i)
    return {k: layer_of(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def on_rows(fn, x: torch.Tensor, *leaves: torch.Tensor) -> torch.Tensor:
    """fn(x, *leaves). Where the leaves are DTensors, fn runs on each rank's
    batch rows of x with the leaves whole (gathered where they are
    sharded), and autograd is told that a leaf's gradient is a partial sum
    over the ranks that hold other rows. It carries what DTensor's own rules
    do not: a conv whose weight is sharded over output channels
    (`parallel.whisper_rules`; torch 2.11's conv rule also exchanges halos
    along time where only the batch is sharded, and refuses stride 2), and
    the backward of an embedding lookup (torch 2.11's index_put rule)."""
    if not hasattr(leaves[0], "device_mesh"):
        return fn(x, *leaves)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = leaves[0].device_mesh
    whole = [Replicate()] * mesh.ndim
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, whole)
    if any(pl.is_shard() and pl.dim != 0 for pl in x.placements):
        raise ValueError(f"on_rows: rows sharded over {x.placements}, not over the batch")
    rows = [Partial() if pl.is_shard() else Replicate() for pl in x.placements]
    y = fn(x.to_local(), *(w.redistribute(mesh, whole).to_local(grad_placements=rows)
                           for w in leaves))
    shape = torch.Size((x.shape[0], *y.shape[1:]))
    return DTensor.from_local(y, mesh, x.placements, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def stem_conv(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """conv1d (kernel 3, padding 1) + GELU, by `on_rows`."""
    return on_rows(lambda x, w, b: gelu(conv1d({"weight": w, "bias": b}, x, stride=stride,
                                               padding=1)), x, p["weight"], p["bias"])


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The token embedding's rows (`nn.layers.embedding`; an fp table by
    `on_rows`)."""
    if "weight" not in p:
        return embedding(p, tokens)
    return on_rows(lambda ids, w: embedding({"weight": w}, ids), tokens, p["weight"])


def per_head(fn, tensors, head_dims):
    """fn(*tensors) on each rank's own rows and heads where the (B, T, H,
    hd) inputs are DTensors sharded over the batch (dim 0) or the heads
    (dim 2) only, each placed as the first: attention runs per row and
    head, so it needs no collective, and DTensor's rule for its einsum
    cannot flatten a batch and a head dim that are both sharded (torch
    2.11). fn returns a tuple; its i-th output keeps the batch at dim 0 and
    the heads at head_dims[i]. On plain tensors, fn itself."""
    q = tensors[0]
    if not hasattr(q, "device_mesh"):
        return fn(*tensors)
    from torch.distributed.tensor import DTensor, Shard

    mesh, place = q.device_mesh, q.placements
    if any(pl.is_shard() and (pl.dim not in (0, 2) or q.shape[pl.dim] % mesh.size(m))
           for m, pl in enumerate(place)):
        raise ValueError(f"per_head: q placed {place}, not evenly over rows or heads")
    outs = fn(*(t.redistribute(mesh, place).to_local() for t in tensors))
    return tuple(DTensor.from_local(o, mesh, [Shard(h) if pl.is_shard() and pl.dim == 2 else pl
                                              for pl in place])
                 for o, h in zip(outs, head_dims))


@functools.lru_cache(maxsize=4)
def _audio_positions(n_ctx: int, d: int) -> torch.Tensor:
    return torch.from_numpy(sinusoidal_positions(n_ctx, d))


def stem_xla(p: dict, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """conv1 + GELU → conv2 (stride 2) + GELU → + sinusoids."""
    x = stem_conv(p["conv2"], stem_conv(p["conv1"], mel, stride=1), stride=2)
    pos = _audio_positions(cfg.n_audio_ctx, cfg.n_audio_state)
    return x + pos.to(device=x.device, dtype=x.dtype)


def attention_xla(p: dict, x: torch.Tensor, n_heads: int, mask=None) -> torch.Tensor:
    """Self-attention: q and k each scaled by hd^-0.25, `attend_plain`."""
    b, t, d = x.shape
    scale = (d // n_heads) ** -0.25
    q = _heads(linear(p["q"], x), n_heads) * scale
    k = _heads(linear(p["k"], x), n_heads) * scale
    v = _heads(linear(p["v"], x), n_heads)
    o, = per_head(lambda *qkv: (attend_plain(*qkv, mask),), (q, k, v), (2,))
    return linear(p["o"], o.reshape(b, t, d))


def encoder_block_xla(bp: dict, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """One pre-norm encoder block: self-attention, then the GELU MLP."""
    x = x + attention_xla(bp["attn"], layer_norm(bp["ln1"], x), n_heads)
    hn = layer_norm(bp["ln2"], x)
    return x + linear(bp["mlp"]["fc2"], gelu(linear(bp["mlp"]["fc1"], hn)))


def encode_xla(params, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """The training route's encoder: mel (B, 2·n_audio_ctx, n_mels) →
    features (B, n_audio_ctx, D) in mel's dtype, as the JAX `encode`
    computes them with its kernels off."""
    p = params["encoder"]
    x = stem_xla(p, cfg, mel)
    for i in range(cfg.n_audio_layer):
        x = encoder_block_xla(layer_of(p["blocks"], i), x, cfg.n_audio_head)
    return layer_norm(p["ln_post"], x)


def precompute_cross_kv(params, cfg: WhisperConfig, audio_features: torch.Tensor):
    """Each decoder layer's cross K (scaled by hd^-0.25) and V over the
    audio features: two (L, B, T, H, hd) tensors."""
    h = cfg.n_text_head
    scale = (cfg.n_text_state // h) ** -0.25
    cross = params["decoder"]["blocks"]["cross_attn"]
    ks, vs = [], []
    for i in range(cfg.n_text_layer):
        bp = layer_of(cross, i)
        ks.append(_heads(linear(bp["k"], audio_features), h) * scale)
        vs.append(_heads(linear(bp["v"], audio_features), h))
    return torch.stack(ks), torch.stack(vs)


def _cross_attention(q, k, v):
    """(the attention (B, T, H, hd), its raw scores (B, H, T, T_audio) in
    f32, or f64 for f64 q)."""
    ct = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v), scores


def forward_cross_qk(params, cfg: WhisperConfig, tokens: torch.Tensor,
                     audio_features: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-sequence decoder pass: tokens (B, T) at positions 0.. over
    the audio features → (logits (B, T, V), the raw cross-attention scores
    (L, B, H, T, T_audio), f32 or f64), which `timing.find_alignment`
    soft-maxes after choosing its heads."""
    p = params["decoder"]
    b, t = tokens.shape
    h, d = cfg.n_text_head, cfg.n_text_state
    scale = (d // h) ** -0.25
    ck, cv = precompute_cross_kv(params, cfg, audio_features)
    x = embed_tokens(p["token_embedding"], tokens)
    x = x + p["positional_embedding"][:t][None].to(x.dtype)
    mask = causal_mask(t, t, device=x.device)
    qks = []
    for i in range(cfg.n_text_layer):
        bp = layer_of(p["blocks"], i)
        x = x + attention_xla(bp["attn"], layer_norm(bp["ln1"], x), h, mask)
        hn = layer_norm(bp["ln_cross"], x)
        qc = _heads(linear(bp["cross_attn"]["q"], hn), h) * scale
        oc, scores = per_head(_cross_attention, (qc, ck[i].to(qc.dtype), cv[i]), (2, 1))
        x = x + linear(bp["cross_attn"]["o"], oc.reshape(b, t, d))
        hn = layer_norm(bp["ln2"], x)
        x = x + linear(bp["mlp"]["fc2"], gelu(linear(bp["mlp"]["fc1"], hn)))
        qks.append(scores)
    x = layer_norm(p["ln"], x)
    return embedding_as_linear(p["token_embedding"], x), torch.stack(qks)
