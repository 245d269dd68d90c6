"""Decoder-only transformer family (Llama / Qwen2 / Qwen3 / GPT-2) as one
configurable stack (port of tpu_audio/nn/transformer.py: TransformerConfig,
init_params, fuse_fp_tree, make_cache, make_fused_cache,
decode_cache_and_mask, fused_decode_supported, forward_hidden, forward,
logits, encode).

The parameters keep the JAX tree's stacked (L, …) layer layout; a layer is
a view of each stacked leaf, so the loop over layers copies no weight. A
stacked W4A8 leaf ("weight_q4p" / "weight_q4s") reaches its layer whole,
as "weight_q4p_stacked" beside "layer_idx" and the layer's scales, as the
JAX `_reinject_stacked` hands it over: the stacked kernel reads the layer
in place. GQA,
Llama-3-scaled RoPE, Qwen3 q/k-norm and GPT-2 learned positions as in the
JAX module. Caches are updated in place (`ops/kvcache.py`).

Over a `FusedKVCache` (single stream), steps of up to 4 tokens run the
whole stack as one launch per token (`ops/kernels/fused_step.py`) when
`fused_decode_supported` holds; prefill runs the per-layer path on a
layout view of that cache, with the key slots before `start` masked.

Over a `QuantizedKVCache` (the int8 cache, `make_cache(quantized=True)`)
each layer writes its keys and values quantised at `pos` and attends over
the layer read back dequantised into q's dtype, as the JAX module's
quantised branch does.

Tensor parallelism (`axis_name`): each rank of the tp process group holds
its megatron shard of the layers (`parallel/tp_quant.local_params`) and runs
the stack at the local head counts (`local_config`); the partial sums of the
row-parallel o-projection and MLP are all-reduced (sum) over the group, where
the JAX module psums under `shard_map`. A `FusedKVCache` refuses it, as in
the JAX module.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from tpu_audio_torch.nn import attention, layers, rope
from tpu_audio_torch.ops import quant
from tpu_audio_torch.ops.kernels import fused_step as fs
from tpu_audio_torch.ops.kvcache import FusedKVCache, KVCache, QuantizedKVCache


@dataclass(frozen=True)
class TransformerConfig:
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int | None = None
    head_dim: int | None = None
    hidden_dim: int = 0  # MLP inner dim
    vocab_size: int = 0
    rope_theta: float = 10000.0
    rope_scaling: dict | None = None
    norm_eps: float = 1e-5
    attn_qkv_bias: bool = False  # Qwen2
    attn_o_bias: bool = False
    qk_norm: bool = False  # Qwen3
    mlp: str = "swiglu"  # or "gelu" (erf) / "gelu_new" (GPT-2 tanh approx)
    norm: str = "rms"  # or "ln"
    pos_emb: str = "rope"  # "rope" | "learned" | "none"
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.dim // self.n_heads

    def inv_freq(self) -> np.ndarray:
        return rope.make_inv_freq(self.hd, self.rope_theta, self.rope_scaling)


_STACKED_KEYS = ("weight_q4p", "weight_q4s")  # handed over whole, with the layer index


def _layer(tree: dict, i: int) -> dict:
    """Layer i of a stacked tree: a view of every leaf, except a W4A8
    weight, which stays whole under "<key>_stacked" beside "layer_idx"."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _layer(v, i)
        elif k in _STACKED_KEYS:
            out[k + "_stacked"], out["layer_idx"] = v, i
        else:
            out[k] = v[i]
    return out


def _norm(cfg: TransformerConfig, p, x):
    if cfg.norm == "rms":
        return layers.rms_norm(p, x, cfg.norm_eps)
    return layers.layer_norm(p, x, cfg.norm_eps)


def _mlp(cfg: TransformerConfig, p, x):
    if cfg.mlp == "swiglu":
        if "gateup" in p:  # fused leaf (fuse_fp_tree / quant.fuse_int8_tree)
            gate, up = layers.linear(p["gateup"], x).chunk(2, dim=-1)
            return layers.linear(p["down"], layers.silu(gate) * up)
        return layers.linear(p["down"], layers.silu(layers.linear(p["gate"], x))
                             * layers.linear(p["up"], x))
    if cfg.mlp == "gelu_new":
        act = torch.nn.functional.gelu(layers.linear(p["fc1"], x), approximate="tanh")
    else:
        act = layers.gelu(layers.linear(p["fc1"], x))
    return layers.linear(p["fc2"], act)


def _qkv(cfg: TransformerConfig, attn_p, hn, b, t):
    """Project hidden → (q, k, v) heads, through the fused qkv leaf if present."""
    h_, kvh, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    if "qkv" in attn_p:
        q, k, v = layers.linear(attn_p["qkv"], hn).split([h_ * hd, kvh * hd, kvh * hd], dim=-1)
    else:
        q, k, v = (layers.linear(attn_p[n], hn) for n in "qkv")
    return q.reshape(b, t, h_, hd), k.reshape(b, t, kvh, hd), v.reshape(b, t, kvh, hd)


def psum(t: torch.Tensor, axis_name=None) -> torch.Tensor:
    """t summed over the process group `axis_name` in place (None: t)."""
    if axis_name is not None:
        dist.all_reduce(t, group=axis_name)
    return t


def _attention_block(cfg, lp, x, rope_pos, inv_freq, kv, mask, axis_name=None):
    """Pre-norm attention of one layer: x + attention. kv(k, v) returns the
    keys and values to attend (the cache's, or k, v); under `axis_name` the
    o-projection's partial sums are all-reduced before the residual."""
    b, t, _ = x.shape
    hn = _norm(cfg, lp["ln1"], x)
    q, k, v = _qkv(cfg, lp["attn"], hn, b, t)
    if cfg.qk_norm:
        q = layers.rms_norm(lp["attn"]["q_norm"], q, cfg.norm_eps)
        k = layers.rms_norm(lp["attn"]["k_norm"], k, cfg.norm_eps)
    if inv_freq is not None:
        q = rope.apply_rope(q, rope_pos, inv_freq)
        k = rope.apply_rope(k, rope_pos, inv_freq)
    kl, vl = kv(k, v)
    o = attention.attend(q, kl.to(q.dtype), vl.to(q.dtype), mask, scale=1.0 / math.sqrt(cfg.hd))
    return x + psum(layers.linear(lp["attn"]["o"], o.reshape(b, t, cfg.n_heads * cfg.hd)),
                    axis_name)


# ------------------------------------------------------------------ params

def init_params(seed: int, cfg: TransformerConfig, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters from a numpy seed with the tree, shapes and
    initialisation ranges of the JAX `init_params` (stacked (L, …) layer
    leaves), on the card unless `device` says otherwise."""
    from tpu_audio_torch.convert import params_from_numpy

    return params_from_numpy(numpy_params(np.random.default_rng(seed), cfg), device, dtype)


def numpy_params(rng: np.random.Generator, cfg: TransformerConfig) -> dict:
    """The tree of `init_params` as f32 numpy arrays drawn from `rng`."""
    lyr, d, h, kvh, hd = cfg.n_layers, cfg.dim, cfg.n_heads, cfg.kv_heads, cfg.hd

    def lin(fan_in, fan_out, bias):
        scale = np.float32(1.0 / math.sqrt(fan_in))
        p = {"weight": (rng.random((lyr, fan_out, fan_in), dtype=np.float32) * 2 - 1) * scale}
        if bias:
            p["bias"] = (rng.random((lyr, fan_out), dtype=np.float32) * 2 - 1) * scale
        return p

    def norm(shape, bias):
        p = {"weight": np.ones(shape, np.float32)}
        if bias:
            p["bias"] = np.zeros(shape, np.float32)
        return p

    attn = {"q": lin(d, h * hd, cfg.attn_qkv_bias), "k": lin(d, kvh * hd, cfg.attn_qkv_bias),
            "v": lin(d, kvh * hd, cfg.attn_qkv_bias), "o": lin(h * hd, d, cfg.attn_o_bias)}
    if cfg.qk_norm:
        attn["q_norm"] = norm((lyr, hd), False)
        attn["k_norm"] = norm((lyr, hd), False)
    if cfg.mlp == "swiglu":
        mlp = {"gate": lin(d, cfg.hidden_dim, False), "up": lin(d, cfg.hidden_dim, False),
               "down": lin(cfg.hidden_dim, d, False)}
    else:
        mlp = {"fc1": lin(d, cfg.hidden_dim, True), "fc2": lin(cfg.hidden_dim, d, True)}
    use_bias = cfg.norm == "ln"
    p = {"layers": {"attn": attn, "mlp": mlp, "ln1": norm((lyr, d), use_bias),
                    "ln2": norm((lyr, d), use_bias)},
         "norm": norm((d,), use_bias)}

    def table(rows):
        return {"weight": rng.standard_normal((rows, d), dtype=np.float32) * np.float32(0.02)}

    if cfg.vocab_size:
        p["embed"] = table(cfg.vocab_size)
    if cfg.pos_emb == "learned":
        p["pos_embed"] = table(cfg.max_position_embeddings)
    if not cfg.tie_word_embeddings and cfg.vocab_size:
        scale = np.float32(1.0 / math.sqrt(d))
        p["lm_head"] = {"weight": (rng.random((cfg.vocab_size, d), dtype=np.float32) * 2 - 1)
                        * scale}
    return p


def fuse_fp_tree(params: dict) -> dict:
    """Fuse fp q/k/v → qkv (with their biases when all three have one) and
    gate/up → gateup leaves, concatenated along the output channels: the
    same results from fewer, larger products, and the shape the whole-stack
    step kernel streams. Quantised leaves are left as they are."""
    def cat(ds):
        leaf = {"weight": torch.cat([d["weight"] for d in ds], dim=-2)}
        if len(ds) == 3 and all("bias" in d for d in ds):
            leaf["bias"] = torch.cat([d["bias"] for d in ds], dim=-1)
        return leaf
    return quant.fuse_leaves(params, lambda d: "weight" in d, cat)


# ------------------------------------------------------------------ caches

def make_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, quantized: bool = False,
               device: torch.device | str = "cuda"):
    """A KVCache in `dtype`, or with `quantized` the int8 QuantizedKVCache."""
    if quantized:
        return QuantizedKVCache.create(cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hd,
                                       device)
    return KVCache.create(cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hd, dtype, device)


def make_fused_cache(cfg: TransformerConfig, max_len: int, dtype: torch.dtype = torch.bfloat16,
                     start=0, device: torch.device | str = "cuda") -> FusedKVCache:
    return FusedKVCache.create(cfg.n_layers, max_len, cfg.kv_heads, cfg.hd, dtype, start, device)


def _start_mask(max_len: int, start, device) -> torch.Tensor:
    """Additive (1, 1, 1, max_len) mask hiding the key slots < start."""
    slot = torch.arange(max_len, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(slot < start, attention.NEG_INF, zero)[None, None, None, :]


def decode_cache_and_mask(cfg: TransformerConfig, max_len: int, start, fused: bool,
                          dtype: torch.dtype = torch.bfloat16,
                          device: torch.device | str = "cuda"):
    """The decode loops' left-padded cache, in both serving modes: fused →
    (FusedKVCache carrying `start`, None); plain → (KVCache, the additive
    mask hiding key slots < start)."""
    if fused:
        return make_fused_cache(cfg, max_len, dtype, start, device), None
    return make_cache(cfg, 1, max_len, dtype, device=device), _start_mask(max_len, start, device)


def fused_decode_supported(cfg: TransformerConfig, params: dict, max_len: int = 512,
                           cache_dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the whole-stack step serves this stack single-stream: fused
    qkv/gateup leaves without o/gateup/down biases, RMSNorm, SwiGLU, RoPE,
    hd 64 or 128, dim % 128 == 0, hidden % 8 == 0 (the JAX gate's shape
    rules). There is no compile probe: on CUDA the kernel launches or
    raises."""
    del max_len, cache_dtype  # the kernel takes any cache length; the wrapper checks the dtype
    lp = params.get("layers", {})
    attn, mlp = lp.get("attn", {}), lp.get("mlp", {})
    if "qkv" not in attn or "gateup" not in mlp:
        return False
    if "bias" in attn.get("o", {}) or "bias" in mlp["gateup"] or "bias" in mlp["down"]:
        return False
    return (cfg.norm == "rms" and cfg.mlp == "swiglu" and cfg.pos_emb == "rope"
            and cfg.hd in fs.HEAD_DIMS and cfg.dim % 128 == 0 and cfg.hidden_dim % 8 == 0
            and ("weight" in attn["qkv"] or "weight_i8" in attn["qkv"]))


# ------------------------------------------------------------------ forward

def forward_hidden(params: dict, cfg: TransformerConfig, x: torch.Tensor, cache,
                   extra_mask: torch.Tensor | None = None, axis_name=None,
                   pos_offset: torch.Tensor | None = None):
    """Run the stack on embedded inputs x (B, T, D), writing into `cache`
    at cache.pos and advancing it, in place. Returns (hidden (B, T, D),
    cache).

    extra_mask: optional additive (B, 1, T, S_max) bias composed onto the
    causal decode mask. pos_offset: optional (B,) per-row offset subtracted
    from the positions fed to RoPE / learned embeddings (cache slots are
    unaffected), clamped at 0. axis_name: the tensor-parallel process group
    (`mesh.get_group("tp")`) over which this rank's partial sums of the
    o-projection and the MLP are all-reduced; params and cfg are then the
    rank's local tree and `local_config`, and the cache holds its heads."""
    if axis_name is not None and not isinstance(axis_name, dist.ProcessGroup):
        raise TypeError(f"axis_name must be the tp process group (mesh.get_group('tp')), "
                        f"got {type(axis_name).__name__} {axis_name!r}")
    if isinstance(cache, FusedKVCache):
        if axis_name is not None:
            raise ValueError("FusedKVCache does not support tensor parallelism (axis_name)")
        return _forward_fused(params, cfg, x, cache, extra_mask, pos_offset)
    quantized = isinstance(cache, QuantizedKVCache)
    if not (quantized or isinstance(cache, KVCache)):
        raise TypeError(f"unknown cache type {type(cache).__name__}")
    b, t, _ = x.shape
    pos = cache.pos
    positions = pos + torch.arange(t, device=pos.device)
    mask = attention.decode_mask(cache.max_len, pos, t)
    if extra_mask is not None:
        mask = mask + extra_mask
    if pos_offset is None:
        rope_pos = positions
    else:  # pad slots would go negative; they are key-masked, clamp to 0
        rope_pos = torch.clamp(positions[None, :] - pos_offset[:, None], min=0)
    if cfg.pos_emb == "learned":
        pe = layers.embedding(params["pos_embed"], rope_pos)
        x = x + (pe if pe.dim() == 3 else pe[None])
    inv_freq = cfg.inv_freq() if cfg.pos_emb == "rope" else None

    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)

        def kv(k, v, i=i):
            cache.write(i, k, v)
            return cache.read_layer(i, k.dtype) if quantized else (cache.k[i], cache.v[i])

        x = _attention_block(cfg, lp, x, rope_pos, inv_freq, kv, mask, axis_name)
        x = x + psum(_mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x)), axis_name)
    cache.advance(t)
    return _norm(cfg, params["norm"], x), cache


def _forward_fused(params: dict, cfg: TransformerConfig, x: torch.Tensor, cache: FusedKVCache,
                   extra_mask, pos_offset):
    """forward_hidden over a FusedKVCache (single stream, kernel layout).
    Steps of T ≤ 4 tokens without an extra mask run the whole stack as one
    launch per token; prefill runs the per-layer path on a layout view of
    the same buffers, with the slots before `start` masked."""
    b, t, _ = x.shape
    if b != 1:
        raise ValueError("FusedKVCache is single-stream (B=1)")
    if t <= 4 and extra_mask is None and fused_decode_supported(cfg, params, cache.max_len,
                                                                cache.k.dtype):
        stack = fs.prepare_stack(params)
        hs = []
        for i in range(t):
            pos_i = cache.pos + i
            rope_pos = pos_i
            if pos_offset is not None:
                rope_pos = torch.clamp(pos_i - pos_offset.reshape(()), min=0)
            cos, sin = fs.make_cos_sin(rope_pos, cfg.inv_freq())
            hs.append(fs.fused_decode_step(
                stack, x[:, i], pos_i, cache.start, cos, sin, cache.k, cache.v,
                n_heads=cfg.n_heads, n_kv_heads=cfg.kv_heads, hd=cfg.hd, eps=cfg.norm_eps))
        cache.advance(t)
        return torch.stack(hs, dim=1).to(x.dtype), cache
    # (L, KVH, S, D) → a (L, 1, S, KVH, D) view: the writes land in the buffers
    inner = KVCache(k=cache.k.transpose(1, 2)[:, None], v=cache.v.transpose(1, 2)[:, None],
                    pos=cache.pos)
    if extra_mask is None:
        extra_mask = _start_mask(cache.max_len, cache.start, x.device)
    h, _ = forward_hidden(params, cfg, x, inner, extra_mask, pos_offset=pos_offset)
    return h, cache


def forward(params: dict, cfg: TransformerConfig, tokens: torch.Tensor, cache,
            extra_mask: torch.Tensor | None = None, axis_name=None,
            pos_offset: torch.Tensor | None = None):
    """Token ids (B, T) → (logits (B, T, V), cache advanced in place)."""
    x = layers.embedding(params["embed"], tokens)
    h, cache = forward_hidden(params, cfg, x, cache, extra_mask, axis_name, pos_offset)
    return logits(params, cfg, h), cache


def logits(params: dict, cfg: TransformerConfig, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_word_embeddings or "lm_head" not in params:
        return layers.embedding_as_linear(params["embed"], hidden)
    return layers.linear(params["lm_head"], hidden)


def encode(params: dict, cfg: TransformerConfig, x: torch.Tensor,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """Bidirectional (encoder) pass without a cache: x (B, T, D) → (B, T, D)."""
    t = x.shape[1]
    positions = torch.arange(t, device=x.device)
    inv_freq = cfg.inv_freq() if cfg.pos_emb == "rope" else None
    if cfg.pos_emb == "learned":
        x = x + layers.embedding(params["pos_embed"], positions)[None]
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        x = _attention_block(cfg, lp, x, positions, inv_freq, lambda k, v: (k, v), mask)
        x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))
    return _norm(cfg, params["norm"], x)
