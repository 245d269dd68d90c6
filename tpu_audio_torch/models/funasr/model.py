"""Fun-ASR: SenseVoice SANM encoder → adaptor → Qwen3 decoder (port of
tpu_audio/models/funasr/model.py: the configs, QWEN3_06B, init_params,
encode, adapt, FunASRGenerator).

Reference: package/STT/FunASR/ — SenseVoiceEncoder (1 input + 49 main + 20
time-pooling SANM layers at 512: fused QKV + depthwise FSMN k11 memory on
the masked value), AudioAdaptor (frame stacking → 2 linears → transformer
blocks), Qwen3ForCausalLM, and the embedding merge that splices the audio
between <|startofspeech|><|endofspeech|>.

The FSMN memory is a plain depthwise `F.conv1d` (groups = C) over a
(C, 1, K) weight; `convert.params_from_numpy` transposes the JAX tree's
(K, 1, C). The decoder is `nn/transformer.py`: its single-token steps run
the whole-stack kernel on fp and int8 trees, and its linears the q4/q8
dequant-matmul kernel on group-affine trees.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch.convert import params_from_numpy, tree_device
from tpu_audio_torch.nn import attention, layers, transformer
from tpu_audio_torch.ops import sampling
from tpu_audio_torch.ops.decoding import decode_loop
from tpu_audio_torch.ops.sampling import SamplerConfig

QWEN3_06B = transformer.TransformerConfig(
    dim=1024, n_layers=28, n_heads=16, n_kv_heads=8, head_dim=128,
    hidden_dim=3072, vocab_size=151936, rope_theta=1000000.0,
    qk_norm=True, norm_eps=1e-6, tie_word_embeddings=True)


@dataclass(frozen=True)
class SenseVoiceConfig:
    input_dim: int = 560  # 80 mels × LFR 7
    encoder_dim: int = 512
    num_heads: int = 4
    ffn_dim: int = 2048
    num_encoders0: int = 1
    num_encoders: int = 49
    num_tp_encoders: int = 20
    kernel_size: int = 11
    sanm_shift: int = 0


@dataclass(frozen=True)
class AdaptorConfig:
    encoder_dim: int = 512
    downsample_rate: int = 2
    ffn_dim: int = 2048
    llm_dim: int = 1024
    n_layer: int = 2
    attention_heads: int = 8


@dataclass(frozen=True)
class FunASRConfig:
    encoder: SenseVoiceConfig = field(default_factory=SenseVoiceConfig)
    adaptor: AdaptorConfig = field(default_factory=AdaptorConfig)
    llm: transformer.TransformerConfig = QWEN3_06B


# ------------------------------------------------------------------ params

def _numpy_params(rng: np.random.Generator, cfg: FunASRConfig) -> dict:
    """The JAX `init_params` tree (JAX layouts: FSMN weight (K, 1, C)) as
    f32 numpy arrays with its initialisation ranges."""
    def uniform(shape, fan_in):
        return (rng.random(shape, dtype=np.float32) * 2 - 1) * np.float32(1.0 / math.sqrt(fan_in))

    def lin(fan_in, fan_out, bias=True):
        p = {"weight": uniform((fan_out, fan_in), fan_in)}
        if bias:
            p["bias"] = uniform((fan_out,), fan_in)
        return p

    def norm(d):
        return {"weight": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    ec = cfg.encoder

    def sanm(in_size):
        size = ec.encoder_dim
        return {"norm1": norm(in_size),
                "self_attn": {"linear_q_k_v": lin(in_size, 3 * size),
                              "linear_out": lin(size, size),
                              "fsmn_block": {"weight": uniform((ec.kernel_size, 1, size),
                                                               ec.kernel_size)}},
                "norm2": norm(size),
                "feed_forward": {"w_1": lin(size, ec.ffn_dim), "w_2": lin(ec.ffn_dim, size)}}

    encoder = {"encoders0": {str(i): sanm(ec.input_dim if i == 0 else ec.encoder_dim)
                             for i in range(ec.num_encoders0)},
               "encoders": {str(i): sanm(ec.encoder_dim) for i in range(ec.num_encoders)},
               "tp_encoders": {str(i): sanm(ec.encoder_dim) for i in range(ec.num_tp_encoders)},
               "after_norm": norm(ec.encoder_dim), "tp_norm": norm(ec.encoder_dim)}
    ac = cfg.adaptor
    d = ac.llm_dim
    adaptor = {"linear1": lin(ac.encoder_dim * ac.downsample_rate, ac.ffn_dim),
               "linear2": lin(ac.ffn_dim, d),
               "blocks": {str(i): {"norm1": norm(d),
                                   "attn": {n: lin(d, d) for n in "qkvo"},
                                   "norm2": norm(d),
                                   "ff": {"w_1": lin(d, d // 4), "w_2": lin(d // 4, d)}}
                          for i in range(ac.n_layer)}}
    return {"encoder": encoder, "adaptor": adaptor,
            "llm": transformer.numpy_params(rng, cfg.llm)}


def init_params(seed: int, cfg: FunASRConfig, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters from a numpy seed, with the tree, shapes and
    initialisation ranges of the JAX `init_params`, on the card unless
    `device` says otherwise."""
    return params_from_numpy(_numpy_params(np.random.default_rng(seed), cfg), device, dtype)


# ------------------------------------------------------------------ SANM

def _sanm_attention(p, x, cfg: SenseVoiceConfig, pad_mask, bias):
    b, t, _ = x.shape
    d, h = cfg.encoder_dim, cfg.num_heads
    hd = d // h
    q, k, v = layers.linear(p["linear_q_k_v"], x).chunk(3, dim=-1)
    # FSMN memory: a depthwise conv over the masked value
    left = (cfg.kernel_size - 1) // 2 + cfg.sanm_shift
    right = cfg.kernel_size - 1 - left
    vm = v * pad_mask
    mem = layers.conv1d(p["fsmn_block"], vm, padding=(left, right), groups=d)
    mem = (mem + vm) * pad_mask
    o = attention.attend(q.reshape(b, t, h, hd), k.reshape(b, t, h, hd),
                         v.reshape(b, t, h, hd), bias, scale=1.0 / math.sqrt(hd))
    return layers.linear(p["linear_out"], o.reshape(b, t, d)) + mem


def _sanm_block(p, x, cfg, pad_mask, bias, residual: bool):
    a = _sanm_attention(p["self_attn"], layers.layer_norm(p["norm1"], x), cfg, pad_mask, bias)
    x = (x + a) if residual else a
    hn = layers.layer_norm(p["norm2"], x)
    return x + layers.linear(p["feed_forward"]["w_2"],
                             F.relu(layers.linear(p["feed_forward"]["w_1"], hn)))


def encode(params, cfg: SenseVoiceConfig, feats: torch.Tensor,
           lengths: torch.Tensor) -> torch.Tensor:
    """LFR+CMVN features (B, T, 560) → (B, T, 512); frames ≥ lengths are
    padding (masked keys, zeroed FSMN input)."""
    t = feats.shape[1]
    pad_mask = (torch.arange(t, device=feats.device) < lengths[:, None])[..., None].to(feats.dtype)
    bias = attention.padding_mask(lengths, t)
    x = feats * (cfg.encoder_dim ** 0.5)
    for i in range(cfg.num_encoders0):  # the input layer has no residual
        x = _sanm_block(params["encoders0"][str(i)], x, cfg, pad_mask, bias, residual=i > 0)
    for i in range(cfg.num_encoders):
        x = _sanm_block(params["encoders"][str(i)], x, cfg, pad_mask, bias, residual=True)
    x = layers.layer_norm(params["after_norm"], x)
    for i in range(cfg.num_tp_encoders):
        x = _sanm_block(params["tp_encoders"][str(i)], x, cfg, pad_mask, bias, residual=True)
    return layers.layer_norm(params["tp_norm"], x)


# ------------------------------------------------------------------ adaptor

def adapt(params, cfg: AdaptorConfig, x: torch.Tensor, lengths: torch.Tensor):
    """(B, T, enc) → ((B, T//k, llm_dim), lengths // k)."""
    b, t, d = x.shape
    k = cfg.downsample_rate
    t2 = t // k
    x = x[:, : t2 * k].reshape(b, t2, d * k)
    lengths2 = lengths // k
    x = layers.linear(params["linear2"], F.relu(layers.linear(params["linear1"], x)))
    bias = attention.padding_mask(lengths2, t2)
    h_ = cfg.attention_heads
    hd = cfg.llm_dim // h_
    for i in range(cfg.n_layer):
        bp = params["blocks"][str(i)]
        hn = layers.layer_norm(bp["norm1"], x)
        if "qkv" in bp["attn"]:  # fused leaf (quant.fuse_int8_tree)
            q, kk, v = (a.reshape(b, t2, h_, hd)
                        for a in layers.linear(bp["attn"]["qkv"], hn).chunk(3, dim=-1))
        else:
            q, kk, v = (layers.linear(bp["attn"][n], hn).reshape(b, t2, h_, hd) for n in "qkv")
        o = attention.attend(q, kk, v, bias, scale=1.0 / math.sqrt(hd))
        x = x + layers.linear(bp["attn"]["o"], o.reshape(b, t2, cfg.llm_dim))
        hn = layers.layer_norm(bp["norm2"], x)
        x = x + layers.linear(bp["ff"]["w_2"], F.relu(layers.linear(bp["ff"]["w_1"], hn)))
    return x, lengths2


# ------------------------------------------------------------------ generation

class FunASRGenerator:
    """Prompt + audio merge, prefill and decode of one clip. The features
    are padded to a multiple of 32 frames; [pre | audio | post] is placed
    and rolled right by the padding, so the real tokens end at the last
    slot, RoPE positions are the absolute cache slots and the slots before
    `start` = the shift are masked, as the JAX generator does. The cache
    holds `max_cache` slots, or with None as many as each request needs
    (the prompt plus `max_new`)."""

    def __init__(self, params, cfg: FunASRConfig, max_cache: int | None = 4096):
        # fuse the fp q/k/v and gate/up leaves of the Qwen3 stack (int8
        # trees arrive fused; q4 leaves stay as they are)
        self.params = dict(params, llm=transformer.fuse_fp_tree(params["llm"]))
        self.cfg = cfg
        self.max_cache = max_cache
        self.device = tree_device(params["llm"])
        self.fused = transformer.fused_decode_supported(cfg.llm, self.params["llm"], max_cache)

    @torch.inference_mode()
    def prefill_inputs(self, pre_ids: list[int], post_ids: list[int], feats
                       ) -> tuple[torch.Tensor, int]:
        """The decoder's prefill input (1, total, dim) for [pre | audio |
        post], rolled right so that the real tokens end at the last slot,
        and the roll (the first real slot, `start`)."""
        cfg, dev = self.cfg, self.device
        embed = self.params["llm"]["embed"]
        t = feats.shape[0]
        t_pad = max(32, -(-t // 32) * 32)
        f = torch.zeros((1, t_pad, feats.shape[1]), dtype=torch.float32, device=dev)
        f[0, :t] = torch.as_tensor(feats, dtype=torch.float32, device=dev)
        feat_len = torch.tensor([t], device=dev)
        audio = encode(self.params["encoder"], cfg.encoder, f, feat_len)
        audio, _ = adapt(self.params["adaptor"], cfg.adaptor, audio, feat_len)
        a_pad, a_len = audio.shape[1], t // cfg.adaptor.downsample_rate
        pre = layers.embedding(embed, torch.tensor([pre_ids], device=dev))
        post = layers.embedding(embed, torch.tensor([post_ids], device=dev))
        pre_len, post_len = len(pre_ids), len(post_ids)
        total = pre_len + a_pad + post_len
        x = torch.zeros((1, total, cfg.llm.dim), dtype=pre.dtype, device=dev)
        x[:, :pre_len] = pre
        x[:, pre_len:pre_len + a_pad] = audio.to(x.dtype)
        x[:, pre_len + a_len:pre_len + a_len + post_len] = post
        shift = total - (pre_len + a_len + post_len)
        return torch.roll(x, shift, dims=1), shift

    @torch.inference_mode()
    def generate(self, pre_ids: list[int], post_ids: list[int], feats, *, eos_ids: tuple,
                 max_new: int = 256, sampler: SamplerConfig = SamplerConfig(temperature=0.0),
                 seed: int = 0) -> list[int]:
        """Token ids of the answer to [pre | audio(feats (T, 560)) | post],
        EOS ids removed."""
        lcfg, llm, dev = self.cfg.llm, self.params["llm"], self.device
        x, shift = self.prefill_inputs(pre_ids, post_ids, feats)
        slots = x.shape[1] + max_new if self.max_cache is None else self.max_cache
        if x.shape[1] + max_new > slots:
            raise ValueError(f"prompt of {x.shape[1]} slots + {max_new} new tokens exceeds "
                             f"max_cache {self.max_cache}")
        cache, extra = transformer.decode_cache_and_mask(lcfg, slots, shift, self.fused,
                                                         device=dev)
        hidden, cache = transformer.forward_hidden(llm, lcfg, x, cache, extra)
        first_logits = transformer.logits(llm, lcfg, hidden[:, -1:])[:, 0].float()

        def step(tok, cache):
            lg, cache = transformer.forward(llm, lcfg, tok, cache, extra_mask=extra)
            return lg[:, -1].float(), cache

        gen = torch.Generator(device=dev).manual_seed(seed)
        first = sampling.sample(first_logits, sampler,
                                torch.full((1, 64), -1, dtype=torch.int64, device=dev), gen)
        res = decode_loop(step, cache, first, max_new - 1, eos_ids=eos_ids, sampler=sampler,
                          generator=gen, pad_id=int(eos_ids[0]))
        n = int(res.lengths[0])
        out = [int(first[0])] + res.tokens[0, :n].tolist()
        return [tok for tok in out if tok not in eos_ids]
