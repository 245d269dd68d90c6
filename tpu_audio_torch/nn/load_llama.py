"""Checkpoint loader for the Llama/Qwen/GPT-2 family into the
`nn/transformer.py` tree (stacked layers) (port of
tpu_audio/nn/load_llama.py: fold_quantized, convert_llama, convert_gpt2,
config_from_hf, load_llama_dir).

Handles HF-transformers and mlx naming (both model.layers.N.*), quantised
triples (.scales/.biases, `ops/quant.py`) and GPT-2's fused c_attn.
The JAX loader ends with `quant.expand_tree_for_kernel`, which returns
every leaf as it is; the port's `CausalLMGenerator` and `FunASRGenerator`
take the loaded tree directly (they fuse its fp q/k/v and gate/up leaves
themselves).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from tpu_audio_torch.nn import transformer
from tpu_audio_torch.nn.transformer import TransformerConfig
from tpu_audio_torch.utils import weights

_RULES = [
    (r"^model\.embed_tokens\.", "embed."),
    (r"^model\.norm\.", "norm."),
    (r"^model\.layers\.", "layers."),
    (r"^lm_head\.", "lm_head."),
    (r"\.self_attn\.q_proj\.", ".attn.q."),
    (r"\.self_attn\.k_proj\.", ".attn.k."),
    (r"\.self_attn\.v_proj\.", ".attn.v."),
    (r"\.self_attn\.o_proj\.", ".attn.o."),
    (r"\.self_attn\.q_norm\.", ".attn.q_norm."),
    (r"\.self_attn\.k_norm\.", ".attn.k_norm."),
    (r"\.mlp\.gate_proj\.", ".mlp.gate."),
    (r"\.mlp\.up_proj\.", ".mlp.up."),
    (r"\.mlp\.down_proj\.", ".mlp.down."),
    (r"\.input_layernorm\.", ".ln1."),
    (r"\.post_attention_layernorm\.", ".ln2."),
]

_GPT2_RULES = [
    (r"^wte\.", "embed."),
    (r"^wpe\.", "pos_embed."),
    (r"^ln_f\.", "norm."),
    (r"^h\.", "layers."),
    (r"\.attn\.c_proj\.", ".attn.o."),
    (r"\.mlp\.c_fc\.", ".mlp.fc1."),
    (r"\.mlp\.c_proj\.", ".mlp.fc2."),
    (r"\.ln_1\.", ".ln1."),
    (r"\.ln_2\.", ".ln2."),
]


def fold_quantized(flat: dict, group: int = 64) -> dict:
    """Rename each packed uint32 "weight" beside ".scales" to weight_q{bits}."""
    out = dict(flat)
    for k in list(flat):
        if k.endswith(".scales"):
            prefix = k[: -len(".scales")]
            wkey = prefix + ".weight"
            if wkey in out and out[wkey].dtype == np.uint32:
                packed = out.pop(wkey)
                in_features = out[k].shape[-1] * group
                per = in_features // packed.shape[-1]
                out[f"{prefix}.weight_q{32 // per}"] = packed
    return out


def convert_llama(flat: dict) -> dict:
    """Flat HF/mlx llama-family checkpoint → transformer numpy tree."""
    flat = weights.apply_rules(flat, _RULES, drop=[r"rotary_emb", r"position_ids"])
    flat = fold_quantized(flat)
    return weights.stack_numbered_layers(flat, "layers")


def convert_gpt2(flat: dict) -> dict:
    """GPT-2 checkpoints: the fused c_attn split into q/k/v; HF GPT-2's
    Conv1D weights are stored (in, out) and come out (out, in)."""
    out = {}
    for k, v in flat.items():
        nk = k
        for pat, repl in _GPT2_RULES:
            nk = re.sub(pat, repl, nk)  # the rules chain (prefix, then fragment)
        if ".attn.c_attn." in nk:
            base = nk.replace(".attn.c_attn.", ".attn.{}.")
            if nk.endswith("weight") and v.ndim == 2:
                v = v.T  # HF Conv1D → (3D, D)
            for name, part in zip("qkv", np.split(v, 3, axis=0)):
                out[base.format(name)] = part
            continue
        if nk.endswith(".weight") and v.ndim == 2 and any(
                s in nk for s in (".attn.o.", ".mlp.fc1.", ".mlp.fc2.")):
            v = v.T  # HF GPT-2 Conv1D layout
        out[nk] = v
    return weights.stack_numbered_layers(out, "layers")


def config_from_hf(d: dict) -> TransformerConfig:
    """HF config.json → TransformerConfig for llama / qwen2 / qwen3."""
    model_type = d.get("model_type", "llama")
    return TransformerConfig(
        dim=d["hidden_size"],
        n_layers=d["num_hidden_layers"],
        n_heads=d["num_attention_heads"],
        n_kv_heads=d.get("num_key_value_heads"),
        head_dim=d.get("head_dim"),
        hidden_dim=d["intermediate_size"],
        vocab_size=d["vocab_size"],
        rope_theta=d.get("rope_theta", 10000.0),
        rope_scaling=d.get("rope_scaling"),
        norm_eps=d.get("rms_norm_eps", 1e-5),
        attn_qkv_bias=(model_type == "qwen2" or d.get("attention_bias", False)),
        qk_norm=model_type == "qwen3",
        max_position_embeddings=d.get("max_position_embeddings", 8192),
        tie_word_embeddings=d.get("tie_word_embeddings", False),
    )


def load_llama_dir(path: str, dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | str = "cuda"):
    """(params, config) of a llama-family checkpoint directory, on the card
    unless `device` says otherwise; quantised leaves as stored."""
    cfg = config_from_hf(weights.load_config_json(path))
    tree = convert_llama(weights.load_safetensors_dir(path))
    if cfg.tie_word_embeddings:
        tree.pop("lm_head", None)  # some exports ship the tied head anyway
    weights.validate_tree(tree, transformer.numpy_params(weights.ShapeRNG(), cfg), name=path)
    return weights.to_device(tree, dtype, device), cfg
