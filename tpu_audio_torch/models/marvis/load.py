"""Marvis checkpoint loading (port of tpu_audio/models/marvis/load.py:
_SUB_RULES, _convert_stack, backbone_config_from_flavor, load,
load_mimi_dir, convert_mimi).

Repos: Marvis-AI/marvis-tts-{100m,250m}-v0.2-MLX-6bit (backbone, depth
decoder, embeddings and heads; config.json names the flavors) and the Mimi
weights of kyutai/moshiko-pytorch-bf16.

Those Marvis repos are MLX 6-bit: `fold_quantized` names their leaves
`weight_q6`, and neither package has a 6-bit product (`ops/quant.py`), so
a real 6-bit checkpoint does not serve in the JAX package either. `load`
refuses a `weight_q6` leaf with ValueError naming the bits (ROADMAP §C), in
place of a failure deep in the first product, and holds the tree against
the Marvis schema (`validate_tree`).

`convert_mimi` is the JAX function: `.conv.conv.` / `.convtr.convtr.`
wrappers stripped, `encoder.model.` / `decoder.model.` → `.layers.`, torch
conv (O, I, K), transposed (I, O, K) and depthwise (C, 1, K) kernels
turned to the JAX layout (K, I, O) / (K, 1, C). `load_mimi_dir` then holds
the tree against the Mimi schema and moves it to torch's layouts by
Mimi's own rule (`codecs/mimi/model.params_from_numpy`).
"""

from __future__ import annotations

import re

import torch

from tpu_audio_torch.codecs.mimi import model as mimi
from tpu_audio_torch.codecs.mimi.model import MimiConfig
from tpu_audio_torch.models.marvis import model as mmodel
from tpu_audio_torch.models.marvis.model import MarvisConfig
from tpu_audio_torch.nn import load_llama, transformer
from tpu_audio_torch.utils import hub, pytree, weights
from tpu_audio_torch.utils.tokenizer import load_tokenizer

MIMI_REPO = "kyutai/moshiko-pytorch-bf16"

_SUB_RULES = load_llama._RULES + [
    (r"^layers\.", "layers."),
    (r"\.sa_norm\.", ".ln1."),  # torchtune naming variants
    (r"\.mlp_norm\.", ".ln2."),
    (r"\.attn\.q_proj\.", ".attn.q."),
    (r"\.attn\.k_proj\.", ".attn.k."),
    (r"\.attn\.v_proj\.", ".attn.v."),
    (r"\.attn\.output_proj\.", ".attn.o."),
    (r"\.mlp\.w1\.", ".mlp.gate."),
    (r"\.mlp\.w3\.", ".mlp.up."),
    (r"\.mlp\.w2\.", ".mlp.down."),
]

_FLAVORS = {
    "llama-1B": dict(dim=2048, n_layers=16, n_heads=32, n_kv_heads=8, hidden_dim=8192),
    "llama-100M": dict(dim=1024, n_layers=4, n_heads=8, n_kv_heads=2, hidden_dim=8192),
    "llama-250M": dict(dim=1024, n_layers=16, n_heads=16, n_kv_heads=8, hidden_dim=4096),
    "llama-60M": dict(dim=512, n_layers=4, n_heads=8, n_kv_heads=2, hidden_dim=2048),
}


def _convert_stack(flat: dict) -> dict:
    flat = weights.apply_rules(flat, _SUB_RULES, drop=[r"rotary", r"rope"])
    flat = load_llama.fold_quantized(flat)
    return weights.stack_numbered_layers(flat, "layers")


def backbone_config_from_flavor(flavor: str) -> transformer.TransformerConfig:
    return transformer.TransformerConfig(
        rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 32.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192}, **_FLAVORS[flavor])


def refuse_q6(tree: dict, name: str) -> None:
    """Raise ValueError on a 6-bit leaf: there is no 6-bit product."""
    q6 = [k for k in pytree.flatten(tree) if k.endswith("weight_q6")]
    if q6:
        raise ValueError(f"{name}: {len(q6)} 6-bit quantised leaves (weight_q6, e.g. {q6[0]}): "
                         "6-bit weights have no product in ops/quant (q4, q8, int8 and W4A8 "
                         "only), in this package or the JAX one")


def load(repo: str, dtype: torch.dtype = torch.bfloat16, device: torch.device | str = "cuda",
         mimi_repo: str = MIMI_REPO):
    """(params, MarvisConfig, tokenizer, Mimi params, MimiConfig), on the
    card unless `device` says otherwise."""
    path = hub.snapshot(repo)
    raw = weights.load_config_json(path)
    cfg = MarvisConfig(
        backbone=backbone_config_from_flavor(raw.get("backbone_flavor", "llama-250M")),
        decoder=backbone_config_from_flavor(raw.get("decoder_flavor", "llama-100M")),
        text_vocab_size=raw.get("text_vocab_size", 128256),
        audio_vocab_size=raw.get("audio_vocab_size", 2048),
        n_codebooks=raw.get("audio_num_codebooks", 32))
    flat = weights.load_safetensors_dir(path)
    bb = {k[len("backbone."):]: v for k, v in flat.items() if k.startswith("backbone.")}
    dec = {k[len("decoder."):]: v for k, v in flat.items() if k.startswith("decoder.")}
    rest = {k: v for k, v in flat.items() if not k.startswith(("backbone.", "decoder."))}
    tree = {"backbone": _convert_stack(bb), "decoder": _convert_stack(dec),
            **pytree.unflatten(load_llama.fold_quantized(rest))}
    refuse_q6(tree, path)
    weights.validate_tree(tree, mmodel.numpy_params(weights.ShapeRNG(), cfg), name=path)
    params = weights.to_device(tree, dtype, device)
    mimi_params, mimi_cfg = load_mimi_dir(hub.snapshot(mimi_repo), device=device)
    return params, cfg, load_tokenizer(path), mimi_params, mimi_cfg


def load_mimi_dir(path: str, dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cuda"):
    """(params, MimiConfig()) of a Mimi checkpoint directory, on the card
    unless `device` says otherwise."""
    cfg = MimiConfig()
    tree = convert_mimi(weights.load_safetensors_dir(path))
    weights.validate_tree(tree, mimi.numpy_params(weights.ShapeRNG(), cfg), name=path)
    return mimi.params_from_numpy(tree, device, dtype), cfg


def convert_mimi(flat: dict) -> dict:
    """kyutai-Mimi layout → the numpy tree in the JAX layout (no IO)."""
    out = {}
    for k, v in flat.items():
        nk = re.sub(r"\.conv\.conv\.", ".", k)
        nk = re.sub(r"\.convtr\.convtr\.", ".", nk)
        nk = re.sub(r"^encoder\.model\.", "encoder.layers.", nk)
        nk = re.sub(r"^decoder\.model\.", "decoder.layers.", nk)
        if v.ndim == 3:
            if "convtr" in k or ".upsample." in k:
                if v.shape[1] == 1:  # depthwise (C, 1, K) → (K, 1, C)
                    v = v.transpose(2, 1, 0)
                else:
                    v = v.transpose(2, 0, 1)  # dense (I, O, K) → (K, I, O)
            else:
                v = v.transpose(2, 1, 0)  # (O, I, K) → (K, I, O)
        out[nk] = v
    return pytree.unflatten(out)
