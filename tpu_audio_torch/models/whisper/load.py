"""Whisper checkpoint loading, mlx-community and HF-transformers layouts
(port of tpu_audio/models/whisper/load.py: SIZES, QUANTIZATIONS, REPOS,
repo_for, sanitize, load, serve_tree_int8).

snapshot(repo) → config.json → safetensors (`utils/weights.py`'s reader)
→ `sanitize` → `validate_tree` → `to_device` → `serve_tree_int8` for
"w8a8" → the tokenizer. Key remaps cover:
  - openai/mlx layout: encoder.blocks.N.attn.{query,key,value,out}, mlp1/2,
    attn_ln/mlp_ln, decoder cross_attn..., token_embedding,
    positional_embedding
  - HF layout: model.encoder.layers.N.self_attn.{q,k,v,out}_proj, fc1/fc2,
    self_attn_layer_norm, ...
Conv weights: mlx stores (O, K, I) and HF/torch (O, I, K); `sanitize`
brings both to the JAX package's (K, I, O), as its numpy tree has them, and
`to_device` to torch's (O, I, K).
"""

from __future__ import annotations

import torch

from tpu_audio_torch.models.whisper import model as wmodel
from tpu_audio_torch.models.whisper.config import WhisperConfig
from tpu_audio_torch.models.whisper.tokenizer import WhisperTokenizer
from tpu_audio_torch.nn import load_llama
from tpu_audio_torch.ops import quant
from tpu_audio_torch.utils import hub, pytree, weights

# The model matrix: repo "mlx-community/whisper-{size}-{fp16|8bit|4bit}"
# (package/Models/TranscriptionResult.swift:166-272), multilingual
# tiny..large-v3-turbo and the English-only .en sizes.
SIZES = ("tiny", "base", "small", "medium", "large-v3", "large-v3-turbo",
         "tiny.en", "base.en", "small.en", "medium.en")
# "w8a8" serves the q8 checkpoint requantised at load to per-channel int8
# (`serve_tree_int8`), with the int8 cross-K/V decode state (the engine)
QUANTIZATIONS = ("fp16", "q8", "q4", "w8a8")
_QUANT_SUFFIX = {"fp16": "fp16", "q8": "8bit", "q4": "4bit"}

# the classic mlx-community repo names that host these weights
REPOS = {
    ("tiny", "fp16"): "mlx-community/whisper-tiny-mlx-fp32",
    ("tiny", "q4"): "mlx-community/whisper-tiny-mlx-q4",
    ("base", "fp16"): "mlx-community/whisper-base-mlx",
    ("base", "q4"): "mlx-community/whisper-base-mlx-q4",
    ("small", "fp16"): "mlx-community/whisper-small-mlx",
    ("medium", "fp16"): "mlx-community/whisper-medium-mlx",
    ("large-v3", "fp16"): "mlx-community/whisper-large-v3-mlx",
    ("large-v3", "q4"): "mlx-community/whisper-large-v3-mlx-4bit",
    ("large-v3-turbo", "fp16"): "mlx-community/whisper-large-v3-turbo",
    ("large-v3-turbo", "q4"): "mlx-community/whisper-large-v3-turbo-q4",
    ("tiny.en", "fp16"): "mlx-community/whisper-tiny.en-mlx",
    ("base.en", "fp16"): "mlx-community/whisper-base.en-mlx",
    ("small.en", "fp16"): "mlx-community/whisper-small.en-mlx",
    ("medium.en", "fp16"): "mlx-community/whisper-medium.en-mlx",
}


def repo_for(model: str, quantization: str = "fp16") -> str:
    """(size, quantization) → HF repo id (WhisperModelSize.repoId)."""
    if (model, quantization) in REPOS:
        return REPOS[(model, quantization)]
    if model not in SIZES:
        raise ValueError(f"unknown whisper size {model!r}; one of {SIZES}")
    if quantization not in _QUANT_SUFFIX:
        raise ValueError(f"unknown quantization {quantization!r}; "
                         f"one of {QUANTIZATIONS}")
    return f"mlx-community/whisper-{model}-{_QUANT_SUFFIX[quantization]}"


_MLX_RULES = [
    (r"\.attn\.query\.", ".attn.q."),
    (r"\.attn\.key\.", ".attn.k."),
    (r"\.attn\.value\.", ".attn.v."),
    (r"\.attn\.out\.", ".attn.o."),
    (r"\.cross_attn\.query\.", ".cross_attn.q."),
    (r"\.cross_attn\.key\.", ".cross_attn.k."),
    (r"\.cross_attn\.value\.", ".cross_attn.v."),
    (r"\.cross_attn\.out\.", ".cross_attn.o."),
    (r"\.attn_ln\.", ".ln1."),
    (r"\.cross_attn_ln\.", ".ln_cross."),
    (r"\.mlp_ln\.", ".ln2."),
    (r"\.mlp1\.", ".mlp.fc1."),
    (r"\.mlp2\.", ".mlp.fc2."),
]

_HF_RULES = [
    (r"^model\.", ""),
    (r"^proj_out\.", "decoder.token_embedding."),
    (r"encoder\.layers\.", "encoder.blocks."),
    (r"decoder\.layers\.", "decoder.blocks."),
    (r"\.self_attn\.q_proj\.", ".attn.q."),
    (r"\.self_attn\.k_proj\.", ".attn.k."),
    (r"\.self_attn\.v_proj\.", ".attn.v."),
    (r"\.self_attn\.out_proj\.", ".attn.o."),
    (r"\.encoder_attn\.q_proj\.", ".cross_attn.q."),
    (r"\.encoder_attn\.k_proj\.", ".cross_attn.k."),
    (r"\.encoder_attn\.v_proj\.", ".cross_attn.v."),
    (r"\.encoder_attn\.out_proj\.", ".cross_attn.o."),
    (r"\.self_attn_layer_norm\.", ".ln1."),
    (r"\.encoder_attn_layer_norm\.", ".ln_cross."),
    (r"\.final_layer_norm\.", ".ln2."),
    (r"\.fc1\.", ".mlp.fc1."),
    (r"\.fc2\.", ".mlp.fc2."),
    (r"encoder\.layer_norm\.", "encoder.ln_post."),
    (r"decoder\.layer_norm\.", "decoder.ln."),
    (r"decoder\.embed_tokens\.", "decoder.token_embedding."),
    (r"decoder\.embed_positions\.weight", "decoder.positional_embedding"),
]


def load(model: str = "tiny", quantization: str = "fp16", repo: str | None = None,
         dtype: torch.dtype = torch.float32, device: torch.device | str = "cuda"):
    """(params, config, tokenizer) of a checkpoint, on the card unless
    `device` says otherwise. "w8a8" is a serving format: the q8 checkpoint
    is loaded and `serve_tree_int8` requantises the encoder and decoder
    blocks and the tied token embedding to per-channel int8."""
    serve_int8 = quantization == "w8a8"
    repo = repo or repo_for(model, "q8" if serve_int8 else quantization)
    path = hub.snapshot(repo)
    cfg = WhisperConfig.from_dict(weights.load_config_json(path))
    tree = sanitize(weights.load_safetensors_dir(path))
    weights.validate_tree(tree, wmodel.numpy_params(weights.ShapeRNG(), cfg), name=repo)
    params = weights.to_device(tree, dtype, device)
    del tree
    if serve_int8:
        params = serve_tree_int8(params)
    tok = WhisperTokenizer.load(path, multilingual=cfg.is_multilingual,
                                num_languages=cfg.num_languages)
    return params, cfg, tok


def serve_tree_int8(tree: dict, decoder: bool = True,
                    encoder: bool = True) -> dict:
    """Per-channel int8 W8A8 serving tree: the block matmul weights of the
    chosen halves, and the decoder's tied token embedding, become
    {"weight_i8", "scale_i8"} dicts; convs, norms, biases and positions
    stay as they are. Stacked (L, O, I) leaves keep the JAX layout.

    `Whisper` runs both halves: an int8 decoder through the int8 matmul
    kernels, an int8 encoder (`encoder=True`, the full w8a8 tree) through
    the W8A8 encoder-block kernels (`ops/kernels/fused_encoder_int8.py`)."""
    out = {**tree}
    if encoder:
        enc = quant.requantize_tree_int8(tree["encoder"], fuse=False)
        out["encoder"] = quant.quantize_tree_int8(
            enc, predicate=lambda k, v: "blocks" in k)
    if decoder:
        dec = quant.requantize_tree_int8(tree["decoder"], fuse=False)
        out["decoder"] = quant.quantize_tree_int8(
            dec, predicate=lambda k, v: "blocks" in k
            or k == "token_embedding.weight")
    return out


def sanitize(flat: dict) -> dict:
    """Flat checkpoint dict (mlx or HF layout) → the whisper numpy tree in
    the JAX layout. Pure key and array work, no IO."""
    is_hf = any(k.startswith(("model.encoder", "model.decoder")) for k in flat)
    rules = _HF_RULES if is_hf else _MLX_RULES

    def conv_fix(v):
        if v.ndim == 3:
            return v.transpose(2, 1, 0) if is_hf else v.transpose(1, 2, 0)
        return v

    flat = weights.apply_rules(
        flat, rules,
        transforms={r"encoder\.conv[12]\.weight": conv_fix},
        # the encoder positions are sinusoids, recomputed rather than loaded
        # (checkpoints still ship them)
        drop=[r"\.rotary_emb\.", r"alignment_heads",
              r"^(model\.)?encoder\.(positional_embedding|embed_positions)"])
    flat = load_llama.fold_quantized(flat)
    tree = weights.stack_numbered_layers(flat, "encoder.blocks")
    return weights.stack_numbered_layers(pytree.flatten(tree), "decoder.blocks")
