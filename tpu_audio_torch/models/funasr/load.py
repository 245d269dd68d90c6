"""Fun-ASR checkpoint loading (port of tpu_audio/models/funasr/load.py:
convert, load). Variants nano / mlt_nano × q4 / q8 / fp16
(Config/FunASRConfig.swift:11-73); weight groups encoder.* (SenseVoice),
adaptor.*, llm.* (Qwen3); the conv sanitize of FunASRModel.swift:207-233.
"""

from __future__ import annotations

import re

import torch

from tpu_audio_torch.models.funasr import model as fmodel
from tpu_audio_torch.nn import load_llama
from tpu_audio_torch.utils import hub, pytree, weights
from tpu_audio_torch.utils.tokenizer import load_tokenizer


def convert(flat: dict) -> dict:
    """Checkpoint layout → {encoder, adaptor, llm} numpy tree in the JAX
    layout (no IO)."""
    enc, adp, llm = {}, {}, {}
    for k, v in flat.items():
        if v.ndim == 3 and "fsmn" in k:
            v = v.transpose(2, 1, 0)  # torch depthwise (O, 1, K) → (K, 1, O)
        if k.startswith("encoder."):
            enc[k[len("encoder."):]] = v
        elif k.startswith(("adaptor.", "audio_adaptor.")):
            adp[k.split(".", 1)[1]] = v
        elif k.startswith(("llm.", "model.")):
            llm[k] = v
    llm_inner = {re.sub(r"^llm\.", "", k): v for k, v in llm.items()}
    return {
        "encoder": pytree.unflatten(enc),
        "adaptor": pytree.unflatten(adp),
        "llm": load_llama.convert_llama(load_llama.fold_quantized(llm_inner)),
    }


def load(repo: str, dtype: torch.dtype = torch.bfloat16, device: torch.device | str = "cuda"):
    """(params, config, tokenizer) of a Fun-ASR checkpoint, on the card
    unless `device` says otherwise. The LLM config comes from config.json's
    `llm_config` (or the file itself where it has `hidden_size`), else
    Qwen3-0.6B's."""
    path = hub.snapshot(repo)
    params = convert(weights.load_safetensors_dir(path))
    raw = weights.load_config_json(path)
    llm_cfg = (load_llama.config_from_hf(raw.get("llm_config", raw))
               if "hidden_size" in raw or "llm_config" in raw else fmodel.QWEN3_06B)
    cfg = fmodel.FunASRConfig(llm=llm_cfg)
    return weights.to_device(params, dtype, device), cfg, load_tokenizer(path)
