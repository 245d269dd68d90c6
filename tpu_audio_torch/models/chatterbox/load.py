"""Chatterbox checkpoint loading (port of
tpu_audio/models/chatterbox/load.py: REPOS, S3TOK_REPO, _split_prefixes,
_convert_t3, _convert_conv_layouts, load).

One checkpoint holds three groups under the prefixes t3.*, s3gen.* and
ve.*. T3 goes through the Llama rules of `nn/load_llama.py` with the
stack under tfmr(.model)? (packed q4/q8 words beside their scales folded
to weight_q{bits}, the layers stacked); S3Gen's 3-D weights are read as
torch's (O, I, K) and turned (2, 1, 0) to the JAX (K, I, O), with one more
(0, 2, 1) under "ups", "convT" and "up_layer", the rule CosyVoice2's loader
keeps (ROADMAP C19: unconfirmed against the published files); the voice
encoder's keys stay as they are. The numpy trees equal the JAX `load`'s
before its `to_device`; the port then moves them to torch's layouts on the
device. The S3 tokenizer comes from mlx-community/S3TokenizerV2 through
`codecs/s3tokenizer/load.py`.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from tpu_audio_torch.codecs.s3gen import model as s3gen
from tpu_audio_torch.codecs.s3tokenizer import load as s3tok_load
from tpu_audio_torch.codecs.s3tokenizer import model as s3tok
from tpu_audio_torch.convert import s3_params_from_numpy, serving_dtype
from tpu_audio_torch.models.chatterbox import t3 as t3mod
from tpu_audio_torch.models.chatterbox import voice_encoder as ve
from tpu_audio_torch.nn import load_llama
from tpu_audio_torch.utils import hub, pytree, weights
from tpu_audio_torch.utils.tokenizer import load_tokenizer

REPOS = {"fp16": "mlx-community/Chatterbox-TTS-fp16",
         "8bit": "mlx-community/Chatterbox-TTS-8bit",
         "4bit": "mlx-community/Chatterbox-TTS-4bit"}
S3TOK_REPO = "mlx-community/S3TokenizerV2"


def _split_prefixes(flat: dict) -> dict[str, dict]:
    groups: dict[str, dict] = {"t3": {}, "s3gen": {}, "ve": {}, "other": {}}
    for k, v in flat.items():
        for p in ("t3", "s3gen", "ve"):
            if k.startswith(p + "."):
                groups[p][k[len(p) + 1:]] = v
                break
        else:
            groups["other"][k] = v
    return groups


def _convert_t3(flat: dict) -> dict:
    """T3's flat keys → its numpy tree (JAX layout)."""
    rules = [(r"^tfmr\.model\.", "tfmr.")] + [
        (p.replace("^model", r"^tfmr(\.model)?"), "tfmr." + r)
        for p, r in load_llama._RULES if p.startswith("^model")
    ] + load_llama._RULES
    flat = weights.apply_rules(flat, rules, drop=[r"rotary"])
    flat = load_llama.fold_quantized(flat)
    return weights.stack_numbered_layers(flat, "tfmr.layers")


def _convert_conv_layouts(flat: dict) -> dict:
    """S3Gen's flat keys with their 3-D weights in the JAX (K, I, O)."""
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if v.ndim == 3 and (".weight" in k or k.endswith("weight_v")):
            v = v.transpose(2, 1, 0)  # torch (O, I, K) → (K, I, O)
            if re.search(r"\.(ups|convT|up_layer)\.", k):
                v = v.transpose(0, 2, 1)
        out[k] = v
    return out


def convert_numpy(flat: dict) -> tuple[dict, dict, dict]:
    """A flat checkpoint → (T3, S3Gen, voice encoder) numpy trees in the
    JAX layouts."""
    groups = _split_prefixes(flat)
    return (_convert_t3(groups["t3"]), pytree.unflatten(_convert_conv_layouts(groups["s3gen"])),
            pytree.unflatten(groups["ve"]))


def load_tokenizer_params(device, dtype: torch.dtype):
    """(S3 tokenizer params, config) of S3TokenizerV2 on `device`."""
    tok_flat = weights.load_safetensors_dir(hub.snapshot(S3TOK_REPO))
    return s3tok_load.convert(tok_flat, device, dtype), s3tok.S3TokenizerConfig()


def load(variant: str = "fp16", device: torch.device | str = "cuda"):
    """(T3 params, T3 config, S3Gen params, S3Gen config, tokenizer params,
    tokenizer config, voice encoder params, its config, text tokenizer) on
    `device` (the card unless the caller asks for the CPU), in the device's
    serving dtype; quantised T3 leaves as stored."""
    dtype = serving_dtype(device)
    path = hub.snapshot(REPOS[variant])
    t3_np, s3_np, ve_np = convert_numpy(weights.load_safetensors_dir(path))
    tok_params, tok_cfg = load_tokenizer_params(device, dtype)
    return (weights.to_device(t3_np, dtype, device), t3mod.T3Config(),
            s3_params_from_numpy(s3_np, device, dtype), s3gen.S3GenConfig(), tok_params, tok_cfg,
            weights.to_device(ve_np, dtype, device), ve.VoiceEncConfig(), load_tokenizer(path))
