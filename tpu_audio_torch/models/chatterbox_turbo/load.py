"""Chatterbox Turbo checkpoint loading (port of
tpu_audio/models/chatterbox_turbo/load.py: REPOS, load).

The t3.* group splits into the GPT-2 stack (the keys under h., wte., wpe.
and ln_f. after an optional tfmr. prefix) through
`nn/load_llama.convert_gpt2`, its position table popped into "wpe", and
the rest (text_emb, speech_emb, speech_head, cond_enc) under its own
names; s3gen.* and ve.* as Chatterbox's `load.py` reads them. One rule
more than the JAX loader: packed q4/q8 words beside their scales are
folded to weight_q{bits} (`load_llama.fold_quantized`) before the split,
as `_convert_t3` folds Chatterbox's; the JAX loader leaves them named
"weight", and then transposes the packed words of c_attn, c_proj and c_fc
as if they were HF Conv1D floats (ROADMAP C24). Folded leaves are read in
the Linear layout (O, I) the quantiser works in, and only fp weights get
the Conv1D transpose.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from tpu_audio_torch.codecs.s3gen import model as s3gen
from tpu_audio_torch.convert import s3_params_from_numpy, serving_dtype
from tpu_audio_torch.models.chatterbox import voice_encoder as ve
from tpu_audio_torch.models.chatterbox.load import (_convert_conv_layouts, _split_prefixes,
                                                    load_tokenizer_params)
from tpu_audio_torch.models.chatterbox_turbo import model as turbo
from tpu_audio_torch.nn import load_llama
from tpu_audio_torch.utils import hub, pytree, weights
from tpu_audio_torch.utils.tokenizer import load_tokenizer

REPOS = {"fp16": "mlx-community/Chatterbox-TTS-Turbo-fp16",
         "8bit": "mlx-community/Chatterbox-TTS-Turbo-8bit",
         "4bit": "mlx-community/Chatterbox-TTS-Turbo-4bit"}
GPT2_PREFIXES = ("h.", "wte.", "wpe.", "ln_f.")


def convert_t3(flat: dict) -> dict:
    """The t3 group's flat keys → the Turbo T3 numpy tree (JAX layout)."""
    t3_flat = load_llama.fold_quantized({re.sub(r"^tfmr\.", "", k): v for k, v in flat.items()})
    gpt = {k: v for k, v in t3_flat.items() if k.startswith(GPT2_PREFIXES)}
    rest = {k: v for k, v in t3_flat.items() if k not in gpt}
    tree = load_llama.convert_gpt2(gpt)
    wpe = tree.pop("pos_embed", None)
    out = {"tfmr": tree, **pytree.unflatten(rest)}
    if wpe is not None:
        out["wpe"] = wpe
    return out


def load(variant: str = "fp16", device: torch.device | str = "cuda"):
    """(T3 params, T3TurboConfig, S3Gen params, S3Gen config, tokenizer
    params, tokenizer config, voice encoder params, its config, text
    tokenizer) on `device` (the card unless the caller asks for the CPU), in
    the device's serving dtype; quantised T3 leaves as stored."""
    dtype = serving_dtype(device)
    path = hub.snapshot(REPOS[variant])
    groups = _split_prefixes(weights.load_safetensors_dir(path))
    tok_params, tok_cfg = load_tokenizer_params(device, dtype)
    s3_np = pytree.unflatten(_convert_conv_layouts(groups["s3gen"]))
    s3cfg = s3gen.S3GenConfig()
    s3cfg = dataclasses.replace(s3cfg, estimator=dataclasses.replace(s3cfg.estimator,
                                                                     meanflow=True))
    return (weights.to_device(convert_t3(groups["t3"]), dtype, device), turbo.T3TurboConfig(),
            s3_params_from_numpy(s3_np, device, dtype), s3cfg, tok_params, tok_cfg,
            weights.to_device(pytree.unflatten(groups["ve"]), dtype, device), ve.VoiceEncConfig(),
            load_tokenizer(path))
