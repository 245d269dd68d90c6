"""CosyVoice2 checkpoint loading (port of
tpu_audio/models/cosyvoice2/load.py: REPO, S3TOK_REPO, convert, load).

The weight groups of mlx-community/CosyVoice2-0.5B-4bit: llm.* (the Qwen2
backbone under llm.llm.*, then llm_embedding, llm_decoder and
speech_embedding), flow.* (the conformer and the estimator), hift.* (the
vocoder), campplus.*. `convert_numpy` keeps the JAX `convert`'s rules bit
for bit: the backbone through `load_llama.convert_llama`; every 3-D
weight of S3Gen read as torch's (O, I, K) and turned (2, 1, 0) to the JAX
(K, I, O), and one more (0, 2, 1) under "ups", "convT" and "up_layer" for
torch's transposed (I, O, K); 4-D weights (CAMPPlus's 2-D kernels) kept.
The S3 tokenizer of mlx-community/S3TokenizerV2 is read by
`codecs/s3tokenizer/load.py`, whose rule reads the same publisher's 3-D
weights as MLX's (O, K, I). The two rules disagree, and the conformer's
"up_layer" is an ordinary convolution that the second turn transposes;
neither is confirmed against the published files, which are not in the
repository (ROADMAP C19). `convert` then moves the trees to torch's
layouts on the device.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from tpu_audio_torch.codecs.s3gen import model as s3gen
from tpu_audio_torch.codecs.s3tokenizer import load as s3tok_load
from tpu_audio_torch.codecs.s3tokenizer import model as s3tok
from tpu_audio_torch.convert import s3_params_from_numpy, serving_dtype
from tpu_audio_torch.models.cosyvoice2 import lm as lm_mod
from tpu_audio_torch.nn import load_llama
from tpu_audio_torch.utils import hub, pytree, weights
from tpu_audio_torch.utils.tokenizer import load_tokenizer

REPO = "mlx-community/CosyVoice2-0.5B-4bit"
S3TOK_REPO = "mlx-community/S3TokenizerV2"


def convert_numpy(flat: dict) -> tuple[dict, dict]:
    """A flat checkpoint → (LM tree, S3Gen tree), numpy in the JAX layouts."""
    lm_flat, s3_flat = {}, {}
    for k, v in flat.items():
        if k.startswith(("llm.", "llm_", "speech_embedding.")):
            lm_flat[re.sub(r"^llm\.llm\.", "llm.", k)] = v
        elif k.startswith("flow."):
            s3_flat[k[len("flow."):]] = v
        elif k.startswith("hift."):
            s3_flat["mel2wav." + k[len("hift."):]] = v
        elif k.startswith("campplus."):
            s3_flat["speaker_encoder." + k[len("campplus."):]] = v
    inner = {k[len("llm."):]: v for k, v in lm_flat.items() if k.startswith("llm.")}
    rest = {k: v for k, v in lm_flat.items() if not k.startswith("llm.")}
    lm_params = {"llm": load_llama.convert_llama(inner), **pytree.unflatten(rest)}
    out = {}
    for k, v in s3_flat.items():
        v = np.asarray(v)
        if v.ndim == 3:
            v = v.transpose(2, 1, 0)
            if re.search(r"\.(ups|convT|up_layer)\.", k):
                v = v.transpose(0, 2, 1)
        out[k] = v
    return lm_params, pytree.unflatten(out)


def convert(flat: dict, dtype: torch.dtype = torch.float32,
            device: torch.device | str = "cuda") -> tuple[dict, dict]:
    """A flat checkpoint → (LM tree, S3Gen tree) in the port's layouts on
    `device`."""
    lm_np, s3_np = convert_numpy(flat)
    return weights.to_device(lm_np, dtype, device), s3_params_from_numpy(s3_np, device, dtype)


def load(repo: str = REPO, tok_repo: str = S3TOK_REPO, device: torch.device | str = "cuda"):
    """(LM params, LM config, S3Gen params, S3Gen config, tokenizer params,
    tokenizer config, text tokenizer) on `device` (the card unless the
    caller asks for the CPU), in the device's serving dtype; the LM's
    quantised leaves as stored (the engine requantises them)."""
    dtype = serving_dtype(device)
    path = hub.snapshot(repo)
    lm_params, s3_params = convert(weights.load_safetensors_dir(path), dtype, device)
    tok_params = s3tok_load.convert(weights.load_safetensors_dir(hub.snapshot(tok_repo)),
                                    device, dtype)
    return (lm_params, lm_mod.CosyLMConfig(), s3_params, s3gen.S3GenConfig(), tok_params,
            s3tok.S3TokenizerConfig(), load_tokenizer(path))
