"""CosyVoice3 checkpoint loading (port of tpu_audio/models/cosyvoice3/load.py:
REPO, S3TOK_V3_REPO, convert, load).

The weight groups of mlx-community/Fun-CosyVoice3-0.5B-2512-4bit: llm.*
(the Qwen2 backbone under llm.llm.*, then llm_embedding, llm_decoder and
speech_embedding), flow.* (the token embedding, the speaker affine, the
pre-lookahead layer and the DiT under upstream CosyVoice's names:
decoder.estimator.transformer_blocks.N …, remapped by `_remap_flow_key`;
the rotary tables and the affine-free norms' entries dropped) and hift.*
(the vocoder). `convert_numpy` keeps the JAX `convert`'s rules bit for
bit, 3-D weights read as torch's (O, I, K) and turned to the JAX (K, I, O)
(one more turn under "ups", "convT" and "up_layer"); `convert` then moves
the trees to the port's layouts on the device. The tokenizer is
S3TokenizerV3, read by `codecs/s3tokenizer/load.py`.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from tpu_audio_torch.codecs.s3tokenizer import load as s3tok_load
from tpu_audio_torch.codecs.s3tokenizer import model as s3tok
from tpu_audio_torch.convert import s3_params_from_numpy, serving_dtype
from tpu_audio_torch.models.cosyvoice2 import lm as lm_mod
from tpu_audio_torch.models.cosyvoice3 import model as cv3
from tpu_audio_torch.nn import load_llama
from tpu_audio_torch.utils import hub, pytree, weights
from tpu_audio_torch.utils.tokenizer import load_tokenizer

REPO = "mlx-community/Fun-CosyVoice3-0.5B-2512-4bit"
S3TOK_V3_REPO = "mlx-community/S3TokenizerV3"

_FLOW_NAMES = [(".attn.to_out_0.", ".attn.to_out."), (".attn.to_out.0.", ".attn.to_out."),
               (".ff.ff_0_0.", ".ff.fc1."), (".ff.ff.0.0.", ".ff.fc1."),
               (".ff.ff_2.", ".ff.fc2."), (".ff.ff.2.", ".ff.fc2."),
               (".input_embed.conv_pos_embed.", ".input_embed."),
               (".norm_out.linear.", ".final_norm.linear.")]


def _remap_flow_key(k: str) -> str | None:
    """A checkpoint flow.* key (its "flow." cut) → the tree's, or None for
    an entry computed at run time."""
    if "rotary_embed" in k:
        return None
    k = re.sub(r"^decoder\.estimator\.", "decoder_estimator.", k)
    k = re.sub(r"transformer_blocks[._](\d+)\.", r"blocks.\1.", k)
    for old, new in _FLOW_NAMES:
        k = k.replace(old, new)
    if re.search(r"\.(ff_norm|attn_norm\.norm|final_norm\.norm)\.", k):
        return None  # affine-free LayerNorms carry no weights
    return k


def convert_numpy(flat: dict) -> tuple[dict, dict]:
    """A flat checkpoint → (LM tree, flow tree), numpy in the JAX layouts."""
    lm_flat, flow_flat = {}, {}
    for k, v in flat.items():
        if k.startswith(("llm.", "llm_", "speech_embedding.")):
            lm_flat[re.sub(r"^llm\.llm\.", "llm.", k)] = v
        elif k.startswith("flow."):
            nk = _remap_flow_key(k[len("flow."):])
            if nk is not None:
                flow_flat[nk] = v
        elif k.startswith("hift."):
            flow_flat["mel2wav." + k[len("hift."):]] = v
    inner = {k[len("llm."):]: v for k, v in lm_flat.items() if k.startswith("llm.")}
    rest = {k: v for k, v in lm_flat.items() if not k.startswith("llm.")}
    lm_params = {"llm": load_llama.convert_llama(inner), **pytree.unflatten(rest)}
    out = {}
    for k, v in flow_flat.items():
        v = np.asarray(v)
        if v.ndim == 3:
            v = v.transpose(2, 1, 0)
            if re.search(r"\.(ups|convT|up_layer)\.", k):
                v = v.transpose(0, 2, 1)
        out[k] = v
    return lm_params, pytree.unflatten(out)


def convert(flat: dict, dtype: torch.dtype = torch.float32,
            device: torch.device | str = "cuda") -> tuple[dict, dict]:
    """A flat checkpoint → (LM tree, flow tree) in the port's layouts on
    `device`."""
    lm_np, flow_np = convert_numpy(flat)
    return weights.to_device(lm_np, dtype, device), s3_params_from_numpy(flow_np, device, dtype)


def load(repo: str = REPO, tok_repo: str = S3TOK_V3_REPO, device: torch.device | str = "cuda"):
    """(LM params, LM config, flow params, flow config, tokenizer params,
    tokenizer config, text tokenizer) on `device` (the card unless the
    caller asks for the CPU), in the device's serving dtype; the LM's
    quantised leaves as stored (the engine requantises them)."""
    dtype = serving_dtype(device)
    path = hub.snapshot(repo)
    lm_params, flow_params = convert(weights.load_safetensors_dir(path), dtype, device)
    tok_params = s3tok_load.convert(weights.load_safetensors_dir(hub.snapshot(tok_repo)),
                                    device, dtype)
    return (lm_params, lm_mod.CosyLMConfig(), flow_params, cv3.CV3FlowConfig(), tok_params,
            s3tok.S3TokenizerConfig(), load_tokenizer(path))
