"""Orpheus checkpoint loading: the Llama LM, the SNAC decoder and the
tokenizer (port of tpu_audio/models/orpheus/load.py: load_snac,
convert_snac, load).

Repos (OrpheusWeightLoader.swift:31, SNACDecoder.swift:291-326):
mlx-community/orpheus-3b-0.1-ft-4bit and mlx-community/snac_24khz.
"""

from __future__ import annotations

import re

import torch

from tpu_audio_torch.codecs.snac import model as snac
from tpu_audio_torch.codecs.snac.model import SNACConfig
from tpu_audio_torch.nn import load_llama
from tpu_audio_torch.utils import hub, pytree, weights
from tpu_audio_torch.utils.tokenizer import load_tokenizer

LLM_REPO = "mlx-community/orpheus-3b-0.1-ft-4bit"
SNAC_REPO = "mlx-community/snac_24khz"


def load_snac(repo: str = SNAC_REPO, dtype: torch.dtype = torch.float32,
              device: torch.device | str = "cuda"):
    """(params, config) of a SNAC checkpoint, on the card unless `device`
    says otherwise."""
    path = hub.snapshot(repo)
    raw = weights.load_config_json(path)
    cfg = SNACConfig(
        sampling_rate=raw.get("sampling_rate", 24000),
        decoder_dim=raw.get("decoder_dim", 1024),
        decoder_rates=tuple(raw.get("decoder_rates", (8, 8, 4, 2))),
        latent_dim=raw.get("latent_dim") or raw.get("encoder_dim", 64) * 16,
        codebook_size=raw.get("codebook_size", 4096),
        codebook_dim=raw.get("codebook_dim", 8),
        vq_strides=tuple(raw.get("vq_strides", (4, 2, 1))),
        noise=raw.get("noise", True),
        depthwise=raw.get("depthwise", True),
    )
    tree = convert_snac(weights.load_safetensors_dir(path))
    weights.validate_tree(tree, snac.numpy_params(weights.ShapeRNG(), cfg), name=repo)
    return weights.to_device(tree, dtype, device), cfg


def convert_snac(flat: dict) -> dict:
    """torch-SNAC layout → the numpy tree in the JAX layout (no IO).

    A Snake alpha goes from torch's (1, C, 1) to the channels-last (1, 1, C)
    the decoder reads. The JAX `convert_snac` turns it (2, 1, 0) like a conv
    kernel and leaves it (1, C, 1) (ROADMAP C11); the port does not copy
    that."""
    out = {}
    for k, v in flat.items():
        nk = _remap_snac_key(k)
        if nk is None:
            continue
        if nk.endswith(".alpha"):
            v = v.transpose(0, 2, 1)
        elif v.ndim == 3:  # conv weights: torch (O, I, K) → (K, I, O)
            v = v.transpose(2, 1, 0)
            if ".convT." in nk:  # a transposed conv, (I, O, K) → (K, O, I) → (K, I, O)
                v = v.transpose(0, 2, 1)
        out[nk] = v
    return pytree.unflatten(out)


def _remap_snac_key(key: str) -> str | None:
    """torch SNAC naming → the tree's. Encoder weights are dropped (the
    engine only decodes)."""
    if key.startswith("encoder."):
        return None
    m = re.match(r"^quantizer\.quantizers\.(\d+)\.(codebook|out_proj)\.(.+)$", key)
    if m:
        return f"quantizer.{m.group(1)}.{m.group(2)}.{m.group(3)}"
    m = re.match(r"^decoder\.model\.(\d+)\.(.*)$", key)
    if not m:
        return None
    idx, rest = int(m.group(1)), m.group(2)
    # decoder.model: 0 depthwise conv, 1 pointwise conv, 2..5 blocks, 6 snake,
    # 7 final conv
    if idx == 0:
        return f"decoder.depthwise_conv.{rest}"
    if idx == 1:
        return f"decoder.pointwise_conv.{rest}"
    if idx in (2, 3, 4, 5):
        return f"decoder.blocks.{idx - 2}.{_remap_block(rest)}"
    if idx == 6:
        return f"decoder.final_snake.{rest}"
    if idx == 7:
        return f"decoder.final_conv.{rest}"
    return None


def _remap_block(rest: str) -> str:
    """block.N: 0 snake, 1 convT, 2 noise, 3..5 residual units; a residual
    unit's layers: 0 snake1, 1 conv1, 2 snake2, 3 conv2."""
    m = re.match(r"^block\.(\d+)\.(.*)$", rest)
    if not m:
        return rest
    i, tail = int(m.group(1)), m.group(2)
    if i == 0:
        return f"snake.{tail}"
    if i == 1:
        return f"convT.{tail}"
    if i == 2 and tail.startswith("linear"):
        return f"noise.{tail}"
    m2 = re.match(r"^block\.(\d+)\.(.*)$", tail)
    if m2:
        j, t2 = int(m2.group(1)), m2.group(2)
        names = {0: "snake1", 1: "conv1", 2: "snake2", 3: "conv2"}
        return f"residuals.{i - 3}.{names.get(j, str(j))}.{t2}"
    return f"residuals.{i - 3}.{tail}"


def load(llm_repo: str = LLM_REPO, snac_repo: str = SNAC_REPO,
         dtype: torch.dtype = torch.bfloat16, device: torch.device | str = "cuda"):
    """(LM params, LM config, tokenizer, SNAC params, SNAC config), on the
    card unless `device` says otherwise; the LM's quantised leaves as
    stored (the engine requantises them)."""
    path = hub.snapshot(llm_repo)
    lm_params, cfg = load_llama.load_llama_dir(path, dtype=dtype, device=device)
    tok = load_tokenizer(path)
    snac_params, snac_cfg = load_snac(snac_repo, device=device)
    return lm_params, cfg, tok, snac_params, snac_cfg
