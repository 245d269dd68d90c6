"""DAC checkpoint loading, mlx-community/dac-speech-24khz-1.5kbps (port of
tpu_audio/codecs/dac/load.py: the key remap, convert, load_dir, load).

A Snake alpha goes from torch's (1, C, 1) to the channels-last (1, 1, C)
the model reads. The JAX `convert` turns every 3-D leaf (2, 1, 0) like a
conv kernel and leaves an alpha (1, C, 1) (ROADMAP C12, the fault C11 is in
SNAC's loader); the port does not copy that. `load_dir` holds the tree
against the DAC schema (`validate_tree`), so an alpha in any other layout
is refused as shape drift.
"""

from __future__ import annotations

import re

import torch

from tpu_audio_torch.codecs.dac import model as dac
from tpu_audio_torch.codecs.dac.model import DACConfig
from tpu_audio_torch.utils import hub, pytree, weights

REPO = "mlx-community/dac-speech-24khz-1.5kbps"


def _remap(key: str) -> str | None:
    """torch DAC naming (encoder.block.N…, decoder.model.N…,
    quantizer.quantizers.N.{in_proj,out_proj,codebook}) → the tree's."""
    m = re.match(r"^quantizer\.quantizers\.(\d+)\.(.+)$", key)
    if m:
        return f"quantizer.{m.group(1)}.{m.group(2)}"
    m = re.match(r"^encoder\.block\.(\d+)\.(.*)$", key)
    if m:
        i, rest = int(m.group(1)), m.group(2)
        if i == 0:
            return f"encoder.conv_in.{rest}"
        if 1 <= i <= 4:
            return f"encoder.blocks.{i - 1}.{_enc_block(rest)}"
        if i == 5:
            return f"encoder.snake_out.{rest}"
        if i == 6:
            return f"encoder.conv_out.{rest}"
    m = re.match(r"^decoder\.model\.(\d+)\.(.*)$", key)
    if m:
        i, rest = int(m.group(1)), m.group(2)
        if i == 0:
            return f"decoder.conv_in.{rest}"
        if 1 <= i <= 4:
            return f"decoder.blocks.{i - 1}.{_dec_block(rest)}"
        if i == 5:
            return f"decoder.snake_out.{rest}"
        if i == 6:
            return f"decoder.conv_out.{rest}"
    return None


def _enc_block(rest: str) -> str:
    m = re.match(r"^block\.(\d+)\.(.*)$", rest)
    if not m:
        return rest
    j, tail = int(m.group(1)), m.group(2)
    if j <= 2:
        return f"residuals.{j}.{_res_unit(tail)}"
    if j == 3:
        return f"snake.{tail}"
    return f"conv.{tail}"


def _dec_block(rest: str) -> str:
    m = re.match(r"^block\.(\d+)\.(.*)$", rest)
    if not m:
        return rest
    j, tail = int(m.group(1)), m.group(2)
    if j == 0:
        return f"snake.{tail}"
    if j == 1:
        return f"convT.{tail}"
    return f"residuals.{j - 2}.{_res_unit(tail)}"


def _res_unit(tail: str) -> str:
    m = re.match(r"^block\.(\d+)\.(.*)$", tail)
    if not m:
        return tail
    names = {0: "snake1", 1: "conv1", 2: "snake2", 3: "conv2"}
    return f"{names.get(int(m.group(1)), m.group(1))}.{m.group(2)}"


def convert_dac(flat: dict) -> dict:
    """torch-DAC layout → the numpy tree in the JAX layout (no IO): conv
    kernels (O, I, K) → (K, I, O), transposed ones (I, O, K) → (K, I, O),
    Snake alphas (1, C, 1) → (1, 1, C)."""
    out = {}
    for k, v in flat.items():
        nk = _remap(k)
        if nk is None:
            continue
        if nk.endswith(".alpha"):
            v = v.transpose(0, 2, 1)
        elif v.ndim == 3:
            v = v.transpose(2, 1, 0)  # (O, I, K) → (K, I, O)
            if ".convT." in nk:  # (I, O, K) → (K, O, I) → (K, I, O)
                v = v.transpose(0, 2, 1)
        out[nk] = v
    return pytree.unflatten(out)


def load_dir(path: str, dtype: torch.dtype = torch.float32,
             device: torch.device | str = "cuda"):
    """(params, config) of a DAC checkpoint directory, on the card unless
    `device` says otherwise."""
    raw = weights.load_config_json(path)
    cfg = DACConfig(
        sampling_rate=raw.get("sampling_rate", 24000),
        encoder_dim=raw.get("encoder_dim", 64),
        encoder_rates=tuple(raw.get("encoder_rates", (2, 4, 5, 8))),
        decoder_dim=raw.get("decoder_dim", 1536),
        decoder_rates=tuple(raw.get("decoder_rates", (8, 5, 4, 2))),
        n_codebooks=raw.get("n_codebooks", 2),
        codebook_size=raw.get("codebook_size", 1024),
        codebook_dim=raw.get("codebook_dim", 8),
        latent_dim=raw.get("latent_dim", 1024),
    )
    tree = convert_dac(weights.load_safetensors_dir(path))
    weights.validate_tree(tree, dac.numpy_params(weights.ShapeRNG(), cfg), name=path)
    return weights.to_device(tree, dtype, device), cfg


def load(repo: str = REPO, dtype: torch.dtype = torch.float32,
         device: torch.device | str = "cuda"):
    return load_dir(hub.snapshot(repo), dtype, device)
