"""Kokoro checkpoint loading (port of tpu_audio/models/kokoro/load.py:
REPO, WEIGHTS_FILE, _remap_key, _fix_conv_layout, convert, load).

mlx-community/Kokoro-82M-bf16 → `utils/hub.snapshot` → the port's
safetensors reader (BF16 widened to f32) → the reference's key remaps
(duration_proj.linear_layer → duration_proj, predictor.text_encoder.lstms
.{2i} → lstm{i} and .{2i+1} → norm{i}, text_encoder.cnn.N.{0,1} → conv /
norm, gamma / beta → weight / bias, the LSTMs' weight_ih_l0 / _hh_l0 /
*_reverse → fwd / bwd wx, wh and biases) and the MLX conv layouts to the
JAX (K, I, O): a convolution (O, K, I), a transposed one (ups, pool) (I,
K, O) → `validate_tree` against `numpy_params`' schema → Kokoro's own
`params_from_numpy` onto the device in f32 (on the card too, as the JAX
`load` serves f32).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from tpu_audio_torch.models.kokoro import model as kmodel
from tpu_audio_torch.models.kokoro.config import KokoroConfig
from tpu_audio_torch.utils import hub, pytree, weights

REPO = "mlx-community/Kokoro-82M-bf16"
WEIGHTS_FILE = "kokoro-v1_0.safetensors"

_RULES = [
    (r"duration_proj\.linear_layer\.", "duration_proj."),
    (r"\.gamma$", ".weight"),
    (r"\.beta$", ".bias"),
]


def _remap_key(key: str) -> str | None:
    if "position_ids" in key:
        return None
    for pat, repl in _RULES:
        key = re.sub(pat, repl, key)
    # predictor.text_encoder.lstms.N → lstm{N//2} / norm{N//2}
    m = re.match(r"^(predictor\.text_encoder)\.lstms\.(\d+)\.(.+)$", key)
    if m:
        idx = int(m.group(2))
        name = f"lstm{idx // 2}" if idx % 2 == 0 else f"norm{idx // 2}"
        key = f"{m.group(1)}.{name}.{m.group(3)}"
    # text_encoder.cnn.N.{0,1} → conv / norm
    m = re.match(r"^(text_encoder\.cnn\.\d+)\.([01])\.(.+)$", key)
    if m:
        key = f"{m.group(1)}.{'conv' if m.group(2) == '0' else 'norm'}.{m.group(3)}"
    # LSTM parameters: weight_ih_l0 → fwd.wx and so on
    m = re.match(r"^(.*)\.(weight|bias)_(ih|hh)_l0(_reverse)?$", key)
    if m:
        direction = "bwd" if m.group(4) else "fwd"
        kind = ("wx" if m.group(3) == "ih" else "wh") if m.group(2) == "weight" \
            else ("bias_ih" if m.group(3) == "ih" else "bias_hh")
        key = f"{m.group(1)}.{direction}.{kind}"
    return key


def _fix_conv_layout(key: str, v: np.ndarray) -> np.ndarray:
    """The MLX conv layouts → the JAX (K, I, O): a convolution (O, K, I),
    a transposed one (ups, pool) (I, K, O), by key and never by shape (F0_conv
    and N_conv have K = 3 > I = 1 at full width)."""
    if v.ndim != 3:
        return v
    if re.search(r"\.(ups|pool)\.", key) or key.endswith("pool.weight_v"):
        return v.transpose(1, 0, 2)  # (I, K, O) → (K, I, O)
    return v.transpose(1, 2, 0)  # (O, K, I) → (K, I, O)


def convert(flat_np: dict) -> dict:
    """A flat checkpoint → Kokoro's numpy tree in the JAX layout (no IO)."""
    out = {}
    for k, v in flat_np.items():
        nk = _remap_key(k)
        if nk is not None:
            out[nk] = _fix_conv_layout(nk, np.asarray(v))
    return pytree.unflatten(out)


def load(repo: str | None = None, device: torch.device | str = "cuda"):
    """(params on `device` in f32, `KokoroConfig()`, the model directory)
    of the checkpoint `repo` (a directory or a cached repo id; the
    published bf16 one by default), validated against the schema."""
    cfg = KokoroConfig()
    path = hub.snapshot(repo or REPO)
    tree = convert(weights.load_safetensors_dir(path))
    weights.validate_tree(tree, kmodel.numpy_params(weights.ShapeRNG(), cfg), name=path)
    return kmodel.params_from_numpy(tree, device, torch.float32), cfg, path
