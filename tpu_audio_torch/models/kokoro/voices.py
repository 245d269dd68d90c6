"""Kokoro's voices and style packs (port of
tpu_audio/models/kokoro/voices.py: VOICES, STYLE_SHAPE, voice_language,
load_voice, random_voice).

52 voices; a voice file holds a (510, 1, 256) style pack indexed by the
phoneme count: the first 128 channels condition the decoder, the last 128
the duration and prosody predictor. `load_voice` reads .npy, .safetensors
(by the port's own reader, `utils/weights`) or raw float32 .bin files
from the model directory's voices/.
"""

from __future__ import annotations

import os

import numpy as np

from tpu_audio_torch.utils import weights

VOICES = [
    "af_alloy", "af_aoede", "af_bella", "af_heart", "af_jessica", "af_kore",
    "af_nicole", "af_nova", "af_river", "af_sarah", "af_sky",
    "am_adam", "am_echo", "am_eric", "am_fenrir", "am_liam", "am_michael",
    "am_onyx", "am_puck", "am_santa",
    "bf_alice", "bf_emma", "bf_isabella", "bf_lily",
    "bm_daniel", "bm_fable", "bm_george", "bm_lewis",
    "ef_dora", "em_alex", "ff_siwis",
    "hf_alpha", "hf_beta", "hm_omega", "hm_psi",
    "if_sara", "im_nicola",
    "jf_alpha", "jf_gongitsune", "jf_nezumi", "jf_tebukuro", "jm_kumo",
    "pf_dora", "pm_santa",
    "zf_xiaobei", "zf_xiaoni", "zf_xiaoxiao", "zf_xiaoyi",
    "zm_yunjian", "zm_yunxi", "zm_yunxia", "zm_yunyang",
]

STYLE_SHAPE = (510, 1, 256)

# voice prefix → language: a American, b British, e Spanish, f French,
# h Hindi, i Italian, j Japanese, p Portuguese, z Chinese
_LANG = {"a": "en-us", "b": "en-gb", "e": "es", "f": "fr", "h": "hi",
         "i": "it", "j": "ja", "p": "pt", "z": "zh"}


def voice_language(name: str) -> str:
    return _LANG.get(name[0], "en-us")


def load_voice(name: str, model_dir: str | None = None) -> np.ndarray:
    """A (510, 1, 256) float32 style pack from `model_dir`/voices/, the
    first of name.npy, name.safetensors (its first tensor) and name.bin
    that exists."""
    if name not in VOICES:
        raise KeyError(f"unknown Kokoro voice {name!r}")
    for ext in (".npy", ".safetensors", ".bin") if model_dir else ():
        path = os.path.join(model_dir, "voices", name + ext)
        if not os.path.exists(path):
            continue
        if ext == ".npy":
            return np.load(path).astype(np.float32).reshape(STYLE_SHAPE)
        if ext == ".safetensors":
            tensors = weights.read_safetensors(path)[0]
            return tensors[next(iter(tensors))].astype(np.float32).reshape(STYLE_SHAPE)
        return np.fromfile(path, dtype=np.float32).reshape(STYLE_SHAPE)
    raise FileNotFoundError(f"voice pack for {name!r} not found under {model_dir}/voices/")


def random_voice(seed: int = 0) -> np.ndarray:
    """A deterministic random style pack (tests, runs without a checkpoint)."""
    return (np.random.default_rng(seed).standard_normal(STYLE_SHAPE).astype(np.float32) * 0.1)
