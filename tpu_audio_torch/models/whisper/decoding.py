"""Whisper decoding constants, results and suppression masks (port of
tpu_audio/models/whisper/decoding.py: NEG_INF, MAX_INITIAL_TIMESTAMP_INDEX,
DecodingResult, compression_ratio, build_suppress_mask, build_blank_mask).

The single-segment `SegmentDecoder` is not ported yet; the batched loop is
in `batch.py`.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np

from tpu_audio_torch.models.whisper.tokenizer import WhisperTokenizer

NEG_INF = float(np.finfo(np.float32).min)
MAX_INITIAL_TIMESTAMP_INDEX = 50


@dataclass
class DecodingResult:
    tokens: list = field(default_factory=list)
    text: str = ""
    avg_logprob: float = 0.0
    no_speech_prob: float = 0.0
    temperature: float = 0.0
    compression_ratio: float = 0.0


def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def build_suppress_mask(tok: WhisperTokenizer, n_vocab: int) -> np.ndarray:
    """Static (V,) additive mask for always-suppressed tokens."""
    mask = np.zeros(n_vocab, np.float32)
    ids = list(tok.non_speech_tokens) + [
        tok.transcribe, tok.translate, tok.sot, tok.sot_prev, tok.sot_lm,
        tok.no_speech,
    ]
    for t in ids:
        if t < n_vocab:
            mask[t] = NEG_INF
    return mask


def build_blank_mask(tok: WhisperTokenizer, n_vocab: int) -> np.ndarray:
    """Extra first-step mask: blank and EOT suppressed."""
    mask = np.zeros(n_vocab, np.float32)
    for t in tok.encode(" ") + [tok.eot]:
        mask[t] = NEG_INF
    return mask
