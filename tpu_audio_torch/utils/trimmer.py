"""Silence trimming and word-boundary clipping for reference audio (port
of tpu_audio/utils/trimmer.py): a librosa-style top-dB energy trim, the
preset configs (default and CosyVoice2 top_db 60, Chatterbox 20), and
clipping at Whisper word boundaries with trailing words dropped and
hallucinated ones (low probability or over-long) filtered. NumPy only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpu_audio_torch.api.results import Word


@dataclass(frozen=True)
class AudioTrimConfig:
    top_db: float = 60.0
    frame_length: float = 0.025  # seconds
    hop_length: float = 0.0125
    trailing_words_to_drop: int = 1
    min_word_probability: float = 0.3
    max_word_duration: float = 2.0


COSYVOICE2 = AudioTrimConfig(top_db=60.0)
CHATTERBOX = AudioTrimConfig(top_db=20.0)  # more aggressive
DEFAULT = AudioTrimConfig()


@dataclass
class AudioTrimResult:
    audio: np.ndarray
    sample_rate: int
    transcription: str | None = None
    words: list[Word] | None = None
    original_duration: float = 0.0
    trimmed_duration: float = 0.0
    clipped_at_word_boundary: bool = False


def _frame_rms_db(audio: np.ndarray, frame: int, hop: int) -> np.ndarray:
    n = max(0, 1 + (len(audio) - frame) // hop)
    if n == 0:
        return np.full(1, -np.inf)
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    rms = np.sqrt(np.mean(audio[idx] ** 2, axis=1))
    ref = rms.max() if rms.max() > 0 else 1e-10
    return 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)


def trim_silence(audio: np.ndarray, sample_rate: int,
                 config: AudioTrimConfig = DEFAULT) -> tuple[np.ndarray, int, int]:
    """librosa.effects.trim semantics: drop leading/trailing frames more than
    top_db below the peak RMS. Returns (trimmed, start_sample, end_sample)."""
    frame = int(config.frame_length * sample_rate)
    hop = int(config.hop_length * sample_rate)
    db = _frame_rms_db(np.asarray(audio, np.float32), frame, hop)
    keep = np.where(db > -config.top_db)[0]
    if len(keep) == 0:
        return audio[:0], 0, 0
    start = int(keep[0] * hop)
    end = min(len(audio), int(keep[-1] * hop + frame))
    return audio[start:end], start, end


def drop_hallucinated_words(words: list[Word],
                            config: AudioTrimConfig = DEFAULT) -> list[Word]:
    """Strip trailing words that look hallucinated: low probability or
    anomalously long (reference hallucination-word dropping)."""
    out = list(words)
    while out:
        w = out[-1]
        if (w.probability < config.min_word_probability
                or (w.end - w.start) > config.max_word_duration):
            out.pop()
        else:
            break
    return out


def clip_at_word_boundary(audio: np.ndarray, sample_rate: int,
                          words: list[Word],
                          config: AudioTrimConfig = DEFAULT) -> AudioTrimResult:
    """Clip reference audio at the end of the last reliable word, dropping
    `trailing_words_to_drop` words (reference: AudioTrimmer word clipping).

    Used when preparing voice-cloning reference audio so the prompt doesn't
    end mid-word."""
    original_duration = len(audio) / sample_rate
    usable = drop_hallucinated_words(words, config)
    n_drop = config.trailing_words_to_drop
    if n_drop and len(usable) > n_drop:
        usable = usable[:-n_drop]
    if not usable:
        trimmed, _, _ = trim_silence(audio, sample_rate, config)
        return AudioTrimResult(
            audio=trimmed, sample_rate=sample_rate,
            original_duration=original_duration,
            trimmed_duration=len(trimmed) / sample_rate,
            clipped_at_word_boundary=False)
    end_sample = min(len(audio), int(usable[-1].end * sample_rate))
    clipped = audio[:end_sample]
    text = "".join(w.word for w in usable).strip()
    return AudioTrimResult(
        audio=clipped, sample_rate=sample_rate, transcription=text,
        words=usable, original_duration=original_duration,
        trimmed_duration=len(clipped) / sample_rate,
        clipped_at_word_boundary=True)
