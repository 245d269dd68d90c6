"""Typed results of the STT and TTS APIs (port of tpu_audio/api/results.py:
TranscriptionTask, TimestampGranularity, Word, TranscriptionSegment,
TranscriptionResult, AudioResult).

RTF is processing_time / audio duration (< 1 means faster than real
time).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

import numpy as np


class TranscriptionTask(str, Enum):
    TRANSCRIBE = "transcribe"
    TRANSLATE = "translate"


class TimestampGranularity(str, Enum):
    NONE = "none"
    SEGMENT = "segment"
    WORD = "word"


@dataclass
class Word:
    word: str
    start: float
    end: float
    probability: float = 1.0


@dataclass
class TranscriptionSegment:
    id: int
    seek: int
    start: float
    end: float
    text: str
    tokens: list[int] = field(default_factory=list)
    temperature: float = 0.0
    avg_logprob: float = 0.0
    compression_ratio: float = 0.0
    no_speech_prob: float = 0.0
    words: list[Word] | None = None


@dataclass
class TranscriptionResult:
    text: str
    segments: list[TranscriptionSegment] = field(default_factory=list)
    language: str = "en"
    duration: float = 0.0
    processing_time: float = 0.0

    @property
    def rtf(self) -> float:
        return self.processing_time / self.duration if self.duration > 0 else float("inf")

    @property
    def words(self) -> list[Word]:
        out = []
        for seg in self.segments:
            if seg.words:
                out.extend(seg.words)
        return out


@dataclass
class AudioResult:
    """TTS output: samples (float32, in [-1, 1]) at a sample rate."""

    samples: np.ndarray
    sample_rate: int
    processing_time: float = 0.0

    @property
    def duration(self) -> float:
        return len(self.samples) / self.sample_rate

    @property
    def rtf(self) -> float:
        return self.processing_time / self.duration if self.duration > 0 else float("inf")

    def save(self, path: str, dtype: str = "int16") -> str:
        from tpu_audio_torch.utils.audio_io import write_wav

        write_wav(path, self.samples, self.sample_rate, dtype=dtype)
        return path
