"""Typed results of the STT API (port of tpu_audio/api/results.py:
TranscriptionTask, TimestampGranularity, Word, TranscriptionSegment,
TranscriptionResult).

RTF is processing_time / audio duration (< 1 means faster than real
time). The TTS `AudioResult` comes with the TTS engines.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum


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
