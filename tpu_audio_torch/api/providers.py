"""Provider registries with feature flags (port of
tpu_audio/api/providers.py: TTSProviderInfo, TTSProvider, STTProviderInfo,
STTProvider): per engine, its sample rate, speed control, expression tags,
quality levels, reference audio and text, instruct mode, voice conversion
and streaming granularities.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


@dataclass(frozen=True)
class TTSProviderInfo:
    id: str
    display_name: str
    sample_rate: int = 24000
    supports_speed: bool = False
    supports_expressions: bool = False
    supports_quality_levels: bool = False
    supports_reference_audio: bool = False
    supports_reference_text: bool = False
    supports_instruct: bool = False
    supports_voice_conversion: bool = False
    supports_voices: bool = True
    streaming_granularities: tuple[str, ...] = ("sentence",)
    default_streaming_granularity: str = "sentence"


class TTSProvider(Enum):
    KOKORO = TTSProviderInfo(
        "kokoro", "Kokoro", sample_rate=24000, supports_speed=True)
    ORPHEUS = TTSProviderInfo(
        "orpheus", "Orpheus", supports_expressions=True)
    MARVIS = TTSProviderInfo(
        "marvis", "Marvis", supports_quality_levels=True,
        streaming_granularities=("sentence", "frame"),
        default_streaming_granularity="frame")
    OUTE = TTSProviderInfo(
        "oute", "OuteTTS", supports_reference_audio=True,
        supports_reference_text=True)
    CHATTERBOX = TTSProviderInfo(
        "chatterbox", "Chatterbox", supports_reference_audio=True,
        supports_expressions=True)  # emotion exaggeration
    CHATTERBOX_TURBO = TTSProviderInfo(
        "chatterbox_turbo", "Chatterbox Turbo", supports_reference_audio=True)
    COSYVOICE2 = TTSProviderInfo(
        "cosyvoice2", "CosyVoice 2", supports_reference_audio=True,
        supports_reference_text=True, supports_instruct=True,
        supports_voice_conversion=True, supports_speed=True)
    COSYVOICE3 = TTSProviderInfo(
        "cosyvoice3", "CosyVoice 3", supports_reference_audio=True,
        supports_reference_text=True, supports_instruct=True,
        supports_voice_conversion=True,
        streaming_granularities=("sentence", "token"),
        default_streaming_granularity="token")

    @property
    def info(self) -> TTSProviderInfo:
        return self.value


@dataclass(frozen=True)
class STTProviderInfo:
    id: str
    display_name: str
    sample_rate: int = 16000
    supports_translation: bool = False
    supports_word_timestamps: bool = False
    supports_streaming: bool = False
    supports_language_detection: bool = False


class STTProvider(Enum):
    WHISPER = STTProviderInfo(
        "whisper", "Whisper", supports_translation=True,
        supports_word_timestamps=True, supports_language_detection=True)
    FUNASR = STTProviderInfo(
        "funasr", "Fun-ASR", supports_streaming=True,
        supports_translation=True)

    @property
    def info(self) -> STTProviderInfo:
        return self.value
