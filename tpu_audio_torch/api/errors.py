"""Typed errors with failure reasons and recovery suggestions (port of
tpu_audio/api/errors.py, the whole module).

Mirrors package/Models/TTSError.swift:6 / STTError.swift:6: each case
carries a human-readable reason and a suggested recovery action (the
reference's LocalizedError surface).
"""

from __future__ import annotations


class TTSAudioError(Exception):
    """Base TTS error."""

    def __init__(self, message: str, failure_reason: str = "",
                 recovery_suggestion: str = ""):
        super().__init__(message)
        self.failure_reason = failure_reason
        self.recovery_suggestion = recovery_suggestion


class STTAudioError(TTSAudioError):
    """Base STT error."""


class ModelNotLoadedError(TTSAudioError):
    def __init__(self, name: str = "model"):
        super().__init__(
            f"{name} is not loaded",
            failure_reason="generate/transcribe called before load()",
            recovery_suggestion="call engine.load() first")


class ModelLoadError(TTSAudioError):
    def __init__(self, repo: str, cause: str = ""):
        super().__init__(
            f"failed to load {repo}: {cause}",
            failure_reason=cause,
            recovery_suggestion="check the repo id / local path and that the "
                                "checkpoint files are present")


class AudioProcessingError(STTAudioError):
    def __init__(self, msg: str):
        super().__init__(msg,
                         failure_reason="audio could not be decoded/processed",
                         recovery_suggestion="provide mono float audio or a "
                                             "PCM/float WAV file")


class GenerationError(TTSAudioError):
    def __init__(self, msg: str):
        super().__init__(msg, failure_reason="generation failed",
                         recovery_suggestion="retry with different sampling "
                                             "settings or shorter text")


class UnsupportedLanguageError(TTSAudioError):
    def __init__(self, lang: str, supported=None):
        super().__init__(
            f"unsupported language {lang!r}",
            failure_reason=f"{lang!r} is not in the engine's language set",
            recovery_suggestion=f"use one of {sorted(supported)[:10]}..."
            if supported else "check engine.supported_languages")
