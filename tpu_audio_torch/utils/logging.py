"""Category loggers and timing helpers (port of tpu_audio/utils/logging.py:
get_logger, log_timing, log_rtf).

The loggers live under `tpu_audio_torch.{category}`; the level comes from
`TPU_AUDIO_LOG` (default WARNING), read once, on the first `get_logger`.
Where the variable is set, the package's logger also gets a stream
handler of its own. Unlike the JAX package's, its records still propagate,
so an application's (or pytest's) handlers on the root logger see them.
"""

from __future__ import annotations

import logging
import os

_CATEGORIES = ("audio", "tts", "stt", "model", "perf", "hub", "parallel", "training")
_ROOT = "tpu_audio_torch"
_CONFIGURED = False


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    level = os.environ.get("TPU_AUDIO_LOG")
    root = logging.getLogger(_ROOT)
    root.setLevel((level or "WARNING").upper())
    if level and not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S"))
        root.addHandler(handler)
    _CONFIGURED = True


def get_logger(category: str = "model") -> logging.Logger:
    """The logger of one of the framework's categories; ValueError for any other."""
    _configure()
    if category not in _CATEGORIES:
        raise ValueError(f"unknown log category {category!r}; use one of {_CATEGORIES}")
    return logging.getLogger(f"{_ROOT}.{category}")


def log_timing(operation: str, seconds: float, category: str = "perf") -> None:
    get_logger(category).info("%s took %.3fs", operation, seconds)


def log_rtf(operation: str, processing_time: float, audio_duration: float,
            category: str = "perf") -> None:
    """Log a real-time factor: processing_time / audio_duration (< 1 is
    faster than real time)."""
    rtf = processing_time / audio_duration if audio_duration > 0 else float("inf")
    get_logger(category).info(
        "%s: %.3fs for %.2fs audio (RTF %.3f, %.1fx real time)",
        operation, processing_time, audio_duration, rtf,
        (1.0 / rtf) if rtf > 0 else float("inf"))
