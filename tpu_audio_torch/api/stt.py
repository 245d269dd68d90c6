"""Public STT API: the engine contract and the factories (port of
tpu_audio/api/stt.py: STTEngineBase, WhisperEngine, STT.whisper,
STT.fun_asr, with `STT.funasr` its alias).

`STT.whisper(...)` returns an engine with load / transcribe / translate /
detect_language / transcribe_batch / warmup / stop / unload / cleanup and
the is_transcribing / transcription_time state; `STT.fun_asr(...)` the
Fun-ASR engine (`api/stt_funasr.py`: transcribe / translate /
transcribe_streaming). `load()` reads the checkpoint of `repo` (a local
directory, or a repo id whose snapshot sits in the pre-seeded cache,
`utils/hub.py`) onto `device`, the card unless the caller asks for the
CPU: bf16 weights on the card, f32 on the CPU. `WhisperEngine.from_pipeline`
and `FunASREngine.from_params` wrap trees already built. Audio is a float
array at 16 kHz or a WAV file's path (`utils/audio_io.load_audio`).
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from tpu_audio_torch.api.results import TranscriptionResult
from tpu_audio_torch.convert import serving_dtype

_log = logging.getLogger("tpu_audio_torch.stt")


class STTEngineBase:
    """Lifecycle and state shared by STT engines."""

    sample_rate: int = 16000

    def __init__(self, device: torch.device | str = "cuda"):
        self.device = device
        self.is_loaded = False
        self.is_transcribing = False
        self.transcription_time: float = 0.0
        self._stop_flag = threading.Event()

    def load(self, progress_handler=None) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        self._stop_flag.set()

    def unload(self) -> None:
        self.is_loaded = False

    def cleanup(self) -> None:
        self.unload()

    def warmup(self, full: bool = False) -> dict[str, float]:
        """Transcribe silence once before the first real request (2 s;
        full=True adds a whole 30 s window): builds the kernels and fills
        the allocator's caches. Returns {variant: seconds}."""
        variants = {"short": 2.0}
        if full:
            variants["window"] = 30.0
        timings: dict[str, float] = {}
        for name, secs in variants.items():
            t0 = time.perf_counter()
            self.transcribe(np.zeros(int(secs * self.sample_rate), np.float32))
            timings[name] = time.perf_counter() - t0
        _log.info("warmup(%s): %s", type(self).__name__,
                  {k: f"{v:.2f}s" for k, v in timings.items()})
        return timings

    def _resolve_audio(self, audio) -> np.ndarray:
        """A file path (read, mixed to mono, resampled to self.sample_rate)
        or a float array at self.sample_rate."""
        if isinstance(audio, str):
            from tpu_audio_torch.utils.audio_io import load_audio

            samples, _ = load_audio(audio, target_rate=self.sample_rate)
            return samples
        return np.asarray(audio, np.float32)


class WhisperEngine(STTEngineBase):
    """Whisper STT engine over a `models.whisper.pipeline.WhisperPipeline`."""

    def __init__(self, model: str = "tiny", quantization: str = "fp16",
                 repo: str | None = None, device: torch.device | str = "cuda"):
        super().__init__(device)
        self.model_name = model
        self.quantization = quantization
        self.repo = repo
        self.pipeline = None

    def load(self, progress_handler=None) -> None:
        if self.is_loaded:
            return
        from tpu_audio_torch.models.whisper import load as wload
        from tpu_audio_torch.models.whisper.model import Whisper
        from tpu_audio_torch.models.whisper.pipeline import WhisperPipeline

        dtype = serving_dtype(self.device)
        params, cfg, tok = wload.load(self.model_name, self.quantization, repo=self.repo,
                                      dtype=dtype, device=self.device)
        # the w8a8 serving format also keeps the cross-K/V state in int8
        self.pipeline = WhisperPipeline(Whisper(cfg, params), tok, compute_dtype=dtype,
                                        kv_int8=self.quantization == "w8a8")
        self.is_loaded = True

    @classmethod
    def from_pipeline(cls, pipeline) -> "WhisperEngine":
        """An engine around an existing pipeline (random weights, tests)."""
        eng = cls(device=pipeline.model.device)
        eng.pipeline = pipeline
        eng.is_loaded = True
        return eng

    def transcribe(self, audio, *, language: str | None = None,
                   temperature=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                   timestamps: bool = True, word_timestamps: bool = False,
                   **kw) -> TranscriptionResult:
        return self._run(audio, task="transcribe", language=language,
                         temperature=temperature, timestamps=timestamps,
                         word_timestamps=word_timestamps, **kw)

    def translate(self, audio, *, language: str | None = None,
                  **kw) -> TranscriptionResult:
        return self._run(audio, task="translate", language=language, **kw)

    def detect_language(self, audio) -> tuple[str, dict]:
        self._ensure_loaded()
        return self.pipeline.detect_language(self._resolve_audio(audio))

    def transcribe_batch(self, audios, *, batch_size: int = 8,
                         language: str = "en", **kw) -> list[str]:
        """Throughput-mode transcription of many clips: fixed-stride 30 s
        windows decoded `batch_size` at a time (`batch.transcribe_windows`),
        without the seek loop's content-aware advance and temperature
        fallback. Returns one text per clip."""
        self._ensure_loaded()
        from tpu_audio_torch.models.whisper import batch as wbatch

        samples = [self._resolve_audio(a) for a in audios]
        self.is_transcribing = True
        t0 = time.perf_counter()
        try:
            return wbatch.transcribe_windows(
                self.pipeline.model, self.pipeline.tok, samples,
                batch_size=batch_size, language=language, **kw)
        finally:
            self.is_transcribing = False
            self.transcription_time = time.perf_counter() - t0

    def _run(self, audio, **kw) -> TranscriptionResult:
        self._ensure_loaded()
        samples = self._resolve_audio(audio)
        self.is_transcribing = True
        t0 = time.perf_counter()
        try:
            result = self.pipeline.transcribe(samples, **kw)
        finally:
            self.is_transcribing = False
            self.transcription_time = time.perf_counter() - t0
        return result

    def _ensure_loaded(self):
        if self.pipeline is None:
            self.load()


class STT:
    """Factory namespace."""

    @staticmethod
    def whisper(model: str = "tiny", quantization: str = "fp16",
                repo: str | None = None, device: torch.device | str = "cuda") -> WhisperEngine:
        return WhisperEngine(model, quantization, repo, device)

    @staticmethod
    def fun_asr(model_type: str = "nano", quantization: str = "q4",
                device: torch.device | str = "cuda"):
        from tpu_audio_torch.api.stt_funasr import FunASREngine

        return FunASREngine(model_type, quantization, device)

    funasr = fun_asr  # the name the port first gave it
