"""Public STT API: the engine contract and the factories (port of
tpu_audio/api/stt.py: STTEngineBase, WhisperEngine, STT.whisper, and
STT.fun_asr as `STT.funasr`).

`STT.whisper(...)` returns an engine with load / transcribe / translate /
detect_language / transcribe_batch / warmup / stop / unload / cleanup and
the is_transcribing / transcription_time state; `STT.funasr(...)` the
Fun-ASR engine (`api/stt_funasr.py`: transcribe / translate /
transcribe_streaming). Loading checkpoints (`load()`: the model matrix,
the safetensors remap, tokenizer.json) and audio files are not ported yet
(ROADMAP A7, A10): build an engine with `WhisperEngine.from_pipeline` or
`FunASREngine.from_params` and pass sample arrays.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np

from tpu_audio_torch.api.results import TranscriptionResult

_log = logging.getLogger("tpu_audio_torch.stt")


class STTEngineBase:
    """Lifecycle and state shared by STT engines."""

    sample_rate: int = 16000

    def __init__(self):
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
        """A float array at self.sample_rate; file paths are not ported."""
        if isinstance(audio, str):
            raise NotImplementedError(
                "reading audio files (utils/audio_io) is not ported yet "
                "(ROADMAP A7): pass the samples as an array")
        return np.asarray(audio, np.float32)


class WhisperEngine(STTEngineBase):
    """Whisper STT engine over a `models.whisper.pipeline.WhisperPipeline`."""

    def __init__(self, model: str = "tiny", quantization: str = "fp16",
                 repo: str | None = None):
        super().__init__()
        self.model_name = model
        self.quantization = quantization
        self.repo = repo
        self.pipeline = None

    def load(self, progress_handler=None) -> None:
        if self.is_loaded:
            return
        raise NotImplementedError(
            "loading Whisper checkpoints (models/whisper/load.py) is not ported "
            "yet (ROADMAP A7): use WhisperEngine.from_pipeline")

    @classmethod
    def from_pipeline(cls, pipeline) -> "WhisperEngine":
        """An engine around an existing pipeline (random weights, tests)."""
        eng = cls()
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
                repo: str | None = None) -> WhisperEngine:
        return WhisperEngine(model, quantization, repo)

    @staticmethod
    def funasr(model_type: str = "nano", quantization: str = "q4"):
        from tpu_audio_torch.api.stt_funasr import FunASREngine

        return FunASREngine(model_type, quantization)
