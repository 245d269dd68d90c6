"""Public TTS API (port of tpu_audio/api/tts.py: StreamingGranularity,
AudioChunk, TTSGenerationResult, TTSEngineBase, GenerationStopped, TTS).

Engines expose load / generate / generate_streaming / stop / unload /
cleanup with is_loaded / is_generating / generation_time state.
generate, generate_streaming and warmup are serialised per engine by a
lock (held for the whole life of a stream); stop() is lock-free and
cancels the generation in flight, and a new stream starts afresh.

Ported engines: Orpheus (`models/orpheus/`), OuteTTS (`models/outetts/`,
with DAC), Marvis (`models/marvis/`, with Mimi), CosyVoice2
(`models/cosyvoice2/`, with S3Gen and the S3 tokenizer), CosyVoice3
(`models/cosyvoice3/`, the DiT flow), Chatterbox (`models/chatterbox/`,
the T3 Llama with CFG and the voice encoder) and Chatterbox Turbo
(`models/chatterbox_turbo/`, the GPT-2 T3 and the meanflow flow) and
Kokoro (`models/kokoro/`, ALBERT, the predictors and the iSTFT-NSF
generator). `say` streams into a playback sink (`api/playback.py`).
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Iterator

import numpy as np

from tpu_audio_torch.api.results import AudioResult
from tpu_audio_torch.utils.logging import log_rtf


class StreamingGranularity(str, Enum):
    """How much audio each streamed chunk covers: a sentence, a codec
    frame, or an LM token span."""

    SENTENCE = "sentence"
    FRAME = "frame"
    TOKEN = "token"


@dataclass
class AudioChunk:
    samples: np.ndarray
    sample_rate: int
    text: str | None = None  # the text this chunk realises
    is_final: bool = False

    @property
    def duration(self) -> float:
        return len(self.samples) / self.sample_rate


@dataclass
class TTSGenerationResult:
    audio: AudioResult
    chunks: int = 1
    generation_time: float = 0.0

    @property
    def rtf(self) -> float:
        d = self.audio.duration
        return self.generation_time / d if d > 0 else float("inf")


class GenerationStopped(Exception):
    pass


class TTSEngineBase:
    """Lifecycle and streaming surface shared by the TTS engines."""

    sample_rate: int = 24000
    supported_streaming_granularities = (StreamingGranularity.SENTENCE,)
    default_streaming_granularity = StreamingGranularity.SENTENCE
    WARMUP_TEXTS = {"short": "Hi."}
    WARMUP_TEXTS_FULL = {
        "medium": "This is a medium length warm up sentence for the compiler cache.",
        "long": "This considerably longer warm up paragraph exists to reach the larger "
                "prompt-length buckets that production requests will hit, so that the first "
                "real request of every size finds its kernels built and its caches filled. " * 3,
    }

    def __init__(self):
        self.is_loaded = False
        self.is_generating = False
        self.is_playing = False
        self.generation_time = 0.0
        self._stop_flag = threading.Event()
        self._gen_lock = threading.Lock()

    def __init_subclass__(cls, **kw):
        """Hold the engine's lock around each subclass's generate_streaming,
        from the first next() until the generator closes; a new stream
        clears a stop() left from the previous one."""
        super().__init_subclass__(**kw)
        if "generate_streaming" in cls.__dict__:
            inner = cls.__dict__["generate_streaming"]

            @functools.wraps(inner)
            def locked(self, *a, **k):
                with self._gen_lock:
                    self._stop_flag.clear()
                    yield from inner(self, *a, **k)

            cls.generate_streaming = locked

    def load(self, progress_handler=None) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        self._stop_flag.set()

    def unload(self) -> None:
        self.is_loaded = False

    def cleanup(self) -> None:
        self.unload()

    def warmup(self, full: bool = False) -> dict[str, float]:
        """Synthesise the warm-up texts once (shortest first), which builds
        the kernels; returns {variant: seconds}."""
        texts = dict(self.WARMUP_TEXTS)
        if full:
            texts.update(self.WARMUP_TEXTS_FULL)
        timings = {}
        for name, text in texts.items():
            t0 = time.perf_counter()
            self.generate(text)
            timings[name] = time.perf_counter() - t0
        return timings

    def generate_streaming(self, text: str, granularity: StreamingGranularity | None = None,
                           **kw) -> Iterator[AudioChunk]:
        raise NotImplementedError

    def generate(self, text: str, **kw) -> AudioResult:
        """Collect the stream into one AudioResult."""
        self._stop_flag.clear()
        self.is_generating = True
        t0 = time.perf_counter()
        try:
            parts = [c.samples for c in self.generate_streaming(text, **kw)]
        finally:
            self.is_generating = False
        self.generation_time = time.perf_counter() - t0
        samples = np.concatenate(parts) if parts else np.zeros(0, np.float32)
        result = AudioResult(samples=samples, sample_rate=self.sample_rate,
                             processing_time=self.generation_time)
        log_rtf(f"{type(self).__name__}.generate", self.generation_time, result.duration)
        return result

    def say(self, text: str, sink=None, **kw) -> TTSGenerationResult:
        """Generate and stream into a playback sink (`api/playback.py`;
        None: `default_sink`, the sound device or, without one, the null
        output)."""
        from tpu_audio_torch.api.playback import PlaybackController

        return PlaybackController(self).play_stream(text, sink=sink, **kw)

    def save(self, text: str, path: str, **kw) -> str:
        return self.generate(text, **kw).save(path)

    def _check_stopped(self):
        if self._stop_flag.is_set():
            raise GenerationStopped()


class TTS:
    """Factory namespace."""

    @staticmethod
    def orpheus(voice: str = "tara", mesh=None, quantization: str = "w8a8",
                speculative=None, gamma: int = 8, device="cuda"):
        """quantization: how `load()` serves the 4-bit checkpoint ("w8a8",
        "w4a8" or "q4", `OrpheusEngine`); speculative: None, "ngram" or a
        `DraftModel`, gamma drafts a target pass; mesh: a
        `parallel.make_mesh` DeviceMesh with a "tp" axis, for
        tensor-parallel serving of the LM; device: the card unless the
        caller asks for the CPU."""
        from tpu_audio_torch.models.orpheus.engine import OrpheusEngine

        return OrpheusEngine(voice=voice, mesh=mesh, quantization=quantization,
                             speculative=speculative, gamma=gamma, device=device)

    @staticmethod
    def kokoro(voice: str = "af_heart", device="cuda"):
        """voice: one of `models/kokoro/voices.VOICES`; device: the card
        unless the caller asks for the CPU. For `load()`:
        `KokoroEngine.from_params` is a classmethod that builds its own
        engine on its tree's device."""
        from tpu_audio_torch.models.kokoro.engine import KokoroEngine

        return KokoroEngine(voice=voice, device=device)

    @staticmethod
    def marvis(quality: str = "high", device="cuda"):
        """quality: codebooks a frame ("low" 8, "medium" 16, "high" 24,
        "max" 32); device: the card unless the caller asks for the CPU.
        For `load()`: `MarvisEngine.from_params` is a classmethod that
        builds its own engine and ignores both arguments."""
        from tpu_audio_torch.models.marvis.engine import MarvisEngine

        return MarvisEngine(quality=quality, device=device)

    @staticmethod
    def oute(speculative=None, gamma: int = 8, device="cuda"):
        """speculative: None, "ngram" or a `DraftModel`, gamma drafts a
        target pass; device: the card unless the caller asks for the CPU.
        For `load()`: `OuteTTSEngine.from_params` is a classmethod that
        builds its own engine and takes its own `speculative=`."""
        from tpu_audio_torch.models.outetts.engine import OuteTTSEngine

        return OuteTTSEngine(speculative=speculative, gamma=gamma, device=device)

    @staticmethod
    def chatterbox(variant: str = "fp16", device="cuda"):
        """variant: the checkpoint `load()` reads ("fp16", "8bit" or "4bit":
        T3 served as stored, the quantised linears through `quant_matmul`);
        device: the card unless the caller asks for the CPU. For `load()`:
        `ChatterboxEngine.from_params` is a classmethod that builds its own
        engine on its trees' device."""
        from tpu_audio_torch.models.chatterbox.engine import ChatterboxEngine

        return ChatterboxEngine(variant=variant, device=device)

    @staticmethod
    def chatterbox_turbo(variant: str = "fp16", device="cuda"):
        """variant: the checkpoint `load()` reads ("fp16", "8bit" or
        "4bit"); device: the card unless the caller asks for the CPU. For
        `load()`: `ChatterboxTurboEngine.from_turbo_params` is a classmethod
        that builds its own engine on its trees' device."""
        from tpu_audio_torch.models.chatterbox_turbo.engine import ChatterboxTurboEngine

        return ChatterboxTurboEngine(variant=variant, device=device)

    @staticmethod
    def cosyvoice2(quantization: str = "w8a8", mesh=None, speculative=None,
                   device="cuda"):
        """quantization: how `load()` serves the 4-bit LM ("w8a8", "w4a8",
        "q4", or dequantised: "bf16", "fp16", "none"); speculative: None or
        "ngram" (prompt lookup in the LM, sentence and token streaming);
        mesh: a DeviceMesh with a "tp" axis, for tensor-parallel serving of
        the LM and the flow (an fp quantization only); device: the card
        unless the caller asks for the CPU. For `load()`:
        `CosyVoice2Engine.from_params` is a classmethod that builds its own
        engine on its trees' device."""
        from tpu_audio_torch.models.cosyvoice2.engine import CosyVoice2Engine

        return CosyVoice2Engine(quantization=quantization, mesh=mesh, speculative=speculative,
                                device=device)

    @staticmethod
    def cosyvoice3(quantization: str = "w8a8", speculative=None, device="cuda"):
        """quantization: how `load()` serves the 4-bit LM ("w8a8", "w4a8"
        or "q4"); speculative: None or "ngram"; device: the card unless the
        caller asks for the CPU. For `load()`: `CosyVoice3Engine.from_params`
        is a classmethod that builds its own engine on its trees' device."""
        from tpu_audio_torch.models.cosyvoice3.engine import CosyVoice3Engine

        return CosyVoice3Engine(quantization=quantization, speculative=speculative,
                                device=device)
