"""Playback controller and streaming sinks (port of
tpu_audio/api/playback.py: RingBufferSink, FileSink, NullSink,
PlayerSink, default_sink, PlaybackController).

A sink takes the engine's AudioChunks as they stream: into the SPSC ring
for a reader of the caller's (`RingBufferSink`, with backpressure), a
progressive WAV (`FileSink`), an `AudioSamplePlayer` (`PlayerSink`), or
nowhere (`NullSink`). `PlaybackController.play_stream` runs one
generation into a sink and times the first audio.
"""

from __future__ import annotations

import time

import numpy as np

from tpu_audio_torch.api.results import AudioResult
from tpu_audio_torch.api.tts import AudioChunk, GenerationStopped, TTSGenerationResult
from tpu_audio_torch.utils import constants
from tpu_audio_torch.utils.logging import get_logger

_log = get_logger("audio")


class RingBufferSink:
    """Streams 30 ms slices, boosted 1.25× and clipped at 0.98, into the
    SPSC ring for the caller's reader (`read`). A full ring blocks `write`
    until the reader takes samples: give it a reader."""

    def __init__(self, sample_rate: int, capacity_seconds: float = 30.0):
        from tpu_audio_torch.native import RingBuffer

        self.sample_rate = sample_rate
        self.slice_size = int(sample_rate * 0.030)
        self.ring = RingBuffer(int(sample_rate * capacity_seconds))
        self.total_written = 0

    def write(self, chunk: AudioChunk) -> None:
        samples = np.clip(chunk.samples * constants.VOLUME_BOOST_FACTOR,
                          -constants.MAX_SAMPLE_VALUE,
                          constants.MAX_SAMPLE_VALUE).astype(np.float32)
        for i in range(0, len(samples), self.slice_size):
            piece = samples[i: i + self.slice_size]
            written = 0
            while written < len(piece):
                written += self.ring.write(piece[written:])
                if written < len(piece):
                    time.sleep(0.005)  # backpressure: the reader drains
        self.total_written += len(samples)

    def read(self, n: int) -> np.ndarray:
        return self.ring.read(n)

    def close(self) -> None:
        pass


class FileSink:
    """Streams chunks to a WAV on disk (`utils/audio_io.StreamingWavWriter`:
    the header's sizes patched on close)."""

    def __init__(self, path: str, sample_rate: int, dtype: str = "int16"):
        from tpu_audio_torch.utils.audio_io import StreamingWavWriter

        self.path = path
        self.sample_rate = sample_rate
        self._writer = StreamingWavWriter(path, sample_rate, dtype=dtype)

    def write(self, chunk: AudioChunk) -> None:
        self._writer.write(np.asarray(chunk.samples, np.float32))

    def close(self) -> str:
        return self._writer.close()


class NullSink:
    def write(self, chunk: AudioChunk) -> None:
        pass

    def close(self) -> None:
        pass


class PlayerSink:
    """Streams chunks into an AudioSamplePlayer (a device, the headless
    clock or the null output) with a prebuffer on start; close() waits
    until the player has drained."""

    def __init__(self, sample_rate: int, player=None, prebuffer_seconds: float = 0.25,
                 backend: str | None = None, time_scale: float = 1.0):
        from tpu_audio_torch.api.player import AudioSamplePlayer

        self._own = player is None
        self.player = player or AudioSamplePlayer(sample_rate, backend=backend,
                                                  time_scale=time_scale)
        self.prebuffer_seconds = prebuffer_seconds

    def write(self, chunk: AudioChunk) -> None:
        self.player.enqueue(chunk.samples, prebuffer_seconds=self.prebuffer_seconds)

    def close(self) -> None:
        self.player.await_drain()
        if self._own:
            self.player.close()


def default_sink(sample_rate: int):
    """The sink of `say()` without one: a PlayerSink on the sound device
    when an output device exists; otherwise a PlayerSink on the "null"
    output, whose consumer takes every sample as it arrives, so `say()`
    never waits on a reader that does not exist. (The JAX package returns
    a RingBufferSink there, which nothing reads: its writes block once 30 s
    of audio are queued, ROADMAP C28.) A RingBufferSink the caller passes
    keeps its backpressure for the caller's reader."""
    try:
        import sounddevice

        if sounddevice.query_devices(kind="output") is not None:
            return PlayerSink(sample_rate, backend="sounddevice")
    except Exception:
        pass
    return PlayerSink(sample_rate, backend="null")


class PlaybackController:
    """Owns one generation: runs the engine's stream, fans the chunks into
    a sink, records the time to the first audio, and stops on stop()."""

    def __init__(self, engine):
        self.engine = engine
        self.time_to_first_audio: float | None = None

    def play_stream(self, text: str, sink=None, **kw) -> TTSGenerationResult:
        sink = sink or default_sink(self.engine.sample_rate)
        engine = self.engine
        engine._stop_flag.clear()
        engine.is_generating = True
        engine.is_playing = True
        parts: list[np.ndarray] = []
        t0 = time.perf_counter()
        n_chunks = 0
        try:
            for chunk in engine.generate_streaming(text, **kw):
                if self.time_to_first_audio is None:
                    self.time_to_first_audio = time.perf_counter() - t0
                sink.write(chunk)
                parts.append(np.asarray(chunk.samples, np.float32))
                n_chunks += 1
        except GenerationStopped:
            _log.info("generation stopped by user")
        finally:
            engine.is_generating = False
            sink.close()  # a PlayerSink blocks here until playback drains
            engine.is_playing = False
        gen_time = time.perf_counter() - t0
        engine.generation_time = gen_time
        samples = np.concatenate(parts) if parts else np.zeros(0, np.float32)
        return TTSGenerationResult(
            audio=AudioResult(samples=samples, sample_rate=engine.sample_rate,
                              processing_time=gen_time),
            chunks=n_chunks, generation_time=gen_time)

    def collect_stream(self, text: str, **kw) -> AudioResult:
        return self.engine.generate(text, **kw)

    def stop(self) -> None:
        self.engine.stop()
