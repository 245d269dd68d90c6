"""Audio capture (port of tpu_audio/utils/recorder.py: AudioRecorder).

Sources are a live input device (sounddevice / PortAudio, the input side
of api/player.py's output), a file, a raw PCM stream (e.g. piped from
arecord or ffmpeg), or pushed NumPy blocks, resampled to the target rate.
Consumers pull fixed-size chunks for streaming ASR. On a host without an
input device live capture raises; the other sources remain.
"""

from __future__ import annotations

import sys
import threading

import numpy as np

from tpu_audio_torch.ops.resample import resample
from tpu_audio_torch.utils.audio_io import read_wav, to_mono


class AudioRecorder:
    def __init__(self, target_rate: int = 16000):
        self.target_rate = target_rate
        self._buffer = np.zeros(0, np.float32)

    # -------------------------------------------------------------- sources

    def push(self, samples: np.ndarray, sample_rate: int | None = None) -> None:
        x = np.asarray(samples, np.float32)
        if sample_rate and sample_rate != self.target_rate:
            x = resample(x, sample_rate, self.target_rate)
        self._buffer = np.concatenate([self._buffer, x])

    def load_file(self, path: str) -> None:
        x, rate = read_wav(path)
        self.push(to_mono(x), rate)

    def read_raw_stream(self, stream=None, sample_rate: int = 16000,
                        dtype: str = "int16", chunk_bytes: int = 32000):
        """Generator over a raw PCM stream (default stdin)."""
        stream = stream or sys.stdin.buffer
        scale = 32768.0 if dtype == "int16" else 1.0
        np_dtype = "<i2" if dtype == "int16" else "<f4"
        while True:
            raw = stream.read(chunk_bytes)
            if not raw:
                break
            x = np.frombuffer(raw, dtype=np_dtype).astype(np.float32) / scale
            self.push(x, sample_rate)
            yield x

    # ------------------------------------------------------------- live mic

    @staticmethod
    def input_available() -> bool:
        """True when a PortAudio input device exists (the symmetric check
        to api/player._pick_backend's output probe)."""
        try:
            import sounddevice

            return sounddevice.query_devices(kind="input") is not None
        except Exception:
            return False

    def record_stream(self, chunk_seconds: float = 0.5, device=None,
                      stop_event: "threading.Event | None" = None):
        """Generator over live microphone chunks at self.target_rate.

        Opens a sounddevice.InputStream whose callback feeds an internal
        queue; each yielded block is also push()ed into the buffer so
        pull()/drain() see the full recording. Ends when stop_event is
        set (or the generator is closed). Raises RuntimeError when no
        input device is available (headless host) — use push()/
        read_raw_stream() there instead."""
        try:
            import sounddevice
        except Exception as exc:  # pragma: no cover - env without portaudio
            raise RuntimeError(
                "live capture needs the sounddevice package and an input "
                f"device ({exc}); push blocks or pipe raw PCM instead"
            ) from exc
        if sounddevice.query_devices(kind="input") is None:
            raise RuntimeError("no audio input device available")

        import queue

        q: "queue.Queue[np.ndarray]" = queue.Queue()
        block = max(1, int(chunk_seconds * self.target_rate))

        def callback(indata, frames, time_info, status):
            q.put(np.array(indata[:, 0], np.float32))

        stream = sounddevice.InputStream(
            samplerate=self.target_rate, channels=1, dtype="float32",
            blocksize=block, device=device, callback=callback)
        stream.start()
        try:
            while stop_event is None or not stop_event.is_set():
                try:
                    x = q.get(timeout=0.25)
                except queue.Empty:
                    continue
                self.push(x)
                yield x
        finally:
            stream.stop()
            stream.close()

    # -------------------------------------------------------------- consume

    @property
    def duration(self) -> float:
        return len(self._buffer) / self.target_rate

    def pull(self, seconds: float) -> np.ndarray | None:
        """Take the next chunk of audio, or None if not enough buffered."""
        n = int(seconds * self.target_rate)
        if len(self._buffer) < n:
            return None
        out, self._buffer = self._buffer[:n], self._buffer[n:]
        return out

    def drain(self) -> np.ndarray:
        out, self._buffer = self._buffer, np.zeros(0, np.float32)
        return out
