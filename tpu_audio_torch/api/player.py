"""Audio-device playback (port of tpu_audio/api/player.py:
AudioSamplePlayer, AudioFilePlayer and their "clock", "null" and
"sounddevice" outputs).

The queue is the SPSC `native.RingBuffer`; the consumer is pluggable:

  - "sounddevice": a PortAudio output stream whose callback pulls from the
    ring (when the optional `sounddevice` package and an output device
    exist; the package is imported only when probed);
  - "clock": a headless consumer thread that drains at real-time rate (or
    scaled for tests);
  - "null": drains as fast as it can.

The state machine (queued_sample_count / is_playing / prebuffer / drain)
is the same for every output. One re-entrant lock guards it and the ring:
`enqueue` counts a slice and writes it in the same critical section, the
count first, so a consumer never takes samples that are not counted yet
(the JAX player writes before it counts and can leave the count above an
empty ring, ROADMAP C2).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from tpu_audio_torch.native import RingBuffer
from tpu_audio_torch.utils import constants
from tpu_audio_torch.utils.logging import get_logger

_log = get_logger("audio")

SLICE_SECONDS = 0.030  # the enqueue slice


def _pick_backend(requested: str | None) -> str:
    if requested:
        return requested
    try:
        import sounddevice

        if sounddevice.query_devices(kind="output") is not None:
            return "sounddevice"
    except Exception:
        pass
    return "clock"


class _ThreadOutput:
    """A consumer thread calling pull(block) until stopped."""

    def __init__(self, sample_rate: int):
        self.sample_rate = sample_rate
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _run(self, pull) -> None:
        raise NotImplementedError

    def start(self, pull) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, args=(pull,), daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class _ClockOutput(_ThreadOutput):
    """Headless consumer: pulls at (scaled) real-time rate."""

    def __init__(self, sample_rate: int, time_scale: float = 1.0,
                 block_seconds: float = 0.010):
        super().__init__(sample_rate)
        self.time_scale = time_scale
        self.block = max(1, int(sample_rate * block_seconds))
        self.block_seconds = block_seconds

    def _run(self, pull) -> None:
        while not self._stop.is_set():
            pull(self.block)
            time.sleep(self.block_seconds * self.time_scale)


class _NullOutput(_ThreadOutput):
    """Drains everything immediately (no pacing)."""

    def _run(self, pull) -> None:
        while not self._stop.is_set():
            if pull(self.sample_rate) == 0:
                time.sleep(0.001)


class _SoundDeviceOutput:
    """PortAudio output stream; the audio callback pulls from the player."""

    def __init__(self, sample_rate: int):
        self.sample_rate = sample_rate
        self._stream = None

    def start(self, pull) -> None:
        import sounddevice

        def callback(outdata, frames, time_info, status):
            if status:
                _log.debug("sounddevice status: %s", status)
            got = pull(frames, out=outdata[:, 0])
            if got < frames:
                outdata[got:, 0] = 0.0

        self._stream = sounddevice.OutputStream(samplerate=self.sample_rate, channels=1,
                                                dtype="float32", callback=callback)
        self._stream.start()

    def stop(self) -> None:
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
            self._stream = None


_OUTPUTS = {"clock": _ClockOutput, "null": _NullOutput, "sounddevice": _SoundDeviceOutput}


def _make_output(backend: str, sample_rate: int, time_scale: float):
    cls = _OUTPUTS[backend]
    return cls(sample_rate, time_scale=time_scale) if cls is _ClockOutput else cls(sample_rate)


class AudioSamplePlayer:
    """Streaming sample player with prebuffer and drain.

    play() boosts 1.25× and clips at 0.98, then blocks until played;
    enqueue() queues 30 ms slices at unity gain and starts playback once
    `prebuffer_seconds` of audio is queued; stop() drops the queue and
    releases every drain waiter. `samples_played` counts what the output
    consumed."""

    def __init__(self, sample_rate: int = 24000, backend: str | None = None,
                 capacity_seconds: float = 120.0, time_scale: float = 1.0):
        self.sample_rate = sample_rate
        self.backend = _pick_backend(backend)
        self._ring = RingBuffer(int(sample_rate * capacity_seconds))
        self._lock = threading.RLock()
        self._drained = threading.Condition(self._lock)
        self.queued_sample_count = 0
        self.samples_played = 0
        self.is_playing = False
        self.has_started_playback = False
        self._consuming = False
        self._epoch = 0  # moved by stop(): an enqueue in flight gives up
        self._output = _make_output(self.backend, sample_rate, time_scale)
        self._output_started = False

    # ---------------------------------------------------------------- pull

    def _pull(self, n: int, out: np.ndarray | None = None) -> int:
        """Consumer callback: take up to n queued samples; returns the count."""
        with self._lock:
            if not self._consuming:
                if out is not None:
                    out[:] = 0.0
                return 0
            data = self._ring.read(n)
            got = len(data)
            self.queued_sample_count -= got
            self.samples_played += got
            if self.queued_sample_count == 0 and self.has_started_playback:
                self.is_playing = False
                self.has_started_playback = False
                self._consuming = False
                self._drained.notify_all()
        if out is not None and got:
            out[:got] = data
        return got

    def _ensure_output(self) -> None:
        if not self._output_started:
            self._output.start(self._pull)
            self._output_started = True

    # ---------------------------------------------------------------- API

    def enqueue(self, samples: np.ndarray, prebuffer_seconds: float = 0.0) -> None:
        """Queue samples for playback in 30 ms slices (unity gain). Blocks
        while the ring is full; returns early if stop() is called."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        if samples.size == 0:
            return
        self._ensure_output()
        slice_n = max(1, int(SLICE_SECONDS * self.sample_rate))
        # a prebuffer past the ring's capacity would never fill: a full ring starts
        prebuffer = min(int(prebuffer_seconds * self.sample_rate), self._ring.capacity)
        epoch = self._epoch
        for i in range(0, len(samples), slice_n):
            piece = samples[i: i + slice_n]
            written = 0
            while written < len(piece):
                with self._lock:
                    if epoch != self._epoch:
                        return
                    # the only writer: the room can only grow until the write
                    n = min(self._ring.capacity - self._ring.available, len(piece) - written)
                    self.queued_sample_count += n
                    self._ring.write(piece[written:written + n])
                    written += n
                    if not self.has_started_playback and self.queued_sample_count and (
                            prebuffer == 0 or self.queued_sample_count >= prebuffer):
                        self.has_started_playback = True
                        self.is_playing = True
                        self._consuming = True
                if written < len(piece):
                    time.sleep(0.005)  # backpressure: the consumer drains

    def play(self, samples: np.ndarray,
             volume_boost: float = constants.VOLUME_BOOST_FACTOR) -> None:
        """One-shot blocking playback with volume boost and clip."""
        samples = np.asarray(samples, np.float32)
        if samples.size == 0:
            return
        self.stop()
        boosted = np.clip(samples * volume_boost, -constants.MAX_SAMPLE_VALUE,
                          constants.MAX_SAMPLE_VALUE)
        self.enqueue(boosted)
        self.await_drain()

    def await_drain(self, timeout: float | None = None) -> bool:
        """Block until every enqueued sample has been consumed (or stop());
        False if `timeout` ran out first. Audio still held back by the
        prebuffer starts playing: nothing else would ever consume it (the
        JAX player waits for it forever)."""
        with self._lock:
            if self.queued_sample_count and not self.has_started_playback:
                self.has_started_playback = True
                self.is_playing = True
                self._consuming = True
            return self._drained.wait_for(
                lambda: self.queued_sample_count == 0 and not self.has_started_playback,
                timeout=timeout)

    def stop(self) -> None:
        """Stop playback, drop queued audio, release drain waiters."""
        with self._lock:
            self._epoch += 1
            self._consuming = False
            self._ring.read(self._ring.available)
            self.queued_sample_count = 0
            self.is_playing = False
            self.has_started_playback = False
            self._drained.notify_all()

    def close(self) -> None:
        self.stop()
        if self._output_started:
            self._output.stop()
            self._output_started = False


class AudioFilePlayer:
    """File playback with progress: load / play / pause / seek / stop,
    is_playing, current_time, duration. Reads the whole WAV into memory
    and feeds the same outputs as AudioSamplePlayer."""

    def __init__(self, backend: str | None = None, time_scale: float = 1.0):
        self._backend = _pick_backend(backend)
        self._time_scale = time_scale
        self._samples = np.zeros(0, np.float32)
        self.sample_rate = 24000
        self._pos = 0
        self._lock = threading.Lock()
        self.is_playing = False
        self.current_audio_path: str | None = None
        self._output = None

    @property
    def duration(self) -> float:
        return len(self._samples) / self.sample_rate

    @property
    def current_time(self) -> float:
        return self._pos / self.sample_rate

    def load(self, path: str) -> None:
        from tpu_audio_torch.utils.audio_io import read_wav

        self.stop()
        samples, self.sample_rate = read_wav(path)
        self._samples = np.asarray(samples, np.float32)
        self.current_audio_path = path
        self._pos = 0

    def _pull(self, n: int, out: np.ndarray | None = None) -> int:
        with self._lock:
            if not self.is_playing:
                if out is not None:
                    out[:] = 0.0
                return 0
            piece = self._samples[self._pos: self._pos + n]
            self._pos += len(piece)
            if self._pos >= len(self._samples):
                self.is_playing = False
        if out is not None and len(piece):
            out[:len(piece)] = piece
        return len(piece)

    def play(self) -> None:
        if self._output is None:
            self._output = _make_output(self._backend, self.sample_rate, self._time_scale)
            self._output.start(self._pull)
        with self._lock:
            if self._pos >= len(self._samples):
                self._pos = 0
            self.is_playing = True

    def pause(self) -> None:
        with self._lock:
            self.is_playing = False

    def toggle_play_pause(self) -> None:
        self.pause() if self.is_playing else self.play()

    def seek(self, seconds: float) -> None:
        with self._lock:
            self._pos = int(np.clip(seconds, 0, self.duration) * self.sample_rate)

    def stop(self) -> None:
        with self._lock:
            self.is_playing = False
            self._pos = 0
        if self._output is not None:
            self._output.stop()
            self._output = None
