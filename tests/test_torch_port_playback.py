"""PyTorch port, the playback layer and the runtime utilities against the
JAX package on the CPU: the player (tests/test_player.py's cases on the
port), the sinks and `say`, providers and languages, the trimmer, the
recorder, `native`'s NumPy versions and SPSC ring, the profiler, memory,
logging and the package's lazy exports.

ROADMAP C2 (the JAX player counts a slice after writing it) and C28
(`say()` on a host without an output device blocks in the JAX package's
default sink) are forced on both packages. Trimmer outputs equal the JAX
functions' on seeded inputs; the recorder's resampled buffer is within
1e-6 of JAX's (the two resamplers' sums are ordered alike in NumPy).
"""

import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401
from tpu_audio.api import player as jplayer
from tpu_audio.api import playback as jplayback
from tpu_audio.api import tts as jtts
from tpu_audio.api.results import Word as JWord
from tpu_audio.ops.resample import resample as jresample
from tpu_audio.utils import trimmer as jtrimmer
from tpu_audio.utils.recorder import AudioRecorder as JRecorder
from tpu_audio_torch import native
from tpu_audio_torch.api import playback, player
from tpu_audio_torch.api.player import AudioFilePlayer, AudioSamplePlayer
from tpu_audio_torch.api.results import Word
from tpu_audio_torch.api.tts import (AudioChunk, GenerationStopped, StreamingGranularity,
                                     TTSEngineBase)
from tpu_audio_torch.utils import constants, memory, trimmer
from tpu_audio_torch.utils import logging as tlogging
from tpu_audio_torch.utils.profiling import Profiler, device_trace
from tpu_audio_torch.utils.recorder import AudioRecorder


def make_player(**kw):
    kw.setdefault("backend", "clock")
    kw.setdefault("time_scale", 0.0)
    return AudioSamplePlayer(sample_rate=16000, **kw)


def wait_until(pred, timeout=5.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.002)
    return False


def fake_engine(base, chunk, n=3, sr=16000):
    """A TTS engine of `base` (either package's TTSEngineBase) streaming n
    chunks of `chunk` samples."""

    class FakeEngine(base):
        sample_rate = sr

        def load(self, progress_handler=None):
            self.is_loaded = True

        def generate_streaming(self, text, granularity=None, **kw):
            for i in range(n):
                yield type(self).chunk_cls(samples=np.full(chunk, 0.1, np.float32),
                                           sample_rate=sr, text=text, is_final=i == n - 1)

    FakeEngine.chunk_cls = AudioChunk if base is TTSEngineBase else jtts.AudioChunk
    return FakeEngine()


# ------------------------------------------------------------------ player

class TestEnqueueDrain:
    def test_enqueue_starts_and_drains(self):
        p = make_player()
        try:
            p.enqueue(np.ones(1600, np.float32) * 0.1)
            assert p.await_drain(timeout=5.0)
            assert p.queued_sample_count == 0 and p.samples_played == 1600
            assert not p.is_playing
        finally:
            p.close()

    def test_prebuffer_gates_start(self):
        p = make_player()
        try:
            p.enqueue(np.ones(1600, np.float32) * 0.1, prebuffer_seconds=0.2)
            time.sleep(0.05)
            assert not p.has_started_playback
            assert p.queued_sample_count == 1600
            p.enqueue(np.ones(1600, np.float32) * 0.1, prebuffer_seconds=0.2)
            assert wait_until(lambda: p.queued_sample_count == 0)
        finally:
            p.close()

    def test_drain_plays_what_the_prebuffer_holds_back(self):
        """await_drain starts audio still under the prebuffer; the JAX player
        waits for it until the timeout."""
        p = make_player()
        jp = jplayer.AudioSamplePlayer(sample_rate=16000, backend="clock", time_scale=0.0)
        try:
            for q in (p, jp):
                q.enqueue(np.ones(1600, np.float32) * 0.1, prebuffer_seconds=0.2)
            assert p.await_drain(timeout=5.0) and p.samples_played == 1600
            jp.await_drain(timeout=0.3)
            assert jp.queued_sample_count == 1600
        finally:
            p.close()
            jp.close()

    def test_queued_count_decrements(self):
        p = make_player()
        try:
            p.enqueue(np.ones(8000, np.float32) * 0.1)
            assert wait_until(lambda: p.queued_sample_count == 0)
            p.await_drain(timeout=5.0)
            assert not p.is_playing
        finally:
            p.close()


class TestStop:
    def test_stop_releases_drain_waiters(self):
        p = make_player(time_scale=1.0)
        try:
            p.enqueue(np.ones(16000, np.float32) * 0.1)
            released = threading.Event()

            def waiter():
                p.await_drain(timeout=10.0)
                released.set()

            t = threading.Thread(target=waiter, daemon=True)
            t.start()
            time.sleep(0.05)
            assert not released.is_set()
            p.stop()
            assert released.wait(timeout=2.0)
            assert p.queued_sample_count == 0 and not p.is_playing
        finally:
            p.close()

    def test_enqueue_after_stop_restarts(self):
        p = make_player()
        try:
            p.enqueue(np.ones(800, np.float32) * 0.1)
            p.stop()
            p.enqueue(np.ones(800, np.float32) * 0.1)
            assert p.await_drain(timeout=5.0)
            assert p.queued_sample_count == 0
        finally:
            p.close()

    def test_stop_ends_an_enqueue_blocked_on_a_full_ring(self):
        p = make_player(time_scale=1.0, capacity_seconds=0.05)
        try:
            t = threading.Thread(target=p.enqueue, args=(np.ones(16000, np.float32),),
                                 daemon=True)
            t.start()
            time.sleep(0.1)
            assert t.is_alive()
            p.stop()
            t.join(timeout=2.0)
            assert not t.is_alive() and p.queued_sample_count == 0
        finally:
            p.close()


class TestPlay:
    def test_play_blocks_until_done(self):
        p = make_player()
        try:
            t0 = time.time()
            p.play(np.ones(1600, np.float32) * 0.5)
            assert p.queued_sample_count == 0 and not p.is_playing
            assert time.time() - t0 < 5.0
        finally:
            p.close()

    def test_play_boosts_and_clips_as_the_jax_player(self):
        """What a device callback receives, against the JAX player's."""
        x = np.random.default_rng(0).uniform(-1, 1, 4000).astype(np.float32)
        got = {}
        for name, cls in (("port", AudioSamplePlayer), ("jax", jplayer.AudioSamplePlayer)):
            out = []
            p = cls(sample_rate=16000, backend="null")

            def pull(n, _p=p, _out=out):
                buf = np.zeros(n, np.float32)
                k = _p._pull(n, out=buf)
                if k:
                    _out.append(buf[:k].copy())
                return k

            p._output.start = lambda _pull, _o=p._output, _f=pull: type(_o).start(_o, _f)
            try:
                p.play(x)
            finally:
                p.close()
            got[name] = np.concatenate(out)
        np.testing.assert_array_equal(got["port"], got["jax"])
        np.testing.assert_array_equal(
            got["port"], np.clip(x * constants.VOLUME_BOOST_FACTOR, -0.98, 0.98))

    def test_play_empty_is_noop(self):
        p = make_player()
        try:
            p.play(np.zeros(0, np.float32))
            assert not p.is_playing
        finally:
            p.close()


class TestBackendSelection:
    def test_clock_fallback_headless(self):
        p = AudioSamplePlayer(sample_rate=16000, time_scale=0.0)
        assert p.backend == jplayer._pick_backend(None) == "clock"
        p.close()

    def test_null_backend_drains(self):
        p = AudioSamplePlayer(sample_rate=16000, backend="null")
        try:
            p.enqueue(np.ones(16000, np.float32) * 0.1)
            assert p.await_drain(timeout=5.0)
            assert p.queued_sample_count == 0 and p.samples_played == 16000
        finally:
            p.close()


class RacingRing:
    """A ring whose write lets the consumer pull everything just written
    before it returns: the interleaving of ROADMAP C2."""

    def __init__(self, inner, player):
        self.inner, self.player = inner, player

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def write(self, data):
        n = self.inner.write(data)
        self.player._pull(self.inner.available)
        return n


def test_c2_a_pull_between_write_and_count():
    """The JAX player counts a slice after writing it: the pull takes the
    samples before they are counted, the count floors at 0, and the slice's
    count outlives its samples, so the drain never comes. The port counts
    first, in the same critical section."""
    x = np.ones(4800, np.float32) * 0.1
    jp = jplayer.AudioSamplePlayer(sample_rate=16000, backend="clock", time_scale=20.0)
    p = AudioSamplePlayer(sample_rate=16000, backend="clock", time_scale=20.0)
    try:
        for q in (jp, p):
            q._ensure_output()
            time.sleep(0.02)  # the clock output's first pull, then 0.2 s sleeps
            q._ring = RacingRing(q._ring, q)
            q.enqueue(x)
        jp.await_drain(timeout=0.3)
        assert jp.queued_sample_count > 0 and jp._ring.available == 0
        assert p.await_drain(timeout=2.0)
        assert p.queued_sample_count == 0 and p.samples_played == len(x)
    finally:
        jp.close()
        p.close()


# ------------------------------------------------------------------ sinks and say

class TestSinks:
    def test_say_through_player_sink(self):
        eng = fake_engine(TTSEngineBase, 800)
        p = make_player()
        sink = playback.PlayerSink(16000, player=p, prebuffer_seconds=0.0)
        res = eng.say("hi", sink=sink)
        assert res.audio.samples.shape == (2400,) and res.chunks == 3
        assert p.queued_sample_count == 0 and p.samples_played == 2400
        assert not eng.is_playing
        p.close()

    def test_ring_buffer_sink_against_jax(self):
        data = np.random.default_rng(0).standard_normal(8000).astype(np.float32) * 0.5
        out = {}
        for name, sink, chunk in (("port", playback.RingBufferSink(16000, 2.0), AudioChunk),
                                  ("jax", jplayback.RingBufferSink(16000, 2.0), jtts.AudioChunk)):
            parts = []

            def consume(_sink=sink, _parts=parts):
                got = 0
                while got < len(data):
                    piece = _sink.read(1024)
                    got += len(piece)
                    _parts.append(piece)

            t = threading.Thread(target=consume)
            t.start()
            sink.write(chunk(samples=data, sample_rate=16000))
            t.join(timeout=5)
            out[name] = np.concatenate(parts)
        np.testing.assert_array_equal(out["port"], out["jax"])
        np.testing.assert_allclose(out["port"], np.clip(data * 1.25, -0.98, 0.98), atol=1e-6)

    def test_file_sink(self, tmp_path):
        from tpu_audio_torch.utils.audio_io import read_wav

        sink = playback.FileSink(str(tmp_path / "o.wav"), 24000)
        x = np.random.default_rng(2).uniform(-1, 1, 2400).astype(np.float32)
        sink.write(AudioChunk(samples=x, sample_rate=24000))
        y, sr = read_wav(sink.close())
        assert sr == 24000 and len(y) == 2400
        np.testing.assert_array_equal(y, (x * 32767).astype(np.int16) / np.float32(32768))

    def test_null_sink(self):
        res = fake_engine(TTSEngineBase, 160).say("x", sink=playback.NullSink())
        assert res.audio.samples.shape == (480,)


def test_c28_say_on_a_host_without_an_output_device(monkeypatch):
    """The JAX default sink is a RingBufferSink nothing reads: with its ring
    shrunk to 0.1 s, say() of 0.5 s blocks until a reader appears. The
    port's default sink plays into the null output and returns, its
    player's ring shrunk too."""
    sinks = []
    init = jplayback.RingBufferSink.__init__

    def small(self, sample_rate, capacity_seconds=0.1):
        init(self, sample_rate, capacity_seconds)
        sinks.append(self)

    monkeypatch.setattr(jplayback.RingBufferSink, "__init__", small)
    eng = fake_engine(jtts.TTSEngineBase, 3200, n=2)
    t = threading.Thread(target=eng.say, args=("x",), daemon=True)
    t.start()
    time.sleep(1.0)
    assert t.is_alive() and len(sinks) == 1  # blocked on the full ring
    while t.is_alive():  # a reader appears: the JAX say() ends
        sinks[0].read(1600)
        time.sleep(0.001)

    pinit = AudioSamplePlayer.__init__

    def small_player(self, sample_rate=24000, backend=None, capacity_seconds=0.1,
                     time_scale=1.0):
        pinit(self, sample_rate, backend, capacity_seconds, time_scale)
        sinks.append(self)

    monkeypatch.setattr(AudioSamplePlayer, "__init__", small_player)
    sink = playback.default_sink(16000)
    assert isinstance(sink, playback.PlayerSink) and sink.player.backend == "null"
    t0 = time.perf_counter()
    res = fake_engine(TTSEngineBase, 3200, n=2, sr=16000).say("x")
    assert time.perf_counter() - t0 < 5.0
    assert res.audio.samples.shape == (6400,) and sinks[-1].samples_played == 6400


class TestEngineSerialization:
    def _engine(self):
        class SlowEngine(TTSEngineBase):
            sample_rate = 16000

            def load(self, progress_handler=None):
                self.is_loaded = True

            def generate_streaming(self, text, granularity=None, **kw):
                for i in range(4):
                    self._check_stopped()
                    time.sleep(0.03)
                    yield AudioChunk(samples=np.ones(160, np.float32), sample_rate=16000,
                                     text=text, is_final=i == 3)

        return SlowEngine()

    def test_concurrent_generations_serialize(self):
        eng = self._engine()
        order = []

        def run(tag):
            for _ in eng.generate_streaming(tag):
                order.append(tag)

        t1 = threading.Thread(target=run, args=("a",))
        t2 = threading.Thread(target=run, args=("b",))
        t1.start()
        time.sleep(0.01)
        t2.start()
        t1.join(5)
        t2.join(5)
        a_last = max(i for i, t in enumerate(order) if t == order[0])
        b_first = min(i for i, t in enumerate(order) if t != order[0])
        assert a_last < b_first

    def test_stop_mid_say(self):
        eng = self._engine()
        out = {}
        t = threading.Thread(target=lambda: out.update(r=eng.say("x", sink=playback.NullSink())))
        t.start()
        time.sleep(0.04)
        eng.stop()
        t.join(5)
        assert 0 < out["r"].chunks < 4 and not eng.is_playing and not eng.is_generating
        with pytest.raises(GenerationStopped):
            eng.stop()
            eng._check_stopped()


class TestAudioFilePlayer:
    def _wav(self, tmp_path):
        from tpu_audio_torch.utils.audio_io import write_wav

        path = str(tmp_path / "clip.wav")
        write_wav(path, np.ones(16000, np.float32) * 0.1, 16000)
        return path

    def test_load_play_to_end(self, tmp_path):
        p = AudioFilePlayer(backend="clock", time_scale=0.0)
        p.load(self._wav(tmp_path))
        assert p.duration == pytest.approx(1.0, abs=0.01)
        p.play()
        assert wait_until(lambda: not p.is_playing)
        assert p.current_time == pytest.approx(p.duration, abs=0.05)
        p.stop()
        assert p.current_time == 0.0

    def test_pause_resume_and_seek(self, tmp_path):
        p = AudioFilePlayer(backend="clock", time_scale=1.0)
        p.load(self._wav(tmp_path))
        p.play()
        time.sleep(0.08)
        p.pause()
        t1 = p.current_time
        assert 0 < t1 < 1.0
        time.sleep(0.05)
        assert p.current_time == t1
        p.seek(0.5)
        assert p.current_time == pytest.approx(0.5, abs=0.01)
        p.toggle_play_pause()
        assert p.is_playing
        p.stop()


# ------------------------------------------------------------------ providers, trimmer, recorder

def test_providers_and_languages_against_jax():
    from tpu_audio.api import providers as jprov
    from tpu_audio.api import voice as jvoice
    from tpu_audio_torch.api import providers, voice

    for port, ref in ((providers.TTSProvider, jprov.TTSProvider),
                      (providers.STTProvider, jprov.STTProvider)):
        assert [(m.name, vars(m.info)) for m in port] == [(m.name, vars(m.info)) for m in ref]
    assert providers.TTSProvider.COSYVOICE2.info.supports_voice_conversion
    assert not providers.TTSProvider.KOKORO.info.supports_reference_audio
    assert "token" in providers.TTSProvider.COSYVOICE3.info.streaming_granularities
    langs = voice.Language.all()
    assert len(langs) == 100 and voice.Language("en").name == "English"
    assert [(x.code, x.name) for x in langs] == [(x.code, x.name) for x in jvoice.Language.all()]
    assert voice.Voice("tara", "Tara") == voice.Voice("tara", "Tara", "en", None)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trim_silence_against_jax(seed):
    rng = np.random.default_rng(seed)
    sr = 16000
    lead, body, tail = rng.integers(1000, 9000, 3)
    sig = np.concatenate([rng.standard_normal(lead) * 1e-4,
                          rng.standard_normal(body) * 0.3,
                          rng.standard_normal(tail) * 1e-4]).astype(np.float32)
    for cfg in ("DEFAULT", "CHATTERBOX"):
        got = trimmer.trim_silence(sig, sr, getattr(trimmer, cfg))
        want = jtrimmer.trim_silence(sig, sr, getattr(jtrimmer, cfg))
        assert got[1:] == want[1:] and lead // 2 <= got[1] <= lead + 400
        np.testing.assert_array_equal(got[0], want[0])
    out, s, e = trimmer.trim_silence(np.zeros(16000, np.float32), 16000)
    assert (s, e) == jtrimmer.trim_silence(np.zeros(16000, np.float32), 16000)[1:]


def test_word_boundary_clipping_against_jax():
    sr = 16000
    audio = np.random.default_rng(3).standard_normal(sr * 3).astype(np.float32) * 0.1
    rows = [("hello", 0.0, 0.5, 0.9), (" world", 0.6, 1.0, 0.9), (" um", 1.1, 1.3, 0.1)]
    for ws in (rows, rows[:2], rows[:1], [("a", 0.0, 0.2, 0.9), ("b", 0.2, 3.0, 0.9)]):
        got = trimmer.clip_at_word_boundary(audio, sr, [Word(*w) for w in ws])
        want = jtrimmer.clip_at_word_boundary(audio, sr, [JWord(*w) for w in ws])
        np.testing.assert_array_equal(got.audio, want.audio)
        for f in ("sample_rate", "transcription", "original_duration", "trimmed_duration",
                  "clipped_at_word_boundary"):
            assert getattr(got, f) == getattr(want, f), f
        assert [vars(w) for w in got.words or []] == [vars(w) for w in want.words or []]
    res = trimmer.clip_at_word_boundary(audio, sr, [Word(*w) for w in rows])
    assert res.transcription == "hello" and abs(res.trimmed_duration - 0.5) < 0.01
    assert len(trimmer.drop_hallucinated_words([Word("a", 0.0, 0.2, 0.9),
                                                Word("b", 0.2, 3.0, 0.9)])) == 1


def test_recorder_against_jax(tmp_path):
    from tpu_audio_torch.utils.audio_io import write_wav

    x = np.random.default_rng(4).uniform(-0.5, 0.5, 24000).astype(np.float32)
    rec, jrec = AudioRecorder(target_rate=16000), JRecorder(target_rate=16000)
    for r in (rec, jrec):
        r.push(x, sample_rate=24000)
    assert abs(rec.duration - 1.0) < 0.01
    np.testing.assert_allclose(rec._buffer, jrec._buffer, atol=1e-6)
    chunk = rec.pull(0.5)
    assert chunk is not None and len(chunk) == 8000 and rec.pull(1.0) is None
    assert len(rec.drain()) > 0
    path = str(tmp_path / "in.wav")
    write_wav(path, x, 24000)
    rec.load_file(path)
    jrec.drain()
    jrec.load_file(path)
    np.testing.assert_allclose(rec._buffer, jrec._buffer, atol=1e-4)  # int16 WAV round trip
    import io

    pcm = (x[:3200] * 32767).astype("<i2").tobytes()
    got = list(rec.read_raw_stream(io.BytesIO(pcm), sample_rate=16000, chunk_bytes=2000))
    assert sum(len(g) for g in got) == 3200
    assert not AudioRecorder.input_available()
    with pytest.raises(RuntimeError):
        next(rec.record_stream())


# ------------------------------------------------------------------ native

def test_native_numpy_versions_against_jax():
    from tpu_audio.models.whisper.timing import dtw as jdtw

    assert not native.available()
    x = np.random.default_rng(5).standard_normal(4410).astype(np.float32)
    np.testing.assert_allclose(native.resample(x, 44100, 16000), jresample(x, 44100, 16000),
                               atol=1e-6)
    cost = np.random.default_rng(6).random((7, 19)).astype(np.float32)
    for a, b in zip(native.dtw(cost), jdtw(cost)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError):
        native.NativeBPE({b"a": 0})


def test_ring_buffer_wraps_and_refuses_past_capacity():
    r = native.RingBuffer(5)
    assert r.write(np.arange(3, dtype=np.float32)) == 3
    np.testing.assert_array_equal(r.read(2), [0, 1])
    assert r.write(np.arange(10, 20, dtype=np.float32)) == 4 and r.available == 5
    np.testing.assert_array_equal(r.read(10), [2, 10, 11, 12, 13])
    assert r.available == 0 and len(r.read(3)) == 0
    with pytest.raises(ValueError):
        native.RingBuffer(0)


def test_spsc_ring_moves_a_million_samples_in_order():
    n, ring = 1_000_000, native.RingBuffer(4093)
    src = np.arange(n, dtype=np.float32)  # exact below 2**24
    sizes = np.random.default_rng(7).integers(1, 3000, 4000)
    got = []

    def writer():
        i = k = 0
        while i < n:
            i += ring.write(src[i:i + int(sizes[k % len(sizes)])])
            k += 1

    def reader():
        have, k = 0, 1
        while have < n:
            piece = ring.read(int(sizes[k % len(sizes)]))
            have += len(piece)
            got.append(piece)
            k += 1

    threads = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    np.testing.assert_array_equal(np.concatenate(got), src)


# ------------------------------------------------------------------ profiling, memory, logging

def test_profiler_on_the_host():
    prof = Profiler()
    for _ in range(3):
        with prof.time("a"):
            time.sleep(0.002)
    prof.record("b", 0.5)
    s = prof.summary()
    assert s["a"]["count"] == 3 and s["a"]["total_s"] >= 0.006
    assert s["a"]["mean_s"] == pytest.approx(s["a"]["total_s"] / 3)
    assert s["b"] == {"total_s": 0.5, "count": 1, "mean_s": 0.5}
    prof.reset()
    assert prof.summary() == {}


def test_profiler_reads_cuda_events_at_summary(monkeypatch):
    """A CUDA stage is timed between two events on the stream and read only
    at summary(); the events are faked here."""
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.at, self.synced = None, False
            made.append(self)

        def record(self):
            self.at = len(made) * 10.0

        def synchronize(self):
            self.synced = True

        def elapsed_time(self, end):
            return end.at - self.at

    monkeypatch.setattr(torch.cuda, "Event", Event)
    prof = Profiler(device="cuda")
    with prof.time("span"):
        pass
    assert dict(prof.stages) == {} and not made[1].synced  # nothing read yet
    assert prof.summary()["span"] == {"total_s": 0.0, "count": 1, "mean_s": 0.0}
    assert made[1].synced
    with prof.time("span"):
        made.append(None)  # the end event is recorded one object later
    assert prof.summary()["span"]["total_s"] == pytest.approx(0.01)


def test_device_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_AUDIO_TRACE_DIR", str(tmp_path))
    with device_trace("t"):
        torch.ones(4) + 1
    assert (tmp_path / "t.json").stat().st_size > 0
    monkeypatch.delenv("TPU_AUDIO_TRACE_DIR")
    with device_trace("u"):
        pass
    assert not (tmp_path / "u.json").exists()


def test_memory_on_the_cpu():
    assert memory.snapshot("cpu") == {}
    if not torch.cuda.is_available():
        assert memory.snapshot() == {}
    memory.set_memory_fraction(0.5, "cpu")
    memory.clear_caches()
    memory.log_stats("t", "cpu")


def test_logging_categories(caplog):
    log = tlogging.get_logger("audio")
    assert log.name == "tpu_audio_torch.audio"
    with pytest.raises(ValueError, match="unknown log category"):
        tlogging.get_logger("ui")
    with caplog.at_level("INFO", logger="tpu_audio_torch.perf"):
        tlogging.log_rtf("gen", 0.5, 2.0)
        tlogging.log_timing("step", 0.25)
    assert "RTF 0.250, 4.0x real time" in caplog.text and "step took 0.250s" in caplog.text


def test_generate_logs_its_rtf(caplog):
    with caplog.at_level("INFO", logger="tpu_audio_torch.perf"):
        fake_engine(TTSEngineBase, 1600, n=2).generate("x")
    assert "FakeEngine.generate" in caplog.text and "0.20s audio" in caplog.text


def test_lazy_exports_import_no_jax():
    code = ("import sys, tpu_audio_torch as t\n"
            "assert 'jax' not in sys.modules and 'tpu_audio' not in sys.modules\n"
            "assert 'tpu_audio_torch.api.playback' not in sys.modules\n"
            "from tpu_audio_torch import TTS, STT, PlaybackController, AudioSamplePlayer\n"
            "from tpu_audio_torch import AudioFilePlayer, AudioResult, TranscriptionResult\n"
            "from tpu_audio_torch import StreamingGranularity\n"
            "assert sorted(t.__all__) == sorted(t._LAZY)\n"
            "assert TTS.orpheus and PlaybackController.play_stream\n"
            "assert 'jax' not in sys.modules and 'tpu_audio' not in sys.modules\n"
            "try:\n    t.nothing\nexcept AttributeError:\n    print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_say_streams_every_granularity_default():
    """say() on the base class with the engine's granularity default."""
    eng = fake_engine(TTSEngineBase, 400, n=4)
    assert eng.default_streaming_granularity == StreamingGranularity.SENTENCE
    res = eng.say("x", sink=playback.PlayerSink(16000, backend="null"))
    assert res.chunks == 4 and res.audio.duration == pytest.approx(0.1)
    assert player.SLICE_SECONDS == jplayer.SLICE_SECONDS
