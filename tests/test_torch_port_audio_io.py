"""Audio files in and out: the port's utils/audio_io.py and ops/resample.py
against the JAX package's, on files written here; `AudioResult.save` and a
WAV path through an STT engine's `_resolve_audio`.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest

from tpu_audio.ops import resample as jresample
from tpu_audio.utils import audio_io as jaudio_io
from tpu_audio_torch.api.results import AudioResult
from tpu_audio_torch.api.stt import STTEngineBase
from tpu_audio_torch.ops import resample as tresample
from tpu_audio_torch.utils import audio_io
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401


def signal(n: int, channels: int = 1, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (np.sin(np.linspace(0, 300 * np.pi, n))[:, None] * 0.5
         + rng.standard_normal((n, channels)) * 0.1).astype(np.float32)
    x[:3] = [[1.5], [-1.5], [1.0]] if channels == 1 else 1.5  # clipped in int16
    return x[:, 0] if channels == 1 else x


def same(got, want) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("dtype, channels", [("int16", 1), ("float32", 1), ("int16", 2),
                                             ("float32", 2)])
def test_write_and_read_wav_match_jax(tmp_path, dtype, channels):
    x = signal(1001, channels)
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    audio_io.write_wav(str(ours), x, 22050, dtype=dtype)
    jaudio_io.write_wav(str(theirs), x, 22050, dtype=dtype)
    assert ours.read_bytes() == theirs.read_bytes()
    got, rate = audio_io.read_wav(str(ours))
    want, jrate = jaudio_io.read_wav(str(ours))
    assert rate == jrate == 22050 and same(got, want)
    assert same(audio_io.to_mono(got), jaudio_io.to_mono(want))
    assert audio_io.to_mono(got).ndim == 1


def _pcm_file(path, bits: int, data: bytes, channels: int = 1, rate: int = 8000,
              fmt: int = 1) -> None:
    block = channels * bits // 8
    body = (b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels, rate, rate * block, block, bits)
            + b"LIST" + struct.pack("<I", 3) + b"abc\0"  # an odd chunk, padded
            + b"data" + struct.pack("<I", len(data)) + data)
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)


@pytest.mark.parametrize("bits", [8, 24, 32])
def test_read_pcm_depths_match_jax(tmp_path, bits):
    rng = np.random.default_rng(bits)
    data = rng.integers(0, 256, 3 * 4 * 10, dtype=np.uint8).tobytes()
    path = tmp_path / f"pcm{bits}.wav"
    _pcm_file(path, bits, data, channels=2)
    got, rate = audio_io.read_wav(str(path))
    want, _ = jaudio_io.read_wav(str(path))
    assert rate == 8000 and same(got, want) and got.shape[1] == 2


def test_read_refuses_what_the_jax_reader_refuses(tmp_path):
    path = tmp_path / "x.wav"
    path.write_bytes(b"not a wave file at all")
    with pytest.raises(ValueError, match="RIFF"):
        audio_io.read_wav(str(path))
    _pcm_file(path, 12, b"\0" * 12)
    with pytest.raises(ValueError, match="bit depth"):
        audio_io.read_wav(str(path))
    _pcm_file(path, 16, b"\0" * 4, fmt=2)
    with pytest.raises(ValueError, match="format"):
        audio_io.read_wav(str(path))


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_streaming_writer_matches_jax(tmp_path, dtype):
    x = signal(3000, 2, seed=1)
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    with audio_io.StreamingWavWriter(str(ours), 24000, channels=2, dtype=dtype) as w:
        for part in np.array_split(x, 7):
            w.write(part)
    with jaudio_io.StreamingWavWriter(str(theirs), 24000, channels=2, dtype=dtype) as w:
        for part in np.array_split(x, 7):
            w.write(part)
    assert ours.read_bytes() == theirs.read_bytes()
    back, _ = audio_io.read_wav(str(ours))
    assert back.shape == (3000, 2)


@pytest.mark.parametrize("sr_in, sr_out", [(44100, 16000), (22050, 24000), (48000, 16000)])
def test_resample_matches_jax_bit_for_bit(sr_in, sr_out):
    x = signal(sr_in // 3 + 17, seed=sr_in)
    got = tresample.resample(x, sr_in, sr_out, block=4096)
    want = jresample.resample(x, sr_in, sr_out, block=4096)
    assert same(got, want) and got.dtype == np.float32
    assert len(got) == -(-len(x) * sr_out // sr_in)
    assert same(tresample.resample(x, sr_in, sr_in), x)


def test_load_audio_mixes_and_resamples(tmp_path):
    x = signal(44100 // 4, 2, seed=5)
    path = tmp_path / "stereo.wav"
    audio_io.write_wav(str(path), x, 44100)
    got, rate = audio_io.load_audio(str(path), target_rate=16000)
    mono = jaudio_io.to_mono(jaudio_io.read_wav(str(path))[0])
    assert rate == 16000 and same(got, jresample.resample(mono, 44100, 16000))
    same_rate, rate = audio_io.load_audio(str(path))
    assert rate == 44100 and same(same_rate, mono)


def test_audio_result_save(tmp_path):
    """`AudioResult.save` writes int16 by default (each sample truncated to
    its step) and float32 on request, as the JAX one does."""
    x = signal(2400)
    res = AudioResult(samples=x, sample_rate=24000)
    path = res.save(str(tmp_path / "out.wav"))
    jaudio_io.write_wav(str(tmp_path / "ref.wav"), x, 24000, dtype="int16")
    assert open(path, "rb").read() == (tmp_path / "ref.wav").read_bytes()
    back, rate = audio_io.read_wav(path)
    clipped = np.clip(x, -1, 1)
    assert rate == 24000 and np.abs(back - clipped).max() <= (1 + np.abs(clipped)).max() / 32768
    back32, _ = audio_io.read_wav(res.save(str(tmp_path / "f.wav"), dtype="float32"))
    assert same(back32, x)


def test_resolve_audio_reads_a_path(tmp_path):
    """A WAV path through `_resolve_audio`: read, mixed to mono, resampled
    to the engine's 16 kHz; an array passes through; a missing file raises."""
    x = signal(22050 // 2, 2, seed=7)
    path = tmp_path / "clip.wav"
    audio_io.write_wav(str(path), x, 22050, dtype="int16")
    eng = STTEngineBase(device="cpu")
    got = eng._resolve_audio(str(path))
    assert same(got, audio_io.load_audio(str(path), 16000)[0]) and got.ndim == 1
    assert same(eng._resolve_audio(got), got)
    with pytest.raises(FileNotFoundError):
        eng._resolve_audio(str(tmp_path / "absent.wav"))
