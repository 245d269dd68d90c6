"""WAV read/write and mono mixdown, dependency-free (port of
tpu_audio/utils/audio_io.py: read_wav, write_wav, StreamingWavWriter,
to_mono, load_audio).

Replaces the reference's AVAudioFile/AudioFileWriter layer
(package/Audio/AudioFileWriter.swift:43-113): 16/24/32-bit PCM and
float32 WAV in both directions, plus mono mixdown and target-rate loading
through ops/resample (the NumPy polyphase resampler; the JAX package
takes its C++ core where that is built).
"""

from __future__ import annotations

import struct

import numpy as np

from tpu_audio_torch.ops.resample import resample


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file → (float32 samples (T,) or (T, C), sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, fmt, raw = 12, None, None
    while pos + 8 <= len(data):
        cid, size = data[pos : pos + 4], struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 3:  # IEEE float
        x = np.frombuffer(raw, dtype="<f4" if bits == 32 else "<f8").astype(np.float32)
    elif audio_format in (1, 0xFFFE):  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            vals = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAV format {audio_format}")
    if channels > 1:
        x = x[: len(x) // channels * channels].reshape(-1, channels)
    return x, rate


def write_wav(path: str, samples: np.ndarray, sample_rate: int,
              dtype: str = "float32") -> None:
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    channels = samples.shape[1]
    if dtype == "int16":
        fmt_code, bits = 1, 16
        payload = np.clip(samples, -1.0, 1.0)
        payload = (payload * 32767.0).astype("<i2").tobytes()
    else:
        fmt_code, bits = 3, 32
        payload = samples.astype("<f4").tobytes()
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt_code, channels, sample_rate,
                            byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


class StreamingWavWriter:
    """Progressive WAV writing for long streams — samples hit disk as they
    arrive, with RIFF/data sizes patched on close (reference
    Audio/AudioFileWriter.swift writes float32 PCM the same way). Usable as
    a context manager."""

    def __init__(self, path: str, sample_rate: int, channels: int = 1,
                 dtype: str = "float32"):
        self.path = path
        self.sample_rate = sample_rate
        self.channels = channels
        self.dtype = dtype
        self.frames_written = 0
        fmt_code, bits = (1, 16) if dtype == "int16" else (3, 32)
        self._bits = bits
        self._fmt = fmt_code
        self._f = open(path, "wb")
        byte_rate = sample_rate * channels * bits // 8
        block_align = channels * bits // 8
        self._f.write(b"RIFF" + struct.pack("<I", 36) + b"WAVEfmt ")
        self._f.write(struct.pack("<IHHIIHH", 16, fmt_code, channels,
                                  sample_rate, byte_rate, block_align, bits))
        self._f.write(b"data" + struct.pack("<I", 0))

    def write(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples)
        if self.dtype == "int16":
            payload = (np.clip(samples, -1.0, 1.0)
                       * 32767.0).astype("<i2").tobytes()
        else:
            payload = samples.astype("<f4").tobytes()
        self._f.write(payload)
        self.frames_written += samples.size // self.channels

    def close(self) -> str:
        data_bytes = self.frames_written * self.channels * self._bits // 8
        self._f.seek(4)
        self._f.write(struct.pack("<I", 36 + data_bytes))
        self._f.seek(40)
        self._f.write(struct.pack("<I", data_bytes))
        self._f.close()
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def to_mono(x: np.ndarray) -> np.ndarray:
    return x.mean(axis=1).astype(np.float32) if x.ndim == 2 else x


def load_audio(path: str, target_rate: int | None = None) -> tuple[np.ndarray, int]:
    """Read + mixdown + resample in one call (the reference's
    loadAndPreprocessAudio, package/STT/Whisper/WhisperEngine.swift:308-369)."""
    x, rate = read_wav(path)
    x = to_mono(x)
    if target_rate is not None and rate != target_rate:
        x = resample(x, rate, target_rate)
        rate = target_rate
    return x, rate
