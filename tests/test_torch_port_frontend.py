"""PyTorch port, Whisper front-end: the port's log-mel against the JAX
package's, on the same audio made by numpy from a seed.

On the CPU every kernel wrapper of the port runs its plain PyTorch version;
the JAX side runs its Pallas kernel in interpret mode, as
tests/test_pallas_mel.py does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.models.whisper import pipeline as jpipeline
from tpu_audio.ops import frontends as jfrontends
from tpu_audio.ops import mel_filters as jmel_filters
from tpu_audio.ops import stft as jstft
from tpu_audio.ops import windows as jwindows
from tpu_audio_torch.models.whisper import pipeline as tpipeline
from tpu_audio_torch.ops import frontends, mel_filters, stft, windows
from tpu_audio_torch.ops.kernels import fused_mel
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-4  # log10-mel units, f32 on both sides


@pytest.fixture
def interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _audio(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)


def test_numpy_tables_match():
    assert np.array_equal(windows.hann(400), jwindows.hann(400))
    assert np.array_equal(windows.get_window("hamming", 400),
                          jwindows.get_window("hamming", 400))
    for n_mels in (80, 128):
        assert np.array_equal(mel_filters.slaney(16000, 400, n_mels, fmax=8000.0),
                              jmel_filters.slaney(16000, 400, n_mels, fmax=8000.0))
    assert np.array_equal(stft.dft_basis(400), jstft.dft_basis(400))


def test_stft_power_matches():
    audio = _audio(1.0)
    got = stft.stft_power(torch.from_numpy(audio), windows.hann(400), 400, 160)
    ref = jstft.stft_power(jnp.asarray(audio), jwindows.hann(400), 400, 160)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_whisper_log_mel_matches(n_mels):
    audio = _audio(7.5, seed=n_mels)
    got = frontends.whisper_log_mel(torch.from_numpy(audio), n_mels=n_mels)
    ref = jfrontends.whisper_log_mel(jnp.asarray(audio), n_mels=n_mels)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_fused_log_mel_plain_matches_pallas(interpret_pallas):
    """The port's plain fused_log_mel (what the CUDA kernel is held to)
    against the TPU kernel in interpret mode, through the Whisper wrapper
    of each, and against the JAX XLA front-end."""
    from tpu_audio.ops.pallas import fused_mel as jfused_mel

    audio = _audio(30.0)
    # whisper_log_mel_pallas's framing: 200 samples of reflect padding, the
    # final frame dropped, then the clip-wide normalisation
    x = torch.nn.functional.pad(torch.from_numpy(audio)[None, None], (200, 200),
                                mode="reflect")[0, 0]
    got = frontends.log10_norm(fused_mel.fused_log_mel(x, n_mels=128)[:3000])
    assert got.shape == (3000, 128)
    ref = jfused_mel.whisper_log_mel_pallas(jnp.asarray(audio), n_mels=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    xla = jfrontends.whisper_log_mel(jnp.asarray(audio), n_mels=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=ATOL)


def test_fused_log_mel_cpu_takes_plain():
    audio = torch.from_numpy(_audio(1.0))
    before = dict(fused_mel.LAUNCHES)
    got = fused_mel.fused_log_mel(audio, n_mels=80)
    assert fused_mel.LAUNCHES == before  # no kernel launch on the CPU
    assert got.shape == ((16000 - 400) // 160 + 1, 80)
    assert torch.equal(got, fused_mel.fused_log_mel_plain(audio, n_mels=80))


def test_mel_extractor_matches():
    """Whole-clip MelExtractor over a clip longer than one 30 s chunk."""
    audio = _audio(35.0, seed=3)
    got = tpipeline.MelExtractor(80, device="cpu")(audio)
    ref = jpipeline.MelExtractor(80)(audio)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_pad_frames():
    mel = torch.ones((10, 4))
    assert tuple(tpipeline._pad_frames(mel, 16).shape) == (16, 4)
    assert tpipeline._pad_frames(mel, 16)[10:].abs().sum() == 0
    assert tuple(tpipeline._pad_frames(mel, 6).shape) == (6, 4)
