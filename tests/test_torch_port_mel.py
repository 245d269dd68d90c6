"""PyTorch port, the Whisper log-mel kernel's design on the CPU: the band
table of `fused_mel._constants` against the Slaney filterbank; a numpy model
of the CUDA kernel's FFT plan (`fused_mel.RADICES`, the twiddle table of
`fused_mel.twiddles`, the split into 201 bins, the banded sum) against
`np.fft.rfft` and the JAX kernel in interpret mode; the card's
dynamic-range gate (`tools/mel_split.py`): its signal through the port's
plain version and the JAX kernel against float64, and its float64
reference against numpy; `MelExtractor`'s one call a clip against its
former per-chunk loop and the JAX extractor; the wrapper's CPU slices, its
refusals and its one launch on a faked card; and the cuts of
`tools/mel_split.py` on the repository's source and on the previous
design's (kept under `tests/data/fused_mel_parent/`).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.models.whisper import pipeline as jpipeline
from tpu_audio.ops.pallas import fused_mel as jfused_mel
from tpu_audio_torch.models.whisper import pipeline as tpipeline
from tpu_audio_torch.ops import frontends, mel_filters, windows
from tpu_audio_torch.ops.kernels import _build, fused_mel
from tpu_audio_torch.tools import mel_split
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

PARENT = Path(__file__).resolve().parent / "data" / "fused_mel_parent"
CPU = torch.device("cpu")
ATOL = 1e-4  # log10-mel units, f32 on both sides (as test_torch_port_frontend.py)


@pytest.fixture
def interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp)


def noise(n: int, seed: int = 0, scale: float = 0.1) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def frames_of(x: np.ndarray) -> np.ndarray:
    return np.lib.stride_tricks.sliding_window_view(x, 400)[::160]


def gate_signal() -> np.ndarray:
    """The card's dynamic-range gate signal (`mel_split.gate_signals`, as
    chip_smoke.py draws it): a 440 Hz tone at 0.5, a chirp from 50 to 7950
    Hz at 1e-2, noise at 1e-5, 2 s of exact zeros from 12 s; reflect
    margins of 200."""
    return mel_split.gate_signals(np.random.default_rng(0))["30 s"]


# ------------------------------------------------ the kernel's plan in numpy

def dft5(v, c):
    """csrc/fused_mel.cu's 5-point butterfly; c casts a constant."""
    c1, c2 = c(np.cos(2 * np.pi / 5)), c(np.cos(4 * np.pi / 5))
    s1, s2 = c(np.sin(2 * np.pi / 5)), c(np.sin(4 * np.pi / 5))
    t1, t2, t3, t4 = v[1] + v[4], v[2] + v[3], v[1] - v[4], v[2] - v[3]
    a1, a2 = v[0] + c1 * t1 + c2 * t2, v[0] + c2 * t1 + c1 * t2
    b1, b2 = (s1 * t3 + s2 * t4) * c(-1j), (s2 * t3 - s1 * t4) * c(-1j)
    return [v[0] + (t1 + t2), a1 + b1, a2 + b2, a2 - b2, a1 - b1]


def dft8(v, c):
    """csrc/fused_mel.cu's 8-point butterfly (three radix-2 stages)."""
    h, mi = c(np.sqrt(0.5)), c(-1j)
    a = [v[r] + v[r + 4] for r in range(4)] + [v[r] - v[r + 4] for r in range(4)]
    a[5] = ((a[5].real + a[5].imag) * h + 1j * ((a[5].imag - a[5].real) * h)).astype(a[5].dtype)
    a[6] = a[6] * mi
    a[7] = ((a[7].imag - a[7].real) * h - 1j * ((a[7].real + a[7].imag) * h)).astype(a[7].dtype)
    b0, b2, b1, b3 = a[0] + a[2], a[0] - a[2], a[1] + a[3], (a[1] - a[3]) * mi
    b4, b6, b5, b7 = a[4] + a[6], a[4] - a[6], a[5] + a[7], (a[5] - a[7]) * mi
    return [b0 + b1, b4 + b5, b2 + b3, b6 + b7, b0 - b1, b4 - b5, b2 - b3, b6 - b7]


def plan_rfft(frames: np.ndarray, dtype) -> np.ndarray:
    """The kernel's 201 bins of each windowed frame in `dtype` (float32 or
    float64): the samples paired into 200 complex points, the Stockham
    passes of RADICES with the table of `twiddles()`, then the split."""
    cdt = np.complex64 if dtype == np.float32 else np.complex128

    def c(v):
        return np.asarray(v, cdt if np.iscomplexobj(v) else dtype)[()]

    tw = fused_mel.twiddles().astype(cdt)
    win = windows.hann(400).astype(np.float64)
    x = (frames[:, 0::2] * win[0::2] + 1j * (frames[:, 1::2] * win[1::2])).astype(cdt)
    ns, off = 1, 0
    for r in fused_mel.RADICES:
        n_items = fused_mel.N_POINTS // r
        j = np.arange(n_items)
        k = j % ns
        table = tw[off: off + (r - 1) * ns].reshape(r - 1, ns)
        off += (r - 1) * ns
        v = [x[:, j + q * n_items] * (table[q - 1, k] if q else c(1)) for q in range(r)]
        v = (dft5 if r == 5 else dft8)(v, c)
        out = np.empty_like(x)
        base = (j // ns) * ns * r + k
        for q in range(r):
            out[:, base + q * ns] = v[q]
        x, ns = out, ns * r
    k = np.arange(fused_mel.N_POINTS // 2 + 1)
    zk, zn = x[:, k], np.conj(x[:, (fused_mel.N_POINTS - k) % fused_mel.N_POINTS])
    e, o = (zk + zn) * c(0.5), (zk - zn) * c(-0.5j)
    t = tw[off + k] * o
    bins = np.empty((x.shape[0], 201), cdt)
    bins[:, 200 - k] = np.conj(e - t)
    bins[:, k] = e + t
    return bins


def banded_log_mel(power: np.ndarray, n_mels: int) -> np.ndarray:
    """The kernel's mel: each band's f32 weights over its bins, in bin
    order, then log10 of max(., 1e-10)."""
    table, weights = fused_mel.bands(n_mels)
    power = power.astype(np.float32)
    acc = np.zeros((power.shape[0], n_mels), np.float32)
    for m, (first, count, offset, _) in enumerate(table):
        for c in range(count):
            acc[:, m] += power[:, first + c] * weights[offset + c]
    return np.log10(np.maximum(acc, np.float32(1e-10)))


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("n_mels", [80, 128])
def test_band_table_covers_the_filterbank(n_mels):
    """Each band's run of bins holds every nonzero weight of its Slaney
    triangle, in order; the banded sum in bin order equals the dense sum in
    bin order bit for bit (the zero weights add exactly nothing); no band
    spans more bins than the kernel unrolls (16)."""
    fb = mel_filters.slaney(16000, 400, n_mels, fmax=8000.0)
    table, weights = fused_mel.bands(n_mels)
    c = fused_mel._constants(n_mels, CPU)
    assert torch.equal(c.bands, torch.from_numpy(table))
    assert torch.equal(c.weights, torch.from_numpy(weights))
    assert c.widest == table[:, 1].max() <= fused_mel.MAX_BAND and table[:, 1].min() >= 1
    covered = np.zeros_like(fb, dtype=bool)
    for m, (first, count, offset, pad) in enumerate(table):
        assert pad == 0 and offset == table[:m, 1].sum()
        covered[m, first:first + count] = True
        np.testing.assert_array_equal(weights[offset:offset + count], fb[m, first:first + count])
    assert not (fb != 0)[~covered].any()
    assert len(weights) == table[:, 1].sum()

    power = np.abs(np.random.default_rng(n_mels).standard_normal((64, 201))).astype(np.float32)
    dense = np.zeros((64, n_mels), np.float32)
    for b in range(201):
        dense += power[:, b:b + 1] * fb[:, b][None]
    banded = banded_log_mel(power, n_mels)
    np.testing.assert_array_equal(banded, np.log10(np.maximum(dense, np.float32(1e-10))))


@pytest.mark.parametrize("dtype, rel", [(np.float32, 1e-5), (np.float64, 1e-12)])
def test_fft_plan_matches_rfft(dtype, rel):
    """The kernel's plan (radix 5, 5, 8, the table of `twiddles()`, the
    split) against np.fft.rfft of the windowed frames, max |diff| over max
    |rfft|."""
    frames = frames_of(noise(200 * 160 + 400, seed=1).astype(np.float64))
    ref = np.fft.rfft(frames * windows.hann(400).astype(np.float64), axis=1)
    got = plan_rfft(frames.astype(dtype), dtype)
    assert np.abs(got - ref).max() / np.abs(ref).max() <= rel


def test_twiddle_table_layout():
    """Each pass's factors at [r - 1][k], then the split's, in float64;
    `_constants` holds them as (real, imaginary) pairs."""
    tw = fused_mel.twiddles()
    assert tw.shape == (4 * 1 + 4 * 5 + 7 * 25 + 101,)
    np.testing.assert_allclose(tw[4 + 2 * 5 + 3], np.exp(-2j * np.pi * 3 * 3 / 25), rtol=1e-15)
    np.testing.assert_allclose(tw[24 + 6 * 25 + 24], np.exp(-2j * np.pi * 24 * 7 / 200),
                               rtol=1e-15)
    np.testing.assert_allclose(tw[199 + 100], np.exp(-2j * np.pi * 100 / 400), rtol=1e-15)
    pairs = fused_mel._constants(128, CPU).twiddles
    assert pairs.dtype == torch.float64
    np.testing.assert_array_equal(pairs.numpy()[:, 0] + 1j * pairs.numpy()[:, 1], tw)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_fft_plan_log_mel_matches_the_tpu_kernel(interpret_pallas, n_mels):
    """The plan in float64 (as the kernel runs it), through the banded
    filterbank and log10, against the JAX fused_log_mel in interpret mode on
    a 30 s chunk with its margins (atol 1e-3)."""
    x = noise(480_400, seed=n_mels)
    power = np.abs(plan_rfft(frames_of(x).astype(np.float64), np.float64)) ** 2
    got = banded_log_mel(power, n_mels)
    frames = 3072  # the JAX kernel takes whole blocks of 256 frames
    xp = np.pad(x, (0, (frames - 1) * 160 + 400 - x.size))
    ref = np.asarray(jfused_mel.fused_log_mel(jnp.asarray(xp), n_mels=n_mels))[:3001]
    assert np.abs(got - ref).max() <= 1e-3


def test_gate_signal_plain_and_tpu_kernel_against_float64(interpret_pallas):
    """The card's dynamic-range gate signal: the port's plain f32 version
    and the JAX kernel in interpret mode each within 0.06 log10 of a numpy
    float64 evaluation of the same function. An f32 DFT of a frame holding
    the 0.5 tone puts ~1e-6 into bins whose noise at 1e-5 makes mels near
    the 1e-10 floor: 0.010 for the port's plain version on the CPU, 0.042
    for the JAX kernel (another order of summation). The kernel's plan in
    float64 is within 1e-4 (the f32 power and band sums)."""
    x = gate_signal()
    n_mels = 128
    fb = mel_filters.slaney(16000, 400, n_mels, fmax=8000.0).astype(np.float64)
    frames = frames_of(x).astype(np.float64)
    power = np.abs(np.fft.rfft(frames * windows.hann(400).astype(np.float64), axis=1)) ** 2
    exact = np.log10(np.maximum(power @ fb.T, 1e-10))
    plain = fused_mel.fused_log_mel_plain(torch.from_numpy(x), n_mels=n_mels).numpy()
    xp = np.pad(x, (0, 3071 * 160 + 400 - x.size))
    tpu = np.asarray(jfused_mel.fused_log_mel(jnp.asarray(xp), n_mels=n_mels))[:3001]
    assert np.abs(plain - exact).max() <= 0.06
    assert np.abs(tpu - exact).max() <= 0.06
    planned = banded_log_mel(np.abs(plan_rfft(frames, np.float64)) ** 2, n_mels)
    assert np.abs(planned - exact).max() <= 1e-4
    assert (exact == -10.0).any()  # the zeros reach the floor


@pytest.mark.parametrize("n_mels", [80, 128])
def test_gate_reference_is_float64(n_mels):
    """`mel_split.gate_refs`, the card's gate, on the CPU: its reference
    is within 1e-6 log10 of a numpy float64 evaluation of the same function
    on both signals (float64 rounding where a quiet mel's power is near the
    1e-10 floor: ~2e-9 here; the distances the gate compares are ~1e-2),
    the 20 s one reaches the zero tail, and the plain f32 version's
    distance from it is what the gate scales."""
    signals, exact, plain = mel_split.gate_refs(n_mels, CPU)
    fb = mel_filters.slaney(16000, 400, n_mels, fmax=8000.0).astype(np.float64)
    hann = windows.hann(400).astype(np.float64)
    for name, x in signals.items():
        power = np.abs(np.fft.rfft(frames_of(x.numpy()).astype(np.float64) * hann, axis=1)) ** 2
        ref = np.log10(np.maximum(power @ fb.T, 1e-10))
        assert np.abs(exact[name].numpy() - ref).max() <= 1e-6, name
        got = fused_mel.fused_log_mel_plain(x, n_mels=n_mels).double()
        assert plain[name] == (got - exact[name]).abs().max().item() > 0, name
    assert (exact["20 s + zeros"][-500:] == -10.0).all()


def test_float32_plan_would_fail_the_gate():
    """Why the kernel's FFT runs in float64: on the gate signal the plan in
    float32 rounds every intermediate against the loud tone's bin, and its
    log-mel lands more than the gate's 1.5x as far from float64 as the
    plain f32 version (1.8x here at 128 mels; the kernel's float32 copy that
    `tools/mel_split.py` gates on the card reads 1.79x); in float64 it is
    under a hundredth of it."""
    x = gate_signal()
    fb = mel_filters.slaney(16000, 400, 128, fmax=8000.0).astype(np.float64)
    frames = frames_of(x).astype(np.float64)
    power = np.abs(np.fft.rfft(frames * windows.hann(400).astype(np.float64), axis=1)) ** 2
    exact = np.log10(np.maximum(power @ fb.T, 1e-10))
    plain = np.abs(fused_mel.fused_log_mel_plain(torch.from_numpy(x)).numpy() - exact).max()
    f32 = banded_log_mel(np.abs(plan_rfft(frames_of(x), np.float32).astype(np.complex128)) ** 2,
                         128)
    f64 = banded_log_mel(np.abs(plan_rfft(frames, np.float64)) ** 2, 128)
    assert np.abs(f32 - exact).max() > 1.5 * plain
    assert np.abs(f64 - exact).max() < 0.01 * plain


def per_chunk_reference(audio: np.ndarray, n_mels: int) -> torch.Tensor:
    """MelExtractor's former loop: one plain call a 30 s chunk with its
    margins, the first 3000 frames of each, then the normalisation."""
    margin = 200
    total_frames = (len(audio) + 480_000) // 160
    padded = np.pad(np.pad(audio, (0, 480_000)), (margin, margin), mode="reflect")
    n_chunks = -(-total_frames // 3000)
    need = n_chunks * 480_000 + 2 * margin
    padded = np.pad(padded, (0, max(0, need - len(padded))))
    x = torch.from_numpy(padded)
    mels = [fused_mel.fused_log_mel_plain(x[c * 480_000: c * 480_000 + 480_400],
                                          n_mels=n_mels)[:3000] for c in range(n_chunks)]
    return frontends.log10_norm(torch.cat(mels)[:total_frames])


def test_mel_extractor_one_call_a_clip():
    """A 70 s clip: the extractor's one call equals the former per-chunk
    loop bit for bit and the JAX extractor at ATOL; on the CPU nothing
    launches."""
    audio = noise(70 * 16000, seed=7)
    before = dict(fused_mel.LAUNCHES)
    got = tpipeline.MelExtractor(80, device="cpu")(audio)
    assert fused_mel.LAUNCHES == before
    assert torch.equal(got, per_chunk_reference(audio, 80))
    ref = jpipeline.MelExtractor(80)(audio)
    assert tuple(got.shape) == ref.shape == (10000, 80)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("samples", [400, 16_000, 480_400, 480_560, 960_400, 1_441_400])
def test_cpu_branch_in_chunk_slices(samples):
    """On the CPU the wrapper runs the plain version on 30 s slices (3000
    frames each, the last to the end): the frames of one unsliced call."""
    x = torch.from_numpy(noise(samples, seed=samples))
    got = fused_mel.fused_log_mel(x, n_mels=80)
    assert got.shape == (fused_mel.num_frames(samples), 80)
    ref = fused_mel.fused_log_mel_plain(x, n_mels=80)
    assert (got - ref).abs().max() <= 1e-5


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors pass the device rule; the entry point records its
    arguments instead of launching."""
    monkeypatch.setattr(_build, "require_cuda", lambda name, *tensors: tensors[0].device)
    calls = []
    monkeypatch.setattr(fused_mel, "_KERNEL", lambda *a: calls.append(a))
    return calls


@pytest.mark.parametrize("shape, dtype, n_mels", [
    ((399,), torch.float32, 128), ((2, 4000), torch.float32, 128),
    ((4000,), torch.float64, 128), ((4000,), torch.bfloat16, 80),
    ((4000,), torch.float32, 40)])  # 40 mels: bands wider than the kernel unrolls
def test_wrapper_refuses_without_launching(fake_card, shape, dtype, n_mels):
    before = dict(fused_mel.LAUNCHES)
    with pytest.raises(ValueError):
        fused_mel.fused_log_mel(torch.empty(shape, dtype=dtype, device="meta"), n_mels=n_mels)
    assert fake_card == [] and fused_mel.LAUNCHES == before


@pytest.mark.parametrize("offset", [0, 4])
def test_wrapper_launches_once(fake_card, offset):
    """One launch for the whole signal, wherever it starts 16-byte aligned
    (the kernel stages each block's span by one bulk copy)."""
    audio = torch.empty(480_404, device="meta")[offset: offset + 480_400]
    before = fused_mel.LAUNCHES["fused_log_mel"]
    out = fused_mel.fused_log_mel(audio, n_mels=128)
    assert out.shape == (3001, 128)
    assert fused_mel.LAUNCHES["fused_log_mel"] == before + 1
    (args,) = fake_card
    assert args[2] == 480_400 and args[-2:] == (3001, 128)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_wrapper_refuses_a_misaligned_signal(fake_card, offset):
    """A signal that does not start 16-byte aligned is refused before a
    launch, never run by the plain version."""
    audio = torch.empty(480_404, device="meta")[offset: offset + 480_400]
    before = dict(fused_mel.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        fused_mel.fused_log_mel(audio, n_mels=128)
    assert fake_card == [] and fused_mel.LAUNCHES == before


@pytest.mark.parametrize("csrc", [mel_split.CSRC, PARENT], ids=["repository", "parent"])
def test_mel_split_cuts_apply_to_the_sources(csrc):
    """tools/mel_split.py recognises both versions' sources, and each of
    its cuts changes them (its marks all match, or it would refuse)."""
    sources = mel_split.SPLIT.read_sources(csrc)
    name = mel_split.SPLIT.layout(sources)
    versions = mel_split.SPLIT.variants(sources)
    assert list(versions) == ["kernel", *mel_split.LAYOUTS[name]["cuts"], "all cut"]
    assert versions["kernel"] == sources
    for variant, files in versions.items():
        changed = {f for f in files if files[f] != sources[f]}
        assert changed == (set() if variant == "kernel" else {mel_split.SRC}), variant
    assert (mel_split.LAYOUTS[name]["entry"] == "fft") == (csrc == mel_split.CSRC)
