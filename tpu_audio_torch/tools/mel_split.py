#!/usr/bin/env python3
"""Where the Whisper log-mel kernel's time goes on the card: the kernel
against copies of its source with one part taken out, each built by nvcc
into `build/mel_split/` (all at once) and timed by CUDA events in turns, at

  one 30 s chunk with its margins (480,400 samples, 3001 frames) and one
  150 s clip (120 s and Whisper's 30 s of padding: 2,400,400 samples,
  15,001 frames), at n_mels 128 and 80.

Each timed call reads the next of enough copies of the audio (COLD_BYTES)
that more than the 50 MB L2 passes between two calls on one copy: the audio
comes from device memory.

    python3 tpu_audio_torch/tools/mel_split.py [CSRC ...]

Each CSRC, a directory holding a version of `fused_mel.cu` (an older
checkout's `tpu_audio_torch/csrc`, or `tests/data/fused_mel_parent`), is
split in the same call, in turns with the others; with none, the
repository's. Each known version has its own marks and its own C signature
(`LAYOUTS`; the cuts are applied and built by `_split.Split`).

Variants (the cut copies compute wrong outputs; only their time is read):
  kernel               the source as it is (held against the plain version,
                       atol 1e-3);
  f32 FFT              (the FFT kernel) its window products, passes and split
                       in float32 instead of float64 (held against the plain
                       version too);
  launch alone         every block leaves at once;
  no audio staging     the span is not copied into shared memory;
  no DFT arithmetic    the DFT (the parent's basis loop; the FFT passes and
                       the split) is not run;
  no mel projection    a band reads one power value, no sum;
  no log               the sum is stored as it is;
  no stores            the log-mel is computed but not stored;
  all cut              the "no" cuts at once: what the call costs besides.
Each "no" share is `kernel` minus the variant. Beside them: at the clip,
the parent as the per-chunk loop called it (`per chunk`: 5 launches of 3001
frames); the plain version; and, as a yardstick only, `torch.stft` (cuFFT)
of the same frames with |.|^2, the spectrum alone, which the port never
calls.

First, each variant that computes the log-mel (`kernel`, `f32 FFT`) goes
through the dynamic-range gate that `chip_smoke.py` holds the kernel to
(`gate_refs`): its largest |log10 error| from a float64 evaluation on a
loud tone over faint noise and exact zeros, against the plain f32
version's, which the kernel may exceed at most GATE_RATIO times. Prints the card line and, last, one JSON object
of the gate's ratios and the mean times. Needs one CUDA card and nvcc;
imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from tpu_audio_torch.tools import _split  # noqa: E402

CSRC = _split.CSRC
SRC = "fused_mel.cu"
CHUNK = 480_000
MARGIN = 200
SHAPES = {"30 s chunk": CHUNK + 2 * MARGIN, "150 s clip": 5 * CHUNK + 2 * MARGIN}
N_MELS = (128, 80)
COLD_BYTES = 160 << 20  # copies enough that a call finds its audio out of L2
HBM_BYTES_PER_S = 3.35e12
# the dynamic-range gate: the kernel's largest |log10 error| against a
# float64 evaluation at most this many times the plain f32 version's
GATE_RATIO = 1.5

# a mark both versions share
FIRST = "  const int f0 = blockIdx.x * kFrames;\n"
LAUNCH_ALONE = [(SRC, FIRST, "  if (num_frames > 0) return;\n" + FIRST)]

# Per version of the source: its C entry point and each variant as (file,
# old text, new text), every occurrence replaced.
LAYOUTS = {
    "a window-folded DFT basis from L2, a thread a bin, the dense filterbank": {
        "entry": "basis",
        "cuts": {
            "launch alone": LAUNCH_ALONE,
            "no audio staging": [(SRC, "i < span; i += blockDim.x)",
                                  "i < 0 * span; i += blockDim.x)")],
            "no DFT arithmetic": [(SRC, "for (int n = 0; n < n_fft; ++n) {",
                                   "for (int n = 0; n < 0 * n_fft; ++n) {")],
            "no mel projection": [
                (SRC, "for (int k = 0; k < n_bins; ++k) acc = fmaf(p[k], fb[k * n_mels + m], acc);",
                 "acc = p[m];")],
            "no log": [(SRC, "log10f(fmaxf(acc, 1e-10f))", "acc")],
            "no stores": [(SRC, "    out[static_cast<long>(f0 + f) * n_mels + m] = ",
                           "    if (acc == -1234.5f) "
                           "out[static_cast<long>(f0 + f) * n_mels + m] = ")],
        },
    },
    "a bulk-copied span, a Stockham FFT (radix 5, 5, 8) in f64 in shared memory, "
    "the filterbank by bands": {
        "entry": "fft",
        "cuts": {
            "f32 FFT": [(SRC, "using real = double;", "using real = float;")],
            "launch alone": LAUNCH_ALONE,
            "no audio staging": [
                (SRC, "    hp::mbar_arrive_expect_tx(bar, n_samples * 4);\n"
                      "    hp::bulk_load(wav, audio + start, n_samples * 4, bar);\n", ""),
                (SRC, "  wait_bar(bar, 0);\n", "")],
            "no DFT arithmetic": [
                (SRC, "first_pass(wav, window, buf_a, nf);", "first_pass(wav, window, buf_a, 0);"),
                (SRC, "(buf_a, buf_b, tw + kTw2, nf);", "(buf_a, buf_b, tw + kTw2, 0);"),
                (SRC, "(buf_b, buf_a, tw + kTw3, nf);", "(buf_b, buf_a, tw + kTw3, 0);"),
                (SRC, "i < nf * kPairs;", "i < 0 * kPairs;")],
            "no mel projection": [(SRC, "if (c < band.y) acc[f] = fmaf(p[c], w[c], acc[f]);",
                                   "if (c == 0) acc[f] = p[0] + w[0];")],
            "no log": [(SRC, "log10f(fmaxf(acc[f], 1e-10f))", "acc[f]")],
            "no stores": [(SRC, "      out[static_cast<long>(f0 + f) * n_mels + m] = ",
                           "      if (acc[f] == -1234.5f) "
                           "out[static_cast<long>(f0 + f) * n_mels + m] = ")],
        },
    },
}
SPLIT = _split.Split("mel_split", SRC, LAYOUTS)


def computes(variant: str) -> bool:
    """Whether a variant still computes the log-mel (it is not a cut)."""
    return not (variant.startswith("no ") or variant in ("launch alone", "all cut"))


def gate_signals(rng) -> dict:
    """The dynamic-range gate's inputs, as `MelExtractor` pads them (200
    samples of reflect margin each side, one chunk): 30 s of a 440 Hz tone
    at 0.5, a chirp from 50 to 7950 Hz at 1e-2 and noise at 1e-5, with 2 s
    of exact zeros from 12 s; and its first 20 s with zeros to 30 s (a clip
    shorter than a chunk reaches the zero tail)."""
    t = np.arange(30 * 16000) / 16000
    sig = (0.5 * np.sin(2 * np.pi * 440 * t)
           + 1e-2 * np.sin(2 * np.pi * (50 * t + 7900 / 60 * t * t))
           + 1e-5 * rng.standard_normal(t.size))
    sig[12 * 16000: 14 * 16000] = 0.0
    short = np.pad(sig[:20 * 16000], (0, 10 * 16000))
    return {name: np.pad(x.astype(np.float32), (200, 200), mode="reflect")
            for name, x in (("30 s", sig), ("20 s + zeros", short))}


def log_mel_f64(x: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The log-mel of `fused_log_mel` evaluated in float64: the same f32
    window and filterbank values, the DFT's cos/sin in float64."""
    from tpu_audio_torch.ops.kernels import fused_mel

    c = fused_mel._constants(n_mels, x.device)
    n = torch.arange(400, dtype=torch.float64, device=x.device)
    k = torch.arange(201, dtype=torch.float64, device=x.device)
    ang = 2 * math.pi * torch.outer(n, k) / 400
    w = c.window.double()[:, None]
    spec = x.double().unfold(0, 400, 160) @ torch.cat([torch.cos(ang) * w, -torch.sin(ang) * w], 1)
    power = spec[:, :201] ** 2 + spec[:, 201:] ** 2
    return torch.log10(torch.clamp(power @ c.fb.double(), min=1e-10))


def gate_refs(n_mels: int, dev, seed: int = 0) -> tuple[dict, dict, dict]:
    """The gate's signals on `dev` (from `seed`), their float64 log-mel and
    the plain f32 version's largest |log10 error| from it, by signal."""
    from tpu_audio_torch.ops.kernels import fused_mel

    signals = {name: torch.from_numpy(x).to(dev)
               for name, x in gate_signals(np.random.default_rng(seed)).items()}
    exact = {name: log_mel_f64(x, n_mels) for name, x in signals.items()}
    plain = {name: (fused_mel.fused_log_mel_plain(x, n_mels=n_mels).double()
                    - exact[name]).abs().max().item() for name, x in signals.items()}
    return signals, exact, plain


def caller(lib, entry: str, xs, outs, n_mels: int, stream: int):
    """A function of the copy index that calls version `lib` on that copy
    of the audio, into that copy's output."""
    from tpu_audio_torch.ops.kernels import fused_mel

    P, I = ctypes.c_void_p, ctypes.c_int
    n = xs[0].shape[0]
    frames = outs[0].shape[0]
    fn = lib.tpa_fused_log_mel
    fn.restype = ctypes.c_int
    c = fused_mel._constants(n_mels, xs[0].device)
    if entry == "basis":
        fn.argtypes = [P, I, P, P, P, I, I, I, I, P]

        def call(i: int):
            return fn(xs[i].data_ptr(), n, c.basis.data_ptr(), c.fb.data_ptr(),
                      outs[i].data_ptr(), frames, 400, 160, n_mels, stream)
    else:
        fn.argtypes = [P, I, P, P, P, P, P, I, I, P]

        def call(i: int):
            return fn(xs[i].data_ptr(), n, c.window.data_ptr(), c.twiddles.data_ptr(),
                      c.bands.data_ptr(), c.weights.data_ptr(), outs[i].data_ptr(), frames,
                      n_mels, stream)

    def checked(i: int):
        rc = call(i)
        if rc:
            raise RuntimeError(f"mel_split: CUDA error {rc}")
        return outs[i]
    return checked


def per_chunk(lib, xs, outs, n_mels: int, stream: int):
    """The parent as the per-chunk loop called it: a launch a 30 s chunk
    with its margins, 3001 frames each, into the clip's rows."""
    chunks = (xs[0].shape[0] - 2 * MARGIN) // CHUNK
    chunk_x = [[x[c * CHUNK: (c + 1) * CHUNK + 2 * MARGIN] for c in range(chunks)] for x in xs]
    chunk_out = [[o[c * 3000: c * 3000 + 3001] for c in range(chunks)] for o in outs]
    calls = [caller(lib, "basis", [cx[c] for cx in chunk_x], [co[c] for co in chunk_out],
                    n_mels, stream) for c in range(chunks)]

    def call(i: int):
        for c in calls:
            c(i)
        return outs[i]
    return call


def spectrum(xs, window):
    """torch.stft (cuFFT) of the same frames, |.|^2: the yardstick."""
    def call(i: int):
        s = torch.stft(xs[i], 400, 160, window=window, center=False, return_complex=True)
        return torch.view_as_real(s).square().sum(-1)
    return call


def gate(libs: dict, entry: dict, dev, stream: int) -> dict:
    """Each variant that computes the log-mel through the dynamic-range
    gate, at each n_mels: its largest |log10 error| from float64 over the
    plain f32 version's, by signal (within the gate at most GATE_RATIO)."""
    from tpu_audio_torch.ops.kernels import fused_mel

    ratios = {}
    for n_mels in N_MELS:
        signals, exact, plain = gate_refs(n_mels, dev)
        for key, lib in libs.items():
            if not computes(key[1]):
                continue
            errs = {}
            for name, x in signals.items():
                out = torch.full((fused_mel.num_frames(x.numel()), n_mels), float("nan"),
                                 device=dev)
                got = caller(lib, entry[key], [x], [out], n_mels, stream)(0)
                errs[name] = (got.double() - exact[name]).abs().max().item()
            q = {name: errs[name] / plain[name] for name in errs}
            ratios[f"{key[0]} {key[1]} {n_mels}"] = q
            within = all(v <= GATE_RATIO for v in q.values())
            print(f"mel_split gate {key[0]} {key[1]} n_mels {n_mels}: " + ", ".join(
                f"{name} max |d log10| {errs[name]:.4e} (plain f32 {plain[name]:.4e}, ratio "
                f"{q[name]:.4f})" for name in errs)
                + (" within" if within else " OUTSIDE") + f" the gate's {GATE_RATIO}", flush=True)
    return ratios


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mel_split: no CUDA device available")
    from tpu_audio_torch.ops.kernels import fused_mel

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dirs = [Path(a) for a in sys.argv[1:]] or [CSRC]
    versions, kinds = {}, {}
    for d in dirs:
        sources = SPLIT.read_sources(d)
        kinds[str(d)] = SPLIT.layout(sources)
        print(f"mel_split: {d}: {kinds[str(d)]}", flush=True)
        for name, files in SPLIT.variants(sources).items():
            versions[(str(d), name)] = files
    libs = SPLIT.build(versions)
    entry = {key: LAYOUTS[kinds[key[0]]]["entry"] for key in libs}
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = {"gate": gate(libs, entry, dev, stream), "ms": {}}
    for (label, n), n_mels in itertools.product(SHAPES.items(), N_MELS):
        frames = fused_mel.num_frames(n)
        copies = max(2, -(-COLD_BYTES // (4 * (n + frames * n_mels))))
        gen = torch.Generator(device=dev).manual_seed(n + n_mels)
        xs = [torch.randn(n, generator=gen, device=dev) * 0.1 for _ in range(copies)]
        outs = [torch.empty((frames, n_mels), device=dev) for _ in range(copies)]
        calls = {key: caller(lib, entry[key], xs, outs, n_mels, stream)
                 for key, lib in libs.items()}
        if label == "150 s clip":
            for d in dirs:
                if entry[(str(d), "kernel")] == "basis":
                    calls[(str(d), "per chunk")] = per_chunk(libs[(str(d), "kernel")], xs, outs,
                                                             n_mels, stream)
        plain = fused_mel.fused_log_mel_plain(xs[1], n_mels=n_mels)
        for key in calls:
            if not computes(key[1]):
                continue
            outs[1].fill_(float("nan"))
            got = calls[key](1).clone()
            torch.cuda.synchronize()
            err = (got - plain).abs().max().item()
            if not err <= 1e-3:
                raise AssertionError(f"mel_split {key} {label} {n_mels}: max |kernel - plain| "
                                     f"{err:.3e} > 1e-3")
        window = torch.hann_window(400, periodic=False, device=dev)
        extra_calls = {"plain": lambda i: fused_mel.fused_log_mel_plain(xs[i], n_mels=n_mels),
                       "torch.stft |.|^2": spectrum(xs, window)}
        names = list(calls)
        times = {key: [] for key in names}
        for order in (names, names[::-1]):
            for key in order:
                cycle = itertools.cycle(range(copies))
                times[key].append(_split.time_ms(lambda key=key, cycle=cycle:
                                                 calls[key](next(cycle)), 50))
        extra = {}
        for name, fn in extra_calls.items():
            cycle = itertools.cycle(range(copies))
            extra[name] = _split.time_ms(lambda fn=fn, cycle=cycle: fn(next(cycle)), 20)
        c = fused_mel._constants(n_mels, dev)
        n_bytes = 4 * (n + frames * n_mels) + sum(
            t.numel() * t.element_size() for t in (c.window, c.twiddles, c.bands, c.weights))
        bound_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
        for d in dict.fromkeys(k[0] for k in names):
            ms = {v: sum(times[(k, v)]) / 2 for k, v in names if k == d}
            results["ms"][f"{d} {label} {n_mels}"] = {**ms, **extra, "bound": bound_ms}
            print(f"mel_split {d} {label} ({n} samples, {frames} frames) n_mels {n_mels}: kernel "
                  f"{ms['kernel']:.4f} ms (bound {bound_ms:.4f}, bytes); " + ", ".join(
                      f"{v} {ms[v]:.4f}" + (f" (share {ms['kernel'] - ms[v]:.4f})"
                                            if v.startswith("no ") else "")
                      for v in ms if v != "kernel")
                  + "".join(f", {k} {t:.4f}" for k, t in extra.items()) + f" ({card})",
                  flush=True)
        del xs, outs, calls, plain
    print(json.dumps({"card": card, "versions": kinds, **results}), flush=True)


if __name__ == "__main__":
    main()
