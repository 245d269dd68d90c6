#!/usr/bin/env python3
"""Where the q4/q8 dequant-matmul's time goes on the card: the kernel
against copies of its sources with one part taken out, each built by nvcc
into `build/quant_split/` (all at once) and timed by CUDA events in turns,
q4, f32 activations, at 1, 16 and 32 rows, at

  the eight linear shapes of the q4 decoders (Whisper large-v3-turbo's
  q, k, v, o and cross q, o 1280 x 1280, fc1 5120 x 1280, fc2 1280 x 5120;
  Qwen3-0.6B's q 2048 x 1024, k and v 1024 x 1024, o 1024 x 2048, gate and
  up 3072 x 1024, down 1024 x 3072) and the two heads (Whisper's 51866 x
  1280, Qwen3-0.6B's tied 151936 x 1024).

Each timed call reads the next of enough stacked copies of the weights that
they come from device memory, as in a forward, and not from the 50 MB L2.

    python3 tpu_audio_torch/tools/quant_split.py [CSRC ...]

Each CSRC, a directory holding a version of `quant_matmul.cu` and its
headers (an older checkout's `tpu_audio_torch/csrc`), is split in the same
call, in turns with the others; with none, the repository's. Each known
version has its own marks and its own C signature (`LAYOUTS`).

Variants (the cut copies compute wrong outputs; only their time is read):
  kernel                 the sources as they are (held against the plain
                         version within rel 1e-4);
  launch alone           the blocks leave at once;
  no activation staging  the activations are not staged in shared memory
                         (what the products read there is left as it is);
  no weight loads        no packed weight is read from device memory (the
                         arithmetic stays);
  no scale/bias loads    no group scale or bias is read;
  all cut                the three "no" cuts at once: what the call costs
                         besides.
Each "no" share is `kernel` minus the variant. Prints the card line and, last,
one JSON object of the mean times. Needs one CUDA card and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "tpu_audio_torch" / "csrc"
OUT = ROOT / "build" / "quant_split"
SRC = "quant_matmul.cu"
SPIN_CYCLES = 50_000_000
SHAPES = {"whisper q, k, v, o, cross q, o": (1280, 1280), "whisper fc1": (5120, 1280),
          "whisper fc2": (1280, 5120), "qwen3 q": (2048, 1024), "qwen3 k, v": (1024, 1024),
          "qwen3 o": (1024, 2048), "qwen3 gate, up": (3072, 1024),
          "qwen3 down": (1024, 3072), "whisper head": (51866, 1280),
          "qwen3 head": (151936, 1024)}
ROWS = (1, 16, 32)
BITS = 4
GROUP = 64
COLD_BYTES = 160 << 20  # copies enough that a call finds its weights out of L2

# Per version of the sources: its C entry point ("f32": x f32 only, rows
# in passes of 8 by the host; "typed": x f32 or bf16 with its flag and its
# row stride) and each cut as (file, old text, new text),
# every occurrence replaced. A version is recognised when every mark is
# found.
LAYOUTS = {
    "one warp a channel group, rows in passes of 8, activations staged first": {
        "entry": "f32",
        "cuts": {
            "launch alone": [(SRC, "  extern __shared__ float smem[];\n  const int nv = I / cpv;",
                              "  extern __shared__ float smem[];\n  if (B > 0) return;\n"
                              "  const int nv = I / cpv;")],
            "no activation staging": [
                (SRC, "e < kRows * I; e += kThreads)", "e < 0 * kRows * I; e += kThreads)"),
                (SRC, "e < kRows * nv; e += kThreads)", "e < 0 * kRows * nv; e += kThreads)")],
            "no weight loads": [(SRC, "raw[r] = __ldcs(rows[r] + v);",
                                 "raw[r] = make_int4(v, r, lane, o0);")],
            "no scale/bias loads": [
                (SRC, "const float s = __ldg(scales + oi), bias = __ldg(biases + oi);",
                 "const float s = static_cast<float>(oi), bias = static_cast<float>(v);")],
        },
    },
    "a producer warp streams spans of 16-channel tiles; one launch, mma.sync on x's terms": {
        "entry": "typed",
        "cuts": {
            "launch alone": [(SRC, "  if (S > 1) hp::cluster_arrive();  // this block runs;",
                              "  if (pl.B > 0) return;\n"
                              "  if (S > 1) hp::cluster_arrive();  // this block runs;")],
            # griddepcontrol.wait stays
            "no activation staging": [(SRC, "u0 < total; u0 += K * kConsumers)",
                                       "u0 < 0 * total; u0 += K * kConsumers)")],
            # no copy, and the stage's barrier expects none of their bytes
            "no weight loads": [
                (SRC, "static_cast<uint32_t>(n * gs * bpg + ",
                 "static_cast<uint32_t>(0 * n * gs * bpg + "),
                (SRC, "        for (int r = 0; r < n; ++r)\n          hp::bulk_load(",
                 "        for (int r = 0; r < 0; ++r)\n          hp::bulk_load(")],
            "no scale/bias loads": [
                (SRC, "gs * bpg + 2 * bulk));", "gs * bpg + 0 * bulk));"),
                (SRC, "        if (bulk > 0) {", "        if (false) {"),
                (SRC, "      for (int e = bulk / 4 + lane; e < n * gs; e += 32) {",
                 "      for (int e = 0; e < 0; e += 32) {")],
        },
    },
}


def layout(sources: dict) -> str:
    """The name of the version whose marks all match `sources` (file → text)."""
    for name, spec in LAYOUTS.items():
        if all(old in sources.get(f, "")
               for edits in spec["cuts"].values() for f, old, _ in edits):
            return name
    raise RuntimeError("quant_split: the sources match no known version's marks")


def variants(sources: dict) -> dict:
    """The sources (file → text) and the cut copies, by variant name."""
    cuts = LAYOUTS[layout(sources)]["cuts"]

    def apply(text_of: dict, edits) -> dict:
        out = dict(text_of)
        for f, old, new in edits:
            out[f] = out[f].replace(old, new)
        return out

    out = {"kernel": sources}
    for name, edits in cuts.items():
        out[name] = apply(sources, edits)
    out["all cut"] = apply(sources, [e for name, edits in cuts.items() if name.startswith("no ")
                                     for e in edits])
    return out


def read_sources(csrc: Path) -> dict:
    return {p.name: p.read_text() for p in sorted(csrc.glob("*.cu*"))
            if p.suffix == ".cuh" or p.name == SRC}


def build(versions: dict) -> dict:
    """One nvcc process a (version, variant), all at once; returns the entry
    points by (version, variant)."""
    sys.path.insert(0, str(ROOT))
    from tpu_audio_torch.ops.kernels import _build

    procs = {}
    for i, (key, files) in enumerate(versions.items()):
        d = OUT / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f, text in files.items():
            (d / f).write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "k.so"),
               str(d / SRC)]
        procs[key] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    entries = {}
    for key, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"quant_split: nvcc failed for {key}:\n{log[-4000:]}")
        if key[1] == "kernel":
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {key[0]}: {line.strip()}", flush=True)
        fn = ctypes.CDLL(str(d / "k.so")).tpa_quant_matmul
        fn.restype = ctypes.c_int
        entries[key] = fn
    return entries


def time_ms(fn, iters: int = 40) -> float:
    """Mean device time of fn() behind a spin kernel, after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def case(o: int, i: int, rows: int, dev):
    """A cold-cache case: (x, stacked packed words, scales, biases, the
    number of copies). Random codes; scales and biases of a q4 group of
    weights of std i^-0.5."""
    gen = torch.Generator(device=dev).manual_seed(o + i + rows)
    per_copy = o * i * BITS // 8 + o * (i // GROUP) * 8
    layers = max(2, -(-COLD_BYTES // per_copy))
    w = torch.randint(-2 ** 31, 2 ** 31 - 1, (layers, o, i * BITS // 32), generator=gen,
                      device=dev, dtype=torch.int32)
    scales = (torch.rand((layers, o, i // GROUP), generator=gen, device=dev) + 0.5) \
        * (0.4 * i ** -0.5)
    biases = -7.5 * scales + torch.randn((layers, o, i // GROUP), generator=gen,
                                         device=dev) * (0.1 * i ** -0.5)
    x = torch.randn((rows, i), generator=gen, device=dev)
    return x, w, scales, biases, layers


def caller(fn, entry: str, x, w, scales, biases, stream: int):
    """A function of the copy index that calls entry `fn` on that copy,
    the output allocated once."""
    rows, i = x.shape
    o = w.shape[1]
    out = torch.empty((rows, o), device=x.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    if entry == "f32":
        fn.argtypes = [P, P, P, P, P, I, I, I, I, P]
        lead = (x.data_ptr(),)
        tail = ()
    else:
        fn.argtypes = [P, I, ctypes.c_long, P, P, P, P, I, I, I, I, P]
        lead = (x.data_ptr(), 0, i)
        tail = ()

    def call(layer: int):
        rc = fn(*lead, w[layer].data_ptr(), scales[layer].data_ptr(),
                biases[layer].data_ptr(), out.data_ptr(), rows, i, o, BITS, *tail, stream)
        if rc:
            raise RuntimeError(f"quant_split: CUDA error {rc}")
        return out
    return call


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("quant_split: no CUDA device available")
    sys.path.insert(0, str(ROOT))
    from tpu_audio_torch.ops.kernels import quant_matmul as qmm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dirs = [Path(a) for a in sys.argv[1:]] or [CSRC]
    versions, kinds = {}, {}
    for d in dirs:
        sources = read_sources(d)
        kinds[str(d)] = layout(sources)
        print(f"quant_split: {d}: {kinds[str(d)]}", flush=True)
        for name, files in variants(sources).items():
            versions[(str(d), name)] = files
    entries = build(versions)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = {}
    for (label, (o, i)), rows in itertools.product(SHAPES.items(), ROWS):
        x, w, scales, biases, layers = case(o, i, rows, dev)
        calls = {key: caller(fn, LAYOUTS[kinds[key[0]]]["entry"], x, w, scales, biases, stream)
                 for key, fn in entries.items()}
        plain = qmm.quant_matmul_plain(x, w[1], scales[1], biases[1], bits=BITS)
        for key, call in calls.items():
            if key[1] == "kernel":
                got = call(1).clone()
                torch.cuda.synchronize()
                rel = ((got - plain).abs().max() / plain.abs().max()).item()
                if not rel <= 1e-4:
                    raise AssertionError(f"quant_split {key[0]} {label} {rows}: the kernel "
                                         f"differs from plain: rel {rel:.3e}")
        del plain
        names = list(calls)
        times = {key: [] for key in names}
        for order in (names, names[::-1]):
            for key in order:
                cycle = itertools.cycle(range(layers))
                times[key].append(time_ms(lambda key=key, cycle=cycle: calls[key](next(cycle))))
        bound_ms = 1e3 * (x.numel() * 4 + o * i * BITS // 8 + o * (i // GROUP) * 8
                          + rows * o * 4) / 3.35e12
        for d in dict.fromkeys(k[0] for k in names):
            ms = {v: sum(times[(d, v)]) / 2 for k, v in names if k == d}
            results[f"{d} {label} {rows}"] = ms
            print(f"quant_split {d} {label} ({o}, {i}) rows {rows}: kernel "
                  f"{ms['kernel']:.4f} ms (bound {bound_ms:.4f}); " + ", ".join(
                      f"{v} {ms[v]:.4f}" + (f" (share {ms['kernel'] - ms[v]:.4f})"
                                            if v.startswith("no ") else "")
                      for v in ms if v != "kernel") + f" ({card})", flush=True)
        del x, w, scales, biases, calls
    print(json.dumps({"card": card, "versions": kinds, "ms": results}), flush=True)


if __name__ == "__main__":
    main()
