#!/usr/bin/env python3
"""Where the W4A8 decode matmul's time goes on the card: the kernel against
copies of its sources with one part taken out, each built by nvcc into
`build/w4a8_split/` (all at once) and timed by CUDA events in turns at the
four shapes of a Llama-3.2-3B layer (qkv 5120 x 3072, o 3072 x 3072,
gateup 16384 x 3072, down 3072 x 8192), at 1 and 8 rows of f32
activations, in both formats (pair: codes with f32 scales and biases per 64
columns; super-group: codes with one f32 scale per 256 columns). Each
timed call reads the next of enough stacked layers that the weights come
from device memory, as in a forward, and not from the 50 MB L2.

    python3 tpu_audio_torch/tools/w4a8_split.py [CSRC ...]

Each CSRC, a directory holding a version of `w4a8_matmul.cu` and its
headers (an older checkout's `tpu_audio_torch/csrc`), is split in the same
call, in turns with the others; with none, the repository's. Each known
version has its own marks and its own C signature (`LAYOUTS`).

Variants (the cut copies compute wrong outputs; only their time is read):
  kernel                 the sources as they are (held against the plain
                         version within rel 1e-5);
  rows alone             only the activation rows' quantisation runs (the
                         two-launch version: its first kernel; the current
                         one: at one row each block's quantisation, above
                         the rows kernel and the products' wait and copy of
                         the codes, then the blocks leave);
  no activation staging  the products do not quantise or copy the rows
                         (the codes and group sums they read are left as
                         they are in shared memory; a rows kernel still
                         runs);
  no weight loads        the products read no weight code from device
                         memory (the arithmetic stays);
  no scale/bias loads    the epilogue reads no group scale or bias;
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
OUT = ROOT / "build" / "w4a8_split"
SRC = "w4a8_matmul.cu"
SPIN_CYCLES = 50_000_000
SHAPES = {"qkv": (5120, 3072), "o": (3072, 3072), "gateup": (16384, 3072), "down": (3072, 8192)}
ROWS = (1, 8)
COLD_BYTES = 160 << 20  # layers enough that a call finds its weights out of L2

# Per version of the sources: its C entry point's scratch ("workspace":
# True, the two-launch version's xq, sx, xsum and xqs; False, one buffer of
# tpa_w4a8_work_bytes) and each cut as (file, old text, new text), every occurrence replaced. A
# version is recognised when every mark is found.
LAYOUTS = {
    "two launches: a rows kernel, then the dp4a GEMV on rows staged in shared memory": {
        "workspace": True,
        "cuts": {
            "rows alone": [(SRC, "  if (err != cudaSuccess) return static_cast<int>(err);\n"
                                 "  const int G = I / kGroup;",
                            "  return static_cast<int>(err);\n  const int G = I / kGroup;")],
            "no activation staging": [
                (SRC, "e < kRows * words; e += kThreads)", "e < 0 * kRows * words; e += kThreads)"),
                (SRC, "e < kRows * G; e += kThreads)", "e < 0 * kRows * G; e += kThreads)")],
            "no weight loads": [(SRC, "on ? __ldcs(rows[r] + 4 * p + q) : make_int4(0, 0, 0, 0)",
                                 "make_int4(p, q, r, lane)")],
            "no scale/bias loads": [
                (SRC, "__ldg(scales + orow[r] * NS + (p >> 1))", "static_cast<float>(p)"),
                (SRC, "__ldg(reinterpret_cast<const float2*>(scales + orow[r] * G) + p)",
                 "make_float2(p, r)"),
                (SRC, "__ldg(reinterpret_cast<const float2*>(biases + orow[r] * G) + p)",
                 "make_float2(r, p)")],
        },
    },
    "a producer warp streams the tiles; one launch at one row, above a rows kernel first": {
        "workspace": False,
        "cuts": {
            # the producer issues nothing, so the block may leave after its rows
            "rows alone": [
                (SRC, "    if (kPDL) issue(0);\n", "\n"),
                (SRC, "    for (int j = kPDL ? 1 : 0; j < items; ++j) issue(j);",
                 "    for (int j = 0; j < 0; ++j) issue(j);"),
                (SRC, "  hp::named_barrier(kBarConsumers, kConsumers);\n\n  const int ra = 2 * t;",
                 "  hp::named_barrier(kBarConsumers, kConsumers);\n  return;\n  const int ra = 2 * t;")],
            # the producer still waits for the consumers' signal
            "no activation staging": [
                (SRC, "  stage_rows(0, min(pl.rows, pl.B));\n  if (kPDL) asm",
                 "  if (false) stage_rows(0, min(pl.rows, pl.B));\n  if (true) asm")],
            # no copy, and the stage's barrier expects none of their bytes
            "no weight loads": [
                (SRC, "static_cast<uint32_t>(n * 64 * np + ", "static_cast<uint32_t>(0 * n * 64 * np + "),
                (SRC, "      for (int r = 0; r < n; ++r)\n        hp::bulk_load(",
                 "      for (int r = 0; r < 0; ++r)\n        hp::bulk_load(")],
            "no scale/bias loads": [
                (SRC, "(SG ? 1 : 2) * bulk));", "0 * (SG ? 1 : 2) * bulk));"),
                (SRC, "      if (bulk > 0) {", "      if (false) {"),
                (SRC, "    for (int e = bulk / 4 + lane; e < n * ng; e += 32) {",
                 "    for (int e = 0; e < 0; e += 32) {")],
        },
    },
}


def layout(sources: dict) -> str:
    """The name of the version whose marks all match `sources` (file → text)."""
    for name, spec in LAYOUTS.items():
        if all(old in sources.get(f, "")
               for edits in spec["cuts"].values() for f, old, _ in edits):
            return name
    raise RuntimeError("w4a8_split: the sources match no known version's marks")


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
            raise RuntimeError(f"w4a8_split: nvcc failed for {key}:\n{log[-4000:]}")
        if key[1] == "kernel":
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {key[0]}: {line.strip()}", flush=True)
        fn = ctypes.CDLL(str(d / "k.so")).tpa_w4a8_matmul
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


def case(o: int, i: int, rows: int, sg: bool, dev):
    """A cold-cache case: (x, stacked codes, per-layer scales and biases,
    the number of layers)."""
    gen = torch.Generator(device=dev).manual_seed(o + i + rows + sg)
    layers = max(2, -(-COLD_BYTES // (o * i // 2)))
    w = torch.randint(-128, 128, (layers, o, i // 2), generator=gen, device=dev,
                      dtype=torch.int8)
    n = i // (256 if sg else 64)
    scales = torch.rand((layers, o, n), generator=gen, device=dev) * 1e-2 + 1e-3
    biases = None if sg else torch.randn((layers, o, n), generator=gen, device=dev) * 1e-2
    x = torch.randn((rows, i), generator=gen, device=dev)
    x[:, :64] += 3.0
    return x, w, scales, biases, layers


def caller(fn, workspace: bool, x, w, scales, biases, sg: bool, stream: int):
    """A function of the layer that calls entry `fn` on it, output and
    scratch allocated once."""
    rows, i = x.shape
    layers, o, _ = w.shape
    dev = x.device
    out = torch.empty((rows, o), device=dev)
    if workspace:
        scratch = [torch.empty((rows, i), dtype=torch.int8, device=dev),
                   torch.empty((rows,), device=dev), torch.empty((rows, i // 64), device=dev),
                   torch.empty((rows, i // 64), dtype=torch.int32, device=dev)]
    else:
        scratch = [torch.empty(4 * rows * i, dtype=torch.uint8, device=dev)]  # ample
    ptr = [t.data_ptr() for t in scratch]
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * (len(ptr) + 1)
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])

    def call(layer: int):
        b = 0 if sg else biases[layer].data_ptr()
        rc = fn(x.data_ptr(), 0, w.data_ptr(), scales[layer].data_ptr(), b, int(sg), *ptr,
                out.data_ptr(), rows, i, o, layer, stream)
        if rc:
            raise RuntimeError(f"w4a8_split: CUDA error {rc}")
        return out
    return call


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("w4a8_split: no CUDA device available")
    sys.path.insert(0, str(ROOT))
    from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dirs = [Path(a) for a in sys.argv[1:]] or [CSRC]
    versions, kinds = {}, {}
    for d in dirs:
        sources = read_sources(d)
        kinds[str(d)] = layout(sources)
        print(f"w4a8_split: {d}: {kinds[str(d)]}", flush=True)
        for name, files in variants(sources).items():
            versions[(str(d), name)] = files
    entries = build(versions)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = {}
    for (label, (o, i)), rows, sg in itertools.product(SHAPES.items(), ROWS, (False, True)):
        fmt = "sg" if sg else "pair"
        x, w, scales, biases, layers = case(o, i, rows, sg, dev)
        calls = {key: caller(fn, LAYOUTS[kinds[key[0]]]["workspace"], x, w, scales, biases, sg,
                             stream) for key, fn in entries.items()}
        plain = (w4mm.w4a8_sg_matmul_plain(x, w[1], scales[1]) if sg
                 else w4mm.w4a8_matmul_plain(x, w[1], scales[1], biases[1]))
        for key, call in calls.items():
            if key[1] == "kernel":
                got = call(1).clone()
                torch.cuda.synchronize()
                rel = ((got - plain).abs().max() / plain.abs().max()).item()
                if not rel <= 1e-5:
                    raise AssertionError(f"w4a8_split {key[0]} {label} {fmt} {rows}: the "
                                         f"kernel differs from plain: rel {rel:.3e}")
        names = list(calls)
        times = {key: [] for key in names}
        for order in (names, names[::-1]):
            for key in order:
                cycle = itertools.cycle(range(layers))
                times[key].append(time_ms(lambda key=key, cycle=cycle: calls[key](next(cycle))))
        for d in dict.fromkeys(k[0] for k in names):
            ms = {v: sum(times[(d, v)]) / 2 for k, v in names if k == d}
            results[f"{d} {label} {fmt} {rows}"] = ms
            print(f"w4a8_split {d} {label} ({o}, {i}) {fmt} rows {rows}: kernel "
                  f"{ms['kernel']:.4f} ms; " + ", ".join(
                      f"{v} {ms[v]:.4f}" + (f" (share {ms['kernel'] - ms[v]:.4f})"
                                            if v.startswith("no ") else "")
                      for v in ms if v != "kernel") + f" ({card})", flush=True)
        del x, w, scales, biases, calls
    print(json.dumps({"card": card, "versions": kinds, "ms": results}), flush=True)


if __name__ == "__main__":
    main()
