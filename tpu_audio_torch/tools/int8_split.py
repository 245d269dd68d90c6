#!/usr/bin/env python3
"""Where the W8A8 weight-streaming matmul's time goes on the card: the
kernel against copies of its sources with one part taken out, each built by
nvcc into `build/int8_split/` (all at once) and timed by CUDA events in
turns, at 1, 4, 16 and 32 rows of f32 and of bf16 activations, at

  Whisper large-v3-turbo's decoder linears (q, k, v, o and cross q, o
  1280 x 1280, fc1 5120 x 1280, fc2 1280 x 5120) and its tied head 51866 x
  1280, Qwen3-0.6B's int8 head 151936 x 1024, and Llama-3.2-3B's down
  projection 3072 x 8192.

Each timed call reads the next of enough stacked copies of the weights
(COLD_BYTES) that more than the 50 MB L2 passes between two calls on one
copy: the weights come from device memory, as in a decoder step, where the
other layers' weights stream through L2 between two calls of one layer.

    python3 tpu_audio_torch/tools/int8_split.py [--quick] [CSRC ...]

Each CSRC, a directory holding a version of `int8_matmul.cu` and its
headers (an older checkout's `tpu_audio_torch/csrc`, or
`tests/data/int8_matmul_parent`), is split in the same call, in turns with
the others; with none, the repository's. Each known version has its own
marks and its own C signature (`LAYOUTS`). `--quick` times Whisper's
1280 x 1280, fc2 and head and Qwen3's head at 1 and 16 rows of bf16 only.

A version is called as `ops/quant.int8_linear` calls it: "typed" (one
launch) with the output in x's dtype and, at the layer shapes, a bf16 or
f32 bias added in the epilogue; "f32" (a rows kernel, then the products:
two launches or more) with an f32 output, to which `int8_linear` adds a
cast and a bias on a bf16 tree, timed apart ("cast + bias").

Variants (the cut copies compute wrong outputs; only their time is read):
  kernel                 the sources as they are (held against the plain
                         version: bit for bit for "typed", rel 1e-5 for "f32");
  launch alone           every block leaves at once;
  rows kernel alone      ("f32") the products' blocks leave at once;
  no row quantisation    the rows are not read nor coded ("typed": the
                         slices' exchange of their row maxima stays);
  no code staging        ("f32") the products do not copy the codes in;
  no weight loads        no weight byte is read from device memory (the
                         arithmetic stays);
  no epilogue stores     the outputs are computed but not stored;
  no codes               ("typed") the rows' |max| taken, no code made;
  codes by a product     ("typed") no IEEE quotient near a half-integer;
  a copy a row           ("typed") a head's tile staged a row a copy, padded;
  all cut                the "no" cuts at once: what the call costs besides.
Each "no" share is `kernel` minus the variant. For "typed", the kernel is
also timed at each other count of column slices it can take (`C=n`).
At 32 rows, `torch._int_mm` of the codes against the weight (the product
alone) and `int8_matmul_bigm` (the port's path above 32 rows) are timed
beside them. Prints the card line and, last, one JSON object of the mean
times. Needs one CUDA card and nvcc; imports nothing of JAX.
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
OUT = ROOT / "build" / "int8_split"
SRC = "int8_matmul.cu"
PRODUCTS = "  extern __shared__ int4 xs[];  // kRows x I int8 codes\n"  # the parent's products
SPIN_CYCLES = 50_000_000
# (O, I), and whether the linear carries a bias
SHAPES = {"whisper q, k, v, o, cross q, o": (1280, 1280, True),
          "whisper fc1": (5120, 1280, True), "whisper fc2": (1280, 5120, True),
          "whisper head": (51866, 1280, False), "qwen3 head": (151936, 1024, False),
          "llama-3.2-3b down": (3072, 8192, False)}
ROWS = (1, 4, 16, 32)
X_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
COLD_BYTES = 160 << 20  # copies enough that a call finds its weights out of L2

# Per version of the sources: its C entry point and each cut as (file, old
# text, new text), every occurrence replaced. A version is recognised when
# every mark is found.
LAYOUTS = {
    "two launches: a rows kernel, then a warp a channel with __dp4a": {
        "entry": "f32",
        "cuts": {
            "launch alone": [
                (SRC, "  __shared__ float scratch[kWarps];\n  const long base",
                 "  __shared__ float scratch[kWarps];\n  if (I > 0) return;\n  const long base"),
                (SRC, PRODUCTS, PRODUCTS + "  if (B > 0) return;\n")],
            "rows kernel alone": [
                (SRC, PRODUCTS, PRODUCTS + "  if (B > 0) return;\n")],
            "no row quantisation": [
                (SRC, "  __shared__ float scratch[kWarps];\n  const long base",
                 "  __shared__ float scratch[kWarps];\n  if (I > 0) return;\n  const long base")],
            "no code staging": [(SRC, "v < kRows * n16; v += kThreads)",
                                 "v < 0 * kRows * n16; v += kThreads)")],
            "no weight loads": [(SRC, "wv[r] = __ldcs(rows[r] + v);",
                                 "wv[r] = make_int4(v, r, lane, o0);")],
            "no epilogue stores": [(SRC, "if (lane == (b & 31) && b < B && o < O)",
                                    "if (lane == (b & 31) && b < B && o < O && s == -2147483647)")],
        },
    },
    "one launch: a producer warp streams 16-channel tiles, rows quantised inside, "
    "mma.sync s8, the cast and bias in the epilogue": {
        "entry": "typed",
        "cuts": {
            "launch alone": [(SRC, "  if (C > 1) hp::cluster_arrive();  // this block runs;",
                              "  if (pl.B > 0) return;\n"
                              "  if (C > 1) hp::cluster_arrive();  // this block runs;")],
            "no row quantisation": [(SRC, "for (int it0 = 0; it0 < iters; it0 += kHold) {",
                                     "for (int it0 = 0; it0 < 0 * iters; it0 += kHold) {")],
            # no copy, and the stage's barrier expects none of their bytes
            "no weight loads": [
                (SRC, "static_cast<uint32_t>(n * kb)", "static_cast<uint32_t>(0 * n * kb)"),
                (SRC, "      if (pl.ws == pl.I) {  // the tile's rows", "      if (false) {  //"),
                (SRC, "      } else if (lane < n) {", "      } else if (lane < 0) {")],
            "no epilogue stores": [(SRC, "    if (o >= pl.O) return;",
                                    "    if (o >= pl.O || acc != -2147483647) return;")],
            "no codes": [(SRC, "if (it0 + q < iters && u < total) {\n        const int b = row_of(",
                          "if (it0 + q < 0 && u < total) {\n        const int b = row_of(")],
            "codes by a product": [(SRC, "  if (tie)\n#pragma unroll",
                                    "  if (false)\n#pragma unroll")],
            "a copy a row": [(SRC, "pl.ws = C == 1 && pl.wide && B <= 8 ? I : pl.rs;",
                              "pl.ws = pl.rs;")],

        },
    },
}


def layout(sources: dict) -> str:
    """The name of the version whose marks all match `sources` (file → text)."""
    for name, spec in LAYOUTS.items():
        if all(old in sources.get(f, "")
               for edits in spec["cuts"].values() for f, old, _ in edits):
            return name
    raise RuntimeError("int8_split: the sources match no known version's marks")


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
    """`int8_matmul.cu` and the headers of `csrc`, and the repository's
    headers that `csrc` lacks (a kept copy of the source alone)."""
    files = {p.name: p.read_text() for p in sorted(csrc.glob("*.cu*"))
             if p.suffix == ".cuh" or p.name == SRC}
    for p in sorted(CSRC.glob("*.cuh")):
        files.setdefault(p.name, p.read_text())
    return files


def build(versions: dict) -> dict:
    """One nvcc process a (version, variant), all at once; returns the
    libraries by (version, variant)."""
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
    libs = {}
    for key, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"int8_split: nvcc failed for {key}:\n{log[-4000:]}")
        if key[1] == "kernel":
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {key[0]}: {line.strip()}", flush=True)
        libs[key] = ctypes.CDLL(str(d / "k.so"))
    return libs


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


def case(o: int, i: int, rows: int, dtype: torch.dtype, with_bias: bool, dev):
    """A cold-cache case: (x, stacked int8 weights, scales (L, O), bias or
    None, the number of copies). Random codes, channel scales of a weight of
    std i^-0.5; the bias in x's dtype, as the trees keep it."""
    gen = torch.Generator(device=dev).manual_seed(o + i + rows)
    layers = max(2, -(-COLD_BYTES // (o * i)))
    w = torch.randint(-127, 128, (layers, o, i), generator=gen, device=dev, dtype=torch.int8)
    scales = (torch.rand((layers, o), generator=gen, device=dev) + 0.5) * (i ** -0.5 / 64)
    x = torch.randn((rows, i), generator=gen, device=dev).to(dtype)
    bias = (torch.randn(o, generator=gen, device=dev) * 0.1).to(dtype) if with_bias else None
    return x, w, scales, bias, layers


def caller(lib, entry: str, x, w, scales, bias, stream: int, slices=None):
    """A function of the copy index that calls version `lib` on that copy
    (the output and any workspace allocated once), and its output."""
    sys.path.insert(0, str(ROOT))
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm

    rows, i = x.shape
    o = w.shape[1]
    P, I = ctypes.c_void_p, ctypes.c_int
    xb = int(x.dtype == torch.bfloat16)
    if entry == "f32":
        fn = lib.tpa_int8_matmul
        fn.argtypes = [P, I, P, P, P, P, P, I, I, I, I, P]
        fn.restype = ctypes.c_int
        out = torch.empty((rows, o), device=x.device)
        xq = torch.empty((rows, i), dtype=torch.int8, device=x.device)
        sx = torch.empty((rows,), device=x.device)

        def call(layer: int):
            return fn(x.data_ptr(), xb, w.data_ptr(), scales[layer].data_ptr(), xq.data_ptr(),
                      sx.data_ptr(), out.data_ptr(), rows, i, o, layer, stream)
    else:
        fn = lib.tpa_int8_matmul
        fn.argtypes = [P, I, P, P, P, I, P, I, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
        if slices is None:
            slices = i8mm.plan(rows, i, o, torch.cuda.get_device_properties(
                x.device).multi_processor_count)
        out = torch.empty((rows, o), dtype=x.dtype, device=x.device)
        kind = 0 if bias is None else 1 if bias.dtype == torch.float32 else 2
        bp = None if bias is None else bias.data_ptr()

        def call(layer: int):
            return fn(x.data_ptr(), xb, w.data_ptr(), scales[layer].data_ptr(), bp, kind,
                      out.data_ptr(), xb, rows, i, o, layer, slices, stream)

    def checked(layer: int):
        rc = call(layer)
        if rc:
            raise RuntimeError(f"int8_split: CUDA error {rc}")
        return out
    return checked


def alternatives(i: int) -> list[int]:
    """The column slices a call can take."""
    sys.path.insert(0, str(ROOT))
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm

    return [c for c in i8mm.SLICES if c <= -(-i // i8mm.CHUNK)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("int8_split: no CUDA device available")
    sys.path.insert(0, str(ROOT))
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    quick = "--quick" in sys.argv[1:]
    dirs = [Path(a) for a in sys.argv[1:] if not a.startswith("--")] or [CSRC]
    versions, kinds = {}, {}
    for d in dirs:
        sources = read_sources(d)
        kinds[str(d)] = layout(sources)
        print(f"int8_split: {d}: {kinds[str(d)]}", flush=True)
        for name, files in variants(sources).items():
            versions[(str(d), name)] = files
    libs = build(versions)
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = {}
    shapes = {k: v for k, v in SHAPES.items() if not quick or k.startswith("whisper q")
              or k in ("whisper fc2", "whisper head", "qwen3 head")}
    for (label, (o, i, with_bias)), rows, (dname, dtype) in itertools.product(
            shapes.items(), (1, 16) if quick else ROWS,
            {"bf16": torch.bfloat16}.items() if quick else X_DTYPES.items()):
        x, w, scales, bias, layers = case(o, i, rows, dtype, with_bias, dev)
        entry = {key: LAYOUTS[kinds[key[0]]]["entry"] for key in libs}
        calls = {key: caller(lib, entry[key], x, w, scales, bias, stream)
                 for key, lib in libs.items()}
        plan = i8mm.plan(rows, i, o, n_sm)
        for d in dirs:
            if LAYOUTS[kinds[str(d)]]["entry"] != "typed":
                continue
            for alt in alternatives(i):
                if alt != plan:
                    calls[(str(d), f"C={alt}")] = caller(
                        libs[(str(d), "kernel")], "typed", x, w, scales, bias, stream, alt)
        plain_f32 = i8mm.int8_matmul_plain(x, w[1], scales[1])
        plain_typed = i8mm.int8_matmul_plain(x, w[1], scales[1], bias, out_dtype=dtype)
        for key in list(calls):
            if key[1] != "kernel" and not key[1].startswith("C="):
                continue
            try:
                got = calls[key](1).clone()
            except RuntimeError as exc:  # a launch this version cannot take
                if key[1] == "kernel":
                    raise
                print(f"int8_split {key[0]} {label} {rows} {dname} {key[1]}: {exc}", flush=True)
                del calls[key]
                continue
            torch.cuda.synchronize()
            if entry.get((key[0], "kernel")) == "typed":
                diff = (got.float() - plain_typed.float()).abs().max().item()
                if diff != 0:
                    raise AssertionError(f"int8_split {key} {label} {rows} {dname}: the kernel "
                                         f"differs from plain by {diff:.3e}")
            else:
                rel = ((got - plain_f32).abs().max() / plain_f32.abs().max()).item()
                if not rel <= 1e-5:
                    raise AssertionError(f"int8_split {key} {label} {rows} {dname}: the kernel "
                                         f"differs from plain: rel {rel:.3e}")
        names = list(calls)
        times = {key: [] for key in names}
        iters = 40 if o * i < 1 << 26 else 20
        for order in (names, names[::-1]):
            for key in order:
                cycle = itertools.cycle(range(layers))
                times[key].append(time_ms(lambda key=key, cycle=cycle: calls[key](next(cycle)),
                                          iters))
        extra = {}
        if dtype == torch.bfloat16:  # int8_linear's cast and bias after an f32 output
            b16 = bias if bias is not None else None
            extra["cast + bias"] = time_ms(
                lambda: plain_f32.to(dtype) + b16 if b16 is not None else plain_f32.to(dtype),
                iters)
        if rows == 32:
            xq, _ = i8mm.quantize_rows(x)
            wp = w[1] if o % 8 == 0 else torch.nn.functional.pad(w[1], (0, 0, 0, -o % 8))
            extra["_int_mm"] = time_ms(lambda: torch._int_mm(xq, wp.T), iters)
            cycle = itertools.cycle(range(layers))
            extra["int8_matmul_bigm"] = time_ms(
                lambda: i8mm.int8_matmul_bigm(x, w[next(cycle)], scales[0]), iters)
            del xq, wp
        n_bytes = (x.numel() * x.element_size() + o * i + 4 * o + rows * o * x.element_size()
                   + (0 if bias is None else bias.numel() * bias.element_size()))
        bound_ms = 1e3 * n_bytes / 3.35e12
        for d in dict.fromkeys(k[0] for k in names):
            ms = {v: sum(times[(k, v)]) / 2 for k, v in names if k == d}
            tag = f"{d} {label} {rows} {dname}"
            results[tag] = {**ms, **extra, "plan": plan, "bound": bound_ms}
            print(f"int8_split {d} {label} ({o}, {i}) rows {rows} x {dname}: kernel "
                  f"{ms['kernel']:.4f} ms (bound {bound_ms:.4f}; plan C={plan}); " + ", ".join(
                      f"{v} {ms[v]:.4f}" + (f" (share {ms['kernel'] - ms[v]:.4f})"
                                            if v.startswith("no ") else "")
                      for v in ms if v != "kernel")
                  + "".join(f", {k} {t:.4f}" for k, t in extra.items()) + f" ({card})",
                  flush=True)
        del x, w, scales, bias, calls, plain_f32, plain_typed
    print(json.dumps({"card": card, "versions": kinds, "ms": results}), flush=True)


if __name__ == "__main__":
    main()
