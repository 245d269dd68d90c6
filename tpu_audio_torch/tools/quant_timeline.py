#!/usr/bin/env python3
"""Where one call of the q4/q8 dequant-matmul spends its time on the card,
stage by stage: a copy of `csrc/quant_matmul.cu` in which thread 0 of
block 0 (and the producer warp's lane 0) write `%globaltimer` stamps at
the kernel's stages, built by nvcc into `build/quant_timeline/` and run in
a chain of calls, as a decoder runs them, on enough stacked copies of the
weights that each call reads them from device memory.

    python3 tpu_audio_torch/tools/quant_timeline.py

Prints, per shape (1 row of f32 x, q4), the medians over the chain's last
calls, in ns: from the release of `griddepcontrol.wait` to x staged, to
the first stage seen landed, to the products done (warp 0), to the warps'
sums begun, to the end; from a call's end to the next call's release; the
period of the chain; and, from the block's entry, when the producer had
issued its first stages and when they had landed. The card line first.
Needs one CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import itertools
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "tpu_audio_torch" / "csrc" / "quant_matmul.cu"
OUT = ROOT / "build" / "quant_timeline"
SHAPES = {"whisper q, k, v, o, cross q, o": (1280, 1280), "qwen3 k, v": (1024, 1024),
          "whisper fc2": (1280, 5120)}
CALLS = 40
SLOTS = 64   # calls kept, by a counter block 0 raises
STAMPS = 9

# (old text, new text): each found once in the source, or the tool refuses.
# Stamp k: 0 entry, 1 released, 2 staged, 3 landed (consumer), 4 products
# done, 5 sums begun, 6 end, 7 issued (producer), 8 landed (producer).
EDITS = [
    ("namespace {\n\nnamespace hp",
     f"__device__ long long g_stamps[{SLOTS}][{STAMPS}];\n__device__ int g_call;\n"
     "namespace {\n\nnamespace hp"),
    ("  if (S > 1) hp::cluster_arrive();  // this block runs;",
     "  __shared__ int slot_;\n"
     "  auto stamp = [&](int k) {\n"
     "    if (blockIdx.x == 0 && (threadIdx.x == 0 || (threadIdx.x == kConsumers && k >= 7))) {\n"
     "      long long t;\n"
     "      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "      g_stamps[slot_][k] = t;\n"
     "    }\n"
     "  };\n"
     f"  if (threadIdx.x == 0 && blockIdx.x == 0) slot_ = atomicAdd(&g_call, 1) % {SLOTS};\n"
     "  __syncthreads();\n"
     "  stamp(0);\n"
     "  if (S > 1) hp::cluster_arrive();  // this block runs;"),
    ("    for (int j = 0; j < first; ++j) issue(j);\n",
     "    for (int j = 0; j < first; ++j) issue(j);\n"
     "    stamp(7);\n"
     "    if (lane == 0) {\n"
     "      wait_bar(full, 0);\n"
     "      stamp(8);\n"
     "    }\n"),
    ("  if (pl.B * 8 * gs <= kConsumers)", "  stamp(1);\n  if (pl.B * 8 * gs <= kConsumers)"),
    ("  hp::named_barrier(kBar, kConsumers);\n  // the next kernel may",
     "  hp::named_barrier(kBar, kConsumers);\n  stamp(2);\n  // the next kernel may"),
    ("    wait_bar(full + s, (j / pl.stages) & 1);\n    const unsigned char* st",
     "    wait_bar(full + s, (j / pl.stages) & 1);\n    if (j == 0) stamp(3);\n"
     "    const unsigned char* st"),
    ("    __syncwarp();\n    if (lane == 0) hp::mbar_arrive(empty + s);",
     "    __syncwarp();\n    if (j == 0) stamp(4);\n    if (lane == 0) hp::mbar_arrive(empty + s);"),
    ("    if (S > 1 && j == 0) hp::cluster_wait();  // every block",
     "    if (j == 0) stamp(5);\n    if (S > 1 && j == 0) hp::cluster_wait();  // every block"),
    ("      hp::named_barrier(kBar, kConsumers);  // red is written again",
     "      if (j == items - 1) stamp(6);\n"
     "      hp::named_barrier(kBar, kConsumers);  // red is written again"),
]
READ = (f'\nextern "C" int tpa_quant_stamps(long long* host) {{\n'
        f"  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps)));\n}}\n")


def stamped(text: str) -> str:
    """The source with the stamps written in."""
    for old, new in EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"quant_timeline: mark not found once: {old!r}")
        text = text.replace(old, new)
    return text + READ


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT))
    from tpu_audio_torch.ops.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    for p in SRC.parent.glob("*.cuh"):
        (OUT / p.name).write_text(p.read_text())
    (OUT / SRC.name).write_text(stamped(SRC.read_text()))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                           str(OUT / "k.so"), str(OUT / SRC.name)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"quant_timeline: nvcc failed:\n{proc.stdout[-4000:]}"
                           f"{proc.stderr[-4000:]}")
    return ctypes.CDLL(str(OUT / "k.so"))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("quant_timeline: no CUDA device available")
    sys.path.insert(0, str(ROOT))
    from tpu_audio_torch.tools import quant_split

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    lib = build()
    fn = lib.tpa_quant_matmul
    fn.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label, (o, i) in SHAPES.items():
        x, w, scales, biases, layers = quant_split.case(o, i, 1, dev)
        call = quant_split.caller(fn, "typed", x, w, scales, biases, stream)
        cycle = itertools.cycle(range(layers))
        for _ in range(3):
            call(next(cycle))
        torch.cuda.synchronize()
        torch.cuda._sleep(quant_split.SPIN_CYCLES)  # the chain queued before it runs
        for _ in range(CALLS):
            call(next(cycle))
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (SLOTS * STAMPS))()
        if lib.tpa_quant_stamps(buf):
            raise RuntimeError("quant_timeline: reading the stamps failed")
        rows = sorted(([buf[c * STAMPS + k] for k in range(STAMPS)] for c in range(SLOTS)),
                      key=lambda r: r[0])[-CALLS // 2:]  # the chain's last calls
        pairs = list(zip(rows, rows[1:]))

        def med(values) -> float:
            return statistics.median(values)
        parts = {"released -> x staged": med(r[2] - r[1] for r in rows),
                 "staged -> stage landed": med(r[3] - r[2] for r in rows),
                 "products": med(r[4] - r[3] for r in rows),
                 "to the sums": med(r[5] - r[4] for r in rows),
                 "sums and stores": med(r[6] - r[5] for r in rows),
                 "end -> next released": med(b[1] - a[6] for a, b in pairs),
                 "period": med(b[0] - a[0] for a, b in pairs),
                 "entry -> released": med(r[1] - r[0] for r in rows),
                 "entry -> producer issued": med(r[7] - r[0] for r in rows),
                 "entry -> producer saw it land": med(r[8] - r[0] for r in rows)}
        print(f"quant_timeline {label} ({o}, {i}) 1 row f32, block 0, median ns of the last "
              f"{len(rows)} calls: " + ", ".join(f"{k} {v:.0f}" for k, v in parts.items())
              + f" ({card})", flush=True)
        del x, w, scales, biases


if __name__ == "__main__":
    main()
