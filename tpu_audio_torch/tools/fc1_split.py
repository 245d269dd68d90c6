#!/usr/bin/env python3
"""Where `fc1_gelu_int8`'s time goes on the card: the kernel against copies
of `csrc/fused_encoder_int8.cu` with one part taken out, each built by nvcc
into `build/fc1_split/` and timed by CUDA events at Whisper large-v3-turbo
batch 16 (M = 24000 rows, D = 1280, FF = 5120) in turns.

    python3 tpu_audio_torch/tools/fc1_split.py

Variants (the cut copies compute wrong codes; only their time is read):
  kernel        the source as it is (its codes held against the plain
                version, bit for bit);
  no GELU       gelu(z) replaced by z in fc1_gemm's epilogue;
  no epilogue   fc1_gemm stops each row tile after its products (no GELU,
                no cluster exchange, no codes);
  quant pass    the entry point launches quant_rows alone.
The products' share is `no epilogue` − `quant pass`, the epilogue's
`kernel` − `no epilogue`, the GELU's `kernel` − `no GELU`. Prints the card
line and, last, one JSON object of the mean times. Needs one CUDA card and
nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "tpu_audio_torch" / "csrc"
OUT = ROOT / "build" / "fc1_split"
B, T, D, FF = 16, 1500, 1280, 5120
SPIN_CYCLES = 50_000_000


def variants(src: str) -> dict:
    """The kernel's source and the three cut copies."""
    kernel = src.index("fc1_gemm_kernel(__grid_constant__")
    head, body = src[:kernel], src[kernel:]
    stop = "    release(g - 1);  // thread 0 starts the next row tile's loads\n"
    gemm = "  if (err == cudaSuccess)\n    err = nw == 160 ? fc1_gemm<160>"
    cuts = {"no GELU": head + body.replace("gelu(dequant(", "(dequant(", 4),
            "no epilogue": head + body.replace(
                stop, stop + "    if (acc[0] == 0x7FFFFFFF) out[0] = 1;  // keep the products\n"
                "    continue;\n", 1),
            "quant pass": src.replace(gemm, "  if (false)\n    err = nw == 160 ? fc1_gemm<160>", 1)}
    for name, text in cuts.items():
        if text == src:
            raise RuntimeError(f"fc1_split: the cut '{name}' no longer matches the source")
    return {"kernel": src, **cuts}


def build(sources: dict) -> dict:
    """One nvcc process a variant, all at once; returns the entry points."""
    sys.path.insert(0, str(ROOT))
    from tpu_audio_torch.ops.kernels import _build

    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for header in CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        (d / "k.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "k.so"),
               str(d / "k.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"fc1_split: nvcc failed for '{name}':\n{log[-4000:]}")
        fn = ctypes.CDLL(str(d / "k.so")).tpa_fc1_gelu_int8
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def time_ms(fn, iters: int = 10) -> float:
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fc1_split: no CUDA device available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    entries = build(variants((CSRC / "fused_encoder_int8.cu").read_text()))
    from tpu_audio_torch.ops.kernels import fused_encoder_int8 as fe8

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn(B, T, D, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (FF, D), generator=gen, device=dev, dtype=torch.int8)
    cs = torch.rand(FF, generator=gen, device=dev) * 1e-3 + 1e-4
    bias = torch.randn(FF, generator=gen, device=dev) * 0.5
    m = B * T
    hq = torch.empty(m, D, dtype=torch.int8, device=dev)
    sh = torch.empty(m, device=dev)
    codes = torch.empty(B, T, FF, dtype=torch.int8, device=dev)
    sg = torch.empty(B, T, 1, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(fn):
        rc = fn(h.data_ptr(), w.data_ptr(), cs.data_ptr(), bias.data_ptr(), hq.data_ptr(),
                sh.data_ptr(), codes.data_ptr(), sg.data_ptr(), m, D, FF, stream)
        if rc:
            raise RuntimeError(f"fc1_split: CUDA error {rc}")

    run(entries["kernel"])
    ref = fe8.fc1_gelu_int8_plain(h, w, cs, bias)
    if not (torch.equal(codes, ref[0]) and torch.equal(sg, ref[1])):
        raise AssertionError("fc1_split: the kernel's codes or scales differ from plain")
    times = {name: [] for name in entries}
    for order in (list(entries), list(entries)[::-1]):
        for name in order:
            times[name].append(time_ms(lambda: run(entries[name])))
    ms = {name: sum(t) / len(t) for name, t in times.items()}
    for name, t in times.items():
        print(f"fc1_split {name}: {ms[name]:.4f} ms (runs {t}) ({card})", flush=True)
    print(f"fc1_split: products {ms['no epilogue'] - ms['quant pass']:.4f} ms, epilogue "
          f"{ms['kernel'] - ms['no epilogue']:.4f} ms (GELU {ms['kernel'] - ms['no GELU']:.4f}), "
          f"quant pass {ms['quant pass']:.4f} ms ({card})", flush=True)
    print(json.dumps({"card": card, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
