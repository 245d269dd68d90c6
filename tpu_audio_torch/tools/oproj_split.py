#!/usr/bin/env python3
"""Where `attn_oproj_ln_int8`'s second launch, oproj_ln, spends its time on
the card: the kernel against copies of `csrc/fused_encoder_int8.cu` with one
part taken out, each built by nvcc into `build/oproj_split/` and timed by
CUDA events at Whisper large-v3-turbo batch 16 (M = 24000 rows, D = 1280,
10 head pairs, clusters of 5 blocks of 256 columns) in turns.

    python3 tpu_audio_torch/tools/oproj_split.py [SOURCE]

SOURCE, a copy of `csrc/fused_encoder_int8.cu` to split instead of the
repository's (another version of the kernel with the same marks).

Variants, each a cut on top of the one before (the cut copies compute wrong
outputs; only their time is read):
  kernel          the source as it is (its y held against the plain version
                  on the same codes, bit for bit);
  no LayerNorm    the two rounds of LayerNorm2's statistics through the
                  cluster taken out (no cluster barrier after the first);
  no stores       y and h neither computed nor stored;
  no dequant      each pair's s32 sums folded into the accumulator by one
                  operation a value instead of the five of (sum * sa) * cso
                  added in f32;
  no x            the accumulator started from bo alone, x not read.
Each share is the difference of two neighbours; `no x` is the products and
the ring alone. Prints the card line and, last, one JSON object of the mean
times. Needs one CUDA card and nvcc; imports nothing of JAX.
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
OUT = ROOT / "build" / "oproj_split"
B, T, D = 16, 1500, 1280
SPIN_CYCLES = 50_000_000


def cut(text: str, old: str, new: str, name: str) -> str:
    if old not in text:
        raise RuntimeError(f"oproj_split: the cut '{name}' no longer matches the source")
    return text.replace(old, new)


def variants(src: str) -> dict:
    """The kernel's source and the cut copies, each cut on top of the one
    before it. A cut keeps the accumulators alive (their sum decides a
    store that never happens), so that the compiler drops nothing else."""
    kernel = src.index("oproj_ln_kernel(__grid_constant__")
    head, body = src[:kernel], src[kernel:]
    no_ln = body
    for old in ("    exchange(psum, s_lo, s_hi);\n", "    exchange(psq, q_lo, q_hi);\n"):
        no_ln = cut(no_ln, old, "", "no LayerNorm")
    start = no_ln.index("    // y, then h = (y - mean) * rstd * g2 + b2")
    end = no_ln.index("  }\n}\n", start)
    no_epi = (no_ln[:start] + "    if (s_lo + s_hi == 1234.5f) y[0] = hout[0];  // keep the sums\n"
              + no_ln[end:])
    start = no_epi.index("        // acc + (sum * sa) * cso, each product and sum rounded")
    end = no_epi.index("      release(step);\n", start)
    no_dq = (no_epi[:start] + "#pragma unroll\n"
             "        for (int i = 0; i < BH / 2; ++i)  // one operation a value, not five\n"
             "          acc[h][i] = __int_as_float(__float_as_int(acc[h][i]) ^ part[i]);\n"
             "      }\n" + no_epi[end:])
    no_x = no_dq
    for half in ("lo", "hi"):
        no_x = cut(no_x, f"        if (h < halves && m_{half} < M)\n          x_{half} =",
                   f"        if (false)\n          x_{half} =", "no x")
    return {"kernel": src, "no LayerNorm": head + no_ln, "no stores": head + no_epi,
            "no dequant": head + no_dq, "no x": head + no_x}


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
            raise RuntimeError(f"oproj_split: nvcc failed for '{name}':\n{log[-4000:]}")
        fn = ctypes.CDLL(str(d / "k.so")).tpa_oproj_ln
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                                      ctypes.c_void_p]
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
        raise SystemExit("oproj_split: no CUDA device available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    source = Path(sys.argv[1]) if len(sys.argv) > 1 else CSRC / "fused_encoder_int8.cu"
    print(f"oproj_split: {source}", flush=True)
    entries = build(variants(source.read_text()))
    from tpu_audio_torch.ops.kernels import fused_encoder_int8 as fe8

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    codes = torch.randint(-127, 128, (B, T, D), generator=gen, device=dev, dtype=torch.int8)
    scales = randn(B, T, D // 128).abs() * 0.01 + 1e-3
    x = randn(B, T, D, scale=0.1).to(torch.bfloat16)
    wo = torch.randint(-127, 128, (D, D), generator=gen, device=dev, dtype=torch.int8)
    cso = randn(D).abs() * 1e-3 + 1e-4
    bo, g2, b2 = randn(D, scale=0.1), 1 + randn(D, scale=0.1), randn(D, scale=0.1)
    y, h = (torch.empty(B, T, D, dtype=torch.bfloat16, device=dev) for _ in range(2))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(fn):
        rc = fn(codes.data_ptr(), scales.data_ptr(), x.data_ptr(), wo.data_ptr(),
                cso.data_ptr(), bo.data_ptr(), g2.data_ptr(), b2.data_ptr(), y.data_ptr(),
                h.data_ptr(), B * T, D, 1e-5, stream)
        if rc:
            raise RuntimeError(f"oproj_split: CUDA error {rc}")

    run(entries["kernel"])
    ref = fe8.oproj_ln_int8_plain(codes, scales, x, wo, cso, bo, g2, b2)
    if not torch.equal(y, ref[0]):
        raise AssertionError("oproj_split: the kernel's y differs from plain")
    times = {name: [] for name in entries}
    for order in (list(entries), list(entries)[::-1]):
        for name in order:
            times[name].append(time_ms(lambda: run(entries[name])))
    ms = {name: sum(t) / len(t) for name, t in times.items()}
    for name, t in times.items():
        print(f"oproj_split {name}: {ms[name]:.4f} ms (runs {t}) ({card})", flush=True)
    print(f"oproj_split: exchange {ms['kernel'] - ms['no LayerNorm']:.4f} ms, stores "
          f"{ms['no LayerNorm'] - ms['no stores']:.4f} ms, dequantisation "
          f"{ms['no stores'] - ms['no dequant']:.4f} ms, x loads "
          f"{ms['no dequant'] - ms['no x']:.4f} ms, products and the ring {ms['no x']:.4f} ms "
          f"({card})", flush=True)
    print(json.dumps({"card": card, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
