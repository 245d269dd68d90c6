#!/usr/bin/env python3
"""Where the o-projections spend their time on the card: the second launch
of `attn_oproj_ln_int8` (oproj_ln, `csrc/fused_encoder_int8.cu`) and of the
bf16 `attn_oproj_ln` (oproj_ln_bf16, `csrc/fused_encoder.cu`), each against
copies of its source with one part taken out, built by nvcc into
`build/oproj_split/` (all at once) and timed by CUDA events at Whisper
large-v3-turbo batch 16 (M = 24000 rows, D = 1280, clusters of 5 blocks of
256 columns) in turns.

    python3 tpu_audio_torch/tools/oproj_split.py [int8|bf16 [SOURCE]]

With no argument both kernels are split. SOURCE, a copy of the kernel's
source to split instead of the repository's (another version of the kernel
with the same marks).

Variants, each a cut on top of the one before (the cut copies compute wrong
outputs; only their time is read):
  kernel          the source as it is (int8: its y held against the plain
                  version on the same codes, bit for bit; bf16: y and h
                  within rel 2e-2, cosine 0.999 of the plain version);
  no LayerNorm    the two rounds of LayerNorm2's statistics through the
                  cluster taken out (no cluster barrier after the first);
  no stores       y and h neither computed nor stored;
  no dequant      (int8) each pair's s32 sums folded into the accumulator by
                  one operation a value instead of the five of
                  (sum * sa) * cso added in f32;
  no x            x not read: the accumulator (int8) or the product (bf16)
                  takes bo alone.
Each share is the difference of two neighbours; `no x` is the products and
the ring alone (bf16: with bo's add). Prints the card line and, last, one
JSON object of the mean times. Needs one CUDA card and nvcc; imports
nothing of JAX.
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
# per kernel: its source, the start of its definition, its entry point, and
# the argument types before the stream
KINDS = {
    "int8": ("fused_encoder_int8.cu", "oproj_ln_kernel(__grid_constant__", "tpa_oproj_ln",
             [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_float]),
    "bf16": ("fused_encoder.cu", "oproj_ln_bf16_kernel(__grid_constant__", "tpa_oproj_ln_bf16",
             [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_float]),
}


def cut(text: str, old: str, new: str, name: str) -> str:
    if old not in text:
        raise RuntimeError(f"oproj_split: the cut '{name}' no longer matches the source")
    return text.replace(old, new)


def variants(src: str, kind: str) -> dict:
    """The kernel's source and the cut copies, each cut on top of the one
    before it. A cut keeps the accumulators alive (their sum decides a
    store that never happens), so that the compiler drops nothing else."""
    kernel = src.index(KINDS[kind][1])
    head, body = src[:kernel], src[kernel:]
    no_ln = body
    for old in ("    exchange(psum, s_lo, s_hi);\n", "    exchange(psq, q_lo, q_hi);\n"):
        no_ln = cut(no_ln, old, "", "no LayerNorm")
    start = no_ln.index("    // y, then h = (y - mean) * rstd * g2 + b2")
    end = no_ln.index("  }\n}\n", start)
    no_epi = (no_ln[:start] + "    if (s_lo + s_hi == 1234.5f) y[0] = hout[0];  // keep the sums\n"
              + no_ln[end:])
    out = {"kernel": src, "no LayerNorm": head + no_ln, "no stores": head + no_epi}
    if kind == "int8":
        start = no_epi.index("        // acc + (sum * sa) * cso, each product and sum rounded")
        end = no_epi.index("      release(step);\n", start)
        no_epi = (no_epi[:start] + "#pragma unroll\n"
                  "        for (int i = 0; i < BH / 2; ++i)  // one operation a value, not five\n"
                  "          acc[h][i] = __int_as_float(__float_as_int(acc[h][i]) ^ part[i]);\n"
                  "      }\n" + no_epi[end:])
        out["no dequant"] = head + no_epi
        guard = "        if (h < halves && m_{half} < M)\n          x_{half} ="
        unguard = "        if (false)\n          x_{half} ="
    else:
        guard = "      if (m_{half} < M)\n        x_{half} ="
        unguard = "      if (false)\n        x_{half} ="
    no_x = no_epi
    for half in ("lo", "hi"):
        no_x = cut(no_x, guard.format(half=half), unguard.format(half=half), "no x")
    out["no x"] = head + no_x
    return out


def build(sources: dict) -> dict:
    """One nvcc process a (kind, variant), all at once; returns the entry
    points by the same keys."""
    sys.path.insert(0, str(ROOT))
    from tpu_audio_torch.ops.kernels import _build

    procs = {}
    for i, ((kind, name), text) in enumerate(sources.items()):
        d = OUT / f"{kind}_v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for header in CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        (d / "k.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "k.so"),
               str(d / "k.cu")]
        procs[kind, name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    entries = {}
    for (kind, name), (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"oproj_split: nvcc failed for {kind} '{name}':\n{log[-4000:]}")
        fn = getattr(ctypes.CDLL(str(d / "k.so")), KINDS[kind][2])
        fn.argtypes = [*KINDS[kind][3], ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[kind, name] = fn
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


def inputs(dev) -> dict:
    """Both kernels' arguments before the stream, by kind, and the check of
    the uncut kernel's outputs against its plain version."""
    from tpu_audio_torch.ops.kernels import fused_encoder as fe
    from tpu_audio_torch.ops.kernels import fused_encoder_int8 as fe8

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    codes = torch.randint(-127, 128, (B, T, D), generator=gen, device=dev, dtype=torch.int8)
    scales = randn(B, T, D // 128).abs() * 0.01 + 1e-3
    x = randn(B, T, D, scale=0.1).to(torch.bfloat16)
    wo8 = torch.randint(-127, 128, (D, D), generator=gen, device=dev, dtype=torch.int8)
    cso = randn(D).abs() * 1e-3 + 1e-4
    attn = randn(B, T, D, scale=0.5).to(torch.bfloat16)
    wo = randn(D, D, scale=0.03).to(torch.bfloat16)
    bo, g2, b2 = randn(D, scale=0.1), 1 + randn(D, scale=0.1), randn(D, scale=0.1)
    y, h = (torch.empty(B, T, D, dtype=torch.bfloat16, device=dev) for _ in range(2))

    def check_int8():
        ref = fe8.oproj_ln_int8_plain(codes, scales, x, wo8, cso, bo, g2, b2)
        if not torch.equal(y, ref[0]):
            raise AssertionError("oproj_split: the int8 kernel's y differs from plain")

    def check_bf16():
        for got, ref in zip((y, h), fe.oproj_ln_plain(attn, x, wo, bo, g2, b2)):
            g, r = got.double().flatten(), ref.double().flatten()
            rel = ((g - r).abs().max() / r.abs().max()).item()
            cos = (g @ r / (g.norm() * r.norm())).item()
            if not (rel <= 2e-2 and cos > 0.999):
                raise AssertionError(f"oproj_split: the bf16 kernel's output differs from "
                                     f"plain: rel {rel:.3e}, cosine {cos:.6f}")

    return {"int8": ((codes, scales, x, wo8, cso, bo, g2, b2, y, h, B * T, D, 1e-5),
                     check_int8),
            "bf16": ((attn, x, wo, bo, g2, b2, y, h, B * T, D, 1e-5), check_bf16)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("oproj_split: no CUDA device available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kinds = [sys.argv[1]] if len(sys.argv) > 1 else list(KINDS)
    if any(k not in KINDS for k in kinds):
        raise SystemExit(f"oproj_split: expected one of {list(KINDS)}, got {sys.argv[1]}")
    sources = {}
    for kind in kinds:
        source = Path(sys.argv[2]) if len(sys.argv) > 2 else CSRC / KINDS[kind][0]
        print(f"oproj_split {kind}: {source}", flush=True)
        for name, text in variants(source.read_text(), kind).items():
            sources[kind, name] = text
    entries = build(sources)
    dev = torch.device("cuda", 0)
    args = inputs(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {"card": card}
    for kind in kinds:
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args[kind][0]]

        def run(fn, conv=conv):
            rc = fn(*conv, stream)
            if rc:
                raise RuntimeError(f"oproj_split: CUDA error {rc}")

        names = [name for k, name in entries if k == kind]
        run(entries[kind, "kernel"])
        torch.cuda.synchronize()
        args[kind][1]()
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(time_ms(lambda name=name: run(entries[kind, name])))
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        for name, t in times.items():
            print(f"oproj_split {kind} {name}: {ms[name]:.4f} ms (runs {t}) ({card})", flush=True)
        parts = [("exchange", "kernel", "no LayerNorm"), ("stores", "no LayerNorm", "no stores")]
        parts += ([("dequantisation", "no stores", "no dequant"), ("x loads", "no dequant", "no x")]
                  if kind == "int8" else [("x loads", "no stores", "no x")])
        print(f"oproj_split {kind}: " + ", ".join(
            f"{label} {ms[a] - ms[b]:.4f} ms" for label, a, b in parts)
            + f", products and the ring {ms['no x']:.4f} ms ({card})", flush=True)
        result[kind] = ms
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
