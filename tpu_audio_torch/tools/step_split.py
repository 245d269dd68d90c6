#!/usr/bin/env python3
"""Where `fused_whisper_decode_step`'s time goes on the card: the step
against copies of its sources with one part taken out, each built by nvcc
into `build/step_split/` (all at once) and timed by CUDA events at the main
path's shapes in turns: Whisper large-v3-turbo's decoder (4 layers, D 1280,
20 heads of 64, hidden 5120) on the int8 tree (int8 weights with f32
scales, f32 activations, bf16 self cache filled to pos 200), cross-K/V
(4, 1, 1536, 1280) int8 with t_valid 1500.

    python3 tpu_audio_torch/tools/step_split.py [CSRC]

CSRC, a directory holding another version of `fused_whisper_step.cu` and
its headers (an older checkout's `tpu_audio_torch/csrc`), to split instead
of the repository's; each known version has its own marks (`LAYOUTS`).

Variants (the cut copies compute wrong outputs; only their time is read):
  kernel          the sources as they are (h held against the plain
                  version within rel 2e-2, cosine 0.999);
  no barriers     every grid barrier taken out;
  no weights      the products read no weight from device memory (the
                  arithmetic stays; the staged version issues no copy);
  no attention    both attentions' key and value passes taken out (in the
                  grid-barrier version the merge of their partials stays;
                  in the staged one, where the last chunk merges, it goes
                  too);
  no LayerNorm    each LayerNorm replaced by a copy of its weight;
  all cut         the four cuts at once: what the step costs besides.
Each share is `kernel` minus the variant. Prints the card line and, last,
one JSON object of the mean times. Needs one CUDA card and nvcc; imports
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
OUT = ROOT / "build" / "step_split"
L, D, H, HIDDEN, S, T_PAD, T_VALID, POS = 4, 1280, 20, 5120, 448, 1536, 1500, 200
SPIN_CYCLES = 50_000_000
STEP = "fused_whisper_step.cu"

# Per version of the sources: each cut as (file, old text, new text), every
# occurrence replaced. A version is recognised when every mark is found.
LAYOUTS = {
    "one warp a row, two-pass attention between grid barriers": {
        "no barriers": [(STEP, "grid.sync();", "__syncthreads();")],
        "no weights": [("decode_step.cuh",
                        "acc += dot_vec<W>(__ldcs(wr + v), a + v * per_vec<W>());",
                        "acc += dot_vec<W>(make_int4(v, o, lane, v ^ o), a + v * per_vec<W>());")],
        "no attention": [(STEP, "    if (attn_block) {\n", "    if (false) {\n")],
        "no LayerNorm": [(STEP, "                           float* scratch) {\n",
                          "                           float* scratch) {\n"
                          "  for (int i = threadIdx.x; i < D; i += kThreads) out[i] = wb[i];\n"
                          "  __syncthreads();\n  return;\n")],
    },
    "weight rows staged in shared memory, chunks merged by the last arrival": {
        "no barriers": [(STEP, "grid.sync();", "__syncthreads();")],
        # no copy, and a copy's barrier expects no bytes
        "no weights": [(STEP, "      for (long o = 0; o < cnt * row_bytes;",
                        "      for (long o = 0; o < 0 * cnt * row_bytes;"),
                       (STEP, "hp::mbar_arrive_expect_tx(br, static_cast<uint32_t>(rows(g, r0)",
                        "hp::mbar_arrive_expect_tx(br, 0u * static_cast<uint32_t>(rows(g, r0)")],
        # the chunks' passes and their merge
        "no attention": [(STEP, "      chunk_attention<", "      if (false) chunk_attention<")],
        "no LayerNorm": [(STEP, "float* out, float* scratch) {\n",
                          "float* out, float* scratch) {\n"
                          "  for (int i = threadIdx.x; i < D; i += kThreads)\n"
                          "    out[nv == 0 ? i : perm<W>(i, nv)] = wb[i];\n"
                          "  __syncthreads();\n  return;\n")],
    },
}


def layout(sources: dict) -> str:
    """The name of the version whose marks all match `sources` (file → text)."""
    for name, cuts in LAYOUTS.items():
        if all(old in sources.get(f, "") for edits in cuts.values() for f, old, _ in edits):
            return name
    raise RuntimeError("step_split: the sources match no known version's marks")


def variants(sources: dict) -> dict:
    """The sources (file → text) and the cut copies, by variant name."""
    cuts = LAYOUTS[layout(sources)]

    def apply(text_of: dict, edits) -> dict:
        out = dict(text_of)
        for f, old, new in edits:
            out[f] = out[f].replace(old, new)
        return out

    out = {"kernel": sources}
    for name, edits in cuts.items():
        out[name] = apply(sources, edits)
    out["all cut"] = apply(sources, [e for edits in cuts.values() for e in edits])
    return out


def read_sources(csrc: Path) -> dict:
    return {p.name: p.read_text() for p in sorted(csrc.glob("*.cu*"))
            if p.suffix == ".cuh" or p.name == STEP}


def build(versions: dict) -> dict:
    """One nvcc process a variant, all at once; returns the entry points."""
    sys.path.insert(0, str(ROOT))
    from tpu_audio_torch.ops.kernels import _build
    from tpu_audio_torch.ops.kernels import fused_whisper_step as fws

    procs = {}
    for i, (name, files) in enumerate(versions.items()):
        d = OUT / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f, text in files.items():
            (d / f).write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "k.so"),
               str(d / STEP)]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"step_split: nvcc failed for '{name}':\n{log[-4000:]}")
        if name == "kernel":
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas: {line.strip()}", flush=True)
        fn = ctypes.CDLL(str(d / "k.so")).tpa_fused_whisper_step
        fn.argtypes = [*fws._KERNEL.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def time_ms(fn, iters: int = 20) -> float:
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


def inputs(dev):
    """The step's arguments before the stream, and the check of h against
    the plain version."""
    from tpu_audio_torch.ops.kernels import fused_whisper_step as fws

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    out_in = {"q": (D, D), "k": (D, D), "v": (D, D), "o": (D, D), "qc": (D, D),
              "oc": (D, D), "fc1": (HIDDEN, D), "fc2": (D, HIDDEN)}
    w = {n: codes(L, *s) for n, s in out_in.items()}
    # scales that keep every term of the step near unit size
    scale = {n: randn(L, s[0]).abs() * 0.5 / (127 * s[1] ** 0.5) + 1e-5 for n, s in out_in.items()}
    vec = {"ln": torch.stack([1 + randn(L, 3, D, scale=0.3), randn(L, 3, D, scale=0.3)], 2),
           "lnf": torch.stack([1 + randn(D, scale=0.3), randn(D, scale=0.3)])}
    vec.update({f"bias_{n}": randn(L, s[0], scale=0.1) for n, s in out_in.items() if n != "k"})
    sw = fws.StepWeights(w, scale, vec)
    x = randn(1, D, scale=0.5)
    pos = torch.tensor(POS, device=dev)
    kc = torch.zeros(L, S, D, dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    kc[:, :POS] = randn(L, POS, D, scale=0.5).to(torch.bfloat16)
    vc[:, :POS] = randn(L, POS, D).to(torch.bfloat16)
    k8, v8 = codes(L, 1, T_PAD, D), codes(L, 1, T_PAD, D)
    ksc, vsc = randn(L, 1, D).abs() * 0.01 + 1e-3, randn(L, 1, D).abs() * 0.01 + 1e-3
    h = torch.empty(1, D, device=dev)
    n_work = fws.workspace_floats(D, HIDDEN, H) + (1 << 20)  # room for any version's layout
    work = torch.empty(n_work, device=dev)
    names = fws.NAMES
    args = [x, 0, pos, *(w[n] for n in names), *(scale[n] for n in names),
            *(vec.get(f"bias_{n}") for n in names), vec["ln"], vec["lnf"], kc, vc, k8, ksc,
            v8, vsc, h, work, n_work, 1, 0, L, D, HIDDEN, H, S, T_PAD, T_VALID]
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]

    def check():
        ref = fws.fused_whisper_decode_step_plain(sw, x, pos, kc.clone(), vc.clone(), k8, ksc,
                                                  v8, vsc, n_heads=H, t_valid=T_VALID)
        g, r = h.double().flatten(), ref.double().flatten()
        rel = ((g - r).abs().max() / r.abs().max()).item()
        cos = (g @ r / (g.norm() * r.norm())).item()
        if not (rel <= 2e-2 and cos > 0.999):
            raise AssertionError(f"step_split: the kernel's h differs from plain: "
                                 f"rel {rel:.3e}, cosine {cos:.6f}")
        print(f"step_split kernel against plain: rel {rel:.3e}, cosine {cos:.6f}", flush=True)

    return args, check


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("step_split: no CUDA device available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    csrc = Path(sys.argv[1]) if len(sys.argv) > 1 else CSRC
    sources = read_sources(csrc)
    print(f"step_split: {csrc}: {layout(sources)}", flush=True)
    entries = build(variants(sources))
    dev = torch.device("cuda", 0)
    args, check = inputs(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(fn):
        rc = fn(*args, stream)
        if rc:
            raise RuntimeError(f"step_split: CUDA error {rc}")

    run(entries["kernel"])
    torch.cuda.synchronize()
    check()
    names = list(entries)
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            times[name].append(time_ms(lambda name=name: run(entries[name])))
    ms = {name: sum(t) / len(t) for name, t in times.items()}
    for name, t in times.items():
        print(f"step_split {name}: {ms[name]:.4f} ms (runs {t}) ({card})", flush=True)
    print("step_split: " + ", ".join(f"{name[3:]} {ms['kernel'] - ms[name]:.4f} ms"
                                     for name in names if name.startswith("no "))
          + f", the rest {ms['all cut']:.4f} ms ({card})", flush=True)
    print(json.dumps({"card": card, "sources": str(csrc), "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
