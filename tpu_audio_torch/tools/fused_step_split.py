#!/usr/bin/env python3
"""Where `fused_decode_step`'s time goes on the card: the whole-stack
Llama / Qwen step against copies of its sources with one part taken out,
each built by nvcc into `build/fused_step_split/` (all at once) and timed
by CUDA events in turns at three shapes, all 28 layers each, so that every
step reads its weights from device memory (0.44-2.8 GB, far past the 50 MB
L2):
  qwen3-0.6b bf16  Qwen3-0.6B (D 1024, 16 heads over 8 of 128, hidden
                   3072, q/k-norm), bf16 weights and bf16 activations, as
                   Fun-ASR's bf16 tree runs it;
  qwen3-0.6b int8  the same with int8 weights (f32 scales) and f32
                   activations, as its int8 tree runs it;
  llama-3.2-3b int8  Llama-3.2-3B (D 3072, 24 heads over 8 of 128, hidden
                   8192), int8 weights and f32 activations (the dequantised
                   rows of the int8 embedding), as Orpheus's default w8a8
                   engine runs it.
The bf16 cache is filled before `pos` (Qwen3: pos 300, first valid slot 40,
as chip_smoke's phase 3; 3B: pos 132, slot 4, a 32-slot prompt and 100
tokens), the slots before the first valid one with keys of std 10.

    python3 tpu_audio_torch/tools/fused_step_split.py [CSRC ...]

Each CSRC, a directory holding a version of `fused_step.cu` and its headers
(an older checkout's `tpu_audio_torch/csrc`), is split in the same call, in
turns with the others; with none, the repository's. Each known version has
its own marks (`LAYOUTS`).

Variants (the cut copies compute wrong outputs; only their time is read):
  kernel        the sources as they are (h held against the plain version:
                rel 2e-2 and cosine 0.999 with f32 activations; with bf16
                ones, whose roundings may flip across 28 layers, cosine
                0.99);
  no barriers   every grid barrier taken out;
  no weights    the products read no weight from device memory (the
                arithmetic stays; a staged version issues no copy);
  no attention  the key and value passes taken out (with the merge where
                the last chunk merges);
  no norms      each RMSNorm (ln1, ln2, the final one) replaced by a copy
                of its weight (without its sum of squares);
  no merge      the attention output gathered from the chunks' partials:
                every block's re-summing of them (the grid-barrier
                version), or the last chunk's merge (the staged one);
  all cut       the cuts at once: what the step costs besides.
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
OUT = ROOT / "build" / "fused_step_split"
STEP = "fused_step.cu"
SPIN_CYCLES = 50_000_000
# (model, weights, activations, cache slots, pos, first valid slot)
SHAPES = {"qwen3-0.6b bf16": ("qwen3", torch.bfloat16, torch.bfloat16, 512, 300, 40),
          "qwen3-0.6b int8": ("qwen3", torch.int8, torch.float32, 512, 300, 40),
          "llama-3.2-3b int8": ("llama3b", torch.int8, torch.float32, 256, 132, 4)}

# Per version of the sources: each cut as (file, old text, new text), every
# occurrence replaced. A version is recognised when every mark is found.
LAYOUTS = {
    "one warp a row over the grid, two attention passes, six grid barriers a layer": {
        "no barriers": [(STEP, "grid.sync();", "__syncthreads();")],
        "no weights": [("decode_step.cuh",
                        "acc += dot_vec<W>(__ldcs(wr + v), a + v * per_vec<W>());",
                        "acc += dot_vec<W>(make_int4(v, o, lane, v ^ o), a + v * per_vec<W>());")],
        "no attention": [(STEP, "    if (attn_block) {\n", "    if (false) {\n")],
        "no norms": [(STEP, "bool rb,\n                         float* scratch) {\n",
                      "bool rb,\n                         float* scratch) {\n"
                      "  for (int i = threadIdx.x; i < D; i += kThreads) out[i] = w[i];\n"
                      "  __syncthreads();\n  return;\n")],
        "no merge": [(STEP, "for (int i = 0; i < split; ++i) s += __ldcg(part",
                      "for (int i = 0; i < 0; ++i) s += __ldcg(part")],
    },
    "weight rows streamed through a ring by a producer warp into mma.sync, chunks merged "
    "by the last arrival, five grid barriers a layer": {
        "no barriers": [(STEP, "auto sync_grid = [&]() { grid_barrier(cnt, G * ++barriers); };",
                         "auto sync_grid = [&]() { consumers_sync(); };")],
        # no copy, and a slot's barrier expects no bytes
        "no weights": [(STEP, "hp::bulk_load(dst", "if (false) hp::bulk_load(dst"),
                       (STEP, "static_cast<uint32_t>(units[k] * m * row_bytes));",
                        "0u * static_cast<uint32_t>(units[k] * m * row_bytes));")],
        # the chunks' passes and their merge
        "no attention": [(STEP, "      chunk_attention<HD>(",
                          "      if (false) chunk_attention<HD>(")],
        "no norms": [(STEP, "    const float r = rsqrtf(csum(s, scratch) / n + eps);",
                      "    const float r = 0.f;"),
                     (STEP, "      for (int j = 0; j < 4; ++j) v[k][j] = v[k][j] * r * w[k][j];",
                      "      for (int j = 0; j < 4; ++j) v[k][j] = w[k][j] + r;"),
                     (STEP, "  const float r = rsqrtf(csum(s, scratch) / D + eps);",
                      "  const float r = 1.f;")],
        "no merge": [(STEP, "  if (sm.bc[3] == 0.f) return;", "  return;")],
    },
}


def layout(sources: dict) -> str:
    """The name of the version whose marks all match `sources` (file → text)."""
    for name, cuts in LAYOUTS.items():
        if all(old in sources.get(f, "") for edits in cuts.values() for f, old, _ in edits):
            return name
    raise RuntimeError("fused_step_split: the sources match no known version's marks")


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
    """One nvcc process a (version, variant), all at once; returns the
    entry points by key."""
    sys.path.insert(0, str(ROOT))
    from tpu_audio_torch.ops.kernels import _build
    from tpu_audio_torch.ops.kernels import fused_step as fs

    procs = {}
    for i, (key, files) in enumerate(versions.items()):
        d = OUT / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f, text in files.items():
            (d / f).write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "k.so"),
               str(d / STEP)]
        procs[key] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    entries = {}
    for key, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"fused_step_split: nvcc failed for {key}:\n{log[-4000:]}")
        if key[1] == "kernel":
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {key[0]}: {line.strip()}", flush=True)
        fn = ctypes.CDLL(str(d / "k.so")).tpa_fused_step
        fn.argtypes = [*fs._KERNEL.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[key] = fn
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


def config(model: str):
    from tpu_audio_torch.models.funasr.model import QWEN3_06B
    from tpu_audio_torch.models.orpheus.model import LLAMA_3B

    return QWEN3_06B if model == "qwen3" else LLAMA_3B


def inputs(shape: str, dev):
    """The step's arguments before the stream (the workspace sized for any
    version's layout), and the check of h against the plain version."""
    from tpu_audio_torch.ops.kernels import fused_step as fs

    model, wdt, xdt, s_max, p, s0 = SHAPES[shape]
    cfg = config(model)
    lyr, d, hd, hidden = cfg.n_layers, cfg.dim, cfg.hd, cfg.hidden_dim
    h_, kvh = cfg.n_heads, cfg.kv_heads
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    out_in = {"qkv": ((h_ + 2 * kvh) * hd, d), "o": (d, h_ * hd), "gateup": (2 * hidden, d),
              "down": (d, hidden)}
    stack = {}
    for n, (o, i) in out_in.items():
        if wdt == torch.int8:
            stack[f"w{n}"] = torch.randint(-127, 128, (lyr, o, i), generator=gen, device=dev,
                                           dtype=torch.int8)
            # scales that keep every term of the step near unit size
            stack[f"s{n}"] = randn(lyr, o).abs() * 0.5 / (127 * i ** 0.5) + 1e-5
        else:
            stack[f"w{n}"] = (randn(lyr, o, i) * 0.5 / i ** 0.5).to(torch.bfloat16)
            stack[f"s{n}"] = torch.ones(lyr, o, device=dev)
    stack.update(ln1=1 + 0.3 * randn(lyr, d), ln2=1 + 0.3 * randn(lyr, d),
                 norm=1 + 0.3 * randn(d))
    if cfg.qk_norm:
        stack["qknorm"] = 1 + 0.3 * randn(lyr, 2, hd)
    kc = torch.zeros(lyr, kvh, s_max, hd, dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    kc[:, :, :s0] = randn(lyr, kvh, s0, hd, scale=10.0).to(torch.bfloat16)
    vc[:, :, :s0] = randn(lyr, kvh, s0, hd, scale=10.0).to(torch.bfloat16)
    kc[:, :, s0:p] = randn(lyr, kvh, p - s0, hd, scale=2.0).to(torch.bfloat16)
    vc[:, :, s0:p] = randn(lyr, kvh, p - s0, hd).to(torch.bfloat16)
    x = randn(1, d, scale=0.5).to(xdt)
    pos, start = torch.tensor(p, device=dev), torch.tensor(s0, device=dev)
    cos, sin = fs.make_cos_sin(pos, cfg.inv_freq())
    h = torch.empty(1, d, device=dev)
    n_work = fs.workspace_floats(d, hidden, h_, kvh, hd) + (1 << 20)
    work = torch.empty(n_work, device=dev)
    kw = dict(n_heads=h_, n_kv_heads=kvh, hd=hd, eps=cfg.norm_eps)
    args = [x, int(xdt == torch.bfloat16), pos, start, cos, sin, stack["wqkv"], stack["sqkv"],
            None, stack.get("qknorm"), stack["wo"], stack["so"], stack["wgateup"],
            stack["sgateup"], stack["wdown"], stack["sdown"], stack["ln1"], stack["ln2"],
            stack["norm"], kc, vc, h, work, n_work, cfg.norm_eps, int(wdt == torch.int8), lyr,
            d, hidden, h_, kvh, hd, s_max]
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]

    def check(label: str):
        ref = fs.fused_decode_step_plain(stack, x, pos, start, cos, sin, kc.clone(), vc.clone(),
                                         **kw)
        g, r = h.double().flatten(), ref.double().flatten()
        rel = ((g - r).abs().max() / r.abs().max()).item()
        cos_ = (g @ r / (g.norm() * r.norm())).item()
        exact = xdt == torch.float32
        print(f"fused_step_split {label} {shape} against plain: rel {rel:.3e}, "
              f"cosine {cos_:.6f}", flush=True)
        if not (cos_ > 0.999 and rel <= 2e-2 if exact else cos_ > 0.99):
            raise AssertionError(f"fused_step_split {label} {shape}: the kernel's h differs "
                                 f"from plain: rel {rel:.3e}, cosine {cos_:.6f}")

    return args, check


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fused_step_split: no CUDA device available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dirs = [Path(a) for a in sys.argv[1:]] or [CSRC]
    versions, kinds = {}, {}
    for d in dirs:
        sources = read_sources(d)
        kinds[str(d)] = layout(sources)
        print(f"fused_step_split: {d}: {kinds[str(d)]}", flush=True)
        for name, files in variants(sources).items():
            versions[(str(d), name)] = files
    entries = build(versions)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = {}
    for shape in SHAPES:
        args, check = inputs(shape, dev)

        def run(key, args=args):
            rc = entries[key](*args, stream)
            if rc:
                raise RuntimeError(f"fused_step_split {key}: CUDA error {rc}")

        for key in entries:
            if key[1] == "kernel":
                run(key)
                torch.cuda.synchronize()
                check(key[0])
        names = list(entries)
        times = {key: [] for key in names}
        for order in (names, names[::-1]):
            for key in order:
                times[key].append(time_ms(lambda key=key: run(key)))
        for d in dict.fromkeys(k[0] for k in names):
            ms = {v: sum(times[(d, v)]) / 2 for k, v in names if k == d}
            results[f"{d} {shape}"] = ms
            print(f"fused_step_split {d} {shape}: kernel {ms['kernel']:.4f} ms; " + ", ".join(
                f"{v} {ms[v]:.4f}" + (f" (share {ms['kernel'] - ms[v]:.4f})"
                                      if v.startswith("no ") else "")
                for v in ms if v != "kernel") + f" ({card})", flush=True)
        del args, check
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "versions": kinds, "ms": results}), flush=True)


if __name__ == "__main__":
    main()
