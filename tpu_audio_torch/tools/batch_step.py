#!/usr/bin/env python3
"""The batch-16 decode step of Whisper large-v3-turbo's int8 decoder tree on
the card (random bf16 weights from seed 0, the decoder and tied head served
as per-channel int8, int8 cross-K/V, 16 windows of random features): ms a
step, by the host clock around `STEPS` calls of `Whisper.decode_step` and
their greedy argmax, ending in a synchronise (the loop is host-bound: this
is what a step costs the batch loop), and device kernels a step, by
torch.profiler over `PROFILED` more.

    python3 tpu_audio_torch/tools/batch_step.py [ROOT ...]

Each ROOT, a checkout of this repository or an unpacked archive of one
(e.g. a parent commit's under `build/`), is measured in a process of its
own, in the order given, importing its own `tpu_audio_torch` (which builds
its kernels into its own `build/`); with none, this checkout. Prints the
card line, one line a run and, last, one JSON object. `chip_smoke.py`'s
phase 6 calls `measure` on its own model. Needs one CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
BATCH = 16
WARMUP, STEPS, PROFILED = 10, 100, 20


def measure(model, tok, dev) -> dict:
    """ms a decode step and device kernels a step of `model` at batch 16,
    from the positions after the sot sequence on."""
    from torch.profiler import ProfilerActivity, profile

    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    feats_in = torch.randn((BATCH, 2 * cfg.n_audio_ctx, cfg.n_mels), generator=gen,
                           device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        feats = model.encode(feats_in)
        state = model.init_state(feats, batch=BATCH, dtype=torch.bfloat16, kv_int8=True)
        init = torch.tensor([tok.sot_sequence()] * BATCH, device=dev)
        logits, state = model.decode_step(init, state)
        last = logits[:, -1].argmax(-1)

        def run(n: int):
            nonlocal state, last
            for _ in range(n):
                lg, state = model.decode_step(last[:, None], state)
                last = lg[:, -1].argmax(-1)

        run(WARMUP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(STEPS)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / STEPS
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(PROFILED)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / PROFILED
    return {"ms_a_step": ms, "kernels_a_step": len(kernels) / PROFILED,
            "device_ms_a_step": busy if kernels else None}


def run_here(root: Path) -> dict:
    """Build the int8 decoder tree from `root`'s package and measure it."""
    sys.path.insert(0, str(root))
    from tpu_audio_torch.models.whisper import load as wload
    from tpu_audio_torch.models.whisper import model as wmodel
    from tpu_audio_torch.models.whisper.config import PRESETS
    from tpu_audio_torch.models.whisper.tokenizer import BPE, WhisperTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = PRESETS["large-v3-turbo"]
    params = wmodel.init_params(0, cfg, torch.bfloat16, dev)
    model = wmodel.Whisper(cfg, wload.serve_tree_int8(params, encoder=False))
    del params
    tok = WhisperTokenizer(BPE({bytes([i]): i for i in range(256)}), True, cfg.num_languages)
    return measure(model, tok, dev)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("batch_step: no CUDA device available")
    if len(sys.argv) == 3 and sys.argv[1] == "--here":
        print(json.dumps(run_here(Path(sys.argv[2]).resolve())), flush=True)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for root in [Path(a).resolve() for a in sys.argv[1:]] or [ROOT]:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--here",
                               str(root)], capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"batch_step: {root} failed:\n{proc.stdout[-2000:]}"
                             f"{proc.stderr[-4000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"root": str(root), **got})
        print(f"batch_step {root}: {got['ms_a_step']:.4f} ms a decode step, "
              f"{got['kernels_a_step']:.1f} device kernels a step, device busy "
              f"{got['device_ms_a_step']} ms a step ({card})", flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
