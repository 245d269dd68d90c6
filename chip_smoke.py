#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tpu_audio_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from `tpu_audio_torch/csrc/` with nvcc;
  3. hold each kernel against its plain PyTorch version at the shapes of
     Whisper large-v3-turbo batch-16 transcription, and time both with
     CUDA events; hold attn_oproj_ln once more on inputs where the
     attention term is as large as the residual, and show that each of a
     set of planted faults (applied to the plain version) lands outside
     the limit;
  4. transcribe 4 two-minute clips (16 windows, one batch of 16) with
     `transcribe_windows` on random bf16 weights and the int8 cross-K/V
     state, check the launch counters, tokens and log-probs, print the wall
     time; then hold the kernel path and the plain bf16 path against the
     plain path in f32 on 2 windows (encoder features and decode logits),
     and run the same with faults planted in the kernel path.

The second line from the end is a JSON object describing each kernel; the
last line is `{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 16
CLIP_SECONDS = 120
N_CLIPS = 4
# The kernel path may be at most this many times further from the f32
# reference than the plain bf16 path is (relative max error), end to end.
SLICE_RATIO = 1.5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` launches, after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_pair(kernel, plain, iters: int) -> tuple[float, float]:
    """(kernel ms, plain ms), each the mean of two runs taken in the order
    plain, kernel, kernel, plain."""
    p1 = time_ms(plain, iters)
    k1 = time_ms(kernel, iters)
    k2 = time_ms(kernel, iters)
    p2 = time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def measure(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float, float]:
    """(max|got - ref|, that over max|ref|, cosine) of got against ref;
    raises on a shape mismatch or a non-finite value in got."""
    g, r = got.float(), ref.float()
    if g.shape != r.shape or not torch.isfinite(g).all():
        raise AssertionError(f"shape {tuple(g.shape)} vs {tuple(r.shape)} "
                             "or non-finite values")
    err = (g - r).abs().max().item()
    gd, rd = g.double().flatten(), r.double().flatten()
    cos = (gd @ rd / (gd.norm() * rd.norm())).item()
    return err, err / r.abs().max().item(), cos


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, *,
            atol: float | None = None, rel: float | None = None) -> float:
    """Max abs error of got against ref; raises past the tolerance. `rel`
    bounds max|got - ref| / max|ref| and also demands cosine > 0.999."""
    err, rel_err, cos = measure(got, ref)
    msg = f"{name}: max_abs_err {err:.3e}"
    if atol is not None and not err <= atol:
        raise AssertionError(f"{msg} > atol {atol}")
    if rel is not None:
        msg += f", rel {rel_err:.3e}, cosine {cos:.6f}"
        if not (rel_err <= rel and cos > 0.999):
            raise AssertionError(f"{msg}: outside rel {rel} / cosine 0.999")
    log(msg)
    return err


def planted_faults(name: str, outputs, faults, rel: float) -> None:
    """Hold `outputs` against each fault's outputs (the plain version with
    one fault planted). Each fault must land outside rel / cosine 0.999 on
    at least one output; a fault that stays inside means the check could
    not tell a kernel with that fault from a right one, and raises."""
    for label, fault in faults:
        readings = [measure(g, r)[1:] for g, r in zip(outputs, fault())]
        text = ", ".join(f"rel {e:.3e} cosine {c:.6f}" for e, c in readings)
        if all(e <= rel and c > 0.999 for e, c in readings):
            raise AssertionError(f"{name}: the check cannot see {label} ({text})")
        log(f"control {name}, {label}: {text}: outside the limit")


@contextmanager
def plain_kernels(*modules):
    """Route every kernel wrapper of `modules` to its plain version."""
    saved = []
    for mod in modules:
        for name in mod.LAUNCHES:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, getattr(mod, name + "_plain"))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    if not (ROOT / "tpu_audio_torch").is_dir():
        raise SystemExit(f"chip_smoke: {ROOT} holds no tpu_audio_torch package")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tpu_audio_torch.models.whisper import batch as wbatch
    from tpu_audio_torch.models.whisper import model as wmodel
    from tpu_audio_torch.models.whisper.config import PRESETS
    from tpu_audio_torch.models.whisper.tokenizer import BPE, WhisperTokenizer
    from tpu_audio_torch.ops.kernels import _build
    from tpu_audio_torch.ops.kernels import cross_kv_attention as ckv
    from tpu_audio_torch.ops.kernels import fused_encoder as fe
    from tpu_audio_torch.ops.kernels import fused_mel

    # ---------------------------------------------------------------- 1. card
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc and load) -> {lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")

    # ------------------------------------------------ model (random weights)
    cfg = PRESETS["large-v3-turbo"]
    t0 = time.perf_counter()
    model = wmodel.Whisper(cfg, wmodel.init_params(SEED, cfg, torch.bfloat16, dev))
    torch.cuda.synchronize()
    log(f"model: large-v3-turbo random bf16 weights (seed {SEED}) in "
        f"{time.perf_counter() - t0:.1f} s")

    # ------------------------------------------- 3. kernels against plain
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # fused_log_mel: one 30 s chunk with its 200-sample margins
    audio = randn(30 * 16000 + 400, scale=0.1)
    got = fused_mel.fused_log_mel(audio, n_mels=cfg.n_mels)
    ref = fused_mel.fused_log_mel_plain(audio, n_mels=cfg.n_mels)
    err = compare("fused_log_mel (3001, 128) f32", got, ref, atol=1e-3)
    ms, pms = timed_pair(lambda: fused_mel.fused_log_mel(audio, n_mels=cfg.n_mels),
                         lambda: fused_mel.fused_log_mel_plain(audio, n_mels=cfg.n_mels), 20)
    rows.append(("fused_log_mel", "tpu_audio_torch/csrc/fused_mel.cu",
                 "tpu_audio/ops/pallas/fused_mel.py:44", fused_mel, err, ms, pms))

    # encoder block 0 at batch 16
    t_audio, d = cfg.n_audio_ctx, cfg.n_audio_state
    blocks = model.encoder["blocks"]
    ln1, ln2, o = blocks["ln1"], blocks["ln2"], blocks["attn"]["o"]
    x = randn(BATCH, t_audio, d, dtype=torch.bfloat16)
    qkv_args = (x, ln1["weight"][0].float(), ln1["bias"][0].float(),
                model.qkv_weight[0], model.qkv_bias[0], cfg.n_audio_head)
    got = fe.ln_qkv(*qkv_args)
    ref = fe.ln_qkv_plain(*qkv_args)
    err = max(compare(f"ln_qkv {n} (16, 20, 1500, 64) bf16", g, r, rel=2e-2)
              for n, g, r in zip("qkv", got, ref))
    ms, pms = timed_pair(lambda: fe.ln_qkv(*qkv_args), lambda: fe.ln_qkv_plain(*qkv_args), 10)
    rows.append(("ln_qkv", "tpu_audio_torch/csrc/fused_encoder.cu",
                 "tpu_audio/ops/pallas/fused_encoder.py:114", fe, err, ms, pms))

    wo, bo = o["weight"][0], o["bias"][0].float()
    g2, b2 = ln2["weight"][0].float(), ln2["bias"][0].float()
    attn_args = (*got, x, wo, bo, g2, b2, t_audio)
    got = fe.attn_oproj_ln(*attn_args)
    ref = fe.attn_oproj_ln_plain(*attn_args)
    err = max(compare(f"attn_oproj_ln {n} (16, 1500, 1280) bf16", g, r, rel=2e-2)
              for n, g, r in zip(("y", "h"), got, ref))
    ms, pms = timed_pair(lambda: fe.attn_oproj_ln(*attn_args),
                         lambda: fe.attn_oproj_ln_plain(*attn_args), 5)
    del got, ref, attn_args, qkv_args, x

    # In the block above the attention adds ~1 % to the residual x, so y and
    # h would read inside the limit with the attention wrong. Here the
    # attention term is as large as x and the bias: peaked scores (q.k std
    # ~2), unit-variance values, keys >= 1000 masked, x and bias std 0.1.
    hshape = (BATCH, cfg.n_audio_head, t_audio, d // cfg.n_audio_head)
    qa, ka = (randn(*hshape, dtype=torch.bfloat16, scale=0.5) for _ in range(2))
    va = randn(*hshape, dtype=torch.bfloat16)
    xa = randn(BATCH, t_audio, d, dtype=torch.bfloat16, scale=0.1)
    boa = randn(d, scale=0.1)
    t_mask = 1000

    def plain(q=qa, k=ka, v=va, x=xa, w=wo, b=boa, t_valid=t_mask):
        return fe.attn_oproj_ln_plain(q, k, v, x, w, b, g2, b2, t_valid)

    got = fe.attn_oproj_ln(qa, ka, va, xa, wo, boa, g2, b2, t_mask)
    err = max(err, *(compare(f"attn_oproj_ln {n}, attention-sized inputs, t_valid {t_mask}",
                             g, r, rel=2e-2) for n, g, r in zip(("y", "h"), got, plain())))
    planted_faults("attn_oproj_ln", got, [
        ("the attention dropped", lambda: plain(v=torch.zeros_like(va))),
        ("wo untransposed", lambda: plain(w=wo.T.contiguous())),
        ("t_valid ignored", lambda: plain(t_valid=t_audio)),
        ("each head given the next head's values", lambda: plain(v=va.roll(1, dims=1))),
        ("the bias dropped", lambda: plain(b=torch.zeros_like(boa))),
        ("the residual dropped", lambda: plain(x=torch.zeros_like(xa))),
        ("LN2 dropped (h = y)", lambda: (plain()[0],) * 2),
    ], rel=2e-2)
    rows.append(("attn_oproj_ln", "tpu_audio_torch/csrc/fused_encoder.cu",
                 "tpu_audio/ops/pallas/fused_encoder.py:207", fe, err, ms, pms))
    del got, qa, ka, va, xa

    # cross-attention decode over int8 K/V of 4 layers at batch 16
    h, hd = cfg.n_text_head, cfg.n_text_state // cfg.n_text_head
    shape = (cfg.n_text_layer, BATCH, t_audio, h, hd)
    k8, ks, v8, vs = ckv.quantize_cross_kv(randn(*shape, scale=0.3), randn(*shape, scale=0.5))
    q = randn(BATCH, h, hd)
    layer = cfg.n_text_layer - 1
    cross_args = (q, k8, v8, ks[layer], vs[layer], layer)
    kw = dict(t_valid=t_audio, n_heads=h)
    err = compare("cross_attention_decode (16, 20, 64) f32",
                  ckv.cross_attention_decode(*cross_args, **kw),
                  ckv.cross_attention_decode_plain(*cross_args, **kw), atol=2e-2)
    ms, pms = timed_pair(lambda: ckv.cross_attention_decode(*cross_args, **kw),
                         lambda: ckv.cross_attention_decode_plain(*cross_args, **kw), 50)
    rows.append(("cross_attention_decode", "tpu_audio_torch/csrc/cross_kv_attention.cu",
                 "tpu_audio/ops/pallas/cross_kv_attention.py:112", ckv, err, ms, pms))
    del k8, v8, ks, vs, cross_args
    for name, *_, ms, pms in rows:
        log(f"time {name}: kernel {ms:.4f} ms, plain {pms:.4f} ms ({card})")

    # ------------------------------------------------------- 4. the slice
    tok = WhisperTokenizer(BPE({bytes([i]): i for i in range(256)}), True,
                           cfg.num_languages)
    rng = np.random.default_rng(SEED)
    clips = [(rng.standard_normal(CLIP_SECONDS * 16000) * 0.1).astype(np.float32)
             for _ in range(N_CLIPS)]
    kernel_mods = (fused_mel, fe, ckv)
    for mod in kernel_mods:
        for name in mod.LAUNCHES:
            mod.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts, results = wbatch.transcribe_windows(model, tok, clips, batch_size=BATCH,
                                               kv_int8=True, return_results=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: n for mod in kernel_mods for name, n in mod.LAUNCHES.items()}
    log(f"slice launches: {launches}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if len(texts) != N_CLIPS or len(results) != BATCH:
        raise AssertionError(f"expected {N_CLIPS} texts and {BATCH} windows, "
                             f"got {len(texts)} and {len(results)}")
    n_tokens = sum(len(r.tokens) for r in results)
    for r in results:
        if not all(0 <= t < cfg.n_vocab for t in r.tokens):
            raise AssertionError("token outside the vocabulary")
        if not math.isfinite(r.avg_logprob) or not math.isfinite(r.no_speech_prob):
            raise AssertionError("non-finite log-prob")
    audio_s = N_CLIPS * CLIP_SECONDS
    log(f"slice: transcribe_windows, {N_CLIPS} clips x {CLIP_SECONDS} s = {BATCH} windows, "
        f"batch {BATCH}, bf16 weights, int8 cross-KV: {wall:.3f} s wall, "
        f"{audio_s / wall:.1f}x real time, {n_tokens} tokens generated, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")

    # The kernel path end to end on 2 windows: encoder features and the
    # logits of the first decode step. The reference is the plain path in
    # f32 on the same bf16-rounded weights and mel; the plain bf16 path's
    # distance from it is the scale of bf16 rounding over 32 blocks. The
    # kernel path must be no more than SLICE_RATIO times as far, with
    # cosine > 0.999 against the reference.
    mel = torch.stack([wbatch.MelExtractor(cfg.n_mels, dev)(c[:30 * 16000])[:3000]
                       for c in clips[:2]]).to(torch.bfloat16)
    init = torch.tensor([tok.sot_sequence()] * 2, device=dev)

    def run_path(m, dtype):
        with torch.inference_mode():
            feats = m.encode(mel.to(dtype))
            state = m.init_state(feats, batch=2, dtype=dtype, kv_int8=True)
            _, state = m.decode_step(init, state)
            logits, _ = m.decode_step(init[:, -1:], state)
        return feats, logits

    ref_model = copy.deepcopy(model).float()
    with plain_kernels(*kernel_mods):
        exact = run_path(ref_model, torch.float32)
        plain_out = run_path(model, torch.bfloat16)
    del ref_model
    kernel_out = run_path(model, torch.bfloat16)
    outputs = ("encoder features (2, 1500, 1280)", "decode-step logits (2, 1, 51866)")
    for name, k, p, r in zip(outputs, kernel_out, plain_out, exact):
        _, e_k, cos_k = measure(k, r)
        _, e_p, cos_p = measure(p, r)
        _, e_kp, cos_kp = measure(k, p)
        msg = (f"slice {name} against f32: kernels rel {e_k:.3e} cosine {cos_k:.6f}, "
               f"plain bf16 rel {e_p:.3e} cosine {cos_p:.6f}, ratio {e_k / e_p:.3f}; "
               f"kernels against plain bf16 rel {e_kp:.3e} cosine {cos_kp:.6f}")
        if not (e_k <= SLICE_RATIO * e_p and cos_k > 0.999):
            raise AssertionError(f"{msg}: outside ratio {SLICE_RATIO} / cosine 0.999")
        log(msg)

    # the same with a fault planted in every encoder block's attn_oproj_ln:
    # each must land outside the limit, or the check above is blind to it
    kernel = fe.attn_oproj_ln
    slice_faults = {
        "wo untransposed": lambda q, k, v, x, w, *a, **kw: kernel(
            q, k, v, x, w.T.contiguous(), *a, **kw),
        "the o-projection bias dropped": lambda q, k, v, x, w, b, *a, **kw: kernel(
            q, k, v, x, w, torch.zeros_like(b), *a, **kw),
        "LN2 dropped (h = y)": lambda *a, **kw: (kernel(*a, **kw)[0],) * 2,
    }
    for label, fault in slice_faults.items():
        fe.attn_oproj_ln = fault
        try:
            faulty = run_path(model, torch.bfloat16)
        finally:
            fe.attn_oproj_ln = kernel
        readings = []
        for k, p, r in zip(faulty, plain_out, exact):
            _, e_k, cos_k = measure(k, r)
            readings.append((e_k / measure(p, r)[1], cos_k))
        text = ", ".join(f"{name.split(' (')[0]} ratio {q:.3f} cosine {c:.6f}"
                         for name, (q, c) in zip(outputs, readings))
        if all(q <= SLICE_RATIO and c > 0.999 for q, c in readings):
            raise AssertionError(f"slice: the check cannot see {label} ({text})")
        log(f"control slice, {label}: {text}: outside the limit")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": pms}
        for name, src, replaces, _, err, ms, pms in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
