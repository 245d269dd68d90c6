#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tpu_audio_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from `tpu_audio_torch/csrc/` with nvcc (one
     process per source, all at once);
  3. hold each kernel against its plain PyTorch version at the shapes of
     Whisper large-v3-turbo (batch-16 transcription for the mel, encoder
     and cross-attention kernels; the int8 decoder's and lm head's shapes
     at 1 and 16 rows for the int8 matmuls; the B=1 step at pos 200 for the
     whole-decoder step), and time both with CUDA events; hold
     attn_oproj_ln and the decoder step once more on inputs where every
     term is as large as the residual, and show that each of a set of
     planted faults (applied to the plain version) lands outside the limit;
  4. transcribe 4 two-minute clips (16 windows, one batch of 16) with
     `transcribe_windows` on random bf16 weights and the int8 cross-K/V
     state, check the launch counters, tokens and log-probs, print the wall
     time; then hold the kernel path and the plain bf16 path against the
     plain path in f32 on 2 windows (encoder features and decode logits),
     and run the same with faults planted in the kernel path;
  5. the single-stream slice: `STT` engine → `WhisperPipeline` →
     `SegmentDecoder` at B=1 on the int8 decoder tree (bf16 encoder, int8
     decoder and lm head, int8 cross-K/V): `detect_language` and
     `transcribe(language=None)` on one short clip, counters checked, then
     the timed greedy decode of one 30 s window (ms per step, × real time)
     on the kernel path and the plain path, and the kernel path held
     against the f32 plain path on prefill and three teacher-forced steps,
     with faults planted in the decoder step;
  6. the mixed batch-16 row: `transcribe_windows` of phase 4's clips on
     the int8 decoder tree, wall time beside phase 4's.

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
SINGLE_CLIP_SECONDS = 4      # phase 5's transcribe clip (one window)
POS = 200                    # the decoder step's position in phase 3
SPIN_CYCLES = 50_000_000     # ~25 ms at the H100's clock: covers queuing a timed loop


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` launches, after one warm-up. A
    spin kernel queued first holds the card while the host queues the
    launches, so the host's issue time is not counted (for an fn that does
    not itself wait for the card)."""
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
def patched(obj, name: str, fn):
    """Replace obj.name with fn inside the block."""
    saved = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextmanager
def counting(obj, name: str, counter: dict, key: str):
    """Count calls of the method obj.name into counter[key] inside the
    block (an instance attribute that is deleted again afterwards)."""
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        counter[key] += 1
        return fn(*args, **kwargs)

    setattr(obj, name, wrapped)
    try:
        yield
    finally:
        delattr(obj, name)


def reset(*modules) -> None:
    for mod in modules:
        for name in mod.LAUNCHES:
            mod.LAUNCHES[name] = 0


def launch_counts(*modules) -> dict:
    return {name: n for mod in modules for name, n in mod.LAUNCHES.items()}


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


def check_int8_matmul(model_i8, randn, rows: list) -> None:
    """Phase 3, int8 matmuls: the lm head and the block shapes at 1 and 16
    rows, on the int8 tree's own codes; the int32 sums are exact, so the
    limit is rel 1e-5. The stacked entry reads the last layer (3), and a
    plain version that reads layer 0 must land outside the limit."""
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm

    blocks = model_i8.decoder["blocks"]
    head = model_i8.decoder["token_embedding"]
    fc1, fc2, q = blocks["mlp"]["fc1"], blocks["mlp"]["fc2"], blocks["attn"]["q"]
    shapes = {"attn q": (q["weight_i8"][0], q["scale_i8"][0]),
              "fc1": (fc1["weight_i8"][0], fc1["scale_i8"][0]),
              "fc2": (fc2["weight_i8"][0], fc2["scale_i8"][0]),
              "lm head": (head["weight_i8"], head["scale_i8"])}
    err = 0.0
    for n in (1, 16):
        for label, (w, sc) in shapes.items():
            x = randn(n, w.shape[1])
            err = max(err, compare(f"int8_matmul {label} ({n}, {w.shape[1]}) x "
                                   f"{tuple(w.shape)} s8", i8mm.int8_matmul(x, w, sc),
                                   i8mm.int8_matmul_plain(x, w, sc), rel=1e-5))
    x = randn(1, head["weight_i8"].shape[1])
    w, sc = shapes["lm head"]
    ms, pms = timed_pair(lambda: i8mm.int8_matmul(x, w, sc),
                         lambda: i8mm.int8_matmul_plain(x, w, sc), 20)
    log(f"time int8_matmul lm head (1, {w.shape[1]}) x {tuple(w.shape)}: kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms")
    rows.append(("int8_matmul", "tpu_audio_torch/csrc/int8_matmul.cu",
                 "tpu_audio/ops/pallas/int8_matmul.py:50", i8mm, err, ms, pms))

    layer, err = model_i8.cfg.n_text_layer - 1, 0.0
    for n in (1, 16):
        for label, leaf in (("fc1", fc1), ("fc2", fc2)):
            w_st, sc = leaf["weight_i8"], leaf["scale_i8"][layer]
            x = randn(n, w_st.shape[2])
            got = i8mm.int8_matmul_stacked(x, w_st, sc, layer)
            err = max(err, compare(f"int8_matmul_stacked {label} layer {layer} ({n}, "
                                   f"{w_st.shape[2]}) x {tuple(w_st.shape)} s8", got,
                                   i8mm.int8_matmul_stacked_plain(x, w_st, sc, layer),
                                   rel=1e-5))
            planted_faults(f"int8_matmul_stacked {label} ({n} rows)", (got,), [
                (f"layer 0 read instead of layer {layer}",
                 lambda: (i8mm.int8_matmul_stacked_plain(x, w_st, sc, 0),))], rel=1e-5)
    w_st, sc = fc1["weight_i8"], fc1["scale_i8"][layer]
    x = randn(16, w_st.shape[2])
    ms, pms = timed_pair(lambda: i8mm.int8_matmul_stacked(x, w_st, sc, layer),
                         lambda: i8mm.int8_matmul_stacked_plain(x, w_st, sc, layer), 20)
    log(f"time int8_matmul_stacked fc1 layer {layer} (16, {w_st.shape[2]}) x "
        f"{tuple(w_st.shape)}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    rows.append(("int8_matmul_stacked", "tpu_audio_torch/csrc/int8_matmul.cu",
                 "tpu_audio/ops/pallas/int8_matmul.py:116", i8mm, err, ms, pms))


def history_only(q, k, v, k_hist, v_hist, rnd):
    """Self-attention of the decoder step with the current token's own
    term dropped (a planted fault)."""
    w = torch.softmax(torch.einsum("thd,hd->ht", k_hist, q), dim=-1)
    return torch.einsum("ht,thd->hd", rnd(w), rnd(v_hist))


def check_decoder_step(models: dict, cfg, dev, randn, rows: list) -> None:
    """Phase 3, the whole-decoder step at B=1 for int8 and bf16 weights,
    bf16 cache filled to POS. With init_params weights the attention terms
    would be ~1 % of the residual and hide a wrong attention, so the inputs make each
    term as large as it: the q, k and cross-q weights ×4 (peaked scores),
    a cache history whose scores have std ~3, random LayerNorm parameters,
    a residual of std 0.5, and padded cross-K/V rows (t ≥ t_valid) filled
    with large codes."""
    from tpu_audio_torch.ops.kernels import cross_kv_attention as ckv
    from tpu_audio_torch.ops.kernels import fused_whisper_step as fws

    lyr, s_max, d, h = cfg.n_text_layer, cfg.n_text_ctx, cfg.n_text_state, cfg.n_text_head
    t_valid = cfg.n_audio_ctx
    shape = (lyr, 1, t_valid, h, d // h)
    k8, ks, v8, vs = ckv.quantize_cross_kv(randn(*shape), randn(*shape))
    t_pad = k8.shape[2]
    k8[:, :, t_valid:] = 127
    v8[:, :, t_valid:] = (randn(lyr, 1, t_pad - t_valid, d) * 60).clamp(-127, 127).to(torch.int8)
    kc = torch.zeros(lyr, s_max, d, dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    kc[:, :POS] = randn(lyr, POS, d, dtype=torch.bfloat16, scale=0.5)
    vc[:, :POS] = randn(lyr, POS, d, dtype=torch.bfloat16)
    pos = torch.tensor(POS, device=dev)

    for label, model in models.items():
        sw = model.step_weights()
        up = {n: 4.0 for n in ("q", "k", "qc")}
        if sw.scale is not None:
            sw = fws.StepWeights(sw.w, {n: s * up.get(n, 1.0) for n, s in sw.scale.items()},
                                 sw.vec)
        else:
            sw = fws.StepWeights({n: w * up.get(n, 1.0) for n, w in sw.w.items()}, None, sw.vec)
        ln = sw.vec["ln"]
        sw.vec = {**sw.vec,
                  "ln": torch.stack([1 + 0.3 * randn(*ln[:, :, 0].shape),
                                     0.3 * randn(*ln[:, :, 1].shape)], 2),
                  "lnf": torch.stack([1 + 0.3 * randn(d), 0.3 * randn(d)])}
        # activations: f32 beside the int8 token table, bf16 in the bf16 tree
        x = randn(1, d, dtype=torch.float32 if sw.scale is not None else torch.bfloat16,
                  scale=0.5)

        def kernel(kc_=kc, vc_=vc):
            kc_, vc_ = kc_.clone(), vc_.clone()
            out = fws.fused_whisper_decode_step(sw, x, pos, kc_, vc_, k8, ks, v8, vs,
                                                n_heads=h, t_valid=t_valid)
            return out, kc_[:, POS], vc_[:, POS]

        def plain(kc_=kc, vc_=vc, v8_=v8, t=t_valid):
            kc_, vc_ = kc_.clone(), vc_.clone()
            out = fws.fused_whisper_decode_step_plain(sw, x, pos, kc_, vc_, k8, ks, v8_, vs,
                                                      n_heads=h, t_valid=t)
            return out, kc_[:, POS], vc_[:, POS]

        def with_patch(name, fn):
            def run():
                with patched(fws, name, fn):
                    return plain()
            return run

        attend = fws._self_attention
        got = kernel()
        err = max(compare(f"fused_whisper_decode_step {label} {n}, pos {POS}", g, r, rel=2e-2)
                  for n, g, r in zip(("h", "k slot", "v slot"), got, plain()))
        planted_faults(f"fused_whisper_decode_step {label}", got, [
            ("history ignored", with_patch(
                "_self_attention", lambda q, k, v, kh, vh, rnd: attend(
                    q, k, v, kh[:0], vh[:0], rnd))),
            ("the fresh term dropped", with_patch("_self_attention", history_only)),
            ("cross-attention dropped", lambda: plain(v8_=torch.zeros_like(v8))),
            ("t_valid ignored", lambda: plain(t=t_pad)),
            ("the MLP dropped", with_patch("_mlp", lambda hn, *a: torch.zeros_like(hn))),
            ("the final LN dropped", with_patch("_final_norm", lambda xs, wb: xs)),
            ("the wrong layer's cache", lambda: plain(kc_=kc.roll(1, 0), vc_=vc.roll(1, 0))),
        ], rel=2e-2)
        kc_k, vc_k, kc_p, vc_p = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        ms, pms = timed_pair(
            lambda: fws.fused_whisper_decode_step(sw, x, pos, kc_k, vc_k, k8, ks, v8, vs,
                                                  n_heads=h, t_valid=t_valid),
            lambda: fws.fused_whisper_decode_step_plain(sw, x, pos, kc_p, vc_p, k8, ks, v8,
                                                        vs, n_heads=h, t_valid=t_valid), 20)
        log(f"time fused_whisper_decode_step {label}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
        if label == "int8":  # the weights of the slice
            rows.append(("fused_whisper_decode_step",
                         "tpu_audio_torch/csrc/fused_whisper_step.cu",
                         "tpu_audio/ops/pallas/fused_whisper_step.py:303", fws, err, ms, pms))


def single_stream(model_i8, tok, clips, mel, dev, card: str) -> dict:
    """Phase 5: the single-stream slice through the public entry point on
    the int8 decoder tree; returns the launch counts of its run."""
    from tpu_audio_torch.api.results import TranscriptionResult
    from tpu_audio_torch.api.stt import WhisperEngine
    from tpu_audio_torch.models.whisper.pipeline import N_FRAMES, WhisperPipeline, _pad_frames
    from tpu_audio_torch.ops.kernels import cross_kv_attention as ckv
    from tpu_audio_torch.ops.kernels import fused_encoder as fe
    from tpu_audio_torch.ops.kernels import fused_mel
    from tpu_audio_torch.ops.kernels import fused_whisper_step as fws
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm

    cfg = model_i8.cfg
    mods = (fused_mel, fe, ckv, i8mm, fws)
    pipe = WhisperPipeline(model_i8, tok, compute_dtype=torch.bfloat16, kv_int8=True)
    engine = WhisperEngine.from_pipeline(pipe)
    clip = clips[0][:SINGLE_CLIP_SECONDS * 16000]
    stats = {"windows": 0, "decodes": 0, "steps": 0}
    decode = pipe.decoder.decode

    def counted_decode(*args, **kwargs):
        stats["decodes"] += 1
        stats["windows"] += kwargs.get("temperature") == 0.0
        return decode(*args, **kwargs)

    reset(*mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with patched(pipe.decoder, "decode", counted_decode), \
            counting(model_i8, "decode_step", stats, "steps"):
        language, probs = engine.detect_language(clip)
        result = engine.transcribe(clip, language=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(*mods)
    log(f"single-stream launches: {launches}")
    need = ("fused_log_mel", "ln_qkv", "attn_oproj_ln", "fused_whisper_decode_step",
            "int8_matmul", "int8_matmul_stacked")
    if not all(launches[n] > 0 for n in need):
        raise AssertionError(f"a kernel of the single-stream path never launched: {launches}")
    if not isinstance(result, TranscriptionResult) or result.language != language:
        raise AssertionError(f"transcribe returned {result!r}")
    if language not in probs or not math.isclose(sum(probs.values()), 1.0, rel_tol=1e-3):
        raise AssertionError(f"language probabilities {probs}")
    for seg in result.segments:
        if not all(0 <= t < cfg.n_vocab for t in seg.tokens) or not math.isfinite(
                seg.avg_logprob):
            raise AssertionError("token outside the vocabulary or non-finite log-prob")
    log(f"single-stream: STT engine detect_language + transcribe(language=None) of "
        f"{SINGLE_CLIP_SECONDS} s: language {language} (p {probs[language]:.4f}), "
        f"{stats['windows']} windows, {stats['decodes']} decodes (temperature fallback), "
        f"{stats['steps']} decoder steps, {len(result.segments)} segments, "
        f"{wall:.3f} s wall ({card})")

    # timed: one 30 s window, greedy, kernel path then plain path
    window = _pad_frames(pipe.mel_extractor(clips[1][:30 * 16000])[:N_FRAMES], N_FRAMES)

    def timed():
        stats["steps"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counting(model_i8, "decode_step", stats, "steps"):
            r = pipe.decoder.decode(window, language="en", temperature=0.0)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, stats["steps"], r

    timed()  # warm-up
    runs = [timed(), timed()]
    with plain_kernels(*mods):
        plain_run = timed()
    for label, (w, n, r) in [("kernels", runs[0]), ("kernels", runs[1]), ("plain", plain_run)]:
        log(f"single-stream decode ({label}): 1 window, {n} decoder steps "
            f"({len(r.tokens)} tokens), {w:.4f} s, {1e3 * w / n:.4f} ms per step, "
            f"{30.0 / w:.2f}x real time ({card})")
    if runs[0][2].tokens != runs[1][2].tokens:
        raise AssertionError("two greedy decodes of one window disagree")
    # one more under the profiler: device kernels per step and the busy share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w, n, _ = timed()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernels:
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        step_us = [e.time_range.elapsed_us() for e in kernels
                   if "fused_whisper_step_kernel" in e.name]
        log(f"single-stream decode (kernels, profiled): {n} steps, {w:.4f} s traced wall, "
            f"{len(kernels) / n:.1f} device kernels per step, device busy {busy:.1f} ms = "
            f"{busy / (1e3 * w):.3f} of the traced wall, fused step "
            f"{sum(step_us) / max(len(step_us), 1):.1f} us per launch in the loop ({card})")
    else:
        log("single-stream decode (kernels, profiled): the profiler saw no device kernels; "
            "device busy share not measured")

    # kernel path against the f32 plain path on the same int8 codes: the
    # logits of prefill and of three teacher-forced B=1 steps
    init = torch.tensor([tok.sot_sequence()], device=dev)
    forced = [tok.timestamp_begin, 400, 1200]

    def run_path(m, dtype):
        with torch.inference_mode():
            feats = m.encode(mel[:1].to(dtype))
            state = m.init_state(feats, batch=1, dtype=dtype, kv_int8=True)
            out = [m.decode_step(init, state)[0][:, -1]]
            for t in forced:
                out.append(m.decode_step(torch.tensor([[t]], device=dev), state)[0][:, -1])
        return torch.cat(out).float()

    ref_model = copy.deepcopy(model_i8).float()
    with plain_kernels(*mods):
        exact = run_path(ref_model, torch.float32)
        plain_out = run_path(model_i8, torch.bfloat16)
    del ref_model
    kernel_out = run_path(model_i8, torch.bfloat16)
    for name, k, p, r in (("prefill logits (1, 51866)", kernel_out[:1], plain_out[:1], exact[:1]),
                          ("B=1 step logits (3, 51866)", kernel_out[1:], plain_out[1:],
                           exact[1:])):
        _, e_k, cos_k = measure(k, r)
        _, e_p, cos_p = measure(p, r)
        msg = (f"single-stream {name} against f32: kernels rel {e_k:.3e} cosine {cos_k:.6f}, "
               f"plain bf16 rel {e_p:.3e} cosine {cos_p:.6f}, ratio {e_k / e_p:.3f}")
        if not (e_k <= SLICE_RATIO * e_p and cos_k > 0.999):
            raise AssertionError(f"{msg}: outside ratio {SLICE_RATIO} / cosine 0.999")
        log(msg)

    step = fws.fused_whisper_decode_step

    def mlp_dropped(sw, *args, **kwargs):
        w2 = torch.zeros_like(sw.w["fc2"])
        vec = {**sw.vec, "bias_fc2": torch.zeros_like(sw.vec["bias_fc2"])}
        return step(fws.StepWeights({**sw.w, "fc2": w2}, sw.scale, vec), *args, **kwargs)

    faults = {
        "cross-attention dropped": lambda sw, x, pos, kc, vc, k8, ks, v8, vs, **kw: step(
            sw, x, pos, kc, vc, k8, ks, torch.zeros_like(v8), vs, **kw),
        "the wrong layer's cache": lambda sw, x, pos, kc, vc, *a, **kw: step(
            sw, x, pos, kc.roll(1, 0), vc.roll(1, 0), *a, **kw),
        "the MLP dropped": mlp_dropped,
    }
    p_err = measure(plain_out[1:], exact[1:])[1]
    for label, fault in faults.items():
        with patched(fws, "fused_whisper_decode_step", fault):
            faulty = run_path(model_i8, torch.bfloat16)
        _, e_k, cos_k = measure(faulty[1:], exact[1:])
        text = f"step logits ratio {e_k / p_err:.3f} cosine {cos_k:.6f}"
        if e_k <= SLICE_RATIO * p_err and cos_k > 0.999:
            raise AssertionError(f"single-stream: the check cannot see {label} ({text})")
        log(f"control single-stream, {label}: {text}: outside the limit")
    return launches


def mixed_batch(model_i8, tok, clips, wall_bf16: float, card: str) -> dict:
    """Phase 6: bench.py's "bf16-enc + int8 decoder + int8 cross-KV" row at
    batch 16 through transcribe_windows; returns its launch counts."""
    from tpu_audio_torch.models.whisper import batch as wbatch
    from tpu_audio_torch.ops.kernels import cross_kv_attention as ckv
    from tpu_audio_torch.ops.kernels import fused_encoder as fe
    from tpu_audio_torch.ops.kernels import fused_mel
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm

    mods = (fused_mel, fe, ckv, i8mm)
    reset(*mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts, results = wbatch.transcribe_windows(model_i8, tok, clips, batch_size=BATCH,
                                               kv_int8=True, return_results=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(*mods)
    log(f"mixed batch launches: {launches}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the mixed batch path never launched: {launches}")
    if len(texts) != N_CLIPS or len(results) != BATCH or not all(
            math.isfinite(r.avg_logprob) for r in results):
        raise AssertionError("mixed batch: wrong count of texts or windows, or NaN log-prob")
    audio_s = N_CLIPS * CLIP_SECONDS
    log(f"mixed batch: transcribe_windows, {BATCH} windows, bf16 encoder + int8 decoder "
        f"+ int8 cross-KV: {wall:.3f} s wall, {audio_s / wall:.1f}x real time, "
        f"{sum(len(r.tokens) for r in results)} tokens (phase 4, bf16 weights: "
        f"{wall_bf16:.3f} s) ({card})")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    if not (ROOT / "tpu_audio_torch").is_dir():
        raise SystemExit(f"chip_smoke: {ROOT} holds no tpu_audio_torch package")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tpu_audio_torch.models.whisper import batch as wbatch
    from tpu_audio_torch.models.whisper import load as wload
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
    params = wmodel.init_params(SEED, cfg, torch.bfloat16, dev)
    model = wmodel.Whisper(cfg, params)
    # the int8 decoder tree: bf16 encoder (shared), int8 decoder and lm head
    model_i8 = wmodel.Whisper(cfg, wload.serve_tree_int8(params, encoder=False))
    del params
    torch.cuda.synchronize()
    log(f"models: large-v3-turbo random bf16 weights (seed {SEED}) and their int8 "
        f"decoder tree in {time.perf_counter() - t0:.1f} s")

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

    check_int8_matmul(model_i8, randn, rows)
    check_decoder_step({"int8": model_i8, "bf16": model}, cfg, dev, randn, rows)
    for name, *_, ms, pms in rows:
        log(f"time {name}: kernel {ms:.4f} ms, plain {pms:.4f} ms ({card})")

    # ------------------------------------------------------- 4. the slice
    tok = WhisperTokenizer(BPE({bytes([i]): i for i in range(256)}), True,
                           cfg.num_languages)
    rng = np.random.default_rng(SEED)
    clips = [(rng.standard_normal(CLIP_SECONDS * 16000) * 0.1).astype(np.float32)
             for _ in range(N_CLIPS)]
    kernel_mods = (fused_mel, fe, ckv)
    reset(*kernel_mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts, results = wbatch.transcribe_windows(model, tok, clips, batch_size=BATCH,
                                               kv_int8=True, return_results=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(*kernel_mods)
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
        with patched(fe, "attn_oproj_ln", fault):
            faulty = run_path(model, torch.bfloat16)
        readings = []
        for k, p, r in zip(faulty, plain_out, exact):
            _, e_k, cos_k = measure(k, r)
            readings.append((e_k / measure(p, r)[1], cos_k))
        text = ", ".join(f"{name.split(' (')[0]} ratio {q:.3f} cosine {c:.6f}"
                         for name, (q, c) in zip(outputs, readings))
        if all(q <= SLICE_RATIO and c > 0.999 for q, c in readings):
            raise AssertionError(f"slice: the check cannot see {label} ({text})")
        log(f"control slice, {label}: {text}: outside the limit")

    # ------------------------------------------- 5. single stream, 6. mixed
    single = single_stream(model_i8, tok, clips, mel, dev, card)
    launches.update({name: single[name] for name in
                     ("fused_whisper_decode_step", "int8_matmul", "int8_matmul_stacked")})
    del model
    mixed_batch(model_i8, tok, clips, wall, card)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": pms}
        for name, src, replaces, _, err, ms, pms in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
