#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tpu_audio_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from `tpu_audio_torch/csrc/` with nvcc (one
     process per source, all at once); print the build's warnings and the
     TMA + wgmma kernels' ptxas lines and wgmma (HGMMA, IGMMA) counts, and
     fail on a spill;
  3. hold each kernel against its plain PyTorch version at the shapes of
     Whisper large-v3-turbo (a 30 s chunk for the mel, with its float64
     gate on a tone over faint noise and exact zeros; batch-16
     transcription for the encoder
     and cross-attention kernels; the int8 decoder's and lm head's shapes
     every int8 decoder linear and the heads at 1, 4, 16 and 32 rows, bit
     for bit, for the int8 matmuls; the B=1 step for the
     whole-decoder step), and time both with CUDA events; hold
     attn_oproj_ln and the decoder step once more on inputs where every
     term is as large as the residual, and show that each of a set of
     planted faults (applied to the plain version) lands outside the limit;
     the cross-attention at batch 16 and B=1 and t_valid 1, 1000 and 1500
     (rel 2e-2 and cosine 0.999 beside its atol 2e-2) with five faults
     (the last key tile, t_valid, the V scale, the layer, a cluster rank's
     partial), the decoder step in both trees at pos 0, 1, 200 and 447 and
     t_valid 1, 750 and 1500 with up to twelve (a chunk's sum dropped from
     a head's merge, a head's last chunk dropped, fc1 of the next layer
     among them);
  4. transcribe 4 two-minute clips (16 windows, one batch of 16) with
     `transcribe_windows` on random bf16 weights and the int8 cross-K/V
     state, check the launch counters (one log-mel launch a clip), tokens
     and log-probs, print the wall
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
     the int8 decoder tree, wall time beside phase 4's; then its decode step
     alone (`tpu_audio_torch/tools/batch_step.py`): ms a step and device
     kernels a step (the profiler);
  7. the full-w8a8 rows (`serve_tree_int8`: int8 encoder, decoder and lm
     head, int8 cross-K/V): the int8 encoder's time at batch 16 against the
     bf16 encoder's, their features' cosine, `transcribe_windows` of phase
     4's clips, the STT engine at B=1 (detect_language + transcribe of 4 s,
     a timed 30 s window), and the kernel path against the f32 plain path on
     2 windows with faults planted in the int8 encoder chain.

  8. Fun-ASR-Nano at full width (SenseVoice encoder, adaptor, Qwen3-0.6B
     decoder) on random weights through `STT.funasr()` →
     `FunASREngine.from_params` → transcribe and translate of a 10 s clip,
     on the bf16 tree and the q4 and int8 LLM trees; the launch counters,
     the split of a transcribe (encode, prefill, ms per decode step), and
     the kernel path against the f32 plain path on the prefill logits and
     three teacher-forced steps, with faults planted in the whole-stack step.
  9. (run after 7, before 8) Whisper on the mlx group-affine q4 and q8
     trees, which take the per-op encoder around `encoder_attention` and
     `quant_matmul` for every decoder linear: the STT engine at B=1 on q4
     (detect_language, transcribe with word timestamps, a timed 30 s
     window, the f32 comparison with planted faults), `transcribe_batch` of
     phase 4's clips at batch 16, a q8 transcribe; then the bf16 per-op
     encoder (pair-packed and head-major attention) against the fused one
     at batch 16: times by CUDA events, launches, features' cosine.

 10. (run last) Orpheus at Llama-3.2-3B width through `TTS.orpheus()` →
     `OrpheusEngine.from_params` with the full-size SNAC: on the W4A8 tree
     (the q4 tree, tied embedding included, repacked) `generate_streaming`
     at TOKEN granularity, `generate` and `generate_batch` of 8 texts, ms
     per step at B=1 and tokens/s at B=8 of the LM alone, device kernels
     per step, SNAC ms per window, the streamed SNAC windows against the
     one-shot decode of given frames; one `generate` on the engine's
     default w8a8 tree (the whole-stack step at 3B); the super-group tree
     of `benchmarks/llm_decode.py --w4a8sg` greedy at B=1 and B=8; the W4A8
     kernel path against the f32 plain path on teacher-forced logits, with
     faults planted in the W4A8 kernels.
 11. (run last) checkpoints in, audio files in and out, at full width from
     seed-0 random weights written into a temporary directory by the
     script's own safetensors writer (the card has no `safetensors`): (a)
     Whisper large-v3-turbo in the mlx-community 8-bit layout with a
     50,257-rank `multilingual.tiktoken`, through `STT.whisper(
     "large-v3-turbo", "w8a8", repo=dir).load()`: its tree against
     `serve_tree_int8` of the written q8 tree bit for bit, `transcribe` and
     `transcribe_batch(kv_int8=True)` token for token against
     `from_pipeline` on that tree, and a 44.1 kHz WAV by its path against
     `load_audio`'s array; (b) Fun-ASR-Nano in the mlx 4-bit layout with a
     `tokenizer.json` (Qwen's pattern, NFC, the chat and speech tokens) in
     a pre-seeded Hugging Face cache, through `STT.funasr().load()`: the eos
     ids, the tree, and the tokens of `from_params`; (c) Orpheus (the mlx
     4-bit Llama-3.2-3B and SNAC 24 kHz, a `tokenizer.json` of Llama-3's
     pattern) through `TTS.orpheus().load()` and `TTS.orpheus(
     quantization="w4a8").load()`: the served trees and greedy tokens
     against `from_params`, and `AudioResult.save` read back by `read_wav`;
     (d) Chatterbox and Chatterbox Turbo in the mlx 4-bit layouts (the
     q4 T3s at full width, S3Gen, the voice encoder, S3TokenizerV2) through
     `TTS.chatterbox("4bit").load()` and `TTS.chatterbox_turbo("4bit")
     .load()`: every tree against the written one bit for bit and greedy T3
     tokens against the written tree's; (e) Kokoro-82M in the
     mlx-community bf16 layout with a voice pack, through
     `TTS.kokoro().load()`: the tree bit for bit, the pack, the audio
     against `from_params`; (f) the `tokenizer.json` reader and
     the Whisper BPE, `regex` blocked, on the golden texts of
     tests/data/tokenizer_golden/. Each run asserts
     its kernels' launches; the bytes written and each engine's write and
     load walls are printed beside the card line.
 12. (run last) OuteTTS at full width (the Llama-3.2-1B of
     `benchmarks/engines.py`, vocab 134,400, and the published DAC) on
     random weights through `TTS.oute()` → `OuteTTSEngine.from_params`,
     unconditioned: on the w8a8 tree (the q4 tree requantised: the
     whole-stack step at hd 64 and the int8 head) and the bf16 tree,
     `generate_streaming` of two sentences and `generate_batch` of 4 texts
     at 196 new tokens, with one whole-stack step launch a decode step at
     B=1 and the head's `int8_matmul` a step asserted, and ms a token of the
     LM alone; the LM's kernel route at f32 activations (the prefill and 8
     steps, each fed the f32 path's token) against the per-op path in f32
     through the logits, at B=1 on both trees and at B=4 on w8a8, the
     plain versions of the route as the yardstick, planted faults in the
     step (pad slots attended, RoPE backwards) and in `int8_matmul` (the
     last 64 input features dropped) refused, each at least
     CV_FAULT_RATIO (5×) the plain route's distance, the stack's q and k
     scaled by 3 for it; one `generate` with speculative="ngram" (its int8
     matmuls at 5 rows held against their plain versions); DAC: 150 frames (2 s)
     through `_decode_dac` and an `encode`
     of 2 s of noise timed by CUDA events, the card's decode against the
     host's f32 one (rel 1e-4), `extract_codes` → `_decode_dac` on a
     string of known c1/c2 runs, the published layout written and read back
     by `load_dir`, and a `convert_dac` that leaves the Snake alphas
     (1, C, 1) refused.
 13. (run last) Marvis at full width (`MarvisConfig()`: the 250M backbone,
     hd 64, and the depth decoder, hd 128, 32 codebooks of 2048;
     `MimiConfig()`) through `TTS.marvis("max")` →
     `MarvisEngine.from_params(max_frames=25)` on the bf16 and w8a8 trees:
     FRAME streaming of one sentence, ms a frame against the 80 ms of
     12.5 Hz and the first chunk's latency, the whole-stack step's launches
     asserted (32 a frame for the depth decoder, 1 a frame for the backbone
     after the prefill); on each tree the prefill and one frame on the
     kernel route at f32 activations against the per-op path in f32
     through the logits of all 64 draws (each forced to the f32 path's
     code), the plain versions of the route as the yardstick, two planted
     faults in the step refused and, on w8a8, one in the prefill's
     `int8_matmul`; `kv_quantized=True` on w8a8 (the backbone per layer
     over the int8 cache: FRAME streaming, its codebook-0 logits against
     the bf16 cache's, the scales dropped on read refused);
     the streaming Mimi decoder against the whole decode (rel 1e-4).
 14. (run last) CosyVoice2 at full width on random weights
     (`CosyLMConfig()`'s Qwen2-0.5B, `S3GenConfig()`,
     `S3TokenizerConfig()`, `CAMPPlusConfig()`; a word-level stand-in for
     the text tokenizer) through `TTS.cosyvoice2()` →
     `CosyVoice2Engine.from_params` on the w8a8 and bf16 trees:
     `prepare_conditionals` on 3 s of noise, `generate_streaming` of two
     sentences at TOKEN granularity (first audio, × real time),
     `generate` of one sentence, `voice_conversion` of 2 s, one
     whole-stack step launch a T=1 step and on w8a8 one head
     `int8_matmul` a step asserted, the LM's ms a token, its kernel route
     at f32 activations against the per-op path in f32 through the speech
     logits with four planted faults at least 5× the plain route's
     distance (the qkv bias, the GQA group, RoPE, the head's bias); a
     short W4A8 `generate`; the flow's ms a window and HiFT's ms a chunk;
     HiFT's streamed windows against one pass (rel 1e-4, f32).
 15. (run last) Speculative decoding: Orpheus at Llama-3.2-3B width on
     the w8a8 and W4A8 trees through `TTS.orpheus(speculative=…)`, by
     prompt lookup and by a Llama-3.2-1B `DraftModel` (w8a8), and
     CosyVoice2's speculative token stream: every int8 and W4A8 matmul call
     (the verify's 5 rows) held against its plain version, launches, ms
     and tokens an iteration; each route's loop (sampled) held against f32
     (verify and draft logits against a fresh prefill of the true prefix)
     with the target rewound one short and the draft not rewound planted;
     the accept step's marginal (χ²) with the residual taken from p.
 16. (run last) CosyVoice3 at the published widths (the Qwen2-0.5B LM on
     w8a8, `CV3FlowConfig()`'s DiT 1024 × 22 and HiFT in bf16,
     `S3TokenizerConfig()`) through `TTS.cosyvoice3()`: the speaker, two
     sentences streamed at TOKEN granularity, voice conversion, the LM
     against f32 with its faults, the O(1) flow against the full window
     (f32), the flow's and HiFT's ms a chunk, the O(1) flow's drift over
     40 chunks.
 17. (run last) Chatterbox and Chatterbox Turbo at full width on random
     weights (`T3Config()`'s Llama-520M and `T3TurboConfig()`'s GPT-2
     medium on bf16, q4 and q8 trees, `S3GenConfig()` with the CFG and the
     meanflow estimators, `S3TokenizerConfig()`, `VoiceEncConfig()`)
     through `TTS.chatterbox()` and `TTS.chatterbox_turbo()` on the q4
     trees: the speaker from a 10 s clip (its wall), one sentence each
     (first audio, × real time; Turbo at SENTENCE and TOKEN granularity),
     every `quant_matmul` call of a generate held against its plain
     version on each T3 and tree, the T3s' teacher-forced logits, the
     voice encoder and Turbo's meanflow flow held against f32 with planted
     controls (CFG's sign, the unconditional row's text, the pad mask, the
     perceiver's self pass, the LSTM's i and f gates, Turbo's positions,
     the mixer's (t, t), a cosine t grid), each T3's ms a token and
     `quant_matmul` launches a step, the flows' and HiFT's ms.
 18. (run last) Kokoro-82M at full width on random f32 weights
     (`kokoro_params`) through `TTS.kokoro()` → `KokoroEngine.from_params`
     with its default voice pack: three sentences streamed (first audio,
     × real time, the phonemizer backend), each sentence's ids, mean
     duration, frame bucket, seconds and stage 1 / stage 2 ms, the first
     sentence's device kernels (the profiler); the sentences held against
     an f64 route of the port on the host with the card's source spectrum
     injected (durations equal, d, t_en, F0 and N within KOKORO_REL), and
     five planted faults (pool's I and O swapped, the BiLSTM's backward
     pass from the padded tail, instance-norm statistics over the padding,
     the alignment one frame late, ups' weight norm per output channel).
     No kernel is on Kokoro's path: `encoder_attention` must not launch.
 19. Serving and playback: Orpheus's LM at Llama-3.2-3B width
     on random weights under `api/serving.ContinuousBatcher` (batch 8,
     spans of 16, prompt bucket 64, a ring of 2048 slots, greedy under a
     repetition penalty): 24 requests on the w8a8 tree (8 up front, one
     more after each span) and 8 on the W4A8 tree: spans, occupancy,
     tokens/s, ms a span and an admission by CUDA events, first-token and
     whole-request latency, the launch rule counted (4 linears a layer and
     the head a step), every int8 / W4A8 call of
     one span held against its plain version; the batcher's logits of two
     requests admitted into recycled rows at different positions against
     f32 with four planted faults (a stale row mask, RoPE at absolute
     slots, the KV window one slot late, the left pad unmasked); each
     request against its single-stream `generate` (a first difference
     must be a near tie); ROADMAP C26 and C27 at 3B (a request that does
     not fit waits, the idle position rewinds); `say` on the w8a8 engine
     into a PlayerSink on the null output and a FileSink (first audio,
     × real time, the samples played, the WAV read back, one whole-stack
     step a decode step); memory snapshots and the profiler's summary.
 20. (run last) Whisper fine-tuning through `training.train`, on the
     training route (the JAX XLA formulation in autograd ops: no kernel has
     a backward, and the wrappers refuse a tensor that requires a
     gradient): 5 AdamW steps at large-v3-turbo width on random f32
     weights at batch 2 with unequal masks (ms a step by CUDA events, peak
     memory, a falling loss, every leaf's gradient finite and non-zero at
     the first step, no kernel launched); the route in f32 against f64 at
     full width and 2 + 2 layers with four planted faults; `evaluate` of
     the trained tree through the fused bf16 encoder (rows 2-3, one launch
     a layer each) against the route's f32 features and loss, with a stale
     `Whisper` (built before the steps) as the control; `make_mesh()` as a
     world of one on NCCL and `train(mesh=...)`'s losses against the
     first steps'; the grad guard.
 21. tensor-parallel serving: (a) a world-of-one NCCL mesh at
     Llama-3.2-3B width on the w8a8, W4A8 and q4 trees, the first steps'
     f32 logits and a sampled generate's tokens of
     `CausalLMGenerator(mesh=)` bit for bit those of `mesh=None` on the
     same per-layer route, ms a token of both in turns, an all-reduce's
     device time, the launches; (b) tp 2 and 4 rank by rank in this process
     on one 3B layer of each tree and the super-group one: every kernel call
     on the ranks' local shapes held against its plain version (rows 12-17
     and 19), the column blocks against the unsharded product, the
     row-parallel sum at most 1.5× as far from the exact f32 product as the
     unsharded kernel plus a bf16 half-ulp a partial, cosine 0.999 to the
     unsharded product; the super-group tree refused at tp 8; (c) three controls
     ≥ 5× against the exact f32 product: the fused qkv / gateup unpermuted,
     a rank's partial dropped, a rank handed the next rank's shard; (d)
     `TTS.orpheus(mesh=)`'s sentence through SNAC equal to the unsharded
     per-layer engine's; (e) CosyVoice2 (fp LM, the flow by local shards
     under flow_rules) and `CosyVoice3Engine.from_params(mesh=)` at world
     one: each LM's tokens and a 2 s voice conversion (flow and HiFT) equal
     to its unsharded per-layer engine's.
 22. the examples: the port's console (`examples/webapp.py --tiny`) on
     127.0.0.1 answering the page, a TTS WAV, an SSE stream and an STT
     upload; `batch_serving`'s `transcribe_batch` and Orpheus
     `generate_batch` at full width, one layer deep, on random weights.
     Phases 12 to 22 print their walls and their launches on lines of
     their own. Every end-to-end control must read at least 5× the plain
     route's distance from f32 (phase 20: from f64); each prints its ratio.

Phase 3 also holds `ln_qkv` at batch 16 and B=1 on offset rows with
seven planted faults (a partial last row tile among them), `attn_oproj_ln`
at t_valid 1, 1000 and 1500 and B=1 with ten (the tail row tile, a tile
straddling two batches, each head's output in the next head's columns
among them) and its two launches alone (`attn_heads`' scratch within rel
2e-2, `oproj_ln` on the plain scratch within a bf16 ulp, with the last
head's k-stage dropped and LayerNorm2 over one block planted), the
encoder-attention kernel (both entries, all three layouts) at batch 16 and
B=1 and at t_valid 1, 1000 and 1500, with five faults (the last partial key
tile dropped among them), the four W8A8 encoder-block kernels against
their plain versions on block 0 of the w8a8 tree at batch 16 and B=1
(`attn_oproj_ln_int8` at t_valid 1, 1000 and 1500; the two launches of
`ln_qkv_int8` and of `attn_oproj_ln_int8` held alone too: the codes and
scales of LayerNorm1 and of the pair attention, each GEMM on the plain codes
bit for bit; fc1's codes and row scales judged themselves; planted faults
of the cluster exchanges, tile edges, k stages, scales and head layout),
each launch timed apart beside SDPA or `torch._int_mm`, the q4/q8
dequant-matmul and the whole-stack Qwen3 step at Fun-ASR-Nano's shapes,
and the four W4A8 kernels at Llama-3.2-3B's (the heads, gateup and down
at 1, 8 and 32 rows, with faults of the kernel's design at 1 and 8: a row
scale from part of the row, a warp's share dropped, scales one group pair
off; the two stacked ones also timed at each of a layer's qkv, o, gateup and
down shapes at 1 and 8 rows, on one layer and on the layers in turn), with
planted faults on inputs where every term matters. Each
kernel is
timed beside its bound (the larger of its operations over the H100's dense
peak for their type and its bytes over 3.35 TB/s) and, where one PyTorch
call computes the same function or its product, that call's time.

`python3 chip_smoke.py --decode-only` runs phases 1, 2, the two decode
kernels' part of phase 3 (the cross-attention and the decoder step with
their planted faults), and phases 4 and 5: a short check of
`csrc/cross_kv_attention.cu` and `csrc/fused_whisper_step.cu`.
`python3 chip_smoke.py --funasr-only` runs phases 1, 2, Fun-ASR's part of
phase 3, and phase 8: a short check of the Fun-ASR kernels.
`python3 chip_smoke.py --q4-only` runs phases 1, 2, encoder attention's
part of phase 3, and phase 9: a short check of the per-op encoder and the
q4/q8 trees. `python3 chip_smoke.py --orpheus-only` runs phases 1, 2, the
W4A8 kernels' part of phase 3, and phase 10. `python3 chip_smoke.py
--encoder-only` runs phases 1, 2, the bf16 encoder kernels' part of phase 3
(`ln_qkv`, `attn_oproj_ln`, encoder attention) and phase 9's fused against
per-op encoder at batch 16: a short check of the TMA + wgmma kernels.
`python3 chip_smoke.py --int8-only` runs phases 1, 2, the W8A8
weight-streaming matmuls' part of phase 3 (`check_int8_matmul`) and phase
6: a short check of `csrc/int8_matmul.cu`.
`python3 chip_smoke.py --mel-only` runs phases 1, 2, the log-mel's part of
phase 3 (noise against the plain version, the dynamic-range gate against
float64, a misaligned signal refused, four planted faults, a chunk and a
150 s clip against the plain version and timed) and `MelExtractor` on phase
4's clips, one launch a clip, against the plain path: a short check of
`csrc/fused_mel.cu`.
`python3 chip_smoke.py --load-only` runs phases 1, 2 and 11: a short check
of the checkpoint, tokenizer and audio-file layer on the card (~30 s).
`python3 chip_smoke.py --tts-only` runs phases 1, 2, 12 and 13: a short
check of the OuteTTS and Marvis engines, DAC and Mimi.
`python3 chip_smoke.py --cosyvoice-only` runs phases 1, 2 and 14: a short
check of the CosyVoice2 engine, S3Gen and the S3 tokenizer.
`python3 chip_smoke.py --spec-only` runs phases 1, 2 and 15 (speculative
decoding); `--cosyvoice3-only` phases 1, 2 and 16 (CosyVoice3);
`--chatterbox-only` phases 1, 2 and 17 (Chatterbox and Chatterbox Turbo);
`--kokoro-only` phases 1, 2 and 18 (Kokoro); `--serve-only` phases 1, 2
and 19 (serving and playback); `--train-only` phases 1, 2 and 20 (Whisper
fine-tuning at large-v3-turbo width: `training.train`'s steps, the route
against f64, `evaluate` through the fused encoder, a world-of-one mesh).
`--mesh-only` runs phases 1, 2 and 21 (tensor-parallel serving);
`--examples-only` phases 1, 2 and 22 (the examples).
`python3 chip_smoke.py --w8a8-only` runs phases 1, 2, the four W8A8
encoder kernels' part of phase 3 and phase 7's int8 against bf16 encoder at
batch 16: a short check of `csrc/fused_encoder_int8.cu` and
`csrc/attention_wgmma.cuh`.

The second line from the end is a JSON object describing each kernel; the
last line is `{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
STEP_POS, STEP_START = 300, 40  # the Qwen3 step's position and first valid slot in phase 3
# the Llama-3.2-3B step's in phase 3: a 32-slot prompt bucket, 100 tokens on
LLAMA_STEP_POS, LLAMA_STEP_START, LLAMA_STEP_SLOTS = 132, 4, 256
COLD_BYTES = 160 << 20       # stacked copies enough that a timed call finds its weights out of L2
# quant_matmul's shapes in phase 3, (O, I): each linear of the q4 decoders
# (Whisper large-v3-turbo; Qwen3-0.6B as the per-layer path runs it) and
# both heads, at these rows
QMM_SHAPES = {"whisper q, k, v, o, cross q, o": (1280, 1280), "whisper fc1": (5120, 1280),
              "whisper fc2": (1280, 5120), "qwen3 q": (2048, 1024), "qwen3 k, v": (1024, 1024),
              "qwen3 o": (1024, 2048), "qwen3 gate, up": (3072, 1024),
              "qwen3 down": (1024, 3072), "whisper head": (51866, 1280),
              "qwen3 head": (151936, 1024)}
QMM_ROWS = (1, 2, 16, 32)
# the int8 matmuls' rows in phase 3, and their shapes beyond the Whisper
# decoder's own, (O, I), on random codes: Qwen3-0.6B's int8 head and
# Llama-3.2-3B's down projection (stacked)
I8_ROWS = (1, 4, 16, 32)
I8_SHAPES = {"qwen3 head": (151936, 1024), "llama-3.2-3b down": (3072, 8192)}
# the hd-64 instantiations of the whole-stack step, held on two layers at
# Llama-3.2-1B's width
HD64_STACK = dict(dim=2048, n_layers=2, n_heads=32, n_kv_heads=8, head_dim=64, hidden_dim=8192,
                  vocab_size=128256)
FUNASR_CLIP_SECONDS = 10     # phase 8's clip
FUNASR_MAX_NEW = 48          # tokens per transcribe (random weights rarely stop early)
FUNASR_CACHE = 1024          # prompt (~370 slots for 10 s) + new tokens
ORPHEUS_MAX_NEW = 70        # phase 10's tokens per generate (10 frames; cut from 98 for time)
ORPHEUS_BATCH = 8            # phase 10's generate_batch rows
# the 3b model of benchmarks/llm_decode.py (its --w4a8sg tree): Llama-3.2-3B
# layers, vocab 128266, an untied head, RoPE theta 10000 unscaled
SG_3B = dict(dim=3072, n_layers=28, n_heads=24, n_kv_heads=8, hidden_dim=8192,
             vocab_size=128266)
ORPHEUS_TEXTS = ["Hello from the card!", "A sentence to say.", "Twenty tokens a second?",
                 "Let us hear the voice.", "One, two, three.", "The weights are random.",
                 "Speak softly now.", "Last one of eight."]
# phase 12: OuteTTS's Llama-3.2-1B (benchmarks/engines.py build_outetts: an
# untied head, vocab 134,400, llama3 RoPE) and the published DAC
OUTE_LLM = dict(dim=2048, n_layers=16, n_heads=32, n_kv_heads=8, hidden_dim=8192,
                vocab_size=134400, rope_theta=500000.0,
                rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                              "high_freq_factor": 4.0, "original_max_position_embeddings": 8192})
OUTE_MAX_NEW = 196           # phase 12's new tokens per generate
OUTE_STREAM_TEXT = ("This first sentence is long enough to stand on its own. "
                    "And a second one, to make two.")
OUTE_TEXTS = ORPHEUS_TEXTS[:4]
OUTE_HELD_STEPS = 8          # phase 12's steps held against f32, each fed the f32 path's token
QK_SCALE = 3.0               # held trees where a fault of positions must show: q, k rows × this
ORPHEUS_SCALE_SPREAD = 2.0   # phase 10's held W4A8 tree for the scale swap: odd / even groups
DAC_FRAMES = 150             # 2 s at 75 frames a second
DAC_REL = 1e-4               # the card's f32 DAC decode against the host's
MARVIS_MAX_FRAMES = 25       # phase 13's frames a sentence: 2 s at 12.5 Hz
MARVIS_TEXT = "Hello from the card."  # "[0]" + 20 bytes: one prompt bucket of 32 rows
MIMI_REL = 1e-4              # the streaming Mimi decode against the whole one, on the card
# phase 14: CosyVoice2 (Qwen2-0.5B, S3Gen, the S3 tokenizer, CAMPPlus) at full width
CV_TEXTS = ("This first sentence is long enough to stand on its own here.",
            "And the second one follows it in the same request today.")
CV_REF_TEXT = "A reference speaker reads these words aloud."
CV_REF_SECONDS, CV_VC_SECONDS = 3, 2  # prepare_conditionals' audio, voice_conversion's
CV_HELD_STEPS = 8            # steps held against f32, each fed the f32 path's token
CV_FAULT_RATIO = 5.0         # a planted fault's distance from f32 over the plain route's
CV_QK_BIAS = 3.0             # the random LM's q and k biases, uniform in ±this
CV_W4A8_NEW = 32             # the short w4a8 generate's tokens (one 32-token bucket)
CV_TIMED_NEW = (32, 160)     # the LM alone: generate at these max_new; ms a token between
CV_VOC_ENDS = (40, 80, 120)  # the streamed HiFT windows' right edges (mel frames)
CV_VOC_EDGE = 16             # frames before a window's edge outside its right context
CV_VOC_REL = 1e-4            # the streamed HiFT windows against one generate, f32
SPEC_GAMMA = 4               # phase 15's drafts a verify: 5 rows through the int8 and W4A8 matmuls
SPEC_NEW = 32                # phase 15's tokens a sentence through the Orpheus engine
SPEC_CV_TEXT = "Spans of drafts stream this."  # phase 15's CosyVoice2 sentence: 100 tokens
SPEC_HELD_NEW = 12           # phase 15's loops held against f32: tokens a loop
SPEC_CHI2_ROWS = 100_000     # phase 15's accept step on the card: rows in one call
SPEC_CHI2_LIMIT = 20.5       # χ²(5) at p-value 1e-3: the accept step's marginal against p
KV8_REL = 5e-2               # phase 13: the int8 cache's backbone logits against the bf16 cache's
CV3_STREAM_TEXTS = CV_TEXTS  # phase 16's two sentences
CV3_O1_CHUNKS = 3            # phase 16's aligned chunks of the O(1) flow against the full window
CV3_O1_REL = 1e-4            # ... in f32
CV3_DRIFT_CHUNKS = 40        # phase 16's O(1) stream for the drift of its chunk times
CB_REF_SECONDS = 10          # phase 17's reference clip (both crops: 6 s for T3, 10 s for S3Gen)
CB_TEXT = CV_TEXTS[0]        # phase 17's streamed sentence
CB_SHORT_IDS = 3             # phase 17's pad-mask control: text ids (29 of 32 slots padding)
CB_MAX_NEW = 150             # phase 17's speech tokens a sentence (6 s of audio)
CB_HELD_NEW = 8              # phase 17's generate whose quant_matmul calls are held
CB_HELD_STEPS = 8            # T3 steps held against f32, each fed the f32 path's token
CB_TIMED_NEW = (8, 32)       # T3 alone: generate at these max_new; ms a token between
CB_FLOW_TOKENS = (75, 50)    # phase 17's flow held against f32: prompt, generated tokens
CB_TIME_SCALE = 4.0          # the held meanflow tree's time MLP and mixer × this
KOKORO_TEXT = ("This first sentence is long enough to stand on its own here. "
               "The second one follows it and is a little longer than that. "
               "A third sentence closes the paragraph, so three chunks stream.")
KOKORO_DUR_BIAS = -2.75      # duration_proj's bias: ~3 frames a token (50 × sigmoid(−2.75))
KOKORO_REL = 1e-4            # phase 18: d, t_en, F0 and N on the card against the f64 route
KOKORO_F64_SENTENCES = 1     # phase 18's sentences held against the f64 route (cut from 3)
QMM_T3_SHAPES = {"t3 q, k, v, o": (1024, 1024), "t3 gate, up / turbo fc1": (4096, 1024),
                 "t3 down / turbo fc2": (1024, 4096), "t3 speech head": (8194, 1024)}
QMM_T3_ROWS = (1, 2)         # Turbo's B=1 and Chatterbox's CFG batch of 2
SERVE_BATCH = 8              # phase 19's rows
SERVE_SPAN = 16              # steps a span
SERVE_BUCKET = 64            # prompt bucket: an admission's prefill is 64 rows (int8_matmul_bigm)
SERVE_RING = 2048            # the generator's max_cache: the batch's shared ring
SERVE_REQUESTS = 24          # (a)'s requests on the w8a8 tree
SERVE_W4A8_REQUESTS = 8      # (b)'s on the W4A8 tree
SERVE_PROMPT = (20, 60)      # prompt tokens, inclusive
SERVE_NEW = (48, 96)         # max_new, inclusive
SERVE_PENALTY = dict(temperature=0.0, repetition_penalty=50.0, repetition_window=20)
SERVE_SMALL_RING = 128       # (e)'s ring: R2's budget (49 slots) does not fit behind R1 at 80
SERVE_NEAR_TIE = 0.05        # a first difference: the routes' logits apart by ≤ this of max|logit|
SAY_TEXT = "Hello from the card!"  # (f)'s sentence
SAY_NEW = 280                # (f)'s tokens: random weights emit a code ~1 token in 5.5
TRAIN_STEPS = 5              # phase 20 (a)'s AdamW steps at full width
TRAIN_LR = 1e-3              # 5 steps move a leaf ~5e-3, past bf16's step at its ~3e-2: (c)'s control
TRAIN_TOKENS = (16, 32)      # the batch's two token streams: unequal masks (15 and 31 tokens)
TRAIN_DEPTH64 = 2            # (b): encoder and decoder layers of the f64 comparison
TRAIN_MESH_STEPS = 2         # (d)'s steps on the world-of-one mesh
TRAIN_MESH_REL = 1e-5        # (d): its losses against (a)'s, where DTensor's decompositions round
TRAIN_LOSS_REL = 1e-2        # (c): evaluate's bf16 loss against the training route's f32 loss
TRAIN_MEM_GB = 45.0          # (a)'s expected peak: 13 GB of leaves, gradients, moments; ~1 GB a layer
MESH_NEW = 28                # phase 21 (a): tokens a generate at Orpheus-3B width
MESH_LOGIT_STEPS = 3         # (a): greedy steps after the prefill whose f32 logits are held
MESH_TPS = (2, 4)            # (b): tensor-parallel widths served rank by rank in one process
MESH_ROWS = (1, 8)           # (b): rows of x a product
MESH_SUM_ULP = 2.0 ** -9      # (b): a partial's bf16 rounding before the sum (half an ulp)
MESH_TTS_NEW = 280           # (d): the engines' tokens: random weights emit a code ~1 in 5.5
MESH_CV_TEXT = "Hello from the card."  # (d): the Orpheus engines' sentence
MESH_CV_NEW = 48             # (e): the CosyVoice LMs' tokens
MESH_CV_SECONDS = 2          # (e): the voice conversion's source audio
EXAMPLE_LAYERS = 1           # phase 22: batch_serving's depth (full width)
EXAMPLE_CLIPS = (3, 5)       # phase 22: batch_serving's clips (s)
SPIN_CYCLES = 50_000_000     # ~25 ms at the H100's clock: covers queuing a timed loop
# pair_codes' scales against the plain ones: where one key holds most of a
# row's weight, the kernel and the plain version may round its probability
# to neighbouring bf16 values (their exp arguments differ in the last bits),
# which moves the row's |max| by up to a bf16 ulp, 2^-7 of itself at most
PAIR_SCALE_REL = 2.0 ** -7
# H100 SXM dense peaks (NVIDIA's data sheet, no sparsity; f32 and f64
# outside the tensor cores) and memory rate
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "f64": 34e12}
HBM_BYTES_PER_S = 3.35e12


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


UNDER_FAULT_RATIO: list = []  # controls read under CV_FAULT_RATIO, refused at the end


def control_ratio(tag: str, label: str, ratios, text: str,
                  yardstick: str = "the plain route's distance from f32") -> float:
    """An end-to-end control's reading: the largest of `ratios` (each
    output's distance from f32 over the plain route's, or over another
    `yardstick`). Logs it; a reading under CV_FAULT_RATIO is kept and
    refused by `refuse_weak_controls`, after every phase has printed its
    readings."""
    ratio = max(ratios)
    seen = ratio >= CV_FAULT_RATIO
    log(f"control {tag}, {label}: {text}: {ratio:.3f}x {yardstick} "
        + (f"(>= {CV_FAULT_RATIO}x)" if seen else f"UNDER {CV_FAULT_RATIO}x"))
    if not seen:
        UNDER_FAULT_RATIO.append(f"{tag} {label}: {ratio:.3f}x")
    return ratio


def refuse_weak_controls() -> None:
    """Raise if an end-to-end control read under CV_FAULT_RATIO."""
    if UNDER_FAULT_RATIO:
        raise AssertionError(f"controls under {CV_FAULT_RATIO}x the plain route's distance "
                             f"from f32: {UNDER_FAULT_RATIO}")


def held_against_f32(tag: str, outputs, exact, p_err, label: str, out, control: bool,
                     p_cos=None) -> None:
    """End to end: each of `out` at most SLICE_RATIO times as far from the
    f32 plain path's `exact` (max|Δ|/max|ref|) as the plain bf16 path is
    (`p_err`), with cosine > 0.999, or, given the plain bf16 path's cosines
    `p_cos` (a stack whose plain path itself is under 0.999), with 1 −
    cosine at most SLICE_RATIO times the plain path's. Where the plain path
    equals `exact` (p_err 0: no rounding of its own on that output), the
    output must equal it too. A control (`out` from a planted fault) must
    land at least CV_FAULT_RATIO times as far from f32 as the plain path on
    at least one output (`control_ratio`)."""
    readings = []
    for k, r, pe in zip(out, exact, p_err):
        _, e, c = measure(k, r)
        readings.append((e / pe if pe else (0.0 if e == 0 else math.inf), c))
    text = ", ".join(f"{name.split(' (')[0]} ratio {q:.3f} cosine {c:.6f}"
                     for name, (q, c) in zip(outputs, readings))
    floors = [0.999] * len(readings) if p_cos is None else [1 - SLICE_RATIO * (1 - c)
                                                            for c in p_cos]
    if control:
        control_ratio(tag, label, [q for q, _ in readings], text)
        return
    inside = all((q == 0.0) if pe == 0 else (q <= SLICE_RATIO and c > f)
                 for (q, c), f, pe in zip(readings, floors, p_err))
    if not inside:
        raise AssertionError(f"{tag} {label}: {text}: outside ratio {SLICE_RATIO} / cosine "
                             + ", ".join(f"{f:.6f}" for f in floors))
    log(f"{tag} {label} against f32: {text} (plain bf16 rel {p_err})")


def events_ms(fn, iters: int = 2) -> float:
    """Mean device time of fn() over `iters` calls by CUDA events, for work
    long enough (a whole encoder) that the host's issue does not count."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def batch_mels(clips, n_mels: int, dev) -> torch.Tensor:
    """The first BATCH 30 s windows of the clips, as `transcribe_windows`
    cuts them: (BATCH, 3000, n_mels) bf16."""
    from tpu_audio_torch.models.whisper.pipeline import N_FRAMES, MelExtractor, _pad_frames

    extractor = MelExtractor(n_mels, dev)
    windows = []
    for clip in clips:
        mel = extractor(clip)
        windows += [_pad_frames(mel[s:s + N_FRAMES], N_FRAMES)
                    for s in range(0, mel.shape[0] - N_FRAMES, N_FRAMES)]
    return torch.stack(windows[:BATCH]).to(torch.bfloat16)


def mel_faulty(x: torch.Tensor, n_mels: int, *, window: bool = True, band=None,
               floor: float = 1e-10, last_row: bool = True) -> torch.Tensor:
    """The plain log-mel with a fault planted: the window left out, band
    `band`'s weights one bin later (its first bin off by one), another
    floor, or the last frame's row not written (left zero)."""
    from tpu_audio_torch.ops import stft
    from tpu_audio_torch.ops.kernels import fused_mel

    c = fused_mel._constants(n_mels, x.device)
    basis = c.basis if window else torch.as_tensor(stft.dft_basis(400), device=x.device)
    fb = c.fb
    if band is not None:
        fb = fb.clone()
        fb[:, band] = torch.roll(fb[:, band], 1)
    spec = stft.frame(x, 400, 160) @ basis
    power = spec[:, :201] ** 2 + spec[:, 201:] ** 2
    out = torch.log10(torch.clamp(power @ fb, min=floor))
    if not last_row:
        out[-1] = 0.0
    return out


def mel_ops(frames: int, n_mels: int) -> dict:
    """fused_log_mel's arithmetic a call, by type: a frame's f64 work is the
    window (400 products), the radix-5 passes (40 items of 48 flops, then
    40 of 48 + 4 twiddle products of 6), the radix-8 pass (25 items of 56 +
    7 twiddle products), the split (101 pairs of 24 with their powers); in
    f32, two a band weight (~394 nonzeros at 128 mels) and a log a band."""
    from tpu_audio_torch.ops.kernels import fused_mel

    nonzeros = fused_mel._constants(n_mels, torch.device("cpu")).weights.numel()
    f64 = 400 + 40 * 48 + 40 * (48 + 24) + 25 * (56 + 42) + 101 * 24
    return {"f64": frames * f64, "f32": frames * (2 * nonzeros + n_mels)}


def check_mel(n_mels: int, dev, randn, rows: list, card: str) -> None:
    """Phase 3, the log-mel: `fused_log_mel` on noise (one 30 s chunk with
    its margins) against the plain version (atol 1e-3); on the
    dynamic-range signals (`tools/mel_split.py`'s gate), its largest |log10
    error| against float64 at most GATE_RATIO times the plain f32
    version's; a signal that is not 16-byte aligned refused before a
    launch; planted faults, each outside one of those limits; one chunk (the
    JSON row) and one 150 s clip in one launch (as phase 4 launches it)
    against the plain version (atol 1e-3) and timed, cold, beside the plain
    version and torch.stft's spectrum alone (cuFFT, a yardstick)."""
    from tpu_audio_torch.ops.kernels import fused_mel
    from tpu_audio_torch.tools import mel_split

    audio = randn(30 * 16000 + 400, scale=0.1)
    got = fused_mel.fused_log_mel(audio, n_mels=n_mels)
    ref = fused_mel.fused_log_mel_plain(audio, n_mels=n_mels)
    err = compare(f"fused_log_mel ({got.shape[0]}, {n_mels}) f32, noise", got, ref, atol=1e-3)
    if not torch.equal(mel_faulty(audio, n_mels), ref):
        raise AssertionError("mel_faulty without a fault is not the plain version")

    # the dynamic-range gate
    signals, exact, p_err = mel_split.gate_refs(n_mels, dev, SEED)
    for name, x in signals.items():
        k_out = fused_mel.fused_log_mel(x, n_mels=n_mels)
        k_err = (k_out.double() - exact[name]).abs().max().item()
        msg = (f"fused_log_mel {name} (440 Hz at 0.5, chirp 1e-2, noise 1e-5, 2 s of zeros) "
               f"against float64: kernel max |d log10| {k_err:.4e}, plain f32 {p_err[name]:.4e}, "
               f"ratio {k_err / p_err[name]:.3f}")
        if not (torch.isfinite(k_out).all() and k_err <= mel_split.GATE_RATIO * p_err[name]):
            raise AssertionError(f"{msg}: outside ratio {mel_split.GATE_RATIO}")
        log(msg)

    # a signal 4 bytes off 16 is refused before it launches
    off = torch.empty(audio.numel() + 4, device=dev)[1:1 + audio.numel()]
    assert off.data_ptr() % 16 != 0
    before = fused_mel.LAUNCHES["fused_log_mel"]
    try:
        fused_mel.fused_log_mel(off, n_mels=n_mels)
    except ValueError as e:
        log(f"fused_log_mel, a signal 4 bytes off 16: refused ({e})")
    else:
        raise AssertionError("fused_log_mel took a signal that is not 16-byte aligned")
    if fused_mel.LAUNCHES["fused_log_mel"] != before:
        raise AssertionError("fused_log_mel launched on a signal it refused")

    faults = {"the window left out": dict(window=False),
              f"band {n_mels // 2}'s first bin off by one": dict(band=n_mels // 2),
              "the floor at 1e-9": dict(floor=1e-9),
              "the last frame not written": dict(last_row=False)}
    for label, fault in faults.items():
        noise = (mel_faulty(audio, n_mels, **fault) - ref).abs().max().item()
        ratios = {name: (mel_faulty(x, n_mels, **fault).double() - exact[name]).abs().max().item()
                  / p_err[name] for name, x in signals.items()}
        text = (f"noise max |d| {noise:.3e} (atol 1e-3), against float64 "
                + ", ".join(f"{name} ratio {q:.3f}" for name, q in ratios.items()))
        if noise <= 1e-3 and all(q <= mel_split.GATE_RATIO for q in ratios.values()):
            raise AssertionError(f"fused_log_mel: the check cannot see {label} ({text})")
        log(f"control fused_log_mel, {label}: {text}: outside the limit")

    # each shape against the plain version on one copy, then its times,
    # cold: each call reads the next of enough copies of its audio
    window = torch.hann_window(400, periodic=False, device=dev)
    randn = randn_on(dev, SEED + 1)  # the caller's draws stay as they were
    for label, seconds in (("30 s chunk", 30), ("150 s clip", 150)):
        n = seconds * 16000 + 400
        frames = fused_mel.num_frames(n)
        copies = max(2, -(-COLD_BYTES // (4 * (n + frames * n_mels))))
        xs = [randn(n, scale=0.1) for _ in range(copies)]
        compare(f"fused_log_mel {label} ({frames}, {n_mels}) f32, noise, one launch",
                fused_mel.fused_log_mel(xs[0], n_mels=n_mels),
                fused_mel.fused_log_mel_plain(xs[0], n_mels=n_mels), atol=1e-3)
        nxt = itertools.cycle(xs).__next__
        ms, pms = timed_pair(lambda: fused_mel.fused_log_mel(nxt(), n_mels=n_mels),
                             lambda: fused_mel.fused_log_mel_plain(nxt(), n_mels=n_mels), 20)
        stft_ms = time_ms(lambda: torch.view_as_real(torch.stft(
            nxt(), 400, 160, window=window, center=False, return_complex=True)).square().sum(-1),
            20)
        c = fused_mel._constants(n_mels, dev)
        roof = bound(mel_ops(frames, n_mels), 4 * (n + frames * n_mels)
                     + nbytes(c.window, c.twiddles, c.bands, c.weights))
        log(f"time fused_log_mel {label} ({frames} frames, n_mels {n_mels}), one launch: kernel "
            f"{ms:.4f} ms, plain {pms:.4f} ms, bound {roof[0]:.4f} ms ({roof[1]}), "
            f"torch.stft |.|^2 (the spectrum alone, cuFFT) {stft_ms:.4f} ms ({card})")
        if label == "30 s chunk":
            rows.append(kernel_row("fused_log_mel", "tpu_audio_torch/csrc/fused_mel.cu",
                                   "tpu_audio/ops/pallas/fused_mel.py:44", err, ms, pms, roof,
                                   None, "no one PyTorch call computes a log-mel: torch.stft is "
                                   f"the spectrum alone ({stft_ms:.4f} ms)"))
        del xs


def mel_slice(clips, n_mels: int, dev, card: str) -> dict:
    """`--mel-only`'s main path: `MelExtractor` on each clip, one
    fused_log_mel launch a clip, against the plain path (atol 1e-3 in the
    normalised units). Returns the launches."""
    from tpu_audio_torch.models.whisper.pipeline import MelExtractor
    from tpu_audio_torch.ops.kernels import fused_mel

    extractor = MelExtractor(n_mels, dev)
    reset(fused_mel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mels = [extractor(clip) for clip in clips]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(fused_mel)
    if launches["fused_log_mel"] != len(clips):
        raise AssertionError(f"expected one fused_log_mel launch a clip ({len(clips)}), got "
                             f"{launches}")
    with plain_kernels(fused_mel):
        for i, (clip, mel) in enumerate(zip(clips, mels)):
            compare(f"MelExtractor clip {i} ({len(clip) / 16000:.0f} s) {tuple(mel.shape)}",
                    mel, extractor(clip), atol=1e-3)
    log(f"MelExtractor: {len(clips)} clips, {launches['fused_log_mel']} launches, "
        f"{wall * 1e3:.1f} ms wall with the host's padding and copy ({card})")
    return launches


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: dict, n_bytes: int) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take for work of
    `ops` operations by type ("bf16", "int8", "f32") moving `n_bytes` (each
    input read once, each output written once)."""
    t_ops = 1e3 * sum(n / PEAK[kind] for kind, n in ops.items())
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_row(name: str, source: str, replaces: str, err: float, ms: float, pms: float,
               roof: tuple[float, str], library: float | None, why: str = "") -> dict:
    """One kernel's entry of the JSON line; logs its bound and yardstick."""
    bound_ms, bound_by = roof
    log(f"bound {name}: {bound_ms:.4f} ms by {bound_by}; kernel {ms:.4f} ms = "
        f"{bound_ms / ms:.3f} of the bound")
    log(f"library {name}: " + (f"{library:.4f} ms" if library is not None
                               else f"none ({why})"))
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library}


@contextmanager
def patched(obj, name: str, fn):
    """Replace obj.name with fn inside the block."""
    saved = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def faulty(obj, name: str, fn, run):
    """run, with obj.name replaced by fn while it runs."""
    def call():
        with patched(obj, name, fn):
            return run()
    return call


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


@contextmanager
def held_calls(tag: str, mod, names, rel: float):
    """Inside the block, each call of the wrappers `names` of `mod` runs
    its kernel and then the plain version on the same inputs (no launch
    counted); each call's rel (max|got - ref| / max|ref|) and cosine stay
    on the card until the block ends. Then, for each wrapper that ran, one
    read: raises if a call's output was not finite or a call lies outside
    rel / cosine 0.999, else logs the worst call and its shapes."""
    readings = {n: [] for n in names}

    def held(name, kernel, plain):
        def run(*args, **kwargs):
            got = kernel(*args, **kwargs)
            g, r = got.double(), plain(*args, **kwargs).double()
            finite = torch.isfinite(g).all().double()
            rel_err = (g - r).abs().max() / r.abs().max()
            cos = (g.flatten() @ r.flatten()) / (g.norm() * r.norm())
            shapes = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
            readings[name].append((torch.stack([finite, rel_err, cos]), shapes))
            return got
        return run

    saved = {n: getattr(mod, n) for n in names}
    for n in names:
        setattr(mod, n, held(n, saved[n], getattr(mod, n + "_plain")))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(mod, n, fn)
    for n, calls in readings.items():
        if not calls:
            continue
        got = torch.stack([c[0] for c in calls]).cpu()
        worst = int(got[:, 1].argmax())
        text = (f"{tag} {n}: {len(calls)} calls held against {n}_plain, worst rel "
                f"{got[worst, 1]:.3e} at {calls[worst][1]}, least cosine {got[:, 2].min():.6f}")
        if not (got[:, 0].all() and got[:, 1].max() <= rel and got[:, 2].min() > 0.999):
            raise AssertionError(f"{text}: a call non-finite or outside rel {rel} / cosine 0.999")
        log(text)


def held_exact(name: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    """got equal to ref bit for bit (max |diff| 0), or raise."""
    if got.shape != ref.shape or got.dtype != ref.dtype or not torch.equal(got, ref):
        diff = ((got.float() - ref.float()).abs().max().item()
                if got.shape == ref.shape else float("nan"))
        raise AssertionError(f"{name}: not bit for bit: max|diff| {diff:.3e}")


def exact_faults(name: str, got: torch.Tensor, faults) -> None:
    """Each fault's output (the plain version with one fault planted) must
    differ from the kernel's somewhere: the check is bit for bit, so a fault
    that equals the kernel's output is one the check cannot see."""
    for label, fault in faults:
        ref = fault()
        diff = (got.float() - ref.float()).abs().max().item()
        if not diff > 0:
            raise AssertionError(f"{name}: the check cannot see {label}")
        log(f"control {name}, {label}: max|diff| {diff:.3e}: outside the limit (0)")


def int8_faulty(x, w, sc, bias, out_dtype, *, cols=None, acc_cols=None, acc_factor=1,
                bias_first=False):
    """The plain int8 matmul with one fault of the kernel's design planted:
    the row scale from columns `cols` only; the partial sum of columns
    `acc_cols` times `acc_factor` (0: dropped, 2: merged twice); the bias
    added in f32 before the cast (one rounding too few)."""
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm

    xf = x.float()
    part = xf if cols is None else xf[:, cols.start:cols.stop]
    sx = torch.clamp(i8mm.true_div(part.abs().amax(dim=-1, keepdim=True), 127.0), min=1e-10)
    xq = torch.clamp(torch.round(xf / sx), -127, 127)
    acc = xq.double() @ w.double().T
    if acc_cols is not None:
        sl = slice(acc_cols.start, acc_cols.stop)
        acc = acc + (acc_factor - 1) * (xq[:, sl].double() @ w[:, sl].double().T)
    y = acc.float() * sx * sc.reshape(1, -1).float()
    if bias_first:
        return (y + bias.to(out_dtype).float()).to(out_dtype)
    y = y.to(out_dtype)
    return y if bias is None else y + bias.to(out_dtype)


C17_CALLS = 16  # calls under the profiler in `one_kernel_a_call`


def one_kernel_a_call(label: str, fn, module, key: str, calls: int = C17_CALLS,
                      quiet: bool = False, kernel: str = "int8_mm_kernel") -> str | None:
    """ROADMAP C17's check that fn() is one device kernel a call: `calls`
    calls of it under `torch.profiler` are `calls` launches by the
    wrapper's count (`module.LAUNCHES[key]`) and `calls` device kernels
    whose name holds `kernel`, and no other device kernel. The
    profiler's first session in a process can miss a short kernel (CUPTI
    starts lazily; one whole run saw none), so a session over the same
    loop warms it first, up to three times until it sees a device event;
    that session is not read. Returns what went wrong, or None."""
    from torch.profiler import ProfilerActivity, profile

    def census():
        torch.cuda.synchronize()
        before = module.LAUNCHES[key]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        return module.LAUNCHES[key] - before, names

    for _ in range(3):
        if census()[1]:
            break
    launched, names = census()
    mine = [n for n in names if kernel in n]
    others = sorted({n for n in names if kernel not in n})
    if launched != calls or len(mine) != calls or others:
        return (f"{label}: {calls} calls, {launched} launches counted, {len(mine)} {kernel} "
                f"kernels, other device kernels {others}: expected one kernel a call")
    if not quiet:
        log(f"{label}: {calls} calls = {launched} launches = {len(mine)} device kernels "
            f"({mine[0]}), no other kernel")
    return None


def check_int8_matmul(model_i8, randn, rows: list) -> None:
    """Phase 3, the W8A8 weight-streaming matmuls, bit for bit against their
    plain versions (exact int32 sums, the same f32 epilogue in the same
    order, the same roundings; the parent design was held at rel 1e-5):
    every int8 linear of the Whisper decoder (q, k, v, o, cross q, o, fc1,
    fc2 of its last layer, stacked; the tied head), Qwen3-0.6B's int8 head
    and Llama-3.2-3B's down projection on random codes, at 1, 4, 16 and 32
    rows of f32 and bf16 x, through both outputs (f32; x's dtype plus the
    bias, as `int8_linear` takes it). Each row's |max| lies in the last
    column slice, and at 1 and 4 rows the output has guard rows past B.
    Planted faults of the design land outside: a row scale from the first
    rank's slice only, the last rank's partial sum dropped or merged twice
    (where the launch splits the columns), the wrong layer, the bias added
    before the cast, the rows past B computed and stored. One
    `int8_linear` on the bf16 tree is one device kernel
    (`one_kernel_a_call`: a loop of calls under the profiler, with a cast
    kernel and a bias kernel planted as controls).
    Times, the weights cold (copies in turn): the head at 1 row (row 12),
    fc1 at 16 rows (row 13), each at 32 rows beside `torch._int_mm` (the
    product alone) and `int8_matmul_bigm`."""
    from tpu_audio_torch.ops import quant
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm

    cfg = model_i8.cfg
    layer = cfg.n_text_layer - 1
    lp = model_i8.decoder["blocks"].layer(layer)
    head = model_i8.decoder["token_embedding"]
    dev = head["weight_i8"].device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    # (entry, weight, scale, bias, layer): the decoder's own leaves, the others random
    cases = {name: (lp[blk][leaf]["weight_i8_stacked"], lp[blk][leaf]["scale_i8"],
                    lp[blk][leaf].get("bias"), layer)
             for name, blk, leaf in (("q", "attn", "q"), ("k", "attn", "k"), ("v", "attn", "v"),
                                     ("o", "attn", "o"), ("cross q", "cross_attn", "q"),
                                     ("cross o", "cross_attn", "o"), ("fc1", "mlp", "fc1"),
                                     ("fc2", "mlp", "fc2"))}
    cases["whisper head"] = (head["weight_i8"], head["scale_i8"], None, None)
    for name, (o, i) in I8_SHAPES.items():
        w = torch.randint(-127, 128, (2, o, i), device=dev, dtype=torch.int8)
        sc = (torch.rand((o, 1), device=dev) + 0.5) * (i ** -0.5 / 64)
        cases[name] = (w, sc, None, 1) if "down" in name else (w[1], sc, None, None)

    def call(kernel: bool, x, w, sc, bias, li, out_dtype, out=None):
        if li is None:
            fn = i8mm.int8_matmul if kernel else i8mm.int8_matmul_plain
            return fn(x, w, sc, bias, out_dtype=out_dtype, out=out)
        fn = i8mm.int8_matmul_stacked if kernel else i8mm.int8_matmul_stacked_plain
        return fn(x, w, sc, li, bias, out_dtype=out_dtype, out=out)

    err, seen, plans = 0.0, set(), {}
    for name, (w, sc, bias, li) in cases.items():
        w2 = w if li is None else w[li]
        o, i = w2.shape
        for n, dt in itertools.product(I8_ROWS, (torch.float32, torch.bfloat16)):
            slices = i8mm.plan(n, i, o, n_sm)
            plans[f"{name} {n}"] = slices
            pad = -n % 8
            x_all = randn(n + pad, i, dtype=dt)
            peak = x_all.float().abs().amax(dim=1) * 3 + 1
            # every row's |max| in the last eighth of the columns: the last slice's
            x_all[:, i8mm.slice_columns(i, 8, 7).start] = peak.to(dt)
            x = x_all[:n]
            for out_dtype, b in ((torch.float32, None), (dt, bias)):
                tag = (f"int8_matmul {name} ({n}, {i}) {str(dt)[6:]} x {tuple(w.shape)} s8 -> "
                       f"{str(out_dtype)[6:]}" + (" + bias" if b is not None else ""))
                guard = torch.full((n + pad, o), 7.0, dtype=out_dtype, device=dev)
                got = call(True, x, w, sc, b, li, out_dtype, out=guard[:n])
                ref = call(False, x, w, sc, b, li, out_dtype)
                held_exact(tag, guard, torch.cat([ref, torch.full_like(guard[n:], 7.0)]))
                err = max(err, (got.float() - ref.float()).abs().max().item())
                faults = []
                if slices > 1:
                    first = i8mm.slice_columns(i, slices, 0)
                    tail = i8mm.slice_columns(i, slices, slices - 1)
                    faults += [("the row scale from rank 0's slice only",
                                lambda first=first: int8_faulty(x, w2, sc, b, out_dtype,
                                                                cols=first)),
                               (f"rank {slices - 1}'s partial sum dropped",
                                lambda tail=tail: int8_faulty(x, w2, sc, b, out_dtype,
                                                              acc_cols=tail, acc_factor=0)),
                               (f"rank {slices - 1}'s partial sum merged twice",
                                lambda tail=tail: int8_faulty(x, w2, sc, b, out_dtype,
                                                              acc_cols=tail, acc_factor=2))]
                    seen.add("slices")
                if li is not None:
                    faults.append((f"layer {li - 1} read instead of layer {li}",
                                   lambda: call(False, x, w, sc, b, li - 1, out_dtype)))
                    seen.add("layer")
                if b is not None and out_dtype == torch.bfloat16:
                    faults.append(("the bias added before the cast", lambda: int8_faulty(
                        x, w2, sc, b, out_dtype, bias_first=True)))
                    seen.add("bias")
                if faults:
                    exact_faults(tag, got, faults)
                if pad:
                    exact_faults(tag + ", guard rows", guard, [
                        ("the rows past B computed and stored",
                         lambda: call(False, x_all, w, sc, b, li, out_dtype))])
                    seen.add("rows")
        log(f"int8_matmul {name} {tuple(w.shape)}: bit for bit at rows {I8_ROWS}, f32 and bf16 "
            f"x, both outputs; slices by rows {[plans[f'{name} {n}'] for n in I8_ROWS]}")
    if seen != {"slices", "layer", "bias", "rows"}:
        raise AssertionError(f"int8_matmul: some planted faults never ran ({seen})")
    keys = ("slices", "blocks", "stages", "smem", "wide")
    log(f"int8_matmul launches (rows, bf16 x: {'/'.join(keys)}): " + ", ".join(
        f"{name} {n}: " + "/".join(str(plan[k]) for k in keys)
        for name in ("q", "fc1", "fc2", "whisper head", "qwen3 head", "llama-3.2-3b down")
        for n in (1, 16)
        for plan in [i8mm.launch_plan(dev, n, cases[name][0].shape[-1],
                                      cases[name][0].shape[-2], x_dtype=torch.bfloat16)]))
    del cases

    # one int8_linear on the bf16 tree, with its bias, and the head: one device
    # kernel each (ROADMAP C17: counted over a loop, the profiler warmed first)
    for label, leaf, n in (("fc1", lp["mlp"]["fc1"], 16), ("head", head, 1)):
        x = randn(n, head["weight_i8"].shape[1], dtype=torch.bfloat16)
        key = "int8_matmul" if "weight_i8" in leaf else "int8_matmul_stacked"
        if quant.int8_linear(leaf, x).dtype != torch.bfloat16:
            raise AssertionError(f"int8_linear {label}: the output is not bf16")
        fault = one_kernel_a_call(f"int8_linear {label} ({n} rows, bf16 tree)",
                                  lambda leaf=leaf, x=x: quant.int8_linear(leaf, x), i8mm, key)
        if fault:
            raise AssertionError(fault)
        w = leaf["weight_i8"] if "weight_i8" in leaf else leaf["weight_i8_stacked"]
        bias = leaf["bias"] if "bias" in leaf else torch.zeros(
            w.shape[-2], dtype=torch.bfloat16, device=x.device)
        no_bias = {k: leaf[k] for k in ("weight_i8", "weight_i8_stacked", "layer_idx",
                                        "scale_i8") if k in leaf}
        for control, planted in (
                ("a cast kernel after it", lambda leaf=leaf, x=x: quant.int8_linear(
                    leaf, x).float()),
                ("the bias added in a kernel of its own", lambda x=x, nb=no_bias, b=bias:
                 quant.int8_linear(nb, x) + b)):
            if not one_kernel_a_call(f"control int8_linear {label}, {control}", planted, i8mm,
                                     key, quiet=True):
                raise AssertionError(f"int8_linear {label}: the check cannot see {control}")
            log(f"control int8_linear {label}, {control}: refused")

    # times, the weights from device memory: copies enough that the calls,
    # made on the copies in turn, miss L2
    fc1 = lp["mlp"]["fc1"]
    timing = {}
    for label, w_one, sc, bias, li, n in (
            ("lm head", head["weight_i8"], head["scale_i8"], None, None, 1),
            ("fc1", fc1["weight_i8_stacked"][layer], fc1["scale_i8"], fc1["bias"], 0, 16)):
        o, i = w_one.shape
        copies = max(2, -(-COLD_BYTES // (o * i)))
        w_st = w_one[None].repeat(copies, 1, 1)
        for m in (n, 32):
            x = randn(m, i, dtype=torch.bfloat16)
            cycle = itertools.cycle(range(copies))
            b = None if bias is None else bias

            def kernel(x=x, cycle=cycle, b=b, li=li):
                if li is None:  # the head's entry
                    return i8mm.int8_matmul(x, w_st[next(cycle)], sc, b, out_dtype=torch.bfloat16)
                return i8mm.int8_matmul_stacked(x, w_st, sc, next(cycle), b,
                                                out_dtype=torch.bfloat16)

            def plain(x=x, b=b):
                return i8mm.int8_matmul_stacked_plain(x, w_st, sc, 0, b,
                                                      out_dtype=torch.bfloat16)
            ms, pms = timed_pair(kernel, plain, 20)
            roof = bound({"int8": 2 * m * i * o},
                         nbytes(x, w_one, sc, *(() if b is None else (b,))) + 2 * m * o)
            lib = ""
            if m == 32:
                xq, _ = i8mm.quantize_rows(x)
                wp = w_one if o % 8 == 0 else torch.nn.functional.pad(w_one, (0, 0, 0, -o % 8))
                lib = (f"; torch._int_mm, the product alone, "
                       f"{time_ms(lambda: torch._int_mm(xq, wp.T), 20):.4f} ms, "
                       f"int8_matmul_bigm "
                       f"{time_ms(lambda: i8mm.int8_matmul_bigm(x, w_one, sc), 20):.4f} ms")
                del xq, wp
            log(f"time int8_matmul {label} ({m}, {i}) bf16 x ({o}, {i}) -> bf16"
                f"{' + bias' if b is not None else ''}, the {copies} copies in turn: kernel "
                f"{ms:.4f} ms, plain {pms:.4f} ms, bound {roof[0]:.4f} ms ({roof[1]}), "
                f"{roof[0] / ms:.3f} of the bound{lib}")
            timing[(label, m)] = (x, ms, pms, roof)
        del w_st
    x, ms, pms, roof = timing[("lm head", 1)]
    rows.append(kernel_row("int8_matmul", "tpu_audio_torch/csrc/int8_matmul.cu",
                           "tpu_audio/ops/pallas/int8_matmul.py:50", err, ms, pms, roof, None,
                           "torch._int_mm takes more than 16 rows; this call has 1 (its "
                           "32-row time is logged beside the kernel's)"))
    x, ms, pms, roof = timing[("fc1", 16)]
    rows.append(kernel_row("int8_matmul_stacked", "tpu_audio_torch/csrc/int8_matmul.cu",
                           "tpu_audio/ops/pallas/int8_matmul.py:116", err, ms, pms, roof, None,
                           "torch._int_mm takes more than 16 rows; this call has 16 (its "
                           "32-row time is logged beside the kernel's)"))


def code_steps(got, ref, scale_rel: float, label: str = "plain") -> tuple[str, bool]:
    """(codes, scales) got against ref: the share of codes off and the
    largest step, the scales' largest relative difference; inside when the
    codes are at most one step apart in at most 1 % of the entries and the
    scales within scale_rel."""
    step = (got[0].int() - ref[0].int()).abs()
    share, top = (step > 0).float().mean().item(), step.max().item()
    s_rel = ((got[1] - ref[1]).abs() / torch.maximum(got[1].abs(), ref[1].abs())).max().item()
    return (f"{share:.3e} of the codes one step from {label}, largest step {top}, scales rel "
            f"{s_rel:.3e}", top <= 1 and share <= 0.01 and s_rel <= scale_rel)


def held_codes(name: str, got, ref, scale_rel: float, faults=()) -> None:
    """Hold (codes, scales) against the plain ones (`code_steps`); each of
    `faults` (label, the plain version with one fault planted) must land
    outside that limit."""
    text, inside = code_steps(got, ref, scale_rel)
    log(f"{name}: {text}")
    if not inside:
        raise AssertionError(f"{name}: codes outside one step in 1 % of the entries or scales "
                             f"outside rel {scale_rel}")
    for label, fault in faults:
        text, inside = code_steps(got, fault(), scale_rel, "the fault")
        if inside:
            raise AssertionError(f"{name}: the check cannot see {label} ({text})")
        log(f"control {name}, {label}: {text}: outside the limit")


def ulps(got: torch.Tensor, ref: torch.Tensor, floor=None) -> torch.Tensor:
    """|got - ref| in bf16 ulps, the ulp taken at the larger of the two
    values and `floor` (a tensor broadcast against them: the size of an
    addend that the value may have cancelled)."""
    g, r = got.float(), ref.float()
    big = torch.maximum(g.abs(), r.abs())
    if floor is not None:
        big = torch.maximum(big, floor.abs())
    big = big.clamp_min(torch.finfo(torch.bfloat16).tiny)
    return (g - r).abs() / torch.exp2(torch.floor(torch.log2(big)) - 7)


def within_ulp(name: str, got: torch.Tensor, ref: torch.Tensor, floor=None) -> None:
    """Raise unless every value of got (bf16) is within one bf16 ulp of
    ref's (`ulps`)."""
    worst = ulps(got, ref, floor).max().item()
    if not worst <= 1.0:
        raise AssertionError(f"{name}: {worst:.2f} bf16 ulps from the plain version")
    log(f"{name}: within {worst:.2f} bf16 ulp of the plain version")


def tail_tile_unwritten(outs, t: int, heads: bool = False):
    """outs (B, T, D), or head-major (B, H, T, hd) with `heads`, with the
    rows of the last partial 128-row tile of the B·T rows left zero: a
    kernel that never stores that tile."""
    outs = [a.clone() for a in outs]
    rows_m = outs[0].shape[0] * t
    m = torch.arange(rows_m // 128 * 128, rows_m, device=outs[0].device)
    for a in outs:
        if heads:
            a[m // t, :, m % t] = 0
        else:
            a.view(-1, a.shape[-1])[m] = 0
    return outs


def straddled_tiles(outs, t: int):
    """outs (B, T, D) with the rows past each batch boundary of a 128-row
    tile that straddles two batches taken from the batch before, at the
    same t: a kernel that reads such a tile from its first row's batch."""
    outs = [a.clone() for a in outs]
    b = outs[0].shape[0]
    for a in outs:
        flat = a.view(b * t, -1)
        for edge in range(t, b * t, t):
            end = min(-(-edge // 128) * 128, b * t)
            flat[edge:end] = flat[edge - t:end - t]
    return outs


def check_int8_encoder(model, randn, rows: list) -> None:
    """Phase 3, the four W8A8 encoder-block kernels on block 0 of the w8a8
    tree at batch 16 and B=1, T = 1500, each against its plain version (rel
    2e-2, cosine 0.999) and timed; `attn_oproj_ln_int8` also at t_valid 1,
    1000 and 1500. The two launches of `ln_qkv_int8` and of
    `attn_oproj_ln_int8` are held alone too: LayerNorm1's and the pair
    attention's codes and scales (`held_codes`: codes at most one step
    apart in at most 1 % of the entries, scales within rel 1e-5 and
    PAIR_SCALE_REL), and each GEMM on the plain codes (q, k, v and y bit for
    bit, h within one bf16 ulp); fc1's codes likewise. Then planted faults,
    each of which must land outside the limit, on inputs where the faulted
    term is as large as the rest: x with a mean and scale of its own for the
    LayerNorm; attention-sized q, k, v over a small residual; a bias as
    large as fc1's product; a residual as small as fc2's."""
    import torch.nn.functional as F

    from tpu_audio_torch.ops.kernels import fused_encoder_int8 as fe8

    cfg = model.cfg
    t, d, h = cfg.n_audio_ctx, cfg.n_audio_state, cfg.n_audio_head
    hd, m = d // h, BATCH * t
    blocks = model.encoder["blocks"]
    ln1, ln2 = blocks["ln1"], blocks["ln2"]
    o, fc1, fc2 = blocks["attn"]["o"], blocks["mlp"]["fc1"], blocks["mlp"]["fc2"]
    ln_w, ln_b = ln1["weight"][0].float(), ln1["bias"][0].float()
    w_qkv, cs_qkv, b_qkv = model.qkv_weight[0], model.qkv_scale[0], model.qkv_bias[0]
    wo, cso, bo = o["weight_i8"][0], o["scale_i8"][0], o["bias"][0].float()
    g2, b2 = ln2["weight"][0].float(), ln2["bias"][0].float()
    w1, cs1, bias1 = fc1["weight_i8"][0], fc1["scale_i8"][0], fc1["bias"][0].float()
    w2, cs2, bias2 = fc2["weight_i8"][0], fc2["scale_i8"][0], fc2["bias"][0].float()
    ff = w1.shape[0]
    shape = f"(16, {t}, {d})"

    def codes(*size):
        return torch.randint(-127, 128, size, device=w1.device, dtype=torch.int8)

    def int_mm_ms(k, n, w):
        a = codes(m, k)
        log(f"library: torch._int_mm ({m}, {k}) x ({k}, {n}) s8, the product alone")
        return time_ms(lambda: torch._int_mm(a, w.T), 10)

    def bit_exact(name, got, ref):
        err = (got.float() - ref.float()).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"{name}: max |got - plain| {err:.3e}, not bit for bit")
        log(f"{name}: equal to the plain version bit for bit")

    # ln_qkv_int8 at batch 16 (a half tile at the end) and B=1 (a partial
    # last tile of 92 rows): the whole entry (rel 2e-2), then its two
    # launches alone: LayerNorm1's codes and scales, and the GEMM on the
    # plain codes bit for bit
    unfold = torch.ones(3 * d, device=w1.device)
    unfold[:2 * d] = hd ** 0.25
    err, qkv_times = 0.0, {}
    for b in (BATCH, 1):
        x_b = (randn(b, t, d) * 3 + 1).to(torch.bfloat16)

        def qkv_plain(cs=cs_qkv, bb=b_qkv, x_b=x_b):
            return fe8.ln_qkv_int8_plain(x_b, ln_w, ln_b, w_qkv, cs, bb, h)

        got = fe8.ln_qkv_int8(x_b, ln_w, ln_b, w_qkv, cs_qkv, b_qkv, h)
        ref = qkv_plain()
        err = max(err, *(compare(f"ln_qkv_int8 {n} ({b}, {h}, {t}, {hd}) bf16", g, r, rel=2e-2)
                         for n, g, r in zip("qkv", got, ref)))
        codes_ref = fe8.ln_quant_rows_plain(x_b, ln_w, ln_b)

        def per_slice(x_b=x_b):  # each row's 128-column slices coded by their own max
            xn = fe8._ln_f32(x_b.float().reshape(-1, d), ln_w, ln_b, 1e-5)
            parts = [fe8.quantize_rows(a) for a in xn.split(128, dim=-1)]
            return torch.cat([q[0] for q in parts], dim=-1), parts[0][1].reshape(-1)

        held_codes(f"ln_quant_rows batch {b}", fe8.ln_quant_rows(x_b, ln_w, ln_b), codes_ref,
                   1e-5, [("each row coded per 128-column slice", per_slice)])
        for n, g, r in zip("qkv", fe8.qkv_from_codes(*codes_ref, w_qkv, cs_qkv, b_qkv, x_b.shape,
                                                     h), ref):
            bit_exact(f"ln_qkv_int8's GEMM on the plain codes, {n} batch {b}", g, r)
        planted_faults(f"ln_qkv_int8 batch {b}", got, [
            ("q and k without the hd^-0.25 fold",
             lambda: qkv_plain(cs=cs_qkv * unfold, bb=b_qkv * unfold)),
            ("LayerNorm skipped", faulty(fe8, "_ln_f32", lambda x, w, b, eps: x, qkv_plain)),
            ("q and k written to each other's heads", lambda: (ref[1], ref[0], ref[2])),
            ("the last partial 128-row tile left unwritten",
             lambda: tail_tile_unwritten(ref, t, heads=True)),
        ], rel=2e-2)
        qkv_times[b] = timed_pair(lambda: fe8.ln_qkv_int8(x_b, ln_w, ln_b, w_qkv, cs_qkv, b_qkv, h),
                                  qkv_plain, 10)
        if b == BATCH:
            x, qkv = x_b, got
            passes = (time_ms(lambda: fe8.ln_quant_rows(x_b, ln_w, ln_b), 10),
                      time_ms(lambda: fe8.qkv_from_codes(*codes_ref, w_qkv, cs_qkv, b_qkv,
                                                         x_b.shape, h), 10))
        del got, ref, codes_ref
    lib = int_mm_ms(d, 3 * d, w_qkv)
    (ms, pms), (ms1, pms1) = qkv_times[BATCH], qkv_times[1]
    log(f"time ln_qkv_int8 batch 16: {ms:.4f} ms = ln_quant_rows {passes[0]:.4f} + the GEMM "
        f"{passes[1]:.4f} (alone); torch._int_mm {lib:.4f} ms; batch 1: {ms1:.4f} ms, "
        f"plain {pms1:.4f} ms")
    rows.append(kernel_row("ln_qkv_int8", "tpu_audio_torch/csrc/fused_encoder_int8.cu",
                           "tpu_audio/ops/pallas/fused_encoder.py:330", err, ms, pms,
                           bound({"int8": 2 * m * d * 3 * d},
                                 nbytes(x, ln_w, ln_b, w_qkv, cs_qkv, b_qkv, *qkv)), lib))

    # attn_oproj_ln_int8 on block 0's q, k, v at batch 16, timed whole and
    # launch by launch (pair_codes beside SDPA on the same q, k, v; oproj_ln
    # beside torch._int_mm of its product)
    attn_args = (*qkv, x, wo, cso, bo, g2, b2, t)
    y, hn = fe8.attn_oproj_ln_int8(*attn_args)
    err = max(compare(f"attn_oproj_ln_int8 {n} {shape} bf16", g, r, rel=2e-2)
              for n, g, r in zip(("y", "h"), (y, hn), fe8.attn_oproj_ln_int8_plain(*attn_args)))
    ms, pms = timed_pair(lambda: fe8.attn_oproj_ln_int8(*attn_args),
                         lambda: fe8.attn_oproj_ln_int8_plain(*attn_args), 5)
    pc16 = fe8.pair_codes(*qkv, t)
    pass_ms = (time_ms(lambda: fe8.pair_codes(*qkv, t), 10),
               time_ms(lambda: fe8.oproj_ln_int8(*pc16, x, wo, cso, bo, g2, b2), 10))
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(*qkv, scale=1.0), 10)
    lib = int_mm_ms(d, d, wo)
    log(f"time attn_oproj_ln_int8 batch 16: {ms:.4f} ms = pair_codes {pass_ms[0]:.4f} (SDPA on the "
        f"same q, k, v {sdpa:.4f}) + oproj_ln {pass_ms[1]:.4f} (torch._int_mm {lib:.4f}) alone; "
        f"oproj_ln: {fe8.oproj_split(d)} blocks a cluster, cudaOccupancyMaxActiveClusters "
        f"{fe8.oproj_active_clusters(h, wo.device)}")
    roof = bound({"bf16": 4 * BATCH * h * t * t * hd, "int8": 2 * m * d * d},
                 nbytes(*attn_args[:9], y, hn))
    del qkv, attn_args, pc16

    # attention-sized inputs: the attention term as large as x and bo
    hshape = (BATCH, h, t, hd)
    qa, ka = (randn(*hshape, dtype=torch.bfloat16, scale=0.5) for _ in range(2))
    va = randn(*hshape, dtype=torch.bfloat16)
    xa = randn(BATCH, t, d, dtype=torch.bfloat16, scale=0.1)
    boa = randn(d, scale=0.1)
    t_mask = 1000
    swap = torch.arange(h, device=qa.device).view(-1, 2).flip(1).reshape(-1)

    def attn_plain(q=qa, k=ka, v=va, x=xa, c=cso, w=wo, t_valid=t_mask):
        return fe8.attn_oproj_ln_int8_plain(q, k, v, x, w, c, boa, g2, b2, t_valid)

    got = fe8.attn_oproj_ln_int8(qa, ka, va, xa, wo, cso, boa, g2, b2, t_mask)
    ref = attn_plain()
    err = max(err, *(compare(f"attn_oproj_ln_int8 {n}, attention-sized inputs, t_valid {t_mask}",
                             g, r, rel=2e-2) for n, g, r in zip(("y", "h"), got, ref)))
    planted_faults("attn_oproj_ln_int8", got, [
        ("the attention dropped", lambda: attn_plain(v=torch.zeros_like(va))),
        ("wo untransposed", lambda: attn_plain(w=wo.T.contiguous())),
        ("t_valid ignored", lambda: attn_plain(t_valid=t)),
        ("the two heads of each pair swapped",
         lambda: attn_plain(q=qa[:, swap], k=ka[:, swap], v=va[:, swap])),
        ("cso dropped", lambda: attn_plain(c=torch.ones_like(cso))),
        ("the residual dropped", lambda: attn_plain(x=torch.zeros_like(xa))),
        ("LN2 dropped (h = y)", lambda: (ref[0],) * 2),
        ("the last partial 128-row tile left unwritten", lambda: tail_tile_unwritten(ref, t)),
    ], rel=2e-2)
    del got, ref
    # the key-tile edges (one valid key, all keys) and B=1 (a partial last
    # row tile of 92 rows)
    for b, tv in ((BATCH, 1), (BATCH, t), (1, 1), (1, t_mask), (1, t)):
        one = (qa[:b], ka[:b], va[:b], xa[:b])
        got = fe8.attn_oproj_ln_int8(*one, wo, cso, boa, g2, b2, tv)
        ref = fe8.attn_oproj_ln_int8_plain(*one, wo, cso, boa, g2, b2, tv)
        err = max(err, *(compare(f"attn_oproj_ln_int8 {n} ({b}, {t}, {d}), attention-sized "
                                 f"inputs, t_valid {tv}", g, r, rel=2e-2)
                         for n, g, r in zip(("y", "h"), got, ref)))
        if b == 1 and tv == t_mask:
            planted_faults("attn_oproj_ln_int8 batch 1", got, [
                ("the last partial 128-row tile left unwritten", lambda: tail_tile_unwritten(ref, t))],
                rel=2e-2)
        del got, ref

    # its two launches alone: pair_codes' codes and scales against the plain
    # ones, oproj_ln on the plain codes (y bit for bit, h within a bf16 ulp)
    for b in (BATCH, 1):
        qkv_b = (qa[:b], ka[:b], va[:b])
        codes_ref = fe8.pair_codes_plain(*qkv_b, t_mask)

        def per_head(qkv_b=qkv_b):  # each head's 64 columns coded by their own max
            r = fe8.attention_plain(*qkv_b, t_mask).transpose(1, 2)
            hq, hs = fe8.quantize_rows(r)
            return hq.reshape(b, t, d), hs.reshape(b, t, h)[..., 0::2].contiguous()

        def own_scale(codes_ref=codes_ref, per_head=per_head):  # the scale from rank 0 alone
            return codes_ref[0], per_head()[1]

        held_codes(f"pair_codes batch {b}, t_valid {t_mask}", fe8.pair_codes(*qkv_b, t_mask),
                   codes_ref, PAIR_SCALE_REL,
                   [("each head coded by its own 64-column max", per_head),
                    ("the scale written from rank 0's head alone, the peer's max ignored",
                     own_scale)])
        oproj_args = (*codes_ref, xa[:b], wo, cso, boa, g2, b2)
        got = fe8.oproj_ln_int8(*oproj_args)
        ref = fe8.oproj_ln_int8_plain(*oproj_args)
        bit_exact(f"oproj_ln y on the plain codes, batch {b}", got[0], ref[0])
        # h = (y - mean) * rstd * g2 + b2: the statistics are summed in
        # another order than torch's, and where terms cancel (y and the mean,
        # or the normalised term and b2) that last-bit difference is one at
        # the size of the terms, so the ulp is taken there
        yf = ref[0].float()
        terms = (yf.mean(-1, keepdim=True) * g2 * torch.rsqrt(
            yf.var(-1, unbiased=False, keepdim=True) + 1e-5)).abs()
        within_ulp(f"oproj_ln h on the plain codes, batch {b}", got[1], ref[1],
                   floor=torch.maximum(terms, b2.abs()))
        sa_next = codes_ref[1].roll(-1, dims=-1)
        last_pair = codes_ref[0].clone()
        last_pair[..., -128:] = 0
        ln_f32 = fe8._ln_f32

        def block_ln(a, w, bb, eps):  # each block's 128 columns normalised alone
            return torch.cat([ln_f32(*p, eps) for p in zip(a.split(128, -1), w.split(128),
                                                           bb.split(128))], dim=-1)

        def oproj_plain(codes=codes_ref[0], sa=codes_ref[1], oproj_args=oproj_args):
            return fe8.oproj_ln_int8_plain(codes, sa, *oproj_args[2:])

        planted_faults(f"oproj_ln batch {b}", got, [
            ("a stage dequantised with the next pair's scale", lambda: oproj_plain(sa=sa_next)),
            ("the last k-stage (pair) dropped", lambda: oproj_plain(codes=last_pair)),
            ("LayerNorm2's statistics over one block's 128 columns",
             faulty(fe8, "_ln_f32", block_ln, oproj_plain)),
        ], rel=2e-2)
        del got, ref, codes_ref, oproj_args, last_pair
    rows.append(kernel_row("attn_oproj_ln_int8", "tpu_audio_torch/csrc/fused_encoder_int8.cu",
                           "tpu_audio/ops/pallas/fused_encoder.py:423", err, ms, pms, roof, None,
                           "no one PyTorch call computes attention, an int8 o-projection and "
                           "LayerNorm"))
    del qa, ka, va, xa

    # fc1_gelu_int8 on block 0's h; held on the dequantised codes, codes x scale
    def dequant(out):
        return out[0].float() * out[1]

    def fc1_faults(hb):
        """Faults judged on the codes and sg (the steps limit, sg rel 1e-5), not
        on codes x scale: a scale per slice of FF dequantises more closely."""
        ref = fe8.fc1_gelu_int8_plain(hb, w1, cs1, bias1)
        rows_m = ref[0].shape[0] * ref[0].shape[1]
        split = fe8.fc1_split(ff)[1]

        def per_slice():  # each block's FF / C columns by their own row max
            hq, sh = fe8.quant_rows_plain(hb)
            act = fe8._gelu(fe8._s8_product(hq, w1).reshape(ref[0].shape) * sh.reshape(
                ref[1].shape) * cs1.reshape(-1) + bias1)
            parts = [fe8.quantize_rows(a) for a in act.chunk(split, dim=-1)]
            return torch.cat([p[0] for p in parts], dim=-1), parts[0][1]

        def unwritten_tail():  # the last partial 128-row tile never stored
            codes, sg = (a.clone().reshape(rows_m, -1) for a in ref)
            codes[rows_m // 128 * 128:] = 0
            sg[rows_m // 128 * 128:] = 0
            return codes.reshape(ref[0].shape), sg.reshape(ref[1].shape)

        def shifted_scales():  # the scales of the first tile's rows one row down
            sg = ref[1].clone().reshape(-1)
            sg[:128] = sg[:128].roll(1)
            return ref[0], sg.reshape(ref[1].shape)

        return [("each FF/C slice quantised by its own row max", per_slice),
                ("the last partial row tile left unwritten", unwritten_tail),
                ("the first tile's scales shifted by a row", shifted_scales)]

    log(f"fc1_gelu_int8: {fe8.fc1_split(ff)[1]} blocks a cluster, "
        f"cudaOccupancyMaxActiveClusters {fe8.fc1_active_clusters(d, ff, w1.device)}")
    g8 = fe8.fc1_gelu_int8(hn, w1, cs1, bias1)
    ref = fe8.fc1_gelu_int8_plain(hn, w1, cs1, bias1)
    err = compare(f"fc1_gelu_int8 codes x scale (16, {t}, {ff})", dequant(g8), dequant(ref),
                  rel=2e-2)
    held_codes("fc1_gelu_int8 batch 16", g8, ref, 1e-5, fc1_faults(hn))
    one = fe8.fc1_gelu_int8(hn[:1], w1, cs1, bias1)
    ref1 = fe8.fc1_gelu_int8_plain(hn[:1], w1, cs1, bias1)
    err = max(err, compare(f"fc1_gelu_int8 codes x scale (1, {t}, {ff}), a partial last "
                           "row tile", dequant(one), dequant(ref1), rel=2e-2))
    held_codes("fc1_gelu_int8 batch 1", one, ref1, 1e-5, fc1_faults(hn[:1]))
    del ref, ref1, one
    ms, pms = timed_pair(lambda: fe8.fc1_gelu_int8(hn, w1, cs1, bias1),
                         lambda: fe8.fc1_gelu_int8_plain(hn, w1, cs1, bias1), 10)
    rows.append(kernel_row("fc1_gelu_int8", "tpu_audio_torch/csrc/fused_encoder_int8.cu",
                           "tpu_audio/ops/pallas/fused_encoder.py:508", err, ms, pms,
                           bound({"int8": 2 * m * d * ff}, nbytes(hn, w1, cs1, bias1, *g8)),
                           int_mm_ms(d, ff, w1)))
    bias_big = randn(ff, scale=0.5)

    def fc1_plain(b=bias_big):
        return (dequant(fe8.fc1_gelu_int8_plain(hn, w1, cs1, b)),)

    big = fe8.fc1_gelu_int8(hn, w1, cs1, bias_big)
    err = max(err, compare("fc1_gelu_int8 codes x scale, bias as large as the product",
                           dequant(big), fc1_plain()[0], rel=2e-2))
    held_codes("fc1_gelu_int8, bias as large as the product", big,
               fe8.fc1_gelu_int8_plain(hn, w1, cs1, bias_big), 1e-5)
    planted_faults("fc1_gelu_int8", (dequant(big),), [
        ("GELU dropped", faulty(fe8, "_gelu", lambda a: a, fc1_plain)),
        ("the bias dropped", lambda: fc1_plain(torch.zeros_like(bias_big))),
    ], rel=2e-2)
    rows[-1]["max_abs_err"] = err

    # fc2_residual_int8 on those codes and block 0's y
    def fc2_plain(gq=g8[0], sg=g8[1], y=y):
        return fe8.fc2_residual_int8_plain(gq, sg, y, w2, cs2, bias2)

    out = fe8.fc2_residual_int8(*g8, y, w2, cs2, bias2)
    err = compare(f"fc2_residual_int8 {shape} bf16", out, fc2_plain(), rel=2e-2)
    # faults on fc1's codes with row scales drawn over a decade, so each row's
    # scale matters, and a residual as small as the product
    for b in (BATCH, 1):
        gq = big[0][:b]
        sgv = (big[1][:b] * torch.exp(randn(b, t, 1, scale=0.5))).contiguous()
        ys = randn(b, t, d, dtype=torch.bfloat16, scale=0.3)
        small = fe8.fc2_residual_int8(gq, sgv, ys, w2, cs2, bias2)
        err = max(err, compare(f"fc2_residual_int8 ({b}, {t}, {d}), a residual as small as "
                               "the product", small, fc2_plain(gq, sgv, ys), rel=2e-2))

        def unwritten_tail(gq=gq, sgv=sgv, ys=ys):
            ref = fc2_plain(gq, sgv, ys).clone().reshape(b * t, d)
            ref[b * t // 128 * 128:] = 0
            return (ref.reshape(b, t, d),)

        last_stage = gq.clone()
        last_stage[..., -128:] = 0
        planted_faults(f"fc2_residual_int8 batch {b}", (small,), [
            ("the residual dropped", lambda: (fc2_plain(gq, sgv, torch.zeros_like(ys)),)),
            ("sg ignored", lambda: (fc2_plain(gq, torch.ones_like(sgv), ys),)),
            ("the last partial row tile left unwritten", unwritten_tail),
            ("the last 128-deep k stage dropped", lambda: (fc2_plain(last_stage, sgv, ys),)),
            ("each row given the next row's sg",
             lambda: (fc2_plain(gq, sgv.roll(-1, dims=1), ys),)),
        ], rel=2e-2)
    ms, pms = timed_pair(lambda: fe8.fc2_residual_int8(*g8, y, w2, cs2, bias2), fc2_plain, 10)
    rows.append(kernel_row("fc2_residual_int8", "tpu_audio_torch/csrc/fused_encoder_int8.cu",
                           "tpu_audio/ops/pallas/fused_encoder.py:561", err, ms, pms,
                           bound({"int8": 2 * m * ff * d}, nbytes(*g8, y, w2, cs2, bias2, out)),
                           int_mm_ms(ff, d, w2)))


def uncentred(x, ln_w, ln_b, eps: float = 1e-5):
    """`ln_rows_plain` with a fault: the variance taken about 0, not about
    the row's mean."""
    xf = x.float()
    var0 = xf.square().mean(-1, keepdim=True)
    return (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(var0 + eps) * ln_w + ln_b


def check_ln_qkv(w_qkv, cfg, randn) -> float:
    """Phase 3, `ln_qkv` on inputs where every term matters: rows whose mean
    is as large as their spread (x = N(0, 1) + a per-row N(0, 2) offset), a
    LayerNorm of weight 1 + N(0, 0.1) and bias N(0, 0.5), a packed bias of
    std 0.3 (block 0's weight, whose product has std ~0.5). Held against the
    plain version (rel 2e-2, cosine 0.999) at batch 16 (M = 24000 rows, a
    half tile at the end) and at B=1 (M = 1500, a partial last tile of 92
    rows); seven planted faults on the plain version must land outside.
    Returns the largest max abs error."""
    from tpu_audio_torch.ops.kernels import fused_encoder as fe

    t, d, h = cfg.n_audio_ctx, cfg.n_audio_state, cfg.n_audio_head
    hd = d // h
    ln_w, ln_b = 1 + randn(d, scale=0.1), randn(d, scale=0.5)
    bias = randn(3 * d, scale=0.3)
    err = 0.0
    for b in (BATCH, 1):
        x = (randn(b, t, d) + randn(b, t, 1, scale=2.0)).to(torch.bfloat16)

        def plain(x=x, g=ln_w, be=ln_b, bb=bias):
            return fe.ln_qkv_plain(x, g, be, w_qkv, bb, h)

        def unwritten_tail():  # rows from the last full 128-row tile on left zero
            outs = [a.clone() for a in plain()]
            m = torch.arange((b * t) // 128 * 128, b * t, device=x.device)
            for a in outs:
                a[m // t, :, m % t] = 0
            return outs

        got = fe.ln_qkv(x, ln_w, ln_b, w_qkv, bias, h)
        ref = plain()
        err = max(err, *(compare(f"ln_qkv {n} ({b}, {h}, {t}, {hd}) bf16, offset rows, "
                                 "LayerNorm and bias drawn", g, r, rel=2e-2)
                         for n, g, r in zip("qkv", got, ref)))
        planted_faults(f"ln_qkv batch {b}", got, [
            ("the LayerNorm bias ignored", lambda: plain(be=torch.zeros_like(ln_b))),
            ("the mean not subtracted before the variance",
             faulty(fe, "ln_rows_plain", uncentred, plain)),
            ("q and k swapped", lambda: (ref[1], ref[0], ref[2])),
            ("each head written into the next head's slot",
             lambda: [a.roll(1, dims=1) for a in ref]),
            ("the bias row shifted by one head", lambda: plain(bb=bias.roll(hd))),
            ("the packed bias dropped", lambda: plain(bb=torch.zeros_like(bias))),
            ("rows past the last full 128-row tile left unwritten", unwritten_tail),
        ], rel=2e-2)
        del got, ref, x
    return err


def check_encoder_kernels(model, cfg, randn, rows: list) -> None:
    """Phase 3, the bf16 fused encoder's kernels at block 0 of the
    large-v3-turbo weights, batch 16: `ln_qkv` (and `check_ln_qkv`) and
    `attn_oproj_ln`, each against its plain version, timed, with planted
    faults. `attn_oproj_ln` also on attention-sized inputs at t_valid 1,
    1000 and 1500 and at B=1, and its two launches alone: `attn_heads`'
    scratch against `attn_heads_plain` (rel 2e-2, cosine 0.999), `oproj_ln`
    on the plain scratch (y and h within a bf16 ulp), each timed beside
    SDPA or torch.matmul of its product."""
    import torch.nn.functional as F

    from tpu_audio_torch.ops.kernels import fused_encoder as fe

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
    err = max(err, check_ln_qkv(model.qkv_weight[0], cfg, randn))
    ms, pms = timed_pair(lambda: fe.ln_qkv(*qkv_args), lambda: fe.ln_qkv_plain(*qkv_args), 10)
    m_rows = BATCH * t_audio
    xn, w_qkv = randn(m_rows, d, dtype=torch.bfloat16), model.qkv_weight[0]
    lib_ms = time_ms(lambda: torch.matmul(xn, w_qkv.T), 10)
    rows.append(kernel_row("ln_qkv", "tpu_audio_torch/csrc/ln_qkv.cu",
                           "tpu_audio/ops/pallas/fused_encoder.py:114", err, ms, pms,
                           bound({"bf16": 2 * m_rows * d * 3 * d},
                                 nbytes(*qkv_args[:5], *got)), lib_ms))
    log(f"library ln_qkv is torch.matmul of the same bf16 product ({m_rows}, {d}) x "
        f"({d}, {3 * d}) alone, without the LayerNorm and the head-major scatter")
    del xn

    wo, bo = o["weight"][0], o["bias"][0].float()
    g2, b2 = ln2["weight"][0].float(), ln2["bias"][0].float()
    attn_args = (*got, x, wo, bo, g2, b2, t_audio)
    got = fe.attn_oproj_ln(*attn_args)
    ref = fe.attn_oproj_ln_plain(*attn_args)
    err = max(compare(f"attn_oproj_ln {n} (16, 1500, 1280) bf16", g, r, rel=2e-2)
              for n, g, r in zip(("y", "h"), got, ref))
    ms, pms = timed_pair(lambda: fe.attn_oproj_ln(*attn_args),
                         lambda: fe.attn_oproj_ln_plain(*attn_args), 5)
    # each launch alone, beside SDPA on the same q, k, v and torch.matmul of
    # the o-projection's product
    h, hd = cfg.n_audio_head, d // cfg.n_audio_head
    scratch = fe.attn_heads(*attn_args[:3], t_audio)
    pass_ms = (time_ms(lambda: fe.attn_heads(*attn_args[:3], t_audio), 10),
               time_ms(lambda: fe.oproj_ln(scratch, *attn_args[3:8]), 10))
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(*attn_args[:3], scale=1.0), 10)
    flat = scratch.view(m_rows, d)
    matmul = time_ms(lambda: torch.matmul(flat, wo.T), 10)
    log(f"time attn_oproj_ln batch 16: {ms:.4f} ms = attn_heads {pass_ms[0]:.4f} (SDPA on the "
        f"same q, k, v {sdpa:.4f}) + oproj_ln {pass_ms[1]:.4f} (torch.matmul ({m_rows}, {d}) x "
        f"({d}, {d}) bf16 {matmul:.4f}) alone; oproj_ln: {fe.oproj_split(d)} blocks a cluster, "
        f"cudaOccupancyMaxActiveClusters {fe.oproj_active_clusters(h, wo.device)}")
    attn_roof = bound({"bf16": 4 * BATCH * h * t_audio * t_audio * hd + 2 * m_rows * d * d},
                      nbytes(*attn_args[:8], *got))
    for name, roof, t_pass in (
            ("attn_heads", bound({"bf16": 4 * BATCH * h * t_audio * t_audio * hd},
                                 nbytes(*attn_args[:3], scratch)), pass_ms[0]),
            ("oproj_ln", bound({"bf16": 2 * m_rows * d * d},
                               nbytes(scratch, *attn_args[3:8], *got)), pass_ms[1])):
        log(f"bound attn_oproj_ln's {name}: {roof[0]:.4f} ms by {roof[1]}; alone {t_pass:.4f} ms "
            f"= {roof[0] / t_pass:.3f} of the bound")
    del got, ref, attn_args, qkv_args, x, scratch, flat

    # In the block above the attention adds ~1 % to the residual x, so y and
    # h would read inside the limit with the attention wrong. Here the
    # attention term is as large as x and the bias: peaked scores (q.k std
    # ~2), unit-variance values, keys >= 1000 masked, x and bias std 0.1.
    hshape = (BATCH, h, t_audio, hd)
    qa, ka = (randn(*hshape, dtype=torch.bfloat16, scale=0.5) for _ in range(2))
    va = randn(*hshape, dtype=torch.bfloat16)
    xa = randn(BATCH, t_audio, d, dtype=torch.bfloat16, scale=0.1)
    boa = randn(d, scale=0.1)
    t_mask = 1000

    def plain(q=qa, k=ka, v=va, x=xa, w=wo, b=boa, t_valid=t_mask):
        return fe.attn_oproj_ln_plain(q, k, v, x, w, b, g2, b2, t_valid)

    scr_ref = fe.attn_heads_plain(qa, ka, va, t_mask)

    def from_scratch(a):  # the second pass on a scratch with a fault
        return fe.oproj_ln_plain(a, xa, wo, boa, g2, b2)

    got = fe.attn_oproj_ln(qa, ka, va, xa, wo, boa, g2, b2, t_mask)
    ref = plain()
    err = max(err, *(compare(f"attn_oproj_ln {n}, attention-sized inputs, t_valid {t_mask}",
                             g, r, rel=2e-2) for n, g, r in zip(("y", "h"), got, ref)))
    planted_faults("attn_oproj_ln", got, [
        ("the attention dropped", lambda: plain(v=torch.zeros_like(va))),
        ("wo untransposed", lambda: plain(w=wo.T.contiguous())),
        ("t_valid ignored", lambda: plain(t_valid=t_audio)),
        ("each head given the next head's values", lambda: plain(v=va.roll(1, dims=1))),
        ("the bias dropped", lambda: plain(b=torch.zeros_like(boa))),
        ("the residual dropped", lambda: plain(x=torch.zeros_like(xa))),
        ("LN2 dropped (h = y)", lambda: (ref[0],) * 2),
        ("the last partial 128-row tile left unwritten", lambda: tail_tile_unwritten(ref, t_audio)),
        ("the rows of each 128-row tile that straddles two batches read from the batch "
         "before", lambda: straddled_tiles(ref, t_audio)),
        ("each head's output written to the next head's columns",
         lambda: from_scratch(scr_ref.roll(hd, dims=-1))),
    ], rel=2e-2)
    del got, ref
    # the key-tile edges (one valid key, all keys) and B=1 (a partial last
    # row tile of 92 rows)
    for b, tv in ((BATCH, 1), (BATCH, t_audio), (1, 1), (1, t_mask), (1, t_audio)):
        one = (qa[:b], ka[:b], va[:b], xa[:b])
        got = fe.attn_oproj_ln(*one, wo, boa, g2, b2, tv)
        ref = fe.attn_oproj_ln_plain(*one, wo, boa, g2, b2, tv)
        err = max(err, *(compare(f"attn_oproj_ln {n} ({b}, {t_audio}, {d}), attention-sized "
                                 f"inputs, t_valid {tv}", g, r, rel=2e-2)
                         for n, g, r in zip(("y", "h"), got, ref)))
        if b == 1 and tv == t_mask:
            planted_faults("attn_oproj_ln batch 1", got, [
                ("the last partial 128-row tile left unwritten",
                 lambda: tail_tile_unwritten(ref, t_audio))], rel=2e-2)
        del got, ref

    # its two launches alone: the scratch against attn_heads_plain (rel 2e-2,
    # cosine 0.999, the share more than one bf16 step off reported); the
    # o-projection on the plain scratch: y within one bf16 ulp and h within
    # one ulp at the size of the terms it adds and subtracts
    for b in (BATCH, 1):
        qkv_b = (qa[:b], ka[:b], va[:b])
        scr_b = scr_ref[:b]
        scr = fe.attn_heads(*qkv_b, t_mask)
        compare(f"attn_heads ({b}, {t_audio}, {d}) bf16 scratch, t_valid {t_mask}", scr, scr_b,
                rel=2e-2)
        log(f"attn_heads batch {b}: {(ulps(scr, scr_b) > 1).float().mean().item():.3e} of the "
            "entries more than one bf16 step from the plain version")
        planted_faults(f"attn_heads batch {b}", (scr,), [
            ("each head's output written to the next head's columns",
             lambda: (scr_b.roll(hd, dims=-1),))], rel=2e-2)
        oproj_args = (scr_b, xa[:b], wo, boa, g2, b2)
        got = fe.oproj_ln(*oproj_args)
        ref = fe.oproj_ln_plain(*oproj_args)
        # the kernel and the plain version sum the product's D terms in
        # another order, in f32: where y cancels them, that last-bit
        # difference is one at the size of the terms, so y's ulp is taken at
        # least at the row's RMS of the product, and h's at least at that
        # times g2 · rstd, at the normalised mean and at b2
        prod_rms = (scr_b.float() @ wo.float().T).square().mean(-1, keepdim=True).sqrt()
        within_ulp(f"oproj_ln y on the plain scratch, batch {b}", got[0], ref[0],
                   floor=prod_rms)
        yf = ref[0].float()
        rstd = torch.rsqrt(yf.var(-1, unbiased=False, keepdim=True) + 1e-5)
        terms = torch.maximum((yf.mean(-1, keepdim=True) * g2 * rstd).abs(), b2.abs())
        within_ulp(f"oproj_ln h on the plain scratch, batch {b}", got[1], ref[1],
                   floor=torch.maximum(terms, (g2 * rstd * prod_rms).abs()))
        last_head = scr_b.clone()
        last_head[..., -hd:] = 0

        def block_ln(oproj_args=oproj_args, ref=ref):  # each block's 256 columns alone
            a, xb = oproj_args[:2]
            yb = xb.float() + boa + a.float() @ wo.float().T
            hb = torch.cat([F.layer_norm(yp, (yp.shape[-1],), w, bb, 1e-5) for yp, w, bb in
                            zip(yb.split(256, -1), g2.split(256), b2.split(256))], -1)
            return ref[0], hb.to(torch.bfloat16)

        planted_faults(f"oproj_ln batch {b}", got, [
            ("the last head's k-stage dropped",
             lambda oproj_args=oproj_args: fe.oproj_ln_plain(last_head, *oproj_args[1:])),
            ("LayerNorm2's statistics over one block of the cluster (256 columns)", block_ln),
        ], rel=2e-2)
        del got, ref, scr, last_head
    rows.append(kernel_row("attn_oproj_ln", "tpu_audio_torch/csrc/fused_encoder.cu",
                           "tpu_audio/ops/pallas/fused_encoder.py:207", err, ms, pms, attn_roof,
                           None, "no one PyTorch call computes attention, o-projection and "
                           f"LayerNorm; SDPA on its q, k, v {sdpa:.4f} ms, torch.matmul of its "
                           f"product {matmul:.4f} ms"))
    del qa, ka, va, xa, scr_ref


def check_encoder_attention(cfg, randn, rows: list) -> None:
    """Phase 3, bidirectional encoder attention: `encoder_attention` in its
    (B, T, H, D) and head-major layouts and `encoder_attention_packed` at
    large-v3-turbo's shapes (20 heads of 64, T 1500, bf16), each against its
    plain version (rel 2e-2, cosine 0.999) at batch 16 on inputs where every
    term matters: q and k of std 0.6 under a scale of 0.7 (scores of std ~2),
    unit values, keys from t_valid = 1000 on holding large values; five
    planted faults per entry (the last partial key tile dropped among them)
    must land outside the limit. Held again at t_valid 1 and 1500, and at
    B=1 at t_valid 1, 1000 and 1500. Timed at the main
    path's arguments (t_valid = T, scale 1: Whisper folds hd^-0.25 into q and
    k) at batch 16 and at B=1, beside the bound and
    F.scaled_dot_product_attention on the same (B, H, T, hd) tensors."""
    import torch.nn.functional as F

    from tpu_audio_torch.ops.kernels import encoder_attention as ea

    t, h = cfg.n_audio_ctx, cfg.n_audio_head
    hd = cfg.n_audio_state // h
    t_mask, scale = 1000, 0.7
    bf16 = torch.bfloat16
    qh, kh = (randn(BATCH, h, t, hd, dtype=bf16, scale=0.6) for _ in range(2))
    vh = randn(BATCH, h, t, hd, dtype=bf16)
    kh[:, :, t_mask:] = 3.0
    vh[:, :, t_mask:] = randn(BATCH, h, t - t_mask, hd, dtype=bf16, scale=5.0)
    swap = torch.arange(h, device=qh.device).view(-1, 2).flip(1).reshape(-1)

    def layout(x, kind):  # from head-major (B, H, T, hd)
        b = x.shape[0]
        if kind == "bthd":
            return x.transpose(1, 2).contiguous()
        if kind == "pre_bh":
            return x.reshape(b * h, t, hd)
        return x.reshape(b, h // 2, 2, t, hd).permute(0, 1, 3, 2, 4).reshape(b * h // 2, t, 2 * hd)

    entries = {
        "bthd": (lambda *a, **k: ea.encoder_attention(*a, **k), ea.encoder_attention_plain),
        "pre_bh": (lambda *a, **k: ea.encoder_attention(*a, pre_bh=True, **k),
                   lambda *a, **k: ea.encoder_attention_plain(*a, pre_bh=True, **k)),
        "packed": (lambda *a, **k: ea.encoder_attention_packed(*a, **k),
                   ea.encoder_attention_packed_plain)}
    times, errs = {}, {}
    for kind, (kernel, plain_fn) in entries.items():
        q, k, v = (layout(x, kind) for x in (qh, kh, vh))
        name = f"encoder_attention {kind} {tuple(q.shape)} bf16"

        def plain(q=q, k=k, v=v, t_valid=t_mask, sc=scale, kind=kind, plain_fn=plain_fn):
            return (plain_fn(q, k, v, t_valid=t_valid, scale=sc),)

        def heads(fn):  # the plain version on head-major inputs changed by fn
            return lambda: plain(*(layout(fn(x), kind) for x in (qh, kh, vh)))

        got = kernel(q, k, v, t_valid=t_mask, scale=scale)
        errs[kind] = compare(f"{name}, t_valid {t_mask}, scale {scale}", got, plain()[0],
                             rel=2e-2)
        planted_faults(name, (got,), [
            ("keys at or beyond t_valid left unmasked", lambda: plain(t_valid=t)),
            ("the scale ignored", lambda: plain(sc=1.0)),
            ("the two heads of each pair swapped", heads(lambda x: x[:, swap])),
            ("each head given the next head's values", lambda: plain(
                v=layout(vh.roll(1, dims=1), kind))),
            ("the last partial key tile dropped", lambda: plain(t_valid=t_mask // 128 * 128)),
        ], rel=2e-2)
        del got
        # the key-tile edges: one valid key, a partial last tile, all keys;
        # and B=1 (12 query tiles of one batch, the last a partial one)
        for b_, tv in ((BATCH, 1), (BATCH, t), (1, 1), (1, t_mask), (1, t)):
            qb, kb, vb = (layout(x[:b_].contiguous(), kind) for x in (qh, kh, vh))
            errs[kind] = max(errs[kind], compare(
                f"encoder_attention {kind} {tuple(qb.shape)} bf16, t_valid {tv}, scale {scale}",
                kernel(qb, kb, vb, t_valid=tv, scale=scale),
                plain_fn(qb, kb, vb, t_valid=tv, scale=scale), rel=2e-2))
            del qb, kb, vb
        times[kind, BATCH] = timed_pair(lambda: kernel(q, k, v, scale=1.0),
                                        lambda: plain_fn(q, k, v, scale=1.0), 5)
        q1, k1, v1 = (layout(x[:1].contiguous(), kind) for x in (qh, kh, vh))
        times[kind, 1] = timed_pair(lambda: kernel(q1, k1, v1, scale=1.0),
                                    lambda: plain_fn(q1, k1, v1, scale=1.0), 20)
    sdpa = {b: time_ms(lambda: F.scaled_dot_product_attention(qh[:b], kh[:b], vh[:b],
                                                                scale=1.0), 10 if b > 1 else 20)
            for b in (BATCH, 1)}
    roofs = {b: bound({"bf16": 4 * b * h * t * t * hd}, 4 * nbytes(qh[:b])) for b in (BATCH, 1)}
    for (kind, b), (ms, pms) in times.items():
        log(f"time encoder_attention {kind}, batch {b} (T {t}, {h} heads of {hd}, scale 1): "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {roofs[b][0]:.4f} ms "
            f"({roofs[b][1]}), F.scaled_dot_product_attention {sdpa[b]:.4f} ms")
    log(f"library encoder_attention: F.scaled_dot_product_attention on the same (B, {h}, {t}, "
        f"{hd}) bf16 tensors with scale 1, called nowhere in the port")
    for name, kind, err in (("encoder_attention", "bthd", max(errs["bthd"], errs["pre_bh"])),
                            ("encoder_attention_packed", "packed", errs["packed"])):
        ms, pms = times[kind, BATCH]
        rows.append(kernel_row(name, "tpu_audio_torch/csrc/encoder_attention.cu",
                               "tpu_audio/ops/pallas/encoder_attention.py:"
                               + ("57" if kind == "bthd" else "157"),
                               err, ms, pms, roofs[BATCH], sdpa[BATCH]))


def check_cross_attention(cfg, randn, rows: list) -> None:
    """Phase 3, `cross_attention_decode` over int8 K/V of 4 layers at batch
    16 and B=1 and t_valid 1, 1000 and 1500 (of 1536 padded rows), the rows
    at and after t_valid filled with large codes, against its plain version
    (atol 2e-2, and rel 2e-2 with cosine > 0.999), with planted faults that
    must land outside: the last key tile of the last rank dropped, t_valid
    ignored, the V scale dropped, the wrong layer, one cluster rank's
    partial dropped; timed at batch 16 and t_valid 1500."""
    from tpu_audio_torch.ops.kernels import cross_kv_attention as ckv

    t_audio, lyr = cfg.n_audio_ctx, cfg.n_text_layer
    h, hd = cfg.n_text_head, cfg.n_text_state // cfg.n_text_head
    layer = lyr - 1
    err = 0.0
    for b in (BATCH, 1):
        shape = (lyr, b, t_audio, h, hd)
        k8, ks, v8, vs = ckv.quantize_cross_kv(randn(*shape, scale=0.3), randn(*shape, scale=0.5))
        t_pad = k8.shape[2]
        q = randn(b, h, hd)
        for t_valid in (1, 1000, t_audio):
            kp, vp = k8.clone(), v8.clone()
            kp[:, :, t_valid:] = 127
            vp[:, :, t_valid:] = (randn(lyr, b, t_pad - t_valid, h * hd) * 60).clamp(
                -127, 127).to(torch.int8)
            args = (q, kp, vp, ks[layer], vs[layer], layer)

            def plain(t=t_valid, v_scale=vs[layer], at=layer, args=args):
                if t == 0:  # no key left: the kernel's 0 / 0
                    return torch.full_like(q, math.nan)
                return ckv.cross_attention_decode_plain(*args[:4], v_scale, at, t_valid=t,
                                                        n_heads=h)

            tag = f"cross_attention_decode ({b}, {h}, {hd}) f32, t_valid {t_valid}"
            got = ckv.cross_attention_decode(*args, t_valid=t_valid, n_heads=h)
            err = max(err, compare(tag, got, plain(), atol=2e-2, rel=2e-2))
            ranks = [(a, e) for a, e in ckv.chunk_bounds(t_valid, ckv.RANKS) if e > a]
            first, end = ranks[-1]  # the last rank's keys; its last trip's first key:
            tail = first + (end - first - 1) // ckv.KEYS_PER_TRIP * ckv.KEYS_PER_TRIP
            planted_faults(tag, (got,), [
                ("the last key tile dropped", lambda: (plain(t=tail),)),
                ("t_valid ignored over padded rows", lambda: (plain(t=t_pad),)),
                ("the V scale dropped", lambda: (plain(v_scale=torch.ones_like(vs[layer])),)),
                ("the wrong layer", lambda: (plain(at=layer - 1),)),
                ("one cluster rank's partial dropped", lambda: (ckv.cross_attention_chunks_plain(
                    *args, t_valid=t_valid, n_heads=h, drop_chunk=len(ranks) - 1),)),
            ], rel=2e-2)
            del kp, vp
        if b == BATCH:
            cross_args = (q, k8, v8, ks[layer], vs[layer], layer)
            kw = dict(t_valid=t_audio, n_heads=h)
            ms, pms = timed_pair(lambda: ckv.cross_attention_decode(*cross_args, **kw),
                                 lambda: ckv.cross_attention_decode_plain(*cross_args, **kw), 50)
            read = (q, k8[layer, :, :t_audio], v8[layer, :, :t_audio], ks[layer], vs[layer])
            roof = bound({"f32": 4 * b * h * t_audio * hd}, nbytes(*read, q))
        del k8, v8
    rows.append(kernel_row("cross_attention_decode", "tpu_audio_torch/csrc/cross_kv_attention.cu",
                           "tpu_audio/ops/pallas/cross_kv_attention.py:112", err, ms, pms, roof,
                           None, "no one PyTorch call attends over int8 keys and values with "
                           "their scales"))


def history_only(q, k, v, k_hist, v_hist, rnd):
    """Self-attention of the decoder step with the current token's own
    term dropped (a planted fault)."""
    w = torch.softmax(torch.einsum("thd,hd->ht", k_hist, q), dim=-1)
    return torch.einsum("ht,thd->hd", rnd(w), rnd(v_hist))


def check_decoder_step(models: dict, cfg, dev, randn, rows: list) -> None:
    """Phase 3, the whole-decoder step at B=1 for int8 and bf16 weights, a
    bf16 cache, at pos 0, 1, POS and n_text_ctx - 1 and t_valid 1, 750 and
    n_audio_ctx. With init_params weights the attention terms would be ~1 %
    of the residual and hide a wrong attention, so the inputs make each
    term as large as it: the q, k and cross-q weights ×4 (peaked scores),
    a cache history whose scores have std ~3, random LayerNorm parameters,
    a residual of std 0.5, and the cross-K/V rows at and after t_valid
    filled with large codes. Planted faults (the plain version with one
    fault) must land outside at each position and t_valid where they change
    the step: the history ignored, the fresh term dropped, cross-attention
    dropped, t_valid ignored, the MLP dropped, the final LN dropped, the
    wrong layer's cache, fc1 of the next layer (weights staged for the wrong
    layer), and, where the keys fill many of the kernel's chunks, a chunk's
    sum dropped from its head's merge and a head's last chunk dropped, in
    the self- and the cross-attention."""
    from tpu_audio_torch.ops.kernels import cross_kv_attention as ckv
    from tpu_audio_torch.ops.kernels import fused_whisper_step as fws

    lyr, s_max, d, h = cfg.n_text_layer, cfg.n_text_ctx, cfg.n_text_state, cfg.n_text_head
    t_audio = cfg.n_audio_ctx
    shape = (lyr, 1, t_audio, h, d // h)
    k8, ks, v8, vs = ckv.quantize_cross_kv(randn(*shape), randn(*shape))
    t_pad = k8.shape[2]
    k8[:, :, t_audio:] = 127
    v8[:, :, t_audio:] = (randn(lyr, 1, t_pad - t_audio, d) * 60).clamp(-127, 127).to(torch.int8)
    kc = torch.zeros(lyr, s_max, d, dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    kc[:, :POS] = randn(lyr, POS, d, dtype=torch.bfloat16, scale=0.5)
    vc[:, :POS] = randn(lyr, POS, d, dtype=torch.bfloat16)
    # the other positions and t_valid from a second generator, so that the
    # main one draws what it drew when pos POS and t_valid n_audio_ctx were
    # the only ones checked
    more = randn_on(dev, SEED + 1)
    kc[:, POS:s_max - 1] = more(lyr, s_max - 1 - POS, d, dtype=torch.bfloat16, scale=0.5)
    vc[:, POS:s_max - 1] = more(lyr, s_max - 1 - POS, d, dtype=torch.bfloat16)
    cross = {}
    for t_valid in (1, 750):
        kp, vp = k8.clone(), v8.clone()
        kp[:, :, t_valid:] = 127
        vp[:, :, t_valid:t_audio] = (more(lyr, 1, t_audio - t_valid, d) * 60).clamp(
            -127, 127).to(torch.int8)
        cross[t_valid] = (kp, vp)
    cross[t_audio] = (k8, v8)
    pos = torch.tensor(POS, device=dev)
    attend = fws._self_attention

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
        rb = x.dtype == torch.bfloat16
        plan = fws.launch_plan(
            dev, int8=sw.scale is not None, cache_f32=False, n_layers=lyr, d=d,
            hidden=sw.w["fc1"].shape[1], n_heads=h, s_max=s_max, t_pad=t_pad)
        log(f"fused_whisper_decode_step {label} launch: {plan}")
        split = plan["split"]
        next_fc1 = fws.StepWeights({**sw.w, "fc1": sw.w["fc1"].roll(-1, 0)}, sw.scale, sw.vec)
        err = 0.0
        for p in (0, 1, POS, s_max - 1):
            at = torch.tensor(p, device=dev)
            for t_valid, (kp, vp) in cross.items():
                def kernel(kp=kp, vp=vp, at=at, p=p, t_valid=t_valid):
                    kc_, vc_ = kc.clone(), vc.clone()
                    out = fws.fused_whisper_decode_step(sw, x, at, kc_, vc_, kp, ks, vp, vs,
                                                        n_heads=h, t_valid=t_valid)
                    return out, kc_[:, p], vc_[:, p]

                def plain(kc_=kc, vc_=vc, v8_=vp, t=t_valid, sw_=sw, kp=kp, at=at, p=p):
                    kc_, vc_ = kc_.clone(), vc_.clone()
                    out = fws.fused_whisper_decode_step_plain(sw_, x, at, kc_, vc_, kp, ks, v8_,
                                                              vs, n_heads=h, t_valid=t)
                    return out, kc_[:, p], vc_[:, p]

                def with_patch(name, fn, plain=plain):
                    def run():
                        with patched(fws, name, fn):
                            return plain()
                    return run

                def chunks(fn, n, **fault):
                    """fn with the kernel's chunks and one fault in their merge; a
                    fault of the last chunk takes the last chunk that holds keys."""
                    if "drop_chunk" in fault:
                        fault = {"drop_chunk": sum(b > a for a, b in fws.chunk_bounds(n, split))
                                 - 1}
                    return functools.partial(fn, split=split, rb=rb, **fault)

                tag = f"fused_whisper_decode_step {label}, pos {p}, t_valid {t_valid}"
                got = kernel()
                err = max(err, max(compare(f"{tag} {n}", g, r, rel=2e-2)
                                   for n, g, r in zip(("h", "k slot", "v slot"), got, plain())))
                faults = [
                    ("cross-attention dropped", lambda: plain(v8_=torch.zeros_like(vp))),
                    ("t_valid ignored", lambda: plain(t=t_pad)),
                    ("the MLP dropped", with_patch("_mlp", lambda hn, *a: torch.zeros_like(hn))),
                    ("the final LN dropped", with_patch("_final_norm", lambda xs, wb: xs)),
                    ("fc1 of the next layer", lambda: plain(sw_=next_fc1)),
                ]
                if p > 0:
                    faults += [
                        ("history ignored", with_patch(
                            "_self_attention", lambda q, k, v, kh, vh, rnd: attend(
                                q, k, v, kh[:0], vh[:0], rnd))),
                        ("the wrong layer's cache",
                         lambda: plain(kc_=kc.roll(1, 0), vc_=vc.roll(1, 0))),
                    ]
                if 0 < p <= POS:  # at the last position the token is one key of 448
                    faults.append(("the fresh term dropped",
                                   with_patch("_self_attention", history_only)))
                if p >= POS and t_valid > 1:
                    faults += [
                        ("a chunk's sum dropped from a self-attention head's merge",
                         with_patch("_self_attention", chunks(fws.self_attention_chunks, p,
                                                              drop_sum=0))),
                        ("a self-attention head's last chunk dropped",
                         with_patch("_self_attention", chunks(fws.self_attention_chunks, p,
                                                              drop_chunk=True))),
                        ("a chunk's sum dropped from a cross-attention head's merge",
                         with_patch("_cross_attention", chunks(fws.cross_attention_chunks,
                                                               t_valid, drop_sum=0))),
                        ("a cross-attention head's last chunk dropped",
                         with_patch("_cross_attention", chunks(fws.cross_attention_chunks,
                                                               t_valid, drop_chunk=True))),
                    ]
                planted_faults(tag, got, faults, rel=2e-2)
        kc_k, vc_k, kc_p, vc_p = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        ms, pms = timed_pair(
            lambda: fws.fused_whisper_decode_step(sw, x, pos, kc_k, vc_k, k8, ks, v8, vs,
                                                  n_heads=h, t_valid=t_audio),
            lambda: fws.fused_whisper_decode_step_plain(sw, x, pos, kc_p, vc_p, k8, ks, v8,
                                                        vs, n_heads=h, t_valid=t_audio), 20)
        log(f"time fused_whisper_decode_step {label}, pos {POS}, t_valid {t_audio}: kernel "
            f"{ms:.4f} ms, plain {pms:.4f} ms")
        if label == "int8":  # the weights of the slice: every weight, scale and
            # vector once, the cache history to POS, the valid cross rows, the
            # new slots and h
            read = [*sw.w.values(), *sw.scale.values(), *sw.vec.values(), kc[:, :POS],
                    vc[:, :POS], k8[:, :, :t_audio], v8[:, :, :t_audio], ks, vs, x]
            ops = {"int8": 2 * sum(w.numel() for w in sw.w.values()),
                   "f32": 4 * lyr * (POS + 1 + t_audio) * d}
            rows.append(kernel_row(
                "fused_whisper_decode_step", "tpu_audio_torch/csrc/fused_whisper_step.cu",
                "tpu_audio/ops/pallas/fused_whisper_step.py:303", err, ms, pms,
                bound(ops, nbytes(*read) + 4 * d + 2 * nbytes(kc[:, POS])), None,
                "no one PyTorch call runs a decoder step"))


def batch_slice(model, tok, clips, dev, card: str):
    """Phase 4: `transcribe_windows` of the clips at batch 16 (bf16 weights,
    int8 cross-K/V), launches checked, then the clips' log-mel against the
    plain path (`mel_slice`: the kernel at the shape this phase launches it)
    and the kernel path against the f32 plain path on 2 windows with faults
    planted in `attn_oproj_ln`; returns (launch counts, wall seconds, the 2
    windows' mel)."""
    from tpu_audio_torch.models.whisper import batch as wbatch
    from tpu_audio_torch.ops.kernels import cross_kv_attention as ckv
    from tpu_audio_torch.ops.kernels import fused_encoder as fe
    from tpu_audio_torch.ops.kernels import fused_mel

    cfg = model.cfg
    t_phase = time.perf_counter()
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
    if launches["fused_log_mel"] != N_CLIPS:
        raise AssertionError(f"expected one fused_log_mel launch a clip ({N_CLIPS}), got "
                             f"{launches['fused_log_mel']}")
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
    mel_slice(clips, cfg.n_mels, dev, card)

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
        control_ratio("slice", label, [q for q, _ in readings], text)
    log(f"phase 4 wall: {time.perf_counter() - t_phase:.1f} s")

    return launches, wall, mel


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
        control_ratio("single-stream", label, [e_k / p_err],
                      f"step logits ratio {e_k / p_err:.3f} cosine {cos_k:.6f}")
    return launches


def mixed_batch(model_i8, tok, clips, wall_bf16: float | None, card: str) -> float:
    """Phase 6: bench.py's "bf16-enc + int8 decoder + int8 cross-KV" row at
    batch 16 through transcribe_windows, then its decode step alone
    (`tools/batch_step.py`: ms a step by the host clock, device kernels a
    step by the profiler); returns the transcribe's wall time."""
    from tpu_audio_torch.models.whisper import batch as wbatch
    from tpu_audio_torch.ops.kernels import cross_kv_attention as ckv
    from tpu_audio_torch.ops.kernels import fused_encoder as fe
    from tpu_audio_torch.ops.kernels import fused_mel
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
    from tpu_audio_torch.tools import batch_step

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
        f"{sum(len(r.tokens) for r in results)} tokens"
        + (f" (phase 4, bf16 weights: {wall_bf16:.3f} s)" if wall_bf16 is not None else "")
        + f" ({card})")
    reset(i8mm)
    step = batch_step.measure(model_i8, tok, torch.device("cuda", 0))
    calls = sum(i8mm.LAUNCHES.values())
    per_step = calls / (batch_step.WARMUP + batch_step.STEPS + batch_step.PROFILED + 1)
    log(f"mixed batch decode step at batch {batch_step.BATCH}: {step['ms_a_step']:.4f} ms a "
        f"step, {step['kernels_a_step']:.1f} device kernels a step, device busy "
        f"{step['device_ms_a_step']} ms a step (int8 matmul launches {calls}, "
        f"~{per_step:.1f} a step) ({card})")
    return wall


def w8a8_encoder_ab(model, model_bf16, clips, dev, card: str):
    """The int8 and bf16 fused encoders alone on phase 4's 16 windows, by
    CUDA events in the order int8, bf16, bf16, int8, and their features'
    cosine (> 0.999). Returns the windows' mel and the launches of one
    int8 encode (n_audio_layer of each W8A8 kernel)."""
    from tpu_audio_torch.ops.kernels import fused_encoder_int8 as fe8

    cfg = model.cfg
    mel16 = batch_mels(clips, cfg.n_mels, dev)

    def encode(m):
        with torch.inference_mode():
            return m.encode(mel16)

    reset(fe8)
    feats_i8 = encode(model)  # warm-up, and the features
    launches = launch_counts(fe8)
    feats_bf16 = encode(model_bf16)
    if any(n != cfg.n_audio_layer for n in launches.values()):
        raise AssertionError(f"w8a8 encoder: expected {cfg.n_audio_layer} launches of each "
                             f"int8 encoder kernel: {launches}")
    times = {"int8": [], "bf16": []}
    for label in ("int8", "bf16", "bf16", "int8"):
        times[label].append(events_ms(lambda: encode(model if label == "int8" else model_bf16)))
    d, t, lyr, ff = cfg.n_audio_state, cfg.n_audio_ctx, cfg.n_audio_layer, 4 * cfg.n_audio_state
    # bench.py's count: the q, k, v, o projections, q k^T and attention . v,
    # fc1 and fc2, and the two convolutions
    mm_ops = BATCH * lyr * (2 * t * d * d * 4 + 2 * 2 * t * d * ff)
    other = BATCH * (lyr * 2 * 2 * t * t * d + 2 * (3000 * 3 * cfg.n_mels * d + 1500 * 3 * d * d))
    roof, _ = bound({"int8": mm_ops, "bf16": other}, 0)
    for label, ms in times.items():
        ms = sum(ms) / len(ms)
        rate = (mm_ops + other) / ms / 1e9
        peak = PEAK[label]
        log(f"w8a8 encoder, batch 16: {label} {ms:.3f} ms (runs {times[label]}), "
            f"{rate:.1f} T{'OP' if label == 'int8' else 'FLOP'}/s = "
            f"{1e12 * rate / peak:.4f} of {peak / 1e12:.0f}; the int8 encoder's bound "
            f"{roof:.3f} ms ({card})")
    _, e, cos = measure(feats_i8, feats_bf16)
    log(f"w8a8 encoder features against bf16 (16, {t}, {d}): cosine {cos:.6f}, rel {e:.3e}")
    if not cos > 0.999:
        raise AssertionError("the int8 encoder's features are not within cosine 0.999 of bf16")
    return mel16, launches


def full_w8a8(model, model_bf16, tok, clips, dev, walls: dict, card: str) -> dict:
    """Phase 7: bench.py's "full w8a8" row at batch 16 and its
    "single-stream w8a8" row, on the full w8a8 tree; returns the launch
    counts of the batch-16 run."""
    from tpu_audio_torch.api.stt import WhisperEngine
    from tpu_audio_torch.models.whisper import batch as wbatch
    from tpu_audio_torch.models.whisper.pipeline import N_FRAMES, WhisperPipeline, _pad_frames
    from tpu_audio_torch.ops.kernels import cross_kv_attention as ckv
    from tpu_audio_torch.ops.kernels import fused_encoder as fe
    from tpu_audio_torch.ops.kernels import fused_encoder_int8 as fe8
    from tpu_audio_torch.ops.kernels import fused_mel
    from tpu_audio_torch.ops.kernels import fused_whisper_step as fws
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm

    cfg = model.cfg
    mods = (fused_mel, fe, fe8, ckv, i8mm, fws)
    lyr = cfg.n_audio_layer

    # 1. the encoders alone on phase 4's 16 windows, by CUDA events
    mel16, _ = w8a8_encoder_ab(model, model_bf16, clips, dev, card)

    # 2. transcribe_windows at batch 16
    reset(*mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts, results = wbatch.transcribe_windows(model, tok, clips, batch_size=BATCH,
                                               kv_int8=True, return_results=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(*mods)
    log(f"full w8a8 batch launches: {launches}")
    need = ("fused_log_mel", "cross_attention_decode", "int8_matmul", "int8_matmul_stacked")
    if (any(launches[n] != lyr for n in fe8.LAUNCHES) or any(launches[n] for n in fe.LAUNCHES)
            or not all(launches[n] > 0 for n in need)):
        raise AssertionError(f"full w8a8 batch: expected {lyr} launches of each int8 encoder "
                             f"kernel, none of the bf16 ones, and the decoder's: {launches}")
    if len(texts) != N_CLIPS or len(results) != BATCH or not all(
            math.isfinite(r.avg_logprob) and all(0 <= x < cfg.n_vocab for x in r.tokens)
            for r in results):
        raise AssertionError("full w8a8 batch: wrong count of texts or windows, a token "
                             "outside the vocabulary or a NaN log-prob")
    audio_s = N_CLIPS * CLIP_SECONDS
    log(f"full w8a8 batch: transcribe_windows, {BATCH} windows, int8 encoder + decoder + "
        f"cross-KV: {wall:.3f} s wall, {audio_s / wall:.1f}x real time, "
        f"{sum(len(r.tokens) for r in results)} tokens (phase 4, bf16: {walls['bf16']:.3f} s; "
        f"phase 6, int8 decoder: {walls['mixed']:.3f} s) ({card})")

    # 3. single stream through the STT engine
    pipe = WhisperPipeline(model, tok, compute_dtype=torch.bfloat16, kv_int8=True)
    engine = WhisperEngine.from_pipeline(pipe)
    clip = clips[0][:SINGLE_CLIP_SECONDS * 16000]
    reset(*mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    language, probs = engine.detect_language(clip)
    result = engine.transcribe(clip, language=None)
    torch.cuda.synchronize()
    single = launch_counts(*mods)
    log(f"single-stream w8a8 launches: {single}")
    if not (all(single[n] > 0 for n in (*fe8.LAUNCHES, "fused_whisper_decode_step",
                                         "int8_matmul")) and result.language == language
            and math.isclose(sum(probs.values()), 1.0, rel_tol=1e-3)):
        raise AssertionError(f"single-stream w8a8: a kernel never launched or the result "
                             f"is wrong: {single}, {result!r}")
    log(f"single-stream w8a8: STT engine detect_language + transcribe(language=None) of "
        f"{SINGLE_CLIP_SECONDS} s: language {language}, {len(result.segments)} segments, "
        f"{time.perf_counter() - t0:.3f} s wall ({card})")
    window = _pad_frames(pipe.mel_extractor(clips[1][:30 * 16000])[:N_FRAMES], N_FRAMES)
    stats = {"steps": 0}

    def timed():
        stats["steps"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counting(model, "decode_step", stats, "steps"):
            r = pipe.decoder.decode(window, language="en", temperature=0.0)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, stats["steps"], r

    timed()  # warm-up
    for w, n, r in (timed(), timed()):
        log(f"single-stream w8a8 decode: 1 window with its int8 encode, {n} decoder steps "
            f"({len(r.tokens)} tokens), {w:.4f} s, {1e3 * w / n:.4f} ms per step, "
            f"{30.0 / w:.2f}x real time ({card})")

    # 4. the kernel path against the f32 plain path on 2 windows, as phase 4
    mel = mel16[:2]
    init = torch.tensor([tok.sot_sequence()] * 2, device=dev)
    plain_mods = (fe8, ckv, i8mm, fws)

    def run_path(m, dtype):
        with torch.inference_mode():
            feats = m.encode(mel.to(dtype))
            state = m.init_state(feats, batch=2, dtype=dtype, kv_int8=True)
            _, state = m.decode_step(init, state)
            logits, _ = m.decode_step(init[:, -1:], state)
        return feats, logits

    ref_model = copy.deepcopy(model).float()
    with plain_kernels(*plain_mods):
        exact = run_path(ref_model, torch.float32)
        plain_out = run_path(model, torch.bfloat16)
    del ref_model
    outputs = ("encoder features (2, 1500, 1280)", "decode-step logits (2, 1, 51866)")
    p_err = [measure(p, r)[1] for p, r in zip(plain_out, exact)]

    held = functools.partial(held_against_f32, "full w8a8", outputs, exact, p_err)

    held("kernel path", run_path(model, torch.bfloat16), control=False)
    attn, fc2 = fe8.attn_oproj_ln_int8, fe8.fc2_residual_int8
    chain_faults = [
        ("wo untransposed", "attn_oproj_ln_int8",
         lambda q, k, v, x, w, *a, **kw: attn(q, k, v, x, w.T.contiguous(), *a, **kw)),
        ("LN2 dropped (h = y)", "attn_oproj_ln_int8",
         lambda *a, **kw: (attn(*a, **kw)[0],) * 2),
        ("the fc2 residual dropped", "fc2_residual_int8",
         lambda g, sg, y, *a: fc2(g, sg, torch.zeros_like(y), *a)),
    ]
    for label, name, fault in chain_faults:
        with patched(fe8, name, fault):
            held(label, run_path(model, torch.bfloat16), control=True)
    return launches


def whisper_q4(model_q4, model_q8, model, tok, clips, dev, card) -> dict:
    """Phase 9: Whisper on the mlx group-affine trees (`quantize_tree` of the
    bf16 weights: every block linear and the tied embedding; convs, norms
    and positions stay bf16), which take the per-op encoder (cuBLAS
    products around `encoder_attention`), `quant_matmul` for every decoder
    linear and the head, and bf16 cross-K/V. The STT engine at B=1 on q4
    (detect_language, transcribe with word timestamps, a timed 30 s window,
    the kernel path against the f32 plain path with planted faults),
    `transcribe_batch` of phase 4's clips at batch 16, one transcribe on q8;
    then the bf16 per-op encoder (packed and head-major attention) against
    the fused one at batch 16. Returns the launch counts of the q4 engine's
    run and of the per-op bf16 encoder's."""
    from tpu_audio_torch.api.results import TranscriptionSegment
    from tpu_audio_torch.api.stt import WhisperEngine
    from tpu_audio_torch.models.whisper import timing
    from tpu_audio_torch.models.whisper.pipeline import N_FRAMES, WhisperPipeline, _pad_frames
    from tpu_audio_torch.ops.kernels import cross_kv_attention as ckv
    from tpu_audio_torch.ops.kernels import encoder_attention as ea
    from tpu_audio_torch.ops.kernels import fused_encoder as fe
    from tpu_audio_torch.ops.kernels import fused_encoder_int8 as fe8
    from tpu_audio_torch.ops.kernels import fused_mel
    from tpu_audio_torch.ops.kernels import fused_whisper_step as fws
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
    from tpu_audio_torch.ops.kernels import quant_matmul as qmm

    cfg = model_q4.cfg
    lyr = cfg.n_audio_layer
    per_step = 8 * cfg.n_text_layer + 1  # the decoder's linears and the tied head
    mods = (fused_mel, fe, fe8, ea, qmm, ckv, fws, i8mm)
    off = ("ln_qkv", "attn_oproj_ln", *fe8.LAUNCHES, "encoder_attention_packed",
           "fused_whisper_decode_step", "cross_attention_decode", "int8_matmul",
           "int8_matmul_stacked")
    clip = clips[0][:SINGLE_CLIP_SECONDS * 16000]

    def counted_steps(m, stats):
        """Count m's encodes and steps, and the quant_matmul launches of each
        single-token step."""
        encode, step = m.encode, m.decode_step

        def enc(*a, **k):
            stats["encodes"] += 1
            return encode(*a, **k)

        def dec(tokens, state):
            before = qmm.LAUNCHES["quant_matmul"]
            out = step(tokens, state)
            if tokens.shape[1] == 1:
                stats["per_step"].append(qmm.LAUNCHES["quant_matmul"] - before)
            return out
        return enc, dec

    # 1. the STT engine at B=1 on q4: detect_language, transcribe with words
    pipe = WhisperPipeline(model_q4, tok, compute_dtype=torch.bfloat16)
    engine = WhisperEngine.from_pipeline(pipe)
    stats = {"encodes": 0, "per_step": []}
    enc, dec = counted_steps(model_q4, stats)
    reset(*mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with patched(model_q4, "encode", enc), patched(model_q4, "decode_step", dec):
        language, probs = engine.detect_language(clip)
        result = engine.transcribe(clip, word_timestamps=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main = launch_counts(*mods)
    log(f"whisper q4 launches: {main}")
    n_steps = len(stats["per_step"])
    if (main["encoder_attention"] != lyr * stats["encodes"] or any(main[n] for n in off)
            or n_steps == 0 or set(stats["per_step"]) != {per_step}):
        raise AssertionError(f"whisper q4: expected {lyr} encoder_attention launches per encode "
                             f"({stats['encodes']} encodes), {per_step} quant_matmul launches "
                             f"per step (got {sorted(set(stats['per_step']))}) and no other "
                             f"encoder or decoder-step kernel: {main}")
    words = result.words
    if not (result.language == language and math.isclose(sum(probs.values()), 1.0,
                                                          rel_tol=1e-3)
            and words and all(0 <= w.start <= w.end and 0 <= w.probability <= 1
                              for w in words)):
        raise AssertionError(f"whisper q4: wrong result or no words: {result!r}")
    log(f"whisper q4: STT engine detect_language + transcribe(word_timestamps=True) of "
        f"{SINGLE_CLIP_SECONDS} s: language {language}, {stats['encodes']} encodes, "
        f"{n_steps} decoder steps, {len(result.segments)} segments, {len(words)} words "
        f"(first {words[0].word!r} {words[0].start:.2f}-{words[0].end:.2f} s), "
        f"{wall:.3f} s wall ({card})")

    # 2. one timed 30 s window, greedy, with its encode
    window = _pad_frames(pipe.mel_extractor(clips[1][:30 * 16000])[:N_FRAMES], N_FRAMES)

    # the word timestamps of real byte-level text on that window (random
    # weights emit ids the byte tokenizer decodes to nothing, so the
    # transcript's words above are empty): one encode, the cross-QK pass and
    # the host DTW, timed
    ts = tok.timestamp_begin
    text = tok.encode(" Hello, world! This is a test of the word timings.")
    segs = [TranscriptionSegment(id=0, seek=0, start=0.0, end=30.0, text="",
                                 tokens=[ts, *text, ts + 1500])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timing.add_word_timestamps(segs, model=model_q4, tokenizer=tok, mel=window, language="en",
                               time_offset=0.0, dtype=torch.bfloat16)
    wall = time.perf_counter() - t0
    aligned = segs[0].words
    if not (len(aligned) == 10 and all(w.word for w in aligned)
            and all(a.start <= b.start and a.start <= a.end for a, b in zip(aligned, aligned[1:]))):
        raise AssertionError(f"whisper q4 word timestamps of given text: {aligned!r}")
    log(f"whisper q4 word timestamps of {len(text)} given tokens on one window: "
        + ", ".join(f"{w.word!r} {w.start:.2f}-{w.end:.2f}" for w in aligned)
        + f"; {1e3 * wall:.1f} ms ({card})")

    def timed():
        stats.update(encodes=0, per_step=[])
        reset(*mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with patched(model_q4, "encode", enc), patched(model_q4, "decode_step", dec):
            r = pipe.decoder.decode(window, language="en", temperature=0.0)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, len(stats["per_step"]), r, launch_counts(ea, qmm)

    timed()  # warm-up
    for w, n, r, counts in (timed(), timed()):
        log(f"whisper q4 single-stream decode: 1 window with its encode, {n} decoder steps "
            f"({len(r.tokens)} tokens), {w:.4f} s, {1e3 * w / n:.4f} ms per step, "
            f"{30.0 / w:.2f}x real time; launches per call: {counts} ({card})")

    # 3. the kernel path against the f32 plain path: encoder features, the
    # prefill logits and three teacher-forced steps of one window
    mel1 = window[None].to(torch.bfloat16)
    init = torch.tensor([tok.sot_sequence()], device=dev)
    forced = [tok.timestamp_begin, 400, 1200]

    def run_path(m, dtype):
        with torch.inference_mode():
            feats = m.encode(mel1.to(dtype))
            state = m.init_state(feats, batch=1, dtype=dtype)
            out = [m.decode_step(init, state)[0][:, -1]]
            for t in forced:
                out.append(m.decode_step(torch.tensor([[t]], device=dev), state)[0][:, -1])
        return feats, torch.cat(out).float()

    ref_model = copy.deepcopy(model_q4).float()
    with plain_kernels(ea, qmm):
        exact = run_path(ref_model, torch.float32)
        plain_out = run_path(model_q4, torch.bfloat16)
    del ref_model
    outputs = ("encoder features (1, 1500, 1280)", "prefill + step logits (4, 51866)")
    p_err = [measure(p, r)[1] for p, r in zip(plain_out, exact)]

    held = functools.partial(held_against_f32, "whisper q4", outputs, exact, p_err)

    held("kernel path", run_path(model_q4, torch.bfloat16), control=False)
    attn, qmat = ea.encoder_attention, qmm.quant_matmul
    swap = torch.arange(cfg.n_audio_head, device=dev).view(-1, 2).flip(1).reshape(-1)
    for label, mod, name, fault in [
            ("each head given the next head's values", ea, "encoder_attention",
             lambda q, k, v, **kw: attn(q, k, v.roll(1, dims=2), **kw)),
            ("the two heads of each pair swapped", ea, "encoder_attention",
             lambda q, k, v, **kw: attn(q[:, :, swap], k[:, :, swap], v[:, :, swap], **kw)),
            ("quant_matmul's group biases dropped", qmm, "quant_matmul",
             lambda x, w, sc, bi, **kw: qmat(x, w, sc, torch.zeros_like(bi), **kw))]:
        with patched(mod, name, fault):
            held(label, run_path(model_q4, torch.bfloat16), control=True)

    # 4. transcribe_batch of phase 4's clips at batch 16 on q4
    reset(*mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = engine.transcribe_batch(clips, batch_size=BATCH, language="en")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    batch = launch_counts(*mods)
    log(f"whisper q4 batch launches: {batch}")
    if (len(texts) != N_CLIPS or batch["encoder_attention"] != lyr
            or batch["quant_matmul"] == 0 or any(batch[n] for n in off)):
        raise AssertionError(f"whisper q4 batch: {len(texts)} texts, launches {batch}")
    audio_s = N_CLIPS * CLIP_SECONDS
    log(f"whisper q4 batch: STT transcribe_batch, {N_CLIPS} clips x {CLIP_SECONDS} s = {BATCH} "
        f"windows, batch {BATCH}, bf16 cross-KV: {wall:.3f} s wall, {audio_s / wall:.1f}x "
        f"real time ({card})")

    # 5. one transcribe of the 4 s clip on q8
    engine8 = WhisperEngine.from_pipeline(WhisperPipeline(model_q8, tok,
                                                          compute_dtype=torch.bfloat16))
    reset(*mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res8 = engine8.transcribe(clip, language="en", temperature=(0.0,))
    torch.cuda.synchronize()
    q8 = launch_counts(*mods)
    if not (res8.segments and q8["encoder_attention"] and q8["quant_matmul"]
            and not any(q8[n] for n in off)):
        raise AssertionError(f"whisper q8: {res8!r}, launches {q8}")
    log(f"whisper q8: STT engine transcribe of {SINGLE_CLIP_SECONDS} s (greedy): "
        f"{len(res8.segments)} segments, {time.perf_counter() - t0:.3f} s wall; launches "
        f"{q8} ({card})")

    # 6. the bf16 per-op encoder against the fused one, batch 16, phase 4's windows
    per_op = encoder_ab(model, clips, dev, card)["per-op packed"]
    return {**main, "encoder_attention_packed": per_op["encoder_attention_packed"]}


def encoder_ab(model, clips, dev, card: str) -> dict:
    """The bf16 encoder at batch 16 on phase 4's windows, fused
    (`ln_qkv` + `attn_oproj_ln`) against per-op with pair-packed and with
    head-major attention: launches per call, device time by CUDA events in
    the order fused, packed, head-major and back, and each one's features
    against the fused one's (cosine > 0.999). Returns the launch counts per
    variant."""
    from tpu_audio_torch.models.whisper import model as wmodel
    from tpu_audio_torch.ops.kernels import encoder_attention as ea
    from tpu_audio_torch.ops.kernels import fused_encoder as fe

    cfg = model.cfg
    lyr = cfg.n_audio_layer
    mods = (fe, ea)
    mel16 = batch_mels(clips, cfg.n_mels, dev)
    variants = {"fused": (True, True), "per-op packed": (False, True),
                "per-op head-major": (False, False)}

    def encode(label):
        fused, packed = variants[label]
        with patched(wmodel, "FUSED_ENC", fused), patched(wmodel, "PACKED_ATTN", packed), \
                torch.inference_mode():
            return model.encode(mel16)

    feats, counts = {}, {}
    for label in variants:
        reset(*mods)
        feats[label] = encode(label)
        torch.cuda.synchronize()
        counts[label] = launch_counts(fe, ea)
    log(f"bf16 encoder launches per call: {counts}")
    want = {"fused": {"ln_qkv": lyr, "attn_oproj_ln": lyr},
            "per-op packed": {"encoder_attention_packed": lyr},
            "per-op head-major": {"encoder_attention": lyr}}
    for label, c in counts.items():
        if c != {n: want[label].get(n, 0) for n in c}:
            raise AssertionError(f"bf16 encoder {label}: launches {c}, expected {want[label]}")
    times = {label: [] for label in variants}
    for label in (*variants, *reversed(variants)):
        times[label].append(events_ms(lambda: encode(label)))
    d, t, ff = cfg.n_audio_state, cfg.n_audio_ctx, 4 * cfg.n_audio_state
    ops = BATCH * (lyr * (2 * t * d * d * 4 + 2 * 2 * t * d * ff + 2 * 2 * t * t * d)
                   + 2 * (3000 * 3 * cfg.n_mels * d + 1500 * 3 * d * d))
    roof, _ = bound({"bf16": ops}, 0)
    for label, ms in times.items():
        mean = sum(ms) / len(ms)
        _, e, cos = measure(feats[label], feats["fused"])
        log(f"bf16 encoder, batch 16, {label}: {mean:.3f} ms (runs {ms}), "
            f"{ops / mean / 1e9:.1f} TFLOP/s = {ops / mean / 1e9 / (PEAK['bf16'] / 1e12):.4f} "
            f"of 989; bound {roof:.3f} ms; features against fused: cosine {cos:.6f}, rel "
            f"{e:.3e} ({card})")
        if not cos > 0.999:
            raise AssertionError(f"bf16 encoder {label}: features not within cosine 0.999 "
                                 "of the fused encoder's")
    return counts


def funasr_trees(dev) -> dict:
    """Fun-ASR-Nano at full width on random bf16 weights (numpy seed), and
    its two quantised LLM trees: "q4", the MLX group-affine format of the
    published checkpoints (`quantize_tree` of the LLM subtree only; the
    encoder's 3-D FSMN weights stay fp), and "int8", that tree requantised
    to fused per-channel int8 (the JAX package's serving recipe)."""
    from tpu_audio_torch.models.funasr import model as fmodel
    from tpu_audio_torch.ops import quant

    params = fmodel.init_params(SEED, fmodel.FunASRConfig(), torch.bfloat16, dev)
    q4 = dict(params, llm=quant.quantize_tree(params["llm"], bits=4, group=64))
    int8 = dict(params, llm=quant.requantize_tree_int8(q4["llm"]))
    return {"bf16": params, "q4": q4, "int8": int8}


def check_quant_matmul(trees: dict, randn, rows: list) -> None:
    """Phase 3, the q4/q8 dequant-matmul at every linear shape of the q4
    decoders and both heads (`QMM_SHAPES`; Qwen3's tied head the q4 tree's
    own words and, for q8, its bf16 weights quantised), at 1, 2, 16 and 32
    rows, and the Chatterbox T3s' linears and 8194-row speech head
    (`QMM_T3_SHAPES`) at 1 and 2 rows, q4 and q8, f32 and bf16 x, against
    the plain version at rel 1e-4
    (both f32; the kernel's terms of x sum to x up to ~2^-24 |x| and it
    folds each group's affine in as s·Σx(q − c) + (b + c s)·Σx, so the sums
    differ in order and in the last bits only). Planted faults that must
    land outside: the nibble order reversed, the group bias dropped (Qwen3's
    head, 1 row), and, where the launch splits the columns over a cluster
    (32 rows of f32 x), one slice's partial dropped or merged twice. Then
    each shape timed at 1 row (f32 and bf16 x) and 16 (bf16), the T3 shapes
    at 1 and 2 rows of f32 x, the weights from device memory."""
    from tpu_audio_torch.ops import quant
    from tpu_audio_torch.ops.kernels import quant_matmul as qmm

    llm_q4, llm_bf16 = trees["q4"]["llm"], trees["bf16"]["llm"]
    unpack = qmm.unpack_words
    dev = llm_q4["embed"]["weight_q4"].device

    def reversed_order(packed, bits):
        q = unpack(packed, bits)
        return q.reshape(*q.shape[:-1], -1, 32 // bits).flip(-1).reshape(q.shape)

    def sliced(x, groups, slices, s, factor):
        """x with slice s's columns times factor: 0 drops its partial, 2
        merges it twice (every term of the slice's partial is linear in its
        columns of x)."""
        cols = qmm.slice_groups(groups, slices, s)
        y = x.float().clone()
        y[:, cols.start * qmm.GROUP:cols.stop * qmm.GROUP] *= factor
        return y

    err, merge_seen, timing = 0.0, set(), {}
    for label, (o, i) in {**QMM_SHAPES, **QMM_T3_SHAPES}.items():
        qrows = QMM_ROWS if label in QMM_SHAPES else QMM_T3_ROWS
        for bits in (4, 8):
            if label == "qwen3 head":
                leaf = (llm_q4["embed"] if bits == 4
                        else quant.quantize_array(llm_bf16["embed"]["weight"], 8))
            else:
                leaf = quant.quantize_array(randn(o, i, scale=i ** -0.5), bits)
            packed, sc, bi = leaf[f"weight_q{bits}"], leaf["scales"], leaf["biases"]
            o, i = packed.shape[0], sc.shape[1] * qmm.GROUP
            worst, plans = (0.0, ""), set()
            for n, dt in itertools.product(qrows, (torch.float32, torch.bfloat16)):
                name = f"quant_matmul q{bits} {label} ({n}, {i}) {str(dt)[6:]} x ({o}, {i})"
                x = randn(n, i, dtype=dt)
                got = qmm.quant_matmul(x, packed, sc, bi, bits=bits)
                ref = qmm.quant_matmul_plain(x, packed, sc, bi, bits=bits)
                e, rel_e, cos = measure(got, ref)
                if not (rel_e <= 1e-4 and cos > 0.999):
                    raise AssertionError(f"{name}: rel {rel_e:.3e}, cosine {cos:.6f}: outside "
                                         "rel 1e-4 / cosine 0.999")
                err, worst = max(err, e), max(worst, (rel_e, name))
                plan = qmm.launch_plan(dev, n, i, o, bits=bits, x_dtype=dt)
                plans.add(f"{n} {str(dt)[6:]}: {plan['tiles_a_span']}/{plan['slices']}/"
                          f"{plan['per_sm']}/{plan['stages']}/{plan['smem']}")
                if n == 1 and dt == torch.float32 and label == "qwen3 head":
                    planted_faults(f"quant_matmul q{bits} {label}", (got,), [
                        ("nibble order reversed", faulty(
                            qmm, "unpack_words", reversed_order,
                            lambda: (qmm.quant_matmul_plain(x, packed, sc, bi, bits=bits),))),
                        ("group bias dropped", lambda: (qmm.quant_matmul_plain(
                            x, packed, sc, torch.zeros_like(bi), bits=bits),)),
                    ], rel=1e-4)
                if plan["slices"] > 1 and bits not in merge_seen:
                    merge_seen.add(bits)
                    groups, slices = i // qmm.GROUP, plan["slices"]
                    planted_faults(f"quant_matmul q{bits} {label} {n} rows, {slices} slices",
                                   (got,), [
                        (f"slice {s}'s partial {what}", lambda s=s, f=f: (
                            qmm.quant_matmul_plain(sliced(x, groups, slices, s, f), packed,
                                                   sc, bi, bits=bits),))
                        for s in (0, slices - 1) for what, f in (("dropped", 0.0),
                                                                 ("merged twice", 2.0))],
                        rel=1e-4)
            log(f"quant_matmul q{bits} {label} ({o}, {i}) at rows {qrows}, f32 and bf16 x: "
                f"within rel 1e-4 and cosine 0.999 (worst rel {worst[0]:.3e}: {worst[1]}); "
                "launch (rows dtype: tiles a span/slices/blocks an SM/stages/smem) "
                f"{sorted(plans)}")
            if label == "qwen3 head" and bits == 4:
                x = randn(1, i)
                timing["head"] = timed_pair(
                    lambda: qmm.quant_matmul(x, packed, sc, bi, bits=bits),
                    lambda: qmm.quant_matmul_plain(x, packed, sc, bi, bits=bits), 20)
            del leaf, packed, sc, bi
    if merge_seen != {4, 8}:
        raise AssertionError(f"quant_matmul: no launch split the columns (bits {merge_seen})")
    # each shape at 1 row (f32 and bf16 x) and 16 rows (bf16: Whisper's
    # batch-16 q4 decode), its weights from device memory: enough stacked
    # copies that the calls, made on the copies in turn, miss L2
    # (the T3 shapes at 1 and 2 rows of f32 x: the q4 T3s' activations)
    for label, (o, i) in {**QMM_SHAPES, **QMM_T3_SHAPES}.items():
        layers = max(2, -(-COLD_BYTES // (o * i // 2 + o * i // qmm.GROUP * 8)))
        leaf = quant.quantize_array(randn(layers, o, i, scale=i ** -0.5), 4)
        packed, sc, bi = leaf["weight_q4"], leaf["scales"], leaf["biases"]
        for n, dt in (((1, torch.float32), (1, torch.bfloat16), (16, torch.bfloat16))
                      if label in QMM_SHAPES else ((1, torch.float32), (2, torch.float32))):
            x = randn(n, i, dtype=dt)
            cycle = itertools.cycle(range(layers))

            def call(x=x, packed=packed, sc=sc, bi=bi, cycle=cycle):
                li = next(cycle)
                return qmm.quant_matmul(x, packed[li], sc[li], bi[li], bits=4)
            ms = time_ms(call, 40)
            roof_ms, by = bound(qmm_ops(x, o), nbytes(x, packed[0], sc[0], bi[0]) + 4 * n * o)
            log(f"time quant_matmul q4 {label} ({n}, {i}) {str(dt)[6:]} x ({o}, {i}), the "
                f"{layers} copies in turn: kernel {ms:.4f} ms, bound {roof_ms:.4f} ms ({by}), "
                f"gap {ms - roof_ms:.4f} ms, {roof_ms / ms:.3f} of the bound")
        del leaf, packed, sc, bi
    head = llm_q4["embed"]
    o, i = head["weight_q4"].shape[0], head["scales"].shape[1] * qmm.GROUP
    x = randn(1, i)
    w_bf16 = quant.dequantize(head).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    lib_ms = time_ms(lambda: torch.nn.functional.linear(xb, w_bf16), 20)
    log(f"library quant_matmul: F.linear of the bf16 dequantised lm head ({o}, {i}) at 1 row, "
        f"the product alone")
    ms, pms = timing["head"]
    log(f"time quant_matmul q4 qwen3 head (1, {i}) x ({o}, {i}): kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms")
    rows.append(kernel_row("quant_matmul", "tpu_audio_torch/csrc/quant_matmul.cu",
                           "tpu_audio/ops/pallas/quant_matmul.py:72", err, ms, pms,
                           bound(qmm_ops(x, o),
                                 nbytes(x, head["weight_q4"], head["scales"], head["biases"])
                                 + 4 * o), lib_ms))
    del w_bf16


def qmm_ops(x: torch.Tensor, o: int) -> dict:
    """quant_matmul's operations at their tensor-core type: the product of x
    (B, I) with O exact bf16 codes a column, once for bf16 x and once for
    each of the three exact bf16 terms of f32 x (f32 sums)."""
    terms = 1 if x.dtype == torch.bfloat16 else 3
    return {"bf16": terms * 2 * x.numel() * o}


def fresh_dropped(q, k, v, k_hist, v_hist, rnd):
    """The whole-stack step's attention with the current token's own term
    dropped (a planted fault)."""
    from tpu_audio_torch.ops.kernels import fused_step as fs

    h = q.shape[0]
    k_hist, v_hist = fs._kv_heads(k_hist, h), fs._kv_heads(v_hist, h)
    w = torch.softmax(torch.einsum("htd,hd->ht", k_hist, q), dim=-1)
    return torch.einsum("ht,htd->hd", rnd(w), rnd(v_hist))


def step_cache(cfg, dev, randn, slots: int, start: int, pos: int):
    """A bf16 cache (L, KVH, slots, hd) filled before `pos`: the slots
    before `start` with keys and values of std 10 (they would dominate if
    read), the history [start, pos) with keys of std 3 (peaked scores) and
    values of std 2."""
    lyr, kvh, hd = cfg.n_layers, cfg.kv_heads, cfg.hd
    kc = torch.zeros(lyr, kvh, slots, hd, dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    kc[:, :, :start] = randn(lyr, kvh, start, hd, dtype=torch.bfloat16, scale=10.0)
    vc[:, :, :start] = randn(lyr, kvh, start, hd, dtype=torch.bfloat16, scale=10.0)
    kc[:, :, start:pos] = randn(lyr, kvh, pos - start, hd, dtype=torch.bfloat16, scale=3.0)
    vc[:, :, start:pos] = randn(lyr, kvh, pos - start, hd, dtype=torch.bfloat16, scale=2.0)
    return kc, vc


def step_plan(cfg, dev, int8: bool, slots: int) -> dict:
    """The whole-stack step's launch on the card at this width, logged."""
    from tpu_audio_torch.ops.kernels import fused_step as fs

    plan = fs.launch_plan(dev, int8=int8, d=cfg.dim, hidden=cfg.hidden_dim,
                          n_heads=cfg.n_heads, n_kv_heads=cfg.kv_heads, hd=cfg.hd, s_max=slots)
    log(f"fused_decode_step launch, D {cfg.dim}, {'int8' if int8 else 'bf16'} weights: {plan}")
    return plan


def hold_step(tag: str, stack: dict, cfg, n_layers: int, dtype, kc, vc, start: int, pos: int,
              dev, randn, int8: bool, faults: bool = True) -> float:
    """The whole-stack step against its plain version at `pos` and at start
    + 1 (the fresh term one of two), within rel 2e-2 / cosine 0.999, on h
    and the new k and v slots. With all of the model's layers, planted
    faults (in the plain version) must land outside: q/k-norm dropped
    (Qwen3), RoPE on the wrong half, KV head j % KVH, start ignored, the
    final norm dropped, a chunk merged twice (the last one holding keys, at
    the launch's split), the int8 scales not applied (int8); at start + 1
    the fresh term dropped (`faults` False: none). Returns the largest max
    abs error."""
    from tpu_audio_torch.ops.kernels import fused_step as fs

    hd = cfg.hd
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.kv_heads, hd=hd, eps=cfg.norm_eps)
    start_t = torch.tensor(start, device=dev)
    x = randn(1, cfg.dim, dtype=dtype, scale=0.5)

    def run(step, p, st=stack, s0=start_t):
        pos_t = torch.tensor(p, device=dev)
        cos, sin = fs.make_cos_sin(pos_t, cfg.inv_freq())
        kc_, vc_ = kc[:n_layers].clone(), vc[:n_layers].clone()
        h = step(st, x, pos_t, s0, cos, sin, kc_, vc_, **kw)
        return h, kc_[:, :, p], vc_[:, :, p]

    def plain(p=pos, **over):
        return run(fs.fused_decode_step_plain, p, **over)

    names = ("h", "k slot", "v slot")
    got = run(fs.fused_decode_step, pos)
    err = max(compare(f"{tag}: {n}, pos {pos}, start {start}", g, r, rel=2e-2)
              for n, g, r in zip(names, got, plain()))
    if n_layers < cfg.n_layers or not faults:
        return err
    split = step_plan(cfg, dev, int8, kc.shape[2])["split"]
    last = len([b for a, b in fs.chunk_bounds(pos - start, split) if b > a]) - 1
    faults = [
        ("RoPE on the wrong half", faulty(fs, "_rope", lambda v, c, s: v * c + torch.cat(
            [v[..., hd // 2:], -v[..., :hd // 2]], -1) * s, plain)),
        ("KV head j % KVH in place of j // G", faulty(
            fs, "_kv_heads", lambda t, n: t.repeat(n // t.shape[0], *[1] * (t.dim() - 1)),
            plain)),
        ("start ignored", lambda: plain(s0=torch.zeros_like(start_t))),
        ("the final norm dropped", faulty(fs, "_final_norm", lambda v, w, eps: v, plain)),
        (f"chunk {last} of {split} merged twice", faulty(
            fs, "_attention", lambda q, k, v, kh, vh, rnd: fs.attention_chunks(
                q, k, v, kh, vh, rnd, split=split, rb=False, twice=last), plain)),
    ]
    if "qknorm" in stack:
        faults.insert(0, ("qk-norm dropped", lambda: plain(
            st={k: v for k, v in stack.items() if k != "qknorm"})))
    if int8:
        faults.append(("int8 scales not applied", lambda: plain(st={
            k: (torch.ones_like(v) if k in ("sqkv", "so", "sgateup", "sdown") else v)
            for k, v in stack.items()})))
    planted_faults(tag, got, faults, rel=2e-2)
    p1 = start + 1
    got = run(fs.fused_decode_step, p1)
    err = max(err, *(compare(f"{tag}: {n}, pos {p1} (one history slot)", g, r, rel=2e-2)
                     for n, g, r in zip(names, got, plain(p1))))
    planted_faults(f"{tag}, pos {p1}", got, [
        ("the fresh term dropped", faulty(fs, "_attention", fresh_dropped,
                                          lambda: plain(p1)))], rel=2e-2)
    return err


def time_step(label: str, stack: dict, cfg, kc, vc, start: int, pos: int, dtype, dev,
              randn) -> tuple:
    """The whole stack timed (kernel and plain, the cache's slot `pos`
    rewritten in place) with the main path's activations: (ms, plain ms,
    bound). The bound: the weights, the vectors and the history's cache
    rows read once, the slot and h written once; f32 operations of the
    products and attention."""
    from tpu_audio_torch.ops.kernels import fused_step as fs

    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.kv_heads, hd=cfg.hd, eps=cfg.norm_eps)
    x = randn(1, cfg.dim, dtype=dtype, scale=0.5)
    pos_t, start_t = torch.tensor(pos, device=dev), torch.tensor(start, device=dev)
    cos, sin = fs.make_cos_sin(pos_t, cfg.inv_freq())
    args = (stack, x, pos_t, start_t, cos, sin, kc, vc)
    ms, pms = timed_pair(lambda: fs.fused_decode_step(*args, **kw),
                         lambda: fs.fused_decode_step_plain(*args, **kw), 20)
    weights = [stack[f"w{n}"] for n in ("qkv", "o", "gateup", "down")]
    vectors = [v for k, v in stack.items() if not k.startswith("w")]
    read = [*weights, *vectors, kc[:, :, start:pos], vc[:, :, start:pos], x]
    ops = {"f32": 2 * sum(w.numel() for w in weights)
           + 4 * cfg.n_layers * cfg.n_heads * (pos - start + 1) * cfg.hd}
    roof = bound(ops, nbytes(*read) + 4 * cfg.dim + 2 * nbytes(kc[:, :, pos]))
    log(f"time fused_decode_step {label} (pos {pos}, start {start}): kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms, bound {roof[0]:.4f} ms ({roof[1]}), {roof[0] / ms:.3f} of it")
    return ms, pms, roof


def check_fused_step(trees: dict, dev, randn, rows: list) -> None:
    """Phase 3, the whole-stack Qwen3 step at Fun-ASR-Nano's shapes on the
    bf16 and int8 trees (bf16 and f32 activations, as the main path gives
    them), bf16 cache filled to STEP_POS, first valid slot STEP_START
    (`step_cache`). The inputs make every term matter: random norm and
    q/k-norm weights, peaked scores, a residual of std 0.5. `hold_step`
    holds it against the plain version with planted faults. The
    bf16-activation case has no planted faults: one f32 sum that rounds
    across a bf16 boundary can read up to 1.5e-3 at two layers, and
    leaving the probabilities' bf16 rounding out reads 4.6e-3, too close
    to tell apart (on the card). The hd-64 instantiations, which no
    model of the main paths runs, are held at Llama-3.2-1B's width on two
    layers. The JSON row is the bf16 tree's timing; its err the largest of
    every check (`check_fused_step_llama` adds the 3B stack's)."""
    from tpu_audio_torch.models.funasr.model import QWEN3_06B as cfg
    from tpu_audio_torch.nn import transformer
    from tpu_audio_torch.nn.transformer import TransformerConfig
    from tpu_audio_torch.ops.kernels import fused_step as fs

    lyr, hd, s_max = cfg.n_layers, cfg.hd, 512
    kc, vc = step_cache(cfg, dev, randn, s_max, STEP_START, STEP_POS)
    err, row = 0.0, None
    for label in ("bf16", "int8"):
        full = dict(fs.prepare_stack(transformer.fuse_fp_tree(trees[label]["llm"])))
        full.update(ln1=1 + 0.3 * randn(lyr, cfg.dim), ln2=1 + 0.3 * randn(lyr, cfg.dim),
                    norm=1 + 0.3 * randn(cfg.dim), qknorm=1 + 0.3 * randn(lyr, 2, hd))
        # All 28 layers with f32 activations: no bf16 rounding between the
        # layers, so kernel and plain agree to f32 summation order and the
        # planted faults stand out. bf16 activations (the bf16 tree's) on
        # layers 0-1 only: a 1e-7 difference in an f32 sum can flip a bf16
        # rounding of hn, and 28 layers of peaked attention amplify such
        # flips to rel 1e-2..4e-2 between two right implementations.
        cases = [(f"{lyr} layers, f32 activations", full, torch.float32, lyr)]
        if label == "bf16":
            cases.insert(0, ("layers 0-1, bf16 activations",
                             {k: v if k == "norm" else v[:2] for k, v in full.items()},
                             torch.bfloat16, 2))
        for desc, stack, dtype, n_layers in cases:
            err = max(err, hold_step(f"fused_decode_step Qwen3-0.6B {label} weights, {desc}",
                                     stack, cfg, n_layers, dtype, kc, vc, STEP_START, STEP_POS,
                                     dev, randn, label == "int8"))
        dtype = torch.bfloat16 if label == "bf16" else torch.float32
        timing = time_step(f"Qwen3-0.6B {label}", full, cfg, kc, vc, STEP_START, STEP_POS,
                           dtype, dev, randn)
        if label == "bf16":
            row = timing
    # hd 64: Llama-3.2-1B's width, two layers, random stacks of both weight types
    small = TransformerConfig(**HD64_STACK)
    d, hidden = small.dim, small.hidden_dim
    kc1, vc1 = step_cache(small, dev, randn, 256, 4, 100)
    qo = (small.n_heads + 2 * small.kv_heads) * small.hd
    for label in ("bf16", "int8"):
        stack = {"ln1": 1 + 0.3 * randn(2, d), "ln2": 1 + 0.3 * randn(2, d),
                 "norm": 1 + 0.3 * randn(d)}
        for n, (o, i) in {"qkv": (qo, d), "o": (d, small.n_heads * small.hd),
                          "gateup": (2 * hidden, d), "down": (d, hidden)}.items():
            w = randn(2, o, i, scale=i ** -0.5)
            if label == "int8":
                stack[f"s{n}"] = w.abs().amax(-1) / 127
                stack[f"w{n}"] = torch.round(w / stack[f"s{n}"][..., None]).to(torch.int8)
            else:
                stack[f"w{n}"], stack[f"s{n}"] = w.to(torch.bfloat16), torch.ones(2, o, device=dev)
        err = max(err, hold_step(f"fused_decode_step hd 64 (Llama-3.2-1B width) {label} weights",
                                 stack, small, 2, torch.float32, kc1, vc1, 4, 100, dev, randn,
                                 label == "int8", faults=False))
    ms, pms, roof = row
    rows.append(kernel_row("fused_decode_step", "tpu_audio_torch/csrc/fused_step.cu",
                           "tpu_audio/ops/pallas/fused_step.py:239", err, ms, pms, roof, None,
                           "no one PyTorch call runs a decoder-stack step"))


def check_fused_step_llama(o_trees: dict, dev, randn, rows: list) -> None:
    """Phase 3, the whole-stack step at Orpheus's Llama-3.2-3B width on its
    default w8a8 tree (int8 weights, f32 activations: the dequantised rows
    of the int8 embedding), all 28 layers, cache filled to LLAMA_STEP_POS
    from LLAMA_STEP_START: `hold_step` with its planted faults, then timed
    with its bound. Raises the fused_decode_step row's err to this check's
    where it is larger; adds the row (with this timing) where phase 3's
    Qwen3 check did not run."""
    from tpu_audio_torch.models.orpheus.model import LLAMA_3B as cfg
    from tpu_audio_torch.ops.kernels import fused_step as fs

    lyr = cfg.n_layers
    stack = dict(fs.prepare_stack(o_trees["w8a8"]))
    stack.update(ln1=1 + 0.3 * randn(lyr, cfg.dim), ln2=1 + 0.3 * randn(lyr, cfg.dim),
                 norm=1 + 0.3 * randn(cfg.dim))
    kc, vc = step_cache(cfg, dev, randn, LLAMA_STEP_SLOTS, LLAMA_STEP_START, LLAMA_STEP_POS)
    err = hold_step(f"fused_decode_step Llama-3.2-3B int8 weights, {lyr} layers, f32 activations",
                    stack, cfg, lyr, torch.float32, kc, vc, LLAMA_STEP_START, LLAMA_STEP_POS,
                    dev, randn, True)
    ms, pms, roof = time_step("Llama-3.2-3B int8", stack, cfg, kc, vc, LLAMA_STEP_START,
                              LLAMA_STEP_POS, torch.float32, dev, randn)
    for r in rows:
        if r["name"] == "fused_decode_step":
            r["max_abs_err"] = max(r["max_abs_err"], err)
            return
    rows.append(kernel_row("fused_decode_step", "tpu_audio_torch/csrc/fused_step.cu",
                           "tpu_audio/ops/pallas/fused_step.py:239", err, ms, pms, roof, None,
                           "no one PyTorch call runs a decoder-stack step"))


def llama_params(cfg, dev, seed: int) -> dict:
    """A Llama tree of `transformer.numpy_params`'s keys, shapes and ranges
    (linears uniform ±1/√fan_in, norms 1, the embedding N(0, 0.02²)), drawn
    on the card from a generator seeded with `seed` (a 3B tree from numpy
    would take the host ~20 s), in bf16."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lyr, d, hd = cfg.n_layers, cfg.dim, cfg.hd

    def lin(fan_in, fan_out, layers=(lyr,)):
        w = torch.rand((*layers, fan_out, fan_in), generator=gen, device=dev) * 2 - 1
        return {"weight": (w / math.sqrt(fan_in)).to(torch.bfloat16)}

    def ones(*shape):
        return {"weight": torch.ones(shape, dtype=torch.bfloat16, device=dev)}

    params = {"layers": {"attn": {"q": lin(d, cfg.n_heads * hd), "k": lin(d, cfg.kv_heads * hd),
                                  "v": lin(d, cfg.kv_heads * hd), "o": lin(cfg.n_heads * hd, d)},
                         "mlp": {"gate": lin(d, cfg.hidden_dim), "up": lin(d, cfg.hidden_dim),
                                 "down": lin(cfg.hidden_dim, d)},
                         "ln1": ones(lyr, d), "ln2": ones(lyr, d)},
              "norm": ones(d),
              "embed": {"weight": (torch.randn((cfg.vocab_size, d), generator=gen, device=dev)
                                   * 0.02).to(torch.bfloat16)}}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = lin(d, cfg.vocab_size, ())
    return params


def orpheus_trees(dev, sg: bool = True) -> dict:
    """Orpheus's LM at Llama-3.2-3B width on random weights, as its engine
    serves it: "w4a8", the q4 tree (`quantize_tree`, the mlx checkpoint's
    format, tied embedding included) repacked to the pair-packed W4A8
    layout; "w8a8", the same q4 tree requantised to fused per-channel int8
    (the engine's default); and "sg", the super-group tree of
    `benchmarks/llm_decode.py --w4a8sg` at its 3b shape (vocab 128266, an
    untied head; layers and head requantised, the embedding bf16), unless
    sg is False."""
    from tpu_audio_torch.models.orpheus.model import LLAMA_3B
    from tpu_audio_torch.nn.transformer import TransformerConfig
    from tpu_audio_torch.ops import quant

    params = llama_params(LLAMA_3B, dev, SEED)
    q4 = quant.quantize_tree(params, bits=4)
    del params
    trees = {"w4a8": quant.repack_tree_w4a8(q4), "w8a8": quant.requantize_tree_int8(q4)}
    del q4
    if not sg:
        return trees
    params = llama_params(TransformerConfig(**SG_3B), dev, SEED + 1)
    q4 = quant.quantize_tree(params, bits=4, predicate=lambda k, v: not k.startswith("embed"))
    del params
    trees["sg"] = quant.requantize_tree_w4a8_sg(q4)
    return trees


def w4a8_terms(x, wp, scales, biases):
    """The pieces of the plain pair-layout product, to plant faults in:
    (per-pair plane dots dlo, dhi (B, P, O), even and odd scales (P, O),
    sx, the affine term, the odd groups' −8 correction)."""
    from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm

    b, i = x.shape
    xq, sx = w4mm.quantize_rows(x)
    x_lo, x_hi = w4mm.split_activations(xq)
    affine = x.float().reshape(b, -1, w4mm.GROUP).sum(-1) @ biases.float().T
    s_odd = scales.float()[:, 1::2]
    hi_fix = 8.0 * sx * (x_hi.float().reshape(b, -1, w4mm.GROUP).sum(-1) @ s_odd.T)
    dlo = w4mm._plane_dots(x_lo, wp & 15, w4mm.GROUP)
    dhi = w4mm._plane_dots(x_hi, wp & -16, w4mm.GROUP) / 16.0
    return dlo, dhi, scales.float()[:, 0::2].T, s_odd.T, sx, affine, hi_fix


def sg_terms(x, wp, scales_sg):
    """The pieces of the plain super-group product: (dlo, dhi (B, NS, O),
    scales (NS, O), sx, the low plane's −8 correction)."""
    from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm

    b, i = x.shape
    xq, sx = w4mm.quantize_rows(x)
    x_lo, x_hi = w4mm.split_activations(xq)
    lo_fix = -8.0 * sx * (x_lo.float().reshape(b, -1, w4mm.PAIR).sum(-1) @ scales_sg.float().T)
    dlo = w4mm._plane_dots(x_lo, wp & 15, w4mm.PAIR)
    dhi = w4mm._plane_dots(x_hi, wp & -16, w4mm.PAIR) / 16.0
    return dlo, dhi, scales_sg.float().T, sx, lo_fix


def w4a8_design_faults(x, wp, scales, biases=None) -> list:
    """Faults of the W4A8 kernel's own design, on the CPU model of its order
    of summation (`w4a8_order.mma_partials`) or on the plain version: the
    row scale taken from part of the row (the pairs of warps 1-7; the caller
    puts the row's |max| in pair 0), one warp's share of the pairs dropped,
    the scales read one group pair (pair layout) or one super-group off."""
    from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm
    from tpu_audio_torch.ops.kernels.int8_matmul import true_div
    from tpu_audio_torch.tools import w4a8_order

    sg = biases is None
    b, i = x.shape
    xq, sx = w4mm.quantize_rows(x)
    xsum = None if sg else x.float().reshape(b, -1, w4mm.GROUP).sum(-1)

    def total(parts):
        return functools.reduce(torch.add, parts.unbind(1))

    part = (torch.arange(i, device=x.device) // w4mm.PAIR) % w4a8_order.WARPS != 0
    s_part = torch.clamp(true_div(x.float()[:, part].abs().amax(-1, keepdim=True), 127.0),
                         min=1e-10)
    xq_part = torch.clamp(torch.round(x.float() / s_part), -127, 127).to(torch.int8)
    rolled = scales.roll(-1 if sg else -2, dims=1).contiguous()
    plain = (lambda: w4mm.w4a8_sg_matmul_plain(x, wp, rolled)) if sg else (
        lambda: w4mm.w4a8_matmul_plain(x, wp, rolled, biases))
    return [
        ("the row scale taken from the pairs of warps 1-7 only",
         lambda: (total(w4a8_order.mma_partials(xq_part, s_part, xsum, wp, scales, biases)),)),
        ("the share of the last pair's warp dropped",
         lambda: (lambda parts: (total(parts) - parts[:, (i // w4mm.PAIR - 1) % w4a8_order.WARPS],))(
             w4a8_order.mma_partials(xq, sx, xsum, wp, scales, biases))),
        ("the scales read one " + ("super-group" if sg else "group pair") + " off",
         lambda: (plain(),)),
    ]


def w4a8_edge_shapes(randn, errs: dict) -> None:
    """The stacked W4A8 entries, both formats, on random codes, scales and
    biases of 2 layers at shapes Llama-3.2-3B's layers do not reach, against
    the plain versions at rel 1e-5: I = 28672 and 14336, where a tile over all
    I does not fit in shared memory (its pairs in chunks; at 28672 fewer
    rows a pass), at 1, 8 and 32 rows; and scales and biases that start 4
    bytes past a 16-byte boundary (as a layer's view of stacked ones may),
    at 1 and 8 rows, O = 7."""
    from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm

    dev = randn(1).device
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)

    def off4(t):  # t's values at 4 bytes past a 16-byte boundary
        buf = torch.empty(t.numel() + 4, device=dev)[1:1 + t.numel()]
        return buf.copy_(t.reshape(-1)).view(t.shape)

    for i, o, ns, shift in ((28672, 40, (1, 8, 32), False), (14336, 72, (1, 8, 32), False),
                            (768, 7, (1, 8), True)):
        w_st = torch.randint(-128, 128, (2, o, i // 2), generator=gen, device=dev,
                             dtype=torch.int8)
        for sg in (False, True):
            n_groups = i // (w4mm.SUPER if sg else w4mm.GROUP)
            sc = torch.rand((o, n_groups), generator=gen, device=dev) * 1e-2 + 1e-3
            bi = None if sg else torch.randn((o, n_groups), generator=gen, device=dev) * 1e-2
            if shift:
                sc, bi = off4(sc), None if sg else off4(bi)
                assert sc.data_ptr() % 16 == 4
            name = "w4a8_sg_matmul_stacked" if sg else "w4a8_matmul_stacked"
            for n in ns:
                x = randn(n, i)
                x[:, 0] = 8.0
                if sg:
                    got = w4mm.w4a8_sg_matmul_stacked(x, w_st, sc, 1)
                    ref = w4mm.w4a8_sg_matmul_stacked_plain(x, w_st, sc, 1)
                else:
                    got = w4mm.w4a8_matmul_stacked(x, w_st, sc, bi, 1)
                    ref = w4mm.w4a8_matmul_stacked_plain(x, w_st, sc, bi, 1)
                errs[name] = max(errs[name], compare(
                    f"{name} random ({n}, {i}) x (2, {o}, {i // 2}) layer 1"
                    + (", scales at 4 mod 16 bytes" if shift else ""), got, ref, rel=1e-5))


def check_w4a8(trees: dict, randn, rows: list) -> None:
    """Phase 3, the four W4A8 kernels at Llama-3.2-3B's shapes, on the trees'
    own leaves: the pair layout's tied head (156940, 3072) and the
    super-group's untied head (128266, 3072) unstacked, each tree's gateup
    (16384, 3072) and down (3072, 8192) stacked on the last layer, at 1, 8
    and 32 rows, against the plain versions at rel 1e-5 (the integer dots
    are exact on both sides; only the f32 epilogue rounds in another order).
    Planted faults, applied to the plain pieces, must land outside: the high
    nibble's −8 bias uncorrected, the even and odd group scales swapped, the
    group biases dropped, the row scale ignored, the wrong layer, the
    super-group low plane's −8 dropped; and, on the stacked ones at 1 row
    (one launch) and 8 (the rows kernel and its dependents), the faults of
    `w4a8_design_faults`. Then the stacked ones on random codes at shapes
    the layers do not reach (`w4a8_edge_shapes`). Then each kernel timed at
    the main path's shape (the stacked ones at gateup on the layers in
    turn, their weights from device memory as in a forward), and the
    stacked ones at each of a layer's four shapes at 1 and 8 rows, on one
    layer and on the layers in turn."""
    from tpu_audio_torch.ops import quant
    from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm

    pair, sg = trees["w4a8"], trees["sg"]
    last = pair["layers"]["mlp"]["down"]["weight_q4p"].shape[0] - 1
    head_p, head_s = pair["embed"], sg["lm_head"]
    errs = {n: 0.0 for n in w4mm.LAUNCHES}
    dim = 2 * head_p["weight_q4p"].shape[1]
    for n in (1, 8, 32):
        x = randn(n, dim)
        got = w4mm.w4a8_matmul(x, head_p["weight_q4p"], head_p["scales"], head_p["biases"])
        ref = w4mm.w4a8_matmul_plain(x, head_p["weight_q4p"], head_p["scales"], head_p["biases"])
        errs["w4a8_matmul"] = max(errs["w4a8_matmul"], compare(
            f"w4a8_matmul tied head ({n}, {dim}) x {tuple(head_p['weight_q4p'].shape)}", got, ref,
            rel=1e-5))
        if n == 1:
            dlo, dhi, se, so, sx, affine, hi_fix = w4a8_terms(
                x, head_p["weight_q4p"], head_p["scales"], head_p["biases"])
            planted_faults("w4a8_matmul tied head", (got,), [
                ("the high nibble's -8 bias uncorrected",
                 lambda: (((dlo * se + dhi * so).sum(1)) * sx + affine,)),
                ("even and odd group scales swapped", lambda: (w4mm.w4a8_matmul_plain(
                    x, head_p["weight_q4p"], head_p["scales"].reshape(-1, 2).flip(-1).reshape(
                        head_p["scales"].shape), head_p["biases"]),)),
                ("the group biases dropped", lambda: (((dlo * se + dhi * so).sum(1)) * sx
                                                      + hi_fix,)),
                ("the row scale ignored", lambda: ((dlo * se + dhi * so).sum(1) + affine
                                                   + hi_fix / sx,)),
            ], rel=1e-5)
        got = w4mm.w4a8_sg_matmul(x, head_s["weight_q4s"], head_s["scales_sg"])
        ref = w4mm.w4a8_sg_matmul_plain(x, head_s["weight_q4s"], head_s["scales_sg"])
        errs["w4a8_sg_matmul"] = max(errs["w4a8_sg_matmul"], compare(
            f"w4a8_sg_matmul untied head ({n}, {dim}) x {tuple(head_s['weight_q4s'].shape)}", got,
            ref, rel=1e-5))
        if n == 1:
            dlo, dhi, s, sx, lo_fix = sg_terms(x, head_s["weight_q4s"], head_s["scales_sg"])
            planted_faults("w4a8_sg_matmul untied head", (got,), [
                ("the low plane's -8 dropped", lambda: (((dlo + dhi) * s).sum(1) * sx,)),
                ("the row scale ignored", lambda: (((dlo + dhi) * s).sum(1) + lo_fix / sx,)),
            ], rel=1e-5)
    for n in (1, 8, 32):
        for label in ("gateup", "down"):
            leaf = pair["layers"]["mlp"][label]
            w_st, sc, bi = leaf["weight_q4p"], leaf["scales"][last], leaf["biases"][last]
            x = randn(n, w_st.shape[2] * 2)
            x[:, 0] = 8.0  # the row's |max| in pair 0, one of warp 0's pairs
            got = w4mm.w4a8_matmul_stacked(x, w_st, sc, bi, last)
            errs["w4a8_matmul_stacked"] = max(errs["w4a8_matmul_stacked"], compare(
                f"w4a8_matmul_stacked {label} layer {last} ({n}, {x.shape[1]}) x "
                f"{tuple(w_st.shape)}", got, w4mm.w4a8_matmul_stacked_plain(x, w_st, sc, bi, last),
                rel=1e-5))
            if n == 8:
                planted_faults(f"w4a8_matmul_stacked {label}", (got,), [
                    (f"layer 0 read instead of layer {last}",
                     lambda: (w4mm.w4a8_matmul_stacked_plain(x, w_st, sc, bi, 0),))], rel=1e-5)
            if n < 32:
                planted_faults(f"w4a8_matmul_stacked {label} {n} rows", (got,),
                               w4a8_design_faults(x, w_st[last], sc, bi), rel=1e-5)
            leaf = sg["layers"]["mlp"][label]
            w_st, sc = leaf["weight_q4s"], leaf["scales_sg"][last]
            got = w4mm.w4a8_sg_matmul_stacked(x, w_st, sc, last)
            errs["w4a8_sg_matmul_stacked"] = max(errs["w4a8_sg_matmul_stacked"], compare(
                f"w4a8_sg_matmul_stacked {label} layer {last} ({n}, {x.shape[1]}) x "
                f"{tuple(w_st.shape)}", got, w4mm.w4a8_sg_matmul_stacked_plain(x, w_st, sc, last),
                rel=1e-5))
            if n == 8:
                dlo, dhi, s, sx, lo_fix = sg_terms(x, w_st[last], sc)
                planted_faults(f"w4a8_sg_matmul_stacked {label}", (got,), [
                    (f"layer 0 read instead of layer {last}",
                     lambda: (w4mm.w4a8_sg_matmul_stacked_plain(x, w_st, sc, 0),)),
                    ("the low plane's -8 dropped", lambda: (((dlo + dhi) * s).sum(1) * sx,))],
                    rel=1e-5)
            if n < 32:
                planted_faults(f"w4a8_sg_matmul_stacked {label} {n} rows", (got,),
                               w4a8_design_faults(x, w_st[last], sc), rel=1e-5)

    w4a8_edge_shapes(randn, errs)

    # timed at the main path's shapes: the heads and gateup at 1 row, the
    # stacked ones on the layers in turn (layer li's own scales and biases)
    gp, gs = pair["layers"]["mlp"]["gateup"], sg["layers"]["mlp"]["gateup"]
    x = randn(1, dim)
    turn = itertools.cycle(range(last + 1))
    cases = {
        "w4a8_matmul": ("tpu_audio/ops/pallas/w4a8_matmul.py:121", "tied head",
                        lambda: (head_p["weight_q4p"], head_p["scales"], head_p["biases"]),
                        lambda w, s, b: w4mm.w4a8_matmul(x, w, s, b),
                        lambda w, s, b: w4mm.w4a8_matmul_plain(x, w, s, b),
                        lambda: quant.dequantize(head_p)),
        "w4a8_matmul_stacked": ("tpu_audio/ops/pallas/w4a8_matmul.py:256",
                                "gateup, the layers in turn",
                                lambda: (gp["weight_q4p"], *(lambda li: (
                                    gp["scales"][li], gp["biases"][li], li))(next(turn))),
                                lambda w, s, b, li: w4mm.w4a8_matmul_stacked(x, w, s, b, li),
                                lambda w, s, b, li: w4mm.w4a8_matmul_stacked_plain(x, w, s, b, li),
                                lambda: quant.dequantize({k: v[last] for k, v in gp.items()})),
        "w4a8_sg_matmul": ("tpu_audio/ops/pallas/w4a8_matmul.py:422", "untied head",
                           lambda: (head_s["weight_q4s"], head_s["scales_sg"]),
                           lambda w, s: w4mm.w4a8_sg_matmul(x, w, s),
                           lambda w, s: w4mm.w4a8_sg_matmul_plain(x, w, s),
                           lambda: quant.dequantize(head_s)),
        "w4a8_sg_matmul_stacked": ("tpu_audio/ops/pallas/w4a8_matmul.py:513",
                                   "gateup, the layers in turn",
                                   lambda: (gs["weight_q4s"], *(lambda li: (
                                       gs["scales_sg"][li], li))(next(turn))),
                                   lambda w, s, li: w4mm.w4a8_sg_matmul_stacked(x, w, s, li),
                                   lambda w, s, li: w4mm.w4a8_sg_matmul_stacked_plain(x, w, s, li),
                                   lambda: quant.dequantize({k: v[last] for k, v in gs.items()})),
    }
    for name, (replaces, label, args, kernel, plain, dense) in cases.items():
        iters = 2 * (last + 1) if name.endswith("stacked") else 10
        ms, pms = timed_pair(lambda: kernel(*args()), lambda: plain(*args()), iters)
        w_bf16, xb = dense().to(torch.bfloat16), x.to(torch.bfloat16)
        lib_ms = time_ms(lambda: torch.nn.functional.linear(xb, w_bf16), 20)
        del w_bf16
        a = args()
        w = a[0][last] if name.endswith("stacked") else a[0]
        o, i = w.shape[0], 2 * w.shape[1]
        log(f"time {name} {label} (1, {i}) x ({o}, {i}): kernel {ms:.4f} ms, plain {pms:.4f} ms; "
            f"library: F.linear of the bf16 dequantised weight at 1 row {lib_ms:.4f} ms")
        rest = [t for t in a[1:] if isinstance(t, torch.Tensor)]
        rows.append(kernel_row(name, "tpu_audio_torch/csrc/w4a8_matmul.cu", replaces, errs[name],
                               ms, pms, bound({"int8": 2 * i * o}, nbytes(x, w, *rest) + 4 * o),
                               lib_ms))
    # the stacked kernels at each of a layer's four shapes (a forward runs
    # each once a layer), at 1 and 8 rows (generate, generate_batch), for the
    # launches x (time - bound) of each shape: on one layer (the weights warm
    # in L2 where they fit, as timed before) and on the layers in turn (from
    # device memory, as in a forward)
    for name, tree, key in (("w4a8_matmul_stacked", pair, "weight_q4p"),
                            ("w4a8_sg_matmul_stacked", sg, "weight_q4s")):
        kernel = getattr(w4mm, name)
        for part, label in (("attn", "qkv"), ("attn", "o"), ("mlp", "gateup"), ("mlp", "down")):
            leaf = tree["layers"][part][label]
            w_st = leaf[key]
            per_layer = [[v[li] for k, v in leaf.items() if k != key]
                         for li in range(w_st.shape[0])]
            o, i = w_st.shape[1], 2 * w_st.shape[2]
            for n in (1, 8):
                x = randn(n, i)
                ms = time_ms(lambda: kernel(x, w_st, *per_layer[last], last), 20)
                turn = itertools.cycle(range(w_st.shape[0]))

                def in_turn():
                    li = next(turn)
                    return kernel(x, w_st, *per_layer[li], li)
                ms_cold = time_ms(in_turn, 2 * w_st.shape[0])
                roof = bound({"int8": 2 * n * i * o},
                             nbytes(x, w_st[last], *per_layer[last]) + 4 * n * o)
                log(f"time {name} {label} layer {last} ({n}, {i}) x ({o}, {i}): kernel "
                    f"{ms:.4f} ms one layer, {ms_cold:.4f} ms layers in turn; bound "
                    f"{roof[0]:.4f} ms ({roof[1]}), {roof[0] / ms:.3f} and "
                    f"{roof[0] / ms_cold:.3f} of it")


def funasr_slice(trees: dict, dev, card: str) -> dict:
    """Phase 8: Fun-ASR-Nano through the public entry point on the bf16, q4
    and int8 trees: `STT.funasr()` → `FunASREngine.from_params` →
    transcribe, then translate, of a numpy-seeded 10 s clip; the launch
    counters; the split of a transcribe (encode + merge, prefill, ms per
    decode step); and the kernel path against the f32 plain path on the
    prefill logits and three teacher-forced steps, with faults planted in
    the whole-stack step. Returns the launch counts of the three runs."""
    from tpu_audio_torch.api.stt import STT
    from tpu_audio_torch.api.stt_funasr import build_prompt_text
    from tpu_audio_torch.models.funasr import model as fmodel
    from tpu_audio_torch.nn import transformer
    from tpu_audio_torch.ops import frontends
    from tpu_audio_torch.ops.decoding import decode_loop
    from tpu_audio_torch.ops.kernels import fused_step as fs
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
    from tpu_audio_torch.ops.kernels import quant_matmul as qmm
    from tpu_audio_torch.ops.sampling import SamplerConfig

    mods = (fs, qmm, i8mm)
    cfg = fmodel.FunASRConfig()
    lcfg = cfg.llm
    rng = np.random.default_rng(SEED + 8)
    clip = (rng.standard_normal(FUNASR_CLIP_SECONDS * 16000) * 0.1).astype(np.float32)
    need = {"bf16": ("fused_decode_step",), "q4": ("quant_matmul",),
            "int8": ("fused_decode_step", "int8_matmul")}
    total = {n: 0 for m in mods for n in m.LAUNCHES}
    for label, tree in trees.items():
        engine = STT.funasr().from_params(tree, cfg, max_cache=FUNASR_CACHE)
        gen = engine.generator
        reset(*mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.transcribe(clip, max_new_tokens=FUNASR_MAX_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res2 = engine.translate(clip, target_language="de", max_new_tokens=FUNASR_MAX_NEW)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0 - wall
        launches = launch_counts(*mods)
        log(f"funasr {label} launches (transcribe + translate): {launches}")
        if not all(launches[n] > 0 for n in need[label]) or (
                label == "q4" and launches["fused_decode_step"]):
            raise AssertionError(f"funasr {label}: a kernel of the path never launched, or the "
                                 f"q4 tree took the whole-stack step: {launches}")
        for n in total:
            total[n] += launches[n]
        if not (isinstance(res.text, str) and isinstance(res2.text, str)
                and res.duration == FUNASR_CLIP_SECONDS):
            raise AssertionError(f"funasr {label}: transcribe returned {res!r}")

        # the split of one transcribe: encode + merge, prefill, decode steps
        feats = frontends.funasr_features(torch.as_tensor(clip, device=dev))
        pre, post = (engine.tokenizer.encode(s) for s in build_prompt_text())
        stats = {"steps": 0}
        step = transformer.forward

        def counted(*a, **k):
            stats["steps"] += 1
            return step(*a, **k)

        def timed(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

        (x, shift), t_enc = timed(lambda: gen.prefill_inputs(pre, post, feats))
        llm = gen.params["llm"]

        def prefill():
            cache, extra = transformer.decode_cache_and_mask(lcfg, FUNASR_CACHE, shift,
                                                             gen.fused, device=dev)
            h, cache = transformer.forward_hidden(llm, lcfg, x, cache, extra)
            return cache, extra, transformer.logits(llm, lcfg, h[:, -1:])[:, 0].float()

        def decode(cache, extra, first_logits):  # the generator's greedy loop
            def step_fn(tok, c):
                lg, c = transformer.forward(llm, lcfg, tok, c, extra_mask=extra)
                return lg[:, -1].float(), c
            return decode_loop(step_fn, cache, first_logits.argmax(-1), FUNASR_MAX_NEW - 1,
                               eos_ids=engine._eos_ids, sampler=SamplerConfig(temperature=0.0),
                               pad_id=engine._eos_ids[0])

        runs = []
        for _ in range(2):
            state, t_pre = timed(prefill)
            stats["steps"] = 0
            with patched(transformer, "forward", counted):
                out, t_dec = timed(lambda: decode(*state))
            n = max(stats["steps"], 1)
            runs.append(f"prefill {1e3 * t_pre:.2f} ms, {1e3 * t_dec / n:.4f} ms per step")
        toks = out.tokens[0, :int(out.lengths[0])].tolist()
        if not all(0 <= tok < lcfg.vocab_size for tok in toks):
            raise AssertionError(f"funasr {label}: a token outside the vocabulary")
        log(f"funasr {label}: STT.funasr transcribe of {FUNASR_CLIP_SECONDS} s: {wall:.3f} s wall "
            f"({FUNASR_CLIP_SECONDS / wall:.2f}x real time), translate {wall2:.3f} s; split: "
            f"features + encode + merge {1e3 * t_enc:.2f} ms; {x.shape[1]} prompt slots, "
            f"{n} decode steps ({len(toks) + 1} tokens), two runs: {'; '.join(runs)}; "
            f"text {res.text[:40]!r} ({card})")

        # the kernel path against the f32 plain path: prefill logits and
        # three teacher-forced steps; the plain bf16 path's distance from
        # f32 (bf16 cache and, on the bf16 tree, activations) is the scale
        forced = tuple(t % lcfg.vocab_size for t in (100, 2000, 50000))

        def run_path(llm, x_in, cache_dtype):
            with torch.inference_mode():
                cache, extra = transformer.decode_cache_and_mask(
                    lcfg, FUNASR_CACHE, shift, gen.fused, dtype=cache_dtype, device=dev)
                h, cache = transformer.forward_hidden(llm, lcfg, x_in, cache, extra)
                out = [transformer.logits(llm, lcfg, h[:, -1:])[:, 0]]
                for t in forced:
                    lg, cache = transformer.forward(llm, lcfg, torch.tensor([[t]], device=dev),
                                                    cache, extra)
                    out.append(lg[:, -1])
            return torch.cat(out).float()

        llm32 = f32_tree(llm)
        with plain_kernels(*mods):
            exact = run_path(llm32, x.float(), torch.float32)
            plain_out = run_path(llm, x, torch.bfloat16)
        del llm32
        kernel_out = run_path(llm, x, torch.bfloat16)
        p_err = {}
        for name, sl in (("prefill logits (1, 151936)", slice(0, 1)),
                         ("step logits (3, 151936)", slice(1, 4))):
            _, e_k, cos_k = measure(kernel_out[sl], exact[sl])
            _, e_p, cos_p = measure(plain_out[sl], exact[sl])
            p_err[name] = e_p
            msg = (f"funasr {label} {name} against f32: kernels rel {e_k:.3e} cosine "
                   f"{cos_k:.6f}, plain rel {e_p:.3e} cosine {cos_p:.6f}, ratio {e_k / e_p:.3f}")
            if not (e_k <= SLICE_RATIO * e_p and cos_k > 0.999):
                raise AssertionError(f"{msg}: outside ratio {SLICE_RATIO} / cosine 0.999")
            log(msg)
        if not gen.fused:
            continue
        kernel = fs.fused_decode_step
        faults = {
            "qk-norm dropped": lambda st, *a, **k: kernel(
                {n: v for n, v in st.items() if n != "qknorm"}, *a, **k),
            "the layers in reverse order": lambda st, *a, **k: kernel(
                {n: v.flip(0) if n.startswith("w") else v for n, v in st.items()}, *a, **k),
            "the o-projection dropped": lambda st, *a, **k: kernel(
                {**st, "so": torch.zeros_like(st["so"])}, *a, **k),
        }
        if label == "int8":
            faults["int8 scales not applied"] = lambda st, *a, **k: kernel(
                {n: (torch.ones_like(v) if n in ("sqkv", "so", "sgateup", "sdown") else v)
                 for n, v in st.items()}, *a, **k)
        e_p = p_err["step logits (3, 151936)"]
        for name, fault in faults.items():
            with patched(fs, "fused_decode_step", fault):
                out = run_path(llm, x, torch.bfloat16)
            _, e_k, cos_k = measure(out[1:], exact[1:])
            control_ratio(f"funasr {label}", name, [e_k / e_p],
                          f"step logits ratio {e_k / e_p:.3f} cosine {cos_k:.6f}")
    return total


def frame_tokens(rng, frames: int) -> list[int]:
    """Valid 7-token SNAC frames: slot k of a frame in codebook page k."""
    from tpu_audio_torch.models.orpheus import model as om

    return [om.CODE_OFFSET + page * om.CODEBOOK_SIZE + int(v)
            for _ in range(frames) for page, v in enumerate(rng.integers(0, om.CODEBOOK_SIZE, 7))]


def timed(fn):
    """(fn(), host seconds) with the card synchronised on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def kernels_per_step(fn, steps: int) -> str:
    """Device kernels per forward pass (`steps` of them in fn) and the busy
    share of fn's traced run (torch.profiler), as text for the log."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, w = timed(fn)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return "the profiler saw no device kernels; not measured"
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return (f"{len(kernels) / steps:.1f} device kernels per forward pass over {steps}, device busy "
            f"{busy:.1f} ms = {busy / (1e3 * w):.3f} of the {w:.3f} s traced wall")


def spread_scales(tree: dict, spread: float) -> dict:
    """The tree with the layers' W4A8 weights of every odd group (along the
    input) `spread` times its even neighbour's (its scales and biases: w =
    q·s + b), both scaled so that a row's mean square stays as it was, so
    that neighbouring groups' scales differ and a fault that mixes them up
    moves the logits (random weights give every group nearly the same
    scale). The codes are shared."""
    k = math.sqrt(2 / (1 + spread ** 2))

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {key: walk(v) for key, v in node.items()}
        if "weight_q4p" in node:
            odd = torch.arange(node["scales"].shape[-1], device=node["scales"].device) % 2 == 1
            for name in ("scales", "biases"):
                out[name] = torch.where(odd, node[name] * (spread * k), node[name] * k)
        return out
    return dict(tree, layers=walk(tree["layers"]))


def orpheus_slice(trees: dict, dev, card: str) -> dict:
    """Phase 10: Orpheus at Llama-3.2-3B width on random weights through
    `TTS.orpheus()` → `OrpheusEngine.from_params` with the full-size SNAC:
    on the W4A8 tree, `generate_streaming` at TOKEN granularity, `generate`
    and `generate_batch` of 8 texts (ms per token at B=1 and tokens/s at
    B=8 of the LM alone, device kernels per step, SNAC ms per window, the
    streamed SNAC windows against the one-shot decode of given frames); on
    the default w8a8 tree one `generate`; the super-group tree's generator,
    greedy at B=1 and B=8; then the W4A8 kernel path against the f32 plain
    path on teacher-forced logits (prefill 32 + 8 steps), with faults
    planted in the W4A8 kernels. Returns the launch counts of the runs."""
    from tpu_audio_torch.api.tts import TTS, StreamingGranularity
    from tpu_audio_torch.codecs.snac import model as snac
    from tpu_audio_torch.models.orpheus import model as om
    from tpu_audio_torch.nn import transformer
    from tpu_audio_torch.ops.kernels import fused_step as fs
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
    from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm
    from tpu_audio_torch.ops.sampling import SamplerConfig

    mods = (w4mm, fs, i8mm)
    total = {n: 0 for m in mods for n in m.LAUNCHES}
    cfg = om.LLAMA_3B
    text = ORPHEUS_TEXTS[0]
    snac_cfg = snac.SNACConfig()
    snac_params = snac.init_params(SEED, snac_cfg, torch.float32, dev)

    def run(label, need, fn, absent=()):
        reset(*mods)
        out, wall = timed(fn)
        launches = launch_counts(*mods)
        log(f"orpheus {label}: {wall:.3f} s wall, launches {launches}")
        if not all(launches[n] for n in need) or any(launches[n] for n in absent):
            raise AssertionError(f"orpheus {label}: a kernel of the path never launched, or "
                                 f"one of {absent} did: {launches}")
        for n in total:
            total[n] += launches[n]
        return out, wall

    def lm_ms(gen, prompts, sampler, label):
        """Log the LM alone: prefill + first token, then ms per decode step
        and tokens per second over all rows (one run, for the script's time)."""
        kw = dict(sampler=sampler, eos_ids=(om.END_TOKEN,), seed=0)
        call = ((lambda n: gen.generate(prompts[0], max_new=n, **kw)) if len(prompts) == 1
                else (lambda n: gen.generate_batch(prompts, max_new=n, **kw)))
        call(2)  # warm-up
        _, t_first = timed(lambda: call(1))
        out, w = timed(lambda: call(ORPHEUS_MAX_NEW))
        n = sum(len(r) for r in ([out] if len(prompts) == 1 else out))
        log(f"orpheus {label} LM alone, B={len(prompts)}: prefill + first token "
            f"{1e3 * t_first:.1f} ms; {ORPHEUS_MAX_NEW - 1} steps: "
            f"{1e3 * (w - t_first) / (ORPHEUS_MAX_NEW - 1):.2f} ms per step, "
            f"{n / w:.1f} tokens/s ({card})")

    # ------------------------------------------------ the W4A8 tree
    w4 = ("w4a8_matmul", "w4a8_matmul_stacked")
    eng = TTS.orpheus().from_params(trees["w4a8"], cfg, snac_params)
    first_chunk = {}

    def stream():
        t0, chunks = time.perf_counter(), []
        for c in eng.generate_streaming(text, granularity=StreamingGranularity.TOKEN,
                                        max_new_tokens=ORPHEUS_MAX_NEW):
            first_chunk.setdefault("s", time.perf_counter() - t0)
            chunks.append(c)
        return chunks

    chunks, wall = run("w4a8 generate_streaming (TOKEN)", w4, stream,
                       absent=("fused_decode_step",))
    audio = np.concatenate([c.samples for c in chunks])
    if (sum(c.is_final for c in chunks) != 1 or not chunks[-1].is_final
            or not np.isfinite(audio).all() or len(audio) % (4 * snac_cfg.hop)):
        raise AssertionError(f"orpheus w4a8 stream: {len(chunks)} chunks, {len(audio)} samples")
    log(f"orpheus w4a8 stream: {len(chunks)} chunks, {len(audio)} samples "
        f"({len(audio) / 24000:.3f} s of audio), first chunk after {first_chunk['s']:.3f} s")
    res, wall = run("w4a8 generate", w4, lambda: eng.generate(text, max_new_tokens=ORPHEUS_MAX_NEW),
                    absent=("fused_decode_step",))
    if res.sample_rate != 24000 or not np.isfinite(res.samples).all():
        raise AssertionError(f"orpheus w4a8 generate: {res!r}")
    sampler = eng._sampler()
    prompts = [eng._prompt(t) for t in ORPHEUS_TEXTS]
    lm_ms(eng.lm, prompts[:1], sampler, "w4a8")
    log("orpheus w4a8 LM, prefill + 32 steps profiled: " + kernels_per_step(
        lambda: eng.lm.generate(prompts[0], sampler=sampler, eos_ids=(om.END_TOKEN,),
                                max_new=33), 33))
    results, wall = run(f"w4a8 generate_batch x{ORPHEUS_BATCH}", w4,
                        lambda: eng.generate_batch(ORPHEUS_TEXTS, max_new_tokens=ORPHEUS_MAX_NEW))
    if len(results) != ORPHEUS_BATCH or not all(np.isfinite(r.samples).all() for r in results):
        raise AssertionError("orpheus w4a8 generate_batch: non-finite or missing audio")
    lm_ms(eng.lm, prompts, sampler, "w4a8")

    # SNAC: ms per window, and the streamed windows against the one-shot
    # decode of given frames
    toks = frame_tokens(np.random.default_rng(SEED + 10), 23)
    layers = om.parse_frames(toks)
    eng._snac_window(layers, 0, 12, 0)
    per = [timed(lambda: eng._snac_window(layers, 4, 12, 0))[1] for _ in range(3)]
    log(f"orpheus SNAC window of 12 frames ({48 * snac_cfg.hop} samples): "
        f"{', '.join(f'{1e3 * t:.2f}' for t in per)} ms ({card})")
    eng.lm.stream_spans = lambda *a, **k: (toks[i:i + eng.STREAM_SPAN]
                                           for i in range(0, len(toks), eng.STREAM_SPAN))
    got = np.concatenate([c.samples for c in eng.generate_streaming(text)])
    del eng.lm.stream_spans
    ref = eng._decode_snac(layers, seed=0)
    diff = float(np.abs(got - ref).max()) if got.shape == ref.shape else float("inf")
    if not diff <= 1e-4:
        raise AssertionError(f"orpheus: streamed SNAC {got.shape} against one-shot {ref.shape}: "
                             f"max diff {diff}")
    log(f"orpheus streamed SNAC (23 frames in spans of {eng.STREAM_SPAN}) against the one-shot "
        f"decode: {got.shape[0]} samples, max abs diff {diff:.3e}")

    # ------------------------------------------------ the default w8a8 tree
    # its prefill runs the int8 matmul at 32 rows of the 8192-wide down
    # projection: 256 KB of codes, which used to overflow a block's shared
    # memory (ROADMAP C6); the rows now run in passes
    down = trees["w8a8"]["layers"]["mlp"]["down"]
    last = down["weight_i8"].shape[0] - 1
    x = randn_on(dev)(32, down["weight_i8"].shape[2])
    compare(f"int8_matmul_stacked down layer {last} (32, {x.shape[1]}) x "
            f"{tuple(down['weight_i8'].shape)} s8, in passes of 16 rows",
            i8mm.int8_matmul_stacked(x, down["weight_i8"], down["scale_i8"][last], last),
            i8mm.int8_matmul_stacked_plain(x, down["weight_i8"], down["scale_i8"][last], last),
            rel=1e-5)
    eng8 = TTS.orpheus().from_params(trees["w8a8"], cfg, snac_params)
    res, wall = run("w8a8 generate", ("fused_decode_step", "int8_matmul"),
                    lambda: eng8.generate(text, max_new_tokens=ORPHEUS_MAX_NEW), absent=w4)
    if not np.isfinite(res.samples).all():
        raise AssertionError("orpheus w8a8 generate: non-finite audio")
    before = fs.LAUNCHES["fused_decode_step"]
    lm_ms(eng8.lm, prompts[:1], sampler, "w8a8")
    timed_steps = fs.LAUNCHES["fused_decode_step"] - before
    log(f"orpheus w8a8 fused_decode_step launches: generate {before}, the LM timing runs "
        f"{timed_steps}")
    total["fused_decode_step"] += timed_steps
    del eng8

    # ------------------------------------------------ the super-group tree
    from tpu_audio_torch.nn.transformer import TransformerConfig

    sg_cfg = TransformerConfig(**SG_3B)
    gen = om.CausalLMGenerator(trees["sg"], sg_cfg, max_cache=None, pad_id=om.PAD_TOKEN)
    greedy = SamplerConfig(temperature=0.0)
    sg = ("w4a8_sg_matmul", "w4a8_sg_matmul_stacked")
    kw = dict(sampler=greedy, eos_ids=(om.END_TOKEN,), max_new=ORPHEUS_MAX_NEW)
    out, _ = run("sg generate B=1", sg, lambda: [gen.generate(prompts[0], **kw)], absent=w4)
    out2, _ = run(f"sg generate_batch x{ORPHEUS_BATCH}", sg,
                  lambda: gen.generate_batch(prompts, **kw), absent=w4)
    if not all(0 <= t < sg_cfg.vocab_size for row in out + out2 for t in row):
        raise AssertionError("orpheus sg: a token outside the vocabulary")
    lm_ms(gen, prompts[:1], greedy, "sg")
    log("orpheus sg LM, prefill + 32 steps profiled: " + kernels_per_step(
        lambda: gen.generate(prompts[0], sampler=greedy, eos_ids=(om.END_TOKEN,), max_new=33),
        33))
    lm_ms(gen, prompts, greedy, "sg")
    del gen

    # ------------------------------------------------ against f32
    # The W4A8 tree's kernel path (bf16 cache) against the plain path in f32
    # (the same codes and scales, f32 norms and cache), and the plain path
    # with the bf16 cache as the scale; prefill of 32 slots and 8
    # teacher-forced steps; faults planted in the W4A8 kernels must land
    # CV_FAULT_RATIO outside. The swap of neighbouring groups' scales is
    # held on a tree whose neighbouring groups differ (`spread_scales`).
    prompt, start = eng.lm._prompt(eng._prompt(ORPHEUS_TEXTS[1]), 32)
    forced = [om.CODE_OFFSET + k * om.CODEBOOK_SIZE + 37 * k for k in range(7)] + [om.END_TOKEN]
    off = torch.tensor([start], device=dev)

    def run_path(params, cache_dtype):
        with torch.inference_mode():
            cache, extra = transformer.decode_cache_and_mask(cfg, 64, start, False,
                                                             dtype=cache_dtype, device=dev)
            lg, cache = transformer.forward(params, cfg, prompt[None], cache, extra,
                                            pos_offset=off)
            out = [lg[:, -1]]
            for t in forced:
                lg, cache = transformer.forward(params, cfg, torch.tensor([[t]], device=dev),
                                                cache, extra, pos_offset=off)
                out.append(lg[:, -1])
        return torch.cat(out).float()

    stacked, head = w4mm.w4a8_matmul_stacked, w4mm.w4a8_matmul
    faults = {
        "layer 0 read in every layer": ("w4a8_matmul_stacked",
                                        lambda x, w, s, b, li: stacked(x, w, s, b, 0)),
        "group biases dropped in the layers": (
            "w4a8_matmul_stacked", lambda x, w, s, b, li: stacked(x, w, s, torch.zeros_like(b),
                                                                  li)),
        "the head's group biases dropped": (
            "w4a8_matmul", lambda x, w, s, b: head(x, w, s, torch.zeros_like(b))),
    }
    swap = {"even and odd group scales swapped in the layers": (
        "w4a8_matmul_stacked", lambda x, w, s, b, li: stacked(
            x, w, s.reshape(-1, 2).flip(-1).reshape(s.shape).contiguous(), b, li))}
    outputs = (f"prefill logits (1, {cfg.vocab_size})", f"step logits (8, {cfg.vocab_size})")
    parts = (slice(0, 1), slice(1, 9))
    for label, tree, planted in (
            ("orpheus w4a8", trees["w4a8"], faults),
            (f"orpheus w4a8, scales spread {ORPHEUS_SCALE_SPREAD:g}x",
             spread_scales(trees["w4a8"], ORPHEUS_SCALE_SPREAD), swap)):
        with plain_kernels(w4mm):
            exact = run_path(f32_tree(tree), torch.float32)
            plain_out = run_path(tree, torch.bfloat16)
        # the plain path's own cosine to f32 is ~0.998 here (the bf16 cache
        # through 28 random-weight layers, int8 activations): the cosine is
        # held relative to it
        p_err, p_cos = zip(*[measure(plain_out[sl], exact[sl])[1:] for sl in parts])
        log(f"{label} plain bf16 path against f32: " + ", ".join(
            f"{name.split(' (')[0]} rel {e:.3e} cosine {c:.6f}"
            for name, e, c in zip(outputs, p_err, p_cos)))
        held_against_f32(label, outputs, [exact[sl] for sl in parts], p_err, "kernels",
                         [run_path(tree, torch.bfloat16)[sl] for sl in parts], control=False,
                         p_cos=p_cos)
        for fault, (name, fn) in planted.items():
            with patched(w4mm, name, fn):
                out = run_path(tree, torch.bfloat16)
            held_against_f32(label, outputs, [exact[sl] for sl in parts], p_err, fault,
                             [out[sl] for sl in parts], control=True, p_cos=p_cos)
    return total


# ------------------------------------------------ 11. checkpoints in, files out

# safetensors dtype names of numpy dtypes (BF16 comes from torch tensors)
ST_DTYPES = {"float64": "F64", "float32": "F32", "float16": "F16", "int64": "I64",
             "int32": "I32", "int16": "I16", "int8": "I8", "uint8": "U8", "uint32": "U32",
             "bool": "BOOL"}
WHISPER_MLX_NAMES = [(".attn.q.", ".attn.query."), (".attn.k.", ".attn.key."),
                     (".attn.v.", ".attn.value."), (".attn.o.", ".attn.out."),
                     (".ln1.", ".attn_ln."), (".ln_cross.", ".cross_attn_ln."),
                     (".ln2.", ".mlp_ln."), (".mlp.fc1.", ".mlp1."), (".mlp.fc2.", ".mlp2.")]
LLAMA_HF_NAMES = [(".attn.q.", ".self_attn.q_proj."), (".attn.k.", ".self_attn.k_proj."),
                  (".attn.v.", ".self_attn.v_proj."), (".attn.o.", ".self_attn.o_proj."),
                  (".attn.q_norm.", ".self_attn.q_norm."),
                  (".attn.k_norm.", ".self_attn.k_norm."), (".mlp.gate.", ".mlp.gate_proj."),
                  (".mlp.up.", ".mlp.up_proj."), (".mlp.down.", ".mlp.down_proj."),
                  (".ln1.", ".input_layernorm."), (".ln2.", ".post_attention_layernorm.")]
QWEN2_PAT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
             r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_PAT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
              r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LOAD_CLIP_SECONDS = 6        # phase 11's Whisper clip
LOAD_FUNASR_NEW = 24         # phase 11's Fun-ASR tokens per transcribe
LOAD_ORPHEUS_NEW = 56        # phase 11's Orpheus tokens per generate (8 frames)
LOAD_T3_NEW = 24             # phase 11's greedy tokens of each Chatterbox T3
LOAD_KOKORO_TEXT = "Hello from the card, read by Kokoro."  # phase 11's sentence


def write_safetensors(path, tensors: dict, metadata: dict | None = None) -> int:
    """Write `tensors` (name → numpy array, or torch tensor; bf16 tensors
    as BF16) as a safetensors file; return its bytes. The script's own
    writer: the card's Python has no `safetensors`, and the package only
    reads."""
    entries, off = [], 0
    for name, t in tensors.items():
        if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
            dt, arr = "BF16", t.detach().contiguous().view(torch.int16).cpu().numpy()
        else:
            arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            dt = ST_DTYPES[arr.dtype.name]
        arr = np.require(arr, requirements="C")  # 0-d stays 0-d
        entries.append((name, dt, arr))
        off += arr.nbytes
    header, off = {}, 0
    if metadata:
        header["__metadata__"] = metadata
    for name, dt, arr in entries:
        header[name] = {"dtype": dt, "shape": list(arr.shape),
                        "data_offsets": [off, off + arr.nbytes]}
        off += arr.nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for _, _, arr in entries:
            f.write(arr.data)
    return 8 + len(head) + off


def renamed(key: str, names) -> str:
    for ours, theirs in names:
        key = key.replace(ours, theirs)
    return key


def unstacked(flat: dict, prefix: str, out_prefix: str) -> dict:
    """'{prefix}.rest' stacked (L, …) leaves → '{out_prefix}.{i}.rest' per layer."""
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix + "."):
            rest = k[len(prefix) + 1:]
            out.update({f"{out_prefix}.{i}.{rest}": v[i] for i in range(v.shape[0])})
        else:
            out[k] = v
    return out


def packed_weights(flat: dict) -> dict:
    """The mlx quantised leaf names: weight_q4/weight_q8 int32 words → "weight"
    uint32; scales and biases stay."""
    out = {}
    for k, v in flat.items():
        if re.search(r"\.weight_q[48]$", k):
            k, v = k.rsplit(".", 1)[0] + ".weight", v.cpu().numpy().view(np.uint32)
        out[k] = v
    return out


def bf16_affine(tree: dict) -> dict:
    """A group-affine tree with its scales and biases rounded to bf16 (as the
    published checkpoints store them), kept float32."""
    from tpu_audio_torch.utils import pytree

    return pytree.unflatten({k: v.bfloat16().float() if k.endswith((".scales", ".biases"))
                             else v for k, v in pytree.flatten(tree).items()})


def whisper_mlx_flat(tree: dict, cfg) -> dict:
    """A port Whisper tree (fp or group-affine) → the flat dict of an
    mlx-community checkpoint: numbered blocks, openai names, convs (O, K, I),
    packed uint32 words, and the encoder sinusoids that sanitize drops."""
    from tpu_audio_torch.nn.layers import sinusoidal_positions
    from tpu_audio_torch.utils import pytree

    flat = unstacked(unstacked(pytree.flatten(tree), "encoder.blocks", "encoder.blocks"),
                     "decoder.blocks", "decoder.blocks")
    flat = {renamed(k, WHISPER_MLX_NAMES): v.permute(0, 2, 1) if re.match(
        r"encoder\.conv[12]\.weight$", k) else v for k, v in packed_weights(flat).items()}
    flat["encoder.positional_embedding"] = sinusoidal_positions(
        cfg.n_audio_ctx, cfg.n_audio_state).astype(np.float16)
    return flat


def llama_flat(tree: dict, prefix: str = "") -> dict:
    """A port Llama/Qwen tree → the flat dict of an HF/mlx checkpoint, keys
    under `prefix`: model.layers.N.self_attn.q_proj, …, packed uint32 words."""
    from tpu_audio_torch.utils import pytree

    flat = packed_weights(unstacked(pytree.flatten(tree), "layers", "model.layers"))
    out = {}
    for k, v in flat.items():
        k = renamed("." + k, LLAMA_HF_NAMES)[1:]
        k = re.sub(r"^embed\.", "model.embed_tokens.", re.sub(r"^norm\.", "model.norm.", k))
        out[prefix + k] = v
    return out


def funasr_flat(tree: dict) -> dict:
    """A port Fun-ASR tree → the flat dict of an mlx-community checkpoint:
    encoder.* and adaptor.* as named in the tree (the FSMN kernels in
    torch's (C, 1, K)), the Qwen3 stack under llm.model.*."""
    from tpu_audio_torch.utils import pytree

    flat = {f"{side}.{k}": v for side in ("encoder", "adaptor")
            for k, v in pytree.flatten(tree[side]).items()}
    flat.update(llama_flat(tree["llm"], "llm."))
    return flat


def snac_torch_flat(tree: dict) -> dict:
    """A port SNAC tree → the flat dict that `convert_snac` reads: torch
    SNAC's names (decoder.model.N.block.M…, quantizer.quantizers.N…) and
    layouts: conv kernels (O, I, K), Snake alphas (1, C, 1)."""
    from tpu_audio_torch.utils import pytree

    res = {"snake1": 0, "conv1": 1, "snake2": 2, "conv2": 3}
    out = {}
    for k, v in pytree.flatten(tree).items():
        if k.endswith(".alpha"):
            v = v.permute(0, 2, 1)
        m = re.match(r"quantizer\.(\d+)\.(.*)$", k)
        if m:
            out[f"quantizer.quantizers.{m.group(1)}.{m.group(2)}"] = v
            continue
        k = re.sub(r"^decoder\.", "", k)
        for name, idx in (("depthwise_conv", 0), ("pointwise_conv", 1), ("final_snake", 6),
                          ("final_conv", 7)):
            k = re.sub(rf"^{name}\.", f"model.{idx}.", k)
        m = re.match(r"blocks\.(\d+)\.(.*)$", k)
        if m:
            b, rest = int(m.group(1)), m.group(2)
            rest = re.sub(r"^snake\.", "block.0.", rest)
            rest = re.sub(r"^convT\.", "block.1.", rest)
            rest = re.sub(r"^noise\.", "block.2.", rest)
            r = re.match(r"residuals\.(\d+)\.(\w+)\.(.*)$", rest)
            if r:
                rest = f"block.{int(r.group(1)) + 3}.block.{res[r.group(2)]}.{r.group(3)}"
            k = f"model.{b + 2}.{rest}"
        out["decoder." + k] = v
    return out


def dac_torch_flat(tree: dict) -> dict:
    """A port DAC tree → the flat dict that `convert_dac` reads: torch DAC's
    names (encoder.block.N…, decoder.model.N…, quantizer.quantizers.N…) and
    layouts: conv kernels (O, I, K), transposed ones (I, O, K), Snake alphas
    (1, C, 1)."""
    from tpu_audio_torch.utils import pytree

    res = {"snake1": 0, "conv1": 1, "snake2": 2, "conv2": 3}
    enc_blk = {"snake": 3, "conv": 4}
    dec_blk = {"snake": 0, "convT": 1}
    out = {}
    for k, v in pytree.flatten(tree).items():
        if k.endswith(".alpha"):
            v = v.permute(0, 2, 1)
        side, name, rest = k.split(".", 2)
        if side == "quantizer":
            out[f"quantizer.quantizers.{name}.{rest}"] = v
            continue
        seq = "block" if side == "encoder" else "model"
        top = {"conv_in": 0, "snake_out": 5, "conv_out": 6}
        if name in top:
            out[f"{side}.{seq}.{top[name]}.{rest}"] = v
            continue
        b, part, tail = rest.split(".", 2)  # blocks.<b>.<part>.<tail>
        if part == "residuals":
            j, unit, leaf = tail.split(".", 2)
            inner = f"block.{int(j) + (0 if side == 'encoder' else 2)}.block.{res[unit]}.{leaf}"
        else:
            inner = f"block.{(enc_blk if side == 'encoder' else dec_blk)[part]}.{tail}"
        out[f"{side}.{seq}.{int(b) + 1}.{inner}"] = v
    return out


def mimi_torch_flat(tree: dict) -> dict:
    """A port Mimi tree → the flat dict that `convert_mimi` reads: each conv
    under its `.conv.conv.` (transposed: `.convtr.convtr.`) wrapper,
    encoder.model.N / decoder.model.N, the kernels in torch's layouts (the
    port's own: (O, I, K), (I, O, K), the upsampler (C, 1, K))."""
    from tpu_audio_torch.codecs.mimi.model import conv_layout
    from tpu_audio_torch.utils import pytree

    flat = pytree.flatten(tree)
    out = {}
    for k, v in flat.items():
        base, leaf = k.rsplit(".", 1)
        w = flat.get(base + ".weight")
        if w is not None and w.dim() == 3 and ".input_proj" not in base \
                and ".output_proj" not in base:
            wrap = {"conv": ".conv.conv", "transposed": ".convtr.convtr",
                    "depthwise": ".convtr.convtr"}[conv_layout(base + ".weight")]
            k = f"{base}{wrap}.{leaf}"
        out[re.sub(r"^(encoder|decoder)\.layers\.", r"\1.model.", k)] = v
    return out


def cosyvoice2_flat(lm_tree: dict, s3_tree: dict) -> dict:
    """A port CosyVoice2 LM tree and a JAX-layout S3Gen numpy tree → the
    flat dict that `models/cosyvoice2/load.convert` reads: the Qwen2 stack
    under llm.llm.model.*, the heads under their names; S3Gen's groups
    under flow.*, hift.* and campplus.*, each 3-D kernel turned back by the
    inverse of the loader's rule ((O, I, K), and (I, O, K) under ups and
    up_layer), the 4-D ones as they are."""
    from tpu_audio_torch.utils import pytree

    flat = llama_flat(lm_tree["llm"], "llm.llm.")
    flat.update({k: v for k, v in pytree.flatten(
        {n: lm_tree[n] for n in lm_tree if n != "llm"}).items()})
    groups = {"flow": "flow", "mel2wav": "hift", "speaker_encoder": "campplus"}
    for k, v in pytree.flatten(s3_tree).items():
        side, rest = k.split(".", 1)
        v = np.asarray(v)
        if v.ndim == 3:
            v = v.transpose(1, 2, 0) if re.search(r"\.(ups|convT|up_layer)\.",
                                                  "." + rest) else v.transpose(2, 1, 0)
        flat[f"{groups[side]}.{rest}"] = np.ascontiguousarray(v)
    return flat


CV3_FLOW_NAMES = [(".blocks.", ".transformer_blocks."), (".attn.to_out.", ".attn.to_out.0."),
                  (".ff.fc1.", ".ff.ff.0.0."), (".ff.fc2.", ".ff.ff.2."),
                  (".input_embed.conv", ".input_embed.conv_pos_embed.conv"),
                  (".final_norm.linear.", ".norm_out.linear.")]


def cosyvoice3_flat(lm_tree: dict, flow_tree: dict) -> dict:
    """A port CosyVoice2-family LM tree and a JAX-layout CosyVoice3 flow
    numpy tree → the flat dict that `models/cosyvoice3/load.convert` reads:
    the LM as `cosyvoice2_flat` writes it; the flow under flow.* with the
    DiT under upstream CosyVoice's names (decoder.estimator.
    transformer_blocks.N, to_out.0, ff.ff.0.0, ff.ff.2, conv_pos_embed,
    norm_out) and a rotary table the loader drops, HiFT under hift.*, each
    3-D kernel in torch's (O, I, K) ((I, O, K) under ups)."""
    from tpu_audio_torch.utils import pytree

    flat = cosyvoice2_flat(lm_tree, {})
    for k, v in pytree.flatten(flow_tree).items():
        side, rest = k.split(".", 1)
        v = np.asarray(v)
        if v.ndim == 3:
            v = v.transpose(1, 2, 0) if ".ups." in "." + rest else v.transpose(2, 1, 0)
        if side == "mel2wav":
            key = f"hift.{rest}"
        elif side == "decoder_estimator":
            key = "flow.decoder.estimator." + renamed("." + rest, CV3_FLOW_NAMES)[1:]
        else:
            key = f"flow.{k}"
        flat[key] = np.ascontiguousarray(v)
    flat["flow.decoder.estimator.rotary_embed.inv_freq"] = np.ones(8, np.float32)
    return flat


def s3gen_torch_flat(s3_tree: dict, prefix: str) -> dict:
    """A JAX-layout S3Gen tree (numpy arrays or tensors) → flat tensors under
    `prefix`, each 3-D weight turned back by the inverse of Chatterbox's
    `_convert_conv_layouts` ((O, I, K), and (I, O, K) under ups, convT and
    up_layer)."""
    from tpu_audio_torch.utils import pytree

    out = {}
    for k, v in pytree.flatten(s3_tree).items():
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        if v.dim() == 3 and (".weight" in k or k.endswith("weight_v")):
            v = v.permute(1, 2, 0) if re.search(r"\.(ups|convT|up_layer)\.", k) else \
                v.permute(2, 1, 0)
        out[prefix + k] = v.contiguous()
    return out


def s3_jax_layout(tree: dict) -> dict:
    """A port S3-family tree → the JAX layouts (the inverse of
    `convert.s3_perm`), on its device."""
    from tpu_audio_torch.convert import s3_perm
    from tpu_audio_torch.utils import pytree

    out = {}
    for k, v in pytree.flatten(tree).items():
        perm = s3_perm(k, v.dim())
        out[k] = v.permute(*np.argsort(perm).tolist()) if perm else v
    return pytree.unflatten(out)


def chatterbox_flat(t3_tree: dict, s3_tree: dict, ve_tree: dict) -> dict:
    """A port T3 tree (fp or group-affine), a JAX-layout S3Gen numpy tree
    and a voice-encoder tree → the flat dict of an mlx-community Chatterbox
    checkpoint as `models/chatterbox/load.py` reads it: the Llama stack
    under t3.tfmr.model.*, T3's other leaves under t3.* (packed uint32
    words), S3Gen under s3gen.*, the voice encoder under ve.*."""
    from tpu_audio_torch.utils import pytree

    flat = llama_flat(t3_tree["tfmr"], "t3.tfmr.")
    flat.update({"t3." + k: v for k, v in packed_weights(pytree.flatten(
        {n: t3_tree[n] for n in t3_tree if n != "tfmr"})).items()})
    flat.update(s3gen_torch_flat(s3_tree, "s3gen."))
    flat.update({"ve." + k: v for k, v in pytree.flatten(ve_tree).items()})
    return flat


GPT2_HF_NAMES = [(".attn.o.", ".attn.c_proj."), (".mlp.fc1.", ".mlp.c_fc."),
                 (".mlp.fc2.", ".mlp.c_proj."), (".ln1.", ".ln_1."), (".ln2.", ".ln_2.")]


def turbo_flat(t3_tree: dict, s3_tree: dict, ve_tree: dict) -> dict:
    """A port Turbo T3 tree (fp or group-affine), a JAX-layout S3Gen numpy
    tree and a voice-encoder tree → the flat dict of an mlx-community
    Chatterbox Turbo checkpoint: the GPT-2 stack under t3.tfmr.h.N (q, k
    and v fused into c_attn; fp weights in HF Conv1D's (in, out), packed
    words in the Linear (out, in)), ln_f and the position table under
    t3.tfmr.ln_f and t3.tfmr.wpe, T3's other leaves under t3.*, then S3Gen
    and the voice encoder as `chatterbox_flat` writes them."""
    from tpu_audio_torch.utils import pytree

    layers = t3_tree["tfmr"]["layers"]
    attn = {k: v for k, v in layers["attn"].items() if k not in "qkv"}
    qkv = [layers["attn"][n] for n in "qkv"]
    attn["c_attn"] = {k: torch.cat([d[k] for d in qkv], dim=1) for k in qkv[0]}
    stacked = {"h." + k: v for k, v in pytree.flatten(dict(layers, attn=attn)).items()}
    out = {}
    for k, v in packed_weights(unstacked(stacked, "h", "h")).items():
        if k.endswith(".weight") and isinstance(v, torch.Tensor) and v.dim() == 2:
            v = v.T.contiguous()  # HF Conv1D (in, out)
        out["t3.tfmr." + renamed(k, GPT2_HF_NAMES)] = v
    rest = {"ln_f": t3_tree["tfmr"]["norm"], "wpe": t3_tree["wpe"]}
    out.update({"t3.tfmr." + k: v for k, v in packed_weights(pytree.flatten(rest)).items()})
    out.update({"t3." + k: v for k, v in packed_weights(pytree.flatten(
        {n: t3_tree[n] for n in t3_tree if n not in ("tfmr", "wpe")})).items()})
    out.update(s3gen_torch_flat(s3_tree, "s3gen."))
    out.update({"ve." + k: v for k, v in pytree.flatten(ve_tree).items()})
    return out


def s3tokenizer_mlx_flat(tree: dict) -> dict:
    """A JAX-layout S3 tokenizer numpy tree → an mlx-community file's flat
    dict: 3-D kernels as MLX's (O, K, I)."""
    from tpu_audio_torch.utils import pytree

    return {k: np.ascontiguousarray(np.asarray(v).transpose(2, 0, 1) if np.ndim(v) == 3
                                    else np.asarray(v))
            for k, v in pytree.flatten(tree).items()}


def kokoro_jax_layout(tree: dict) -> dict:
    """The port's Kokoro tree → the JAX layout, flat: the inverse of
    `kokoro_perm` on every leaf."""
    from tpu_audio_torch.models.kokoro.model import kokoro_perm
    from tpu_audio_torch.utils import pytree

    out = {}
    for k, v in pytree.flatten(tree).items():
        perm = kokoro_perm(k, v.dim())
        out[k] = v if perm is None else v.permute(*np.argsort(perm).tolist()).contiguous()
    return out


def kokoro_mlx_flat(jax_flat: dict) -> dict:
    """Kokoro's flat JAX-layout leaves → mlx-community/Kokoro-82M's keys and
    layouts (the inverse of the loader's remaps): predictor.text_encoder
    .lstm{i} / norm{i} → lstms.{2i} / .{2i+1}, text_encoder.cnn.N.conv /
    norm → .0 / .1 (the norms as gamma / beta), duration_proj →
    duration_proj.linear_layer, the LSTMs' fwd / bwd → weight_ih_l0 and
    the rest, a convolution (K, I, O) → MLX's (O, K, I) and a transposed one
    (ups, pool) → (I, K, O), the Snake alphas (1, 1, C) → (C, 1, 1) as the
    loader reads them back; plus ALBERT's position_ids, which the loader
    drops."""
    lstm_names = {"wx": "weight_ih_l0", "wh": "weight_hh_l0", "bias_ih": "bias_ih_l0",
                  "bias_hh": "bias_hh_l0"}
    out = {"bert.embeddings.position_ids": np.arange(512, dtype=np.int64)[None]}
    for k, v in jax_flat.items():
        src = k
        m = re.match(r"^(predictor\.text_encoder)\.(lstm|norm)(\d)\.(.+)$", src)
        if m:
            idx = int(m.group(3)) * 2 + (0 if m.group(2) == "lstm" else 1)
            src = f"{m.group(1)}.lstms.{idx}.{m.group(4)}"
        m = re.match(r"^(text_encoder\.cnn\.\d+)\.(conv|norm)\.(.+)$", src)
        if m:
            tail = m.group(3)
            if m.group(2) == "norm":
                tail = tail.replace("weight", "gamma").replace("bias", "beta")
            src = f"{m.group(1)}.{'0' if m.group(2) == 'conv' else '1'}.{tail}"
        src = src.replace("predictor.duration_proj.", "predictor.duration_proj.linear_layer.")
        m = re.match(r"^(.*)\.(fwd|bwd)\.(wx|wh|bias_ih|bias_hh)$", src)
        if m:
            src = (f"{m.group(1)}.{lstm_names[m.group(3)]}"
                   + ("_reverse" if m.group(2) == "bwd" else ""))
        if v.dim() == 3:  # the Snake alphas too: the loader reads every 3-D leaf as a conv
            v = v.permute(1, 0, 2) if re.search(r"\.(ups|pool)\.", k) else v.permute(2, 0, 1)
        out[src] = v.contiguous()
    return out



def seed_cache(root: Path, repo_id: str, files: dict) -> tuple[Path, int]:
    """A Hugging Face cache entry for repo_id under root (refs/main and
    snapshots/<revision>/), files = {name: writer(path) → bytes}; returns
    (the snapshot directory, the bytes written)."""
    from tpu_audio_torch.utils.hub import repo_cache_dir

    repo_dir = Path(repo_cache_dir(repo_id, str(root)))
    rev = "0" * 40
    snap = repo_dir / "snapshots" / rev
    snap.mkdir(parents=True)
    (repo_dir / "refs").mkdir()
    (repo_dir / "refs" / "main").write_text(rev)
    return snap, sum(write(snap / name) for name, write in files.items())


def write_text(text: str):
    def write(path):
        path.write_text(text)
        return len(text.encode())
    return write


def tiktoken_text(n_ranks: int) -> str:
    """A rank table of n_ranks tokens in the tiktoken format: the 256 bytes,
    then byte pairs in order."""
    import base64

    pieces = [bytes([b]) for b in range(256)]
    pieces += [bytes([a, b]) for a in range(256) for b in range(256)][:n_ranks - 256]
    return "".join(f"{base64.b64encode(p).decode()} {r}\n" for r, p in enumerate(pieces))


def tokenizer_json(pattern: str, added: dict, words: list[str], *, nfc: bool,
                   ignore_merges: bool) -> str:
    """A byte-level BPE tokenizer.json: the 256 byte characters, the merges
    that build each of `words` left to right, and `added` {content: id} as
    special added tokens."""
    from tpu_audio_torch.utils.tokenizer import bytes_to_unicode

    table = bytes_to_unicode()
    vocab = {table[b]: b for b in range(256)}
    merges = []
    for w in words:
        chars = [table[b] for b in w.encode()]
        cur = chars[0]
        for c in chars[1:]:
            if cur + c not in vocab:
                vocab[cur + c] = len(vocab)
                merges.append([cur, c])
            cur += c
    return json.dumps({
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": c, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for c, i in added.items()],
        "normalizer": {"type": "NFC"} if nfc else None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": pattern}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": ignore_merges,
                  "vocab": vocab, "merges": merges}})


def hf_config(cfg, model_type: str, **extra) -> dict:
    """The HF config.json of a TransformerConfig (llama / qwen3), as
    `load_llama.config_from_hf` reads it back."""
    return {"model_type": model_type, "hidden_size": cfg.dim, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.kv_heads,
            "head_dim": cfg.hd, "intermediate_size": cfg.hidden_dim,
            "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
            "rope_scaling": cfg.rope_scaling, "rms_norm_eps": cfg.norm_eps,
            "tie_word_embeddings": cfg.tie_word_embeddings,
            "max_position_embeddings": cfg.max_position_embeddings, **extra}


def card_params(schema: dict, dev, seed: int, dtype=torch.bfloat16) -> dict:
    """A model's `numpy_params` schema (from a ShapeRNG) filled on the card:
    each drawn leaf uniform in ±1/√(its last dim), the norms as the schema
    has them; converted to the port's layout in `dtype`. A full-width tree
    in a second, with nothing drawn on the host."""
    from tpu_audio_torch.convert import params_from_numpy
    from tpu_audio_torch.utils import pytree, weights

    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = {}
    for k, v in pytree.flatten(schema).items():
        if isinstance(v, weights.AbstractLeaf):
            flat[k] = ((torch.rand(v.shape, generator=gen, device=dev) * 2 - 1)
                       / math.sqrt(v.shape[-1])).to(dtype)
        else:
            flat[k] = torch.as_tensor(v, device=dev)
    return params_from_numpy(pytree.unflatten(flat), dev, dtype)


def held_tree(name: str, got: dict, ref: dict) -> None:
    """Two parameter trees equal key for key and bit for bit."""
    from tpu_audio_torch.utils import pytree

    g, r = pytree.flatten(got), pytree.flatten(ref)
    if set(g) != set(r):
        raise AssertionError(f"{name}: keys differ: {sorted(set(g) ^ set(r))[:8]}")
    bad = [k for k in r if g[k].dtype != r[k].dtype or g[k].shape != r[k].shape
           or not torch.equal(g[k], r[k])]
    if bad:
        raise AssertionError(f"{name}: {len(bad)} leaves differ, e.g. {bad[:5]}")
    log(f"{name}: {len(r)} leaves equal bit for bit")


def module_params(model) -> dict:
    from tpu_audio_torch.utils import pytree

    return pytree.unflatten({k: v.data for k, v in model.named_parameters()})


def check_tokenizer_golden() -> int:
    """Phase 11 (d): the texts of tests/data/tokenizer_golden/ re-encoded by
    the tokenizer.json reader and the Whisper BPE with `regex` blocked; the
    ids must equal the committed ones (those of `tokenizers` and of the JAX
    package). Returns the number of texts checked."""
    from tpu_audio_torch.utils.tokenizer import HFTokenizer

    gold_dir = ROOT / "tests" / "data" / "tokenizer_golden"
    golden = json.loads((gold_dir / "golden.json").read_text())
    saved = sys.modules.get("regex")
    sys.modules["regex"] = None  # the card's Python has no regex: hold that path
    try:
        from tpu_audio_torch.models.whisper.tokenizer import BPE, WhisperTokenizer

        toks = {name: HFTokenizer(str(gold_dir / f"{name}.json"))
                for name in ("llama3", "qwen2", "gpt2")}
        toks["whisper"] = WhisperTokenizer(
            BPE.from_tiktoken_file(str(gold_dir / "whisper.tiktoken")), True, 100)
        n = 0
        for name, tok in toks.items():
            for text, ids in zip(golden["texts"], golden["ids"][name]):
                if tok.encode(text) != ids:
                    raise AssertionError(f"tokenizer {name}: {text!r} -> {tok.encode(text)}, "
                                         f"golden {ids}")
                n += 1
    finally:
        if saved is None:
            del sys.modules["regex"]
        else:
            sys.modules["regex"] = saved
    return n


def load_slice(dev, card: str) -> dict:
    """Phase 11: checkpoints in the published layouts written at full width
    from seed-0 random weights into a temporary directory, each served through
    its engine's `load()` and held against `from_params`/`from_pipeline` on
    the same trees; audio files in and out; the tokenizer readers against the
    golden ids. Returns the launch counts of the loaded engines' runs."""
    import tempfile

    from tpu_audio_torch.api.stt import STT, WhisperEngine
    from tpu_audio_torch.api.tts import TTS
    from tpu_audio_torch.codecs.snac import model as snac
    from tpu_audio_torch.models.funasr import model as fmodel
    from tpu_audio_torch.models.orpheus import model as om
    from tpu_audio_torch.models.orpheus.engine import LLM_REPO, SNAC_REPO
    from tpu_audio_torch.models.whisper import load as wload
    from tpu_audio_torch.models.whisper import model as wmodel
    from tpu_audio_torch.models.whisper.config import PRESETS
    from tpu_audio_torch.models.whisper.pipeline import WhisperPipeline
    from tpu_audio_torch.nn import transformer
    from tpu_audio_torch.ops import quant
    from tpu_audio_torch.ops.kernels import cross_kv_attention as ckv
    from tpu_audio_torch.ops.kernels import fused_encoder_int8 as fe8
    from tpu_audio_torch.ops.kernels import fused_mel
    from tpu_audio_torch.ops.kernels import fused_step as fs
    from tpu_audio_torch.ops.kernels import fused_whisper_step as fws
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
    from tpu_audio_torch.ops.kernels import quant_matmul as qmm
    from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm
    from tpu_audio_torch.ops.resample import resample
    from tpu_audio_torch.utils import audio_io, weights

    mods = (fused_mel, fe8, ckv, fws, i8mm, qmm, fs, w4mm)
    total = {n: 0 for m in mods for n in m.LAUNCHES}
    rng = np.random.default_rng(SEED + 11)

    def run(label, fn, need):
        """fn() on the loaded engine, its launches counted and required."""
        reset(*mods)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        launches = launch_counts(*mods)
        missing = [n for n in need if not launches[n]]
        log(f"load {label} launches: { {n: c for n, c in launches.items() if c} }")
        if missing:
            raise AssertionError(f"load {label}: {missing} never launched: {launches}")
        for n, c in launches.items():
            total[n] += c
        return out

    old_cache = os.environ.get("TPU_AUDIO_CACHE")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_load_") as tmp:
        hub = Path(tmp) / "hub"
        os.environ["TPU_AUDIO_CACHE"] = str(hub)
        try:
            # (a) Whisper large-v3-turbo, mlx-community 8-bit layout
            cfg = PRESETS["large-v3-turbo"]
            q8 = bf16_affine(quant.quantize_tree(card_params(
                wmodel.numpy_params(weights.ShapeRNG(), cfg), dev, SEED), bits=8))
            mlx_cfg = {"model_type": "whisper", **{k: getattr(cfg, k) for k in (
                "n_mels", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
                "n_vocab", "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer")},
                "quantization": {"group_size": 64, "bits": 8}}
            wdir = Path(tmp) / "whisper-large-v3-turbo-8bit"
            wdir.mkdir()
            nbytes, wall = timed(lambda: sum((
                write_safetensors(wdir / "model.safetensors", whisper_mlx_flat(q8, cfg),
                                  {"format": "mlx"}),
                write_text(json.dumps(mlx_cfg))(wdir / "config.json"),
                write_text(tiktoken_text(50257))(wdir / "multilingual.tiktoken"))))
            log(f"load whisper: wrote {nbytes} bytes (mlx 8-bit large-v3-turbo, "
                f"50257 ranks) in {wall:.2f} s ({card})")
            engine = STT.whisper("large-v3-turbo", "w8a8", repo=str(wdir))
            _, wall = timed(engine.load)
            log(f"load whisper: STT.whisper(large-v3-turbo, w8a8).load() {wall:.2f} s "
                f"({card})")
            model = engine.pipeline.model
            ref_tree = wload.serve_tree_int8(q8)
            del q8
            held_tree("load whisper w8a8 tree against serve_tree_int8 of the q8 tree",
                      module_params(model), ref_tree)
            tok = engine.pipeline.tok
            if (tok.eot, tok.sot, tok.timestamp_begin) != (50257, 50258, 50365):
                raise AssertionError(f"whisper special ids {tok.eot}, {tok.sot}, "
                                     f"{tok.timestamp_begin}")
            ref = WhisperEngine.from_pipeline(WhisperPipeline(
                wmodel.Whisper(cfg, ref_tree), tok, compute_dtype=torch.bfloat16,
                kv_int8=True))
            clips = [(rng.standard_normal(LOAD_CLIP_SECONDS * 16000) * 0.1).astype(np.float32)
                     for _ in range(2)]

            def tokens(res):
                return [t for s in res.segments for t in s.tokens]

            got = run("whisper transcribe", lambda: engine.transcribe(
                clips[0], language="en", temperature=(0.0,)),
                ("fused_log_mel", *fe8.LAUNCHES, "fused_whisper_decode_step", "int8_matmul"))
            want = ref.transcribe(clips[0], language="en", temperature=(0.0,))
            if tokens(got) != tokens(want):
                raise AssertionError(f"whisper transcribe: load {tokens(got)[:20]}, "
                                     f"from_pipeline {tokens(want)[:20]}")
            (_, res_b) = run("whisper transcribe_batch", lambda: engine.transcribe_batch(
                clips, batch_size=2, language="en", kv_int8=True, return_results=True),
                ("cross_attention_decode", "int8_matmul_stacked"))
            _, ref_b = ref.transcribe_batch(clips, batch_size=2, language="en",
                                            kv_int8=True, return_results=True)
            if [r.tokens for r in res_b] != [r.tokens for r in ref_b]:
                raise AssertionError("whisper transcribe_batch: load and from_pipeline differ")
            wav = Path(tmp) / "clip_44k.wav"
            audio_io.write_wav(str(wav), resample(clips[0], 16000, 44100), 44100)
            by_path = run("whisper transcribe(path)", lambda: engine.transcribe(
                str(wav), language="en", temperature=(0.0,)), ("fused_log_mel",))
            by_array = engine.transcribe(audio_io.load_audio(str(wav), 16000)[0],
                                         language="en", temperature=(0.0,))
            if tokens(by_path) != tokens(by_array):
                raise AssertionError("whisper: a WAV path and load_audio's array differ")
            log(f"load whisper: transcribe of {LOAD_CLIP_SECONDS} s ({len(tokens(got))} "
                f"tokens) and transcribe_batch of 2 clips equal from_pipeline's; the 44.1 kHz "
                f"WAV by path equals load_audio's array ({len(tokens(by_path))} tokens)")
            del engine, ref, model, ref_tree
            torch.cuda.empty_cache()

            # (b) Fun-ASR-Nano, mlx-community 4-bit layout, pre-seeded cache
            fcfg = fmodel.FunASRConfig()
            params = card_params(fmodel._numpy_params(weights.ShapeRNG(), fcfg), dev, SEED)
            params["llm"] = bf16_affine(quant.quantize_tree(params["llm"], bits=4))
            flat = funasr_flat(params)
            added = {"<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645,
                     "<|startofspeech|>": 151646, "<|endofspeech|>": 151647}
            tok_json = tokenizer_json(QWEN2_PAT, added, ["speech", " recognition", " the",
                                                         "assistant", "system", "user"],
                                      nfc=True, ignore_merges=False)
            (_, nbytes), wall = timed(lambda: seed_cache(hub, "mlx-community/Fun-ASR-Nano-4bit", {
                "model.safetensors": lambda p: write_safetensors(p, flat, {"format": "mlx"}),
                "config.json": write_text(json.dumps({"llm_config": hf_config(fcfg.llm, "qwen3")})),
                "tokenizer.json": write_text(tok_json)}))
            del flat
            log(f"load funasr: wrote {nbytes} bytes (mlx 4-bit Fun-ASR-Nano into the "
                f"pre-seeded cache) in {wall:.2f} s ({card})")
            engine = STT.funasr()
            _, wall = timed(engine.load)
            log(f"load funasr: STT.funasr().load() {wall:.2f} s ({card})")
            if engine.cfg.llm != fcfg.llm or engine._eos_ids != (151643, 151645):
                raise AssertionError(f"funasr load: config {engine.cfg.llm} or eos "
                                     f"{engine._eos_ids}")
            held_tree("load funasr tree against the written one", engine.generator.params,
                      dict(params, llm=transformer.fuse_fp_tree(params["llm"])))
            ref = STT.funasr().from_params(params, fcfg, tokenizer=engine.tokenizer)
            clip = (rng.standard_normal(LOAD_CLIP_SECONDS * 16000) * 0.1).astype(np.float32)
            got = run("funasr transcribe", lambda: engine.generator.generate(
                *_funasr_prompt(engine, clip), eos_ids=engine._eos_ids, max_new=LOAD_FUNASR_NEW,
                sampler=_greedy()), ("quant_matmul",))
            want = ref.generator.generate(*_funasr_prompt(ref, clip), eos_ids=ref._eos_ids,
                                          max_new=LOAD_FUNASR_NEW, sampler=_greedy())
            text = engine.transcribe(clip, max_new_tokens=LOAD_FUNASR_NEW).text
            if got != want or not isinstance(text, str):
                raise AssertionError(f"funasr: load {got} != from_params {want}")
            log(f"load funasr: {len(got)} tokens equal from_params's; eos ids "
                f"{engine._eos_ids}")
            del engine, ref, params
            torch.cuda.empty_cache()

            # (c) Orpheus: Llama-3.2-3B mlx 4-bit + SNAC, pre-seeded cache
            q4 = bf16_affine(quant.quantize_tree(llama_params(om.LLAMA_3B, dev, SEED), bits=4))
            snac_cfg = snac.SNACConfig()
            snac_params = snac.init_params(SEED, snac_cfg, torch.float32, dev)
            added = {"<|begin_of_text|>": 128000, "<|end_of_text|>": 128001,
                     "<|eot_id|>": 128009}
            tok_json = tokenizer_json(LLAMA3_PAT, added, ["tara", " the", " voice", "Hello"],
                                      nfc=False, ignore_merges=True)
            llama = hf_config(om.LLAMA_3B, "llama",
                              quantization={"group_size": 64, "bits": 4})
            (_, n_lm), w_lm = timed(lambda: seed_cache(hub, LLM_REPO, {
                "model.safetensors": lambda p: write_safetensors(p, llama_flat(q4),
                                                                 {"format": "mlx"}),
                "config.json": write_text(json.dumps(llama)),
                "tokenizer.json": write_text(tok_json)}))
            (_, n_snac), w_snac = timed(lambda: seed_cache(hub, SNAC_REPO, {
                "model.safetensors": lambda p: write_safetensors(p, snac_torch_flat(snac_params)),
                "config.json": write_text(json.dumps({
                    "sampling_rate": snac_cfg.sampling_rate,
                    "encoder_dim": snac_cfg.latent_dim // 16, "encoder_rates": [2, 4, 8, 8],
                    "decoder_dim": snac_cfg.decoder_dim,
                    "decoder_rates": list(snac_cfg.decoder_rates), "attn_window_size": None,
                    "codebook_size": snac_cfg.codebook_size,
                    "codebook_dim": snac_cfg.codebook_dim, "vq_strides": list(snac_cfg.vq_strides),
                    "noise": snac_cfg.noise, "depthwise": snac_cfg.depthwise}))}))
            log(f"load orpheus: wrote {n_lm} bytes (mlx 4-bit Llama-3.2-3B) in {w_lm:.2f} s "
                f"and {n_snac} bytes (SNAC 24 kHz) in {w_snac:.2f} s ({card})")
            for quantization, serve, need in (
                    ("w8a8", quant.requantize_tree_int8, ("fused_decode_step",)),
                    ("w4a8", quant.repack_tree_w4a8, ("w4a8_matmul", "w4a8_matmul_stacked"))):
                engine = TTS.orpheus(quantization=quantization)
                _, wall = timed(engine.load)
                log(f"load orpheus: TTS.orpheus(quantization={quantization}).load() "
                    f"{wall:.2f} s ({card})")
                if engine.lm.cfg != om.LLAMA_3B:
                    raise AssertionError(f"orpheus load: config {engine.lm.cfg}")
                held_tree("load orpheus snac against the written one", engine.snac_params,
                          snac_params)
                ref = TTS.orpheus().from_params(serve(q4), om.LLAMA_3B, snac_params, snac_cfg)
                held_tree(f"load orpheus {quantization} LM tree against from_params's",
                          engine.lm.params, ref.lm.params)
                prompt = engine._prompt("Hello from the card!")
                got = run(f"orpheus {quantization} generate", lambda: engine.lm.generate(
                    prompt, sampler=_greedy(), eos_ids=(), max_new=LOAD_ORPHEUS_NEW), need)
                want = ref.lm.generate(prompt, sampler=_greedy(), eos_ids=(),
                                       max_new=LOAD_ORPHEUS_NEW)
                if got != want or len(got) != LOAD_ORPHEUS_NEW:
                    raise AssertionError(f"orpheus {quantization}: load {got[:10]} != "
                                         f"from_params {want[:10]}")
                log(f"load orpheus {quantization}: {len(got)} greedy tokens equal "
                    f"from_params's on the same served tree")
                del ref
                if quantization == "w8a8":
                    save_check(engine, Path(tmp), rng)
                del engine
                torch.cuda.empty_cache()
            del q4

            # (d) Chatterbox and Chatterbox Turbo, mlx-community 4-bit layouts
            chatterbox_loads(hub, dev, card, run)
            # (e) Kokoro, mlx-community/Kokoro-82M-bf16's layout, and a voice pack
            kokoro_loads(hub, dev, card)
        finally:
            if old_cache is None:
                os.environ.pop("TPU_AUDIO_CACHE", None)
            else:
                os.environ["TPU_AUDIO_CACHE"] = old_cache

    # (f) the tokenizer readers on this Python, without regex
    n = check_tokenizer_golden()
    log(f"load tokenizers: {n} golden encodings equal (tokenizer.json reader on llama3, "
        f"qwen2, gpt2 and the Whisper BPE, regex blocked)")
    return total


def chatterbox_loads(hub: Path, dev, card: str, run) -> None:
    """Phase 11 (d): Chatterbox and Chatterbox Turbo 4-bit checkpoints at
    full width (`chatterbox_trees`' q4 T3s, S3Gen and Turbo's meanflow
    S3Gen, the voice encoder, with a `tokenizer.json` each; S3TokenizerV2)
    written by `chatterbox_flat` / `turbo_flat` into the pre-seeded cache,
    read by `TTS.chatterbox("4bit").load()` and
    `TTS.chatterbox_turbo("4bit").load()`: every tree against the written
    one bit for bit, and LOAD_T3_NEW greedy T3 tokens against
    `from_params` / `from_turbo_params` on the written trees."""
    import dataclasses

    from tpu_audio_torch.api.tts import TTS
    from tpu_audio_torch.codecs.s3gen import model as s3gen
    from tpu_audio_torch.codecs.s3tokenizer import model as s3tok
    from tpu_audio_torch.models.chatterbox import load as cload
    from tpu_audio_torch.models.chatterbox import t3
    from tpu_audio_torch.models.chatterbox import voice_encoder as ve
    from tpu_audio_torch.models.chatterbox_turbo import load as tload
    from tpu_audio_torch.models.chatterbox_turbo import model as turbo
    from tpu_audio_torch.utils import pytree
    from tpu_audio_torch.utils.weights import ShapeRNG

    trees = chatterbox_trees(dev, bits=(4,))
    s3cfg, tokcfg, vecfg = s3gen.S3GenConfig(), s3tok.S3TokenizerConfig(), ve.VoiceEncConfig()
    s3tcfg = dataclasses.replace(s3cfg, estimator=dataclasses.replace(s3cfg.estimator,
                                                                      meanflow=True))
    s3s = {"chatterbox": s3_card_params(s3gen.numpy_params(ShapeRNG(), s3cfg), dev, SEED + 1),
           "turbo": s3_card_params(s3gen.numpy_params(ShapeRNG(), s3tcfg), dev, SEED + 6)}
    tokp = s3_card_params(s3tok.numpy_params(ShapeRNG(), tokcfg), dev, SEED + 2)
    vep = card_params(ve.numpy_params(ShapeRNG(), vecfg), dev, SEED + 3)
    tok_np = pytree.unflatten({k: v.float().cpu().numpy()
                               for k, v in pytree.flatten(s3_jax_layout(tokp)).items()})
    seed_cache(hub, cload.S3TOK_REPO, {"model.safetensors": lambda p: write_safetensors(
        p, s3tokenizer_mlx_flat(tok_np))})
    tok_json = tokenizer_json(LLAMA3_PAT, {}, ["the", " voice", " card", "Hello"], nfc=False,
                              ignore_merges=False)
    for name, repo, write, factory in (
            ("chatterbox", cload.REPOS["4bit"], chatterbox_flat, TTS.chatterbox),
            ("turbo", tload.REPOS["4bit"], turbo_flat, TTS.chatterbox_turbo)):
        q4, s3 = trees[name]["q4"], s3s[name]
        (_, nbytes), wall = timed(lambda: seed_cache(hub, repo, {
            "model.safetensors": lambda p: write_safetensors(
                p, write(q4, s3_jax_layout(s3), vep), {"format": "mlx"}),
            "tokenizer.json": write_text(tok_json)}))
        log(f"load {name}: wrote {nbytes} bytes (mlx 4-bit, full width) in {wall:.2f} s ({card})")
        engine = factory("4bit")
        _, wall = timed(engine.load)
        log(f"load {name}: TTS.{'chatterbox' if name == 'chatterbox' else 'chatterbox_turbo'}"
            f"(\"4bit\").load() {wall:.2f} s ({card})")
        gen = engine.t3_gen if name == "chatterbox" else engine.turbo_gen
        held_tree(f"load {name} T3 tree against the written one", gen.params, q4)
        held_tree(f"load {name} S3Gen tree against the written one", engine.s3gen_params, s3)
        held_tree(f"load {name} voice encoder against the written one", engine.ve_params, vep)
        held_tree(f"load {name} S3 tokenizer against the written one", engine.tok_params, tokp)
        ids = engine.tokenizer.encode("Hello the card")
        if name == "chatterbox":
            cfg = t3.T3Config()
            zero_spk = torch.zeros((1, cfg.speaker_embed_size), device=dev)
            ref = t3.T3Generator(q4, cfg)
            cond = t3.prepare_conditioning(q4, cfg, zero_spk, None, 0.5)
            greedy = t3.T3SamplerConfig(temperature=0.0)
            ids = [cfg.start_text_token] + ids + [cfg.stop_text_token]
        else:
            cfg = turbo.T3TurboConfig()
            ref = turbo.T3TurboGenerator(q4, cfg)
            cond = torch.zeros((1, cfg.speaker_embed_size), device=dev)
            greedy = turbo.TurboSampler(temperature=0.0)
        got = run(f"{name} generate", lambda: gen.generate(cond, ids, sampler=greedy,
                                                           max_new=LOAD_T3_NEW),
                  ("quant_matmul",))
        want = ref.generate(cond, ids, sampler=greedy, max_new=LOAD_T3_NEW)
        if got != want or not got:
            raise AssertionError(f"{name}: load {got[:10]} != from_params {want[:10]}")
        log(f"load {name}: {len(got)} greedy T3 tokens equal those of the written tree")
        del engine, ref, gen
        torch.cuda.empty_cache()


def kokoro_loads(hub: Path, dev, card: str) -> None:
    """Phase 11 (e): Kokoro at full width (`kokoro_params` of seed 18,
    rounded to bf16 as the published file stores it) written in the
    mlx-community/Kokoro-82M-bf16 layout (`kokoro_mlx_flat`) with a
    voices/af_heart.safetensors into the pre-seeded cache, read by
    `TTS.kokoro().load()`: the tree against the written one bit for bit,
    the voice pack equal, and the audio of one sentence against
    `from_params` on the written tree."""
    from tpu_audio_torch.api.tts import TTS
    from tpu_audio_torch.models.kokoro import load as kload
    from tpu_audio_torch.models.kokoro.config import KokoroConfig
    from tpu_audio_torch.models.kokoro.voices import random_voice
    from tpu_audio_torch.utils import pytree

    params = pytree.unflatten({k: v.bfloat16().float() for k, v in
                               pytree.flatten(kokoro_params(dev, SEED + 18)).items()})
    flat = {k: v.bfloat16() if isinstance(v, torch.Tensor) else v
            for k, v in kokoro_mlx_flat(kokoro_jax_layout(params)).items()}
    voice = random_voice(SEED + 18)

    def write_voice(path):
        path.parent.mkdir(exist_ok=True)
        return write_safetensors(path, {"af_heart": voice})
    (_, nbytes), wall = timed(lambda: seed_cache(hub, kload.REPO, {
        kload.WEIGHTS_FILE: lambda p: write_safetensors(p, flat),
        "voices/af_heart.safetensors": write_voice}))
    del flat
    log(f"load kokoro: wrote {nbytes} bytes (bf16, the mlx layout, full width, and a voice "
        f"pack) in {wall:.2f} s ({card})")
    engine = TTS.kokoro()
    _, wall = timed(engine.load)
    log(f"load kokoro: TTS.kokoro().load() {wall:.2f} s ({card})")
    held_tree("load kokoro tree against the written one", engine.synth.params, params)
    if not np.array_equal(engine._voice_pack(), voice):
        raise AssertionError("load kokoro: the voice pack differs from the written one")
    ref = TTS.kokoro().from_params(params, KokoroConfig(), voice)
    got = engine.generate(LOAD_KOKORO_TEXT).samples
    want = ref.generate(LOAD_KOKORO_TEXT).samples
    err = float(np.abs(got - want).max()) if len(got) == len(want) else math.inf
    if not (len(want) and err <= 1e-5 * float(np.abs(want).max())):
        raise AssertionError(f"load kokoro: {len(got)} samples against from_params's "
                             f"{len(want)}, max |Δ| {err}")
    log(f"load kokoro: {len(got)} samples against from_params's on the written tree, max |Δ| "
        f"{err:.3e} (the voice pack equal, phonemizer {engine.phonemizer.kind})")
    del engine, ref
    torch.cuda.empty_cache()


def save_check(engine, tmp: Path, rng) -> None:
    """`TTSEngineBase.save` (generate, then `AudioResult.save`) of a short
    text, and `AudioResult.save` of SNAC audio of given frames read back by
    `read_wav`: the int16 file holds each sample truncated to its step, so
    it reads back within one step plus the 32767/32768 scale gap."""
    from tpu_audio_torch.api.results import AudioResult
    from tpu_audio_torch.models.orpheus.model import parse_frames
    from tpu_audio_torch.utils import audio_io

    path = engine.save("Hi.", str(tmp / "orpheus_generate.wav"),
                       max_new_tokens=LOAD_ORPHEUS_NEW)
    back, rate = audio_io.read_wav(path)
    if rate != engine.sample_rate:
        raise AssertionError(f"orpheus save: {rate} Hz")
    samples = engine._decode_snac(parse_frames(frame_tokens(rng, 8)))
    path = AudioResult(samples=samples, sample_rate=engine.sample_rate).save(
        str(tmp / "orpheus_frames.wav"))
    back, rate = audio_io.read_wav(path)
    err = float(np.abs(back - samples).max())
    limit = (1 + float(np.abs(samples).max())) / 32768
    if rate != engine.sample_rate or len(back) != len(samples) or not len(back) or err > limit:
        raise AssertionError(f"orpheus AudioResult.save: {rate} Hz, {len(back)} of "
                             f"{len(samples)} samples, |err| {err} > {limit}")
    log(f"load orpheus: AudioResult.save wrote {len(back)} samples at {rate} Hz, read back "
        f"within {err:.3e} (limit {limit:.3e}: one int16 step 2^-15 and the scale gap)")


def _greedy():
    from tpu_audio_torch.ops.sampling import SamplerConfig

    return SamplerConfig(temperature=0.0)


def _funasr_prompt(engine, clip):
    """(pre ids, post ids, features) of a Fun-ASR transcribe of `clip`."""
    from tpu_audio_torch.api.stt_funasr import build_prompt_text
    from tpu_audio_torch.ops import frontends

    feats = frontends.funasr_features(torch.as_tensor(clip, device=engine.generator.device))
    pre, post = build_prompt_text()
    return engine.tokenizer.encode(pre), engine.tokenizer.encode(post), feats


# ------------------------------------------------ 12. OuteTTS + DAC, 13. Marvis + Mimi

def counted_run(tag: str, mods, total: dict, label: str, need, fn, absent=()):
    """fn() with the launch counters of `mods` reset first: (its result, the
    launches, the wall). Raises if a kernel of `need` never launched or one
    of `absent` did; adds the launches into `total`."""
    reset(*mods)
    out, wall = timed(fn)
    launches = launch_counts(*mods)
    log(f"{tag} {label}: {wall:.3f} s wall, launches {launches}")
    if not all(launches[n] for n in need) or any(launches[n] for n in absent):
        raise AssertionError(f"{tag} {label}: a kernel of the path never launched, or one of "
                             f"{absent} did: {launches}")
    for n in total:
        total[n] += launches[n]
    return out, launches, wall


def step_counter(gen) -> dict:
    """Count the decode steps `gen` (a CausalLMGenerator) runs: {"n": …}."""
    steps = {"n": 0}
    make = gen._step

    def counted(extra, off):
        step = make(extra, off)

        def run(tok, cache):
            steps["n"] += 1
            return step(tok, cache)
        return run

    gen._step = counted
    return steps


def sharpened(params: dict, cfg, factor: float) -> dict:
    """The stack with the q and k rows of its fused qkv leaf × factor (the
    fp rows, the int8 rows' scales, or the W4A8 rows' group scales and
    biases), so that q·k grows by factor² and
    attention is peaked: random weights leave it nearly uniform, and then
    a fault of the positions (RoPE) barely moves the logits."""
    qkv = params["layers"]["attn"]["qkv"]
    rows = (cfg.n_heads + cfg.kv_heads) * cfg.hd
    new = {}
    for name in ("weight", "scale_i8", "scales", "biases"):  # fp, int8, W4A8 (w = q·s + b)
        if name in qkv:
            leaf = qkv[name].clone()
            leaf[:, :rows] = leaf[:, :rows] * factor
            new[name] = leaf
    if "weight_i8" in qkv:
        # a new weight tensor too: the whole-stack step keeps a tree's
        # scales by the identity of its qkv weight (`fused_step.prepare_stack`)
        new["weight_i8"] = qkv["weight_i8"].clone()
    attn = dict(params["layers"]["attn"], qkv=dict(qkv, **new))
    return dict(params, layers=dict(params["layers"], attn=attn))


def oute_against_f32(tag: str, gen, prompts: list, dev, int8: bool, sharpen: bool) -> None:
    """Phase 12, the OuteTTS LM on the kernel route held against f32 through
    its logits: the prefill and OUTE_HELD_STEPS steps, each fed the f32
    path's greedy token. At B=1 (`generate`'s route: the 32-slot prompt
    bucket left-padded, one whole-stack step launch a token, the head's
    `int8_matmul` on the int8 tree) and, on the int8 tree, at
    B=len(prompts) (`generate_batch`'s per-layer route, every linear an
    `int8_matmul` of 4 rows). The route runs with the stack in its serving
    dtype and a bf16 cache, every other leaf in f32 (f32 activations); the
    reference is the per-op path with every leaf in f32, an f32 cache and
    the plain int8 products; the plain versions of the route are the
    yardstick (`held_against_f32`). Planted faults must land at least
    CV_FAULT_RATIO times as far from f32: the prompt's pad slots attended
    in the step, and on the int8 tree the last 64 input features dropped in
    `int8_matmul` (the head's, and at B=4 every linear's); with `sharpen`
    (the stack's q and k QK_SCALE times the random tree's, `sharpened`, so
    that attention depends on the positions; at B=1 only) RoPE turned
    backwards in the step. Peaked attention also grows the int8 route's own
    distance from f32, which would hide the other faults."""
    from tpu_audio_torch.nn import attention, transformer
    from tpu_audio_torch.ops.kernels import fused_step as fs
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm

    cfg, steps = gen.cfg, OUTE_HELD_STEPS
    fused = sharpened(gen.params, cfg, QK_SCALE) if sharpen else gen.params
    tree32 = f32_tree(fused)
    tree_k = dict(tree32, layers=fused["layers"])

    def decode(tree, cache, extra, off, tokens, forced):
        """Prefill `tokens` (B, T), then `steps` steps: the logits (1 + steps, B, V)."""
        lg, cache = transformer.forward(tree, cfg, tokens, cache, extra, pos_offset=off)
        out = [lg[:, -1].float()]
        for i in range(steps):
            tok = out[-1].argmax(-1) if forced is None else forced[i]
            lg, cache = transformer.forward(tree, cfg, tok[:, None], cache, extra, pos_offset=off)
            out.append(lg[:, -1].float())
        return torch.stack(out)

    prompt, start = gen._prompt(prompts[0], 32)
    if start == 0:
        raise AssertionError(f"{tag}: the held prompt fills its bucket; the pad fault is blind")

    def single(tree, route: bool, forced=None):
        with torch.inference_mode():
            cache, extra = transformer.decode_cache_and_mask(
                cfg, prompt.shape[0] + steps + 1, start, route,
                dtype=torch.bfloat16 if route else torch.float32, device=dev)
            return decode(tree, cache, extra, torch.tensor([start], device=dev), prompt[None],
                          forced)

    def batch(tree, route: bool, forced=None):
        b, pad = len(prompts), pad_b
        arr = torch.full((b, pad), gen.pad_id, dtype=torch.int64)
        for r, ids in enumerate(prompts):
            arr[r, pad - len(ids):] = torch.as_tensor(ids)
        off = torch.tensor([pad - len(p) for p in prompts], device=dev)
        slot = torch.arange(pad + steps + 1, device=dev)
        extra = torch.where(slot[None] >= off[:, None], 0.0,
                            attention.NEG_INF)[:, None, None, :]
        with torch.inference_mode():
            cache = transformer.make_cache(cfg, b, slot.shape[0],
                                           torch.bfloat16 if route else torch.float32,
                                           device=dev)
            return decode(tree, cache, extra, off, arr.to(dev), forced)

    step, head = fs.fused_decode_step, i8mm.int8_matmul

    def pads_attended(stack, x, pos, s0, *a, **kw):
        return step(stack, x, pos, torch.zeros_like(s0), *a, **kw)

    def rope_backwards(stack, x, pos, s0, cos, sin, *a, **kw):
        return step(stack, x, pos, s0, cos, -sin, *a, **kw)

    def k_tail_dropped(x, w, sc, bias=None, **kw):
        x = x.clone()
        x[..., -64:] = 0
        return head(x, w, sc, bias, **kw)

    step_faults = [("RoPE turned backwards in the step", fs, "fused_decode_step",
                    rope_backwards)] if sharpen else [
        ("the prompt's pad slots attended in the step", fs, "fused_decode_step",
         pads_attended)]
    int8_fault = [] if sharpen else [("the last 64 input features dropped in int8_matmul",
                                      i8mm, "int8_matmul", k_tail_dropped)]
    def int8_calls(rows: int, linears: int) -> int:  # int8_matmul(_stacked) launches
        return linears * (int8 and rows <= i8mm.MAX_ROWS)

    every = 4 * cfg.n_layers + 1  # a layer's qkv, o, gateup and down, and the head
    pad_b = -(-max(len(p) for p in prompts) // 32) * 32
    cases = [("B=1", single, steps, int8_calls(prompt.shape[0], every) + steps * int8,
              step_faults + (int8_fault if int8 else []))]
    if int8 and not sharpen:
        b = len(prompts)
        cases.append((f"B={b}", batch, 0, int8_calls(b * pad_b, every)
                      + steps * int8_calls(b, every), int8_fault))
    for label, run, n_fused, n_int8, faults in cases:
        with plain_kernels(fs, i8mm):
            exact = run(tree32, False)
            forced = exact[:-1].argmax(-1)
            plain = run(tree_k, True, forced)
        b = exact.shape[1]
        parts = [exact[:1].flatten(0, 1), exact[1:].flatten(0, 1)]
        outputs = (f"prefill logits ({b}, {cfg.vocab_size})",
                   f"step logits ({steps * b}, {cfg.vocab_size})")
        p_err, p_cos = zip(*[measure(pl, ex)[1:] for pl, ex in zip(
            (plain[:1].flatten(0, 1), plain[1:].flatten(0, 1)), parts)])
        log(f"{tag} {label} plain route against f32: " + ", ".join(
            f"{name.split(' (')[0]} rel {e:.3e} cosine {c:.6f}"
            for name, e, c in zip(outputs, p_err, p_cos)))
        reset(fs, i8mm)
        got = run(tree_k, True, forced)
        launches = launch_counts(fs, i8mm)
        n_got = (launches["fused_decode_step"],
                 launches["int8_matmul"] + launches["int8_matmul_stacked"])
        if n_got != (n_fused, n_int8):
            raise AssertionError(f"{tag} {label} held: launches {launches}, want "
                                 f"{n_fused} fused_decode_step, {n_int8} int8 matmuls")
        held_against_f32(f"{tag} {label}", outputs, parts, p_err, "kernels",
                         [got[:1].flatten(0, 1), got[1:].flatten(0, 1)], control=False,
                         p_cos=p_cos)
        for fault, mod, name, fn in faults:
            with patched(mod, name, fn):
                out = run(tree_k, True, forced)
            held_against_f32(f"{tag} {label}", outputs, parts, p_err, fault,
                             [out[:1].flatten(0, 1), out[1:].flatten(0, 1)], control=True,
                             p_cos=p_cos)


def oute_slice(dev, card: str) -> dict:
    """Phase 12: OuteTTS at full width on random weights (Llama-3.2-1B of
    `benchmarks/engines.py`, the published DAC) through `TTS.oute()` →
    `OuteTTSEngine.from_params`, unconditioned, on the w8a8 tree (the q4
    tree requantised: the whole-stack step at hd 64 and the int8 head) and
    the bf16 tree: `generate_streaming` of two sentences and
    `generate_batch` of 4 texts (196 new tokens each), one whole-stack step
    launch a decode step at B=1 and the head's `int8_matmul` beside it
    asserted, ms a token of the LM alone, the LM held against f32
    (`oute_against_f32`); then DAC: 150 frames (2 s)
    through `_decode_dac` and an `encode` of 2 s of noise by CUDA events,
    the card's decode against the host's f32 one, `extract_codes` →
    `_decode_dac` on a string with known c1/c2 runs, and the published
    layout written and read back by `load_dir`, with a `convert_dac` that
    leaves the alphas (1, C, 1) refused. Returns the launch counts."""
    import tempfile

    from tpu_audio_torch.api.errors import ModelLoadError
    from tpu_audio_torch.api.tts import TTS
    from tpu_audio_torch.codecs.dac import load as dac_load
    from tpu_audio_torch.codecs.dac import model as dac
    from tpu_audio_torch.models.outetts import engine as oe
    from tpu_audio_torch.nn.transformer import TransformerConfig
    from tpu_audio_torch.ops import quant
    from tpu_audio_torch.ops.kernels import fused_step as fs
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
    from tpu_audio_torch.ops.kernels import quant_matmul as qmm
    from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm
    from tpu_audio_torch.utils import pytree

    mods = (fs, i8mm, w4mm, qmm)
    total = {n: 0 for m in mods for n in m.LAUNCHES}
    others = tuple(n for m in (w4mm, qmm) for n in m.LAUNCHES)
    int8 = tuple(i8mm.LAUNCHES)
    cfg = TransformerConfig(**OUTE_LLM)
    t0 = time.perf_counter()
    bf16 = llama_params(cfg, dev, SEED)
    trees = {"w8a8": quant.requantize_tree_int8(quant.quantize_tree(bf16, bits=4)),
             "bf16": bf16}
    dac_cfg = dac.DACConfig()
    dac_params = dac.init_params(SEED + 1, dac_cfg, torch.float32, dev)
    torch.cuda.synchronize()
    log(f"models: OuteTTS's Llama-3.2-1B random bf16 weights (seed {SEED}) and its w8a8 tree, "
        f"the published DAC in f32, in {time.perf_counter() - t0:.1f} s")

    for kind, tree in trees.items():
        eng = TTS.oute(device=dev).from_params(tree, cfg, dac_params, dac_cfg)
        eng.speaker = None
        tag = f"oute {kind}"
        steps = step_counter(eng.lm)
        toks = []
        gen = eng.lm.generate

        def generate(*a, **k):
            out = gen(*a, **k)
            toks.append(out)
            return out

        eng.lm.generate = generate
        need = ("fused_decode_step",) + (("int8_matmul",) if kind == "w8a8" else ())
        first = {}

        def stream():
            t, chunks = time.perf_counter(), []
            for c in eng.generate_streaming(OUTE_STREAM_TEXT, max_new_tokens=OUTE_MAX_NEW):
                first.setdefault("s", time.perf_counter() - t)
                chunks.append(c)
            return chunks

        chunks, launches, wall = counted_run(
            tag, mods, total, "generate_streaming (2 sentences)", need, stream,
            absent=others + (() if kind == "w8a8" else int8))
        prompts = [eng.tokenizer.encode(oe.build_prompt(c.text, None)) for c in chunks]
        small = sum(-(-len(p) // 32) * 32 <= i8mm.MAX_ROWS for p in prompts)
        want = {"fused_decode_step": steps["n"]}
        if kind == "w8a8":  # the head each step, and at a prefill of ≤ 32 rows
            want["int8_matmul"] = steps["n"] + small
        if (len(chunks) != 2 or not chunks[-1].is_final
                or any(launches[n] != c for n, c in want.items())
                or not all(len(t) <= OUTE_MAX_NEW for t in toks)
                or steps["n"] < sum(len(t) - 1 for t in toks)):
            raise AssertionError(f"{tag} stream: {len(chunks)} chunks, {steps['n']} decode "
                                 f"steps, tokens {[len(t) for t in toks]}, launches "
                                 f"{launches}, want {want}")
        audio = np.concatenate([c.samples for c in chunks])
        if not np.isfinite(audio).all() or len(audio) % dac_cfg.hop:
            raise AssertionError(f"{tag} stream: {len(audio)} samples, non-finite or ragged")
        log(f"{tag} stream: {[len(t) for t in toks]} tokens, {steps['n']} decode steps at B=1 "
            f"= {launches['fused_decode_step']} fused_decode_step launches (one a step)"
            + (f", {launches['int8_matmul']} int8_matmul (the head a step + {small} prefills "
               "of ≤ 32 rows)" if kind == "w8a8" else "")
            + f"; first chunk after {first['s']:.3f} s; {len(audio)} samples ({card})")
        eng.lm.generate = gen
        sampler = oe.SAMPLER
        prompt = eng.tokenizer.encode(oe.build_prompt(OUTE_TEXTS[0], None))
        call = (lambda n: eng.lm.generate(prompt, sampler=sampler, eos_ids=eng._eos_ids(),
                                          max_new=n, seed=0))
        reset(*mods)
        call(2)
        _, t_first = timed(lambda: call(1))
        runs = []
        for _ in range(2):
            out, w = timed(lambda: call(OUTE_MAX_NEW))
            runs.append(f"{1e3 * (w - t_first) / (OUTE_MAX_NEW - 1):.3f} ms a token "
                        f"({len(out)} tokens)")
        for n in total:
            total[n] += launch_counts(*mods)[n]
        log(f"{tag} LM alone, B=1: prefill + first token {1e3 * t_first:.1f} ms; "
            f"{OUTE_MAX_NEW - 1} steps, two runs: {'; '.join(runs)} ({card})")
        results, launches, wall = counted_run(
            tag, mods, total, f"generate_batch x{len(OUTE_TEXTS)}",
            ("int8_matmul",) if kind == "w8a8" else (),
            lambda: eng.generate_batch(OUTE_TEXTS, max_new_tokens=OUTE_MAX_NEW),
            absent=("fused_decode_step",) + others + (() if kind == "w8a8" else int8))
        if len(results) != len(OUTE_TEXTS) or not all(np.isfinite(r.samples).all()
                                                     for r in results):
            raise AssertionError(f"{tag} generate_batch: non-finite or missing audio")
        log(f"{tag} generate_batch: {wall / (OUTE_MAX_NEW - 1) * 1e3:.2f} ms a step at "
            f"B={len(OUTE_TEXTS)} (wall over {OUTE_MAX_NEW - 1} steps, prefill and DAC "
            f"included) ({card})")
        for sharpen in (False, True):
            oute_against_f32(tag + (" q/k x3" if sharpen else ""), eng.lm,
                             [eng.tokenizer.encode(oe.build_prompt(t, None))
                              for t in OUTE_TEXTS], dev, kind == "w8a8", sharpen)
        del eng
        if kind != "w8a8":
            continue
        # speculative="ngram": the verify per layer on the plain cache, its
        # int8 matmuls at SPEC_GAMMA + 1 rows held against their plain versions
        tag = "oute w8a8 speculative ngram"
        eng = TTS.oute(speculative="ngram", gamma=SPEC_GAMMA, device=dev).from_params(
            tree, cfg, dac_params, dac_cfg, speculative="ngram", gamma=SPEC_GAMMA)
        eng.speaker = None
        with held_calls(tag, i8mm, int8, 1e-5):
            res, launches, wall = counted_run(
                tag, mods, total, f"generate ({SPEC_NEW} tokens)", ("int8_matmul",),
                lambda: eng.generate(OUTE_TEXTS[0], max_new_tokens=SPEC_NEW),
                absent=("fused_decode_step",) + others)
        st = eng.lm.last_spec_stats
        if not (np.isfinite(res.samples).all() and st["iterations"]):
            raise AssertionError(f"{tag}: non-finite audio or no iterations: {st}")
        log(f"{tag}: {st['iterations']} iterations, {st['accepted']} of {st['drafted']} drafts "
            f"accepted, {st['tokens_per_iteration']:.3f} tokens an iteration, {wall:.3f} s "
            f"(DAC included), launches an iteration " + ", ".join(
                f"{n} {c / st['iterations']:.1f}" for n, c in launches.items() if c)
            + f" ({card})")
        del eng

    # ------------------------------------------------ DAC
    eng = TTS.oute(device=dev)
    eng.speaker, eng.dac_params, eng.dac_cfg = None, dac_params, dac_cfg
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    codes = torch.randint(0, dac_cfg.codebook_size, (1, 2, DAC_FRAMES), generator=gen,
                          device=dev)
    c1, c2 = (codes[0, i].cpu().numpy() for i in range(2))
    noise = torch.randn((1, DAC_FRAMES * dac_cfg.hop), generator=gen, device=dev) * 0.1
    with torch.inference_mode():
        eng._decode_dac(c1, c2)
        ms_dec = events_ms(lambda: eng._decode_dac(c1, c2), 3)
        dac.encode(dac_params, dac_cfg, noise)
        ms_enc = events_ms(lambda: dac.encode(dac_params, dac_cfg, noise), 3)
        got = torch.from_numpy(eng._decode_dac(c1, c2))
        host = {k: v.cpu() for k, v in pytree.flatten(dac_params).items()}
        ref = dac.decode_codes(pytree.unflatten(host), dac_cfg, codes.cpu())[0]
        compare(f"DAC decode of {DAC_FRAMES} frames on the card against the host's f32 decode",
                got, ref, rel=DAC_REL)
        enc = dac.encode(dac_params, dac_cfg, noise)
        if tuple(enc.shape) != (1, 2, DAC_FRAMES) or not 0 <= int(enc.min()) <= int(
                enc.max()) < dac_cfg.codebook_size:
            raise AssertionError(f"DAC encode: codes {tuple(enc.shape)} out of shape or range")
    log(f"DAC: decode of {DAC_FRAMES} frames ({DAC_FRAMES * dac_cfg.hop / 24000:.1f} s) "
        f"through _decode_dac {ms_dec:.2f} ms, encode of the same length of noise "
        f"{ms_enc:.2f} ms (CUDA events, f32) ({card})")
    text = "<|audio_start|>\n" + "\n".join(
        "<|word_start|>w<|features|><|t_0.40|><|code|>" + "".join(
            f"<|c1_{a}|><|c2_{b}|>" for a, b in zip(c1[i:i + 30], c2[i:i + 30]))
        + "<|word_end|>" for i in range(0, DAC_FRAMES, 30))
    e1, e2 = oe.extract_codes(text)
    if not (np.array_equal(e1, c1) and np.array_equal(e2, c2)):
        raise AssertionError("extract_codes: the code runs of the string came back otherwise")
    held_exact("extract_codes → _decode_dac", torch.from_numpy(eng._decode_dac(e1, e2)), got)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dac_") as tmp:
        path = Path(tmp)
        n_bytes = write_safetensors(path / "model.safetensors", dac_torch_flat(dac_params))
        (path / "config.json").write_text(json.dumps({}))  # the published DACConfig()
        loaded, got_cfg = dac_load.load_dir(str(path), device=dev)
        if got_cfg != dac_cfg:
            raise AssertionError(f"DAC load_dir: {got_cfg}")
        held_tree(f"DAC load_dir ({n_bytes / 1e6:.0f} MB written)", loaded, dac_params)
        convert = dac_load.convert_dac

        def alphas_left(flat):  # the JAX rule: every alpha stays (1, C, 1)
            tree = pytree.flatten(convert(flat))
            return pytree.unflatten({k: v.transpose(0, 2, 1) if k.endswith(".alpha") else v
                                     for k, v in tree.items()})

        try:
            with patched(dac_load, "convert_dac", alphas_left):
                dac_load.load_dir(str(path), device=dev)
        except ModelLoadError as e:
            log(f"control DAC load_dir, alphas left (1, C, 1): refused ({str(e)[:120]}…)")
        else:
            raise AssertionError("DAC load_dir took alphas in the (1, C, 1) layout")
    return total


def marvis_slice(dev, card: str) -> dict:
    """Phase 13: Marvis at full width on random weights (`MarvisConfig()`:
    the 250M backbone, the depth decoder, 32 codebooks of 2048;
    `MimiConfig()`) through `TTS.marvis("max")` → `MarvisEngine.from_params`
    (max_frames 25), on the bf16 and the w8a8 trees: FRAME streaming of one
    sentence with ms a frame against the 80 ms budget at 12.5 Hz and the
    first chunk's latency; the whole-stack step's launches asserted (the
    backbone's one a frame after the prefill, the depth decoder's 32 a
    frame); on each tree the prefill and one greedy frame on the kernel
    path at f32 activations against the per-op path in f32, through the
    logits of their 64 draws, with planted faults; the streaming Mimi
    decode against the whole one.
    Returns the launch counts."""
    from tpu_audio_torch.api.tts import TTS, StreamingGranularity
    from tpu_audio_torch.codecs.mimi import model as mimi
    from tpu_audio_torch.codecs.mimi import streaming
    from tpu_audio_torch.models.marvis import model as mm
    from tpu_audio_torch.nn import transformer
    from tpu_audio_torch.ops.kernels import fused_step as fs
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
    from tpu_audio_torch.utils import weights

    mods = (fs, i8mm)
    total = {n: 0 for m in mods for n in m.LAUNCHES}
    cfg = mm.MarvisConfig()
    t0 = time.perf_counter()
    params = card_params(mm.numpy_params(weights.ShapeRNG(), cfg), dev, SEED)
    mimi_cfg = mimi.MimiConfig()
    mimi_params = mimi.init_params(SEED + 1, mimi_cfg, torch.float32, dev)
    torch.cuda.synchronize()
    log(f"models: Marvis 250M random bf16 weights (seed {SEED}), Mimi in f32, in "
        f"{time.perf_counter() - t0:.1f} s")
    k = cfg.n_codebooks
    for kind, quantization in (("bf16", None), ("w8a8", "w8a8")):
        eng = TTS.marvis("max", device=dev).from_params(params, cfg, mimi_params, mimi_cfg,
                                                        max_frames=MARVIS_MAX_FRAMES,
                                                        quantization=quantization)
        eng.quality = "max"
        tag = f"marvis {kind}"
        if not (eng._depth_fused and eng._bb_fused) or eng.n_codebooks != k:
            raise AssertionError(f"{tag}: the whole-stack step does not serve both stacks")
        spans = []
        span = eng._span

        def timed_span(*a, **kw):
            t = time.perf_counter()
            out = span(*a, **kw)
            torch.cuda.synchronize()
            spans.append(time.perf_counter() - t)
            return out

        eng._span = timed_span
        times = []

        def stream():
            t, chunks = time.perf_counter(), []
            for c in eng.generate_streaming(MARVIS_TEXT, granularity=StreamingGranularity.FRAME):
                times.append(time.perf_counter() - t)
                chunks.append(c)
            return chunks

        # the w8a8 prefill's int8 linears: a layer of a stacked leaf at 32 rows
        need = ("fused_decode_step",) + (("int8_matmul",) if kind == "w8a8" else ())
        chunks, launches, wall = counted_run(
            tag, mods, total, "FRAME streaming", need, stream,
            absent=() if kind == "w8a8" else tuple(i8mm.LAUNCHES))
        frames = 1 + eng.frame_span * len(spans)  # the prefill's, then the spans'
        want = k * frames + (frames - 1)  # the depth decoder's k a frame, the backbone's after
        audio = np.concatenate([c.samples for c in chunks])
        if (launches["fused_decode_step"] != want or len(audio) != MARVIS_MAX_FRAMES
                * mimi_cfg.hop or not np.isfinite(audio).all() or not chunks[-1].is_final):
            raise AssertionError(f"{tag}: {frames} frames made, {len(audio)} samples, "
                                 f"launches {launches}, want {want} fused_decode_step")
        per_frame = 1e3 * sum(spans) / (eng.frame_span * len(spans))
        log(f"{tag} FRAME streaming: {len(chunks)} chunks, {len(audio) / 24000:.2f} s of audio; "
            f"{per_frame:.2f} ms a frame over {len(spans)} spans of {eng.frame_span} "
            f"(budget 80 ms at 12.5 Hz: {per_frame / 80:.3f} of it); first chunk after "
            f"{1e3 * times[0]:.1f} ms, wall {wall:.3f} s; fused_decode_step launches "
            f"{launches['fused_decode_step']} = {k} a frame × {frames} + 1 a frame × "
            f"{frames - 1} ({card})")
        del eng

    # ------------------------------------------------ one sentence's first frames against f32
    # The kernel route (the prefill with the depth decoder's 32 launches,
    # then the backbone's one-token step and the depth decoder's 32; the
    # stacks in their serving dtype, bf16 caches, every other leaf f32)
    # against the per-op path with every leaf f32 and an f32 cache, on the
    # bf16 and the w8a8 trees (the prefill's 32 rows through int8_matmul);
    # the plain versions of the route as the yardstick; each draw forced to
    # the f32 path's code, so the logits of all 64 draws are held.
    from tpu_audio_torch.models.marvis.engine import MarvisEngine

    eng = MarvisEngine.from_params(params, cfg, mimi_params, mimi_cfg)
    tokens, mask = eng._tokenize_text(MARVIS_TEXT)
    n, pad = tokens.shape[0], 32
    tok = torch.zeros((1, pad, k + 1), dtype=torch.int64, device=dev)
    msk = torch.zeros((1, pad, k + 1), dtype=torch.bool, device=dev)
    tok[0, pad - n:], msk[0, pad - n:] = torch.as_tensor(tokens), torch.as_tensor(mask)
    s_max = mm.backbone_ring_len(pad, MARVIS_MAX_FRAMES, eng.frame_span)
    slot = torch.arange(s_max, device=dev)
    extra = torch.where(slot >= pad - n, 0.0, -1e30)[None, None, None, :]
    start = torch.tensor(pad - n, device=dev)
    greedy = dict(max_codebooks=k, temperature=0.0, top_k=0)
    record = {"logits": [], "draws": [], "forced": None}
    call = mm.Sampler.__call__

    def sampler(self, logits):
        i = len(record["logits"])
        record["logits"].append(logits.float())
        if record["forced"] is None:
            record["draws"].append(call(self, logits))
            return record["draws"][-1]
        return record["forced"][i]

    def frames(tree, kernel_route: bool):
        record["logits"] = []
        with torch.inference_mode(), patched(mm.Sampler, "__call__", sampler):
            cache = transformer.make_cache(cfg.backbone, 1, s_max, torch.float32, device=dev)
            f0, cache = mm.frame_step(tree, cfg, tok, msk, cache, extra_mask=extra,
                                      depth_fused=kernel_route, **greedy)
            step_in = eng._frame_input(f0)
            if kernel_route:
                kc, vc, pos = mm.cache_to_fused(cache, torch.bfloat16)
                mm.frame_step_fused_bb(tree, cfg, *step_in, kc, vc, pos, start, **greedy)
            else:
                mm.frame_step(tree, cfg, *step_in, cache, extra_mask=extra, **greedy)
        lg = torch.cat(record["logits"])
        return [lg[:1], lg[1:k], lg[k:k + 1], lg[k + 1:]]

    outputs = ("prefill codebook 0 logits (1, 2048)", f"prefill depth logits ({k - 1}, 2048)",
               "frame codebook 0 logits (1, 2048)", f"frame depth logits ({k - 1}, 2048)")
    step, bcfg, dcfg = fs.fused_decode_step, cfg.backbone, cfg.decoder
    int8_mm = i8mm.int8_matmul

    def unmasked(stack, x, pos, s0, *a, **kw):  # the prompt's pad slots attended
        backbone = stack["wqkv"].shape[0] == bcfg.n_layers
        return step(stack, x, pos, torch.zeros_like(s0) if backbone else s0, *a, **kw)

    def h_dropped(stack, x, pos, s0, *a, **kw):  # the depth ring's first slot unread
        depth = stack["wqkv"].shape[0] == dcfg.n_layers
        return step(stack, x, pos, s0 + int(depth and int(pos) > 1), *a, **kw)

    def k_tail_dropped(x, w, sc, bias=None, **kw):  # the last 64 input features unread
        x = x.clone()
        x[..., -64:] = 0
        return int8_mm(x, w, sc, bias, **kw)

    faults = [("the prompt's pad slots unmasked in the backbone step", fs, "fused_decode_step",
               unmasked),
              ("the backbone's state (depth slot 0) unread by later codebooks", fs,
               "fused_decode_step", h_dropped)]
    for kind, quantization in (("bf16", None), ("w8a8", "w8a8")):
        tag = f"marvis {kind} frames"
        fused = MarvisEngine._fuse(MarvisEngine._quantize(params, quantization))
        tree32 = f32_tree(fused)
        tree_k = dict(tree32, backbone=fused["backbone"], decoder=fused["decoder"])
        record["forced"] = None
        with plain_kernels(fs, i8mm):
            exact = frames(tree32, False)
            record["forced"] = list(record["draws"])
            record["draws"] = []
            plain_out = frames(tree_k, True)
        p_err, p_cos = zip(*[measure(g, r)[1:] for g, r in zip(plain_out, exact)])
        log(f"{tag}: plain route against f32: " + ", ".join(
            f"{name.split(' (')[0]} rel {e:.3e} cosine {c:.6f}"
            for name, e, c in zip(outputs, p_err, p_cos)))
        reset(fs, i8mm)
        kernel_out = frames(tree_k, True)
        launches = launch_counts(fs, i8mm)
        n_int8 = 4 * bcfg.n_layers if quantization else 0  # qkv, o, gateup, down at 32 rows
        if (launches["fused_decode_step"] != 2 * k + 1
                or launches["int8_matmul"] + launches["int8_matmul_stacked"] != n_int8):
            raise AssertionError(f"{tag}: launches {launches}, want {2 * k + 1} "
                                 f"fused_decode_step, {n_int8} int8 matmuls")
        held_against_f32(tag, outputs, exact, p_err, "kernels", kernel_out, control=False,
                         p_cos=p_cos)
        planted = faults + ([("the last 64 input features dropped in the prefill's "
                              "int8_matmul", i8mm, "int8_matmul", k_tail_dropped)]
                            if quantization else [])
        for label, mod, name, fault in planted:
            with patched(mod, name, fault):
                out = frames(tree_k, True)
            held_against_f32(tag, outputs, exact, p_err, label, out, control=True,
                             p_cos=p_cos)
        del fused, tree32, tree_k

    # ------------------------------------------------ the int8 KV cache
    # `kv_quantized=True` on the w8a8 tree: FRAME streaming with the
    # backbone per layer over the int8 cache (no backbone step launch, the
    # depth decoder's k a frame), and the backbone's codebook-0 logits of
    # the prefill and one frame (greedy, each draw forced to the bf16
    # cache's) against the same with a bf16 KVCache, within KV8_REL and
    # cosine 0.999; the scales dropped on read must land CV_FAULT_RATIO as
    # far from the bf16 cache's logits as the int8 cache's own
    from tpu_audio_torch.ops.kvcache import QuantizedKVCache

    tag = "marvis w8a8 kv_quantized"
    kv8 = TTS.marvis("max", device=dev).from_params(params, cfg, mimi_params, mimi_cfg,
                                                    max_frames=MARVIS_MAX_FRAMES,
                                                    quantization="w8a8", kv_quantized=True)
    kv8.quality = "max"
    if not kv8._depth_fused or kv8._bb_fused:
        raise AssertionError(f"{tag}: want the depth decoder's step and no backbone step")
    chunks, launches, wall = counted_run(
        tag, mods, total, "FRAME streaming", ("fused_decode_step",),
        lambda: list(kv8.generate_streaming(MARVIS_TEXT, granularity=StreamingGranularity.FRAME)))
    audio = np.concatenate([c.samples for c in chunks])
    frames = len(audio) // mimi_cfg.hop
    if (launches["fused_decode_step"] != k * frames or not np.isfinite(audio).all()
            or frames != MARVIS_MAX_FRAMES
            or not launches["int8_matmul"] + launches["int8_matmul_stacked"]):
        raise AssertionError(f"{tag}: {frames} frames, launches {launches}, want "
                             f"{k * frames} fused_decode_step (the depth decoder's alone)")
    log(f"{tag} FRAME streaming: {frames} frames in {wall:.3f} s, "
        f"{1e3 * wall / frames:.2f} ms a frame (the Mimi decode included); launches "
        f"{launches} ({card})")
    fused = MarvisEngine._fuse(MarvisEngine._quantize(params, "w8a8"))
    tree_k = dict(f32_tree(fused), backbone=fused["backbone"], decoder=fused["decoder"])

    def backbone_logits(quantized: bool):
        record["logits"] = []
        with torch.inference_mode(), patched(mm.Sampler, "__call__", sampler):
            cache = transformer.make_cache(cfg.backbone, 1, s_max, torch.bfloat16,
                                           quantized=quantized, device=dev)
            f0, cache = mm.frame_step(tree_k, cfg, tok, msk, cache, extra_mask=extra,
                                      depth_fused=True, **greedy)
            if quantized != isinstance(cache, QuantizedKVCache):
                raise AssertionError(f"{tag}: the backbone's cache is {type(cache).__name__}")
            mm.frame_step(tree_k, cfg, *kv8._frame_input(f0), cache, extra_mask=extra,
                          depth_fused=True, **greedy)
        lg = torch.cat(record["logits"])
        return torch.cat([lg[:1], lg[k:k + 1]])  # codebook 0 of the prefill and the frame

    record["forced"], record["draws"] = None, []
    ref = backbone_logits(False)
    record["forced"], record["draws"] = list(record["draws"]), []
    got = backbone_logits(True)
    _, rel, cos = measure(got, ref)
    if not (rel <= KV8_REL and cos > 0.999):
        raise AssertionError(f"{tag}: backbone logits rel {rel:.3e} cosine {cos:.6f} against "
                             f"the bf16 cache's, outside {KV8_REL} / 0.999")
    log(f"{tag}: the backbone's codebook-0 logits (prefill and a frame) over the int8 cache "
        f"against the bf16 cache's: rel {rel:.3e}, cosine {cos:.6f} (limit {KV8_REL})")

    def scales_dropped(self, layer, dtype=torch.bfloat16):
        return self.k_q[layer].to(dtype), self.v_q[layer].to(dtype)

    with patched(QuantizedKVCache, "read_layer", scales_dropped):
        bad = backbone_logits(True)
    _, bad_rel, bad_cos = measure(bad, ref)
    control_ratio(tag, "the scales dropped on read", [bad_rel / rel],
                  f"rel {bad_rel:.3e} cosine {bad_cos:.6f}",
                  "the int8 cache's own distance from the bf16 cache's logits")
    del eng, kv8, fused, tree_k

    # ------------------------------------------------ the streaming Mimi decoder
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    codes = torch.randint(0, mimi_cfg.bins, (1, k, MARVIS_MAX_FRAMES), generator=gen,
                          device=dev)
    with torch.inference_mode():
        whole = mimi.decode(mimi_params, mimi_cfg, codes)
        ms_whole = events_ms(lambda: mimi.decode(mimi_params, mimi_cfg, codes), 3)
        state = streaming.init_state(mimi_params, mimi_cfg, 1, 6)
        parts = [streaming.decode_stream(mimi_params, mimi_cfg, codes[:, :, s:s + 6], state)[0]
                 for s in range(0, MARVIS_MAX_FRAMES, 6)]
    compare(f"Mimi decode_stream in chunks of 6 frames against the whole decode of "
            f"{MARVIS_MAX_FRAMES}", torch.cat(parts, -1), whole, rel=MIMI_REL)
    log(f"Mimi: whole decode of {MARVIS_MAX_FRAMES} frames (2 s) {ms_whole:.2f} ms "
        f"(CUDA events, f32) ({card})")
    return total


# the TMA + wgmma kernels of csrc/ (hopper.cuh) and the passes that feed
# them, the two decode kernels and the functions the whole-decoder step
# calls, the W4A8 rows kernel and products, the whole-stack Llama/Qwen
# step and its functions (every instantiation), and whether each issues
# wgmma
HOPPER_KERNELS = {"ln_rows_kernel": False, "qkv_gemm_kernel": True,
                  "encoder_attention_kernel": True, "attn_heads_kernel": True,
                  "oproj_ln_bf16_kernel": True, "quant_rows_kernel": False,
                  "ln_quant_rows_kernel": False, "fc1_gemm_kernel": True,
                  "s8_gemm_kernel": True, "pair_codes_kernel": True, "oproj_ln_kernel": True,
                  "fused_whisper_step_kernel": False, "step_product": False,
                  "step_layer_norm": False, "chunk_attention": False,
                  "cross_attention_decode_kernel": False, "w4a8_rows_kernel": False,
                  "w4a8_kernel": False, "fused_step_kernel": False, "make_terms_k": False,
                  "slot_mma": False, "final_norm": False}


class WordTokenizer:
    """Stands in for a text tokenizer.json (not in the repository): one id
    a word, from its CRC, below `vocab` (Qwen2's 151,643 text ids by
    default), about the count a BPE gives English."""

    def __init__(self, vocab: int = 151643):
        self.vocab = vocab

    def encode(self, text: str) -> list[int]:
        import zlib

        return [zlib.crc32(w.encode()) % self.vocab for w in text.split()]


def s3_card_params(schema: dict, dev, seed: int, dtype=torch.bfloat16) -> dict:
    """An S3-family `numpy_params` schema (from a ShapeRNG) filled on the
    card: each drawn leaf uniform in ±1/√fan_in (a kernel's (K, I) or
    (KH, KW, I), a linear's I, a vector's length), the norms, BN stats and
    alphas as the schema has them; in the port's layouts in `dtype` (the BN
    stats and alphas in f32, as `s3_params_from_numpy` keeps them)."""
    from tpu_audio_torch.convert import s3_params_from_numpy
    from tpu_audio_torch.utils import pytree, weights

    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = {}
    for k, v in pytree.flatten(schema).items():
        if isinstance(v, weights.AbstractLeaf):
            fan = v.shape[-1] if len(v.shape) <= 2 else math.prod(v.shape[:-1])
            flat[k] = (torch.rand(v.shape, generator=gen, device=dev) * 2 - 1) / math.sqrt(fan)
        else:
            flat[k] = torch.as_tensor(v, device=dev)
    return s3_params_from_numpy(pytree.unflatten(flat), dev, dtype)


def cv_against_f32(tag: str, tree: dict, cfg, dev, int8: bool, prompt) -> None:
    """Phase 14, the CosyVoice2 LM on the kernel route held against f32
    through the speech logits: the roll-packed prefill and CV_HELD_STEPS
    T=1 steps, each fed the f32 path's greedy token. The route runs the
    stack in its serving dtype (one whole-stack step launch a step, the qkv
    bias folded in) with a bf16 cache, every other float leaf in f32 (f32
    activations; on the w8a8 tree the speech head's `int8_matmul` with its
    bias); the reference is the per-op path with every float leaf in f32,
    an f32 cache and the plain int8 products; the plain versions of the
    route are the yardstick. Planted faults must land at least
    CV_FAULT_RATIO times as far from f32 as the yardstick on some output:
    the qkv bias dropped in the step, query head j reading KV head j // 2
    (clamped) instead of j // 7, RoPE turned backwards in the step, and on
    the w8a8 tree the head's bias dropped in `int8_matmul`."""
    from tpu_audio_torch.models.cosyvoice2 import lm as cvlm
    from tpu_audio_torch.ops.kernels import fused_step as fs
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm

    steps = CV_HELD_STEPS
    tree32 = f32_tree(tree)
    exact_gen = cvlm.CosyLMGenerator(tree32, cfg, cache_dtype=torch.float32)
    route_gen = cvlm.CosyLMGenerator(dict(tree32, llm=dict(tree32["llm"],
                                                            layers=tree["llm"]["layers"])), cfg)
    if not route_gen.fused_ok():
        raise AssertionError(f"{tag}: the whole-stack step does not serve the tree")

    def decode(gen, fused: bool, forced=None):
        with torch.inference_mode():
            logits, cache, extra = gen.prefill(*prompt, steps + 1, fused=fused)
            out, step = [logits], gen.step_fn(extra)
            for i in range(steps):
                tok = out[-1].argmax(-1) if forced is None else forced[i]
                logits, cache = step(tok[:, None], cache)
                out.append(logits)
            return torch.cat(out)

    with plain_kernels(fs, i8mm):
        exact = decode(exact_gen, False)
        forced = exact[:-1].argmax(-1)[:, None]
        plain = decode(route_gen, True, forced)
    parts = [exact[:1], exact[1:]]
    outputs = (f"prefill logits (1, {exact.shape[-1]})",
               f"step logits ({steps}, {exact.shape[-1]})")
    p_err, p_cos = zip(*[measure(pl, ex)[1:] for pl, ex in zip((plain[:1], plain[1:]), parts)])
    log(f"{tag} plain route against f32: " + ", ".join(
        f"{n.split(' (')[0]} rel {e:.3e} cosine {c:.6f}" for n, e, c in zip(outputs, p_err,
                                                                             p_cos)))
    reset(fs, i8mm)
    got = decode(route_gen, True, forced)
    launches = launch_counts(fs, i8mm)
    want = (steps, (1 + steps) * int8)  # a step each; the head at the prefill and each step
    if (launches["fused_decode_step"], launches["int8_matmul"]) != want or launches[
            "int8_matmul_stacked"]:
        raise AssertionError(f"{tag} held: launches {launches}, want {want[0]} "
                             f"fused_decode_step, {want[1]} int8_matmul")
    held_against_f32(tag, outputs, parts, p_err, "kernels", [got[:1], got[1:]], control=False,
                     p_cos=p_cos)

    step, head = fs.fused_decode_step, i8mm.int8_matmul

    def bias_dropped(stack, *a, **kw):
        return step({k: v for k, v in stack.items() if k != "bqkv"}, *a, **kw)

    def kv_head_by_2(stack, x, pos, s0, cos, sin, kc, vc, **kw):
        def by_2(t, n_heads):
            return t[torch.clamp(torch.arange(n_heads, device=t.device) // 2,
                                 max=t.shape[0] - 1)]
        with patched(fs, "_kv_heads", by_2):
            return fs.fused_decode_step_plain(stack, x, pos, s0, cos, sin, kc, vc, **kw)

    def rope_backwards(stack, x, pos, s0, cos, sin, *a, **kw):
        return step(stack, x, pos, s0, cos, -sin, *a, **kw)

    def head_bias_dropped(x, w, sc, bias=None, **kw):
        return head(x, w, sc, None, **kw)

    faults = [("the qkv bias dropped in the step", fs, "fused_decode_step", bias_dropped),
              ("KV head = head / 2 (clamped), not head / 7, in the step", fs,
               "fused_decode_step", kv_head_by_2),
              ("RoPE turned backwards in the step", fs, "fused_decode_step", rope_backwards)]
    if int8:
        faults.append(("the head's bias dropped in int8_matmul", i8mm, "int8_matmul",
                       head_bias_dropped))
    for fault, mod, name, fn in faults:
        with patched(mod, name, fn):
            out = decode(route_gen, True, forced)
        held_against_f32(tag, outputs, parts, p_err, fault, [out[:1], out[1:]], control=True,
                         p_cos=p_cos)


def cv_vocoder_stream(s3, s3cfg, mel: torch.Tensor, card: str) -> None:
    """HiFT streamed (`vocode_window` over windows ending at CV_VOC_ENDS,
    the phase and the source tail carried) against one `generate` of the
    same mel, both in f32 on the card with `Noise(SEED)`: within
    CV_VOC_REL outside the CV_VOC_EDGE frames before each window's right
    edge (a window lacks the mel after it there, as the reference's
    streaming does)."""
    from tpu_audio_torch.codecs.s3gen import hift
    from tpu_audio_torch.codecs.s3gen.noise import Noise
    from tpu_audio_torch.utils import pytree

    p32 = pytree.unflatten({k: v.float() for k, v in pytree.flatten(s3["mel2wav"]).items()})
    cfg, noise, ups = s3cfg.hift, Noise(SEED), s3cfg.hift.upsample_scale
    mel = mel[:, : CV_VOC_ENDS[-1]].float()
    with torch.inference_mode():
        full, _ = hift.generate(p32, cfg, mel, noise)
        phase = torch.zeros((1, cfg.nb_harmonics + 1), dtype=torch.float64, device=mel.device)
        tail, done, parts = mel.new_zeros((1, 0)), 0, []
        for end in CV_VOC_ENDS:
            lb = min(hift.LOOKBACK_FRAMES, done)
            audio, phase, src = hift.vocode_window(p32, cfg, mel[:, done - lb: end], noise,
                                                   phase, tail[:, tail.shape[1] - lb * ups:],
                                                   done)
            parts.append(audio[0, lb * ups:])
            tail = src[:, (lb + end - done - min(hift.LOOKBACK_FRAMES, end)) * ups:]
            done = end
    got = torch.cat(parts)
    starts = (0,) + CV_VOC_ENDS[:-1]
    for a, b in zip(starts, CV_VOC_ENDS[:-1] + (CV_VOC_ENDS[-1] + CV_VOC_EDGE,)):
        b -= CV_VOC_EDGE
        compare(f"HiFT streamed windows, frames {a}-{b}, against one generate (f32, {card})",
                got[a * ups: b * ups], full[0, a * ups: b * ups], rel=CV_VOC_REL)


def cosy_lm_trees(lm_cfg, dev) -> tuple[dict, dict]:
    """CosyVoice2's LM (Qwen2-0.5B of `lm_cfg`) on random weights drawn on
    the card (seed 0): (the bf16 tree, its q4 tree). q's and k's biases at
    ±CV_QK_BIAS and the head's at ±1: the init's ±1/√fan_in would leave
    them ~3 % of what they add to (a trained Qwen2's q and k biases are of
    the order of its projections, or larger); with them the random stack's
    attention depends on its positions and its head, so that a fault there
    shows (v's stays the init's: a large v bias would make every key's
    value alike)."""
    from tpu_audio_torch.models.cosyvoice2 import lm as cvlm
    from tpu_audio_torch.ops import quant
    from tpu_audio_torch.utils.weights import ShapeRNG

    bf16 = card_params(cvlm.numpy_params(ShapeRNG(), lm_cfg), dev, SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    def uniform(t, scale):
        return ((torch.rand(t.shape, generator=gen, device=dev) * 2 - 1) * scale).to(t.dtype)
    for name in ("q", "k"):
        leaf = bf16["llm"]["layers"]["attn"][name]
        leaf["bias"] = uniform(leaf["bias"], CV_QK_BIAS)
    bf16["llm_decoder"]["bias"] = uniform(bf16["llm_decoder"]["bias"], 1.0)
    return bf16, quant.quantize_tree(bf16, bits=4)


def cosyvoice_slice(dev, card: str) -> dict:
    """Phase 14: CosyVoice2 at full width on random weights (seed 0:
    `CosyLMConfig()`'s Qwen2-0.5B, `S3GenConfig()`, `S3TokenizerConfig()`,
    `CAMPPlusConfig()`; q's and k's biases at ±CV_QK_BIAS and the speech
    head's at ±1; the text tokenizer a word-level stand-in) through
    `TTS.cosyvoice2()` → `CosyVoice2Engine.from_params`, on the w8a8 tree
    (the q4 tree requantised: the whole-stack step with the qkv bias and
    the int8 speech head) and the bf16 tree: `prepare_conditionals` on 3 s
    of noise with its text, `generate_streaming` of two sentences at TOKEN
    granularity (the first chunk's latency, × real time), `generate` of one
    sentence, `voice_conversion` of 2 s; one whole-stack step launch a T=1
    step and on w8a8 one head `int8_matmul` a step asserted; the LM alone
    in ms a token; the LM held against f32 (`cv_against_f32`); one short
    `generate` on the W4A8 tree (its kernels, no step kernel; each of its
    calls held against its plain version at rel 1e-5, `held_calls`); the flow's
    ms a window and HiFT's ms a chunk by CUDA events; the streamed vocoder
    against one pass (`cv_vocoder_stream`). Returns the launch counts."""
    from tpu_audio_torch.api.tts import TTS, StreamingGranularity
    from tpu_audio_torch.codecs.s3gen import hift
    from tpu_audio_torch.codecs.s3gen import model as s3gen
    from tpu_audio_torch.codecs.s3gen.noise import Noise
    from tpu_audio_torch.codecs.s3tokenizer import model as s3tok
    from tpu_audio_torch.models.cosyvoice2 import lm as cvlm
    from tpu_audio_torch.ops import quant
    from tpu_audio_torch.ops.kernels import fused_step as fs
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
    from tpu_audio_torch.ops.kernels import quant_matmul as qmm
    from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm
    from tpu_audio_torch.utils.weights import ShapeRNG

    mods = (fs, i8mm, w4mm, qmm)
    total = {n: 0 for m in mods for n in m.LAUNCHES}
    others = tuple(n for m in (w4mm, qmm) for n in m.LAUNCHES)
    int8 = tuple(i8mm.LAUNCHES)
    lm_cfg, s3cfg, tokcfg = cvlm.CosyLMConfig(), s3gen.S3GenConfig(), s3tok.S3TokenizerConfig()
    t0 = time.perf_counter()
    bf16, q4 = cosy_lm_trees(lm_cfg, dev)
    trees = {"w8a8": quant.requantize_tree_int8(q4), "bf16": bf16}
    s3 = s3_card_params(s3gen.numpy_params(ShapeRNG(), s3cfg), dev, SEED + 1)
    tokp = s3_card_params(s3tok.numpy_params(ShapeRNG(), tokcfg), dev, SEED + 2)
    torch.cuda.synchronize()
    log(f"models: CosyVoice2's Qwen2-0.5B random bf16 weights (seed {SEED}), its w8a8 tree; "
        f"S3Gen, the S3 tokenizer and CAMPPlus at full width in bf16, in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    ref24 = (0.1 * rng.standard_normal(CV_REF_SECONDS * 24000)).astype(np.float32)
    src16 = (0.1 * rng.standard_normal(CV_VC_SECONDS * 16000)).astype(np.float32)
    text = " ".join(CV_TEXTS)

    for kind, tree in trees.items():
        tag = f"cosyvoice2 {kind}"
        eng = TTS.cosyvoice2(device=dev).from_params(tree, lm_cfg, s3, s3cfg, tokp, tokcfg,
                                                     tokenizer=WordTokenizer())
        spk, _, wall = counted_run(
            tag, mods, total, f"prepare_conditionals ({CV_REF_SECONDS} s)", (),
            lambda: eng.prepare_conditionals(ref24, 24000, ref_text=CV_REF_TEXT),
            absent=tuple(total))
        if not (len(spk.speech_tokens) == 25 * CV_REF_SECONDS and spk.prompt_mel.shape[1]
                == 2 * len(spk.speech_tokens) and torch.isfinite(spk.embedding).all()):
            raise AssertionError(f"{tag} speaker: {len(spk.speech_tokens)} tokens, mel "
                                 f"{tuple(spk.prompt_mel.shape)}")
        steps = {"n": 0}
        make = eng.lm.step_fn

        def counted(extra, make=make):
            step = make(extra)

            def run(tok, cache):
                steps["n"] += 1
                return step(tok, cache)
            return run

        eng.lm.step_fn = counted
        need = ("fused_decode_step",) + (("int8_matmul",) if kind == "w8a8" else ())
        first = {}

        def stream():
            t, chunks = time.perf_counter(), []
            for c in eng.generate_streaming(text):
                first.setdefault("s", time.perf_counter() - t)
                chunks.append(c)
            return chunks

        chunks, launches, wall = counted_run(
            tag, mods, total, "generate_streaming (2 sentences, TOKEN)", need, stream,
            absent=others + (() if kind == "w8a8" else int8))
        want = {"fused_decode_step": steps["n"]}
        if kind == "w8a8":  # the head a step, and at each sentence's prefill
            want["int8_matmul"] = steps["n"] + 2
        audio = np.concatenate([c.samples for c in chunks])
        seconds = len(audio) / 24000
        if (not chunks[-1].is_final or len(chunks) < 4 or not np.isfinite(audio).all()
                or any(launches[n] != c for n, c in want.items())):
            raise AssertionError(f"{tag} stream: {len(chunks)} chunks, {steps['n']} T=1 steps, "
                                 f"launches {launches}, want {want}")
        log(f"{tag} stream: {len(chunks)} chunks, {steps['n']} T=1 steps = "
            f"{launches['fused_decode_step']} fused_decode_step launches (one a step)"
            + (f", {launches['int8_matmul']} int8_matmul (the head a step + 2 prefills)"
               if kind == "w8a8" else "")
            + f"; first audio after {first['s']:.3f} s; {seconds:.2f} s of audio in "
              f"{wall:.3f} s: {seconds / wall:.2f}× real time ({card})")
        steps["n"] = 0
        res, launches, wall = counted_run(
            tag, mods, total, "generate (1 sentence, SENTENCE)", need,
            lambda: eng.generate(CV_TEXTS[0]), absent=others + (() if kind == "w8a8" else int8))
        want = {"fused_decode_step": steps["n"]}
        if kind == "w8a8":
            want["int8_matmul"] = steps["n"] + 1
        if (not len(res.samples) or not np.isfinite(res.samples).all()
                or any(launches[n] != c for n, c in want.items())):
            raise AssertionError(f"{tag} generate: {len(res.samples)} samples, launches "
                                 f"{launches}, want {want}")
        log(f"{tag} generate: {len(res.samples) / 24000:.2f} s of audio, {steps['n']} T=1 steps, "
            f"{wall:.3f} s: {len(res.samples) / 24000 / wall:.2f}× real time ({card})")
        vc, _, wall = counted_run(tag, mods, total, f"voice_conversion ({CV_VC_SECONDS} s)", (),
                                  lambda: eng.voice_conversion(src16, 16000),
                                  absent=tuple(total))
        if len(vc) != CV_VC_SECONDS * 24000 or not np.isfinite(vc).all():
            raise AssertionError(f"{tag} voice_conversion: {len(vc)} samples")
        eng.lm.step_fn = make
        prompt = (eng.tokenizer.encode(CV_TEXTS[0]), spk.prompt_text_ids, spk.speech_tokens)
        reset(*mods)
        walls = {}
        for n in CV_TIMED_NEW + CV_TIMED_NEW:
            _, w = timed(lambda n=n: eng.lm.generate(*prompt, max_new=n))
            walls.setdefault(n, []).append(w)
        for n in total:
            total[n] += launch_counts(*mods)[n]
        lo, hi = CV_TIMED_NEW
        runs = [1e3 * (b - a) / (hi - lo) for a, b in zip(walls[lo], walls[hi])]
        log(f"{tag} LM alone, B=1: ms a token {', '.join(f'{r:.3f}' for r in runs)} "
            f"(generate of {hi} against {lo} tokens, twice) ({card})")
        cv_against_f32(tag, tree, lm_cfg, dev, kind == "w8a8", prompt)
        del eng

    # ------------------------------------------------ W4A8, the flow, HiFT
    w4 = cvlm.CosyLMGenerator(quant.repack_tree_w4a8(q4), lm_cfg)
    with held_calls("cosyvoice2 w4a8", w4mm, ("w4a8_matmul", "w4a8_matmul_stacked"), 1e-5):
        toks, launches, _ = counted_run(
            "cosyvoice2 w4a8", mods, total, f"generate ({CV_W4A8_NEW} tokens)",
            ("w4a8_matmul", "w4a8_matmul_stacked"),
            lambda: w4.generate(WordTokenizer().encode(CV_TEXTS[0]), [], [1, 2, 3],
                                max_new=CV_W4A8_NEW),
            absent=("fused_decode_step", "w4a8_sg_matmul", "w4a8_sg_matmul_stacked") + int8)
    if not toks:
        raise AssertionError("cosyvoice2 w4a8 generate: no tokens")
    del w4, q4, trees
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    p_len, n_tok = 75, 53  # a 3 s speaker, a window of 50 tokens + the lookahead
    pt = torch.randint(0, s3cfg.vocab_size, (1, p_len), generator=gen, device=dev)
    toks = torch.zeros((1, 64), dtype=torch.int64, device=dev)
    toks[0, :n_tok] = torch.randint(0, s3cfg.vocab_size, (n_tok,), generator=gen, device=dev)
    pm = torch.randn((1, 2 * p_len, s3cfg.mel_dim), generator=gen, device=dev).to(torch.bfloat16)
    emb = torch.randn((1, s3cfg.spk_dim), generator=gen, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        def flow():
            return s3gen.flow_inference(s3, s3cfg, toks, n_tok, pt, p_len, pm, 2 * p_len, emb,
                                        Noise(SEED), streaming=True)[0]
        mel = flow()
        ms_flow = events_ms(flow, 2)
        lb, new = hift.LOOKBACK_FRAMES, 50
        win = mel[:, : lb + new]
        phase = torch.zeros((1, s3cfg.hift.nb_harmonics + 1), dtype=torch.float64, device=dev)
        tail = torch.zeros((1, lb * s3cfg.hift.upsample_scale), dtype=win.dtype, device=dev)
        ms_voc = events_ms(lambda: hift.vocode_window(s3["mel2wav"], s3cfg.hift, win,
                                                      Noise(SEED), phase, tail, 100), 2)
    log(f"S3Gen: flow {ms_flow:.2f} ms a window ({p_len} prompt + 64 tokens, "
        f"{s3cfg.cfm.n_timesteps} CFG Euler steps, streaming masks), HiFT {ms_voc:.2f} ms a "
        f"chunk ({lb} + {new} frames, 1 s of new audio) (CUDA events, bf16) ({card})")
    if not torch.isfinite(mel).all():
        raise AssertionError("cosyvoice2 flow: non-finite mel")
    cv_vocoder_stream(s3, s3cfg, mel[:, 2 * p_len:], card)
    return total


# ------------------------------------------------ 15. speculative decoding

def spec_loop(spec, opened: dict, gamma: int, draft: dict | None = None) -> dict:
    """The speculative loop, sampled at temperature 1 from a seeded
    generator (a greedy random stack repeats one token, and a cache that
    lost copies of it hardly moves the logits), for SPEC_HELD_NEW tokens
    from `opened` (a target opened by a `spec_against_f32` opener) and, with
    `draft`, a draft opened alike; each verify's inputs and logits, each
    draft step's last logits and each accept's n_acc recorded. Returns the
    records and the result, with the emitted tokens (the first included)."""
    from tpu_audio_torch.ops.sampling import SamplerConfig

    rec = {"t": [], "d": [], "acc": []}
    t_step, d_step, acc = opened["step"], draft and draft["step"], spec.accept

    def t_wrap(toks, c):
        lg, c = t_step(toks, c)
        rec["t"].append((toks[0].clone(), lg[0].float().clone()))
        return lg, c

    def d_wrap(toks, c):
        lg, c = d_step(toks, c)
        rec["d"].append(lg[0, -1].float().clone())
        return lg, c

    def a_wrap(*a):
        n_acc, extra = acc(*a)
        rec["acc"].append(n_acc[0].clone())
        return n_acc, extra

    kw = (dict(draft_step=d_wrap, draft_cache=draft["cache"]) if draft else
          dict(history=opened["hist"], history_len=opened["hist_len"]))
    gen = torch.Generator(device=opened["first"].device).manual_seed(SEED + 8)
    with patched(spec, "accept", a_wrap), torch.inference_mode():
        res = spec.speculative_decode_loop(
            t_wrap, opened["cache"], opened["first"], opened["second"], SPEC_HELD_NEW, gamma,
            (), SamplerConfig(temperature=1.0), generator=gen, **kw)
    k = int(res.iterations)
    rec["t"], rec["acc"] = rec["t"][:k], [int(a) for a in rec["acc"][:k]]
    rec["d"] = rec["d"][:k * gamma]
    rec["seq"] = [int(opened["first"][0])] + res.tokens[0, :int(res.emitted)].tolist()
    rec["res"] = res
    return rec


def spec_refs(rec: dict, gamma: int, open_t, open_d=None):
    """The logits of a recorded loop's verifies (and draft steps) recomputed
    from a fresh prefill on each iteration's true prefix (the prompt and the
    tokens emitted before it), by `open_t(…)` / `open_d(…)`: (verify rows
    ((gamma + 1) · iterations, V), draft rows (gamma · iterations, V) or
    None)."""
    seq, i, t_rows, d_rows = rec["seq"], 0, [], []
    for it, (t_in, _) in enumerate(rec["t"]):
        if int(t_in[0]) != seq[i]:
            raise AssertionError(f"speculative loop: iteration {it} verifies from {int(t_in[0])}, "
                                 f"not the last emitted token {seq[i]}")
        with torch.inference_mode():
            o = open_t()
            step, cache = o["step"], o["cache"]
            if i:
                _, cache = step(torch.tensor([seq[:i]], device=t_in.device), cache)
            t_rows.append(step(t_in[None], cache)[0][0].float())
            if open_d is not None:
                o = open_d()
                step, cache = o["step"], o["cache"]
                d_seq = [int(o["second"][0])] + seq
                if i:
                    _, cache = step(torch.tensor([d_seq[:i]], device=t_in.device), cache)
                lg, cache = step(torch.tensor([d_seq[i:i + 2]], device=t_in.device), cache)
                d_rows.append(lg[0, -1:].float())
                for g in range(gamma - 1):
                    lg, cache = step(t_in[1 + g:2 + g][None], cache)
                    d_rows.append(lg[0, -1:].float())
        i += rec["acc"][it] + 1
    return torch.cat(t_rows), (torch.cat(d_rows) if open_d is not None else None)


def spec_against_f32(tag: str, opener, gamma: int, draft_opener=None, plain_mods=(),
                     loop_faults: bool = True, kernel_faults=()) -> None:
    """A speculative route held against f32 (phase 15): the loop on the
    kernel route (the target on the plain cache, a verify of gamma + 1
    rows a pass; the draft on its whole-stack step), each verify's logits
    and each draft step's against the same positions recomputed from a
    fresh prefill of the true prefix, in f32 (the reference) and on the
    plain versions of the route (the yardstick, `held_against_f32`).
    opener(kind) / draft_opener(kind), kind "route", "plain" or "exact",
    open a prefilled model: {step, cache, first, second, hist, hist_len}.
    Planted faults must read CV_FAULT_RATIO: with `loop_faults` the target
    rewound to p_t + n_acc instead of + 1 and, with a draft, the draft not
    rewound; `kernel_faults`, (label, module, name, fn) patched in."""
    from tpu_audio_torch.ops import speculative as spec

    def route_run():
        return spec_loop(spec, opener("route"), gamma,
                         draft_opener("route") if draft_opener else None)

    rec = route_run()
    got = [torch.cat([r[1] for r in rec["t"]])] + ([torch.cat([d[None] for d in rec["d"]])]
                                                   if draft_opener else [])

    def refs(rec, kind):
        with plain_kernels(*plain_mods):
            t_ref, d_ref = spec_refs(rec, gamma, lambda: opener(kind),
                                     (lambda: draft_opener(kind)) if draft_opener else None)
        return [t_ref] + ([d_ref] if draft_opener else [])

    exact, plain = refs(rec, "exact"), refs(rec, "plain")
    outputs = [f"verify logits {tuple(got[0].shape)}"] + (
        [f"draft logits {tuple(got[1].shape)}"] if draft_opener else [])
    p_err, p_cos = zip(*[measure(p, e)[1:] for p, e in zip(plain, exact)])
    res = rec["res"]
    log(f"{tag} held: {int(res.iterations)} iterations, {int(res.accepted)} of "
        f"{int(res.drafted)} drafts accepted, {len(rec['seq'])} tokens; plain route against "
        f"f32: " + ", ".join(f"{o.split(' (')[0]} rel {e:.3e} cosine {c:.6f}"
                             for o, e, c in zip(outputs, p_err, p_cos)))
    held_against_f32(tag, outputs, exact, p_err, "kernels", got, control=False, p_cos=p_cos)
    faults = [] if not loop_faults else [
        ("the target rewound to p_t + n_acc, not + 1", spec, "target_pos",
         lambda p_t, n_acc: p_t + n_acc)]
    if draft_opener and loop_faults:
        faults.append(("the draft not rewound", spec, "draft_pos",
                       lambda p_t, n_acc: p_t + gamma))
    for label, mod, name, fn in faults + list(kernel_faults):
        with patched(mod, name, fn):
            bad = route_run()
        out = [torch.cat([r[1] for r in bad["t"]])] + (
            [torch.cat([d[None] for d in bad["d"]])] if draft_opener else [])
        held_against_f32(tag, outputs, refs(bad, "exact"), p_err, label, out, control=True,
                         p_cos=p_cos)


def accept_marginal(dev) -> None:
    """Phase 15, the accept step on the card: its first emitted token (x_0
    if accepted, else the residual's draw) over SPEC_CHI2_ROWS rows drawn
    from q, at V 6, gamma 2, in one batched call: χ² against p under
    SPEC_CHI2_LIMIT (5 dof, p-value 1e-3). A planted fault, the residual
    taken from p alone, must read CV_FAULT_RATIO times the limit."""
    from tpu_audio_torch.ops import sampling
    from tpu_audio_torch.ops import speculative as spec

    n, gamma, v = SPEC_CHI2_ROWS, 2, 6
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    p = torch.tensor([0.30, 0.25, 0.20, 0.15, 0.07, 0.03], device=dev)
    q = torch.tensor([0.05, 0.10, 0.15, 0.20, 0.25, 0.25], device=dev)
    p_stack = torch.stack([p, p.flip(0), p]).expand(n, gamma + 1, v)
    q_stack = torch.stack([q, q, torch.zeros_like(q)]).expand(n, gamma + 1, v)
    x = torch.multinomial(q, n * gamma, replacement=True, generator=gen).reshape(n, gamma)
    u = torch.rand((n, gamma), generator=gen, device=dev)
    g = sampling.gumbel((n, v), gen, dev)

    def chi2() -> float:
        n_acc, extra = spec.accept(p_stack, q_stack, x, u, g)
        first = torch.where(n_acc > 0, x[:, 0], extra)
        counts = torch.bincount(first, minlength=v).double()
        return float(((counts - n * p.double()) ** 2 / (n * p.double())).sum())

    right = chi2()
    if not right < SPEC_CHI2_LIMIT:
        raise AssertionError(f"speculative accept step: χ² {right:.2f} against p over {n} rows, "
                             f"at or past {SPEC_CHI2_LIMIT}")
    log(f"speculative accept step: the first emitted token over {n} rows (V {v}, gamma "
        f"{gamma}) against p: χ² {right:.2f} < {SPEC_CHI2_LIMIT} (5 dof, p-value 1e-3)")
    with patched(spec, "residual", lambda p_, q_: p_):
        bad = chi2()
    control_ratio("speculative accept step", "the residual taken from p alone",
                  [bad / SPEC_CHI2_LIMIT], f"χ² {bad:.1f}", "the χ² limit")


def llama_opener(params: dict, cfg, prompt: torch.Tensor, start: int, dev, tree32: dict,
                 fused_draft: bool = False):
    """An opener for `spec_against_f32` over a left-padded prompt (the
    Orpheus generator's bucket): kind "route" and "plain" the serving tree
    on a bf16 cache, "exact" `tree32` on an f32 cache; a plain cache (the
    target's), or with fused_draft the whole-stack step's cache, its pos
    one slot back (a draft's)."""
    from tpu_audio_torch.nn import transformer
    from tpu_audio_torch.ops import speculative as spec

    off = torch.tensor([start], device=dev)
    pad = prompt.shape[0]

    def open_(kind):
        tree = tree32 if kind == "exact" else params
        dtype = torch.float32 if kind == "exact" else torch.bfloat16
        slots = pad + SPEC_HELD_NEW * (SPEC_GAMMA + 1) + spec.loop_slots(SPEC_HELD_NEW, SPEC_GAMMA)
        cache, extra = transformer.decode_cache_and_mask(cfg, slots, start, fused_draft,
                                                         dtype=dtype, device=dev)
        lg, cache = transformer.forward(tree, cfg, prompt[None], cache, extra, pos_offset=off)
        if fused_draft:
            cache.pos -= 1

        def step(toks, c):
            lg, c = transformer.forward(tree, cfg, toks, c, extra, pos_offset=off)
            return lg.float(), c
        hist = torch.zeros((1, pad + SPEC_HELD_NEW + 2 * SPEC_GAMMA + 4), dtype=torch.int64,
                           device=dev)
        hist[0, :pad] = torch.roll(prompt, -start)
        return {"step": step, "cache": cache, "first": lg[:, -1].float().argmax(-1),
                "second": prompt[-1:], "hist": hist,
                "hist_len": torch.tensor(pad - start, device=dev)}
    return open_


def f32_tree(tree: dict) -> dict:
    from tpu_audio_torch.utils import pytree

    return pytree.unflatten({k: v.float() if v.is_floating_point() else v
                             for k, v in pytree.flatten(tree).items()})


def spec_slice(dev, card: str) -> dict:
    """Phase 15: speculative decoding on the card. Orpheus at Llama-3.2-3B
    width on its w8a8 and W4A8 trees, through `TTS.orpheus(speculative=…)`
    → `from_params` → `generate` of one sentence (SPEC_NEW tokens), by
    prompt lookup ("ngram") and by a `DraftModel` at Llama-3.2-1B width
    with the Orpheus vocabulary (w8a8, its steps on the whole-stack step):
    every call of the int8 and W4A8 matmuls (the verify's SPEC_GAMMA + 1
    rows) held against its plain version (`held_calls`), no whole-stack
    step on the target, launches, ms and tokens an iteration of the LM
    alone; CosyVoice2's Qwen2-0.5B (w8a8, phase 14's biases) through
    `TTS.cosyvoice2(speculative="ngram")` streaming one sentence of 5 words
    (100 tokens, 4 spans) at TOKEN granularity. Each route's sampled
    loop held against f32 (`spec_against_f32`) with its planted faults, and
    the accept step's marginal (`accept_marginal`). Returns the launch
    counts."""
    from tpu_audio_torch.api.tts import TTS, StreamingGranularity
    from tpu_audio_torch.codecs.s3gen import model as s3gen
    from tpu_audio_torch.codecs.s3tokenizer import model as s3tok
    from tpu_audio_torch.codecs.snac import model as snac
    from tpu_audio_torch.models.cosyvoice2 import lm as cvlm
    from tpu_audio_torch.models.orpheus import model as om
    from tpu_audio_torch.nn.transformer import TransformerConfig
    from tpu_audio_torch.ops import quant
    from tpu_audio_torch.ops.kernels import fused_step as fs
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
    from tpu_audio_torch.ops.kernels import quant_matmul as qmm
    from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm
    from tpu_audio_torch.utils.weights import ShapeRNG

    mods = (fs, i8mm, w4mm, qmm)
    total = {n: 0 for m in mods for n in m.LAUNCHES}
    int8, w4 = ("int8_matmul", "int8_matmul_stacked"), ("w4a8_matmul", "w4a8_matmul_stacked")
    cfg, gamma = om.LLAMA_3B, SPEC_GAMMA
    t0 = time.perf_counter()
    trees = orpheus_trees(dev, sg=False)
    dcfg = TransformerConfig(**{**OUTE_LLM, "vocab_size": cfg.vocab_size,
                                "tie_word_embeddings": True})
    d_bf16 = llama_params(dcfg, dev, SEED + 5)
    draft_tree = quant.requantize_tree_int8(quant.quantize_tree(d_bf16, bits=4))
    del d_bf16
    snac_cfg = snac.SNACConfig()
    snac_params = snac.init_params(SEED, snac_cfg, torch.float32, dev)
    torch.cuda.synchronize()
    log(f"models: Orpheus's Llama-3.2-3B random weights (seed {SEED}), its w8a8 and W4A8 trees; "
        f"a Llama-3.2-1B draft at the Orpheus vocabulary (w8a8); SNAC, in "
        f"{time.perf_counter() - t0:.1f} s")
    draft = om.DraftModel(draft_tree, dcfg)
    for kind in ("w8a8", "w4a8"):
        tree = trees[kind]
        route = int8 if kind == "w8a8" else w4
        for drafting, speculative in (("ngram", "ngram"), ("draft", draft)):
            tag = f"orpheus {kind} speculative {drafting}"
            eng = TTS.orpheus(speculative=speculative, gamma=gamma, device=dev).from_params(
                tree, cfg, snac_params, snac_cfg, speculative=speculative, gamma=gamma)
            need = (("int8_matmul",) if kind == "w8a8" else w4) + (
                ("fused_decode_step",) if drafting == "draft" else ())
            absent = (() if drafting == "draft" else ("fused_decode_step",)) + (
                () if kind == "w8a8" or drafting == "draft" else int8)
            with held_calls(tag, i8mm if kind == "w8a8" else w4mm, route, 1e-5):
                res, launches, wall = counted_run(
                    tag, mods, total, f"generate ({SPEC_NEW} tokens, SENTENCE)", need,
                    lambda: eng.generate(ORPHEUS_TEXTS[0], max_new_tokens=SPEC_NEW),
                    absent=absent)
            st = eng.lm.last_spec_stats
            if not (np.isfinite(res.samples).all() and st["iterations"]):
                raise AssertionError(f"{tag}: non-finite audio or no iterations: {st}")
            prompt = eng._prompt(ORPHEUS_TEXTS[0])
            reset(*mods)
            _, w = timed(lambda: eng.lm.generate_speculative(
                prompt, sampler=eng._sampler(), eos_ids=(om.END_TOKEN,), max_new=SPEC_NEW,
                gamma=gamma, draft=None if drafting == "ngram" else draft))
            st, counts = eng.lm.last_spec_stats, launch_counts(*mods)
            for n in total:
                total[n] += counts[n]
            it = st["iterations"]
            log(f"{tag}: {it} iterations, {st['accepted']} of {st['drafted']} drafts accepted, "
                f"{st['tokens_per_iteration']:.3f} tokens an iteration; the LM alone "
                f"{1e3 * w / it:.2f} ms an iteration (prefill included), launches an iteration "
                + ", ".join(f"{n} {c / it:.1f}" for n, c in counts.items() if c)
                + f" ({card})")
            del eng
        prompt_ids = om.build_prompt_ids(WordTokenizer().encode(f"tara: {ORPHEUS_TEXTS[0]}"))
        prompt, start = om.CausalLMGenerator(tree, cfg, pad_id=om.PAD_TOKEN)._prompt(prompt_ids,
                                                                                     32)
        # q and k × QK_SCALE: attention that depends on the cache's
        # positions, so that a rewind fault moves the logits; the rewind is
        # held on the w8a8 route, whose own distance from f32 is half the
        # W4A8 route's, and on each route a fault of the verify's rows
        held = sharpened(tree, cfg, QK_SCALE)
        opener = llama_opener(held, cfg, prompt, start, dev, f32_tree(held))
        mod, name = (i8mm, "int8_matmul") if kind == "w8a8" else (w4mm, "w4a8_matmul_stacked")
        kernel = getattr(mod, name)

        def row0(x, *a, kernel=kernel, **kw):  # every row of a call reads row 0's input
            return kernel(x[:1].expand(x.shape).contiguous(), *a, **kw)
        spec_against_f32(f"orpheus {kind} speculative ngram q/k x3", opener, gamma,
                         plain_mods=(fs, i8mm, w4mm), loop_faults=kind == "w8a8",
                         kernel_faults=[(f"each row of a {name} call fed row 0", mod, name,
                                         row0)])
        if kind == "w8a8":
            d_held = sharpened(draft.params, dcfg, QK_SCALE)
            spec_against_f32(f"orpheus {kind} speculative draft q/k x3", opener, gamma,
                             llama_opener(d_held, dcfg, prompt, start, dev, f32_tree(d_held),
                                          fused_draft=True), plain_mods=(fs, i8mm, w4mm))
            del d_held
        del held, opener
    del trees, draft
    torch.cuda.empty_cache()

    # ------------------------------------------------ CosyVoice2's spans
    lm_cfg, s3cfg, tokcfg = cvlm.CosyLMConfig(), s3gen.S3GenConfig(), s3tok.S3TokenizerConfig()
    _, q4 = cosy_lm_trees(lm_cfg, dev)
    tree = quant.requantize_tree_int8(q4)
    del q4
    s3 = s3_card_params(s3gen.numpy_params(ShapeRNG(), s3cfg), dev, SEED + 1)
    tokp = s3_card_params(s3tok.numpy_params(ShapeRNG(), tokcfg), dev, SEED + 2)
    tag = "cosyvoice2 w8a8 speculative ngram"
    eng = TTS.cosyvoice2(speculative="ngram", device=dev).from_params(
        tree, lm_cfg, s3, s3cfg, tokp, tokcfg, tokenizer=WordTokenizer(), speculative="ngram")
    first = {}

    def stream():
        t, chunks = time.perf_counter(), []
        for c in eng.generate_streaming(SPEC_CV_TEXT, granularity=StreamingGranularity.TOKEN):
            first.setdefault("s", time.perf_counter() - t)
            chunks.append(c)
        return chunks

    with held_calls(tag, i8mm, int8, 1e-5):
        chunks, launches, wall = counted_run(tag, mods, total, "generate_streaming (TOKEN)",
                                             ("int8_matmul",), stream,
                                             absent=("fused_decode_step",) + w4)
    st = eng.lm.last_spec_stats
    audio = np.concatenate([c.samples for c in chunks])
    if not (chunks[-1].is_final and np.isfinite(audio).all() and st["iterations"]):
        raise AssertionError(f"{tag}: {len(chunks)} chunks, spans' counters {st}")
    it = st["iterations"]
    log(f"{tag}: {len(chunks)} chunks, {len(audio) / 24000:.2f} s of audio in {wall:.3f} s "
        f"({len(audio) / 24000 / wall:.2f}x real time), first audio {first['s']:.3f} s; the "
        f"spans: {it} iterations, {st['accepted']} of {st['drafted']} drafts accepted, "
        f"{st['tokens_per_iteration']:.3f} tokens an iteration, launches an iteration "
        + ", ".join(f"{n} {c / it:.1f}" for n, c in launches.items() if c) + f" ({card})")
    gen = eng.lm
    text = WordTokenizer().encode(SPEC_CV_TEXT)
    speech = list(range(100, 175))  # a 3 s speaker's tokens
    t32 = f32_tree(tree)
    exact_gen = cvlm.CosyLMGenerator(t32, lm_cfg, cache_dtype=torch.float32)

    def cv_open(kind):
        g = exact_gen if kind == "exact" else gen
        steps = SPEC_HELD_NEW * (gamma + 1) + 64
        logits, cache, extra = g.prefill(text, [], speech, steps, fused=False)
        hist, hist_len, second = g.spec_history(speech, 96 + SPEC_HELD_NEW + 2 * gamma + 4)
        return {"step": g.target_step(extra), "cache": cache, "first": logits.argmax(-1),
                "second": second, "hist": hist, "hist_len": hist_len}

    spec_against_f32(tag, cv_open, gamma, plain_mods=(fs, i8mm))
    del eng, gen, exact_gen, t32, tree, s3, tokp
    accept_marginal(dev)
    return total


# ------------------------------------------------ 16. CosyVoice3

def cv3_o1_against_full(flow, flow_cfg, dev) -> None:
    """Phase 16: the O(1) flow (`cfm_solve_chunk` over CV3_O1_CHUNKS chunks
    aligned to static_chunk_size, each padded to a multiple of 32 as the
    synthesizer pads it, with each timestep's frozen keys and values) against
    the full-window flow (`flow.cfm_solve` with the chunk-causal masks) on
    the same mu, speaker, prompt mel and position-keyed z, both with the
    O(1) flow's left window of 2 chunks, in f32: the chunks' mels within
    rel CV3_O1_REL."""
    from dataclasses import replace

    from tpu_audio_torch.codecs.s3gen import flow as s3flow
    from tpu_audio_torch.codecs.s3gen.noise import Noise
    from tpu_audio_torch.models.cosyvoice3 import dit
    from tpu_audio_torch.models.cosyvoice3 import model as cv3

    cfg = replace(flow_cfg, dit=replace(flow_cfg.dit, num_left_chunks=2))
    params = f32_tree(flow)
    static = cfg.dit.static_chunk_size
    frames = CV3_O1_CHUNKS * static
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    toks = torch.randint(0, cfg.vocab_size, (1, frames // cfg.token_mel_ratio), generator=gen,
                         device=dev)
    emb = torch.randn((1, cfg.spk_dim), generator=gen, device=dev)
    cond = torch.zeros((1, frames, cfg.mel_dim), device=dev)
    cond[:, :static // 2] = torch.randn((1, static // 2, cfg.mel_dim), generator=gen, device=dev)
    noise = Noise(SEED)
    with torch.inference_mode():
        mu, spks = cv3._mu(params, cfg, toks, toks.shape[1], emb)
        z = noise.z((1, frames, cfg.mel_dim), dev)

        def est(x, ml, mu_, t, spks_, cond_, stream):
            return dit.forward(params["decoder_estimator"], cfg.dit, x, ml, mu_, t, spks_, cond_,
                               stream)
        whole = s3flow.cfm_solve(est, cfg.cfm, mu, torch.tensor([frames], device=dev), spks,
                                 cond, z, streaming=True)
        caches = cv3.make_flow_stream_caches(cfg, 512, device=dev)
        pad = -(-static // 32) * 32
        chunks = []
        for lo in range(0, frames, static):
            def padded(a):
                return torch.nn.functional.pad(a[:, lo:lo + static], (0, 0, 0, pad - static))
            x = cv3.cfm_solve_chunk(params, cfg, noise.z_chunk(lo, (1, pad, cfg.mel_dim), dev),
                                    padded(mu), spks, padded(cond), caches, valid_new=static)
            chunks.append(x[:, :static])
    compare(f"cosyvoice3 O(1) flow, {CV3_O1_CHUNKS} chunks of {static} frames (padded to {pad}), "
            f"against the full-window flow (f32)", torch.cat(chunks, 1), whole, rel=CV3_O1_REL)


def cosyvoice3_slice(dev, card: str) -> dict:
    """Phase 16: CosyVoice3 at the published widths on random weights
    (seed 0: `CosyLMConfig()`'s Qwen2-0.5B on the w8a8 tree with phase 14's
    biases, `CV3FlowConfig()`: the DiT 1024 × 22 of 16 heads of 64 and the
    causal HiFT, in bf16; `S3TokenizerConfig()`; the word-level stand-in
    tokenizer) through `TTS.cosyvoice3()` → `CosyVoice3Engine.from_params`
    (chunks of 25 tokens): `prepare_conditionals` on 3 s of noise,
    `generate_streaming` of two sentences at TOKEN granularity (first audio,
    × real time; the whole-stack step a T=1 step and the head's
    `int8_matmul` asserted), `voice_conversion` of 2 s; the LM held against
    f32 with its planted faults (`cv_against_f32`); the O(1) flow against
    the full window (`cv3_o1_against_full`); the flow's ms a chunk on both
    policies and HiFT's (CUDA events); the drift of the O(1) flow's chunk
    times over CV3_DRIFT_CHUNKS chunks (reported, not gated: host clock).
    Returns the launch counts."""
    from tpu_audio_torch.api.tts import TTS
    from tpu_audio_torch.codecs.s3gen import hift
    from tpu_audio_torch.codecs.s3gen.noise import Noise
    from tpu_audio_torch.codecs.s3tokenizer import model as s3tok
    from tpu_audio_torch.models.cosyvoice2 import lm as cvlm
    from tpu_audio_torch.models.cosyvoice3 import model as cv3
    from tpu_audio_torch.ops import quant
    from tpu_audio_torch.ops.kernels import fused_step as fs
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
    from tpu_audio_torch.ops.kernels import quant_matmul as qmm
    from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm
    from tpu_audio_torch.utils.weights import ShapeRNG

    mods = (fs, i8mm, w4mm, qmm)
    total = {n: 0 for m in mods for n in m.LAUNCHES}
    others = tuple(n for m in (w4mm, qmm) for n in m.LAUNCHES)
    lm_cfg, flow_cfg, tokcfg = cvlm.CosyLMConfig(), cv3.CV3FlowConfig(), s3tok.S3TokenizerConfig()
    t0 = time.perf_counter()
    _, q4 = cosy_lm_trees(lm_cfg, dev)
    tree = quant.requantize_tree_int8(q4)
    del q4
    flow = s3_card_params(cv3.numpy_params(ShapeRNG(), flow_cfg), dev, SEED + 5)
    tokp = s3_card_params(s3tok.numpy_params(ShapeRNG(), tokcfg), dev, SEED + 2)
    torch.cuda.synchronize()
    log(f"models: CosyVoice3's Qwen2-0.5B random weights (seed {SEED}), its w8a8 tree; the DiT "
        f"flow ({flow_cfg.dit.dim} x {flow_cfg.dit.depth}, {flow_cfg.dit.heads} heads of "
        f"{flow_cfg.dit.head_dim}) and HiFT in bf16; the S3 tokenizer, in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    ref24 = (0.1 * rng.standard_normal(CV_REF_SECONDS * 24000)).astype(np.float32)
    src16 = (0.1 * rng.standard_normal(CV_VC_SECONDS * 16000)).astype(np.float32)
    tag = "cosyvoice3 w8a8"
    eng = TTS.cosyvoice3(device=dev).from_params(tree, lm_cfg, flow, flow_cfg, tokp, tokcfg,
                                                 tokenizer=WordTokenizer(), chunk=cv3.CHUNK_SIZE)
    spk, _, _ = counted_run(tag, mods, total, f"prepare_conditionals ({CV_REF_SECONDS} s)", (),
                            lambda: eng.prepare_conditionals(ref24, 24000, ref_text=CV_REF_TEXT),
                            absent=tuple(total))
    if not (len(spk.speech_tokens) == 25 * CV_REF_SECONDS
            and spk.prompt_mel.shape[1] == 2 * len(spk.speech_tokens)):
        raise AssertionError(f"{tag} speaker: {len(spk.speech_tokens)} tokens, mel "
                             f"{tuple(spk.prompt_mel.shape)}")
    steps = {"n": 0}
    make = eng.lm.step_fn

    def counted(extra):
        step = make(extra)

        def run(tok, cache):
            steps["n"] += 1
            return step(tok, cache)
        return run

    eng.lm.step_fn = counted
    first = {}

    def stream():
        t, chunks = time.perf_counter(), []
        for c in eng.generate_streaming(" ".join(CV3_STREAM_TEXTS)):
            first.setdefault("s", time.perf_counter() - t)
            chunks.append(c)
        return chunks

    chunks, launches, wall = counted_run(tag, mods, total,
                                         "generate_streaming (2 sentences, TOKEN)",
                                         ("fused_decode_step", "int8_matmul"), stream,
                                         absent=others)
    want = {"fused_decode_step": steps["n"], "int8_matmul": steps["n"] + 2}
    audio = np.concatenate([c.samples for c in chunks])
    seconds = len(audio) / 24000
    if (not chunks[-1].is_final or len(chunks) < 4 or not np.isfinite(audio).all()
            or any(launches[n] != c for n, c in want.items())):
        raise AssertionError(f"{tag} stream: {len(chunks)} chunks, {steps['n']} T=1 steps, "
                             f"launches {launches}, want {want}")
    log(f"{tag} stream: {len(chunks)} chunks, {steps['n']} T=1 steps = "
        f"{launches['fused_decode_step']} fused_decode_step launches (one a step), "
        f"{launches['int8_matmul']} int8_matmul (the head a step + 2 prefills); first audio "
        f"after {first['s']:.3f} s; {seconds:.2f} s of audio in {wall:.3f} s: "
        f"{seconds / wall:.2f}x real time ({card})")
    eng.lm.step_fn = make
    vc, _, wall = counted_run(tag, mods, total, f"voice_conversion ({CV_VC_SECONDS} s)", (),
                              lambda: eng.voice_conversion(src16, 16000), absent=tuple(total))
    if len(vc) != CV_VC_SECONDS * 24000 or not np.isfinite(vc).all():
        raise AssertionError(f"{tag} voice_conversion: {len(vc)} samples")
    log(f"{tag} voice_conversion: {CV_VC_SECONDS} s in {wall:.3f} s ({card})")
    prompt = (eng.tokenizer.encode(CV3_STREAM_TEXTS[0]), spk.prompt_text_ids, spk.speech_tokens)
    cv_against_f32(tag, tree, lm_cfg, dev, True, prompt)
    del eng, tree
    torch.cuda.empty_cache()

    cv3_o1_against_full(flow, flow_cfg, dev)
    # the flow's ms a chunk: the full window at the second chunk of a stream
    # from a 3 s speaker (75 + 50 + 3 tokens), one O(1) chunk of 50 frames
    # (padded to 64) on caches primed over the window before it, HiFT's
    # window of 32 + 50 frames
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    p_len, n_tok = 75, 75 + 50 + cv3.PRE_LOOKAHEAD
    toks = torch.randint(0, flow_cfg.vocab_size, (1, -(-n_tok // 32) * 32), generator=gen,
                         device=dev)
    pm = torch.randn((1, 2 * p_len, flow_cfg.mel_dim), generator=gen, device=dev)
    emb = torch.randn((1, flow_cfg.spk_dim), generator=gen, device=dev).to(torch.bfloat16)
    synth = cv3.CV3Synthesizer(flow, flow_cfg, o1_flow=True)
    ocfg = synth.o1_cfg
    with torch.inference_mode():
        ms_full = events_ms(lambda: cv3.flow_chunk(flow, flow_cfg, toks, n_tok, pm, 2 * p_len,
                                                   emb, Noise(SEED), True), 2)
        mu, spks = synth._mu_window(toks, n_tok, emb, 0, 2 * n_tok + 64, 2 * n_tok)
        caches = cv3.make_flow_stream_caches(ocfg, 512, device=dev)
        lo = 2 * (p_len + 25)
        z = Noise(SEED).z_chunk(0, (1, lo, flow_cfg.mel_dim), dev)
        cv3.cfm_solve_chunk(flow, ocfg, z, mu[:, :lo], spks, torch.zeros_like(z).to(mu.dtype),
                            caches, valid_new=lo)

        def one_chunk():
            keep = caches.pos.clone()
            z1 = Noise(SEED).z_chunk(lo, (1, 64, flow_cfg.mel_dim), dev)
            out = cv3.cfm_solve_chunk(flow, ocfg, z1, mu[:, lo:lo + 64], spks,
                                      torch.zeros_like(z1).to(mu.dtype), caches, valid_new=50)
            caches.pos.copy_(keep)
            return out
        ms_o1 = events_ms(one_chunk, 2)
        lb, new = hift.LOOKBACK_FRAMES, 50
        win = torch.randn((1, lb + new, flow_cfg.mel_dim), generator=gen, device=dev).to(
            torch.bfloat16)
        phase = torch.zeros((1, flow_cfg.hift.nb_harmonics + 1), dtype=torch.float64, device=dev)
        tail = torch.zeros((1, lb * flow_cfg.hift.upsample_scale), dtype=win.dtype, device=dev)
        ms_voc = events_ms(lambda: hift.vocode_window(flow["mel2wav"], flow_cfg.hift, win,
                                                      Noise(SEED), phase, tail, 100), 2)
    log(f"cosyvoice3 flow: the full window {ms_full:.2f} ms a chunk ({n_tok} tokens, "
        f"{flow_cfg.cfm.n_timesteps} CFG Euler steps), the O(1) flow {ms_o1:.2f} ms a chunk "
        f"(50 frames padded to 64, 512 cached slots); HiFT {ms_voc:.2f} ms a chunk ({lb} + {new} "
        f"frames) (CUDA events, bf16) ({card})")

    # drift: the O(1) flow's chunk times over CV3_DRIFT_CHUNKS chunks of 25 tokens
    token_chunks = [torch.randint(3, flow_cfg.vocab_size, (cv3.CHUNK_SIZE,), generator=gen,
                                  device=dev).tolist() for _ in range(CV3_DRIFT_CHUNKS)]
    prompt_tokens = torch.randint(3, flow_cfg.vocab_size, (p_len,), generator=gen,
                                  device=dev).tolist()
    stamps, t = [], time.perf_counter()
    for audio in synth.stream(iter(token_chunks), prompt_tokens, pm, emb,
                              chunk_size=cv3.CHUNK_SIZE):
        now = time.perf_counter()
        stamps.append(now - t)
        t = now
        if not np.isfinite(audio).all():
            raise AssertionError("cosyvoice3 O(1) stream: non-finite audio")
    half = len(stamps) // 2
    ratio = float(np.median(stamps[half:]) / np.median(stamps[:half]))
    log(f"cosyvoice3 O(1) flow drift over {len(stamps)} chunks of {cv3.CHUNK_SIZE} tokens: "
        f"median chunk {1e3 * np.median(stamps[:half]):.1f} ms (first half), "
        f"{1e3 * np.median(stamps[half:]):.1f} ms (second half), ratio {ratio:.3f} (ROADMAP "
        f"asks ≤ 1.05; host clock, not gated) ({card})")
    return total


# ------------------------------------------------ 17. Chatterbox, Chatterbox Turbo

def chatterbox_trees(dev, bits=(4, 8)) -> dict:
    """The two T3s at full width on random weights drawn on the card (seed
    0): Chatterbox's Llama-520M (`T3Config()`) and Turbo's GPT-2 medium
    (`T3TurboConfig()`, a bias on every linear as the published GPT-2 has),
    each as {"bf16": …, "q4": …, "q8": …}: the group-affine trees of group
    64, their scales and biases rounded to bf16 as the 4bit/8bit repos store
    them, the position tables kept bf16."""
    import dataclasses

    from tpu_audio_torch.models.chatterbox import t3
    from tpu_audio_torch.models.chatterbox_turbo import model as turbo
    from tpu_audio_torch.ops import quant
    from tpu_audio_torch.utils.weights import ShapeRNG

    def keep(k, v):
        return "pos_emb" not in k and not k.startswith("wpe")

    tcfg = turbo.T3TurboConfig()
    biased = dataclasses.replace(tcfg, gpt2=dataclasses.replace(
        tcfg.gpt2, attn_qkv_bias=True, attn_o_bias=True))
    out = {}
    for name, schema, seed in (("chatterbox", t3.numpy_params(ShapeRNG(), t3.T3Config()), SEED),
                               ("turbo", turbo.numpy_params(ShapeRNG(), biased), SEED + 5)):
        bf16 = card_params(schema, dev, seed)
        out[name] = {"bf16": bf16, **{f"q{b}": bf16_affine(quant.quantize_tree(
            bf16, bits=b, predicate=keep)) for b in bits}}
    return out


def t3_forced(gen, cond_fn, ids: list[int], steps: int, forced=None, turbo: bool = False):
    """T3's logits (1 + steps, V) f32: the prefill's (CFG-merged for
    Chatterbox), then `steps` T=1 steps, each fed forced[i] or the argmax
    of the logits before."""
    with torch.inference_mode():
        cond = cond_fn(gen.params)
        if turbo:
            logits, cache, extra, total = gen.prefill(cond, ids, steps + 1)
            step = gen.step_fn(extra, len(ids), total)
        else:
            logits, cache, extra, total = gen.prefill(cond, ids, steps + 1, 0.5)
            step = gen.step_fn(extra, total, 0.5)
        out = [logits]
        for i in range(steps):
            tok = out[-1].argmax(-1) if forced is None else forced[i]
            logits, cache = step(tok.reshape(1, 1), cache)
            out.append(logits)
        return torch.cat(out)


def t3_against_f32(tag: str, make_gen, tree: dict, cfg, cond_fn, inputs: dict, controls,
                   turbo: bool = False) -> None:
    """Phase 17, a T3 on the q4 tree held against f32 through its
    teacher-forced logits (CFG-merged for Chatterbox): the prefill and
    CB_HELD_STEPS steps, each fed the f32 path's greedy token, on each input
    of `inputs` ({label: text ids}). The route runs the tree as served (f32
    activations from its q4 tables, its fp leaves bf16, a bf16 cache) with
    `quant_matmul`; the reference is the per-op path with every float leaf
    in f32, an f32 cache and the plain products; the route's plain version
    is the yardstick. Each control (label, input, patch) must land at least
    CV_FAULT_RATIO times as far from f32 as the yardstick."""
    from tpu_audio_torch.ops.kernels import quant_matmul as qmm

    steps = CB_HELD_STEPS
    exact_gen = make_gen(f32_tree(tree), torch.float32)
    route_gen = make_gen(tree, torch.bfloat16)
    held = {}
    for name, ids in inputs.items():
        with plain_kernels(qmm):
            exact = t3_forced(exact_gen, cond_fn, ids, steps, turbo=turbo)
            forced = exact[:-1].argmax(-1)
            plain = t3_forced(route_gen, cond_fn, ids, steps, forced, turbo)
        parts = [exact[:1], exact[1:]]
        p_err, p_cos = zip(*[measure(pl, ex)[1:] for pl, ex in zip((plain[:1], plain[1:]),
                                                                  parts)])
        outputs = (f"prefill logits (1, {exact.shape[-1]})",
                   f"step logits ({steps}, {exact.shape[-1]})")
        reset(qmm)
        got = t3_forced(route_gen, cond_fn, ids, steps, forced, turbo)
        launches = qmm.LAUNCHES["quant_matmul"]
        log(f"{tag} {name}: plain route against f32 rel {p_err[0]:.3e} / {p_err[1]:.3e}, "
            f"cosine {p_cos[0]:.6f} / {p_cos[1]:.6f}; the route {launches} quant_matmul")
        if not launches:
            raise AssertionError(f"{tag} {name}: the route launched no quant_matmul")
        held_against_f32(f"{tag} {name}", outputs, parts, p_err, "kernels", [got[:1], got[1:]],
                         control=False, p_cos=p_cos)
        held[name] = (outputs, parts, p_err, p_cos, forced)
    for label, name, patch in controls:
        outputs, parts, p_err, p_cos, forced = held[name]
        with patch():
            out = t3_forced(route_gen, cond_fn, inputs[name], steps, forced, turbo)
        held_against_f32(f"{tag} {name}", outputs, parts, p_err, label, [out[:1], out[1:]],
                         control=True, p_cos=p_cos)


def ve_against_f32(ve_params: dict, vecfg, audio16: np.ndarray) -> None:
    """The voice encoder's embedding as served (bf16 weights and LSTM)
    against f32 weights and activations on the same 16 kHz clip; the LSTMs
    with their i and f gates swapped (the first two H-row blocks of every
    gate weight and bias exchanged) must land CV_FAULT_RATIO times as far."""
    from tpu_audio_torch.models.chatterbox import voice_encoder as ve

    hid = vecfg.ve_hidden_size

    def swap(w):
        return torch.cat([w[hid: 2 * hid], w[:hid], w[2 * hid:]])
    swapped = dict(ve_params, lstm={i: {k: swap(v) for k, v in p.items()}
                                    for i, p in ve_params["lstm"].items()})
    with torch.inference_mode():
        exact = ve.embed_utterance(f32_tree(ve_params), vecfg, audio16)
        plain = ve.embed_utterance(ve_params, vecfg, audio16)
        fault = ve.embed_utterance(swapped, vecfg, audio16)
    _, p_err, p_cos = measure(plain, exact)
    outputs = (f"speaker embedding ({exact.shape[0]},)",)
    log(f"chatterbox voice encoder: bf16 against f32 rel {p_err:.3e}, cosine {p_cos:.6f}")
    held_against_f32("chatterbox voice encoder", outputs, [exact], [p_err], "LSTM i and f "
                     "gates swapped", [fault], control=True, p_cos=[p_cos])


def meanflow_against_f32(s3t: dict, s3cfg, dev) -> None:
    """Turbo's meanflow flow (2 Euler steps, no CFG) on a window of
    CB_FLOW_TOKENS, as served (bf16) against f32, on a tree whose time MLP
    and mixer are × CB_TIME_SCALE (random weights leave the velocity almost
    blind to t; here the time terms matter). Planted: the mixer fed (t, t)
    in place of (t, r), and a cosine-warped t grid; each must land
    CV_FAULT_RATIO times as far from f32 as the served flow."""
    from tpu_audio_torch.codecs.s3gen import flow as s3flow
    from tpu_audio_torch.codecs.s3gen.noise import Noise
    from tpu_audio_torch.models.chatterbox_turbo import streaming as tstreaming

    est = s3t["flow"]["decoder_estimator"]
    scaled = {**est, "time_mlp": {k: {n: v * CB_TIME_SCALE for n, v in lin.items()}
                                  for k, lin in est["time_mlp"].items()},
              "time_embed_mixer": {n: v * CB_TIME_SCALE
                                   for n, v in est["time_embed_mixer"].items()}}
    tree = dict(s3t, flow=dict(s3t["flow"], decoder_estimator=scaled))
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    p_len, n = CB_FLOW_TOKENS
    pt = torch.randint(0, s3cfg.vocab_size, (1, p_len), generator=gen, device=dev)
    toks = torch.randint(0, s3cfg.vocab_size, (1, n), generator=gen, device=dev)
    pm = torch.randn((1, 2 * p_len, s3cfg.mel_dim), generator=gen, device=dev)
    emb = torch.randn((1, s3cfg.spk_dim), generator=gen, device=dev)

    def mel(t_):
        with torch.inference_mode():
            return tstreaming.meanflow_mel(t_, s3cfg, toks, n, pt, p_len, pm, 2 * p_len, emb,
                                           Noise(SEED))

    exact, plain = mel(f32_tree(tree)), mel(tree)
    _, p_err, p_cos = measure(plain, exact)
    log(f"turbo meanflow: bf16 against f32 rel {p_err:.3e}, cosine {p_cos:.6f} ({p_len} "
        f"prompt + {n} tokens, time terms × {CB_TIME_SCALE})")
    forward = s3flow.estimator_forward

    def t_for_r(*a, r=None, **kw):
        return forward(*a, r=None if r is None else a[5], **kw)

    def cosine(est_fn, mu, ml, spks, cond, z, n_timesteps=2, streaming=False):
        ts = 1 - torch.cos(torch.linspace(0.0, 1.0, n_timesteps + 1, device=mu.device)
                           * 0.5 * torch.pi)
        x, b = z.to(mu.dtype), mu.shape[0]
        for i in range(n_timesteps):
            v = est_fn(x, ml, mu, ts[i].to(mu.dtype).expand(b), spks, cond, streaming,
                       ts[i + 1].to(mu.dtype).expand(b))
            x = (x.float() + (ts[i + 1] - ts[i]) * v.float()).to(x.dtype)
        return x

    outputs = (f"mel {tuple(exact.shape)}",)
    for label, obj, name, fn in (("the mixer fed (t, t)", s3flow, "estimator_forward", t_for_r),
                                 ("a cosine-warped t grid", tstreaming, "meanflow_inference",
                                  cosine)):
        with patched(obj, name, fn):
            fault = mel(tree)
        held_against_f32("turbo meanflow", outputs, [exact], [p_err], label, [fault],
                         control=True, p_cos=[p_cos])


def chatterbox_slice(dev, card: str) -> dict:
    """Phase 17: Chatterbox and Chatterbox Turbo at full width on random
    weights (seed 0: `T3Config()`'s Llama-520M and `T3TurboConfig()`'s GPT-2
    medium on their bf16, q4 and q8 trees, `S3GenConfig()` (Turbo's with
    the meanflow estimator), `S3TokenizerConfig()`, `VoiceEncConfig()`; a
    word-level stand-in for each text tokenizer) through `TTS.chatterbox()`
    → `ChatterboxEngine.from_params` and `TTS.chatterbox_turbo()` →
    `from_turbo_params` on the q4 trees: `prepare_conditionals` on a
    CB_REF_SECONDS clip (its wall), one sentence streamed by each engine
    (first audio, × real time; Turbo at SENTENCE and TOKEN granularity),
    every `quant_matmul` call of a short generate on each T3 and tree held
    against its plain version (`held_calls`), the T3s on the q4 tree, the
    voice encoder and Turbo's meanflow flow held against f32 with planted
    controls, each T3's ms a token on each tree and `quant_matmul` launches
    a step, the flows' and HiFT's ms by CUDA events. Returns the launch
    counts."""
    import dataclasses

    from tpu_audio_torch.api.tts import TTS, StreamingGranularity
    from tpu_audio_torch.codecs.s3gen import hift
    from tpu_audio_torch.codecs.s3gen import model as s3gen
    from tpu_audio_torch.codecs.s3gen.noise import Noise
    from tpu_audio_torch.codecs.s3tokenizer import model as s3tok
    from tpu_audio_torch.models.chatterbox import t3
    from tpu_audio_torch.models.chatterbox import voice_encoder as ve
    from tpu_audio_torch.models.chatterbox_turbo import model as turbo
    from tpu_audio_torch.models.chatterbox_turbo import streaming as tstreaming
    from tpu_audio_torch.ops.kernels import quant_matmul as qmm
    from tpu_audio_torch.utils.weights import ShapeRNG

    total = {n: 0 for n in qmm.LAUNCHES}
    cfg, tcfg = t3.T3Config(), turbo.T3TurboConfig()
    s3cfg, tokcfg, vecfg = s3gen.S3GenConfig(), s3tok.S3TokenizerConfig(), ve.VoiceEncConfig()
    s3tcfg = dataclasses.replace(s3cfg, estimator=dataclasses.replace(s3cfg.estimator,
                                                                      meanflow=True))
    t0 = time.perf_counter()
    trees = chatterbox_trees(dev)
    s3 = s3_card_params(s3gen.numpy_params(ShapeRNG(), s3cfg), dev, SEED + 1)
    s3t = s3_card_params(s3gen.numpy_params(ShapeRNG(), s3tcfg), dev, SEED + 6)
    tokp = s3_card_params(s3tok.numpy_params(ShapeRNG(), tokcfg), dev, SEED + 2)
    vep = card_params(ve.numpy_params(ShapeRNG(), vecfg), dev, SEED + 3)
    torch.cuda.synchronize()
    log(f"models: Chatterbox's T3 (Llama-520M, {cfg.llama.n_layers} layers) and Turbo's "
        f"(GPT-2 medium, {tcfg.gpt2.n_layers} layers) random bf16 weights (seed {SEED}), their "
        f"q4 and q8 trees; S3Gen (CFG and meanflow), the S3 tokenizer, CAMPPlus and the voice "
        f"encoder at full width in bf16, in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 17)
    ref24 = (0.1 * rng.standard_normal(CB_REF_SECONDS * 24000)).astype(np.float32)
    eng = TTS.chatterbox(device=dev).from_params(trees["chatterbox"]["q4"], cfg, s3, s3cfg,
                                                 tokp, tokcfg, vep, vecfg,
                                                 tokenizer=WordTokenizer(cfg.text_tokens_dict_size))
    teng = TTS.chatterbox_turbo(device=dev).from_turbo_params(
        trees["turbo"]["q4"], tcfg, s3t, s3tcfg, tokp, tokcfg, vep, vecfg,
        tokenizer=WordTokenizer(tcfg.text_tokens_dict_size))

    # ------------------------------------------------ the speaker
    cond, _, wall = counted_run("chatterbox", (qmm,), total,
                                f"prepare_conditionals ({CB_REF_SECONDS} s)", (),
                                lambda: eng.prepare_conditionals(ref24, 24000),
                                absent=("quant_matmul",))
    if not (cond.t3_cond_tokens.shape == (1, 150) and cond.prompt_tokens.shape == (1, 250)
            and cond.prompt_mel.shape == (1, 500, s3cfg.mel_dim)
            and abs(float(cond.speaker_emb.float().norm()) - 1) < 1e-2
            and torch.isfinite(cond.embedding).all()):
        raise AssertionError(f"chatterbox speaker: tokens {tuple(cond.t3_cond_tokens.shape)} / "
                             f"{tuple(cond.prompt_tokens.shape)}, mel "
                             f"{tuple(cond.prompt_mel.shape)}")
    log(f"chatterbox prepare_conditionals: {wall:.3f} s wall for a {CB_REF_SECONDS} s "
        f"reference (S3 tokens of 6 s and 10 s, S3Gen's prompt mel, CAMPPlus, the voice "
        f"encoder over {(CB_REF_SECONDS * 100 + 1 - 160) // 80 + 1} partials) ({card})")
    teng.conditionals = cond

    # ------------------------------------------------ one sentence each
    def stream(engine, granularity):
        first, chunks = {}, []
        t_ = time.perf_counter()
        for c in engine.generate_streaming(CB_TEXT, granularity=granularity,
                                           max_new_tokens=CB_MAX_NEW):
            first.setdefault("s", time.perf_counter() - t_)
            chunks.append(c)
        return chunks, first["s"]

    for tag, engine, grans in (("chatterbox", eng, (StreamingGranularity.SENTENCE,)),
                               ("turbo", teng, (StreamingGranularity.SENTENCE,
                                                StreamingGranularity.TOKEN))):
        for gran in grans:
            (chunks, first), launches, wall = counted_run(
                tag, (qmm,), total, f"generate_streaming (1 sentence, {gran.value.upper()}, "
                f"≤ {CB_MAX_NEW} tokens, q4)", ("quant_matmul",),
                lambda engine=engine, gran=gran: stream(engine, gran))
            audio = np.concatenate([c.samples for c in chunks])
            if not (chunks[-1].is_final and len(audio) and np.isfinite(audio).all()):
                raise AssertionError(f"{tag} stream: {len(chunks)} chunks, {len(audio)} samples")
            log(f"{tag} stream ({gran.value}): {len(chunks)} chunks, first audio after "
                f"{first:.3f} s; {len(audio) / 24000:.2f} s of audio in {wall:.3f} s: "
                f"{len(audio) / 24000 / wall:.2f}× real time; {launches['quant_matmul']} "
                f"quant_matmul launches ({card})")

    # ------------------------------------------------ every quant_matmul call held
    ids = eng.text_ids(CB_TEXT)
    tids = teng.text_ids(CB_TEXT)
    with torch.inference_mode():
        cond_emb = {k: t3.prepare_conditioning(tree, cfg, cond.speaker_emb, cond.t3_cond_tokens,
                                               0.5) for k, tree in trees["chatterbox"].items()}
    gens = {("chatterbox", k): t3.T3Generator(tree, cfg) for k, tree in
            trees["chatterbox"].items()}
    gens.update({("turbo", k): turbo.T3TurboGenerator(tree, tcfg) for k, tree in
                 trees["turbo"].items()})

    def generate(name, kind, n):
        g = gens[(name, kind)]
        if name == "chatterbox":
            return g.generate(cond_emb[kind], ids, max_new=n)
        return g.generate(cond.speaker_emb, tids, max_new=n)

    for name, kind in itertools.product(("chatterbox", "turbo"), ("q4", "q8")):
        tag = f"{name} {kind}"
        with held_calls(tag, qmm, ("quant_matmul",), 1e-4):
            counted_run(tag, (qmm,), total, f"generate ({CB_HELD_NEW} tokens), each "
                        "quant_matmul call held", ("quant_matmul",),
                        lambda name=name, kind=kind: generate(name, kind, CB_HELD_NEW))

    # ------------------------------------------------ against f32
    spk, ctoks = cond.speaker_emb, cond.t3_cond_tokens

    def cb_cond(params):
        return t3.prepare_conditioning(params, cfg, spk, ctoks, 0.5)

    def turbo_cond(params):
        return spk

    def self_pass_skipped(p, h, heads=t3.PERCEIVER_HEADS):
        q0 = p["pre_attention_query"].to(h.dtype).expand(h.shape[0], -1, -1)
        return t3.attn_block(p["attn"], q0, h, heads)

    merge, wpe = t3.cfg_merge, turbo.T3TurboGenerator.wpe
    t3_against_f32(
        "chatterbox q4", lambda tree, dt: t3.T3Generator(tree, cfg, cache_dtype=dt),
        trees["chatterbox"]["q4"], cfg, cb_cond, {"sentence": ids,
                                                 "short text": ids[:CB_SHORT_IDS]},
        [("CFG sign flipped", "sentence", lambda: patched(
            t3, "cfg_merge", lambda lg, w: merge(lg, -w))),
         ("the unconditional row's text kept", "sentence", lambda: patched(
             t3, "cfg_text_rows", lambda e: torch.cat([e, e]))),
         ("the pad mask dropped", "short text", lambda: patched(
             t3, "pad_mask", lambda slots, shift, d: torch.zeros((1, 1, 1, slots), device=d))),
         ("the perceiver's self pass skipped", "sentence", lambda: patched(
             t3, "_perceiver", self_pass_skipped))])
    t3_against_f32(
        "turbo q4", lambda tree, dt: turbo.T3TurboGenerator(tree, tcfg, cache_dtype=dt),
        trees["turbo"]["q4"], tcfg, turbo_cond, {"sentence": tids},
        [("positions one late", "sentence", lambda: patched(
            turbo.T3TurboGenerator, "wpe", lambda self, pos: wpe(self, pos + 1)))], turbo=True)
    ve_against_f32(vep, vecfg, (0.1 * rng.standard_normal(CB_REF_SECONDS * 16000))
                   .astype(np.float32))
    meanflow_against_f32(s3t, s3tcfg, dev)

    # ------------------------------------------------ T3 alone: ms a token, launches a step
    for (name, kind), g in gens.items():
        steps = {"n": 0}
        make = g.step_fn

        def counted(*a, make=make, steps=steps):
            step = make(*a)

            def run(tok, cache):
                steps["n"] += 1
                return step(tok, cache)
            return run
        g.step_fn = counted
        walls = {}
        for n in CB_TIMED_NEW + CB_TIMED_NEW:
            steps["n"] = 0
            _, w = timed(lambda n=n: generate(name, kind, n))
            walls.setdefault(n, []).append((w, steps["n"]))
        g.step_fn = make
        lo, hi = CB_TIMED_NEW
        runs = [1e3 * (b[0] - a[0]) / max(b[1] - a[1], 1) for a, b in zip(walls[lo], walls[hi])]
        per_step = ""
        if kind != "bf16":
            with torch.inference_mode():
                if name == "chatterbox":
                    _, cache, extra, total_ = g.prefill(cond_emb[kind], ids, 4, 0.5)
                    step = g.step_fn(extra, total_, 0.5)
                    layer_linears = 7
                    nl = cfg.llama.n_layers
                else:
                    _, cache, extra, total_ = g.prefill(spk, tids, 4)
                    step = g.step_fn(extra, len(tids), total_)
                    layer_linears = 6
                    nl = tcfg.gpt2.n_layers
                reset(qmm)
                step(torch.zeros((1, 1), dtype=torch.int64, device=dev), cache)
                torch.cuda.synchronize()
                n_step = qmm.LAUNCHES["quant_matmul"]
            want = nl * layer_linears + 1
            if n_step != want:
                raise AssertionError(f"{name} {kind}: {n_step} quant_matmul launches a step, "
                                     f"want {want}")
            per_step = f", {n_step} quant_matmul launches a step ({nl} × {layer_linears} + head)"
        rows = 2 if name == "chatterbox" else 1
        log(f"{name} T3 {kind} alone, B={rows}: ms a token {', '.join(f'{r:.3f}' for r in runs)} "
            f"(generate of {hi} against {lo} tokens, twice){per_step} ({card})")

    # ------------------------------------------------ the flows and HiFT
    p_len, n_tok = cond.prompt_tokens.shape[1], CB_MAX_NEW
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    toks = torch.randint(0, s3cfg.vocab_size, (1, n_tok), generator=gen, device=dev)
    with torch.inference_mode():
        def cfg_flow():
            return s3gen.flow_inference(s3, s3cfg, toks, n_tok, cond.prompt_tokens, p_len,
                                        cond.prompt_mel, 2 * p_len, cond.embedding,
                                        Noise(SEED))[0]

        def mean_flow():
            return tstreaming.meanflow_mel(s3t, s3tcfg, toks, n_tok, cond.prompt_tokens, p_len,
                                           cond.prompt_mel, 2 * p_len, cond.embedding,
                                           Noise(SEED))
        mel = cfg_flow()
        ms_cfg, ms_mean = events_ms(cfg_flow, 2), events_ms(mean_flow, 2)
        ms_voc = events_ms(lambda: hift.generate(s3["mel2wav"], s3cfg.hift, mel, Noise(SEED)), 2)
    if not torch.isfinite(mel).all():
        raise AssertionError("chatterbox flow: non-finite mel")
    log(f"S3Gen ({p_len} prompt + {n_tok} tokens, {mel.shape[1]} frames): CFG flow "
        f"{ms_cfg:.2f} ms ({s3cfg.cfm.n_timesteps} Euler steps at batch 2), meanflow "
        f"{ms_mean:.2f} ms (2 steps, no CFG), HiFT {ms_voc:.2f} ms (CUDA events, bf16) ({card})")
    return total


# ------------------------------------------------------------------ 18. Kokoro

def kokoro_params(dev, seed: int = SEED) -> dict:
    """`KokoroConfig()` at full width (82M) from the port's `init_params`
    (a numpy seed), f32 on `dev`, with two changes: duration_proj's bias
    set to KOKORO_DUR_BIAS (random weights otherwise speak ~25 frames a
    token, 50 sigmoids near 0.5: ~7× slower than speech), and the LSTMs'
    biases drawn uniform in ±1/√H as torch draws them (the JAX init's
    zeros leave a zero input's state at zero, so that a backward pass
    started in the padding could not be told from one started at the last
    valid frame)."""
    from tpu_audio_torch.models.kokoro import model as km
    from tpu_audio_torch.models.kokoro.config import KokoroConfig
    from tpu_audio_torch.utils import pytree

    params = km.init_params(seed, KokoroConfig(), torch.float32, dev)
    params["predictor"]["duration_proj"]["bias"].fill_(KOKORO_DUR_BIAS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for k, v in pytree.flatten(params).items():
        if k.endswith((".bias_ih", ".bias_hh")):
            v.copy_((torch.rand(v.shape, generator=gen, device=dev) * 2 - 1)
                    / math.sqrt(v.shape[0] // 4))
    return params


def kokoro_faults() -> list:
    """Phase 18's planted faults, [(label, stage, tree_fn, patch)]: a stage
    1 fault is read on d and t_en, a stage 2 fault on F0, N and the audio;
    `tree_fn` makes the faulty tree, `patch` (obj, name, fn) replaces a
    function while the stage runs."""
    from tpu_audio_torch.models.kokoro import model as km
    from tpu_audio_torch.nn import layers, lstm
    from tpu_audio_torch.utils import pytree

    instance_norm, alignment, generator = (layers.masked_instance_norm, km.alignment_matrix,
                                           km.generator)

    def pool_swapped(tree):
        """Every pool's weight_v and weight_g (I, O, K) read as (O, I, K):
        the generic conversion's (2, 1, 0) in place of (1, 2, 0)."""
        return pytree.unflatten({k: v.permute(1, 0, 2) if ".pool.weight_" in k else v
                                 for k, v in pytree.flatten(tree).items()})

    def bwd_from_tail(p, x, valid_len):
        out = torch.cat([lstm.lstm(p["fwd"], x), lstm.lstm(p["bwd"], x, reverse=True)], dim=-1)
        return layers.zero_pad_tail(out, valid_len)

    def stats_over_padding(x, valid_len, eps=1e-5):
        return layers.zero_pad_tail(instance_norm(x, x.shape[-2], eps), valid_len)

    def one_frame_late(durations, total_frames, dtype=torch.float32):
        a = alignment(durations, total_frames, dtype)
        return torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], dim=1)

    def norm_per_output(p, x, stride, padding):
        q = {"weight": layers.weight_norm(p["weight_v"], p["weight_g"], (0, 2)).to(x.dtype),
             "bias": p["bias"]}
        return layers.conv_transpose1d(q, x, stride=stride, padding=padding)

    def ups_norm_per_output(*a, **k):
        with patched(km, "wn_conv_transpose", norm_per_output):
            return generator(*a, **k)

    return [("pool's I and O swapped", 2, pool_swapped, None),
            ("the BiLSTM's backward direction from the padded tail", 1, None,
             (lstm, "masked_bilstm", bwd_from_tail)),
            ("instance-norm statistics over the padded frames", 2, None,
             (layers, "masked_instance_norm", stats_over_padding)),
            ("the alignment one frame late", 2, None, (km, "alignment_matrix", one_frame_late)),
            ("ups' weight norm per output channel, g's stored orientation, not per input", 2,
             None, (km, "generator", ups_norm_per_output))]


def kokoro_fault_run(synth, params, s, ids, pack, fault):
    """One fault's outputs: {"d", "t_en"} of stage 1 on `ids`, or {"F0", "N",
    "audio"} of stage 2 on `s`'s stage-1 outputs with its source spectrum."""
    import dataclasses
    from contextlib import nullcontext

    from tpu_audio_torch.models.kokoro.synth import KokoroSynthesizer

    _, stage, tree_fn, patch = fault
    if tree_fn is not None:
        synth = KokoroSynthesizer(tree_fn(params), synth.cfg)
    with torch.inference_mode(), (patched(*patch) if patch else nullcontext()):
        if stage == 1:
            f = synth.stage1(synth.prepare(ids, pack))
            return {"d": f.d, "t_en": f.t_en}
        f = synth.stage2(dataclasses.replace(s), har=s.har)
        return {"F0": f.f0, "N": f.n, "audio": f.audio}


def device_kernels(fn) -> tuple[int, float, float]:
    """(device kernels, device busy ms, traced wall s) of fn() under
    torch.profiler, tracing the card's activity only (a Kokoro stage 1
    launches ~57,000 kernels: the host's operators would add as many events
    again to the trace's processing)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, w = timed(fn)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3, w


def kokoro_slice(dev, card: str) -> dict:
    """Phase 18: Kokoro at full width on random weights (`kokoro_params`:
    82M, f32) through `TTS.kokoro()` → `KokoroEngine.from_params` with its
    default voice pack: KOKORO_TEXT's three sentences streamed (first audio,
    × real time, the phonemizer backend); each sentence's ids, mean
    duration, frame bucket and seconds, stage 1 and stage 2 ms (CUDA
    events), the first sentence's device kernels (the profiler); the first
    KOKORO_F64_SENTENCES held against an f64 route of the port on the host
    (the same tree and draws, the card's source spectrum injected):
    durations equal, d, t_en, F0 and N within KOKORO_REL, the audio's
    distance printed; five planted faults (`kokoro_faults`), each at least
    CV_FAULT_RATIO times the card route's distance from f64. No kernel of
    the port is on the path: ALBERT's masked attention takes the plain
    route, asserted by `encoder_attention`'s counters staying 0."""
    from tpu_audio_torch.api.tts import TTS
    from tpu_audio_torch.models.kokoro import model as km
    from tpu_audio_torch.models.kokoro.config import KokoroConfig
    from tpu_audio_torch.models.kokoro.synth import KokoroSynthesizer
    from tpu_audio_torch.ops.kernels import encoder_attention as ea
    from tpu_audio_torch.utils import pytree

    total = {n: 0 for n in ea.LAUNCHES}
    cfg = KokoroConfig()
    t0 = time.perf_counter()
    params = kokoro_params(dev)
    torch.cuda.synchronize()
    log(f"models: Kokoro-82M random f32 weights ({pytree.param_count(params)} parameters, seed "
        f"{SEED}, duration_proj's bias {KOKORO_DUR_BIAS}) in {time.perf_counter() - t0:.1f} s")
    eng = TTS.kokoro(device=dev).from_params(params, cfg)
    pack = eng._voice_pack()
    log(f"kokoro phonemizer: the {eng.phonemizer.kind} backend")

    def stream():
        first, chunks = {}, []
        t_ = time.perf_counter()
        for c in eng.generate_streaming(KOKORO_TEXT):
            first.setdefault("s", time.perf_counter() - t_)
            chunks.append(c)
        return chunks, first["s"]

    with torch.inference_mode():
        (chunks, first), _, wall = counted_run(
            "kokoro", (ea,), total, "generate_streaming (3 sentences, SENTENCE)", (), stream,
            absent=tuple(ea.LAUNCHES))
    audio = np.concatenate([c.samples for c in chunks])
    if not (len(chunks) == 3 and chunks[-1].is_final and np.isfinite(audio).all()
            and all(len(c.samples) and len(c.samples) % cfg.samples_per_frame == 0
                    for c in chunks)):
        raise AssertionError(f"kokoro stream: {len(chunks)} chunks of "
                             f"{[len(c.samples) for c in chunks]} samples")
    log(f"kokoro stream: {len(chunks)} chunks, first audio after {first:.3f} s; "
        f"{len(audio) / 24000:.2f} s of audio in {wall:.3f} s: {len(audio) / 24000 / wall:.2f}× "
        f"real time ({card})")

    # ------------------------------------------------ each sentence, its stages
    synth, sentences = eng.synth, []
    with torch.inference_mode():
        for i, c in enumerate(chunks):
            ids = eng.phonemizer.to_ids(c.text)
            s = synth.run(ids, pack)
            if measure(s.audio.cpu(), torch.as_tensor(c.samples))[1] > 1e-6:
                raise AssertionError(f"kokoro sentence {i}: run() differs from the stream")
            prepared = synth.stage1(synth.prepare(ids, pack))
            rng = torch.Generator(device=dev)
            ms1 = events_ms(lambda: synth.stage1(synth.prepare(ids, pack)), 2)
            ms2 = events_ms(lambda: synth.stage2(prepared, rng.manual_seed(SEED)), 2)
            n_valid = int(s.n_tokens)
            log(f"kokoro sentence {i}: {len(ids)} phoneme ids ({n_valid} with the boundaries), "
                f"mean duration {s.total / n_valid:.2f} frames a token, {s.total} frames in the "
                f"bucket of {s.frames_pad}, {len(c.samples) / 24000:.2f} s of audio; stage 1 "
                f"{ms1:.1f} ms, stage 2 {ms2:.1f} ms (CUDA events) ({card})")
            if i == 0:  # the kernels a sentence: the shapes are fixed, one sentence profiled
                t_ = time.perf_counter()
                k1, busy1, w1 = device_kernels(lambda: synth.stage1(synth.prepare(ids, pack)))
                k2, busy2, w2 = device_kernels(lambda: synth.stage2(prepared,
                                                                    rng.manual_seed(SEED)))
                log(f"kokoro sentence 0 device kernels (torch.profiler, the card's activity): "
                    f"stage 1 {k1}, busy {busy1:.1f} ms of the {1e3 * w1:.1f} ms traced; "
                    f"stage 2 {k2}, busy {busy2:.1f} ms of {1e3 * w2:.1f} ms; both traces "
                    f"{time.perf_counter() - t_:.1f} s with their processing ({card})")
            sentences.append((ids, s))

    # ------------------------------------------------ against the f64 route on the host
    tree64 = pytree.unflatten({k: v.detach().double().cpu()
                               for k, v in pytree.flatten(params).items()})
    synth64 = KokoroSynthesizer(tree64, cfg)
    t0 = time.perf_counter()
    refs = []
    for i, (ids, s) in enumerate(sentences[:KOKORO_F64_SENTENCES]):
        r = synth64.stage1(synth64.prepare(ids, pack))
        if not torch.equal(r.durations, s.durations.cpu()):
            bad = (r.durations != s.durations.cpu()).nonzero()[:, 1].tolist()
            pre = km.duration_sums(tree64, cfg, r.d, r.n_tokens, 1.0)[0, bad].tolist()
            pre_card = km.duration_sums(params, cfg, s.d, s.n_tokens, 1.0)[0, bad].tolist()
            raise AssertionError(f"kokoro sentence {i}: durations differ at tokens {bad}, "
                                 f"before rounding f64 {pre} card {pre_card}")
        synth64.stage2(r, har=s.har.double().cpu())
        ref = {"d": r.d, "t_en": r.t_en, "F0": r.f0, "N": r.n, "audio": r.audio}
        got = {"d": s.d, "t_en": s.t_en, "F0": s.f0, "N": s.n, "audio": s.audio}
        rel = {k: measure(got[k].cpu(), ref[k])[1] for k in ref}
        text = ", ".join(f"{k} rel {e:.3e}" for k, e in rel.items())
        if not all(rel[k] <= KOKORO_REL for k in ("d", "t_en", "F0", "N")):
            raise AssertionError(f"kokoro sentence {i} against f64: {text}: outside "
                                 f"rel {KOKORO_REL}")
        log(f"kokoro sentence {i} against the f64 route: durations equal ({s.total} frames), "
            f"{text} (d, t_en, F0, N within rel {KOKORO_REL}; the audio on the card's source "
            f"spectrum)")
        refs.append((ref, rel))
    log(f"kokoro f64 route on the host: {len(refs)} sentences in "
        f"{time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------ planted faults, on the first sentence
    (ids, s), (ref, rel) = sentences[0], refs[0]
    for fault in kokoro_faults():
        outs = kokoro_fault_run(synth, params, s, ids, pack, fault)
        errs = {k: measure(v.cpu(), ref[k])[1] for k, v in outs.items()}
        control_ratio("kokoro", fault[0], [e / rel[k] if rel[k] else math.inf
                                            for k, e in errs.items()],
                      ", ".join(f"{k} rel {e:.3e}" for k, e in errs.items()),
                      yardstick="the card route's distance from the f64 route")
    return total


# ------------------------------------------------ 19. serving and playback

def serve_requests(rng, n: int) -> list:
    """n (prompt ids, max_new): prompts of SERVE_PROMPT tokens below the
    Orpheus control ids, max_new in SERVE_NEW, from `rng`."""
    return [(rng.integers(0, 128000, int(rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1)))
             .tolist(), int(rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1))) for _ in range(n)]


@contextmanager
def captured_logits(module, key=lambda: None):
    """Record the logits of every step that `module`'s decode loops run and
    of every first token sampled without a recent ring (a prefill's): into
    {"first": [(1, V)], "spans": [(key(), [(B, V) a step])]}, f32 copies on
    the card. Wraps the step handed to `module.decode_loop`; adds nothing
    to the package."""
    from tpu_audio_torch.ops import sampling

    store = {"first": [], "spans": []}
    loop, sample = module.decode_loop, sampling.sample

    def wrapped_loop(step_fn, state, first, n, **kw):
        steps = []
        store["spans"].append((key(), steps))

        def step(tok, cache):
            lg, cache = step_fn(tok, cache)
            steps.append(lg.float().clone())
            return lg, cache
        return loop(step, state, first, n, **kw)

    def wrapped_sample(logits, cfg, recent=None, *a, **k):
        if recent is None:
            store["first"].append(logits.float().clone())
        return sample(logits, cfg, recent, *a, **k)

    with patched(module, "decode_loop", wrapped_loop), patched(sampling, "sample",
                                                                wrapped_sample):
        yield store


@contextmanager
def batcher_logits(batcher):
    """`captured_logits` of a ContinuousBatcher's spans and admissions,
    with the row → request map of each span and the admission order."""
    from tpu_audio_torch.api import serving

    admitted, admit = [], batcher._admit

    def record(row, req):
        admitted.append(req)
        return admit(row, req)

    batcher._admit = record
    try:
        with captured_logits(serving, lambda: list(batcher.row_req)) as store:
            store["admitted"] = admitted
            yield store
    finally:
        del batcher._admit


def request_logits(store: dict, req) -> torch.Tensor:
    """(len(req.tokens), V): row j the logits that chose req.tokens[j]."""
    i = next(i for i, r in enumerate(store["admitted"]) if r is req)
    rows = [store["first"][i][0]]
    for owners, steps in store["spans"]:
        for row, r in enumerate(owners):
            if r is req:
                rows.extend(s[row] for s in steps)
    return torch.stack(rows)[:len(req.tokens)]


def single_logits(gen, prompt, sampler, max_new: int):
    """`gen.generate` of one prompt at the batcher's bucket: (tokens, their
    logits (len, V) as `request_logits` lays them out)."""
    from tpu_audio_torch.models.orpheus import model as om

    with captured_logits(om) as store:
        toks = gen.generate(prompt, sampler=sampler, eos_ids=(om.END_TOKEN,), max_new=max_new,
                            bucket=SERVE_BUCKET)
    rows = [store["first"][0][0]] + [s[0] for _, steps in store["spans"] for s in steps]
    return toks, torch.stack(rows)[:len(toks)]


def first_difference(tag: str, got: list, ref: list, got_lg, ref_lg, sampler) -> str:
    """Where two greedy token streams of one prompt part: their first
    differing step k, the reference's top-2 margin there and the two routes'
    largest logit difference, both after the repetition penalty over the
    shared prefix. A flip needs margin ≤ 2 × difference; that difference
    must stay within SERVE_NEAR_TIE of the step's largest |logit|. Raises
    otherwise; returns a line for the log."""
    from tpu_audio_torch.ops import sampling

    if got == ref:
        return f"{len(got)} of {len(ref)} tokens equal"
    k = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), min(len(got), len(ref)))
    if k == min(len(got), len(ref)):
        raise AssertionError(f"{tag}: one stream ends early ({len(got)} vs {len(ref)} tokens)")
    recent = torch.full((1, sampler.repetition_window), -1, dtype=torch.int64,
                        device=got_lg.device)
    for t in ref[:k][-sampler.repetition_window:]:
        recent = sampling.update_recent(recent, torch.tensor([t], device=got_lg.device))
    if k:
        pen = lambda lg: sampling.apply_repetition_penalty(lg[None], recent,  # noqa: E731
                                                           sampler.repetition_penalty)[0]
    else:  # the first token is sampled without the penalty
        pen = lambda lg: lg  # noqa: E731
    g, r = pen(got_lg[k]), pen(ref_lg[k])
    top = torch.topk(r, 2).values
    margin, diff = (top[0] - top[1]).item(), (g - r).abs().max().item()
    scale = r.abs().max().item()
    text = (f"{k} of {len(ref)} tokens equal; at step {k} the reference's top-2 margin "
            f"{margin:.4e}, the routes' largest logit difference {diff:.4e} "
            f"({diff / scale:.3e} of max|logit| {scale:.3f})")
    if not (margin <= 2 * diff and diff <= SERVE_NEAR_TIE * scale):
        raise AssertionError(f"{tag}: {text}: not a near tie (margin ≤ 2 × difference, "
                             f"difference ≤ {SERVE_NEAR_TIE} of max|logit|)")
    return text


def percentiles(xs) -> str:
    a = np.asarray(xs, np.float64) * 1e3
    return f"p50 {np.percentile(a, 50):.1f} ms, p90 {np.percentile(a, 90):.1f} ms"


def dequantised_f32(tree: dict) -> dict:
    """The tree with every int8 leaf dequantised (codes × scale) to an f32
    weight and every other float leaf in f32: the plain route's reference."""
    def walk(node):
        if not isinstance(node, dict):
            return node.float() if node.is_floating_point() else node
        if "weight_i8" in node:
            out = {"weight": node["weight_i8"].float() * node["scale_i8"].float()}
            if "bias" in node:
                out["bias"] = node["bias"].float()
            return out
        return {k: walk(v) for k, v in node.items()}
    return walk(tree)


def f32_request_logits(params32: dict, cfg, prompt: list, tokens: list, dev) -> torch.Tensor:
    """A fresh single-stream prefill of prompt + tokens[:-1] (left-padded to
    SERVE_BUCKET, the pad key-masked, RoPE from the first real token) on an
    f32 tree: (len(tokens), V), row j the logits after prompt + tokens[:j]."""
    from tpu_audio_torch.nn import transformer

    n = len(prompt)
    pad = -(-n // SERVE_BUCKET) * SERVE_BUCKET
    seq = [0] * (pad - n) + list(prompt) + list(tokens[:-1])
    with torch.inference_mode():
        cache, extra = transformer.decode_cache_and_mask(cfg, len(seq), pad - n, False,
                                                         dtype=torch.float32, device=dev)
        lg, _ = transformer.forward(params32, cfg, torch.tensor([seq], device=dev), cache,
                                    extra, pos_offset=torch.tensor([pad - n], device=dev))
    return lg[0, pad - 1:].float()


def serve_faults() -> dict:
    """The batcher's planted faults, by name: each plants itself in a
    ContinuousBatcher (instance attributes; nothing in the package
    changes)."""
    def stale_mask(b):
        """Span masks from each row's first request's row_start."""
        first = {}
        mask = b._mask

        def masked(row_start):
            if row_start is b.row_start:
                for row, r in enumerate(b.row_req):
                    if r is not None:
                        first.setdefault(row, int(b.row_start[row]))
                stale = b.row_start.clone()
                for row, s in first.items():
                    stale[row] = s
                return mask(stale)
            return mask(row_start)
        b._mask = masked

    def no_offset(b):
        """RoPE at absolute slots in the spans."""
        make = b.gen._step
        b.gen = copy.copy(b.gen)
        b.gen._step = lambda extra, off: make(extra, None)

    def late_window(b):
        def copy_late(row, lo, hi):
            b.cache.k[:, row, lo + 1:hi + 1] = b._scratch.k[:, 0, lo:hi]
            b.cache.v[:, row, lo + 1:hi + 1] = b._scratch.v[:, 0, lo:hi]
        b._copy_window = copy_late

    def pad_unmasked(b):
        mask = b._mask
        b._mask = lambda rs: mask(b._scratch.pos.reshape(1)) if rs.shape[0] == 1 else mask(rs)

    return {"a refilled row's mask left at its previous request's row_start": stale_mask,
            "pos_offset dropped: RoPE at absolute slots": no_offset,
            "the admitted KV window copied one slot late": late_window,
            "the left pad unmasked at admission": pad_unmasked}


def serve_control(groups, cfg, dev, rng) -> None:
    """(c): two requests admitted into recycled rows at different P (C into
    A's row after its 4 spans, P 128; D at P 160, into the row C left, as
    B's 6 spans end), their logits captured in the batcher's
    span steps and admissions, held against a fresh single-stream prefill
    of prompt + tokens on the f32 dequantised tree. Each of `groups` is
    (label, tree, kernels, faults): the batcher on the kernels' plain
    versions is the tree's yardstick; with `kernels`, the kernel route must
    be within SLICE_RATIO of it; each fault of `faults` (names of
    `serve_faults`) must read CV_FAULT_RATIO times its distance."""
    from tpu_audio_torch.api.serving import ContinuousBatcher, Request
    from tpu_audio_torch.models.orpheus import model as om
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
    from tpu_audio_torch.ops.sampling import SamplerConfig

    sampler = SamplerConfig(**SERVE_PENALTY)
    prompts = [rng.integers(0, 128000, n).tolist() for n in (24, 50, 30, 45)]
    plan = list(zip(prompts, (4 * SERVE_SPAN + 1, 6 * SERVE_SPAN + 1, 2 * SERVE_SPAN + 1,
                              2 * SERVE_SPAN + 1)))
    outputs = tuple(f"request {c} logits ({m}, {cfg.vocab_size})"
                    for c, (_, m) in zip("CD", plan[2:]))
    for label, tree, kernels, names in groups:
        gen = om.CausalLMGenerator(tree, cfg, max_cache=SERVE_RING, pad_id=om.PAD_TOKEN)
        params32 = dequantised_f32(tree)
        tag = f"serve batcher, {label}"

        def serve(plant=None):
            b = ContinuousBatcher(gen, batch=2, span=SERVE_SPAN, sampler=sampler,
                                  eos_ids=(om.END_TOKEN,), prompt_bucket=SERVE_BUCKET)
            if plant is not None:
                plant(b)
            reqs = [Request(list(p), max_new=m) for p, m in plan]
            admit = b._admit

            def placed(row, req):
                b.placed.append((row, b.pos))
                return admit(row, req)

            b.placed, b._admit = [], placed
            with batcher_logits(b) as store:
                for r in reqs:
                    b.submit(r)
                b.run_until_idle()
            got = [request_logits(store, r) for r in reqs[2:]]
            exact = [f32_request_logits(params32, cfg, r.prompt_ids, r.tokens, dev)
                     for r in reqs[2:]]
            return got, exact, b

        with plain_kernels(i8mm):
            plain, exact_p, b = serve()
        p_err, p_cos = zip(*[measure(g, r)[1:] for g, r in zip(plain, exact_p)])
        log(f"{tag}: (row, P) of the admissions of A, B, C, D: {b.placed}; the plain route "
            "against f32: " + ", ".join(f"{n.split(' (')[0]} rel {e:.3e} cosine {c:.6f}"
                                        for n, e, c in zip(outputs, p_err, p_cos)))
        if kernels:
            got, exact, _ = serve()
            held_against_f32(tag, outputs, exact, p_err, "kernels", got, control=False,
                             p_cos=p_cos)
        faults = serve_faults()
        for name in names:
            got, exact, _ = serve(faults[name])
            held_against_f32(tag, outputs, exact, p_err, name, got, control=True, p_cos=p_cos)
        del params32


def serve_run(tag: str, gen, reqs_spec, mods, rule: dict, absent, held, held_rel, card: str,
              prof) -> tuple:
    """(a)/(b): SERVE_BATCH rows, SERVE_BATCH requests up front and one more
    after each span; the launches counted against `rule` (launches a span
    step by wrapper; the admissions' 64-row prefills take none of them);
    `held`'s calls of the third span held against their plain versions.
    Returns (requests, launches, the batcher's capture)."""
    from tpu_audio_torch.api import serving
    from tpu_audio_torch.api.serving import ContinuousBatcher, Request
    from tpu_audio_torch.models.orpheus import model as om
    from tpu_audio_torch.ops.sampling import SamplerConfig

    b = ContinuousBatcher(gen, batch=SERVE_BATCH, span=SERVE_SPAN,
                          sampler=SamplerConfig(**SERVE_PENALTY), eos_ids=(om.END_TOKEN,),
                          prompt_bucket=SERVE_BUCKET)
    reqs = [Request(list(p), max_new=m) for p, m in reqs_spec]
    admit = b._admit

    def timed_admit(row, req):
        with prof.time(f"{tag} admission"):
            return admit(row, req)

    b._admit = timed_admit
    reset(*mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with batcher_logits(b) as store:
        loop = serving.decode_loop  # the capturing one

        def timed_loop(*a, **k):
            with prof.time(f"{tag} span"):
                return loop(*a, **k)

        with patched(serving, "decode_loop", timed_loop):
            for r in reqs[:SERVE_BATCH]:
                b.submit(r)
            pending = list(reqs[SERVE_BATCH:])
            while True:
                with (held_calls(f"{tag} span 3", *held, held_rel) if len(store["spans"]) == 2
                      else contextlib.nullcontext()):
                    more = b.step()
                if pending:
                    b.submit(pending.pop(0))
                elif not more:
                    break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = len(store["spans"])
    occupancy = [sum(r is not None for r in owners) for owners, _ in store["spans"]]
    launches = launch_counts(*mods)
    steps = sum(len(s) for _, s in store["spans"])
    n_tok = sum(len(r.tokens) for r in reqs)
    if not all(r.done and 1 <= len(r.tokens) <= r.max_new for r in reqs) or len(b.completed) \
            != len(reqs) or not all(0 <= t < gen.cfg.vocab_size for r in reqs for t in r.tokens):
        raise AssertionError(f"{tag}: a request unserved, overlong or out of the vocabulary")
    log(f"{tag}: {len(reqs)} requests, {n_tok} tokens in {spans} spans of {SERVE_SPAN} "
        f"({steps} steps), mean occupancy {np.mean(occupancy):.3f} of {SERVE_BATCH} rows, "
        f"{n_tok / wall:.1f} tokens/s over {wall:.3f} s ({card})")
    log(f"{tag}: first token {percentiles([r.first_token_at - r.arrival for r in reqs])}; "
        f"whole request {percentiles([r.done_at - r.arrival for r in reqs])} ({card})")
    times = prof.summary()
    log(f"{tag}: {1e3 * times[f'{tag} span']['mean_s']:.2f} ms a span, "
        f"{1e3 * times[f'{tag} span']['mean_s'] / SERVE_SPAN:.2f} ms a step, "
        f"{1e3 * times[f'{tag} admission']['mean_s']:.2f} ms an admission (CUDA events) "
        f"({card})")
    log(f"{tag} launches: {launches}; a span step: " + ", ".join(
        f"{n} {launches[n] / steps:g}" for n in rule))
    if any(launches[n] != k * steps for n, k in rule.items()) or any(launches[n] for n in absent):
        raise AssertionError(f"{tag}: launches {launches} in {steps} steps, not {rule} a step, "
                             f"or one of {absent}")
    return reqs, launches, store


def serve_slice(dev, card: str) -> dict:
    """Phase 19: serving and playback on the card. Orpheus's LM at
    Llama-3.2-3B width on random weights (`orpheus_trees(sg=False)`): (a)
    `ContinuousBatcher` over a `CausalLMGenerator(max_cache=SERVE_RING)` on
    the w8a8 tree at batch 8, spans of 16, prompt bucket 64, greedy under a
    repetition penalty, SERVE_REQUESTS requests (8 up front, one more after
    each span): spans, occupancy, tokens/s, ms a span and an admission (CUDA
    events, `utils/profiling.Profiler`), first-token and whole-request
    latency, the launch rule counted (the head's `int8_matmul` once a step,
    4 × 28 layer linears a step through the same entry on views of the
    stacked leaves, `int8_matmul_stacked` never), the int8 calls of one span
    bit for bit against their plain versions; (b) the same on the W4A8 tree with
    SERVE_W4A8_REQUESTS (the W4A8 calls of one span within rel 1e-5); (c)
    the batcher's logits of two requests admitted into recycled rows at
    different P against f32 with four planted faults; (d) each request of
    (a) against the single-stream `generate` of its prompt; (e) C26 and C27:
    a request whose budget does not fit the ring waits, the idle position
    rewinds, its tokens equal a roomy ring's; (f) `say` on the w8a8 engine
    into a PlayerSink on the null output and a FileSink; (g) memory
    snapshots and the phase's profiler summary. Returns the launches of
    (a), (b) and (f)."""
    from tpu_audio_torch.api.player import AudioSamplePlayer
    from tpu_audio_torch.api.playback import FileSink, PlaybackController, PlayerSink
    from tpu_audio_torch.api.serving import ContinuousBatcher, Request
    from tpu_audio_torch.api.tts import TTS, StreamingGranularity
    from tpu_audio_torch.codecs.snac import model as snac
    from tpu_audio_torch.models.orpheus import model as om
    from tpu_audio_torch.ops.kernels import fused_step as fs
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
    from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm
    from tpu_audio_torch.ops.sampling import SamplerConfig
    from tpu_audio_torch.utils import memory
    from tpu_audio_torch.utils.audio_io import read_wav
    from tpu_audio_torch.utils.profiling import Profiler

    mods = (i8mm, w4mm, fs)
    total = {n: 0 for m in mods for n in m.LAUNCHES}
    log(f"serve memory before: {memory.snapshot(dev)}")
    prof = Profiler(device=dev)
    cfg = om.LLAMA_3B
    t0 = time.perf_counter()
    trees = orpheus_trees(dev, sg=False)
    torch.cuda.synchronize()
    log(f"serve: Orpheus's Llama-3.2-3B random weights (seed {SEED}), its W4A8 and w8a8 trees "
        f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 19)
    sampler = SamplerConfig(**SERVE_PENALTY)

    # (a) the w8a8 tree, the engine's default
    gen = om.CausalLMGenerator(trees["w8a8"], cfg, max_cache=SERVE_RING, pad_id=om.PAD_TOKEN)
    spec = serve_requests(rng, SERVE_REQUESTS)
    i8 = ("int8_matmul", "int8_matmul_stacked")
    w4 = ("w4a8_matmul", "w4a8_matmul_stacked")
    lyr = cfg.n_layers
    # the int8 layers are served by views of the stacked leaves through
    # int8_matmul (qkv, o, gateup, down a layer), the head by the same entry
    reqs, launches, store = serve_run(
        "serve w8a8", gen, spec, mods, {"int8_matmul": 4 * lyr + 1, "int8_matmul_stacked": 0},
        ("fused_decode_step",) + w4, (i8mm, i8), 0.0, card, prof)
    for n, c in launches.items():
        total[n] += c

    # (d) each request against the single-stream generate of its prompt
    equal = 0
    for i, r in enumerate(reqs):
        ref, ref_lg = single_logits(gen, r.prompt_ids, sampler, r.max_new)
        equal += r.tokens == ref
        log(f"serve w8a8 request {i} ({len(r.prompt_ids)} prompt tokens, max_new {r.max_new}) "
            f"against generate: " + first_difference(f"serve request {i}", r.tokens, ref,
                                                     request_logits(store, r), ref_lg, sampler))
    log(f"serve w8a8: {equal} of {len(reqs)} requests equal to their single-stream generate")
    del store

    # (b) the W4A8 tree
    gen4 = om.CausalLMGenerator(trees["w4a8"], cfg, max_cache=SERVE_RING, pad_id=om.PAD_TOKEN)
    _, launches, _ = serve_run(
        "serve w4a8", gen4, serve_requests(rng, SERVE_W4A8_REQUESTS), mods,
        {"w4a8_matmul": 1, "w4a8_matmul_stacked": 4 * lyr}, ("fused_decode_step",) + i8,
        (w4mm, w4), 1e-5, card, prof)
    for n, c in launches.items():
        total[n] += c
    del gen4

    # (c) end to end against f32, with the batcher's faults
    # each fault on the tree where its term shows (all four held on both
    # trees): a position fault needs peaked attention (q, k x 3; on w8a8
    # RoPE read 3.160x and the late window 3.629x), while the masks read
    # 50.4x and 74.4x on w8a8 against 13.8x and 16.8x on q, k x 3
    stale, rope, late, pad = serve_faults()
    serve_control(((f"q, k x {QK_SCALE:g}", sharpened(trees["w8a8"], cfg, QK_SCALE), True,
                    (rope, late)), ("w8a8", trees["w8a8"], False, (stale, pad))), cfg, dev, rng)
    torch.cuda.empty_cache()

    # (e) C26 and C27 at 3B: R2's budget does not fit behind R1 in a ring of
    # SERVE_SMALL_RING; it waits, the idle position rewinds, and its tokens
    # equal those of a fresh batcher on the same ring (R1's slots left in the
    # rewound ring are masked: bit for bit) and, to a near tie, a roomy
    # ring's (another attention length, other roundings)
    small = om.CausalLMGenerator(trees["w8a8"], cfg, max_cache=SERVE_SMALL_RING,
                                 pad_id=om.PAD_TOKEN)
    p1, p2 = (rng.integers(0, 128000, n).tolist() for n in (40, 33))
    b = ContinuousBatcher(small, batch=2, span=SERVE_SPAN, sampler=sampler,
                          eos_ids=(om.END_TOKEN,), prompt_bucket=SERVE_BUCKET)
    r1, r2 = Request(p1, max_new=2 * SERVE_SPAN + 1), Request(p2, max_new=3 * SERVE_SPAN + 1)
    positions, waited = [], 0
    with batcher_logits(b) as store:
        b.submit(r1)
        b.step()
        b.submit(r2)
        while b.step():
            positions.append(b.pos)
            waited += any(q is r2 for q in b.queue)
            if b.pos > SERVE_SMALL_RING:
                raise AssertionError(f"serve C26: position {b.pos} past the ring")
    rewound = any(q < p for p, q in zip(positions, positions[1:]))
    if not (waited and rewound and r2.done and len(r2.tokens) == r2.max_new):
        raise AssertionError(f"serve C26/C27: waited {waited} spans, positions {positions}, "
                             f"r2 {len(r2.tokens)} of {r2.max_new}")
    fresh = ContinuousBatcher(small, batch=2, span=SERVE_SPAN, sampler=sampler,
                              eos_ids=(om.END_TOKEN,), prompt_bucket=SERVE_BUCKET)
    r2f = Request(list(p2), max_new=r2.max_new)
    fresh.submit(r2f)
    fresh.run_until_idle()
    if r2f.tokens != r2.tokens:
        raise AssertionError(f"serve C27: the rewound R2's {len(r2.tokens)} tokens against a "
                             f"fresh batcher's {len(r2f.tokens)}: not equal")
    roomy = ContinuousBatcher(gen, batch=2, span=SERVE_SPAN, sampler=sampler,
                              eos_ids=(om.END_TOKEN,), prompt_bucket=SERVE_BUCKET)
    r2b = Request(list(p2), max_new=r2.max_new)
    with batcher_logits(roomy) as roomy_store:
        roomy.submit(r2b)
        roomy.run_until_idle()
    log(f"serve C26/C27 at 3B, ring {SERVE_SMALL_RING}: R2 ({r2.max_new} tokens, "
        f"{b._need(r2)} slots of budget) waited {waited} spans behind R1, the idle position "
        f"rewound ({positions}), the ring never passed; R2 equal to a fresh batcher's on the "
        f"same ring, {len(r2.tokens)} tokens; against a ring of {SERVE_RING}: "
        + first_difference("serve C26", r2.tokens, r2b.tokens, request_logits(store, r2),
                           request_logits(roomy_store, r2b), sampler))
    del store, roomy_store, small, b, roomy, fresh

    # (f) say on the w8a8 engine
    snac_params = snac.init_params(SEED, snac.SNACConfig(), torch.float32, dev)
    eng = TTS.orpheus().from_params(trees["w8a8"], cfg, snac_params)
    player = AudioSamplePlayer(eng.sample_rate, backend="null")
    tmp = tempfile.TemporaryDirectory()
    wav = Path(tmp.name) / "say.wav"

    class Tee:
        def __init__(self, *sinks):
            self.sinks = sinks

        def write(self, chunk):
            for s in self.sinks:
                s.write(chunk)

        def close(self):
            for s in self.sinks:
                s.close()

    steps = step_counter(eng.lm)
    controller = PlaybackController(eng)
    reset(*mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = controller.play_stream(SAY_TEXT, sink=Tee(PlayerSink(eng.sample_rate, player=player),
                                                    FileSink(str(wav), eng.sample_rate)),
                                 granularity=StreamingGranularity.TOKEN,
                                 max_new_tokens=SAY_NEW)
    wall = time.perf_counter() - t0
    launches = launch_counts(*mods)
    drained = player.await_drain(timeout=10.0)
    back, sr = read_wav(str(wav))
    tmp.cleanup()
    audio = res.audio.samples
    want = (np.clip(audio, -1.0, 1.0) * 32767).astype(np.int16) / np.float32(32768)
    log(f"serve say: {res.chunks} chunks, {len(audio)} samples ({res.audio.duration:.3f} s), "
        f"first audio after {controller.time_to_first_audio:.3f} s, {wall:.3f} s wall = "
        f"{res.audio.duration / wall:.3f}x real time; the player took {player.samples_played} "
        f"samples; launches {launches}, {steps['n']} decode steps ({card})")
    if not (drained and player.samples_played == len(audio) > 0 and np.isfinite(audio).all()
            and sr == eng.sample_rate and back.shape == want.shape
            and np.array_equal(back, want)):
        raise AssertionError(f"serve say: drained {drained}, played {player.samples_played} of "
                             f"{len(audio)}, the WAV {back.shape} at {sr} Hz not the audio to "
                             "int16 rounding")
    if launches["fused_decode_step"] != steps["n"] or not steps["n"]:
        raise AssertionError(f"serve say: {launches['fused_decode_step']} whole-stack steps for "
                             f"{steps['n']} decode steps")
    player.close()
    for n, c in launches.items():
        total[n] += c
    del eng, trees, gen
    torch.cuda.empty_cache()

    # (g)
    log(f"serve profiler: {json.dumps(prof.summary())} ({card})")
    log(f"serve memory after: {memory.snapshot(dev)}")
    return total


def train_batcher(cfg):
    """Phase 20's data: two examples of synthetic mel with token streams of
    TRAIN_TOKENS ids, so every batch is the same two rows (their order
    drawn) with unequal masks."""
    from tpu_audio_torch.training import Batcher, Example

    rng = np.random.default_rng(SEED)
    ex = [Example(mel=(rng.standard_normal((2 * cfg.n_audio_ctx, cfg.n_mels)) * 0.5
                       ).astype(np.float32),
                  tokens=rng.integers(0, 50257, n).astype(np.int32)) for n in TRAIN_TOKENS]
    return Batcher(ex, batch_size=2, max_tokens=max(TRAIN_TOKENS) - 1, seed=SEED)


class GradReport(torch.optim.AdamW):
    """The default AdamW (`training.whisper.adamw`'s betas, eps and decay
    0.01) that reads every leaf's gradient at its first step (`report`:
    (group, leaf, finite and not all zero), a stacked leaf per layer, one
    host read) and records a CUDA event after each step (`marks`)."""

    def __init__(self, params, lr: float):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
        self.report, self.marks = None, []

    def step(self, closure=None):
        if self.report is None:
            group = self.param_groups[0]
            self.report = grad_report(zip(group["param_names"], group["params"]))
        out = super().step(closure)
        self.marks.append(torch.cuda.Event(enable_timing=True))
        self.marks[-1].record()
        return out


def grad_report(named) -> list:
    """(group, leaf, its gradient finite and not all zero) for every leaf:
    the stem, each encoder and decoder block (a stacked leaf's slice i),
    ln_post, the decoder's ln, the embeddings."""
    keys, flags = [], []
    for name, p in named:
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if ".blocks." in name:
            side = name.split(".")[0]
            g2 = g.flatten(1)
            flags.append(torch.isfinite(g2).all(1) & (g2 != 0).any(1))
            keys += [(f"{side} block {i}", f"{name}[{i}]") for i in range(g.shape[0])]
        else:
            group = ("stem" if ".conv" in name else "embedding" if "embedding" in name
                     else name.rsplit(".", 1)[0])
            flags.append((torch.isfinite(g).all() & (g != 0).any())[None])
            keys.append((group, name))
    return [(grp, leaf, ok) for (grp, leaf), ok in zip(keys, torch.cat(flags).tolist())]


def tree_rel(got: dict, ref: dict) -> dict:
    """Each leaf's ‖got − ref‖ / ‖ref‖, in f64."""
    return {k: ((got[k].double() - ref[k].double()).norm() / ref[k].double().norm()).item()
            for k in ref}


def train_slice(dev, card: str) -> dict:
    """Phase 20: Whisper fine-tuning on the card through `training.train`
    (the training route: the JAX XLA formulation in autograd ops, since no
    kernel has a backward). (a) large-v3-turbo at full width, random f32
    leaves (`init_params`), a fixed batch of 2 with unequal masks,
    TRAIN_STEPS AdamW steps at TRAIN_LR: ms a step (CUDA events), peak
    memory, the loss falls, every leaf's gradient finite and non-zero at the
    first step, no kernel launched; (b) the route at full width and
    TRAIN_DEPTH64 + TRAIN_DEPTH64 layers in f32 and f64 on the card, TF32
    off: the loss's and each leaf's gradient's distance, with four planted
    faults ≥ CV_FAULT_RATIO × the route's own distance (a block's output
    detached, as a kernel on the route would do; the loss as a mean of
    half-batch means; hd^-0.25 on q only; AdamW at optax's default decay
    1e-4, after the step against the 0.01 update, both from the f32
    gradients, against the same step in f64); (c) `evaluate` of (a)'s
    trained tree: the fused bf16 encoder (rows 2–3, one launch a layer
    each), its features and loss against the training route's f32 ones,
    and a `Whisper` built before the steps whose leaves were then updated
    in place (stale packed QKV) as a control; (d) `make_mesh()` as a world
    of one on NCCL and `train(mesh=...)`'s TRAIN_MESH_STEPS losses against
    (a)'s, then the grad guard of the kernel wrappers. Returns (c)'s
    launches."""
    import dataclasses

    import torch.distributed as dist

    from tpu_audio_torch.models.whisper import model as wmodel
    from tpu_audio_torch.models.whisper.config import PRESETS
    from tpu_audio_torch.ops.kernels import cross_kv_attention as ckv
    from tpu_audio_torch.ops.kernels import encoder_attention as ea
    from tpu_audio_torch.ops.kernels import fused_encoder as fe
    from tpu_audio_torch.ops.kernels import fused_encoder_int8 as fe8
    from tpu_audio_torch.ops.kernels import fused_mel, fused_step, fused_whisper_step
    from tpu_audio_torch.ops.kernels import int8_matmul, quant_matmul, w4a8_matmul
    from tpu_audio_torch.parallel import make_mesh
    from tpu_audio_torch.training import evaluate, train
    from tpu_audio_torch.training.data import evaluate_model, put
    from tpu_audio_torch.training.whisper import adamw, loss_fn
    from tpu_audio_torch.utils import pytree

    mods = (fused_mel, fe, fe8, ea, ckv, fused_whisper_step, int8_matmul, quant_matmul,
            w4a8_matmul, fused_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"train TF32: torch.backends.cuda.matmul.allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32 "
        f"{torch.backends.cudnn.allow_tf32}")
    cfg = PRESETS["large-v3-turbo"]
    t0 = time.perf_counter()
    params0 = wmodel.init_params(SEED, cfg, torch.float32, dev)
    n_params = sum(v.numel() for v in pytree.flatten(params0).values())
    # (c)'s control: built before the steps, its leaves updated in place after them
    stale = wmodel.Whisper(cfg, pytree.unflatten({k: v.to(torch.bfloat16) for k, v in
                                                  pytree.flatten(params0).items()}))
    batcher = train_batcher(cfg)
    batch = put(next(batcher.batches()), dev)
    torch.cuda.synchronize()
    log(f"train models: large-v3-turbo random f32 weights (seed {SEED}), {n_params:,} "
        f"parameters, and a bf16 Whisper of them in {time.perf_counter() - t0:.1f} s")

    # (a) full width, TRAIN_STEPS steps
    opts = []

    def report_adamw(ps):
        opts.append(GradReport(ps, lr=TRAIN_LR))
        return opts[-1]

    reset(*mods)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    trained, losses = train(params0, cfg, batcher, TRAIN_STEPS, optimizer=report_adamw,
                            log_every=0)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = {n: c for n, c in launch_counts(*mods).items() if c}
    marks = [start] + opts[0].marks
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    log(f"train (a): large-v3-turbo f32 at batch 2 (masks of {batch['mask'].sum(1).tolist()} "
        f"tokens), {TRAIN_STEPS} AdamW steps at lr {TRAIN_LR}: losses "
        f"{[round(x, 4) for x in losses]}; ms a step (CUDA events, one step's end to the next) "
        f"{[round(x, 2) for x in ms]}, steps 2-{TRAIN_STEPS} {np.mean(ms[1:]):.2f} ms; "
        f"{wall:.2f} s wall; peak memory {peak:.2f} GiB (estimate {TRAIN_MEM_GB} GB); "
        f"kernels launched {launched or 'none'} ({card})")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]) or launched:
        raise AssertionError(f"train (a): losses {losses} not finite and falling, or a kernel "
                             f"launched on the training route: {launched}")
    groups: dict = {}
    for grp, leaf, ok in opts[0].report:
        groups.setdefault(grp, []).append(ok)
    enc = [g for g in groups if g.startswith("encoder block")]
    dec = [g for g in groups if g.startswith("decoder block")]
    rest = [g for g in groups if g not in enc + dec]
    log("train (a) gradients finite and non-zero at step 1: "
        + ", ".join(f"{g} {sum(groups[g])}/{len(groups[g])}" for g in rest)
        + f"; {len(enc)} encoder blocks, each {min(sum(groups[g]) for g in enc)}"
          f"/{len(groups[enc[0]])}; {len(dec)} decoder blocks, each "
          f"{min(sum(groups[g]) for g in dec)}/{len(groups[dec[0]])}; "
          f"{sum(ok for _, _, ok in opts[0].report)} of {len(opts[0].report)} leaf slices")
    bad = [leaf for _, leaf, ok in opts[0].report if not ok]
    if bad or len(enc) != cfg.n_audio_layer or len(dec) != cfg.n_text_layer:
        raise AssertionError(f"train (a): leaves without a finite, non-zero gradient: {bad[:20]}")
    del opts

    # (c) the kernel route after training (before (b), while the trained tree is here)
    mel16 = batch["mel"].to(torch.bfloat16)
    args = (batch["tokens_in"], batch["tokens_out"], batch["mask"])
    with torch.no_grad():
        for k, p in stale.tree()["encoder"].named_parameters(prefix="encoder"):
            p.copy_(pytree.flatten(trained)[k])
        for k, p in stale.tree()["decoder"].named_parameters(prefix="decoder"):
            p.copy_(pytree.flatten(trained)[k])
        exact_f = wmodel.encode_xla(trained, cfg, batch["mel"])
        exact_l = loss_fn(trained, cfg, batch["mel"], *args).item()
        bf = pytree.unflatten({k: v.to(torch.bfloat16) for k, v in pytree.flatten(trained).items()})
        plain_f = wmodel.encode_xla(bf, cfg, mel16)
        plain_l = loss_fn(bf, cfg, mel16, *args).item()
        del bf
    reset(*mods)
    ev, ev_wall = timed(lambda: evaluate(trained, cfg, batcher.batches(epochs=1), max_batches=1))
    counts = launch_counts(*mods)
    log(f"train (c) evaluate: loss {ev['loss']:.6f}, token accuracy {ev['token_acc']:.4f}, "
        f"{ev['batches']} batch, {ev_wall:.3f} s wall, launches "
        f"{ {n: c for n, c in counts.items() if c} }")
    if (counts["ln_qkv"], counts["attn_oproj_ln"]) != (cfg.n_audio_layer,) * 2 or any(
            c for n, c in counts.items() if n not in ("ln_qkv", "attn_oproj_ln")):
        raise AssertionError(f"train (c): evaluate's launches {counts}, not one ln_qkv and one "
                             "attn_oproj_ln a layer")
    with torch.no_grad():
        fresh = wmodel.Whisper(cfg, pytree.unflatten(
            {k: v.to(torch.bfloat16) for k, v in pytree.flatten(trained).items()}))
        kern_f = fresh.encode(mel16)
        del fresh
        stale_f = stale.encode(mel16)
    stale_ev = evaluate_model(stale, batcher.batches(epochs=1), max_batches=1)
    (_, p_err, p_cos), (_, k_err, k_cos), (_, s_err, s_cos) = (
        measure(f, exact_f) for f in (plain_f, kern_f, stale_f))
    k_l, s_l = (abs(x - exact_l) / abs(exact_l) for x in (ev["loss"], stale_ev["loss"]))
    log(f"train (c): the training route f32 loss {exact_l:.6f}; the plain bf16 route: loss "
        f"{plain_l:.6f} (rel {abs(plain_l - exact_l) / abs(exact_l):.3e}), features rel "
        f"{p_err:.3e}, 1 - cosine {1 - p_cos:.3e}; evaluate (the kernels): loss rel "
        f"{k_l:.3e} (bound {TRAIN_LOSS_REL}), features rel {k_err:.3e} = "
        f"{k_err / p_err:.3f}x and 1 - cosine {1 - k_cos:.3e} = "
        f"{(1 - k_cos) / (1 - p_cos):.3f}x the plain bf16 route's (bound {SLICE_RATIO}x) "
        f"({card})")
    if not (k_l <= TRAIN_LOSS_REL and k_err <= SLICE_RATIO * p_err
            and 1 - k_cos <= SLICE_RATIO * (1 - p_cos)):
        raise AssertionError("train (c): evaluate's loss or features outside the bound")
    control_ratio("train (c)", "a Whisper built before the steps (stale packed QKV)",
                  [s_err / p_err, (1 - s_cos) / (1 - p_cos), s_l / TRAIN_LOSS_REL],
                  f"features rel {s_err:.3e}, 1 - cosine {1 - s_cos:.3e}, loss rel {s_l:.3e}",
                  "the plain bf16 route's features distance (rel, 1 - cosine) / the loss bound")
    del trained, stale, exact_f, plain_f, kern_f, stale_f
    torch.cuda.empty_cache()

    # (b) f32 against f64, full width at TRAIN_DEPTH64 + TRAIN_DEPTH64 layers
    cfg_b = dataclasses.replace(cfg, n_audio_layer=TRAIN_DEPTH64, n_text_layer=TRAIN_DEPTH64)
    tree_b = wmodel.init_params(SEED, cfg_b, torch.float32, dev)

    def grads(dtype, loss=loss_fn):
        m = wmodel.ParamTree(pytree.unflatten(
            {k: v.to(dtype, copy=True) for k, v in pytree.flatten(tree_b).items()}))
        m.requires_grad_(True)
        lv = loss(m, cfg_b, batch["mel"].to(dtype), *args)
        lv.backward()
        return lv.detach(), {k: torch.zeros_like(p) if p.grad is None else p.grad
                             for k, p in m.named_parameters()}

    def dists(lv, g):
        return {"loss": abs(lv.double() - l64).item() / abs(l64).item(), **tree_rel(g, g64)}

    l64, g64 = grads(torch.float64)
    own = dists(*grads(torch.float32))
    yard = max(own.values())
    worst = max(own, key=own.get)
    log(f"train (b): the route in f32 against f64 at full width, {TRAIN_DEPTH64} + "
        f"{TRAIN_DEPTH64} layers (TF32 off): loss rel {own['loss']:.3e}, leaves' gradients "
        f"median {np.median(list(own.values())):.3e}, largest {own[worst]:.3e} ({worst}) "
        f"({card})")

    def detached_first(block):
        seen = []

        def run(bp, x, n_heads):
            out = block(bp, x, n_heads)
            seen.append(1)
            return out.detach() if len(seen) == 1 else out
        return run

    def q_only(p, x, n_heads, mask=None):
        b, t, d = x.shape
        q = wmodel._heads(wmodel.linear(p["q"], x), n_heads) * (d // n_heads) ** -0.25
        k = wmodel._heads(wmodel.linear(p["k"], x), n_heads)
        v = wmodel._heads(wmodel.linear(p["v"], x), n_heads)
        return wmodel.linear(p["o"], wmodel.attend_plain(q, k, v, mask).reshape(b, t, d))

    def half_means(m, c, mel, tin, tout, mask):
        return 0.5 * sum(loss_fn(m, c, mel[s], tin[s], tout[s], mask[s])
                         for s in (slice(0, 1), slice(1, 2)))

    faults = [("encoder block 0's output detached", lambda: faulty(
                  wmodel, "encoder_block_xla", detached_first(wmodel.encoder_block_xla),
                  lambda: grads(torch.float32))()),
              ("the loss as a mean of two half-batch means",
               lambda: grads(torch.float32, half_means)),
              ("hd^-0.25 on q only", faulty(wmodel, "attention_xla", q_only,
                                            lambda: grads(torch.float32)))]
    for label, run in faults:
        d = dists(*run())
        w = max(d, key=d.get)
        control_ratio("train (b)", label, [x / yard for x in d.values()],
                      f"loss rel {d['loss']:.3e}, largest {d[w]:.3e} ({w})",
                      "the route's own distance from f64")
    g32 = grads(torch.float32)[1]

    def stepped(dtype, decay):
        """One AdamW step from tree_b in `dtype` on the f32 route's gradients:
        each leaf's update, in f64."""
        m = wmodel.ParamTree(pytree.unflatten(
            {k: v.to(dtype, copy=True) for k, v in pytree.flatten(tree_b).items()}))
        named = list(m.named_parameters())
        for k, p in named:
            p.grad = g32[k].to(dtype)
        adamw(named, lr=TRAIN_LR, weight_decay=decay).step()
        flat = pytree.flatten(tree_b)
        return {k: p.detach().double() - flat[k].double() for k, p in named}

    ref = stepped(torch.float64, 0.01)
    own_s = tree_rel(stepped(torch.float32, 0.01), ref)
    yard_s = max(own_s.values())
    fault_s = tree_rel(stepped(torch.float32, 1e-4), ref)
    log(f"train (b): one AdamW step (decay 0.01) in f32 against f64 on the same gradients: "
        f"updates' largest rel {yard_s:.3e} ({max(own_s, key=own_s.get)})")
    w = max(fault_s, key=fault_s.get)
    control_ratio("train (b)", "AdamW at optax's default decay 1e-4",
                  [fault_s[k] / yard_s for k in fault_s], f"largest {fault_s[w]:.3e} ({w})",
                  "the f32 step's own distance from f64")
    del tree_b, g64, g32, ref
    torch.cuda.empty_cache()

    # (d) a world of one on NCCL, then the grad guard
    mesh = make_mesh()
    log(f"train (d): make_mesh() {tuple(mesh.mesh.shape)} {mesh.mesh_dim_names} on "
        f"{dist.get_backend()}, world {dist.get_world_size()}")
    try:
        t0 = time.perf_counter()
        _, mesh_losses = train(params0, cfg, batcher, TRAIN_MESH_STEPS, mesh=mesh, log_every=0,
                               optimizer=lambda ps: adamw(ps, lr=TRAIN_LR))
        wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    rel = max(abs(a - b) / abs(b) for a, b in zip(mesh_losses, losses))
    log(f"train (d): train(mesh=...) losses {mesh_losses} against (a)'s "
        f"{losses[:TRAIN_MESH_STEPS]}: " + ("bit for bit" if mesh_losses ==
                                            losses[:TRAIN_MESH_STEPS] else f"rel {rel:.3e}")
        + f" (bound {TRAIN_MESH_REL}), {wall:.1f} s wall")
    if not rel <= TRAIN_MESH_REL:
        raise AssertionError("train (d): the mesh's losses are not (a)'s")
    del params0
    torch.cuda.empty_cache()
    randn = randn_on(dev)
    q, k, v = (randn(1, cfg.n_audio_ctx, cfg.n_audio_head, 64, dtype=torch.bfloat16)
               for _ in range(3))
    q.requires_grad_(True)
    try:
        ea.encoder_attention(q, k, v)
        raise AssertionError("train (d): encoder_attention took an input that requires grad")
    except RuntimeError as err:
        refused = str(err)
    with torch.no_grad():
        out = ea.encoder_attention(q, k, v)
    torch.cuda.synchronize()
    log(f"train (d) grad guard: under grad mode {refused!r}; under no_grad it ran "
        f"({tuple(out.shape)}, finite {bool(torch.isfinite(out).all())})")
    if "no backward" not in refused or not torch.isfinite(out).all():
        raise AssertionError("train (d): the grad guard")
    return counts


def hopper_report(lib_path: Path) -> None:
    """Phase 2: the build's warnings; each TMA + wgmma kernel's ptxas lines
    (registers, stack, spills) from the build log and, where cuobjdump is
    present, its count of wgmma instructions (HGMMA for bf16, IGMMA for
    s8 in the SASS). Raises on a spill in any instantiation, or on a wgmma
    kernel that holds none."""
    info, name = {}, None
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "warning" in line.lower() or "Performance Loss" in line:
            log(f"  ptxas: {line.strip()}")
        found = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if found:
            name = found.group(1)
            info.setdefault(name, [])
        elif name and ("registers" in line or "spill" in line):
            info[name].append(line.split("info    :")[-1].strip())
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    hgmma = None
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                              text=True).stdout
        hgmma, fn = {}, None
        for line in sass.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                fn = found.group(1)
                hgmma[fn] = 0
            elif fn and re.search(r"\b[HIQ]GMMA", line):
                hgmma[fn] += 1
    for short, wgmma in HOPPER_KERNELS.items():
        names = [n for n in info if f"{len(short)}{short}" in n]  # the mangled identifier
        if not names:
            raise AssertionError(f"ptxas reported no kernel {short}")
        for name in names:
            lines = "; ".join(info[name])
            count = None if hgmma is None else sum(c for n, c in hgmma.items() if name in n)
            log(f"ptxas {short}" + (f" ({name})" if len(names) > 1 else "") + f": {lines}; "
                "wgmma (HGMMA/IGMMA) instructions: "
                + ("not counted (no cuobjdump)" if count is None else str(count)))
            if "0 bytes spill stores, 0 bytes spill loads" not in lines:
                raise AssertionError(f"{name} spills: {lines}")
            if wgmma and count == 0:
                raise AssertionError(f"{name} holds no wgmma instruction")


def randn_on(dev, seed: int = SEED):
    """randn(*shape, dtype, scale) on `dev` from a generator seeded with `seed`."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)
    return randn


def mesh_generators(tree, cfg, mesh, dev):
    """(the unsharded generator on the per-layer route, the mesh's): the
    same tree, the whole-stack step off in both."""
    from tpu_audio_torch.models.orpheus import model as om

    ref = om.CausalLMGenerator(tree, cfg, max_cache=None, pad_id=om.PAD_TOKEN)
    ref._fused_ok = lambda: False
    return ref, om.CausalLMGenerator(tree, cfg, max_cache=None, pad_id=om.PAD_TOKEN, mesh=mesh)


@torch.inference_mode()
def first_logits(gen, prompt: list[int], steps: int, dev) -> torch.Tensor:
    """The f32 logits of the prefill and of `steps` greedy steps after it
    (each fed the argmax of the last), through `gen`'s own forward."""
    from tpu_audio_torch.nn import transformer

    p, start = gen._prompt(prompt, 32)
    cache, extra = transformer.decode_cache_and_mask(gen.cfg_run, p.shape[0] + steps, start,
                                                     False, dtype=gen.cache_dtype, device=dev)
    off = torch.tensor([start], device=dev)
    lg, cache = gen._forward(p[None], cache, extra, off)
    out = [lg[0, -1].float()]
    for _ in range(steps):
        lg, cache = gen._forward(out[-1].argmax().view(1, 1), cache, extra, off)
        out.append(lg[0, -1].float())
    return torch.stack(out)


def mesh_gap(gen, prompt, kw, card: str) -> None:
    """Where a world-of-one mesh's extra time a token goes: the host time
    spent in `dist.all_reduce` during a generate, and the generate again
    with the all-reduces skipped (an identity at world one)."""
    import torch.distributed as dist

    from tpu_audio_torch.nn import transformer

    spent = []

    def timed(*args, **kwargs):
        t = time.perf_counter()
        out = real(*args, **kwargs)
        spent.append(time.perf_counter() - t)
        return out

    def per_token():
        torch.cuda.synchronize()
        t = time.perf_counter()
        gen.generate(prompt, **kw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / kw["max_new"]

    real = dist.all_reduce
    with patched(dist, "all_reduce", timed):
        with_calls = per_token()
    with patched(transformer, "psum", lambda t, axis_name=None: t):
        skipped = per_token()
    log(f"mesh (a) w8a8: {len(spent)} all-reduces a generate, {sum(spent) * 1e3 / kw['max_new']:.2f} "
        f"ms of host time a token in them ({sum(spent) / len(spent) * 1e6:.1f} us a call); ms a "
        f"token {with_calls:.2f} with them, {skipped:.2f} with them skipped ({card})")


def mesh_layer_trees(dev) -> tuple:
    """(cfg, {kind: tree}): one Llama-3.2-3B layer (random, seed SEED + 7)
    in each served format: w8a8 and W4A8 (fused), super-group (fused), q4
    (the checkpoint's unfused leaves)."""
    import dataclasses

    from tpu_audio_torch.models.orpheus.model import LLAMA_3B
    from tpu_audio_torch.ops import quant

    cfg = dataclasses.replace(LLAMA_3B, n_layers=1, vocab_size=256)
    q4 = quant.quantize_tree(llama_params(cfg, dev, SEED + 7), bits=4,
                             predicate=lambda k, v: not k.startswith("embed"))
    return cfg, {"w8a8": quant.requantize_tree_int8(q4), "w4a8": quant.repack_tree_w4a8(q4),
                 "sg": quant.requantize_tree_w4a8_sg(q4), "q4": q4}


def mesh_layer(kind: str, tree: dict, cfg, tp: int, randn, total: dict) -> None:
    """Phase 21 (b) and (c) on one 3B layer at tensor-parallel width tp,
    rank by rank in this process: each rank's column- and row-parallel
    products through the route (the kernels on the rank's local shapes),
    every kernel call held against its plain version; the other entry of
    the format on the same local leaves (rows 13, 14, 16); the column
    blocks against the unsharded product's; the row-parallel sum (summed
    in bf16, as the all-reduce sums) at most SLICE_RATIO times as far from
    the exact f32 product as the unsharded kernel, plus tp half-ulps of
    bf16 (MESH_SUM_ULP: each partial is rounded to bf16 before the sum),
    cosine > 0.999 to the unsharded product; three planted controls against
    the exact f32 product."""
    from tpu_audio_torch.nn import layers, transformer
    from tpu_audio_torch.ops import quant
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
    from tpu_audio_torch.ops.kernels import quant_matmul as qmm
    from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm
    from tpu_audio_torch.parallel import tp_quant

    mods = (i8mm, w4mm, qmm)
    tag = f"mesh (b) {kind} tp {tp}"
    locs = [tp_quant.local_params(tree, cfg, tp, r) for r in range(tp)]
    full = transformer._layer(tree["layers"], 0)
    views = [transformer._layer(lc["layers"], 0) for lc in locs]
    fused = "qkv" in tree["layers"]["attn"]
    hd, h, kvh = cfg.hd, cfg.n_heads, cfg.kv_heads
    cols = ([("attn", "qkv", [h * hd, kvh * hd, kvh * hd]),
             ("mlp", "gateup", [cfg.hidden_dim] * 2)] if fused else
            [("attn", n, [w]) for n, w in (("q", h * hd), ("k", kvh * hd), ("v", kvh * hd))]
            + [("mlp", n, [cfg.hidden_dim]) for n in ("gate", "up")])
    rows_ = [("attn", "o", h * hd), ("mlp", "down", cfg.hidden_dim)]

    def exact(sub, name, x):
        return x.float() @ quant.dequantize(tree["layers"][sub][name])[0].T

    def rel(a, b):
        return measure(a, b)[1]

    reset(*mods)
    readings = {"col": [], "col faults": [], "row": [], "row faults": [], "drop": [],
                "wrong": []}
    with held_calls(tag, i8mm, ("int8_matmul", "int8_matmul_stacked"), 0.0), \
            held_calls(tag, w4mm, tuple(w4mm.LAUNCHES), 1e-5), \
            held_calls(tag, qmm, ("quant_matmul",), 1e-4):
        for n_rows in MESH_ROWS:
            x = randn(n_rows, cfg.dim, dtype=torch.bfloat16)
            for sub, name, sections in cols:
                perm = torch.as_tensor(tp_quant._fused_perm(sections, tp), device=x.device)
                ref = layers.linear(full[sub][name], x)[..., perm]
                ex = exact(sub, name, x)[..., perm]
                n = ref.shape[-1] // tp
                got = [layers.linear(v[sub][name], x) for v in views]
                compare(f"{tag} {sub}.{name} {n_rows} rows: the ranks' blocks against the "
                        f"unsharded product's", torch.cat(got, -1), ref, rel=1e-3)
                leaf = tree["layers"][sub][name]
                for r in range(tp):
                    blk = slice(r * n, (r + 1) * n)
                    e = rel(got[r], ex[..., blk])
                    readings["col"].append(e)
                    if len(sections) > 1 and r == tp - 1:  # the unpermuted fused block
                        bad = transformer._layer({"x": tp_quant._leaf_local(leaf, "col", r, tp)},
                                                 0)["x"]
                        readings["col faults"].append(rel(layers.linear(bad, x), ex[..., blk]) / e)
            for sub, name, k in rows_:
                xr = randn(n_rows, k, dtype=torch.bfloat16)
                kb = k // tp
                parts = [layers.linear(v[sub][name], xr[..., r * kb:(r + 1) * kb].contiguous())
                         for r, v in enumerate(views)]
                total_ = parts[0]
                for p in parts[1:]:
                    total_ = total_ + p  # bf16 adds, as the all-reduce sums bf16 partials
                ref = layers.linear(full[sub][name], xr)
                ex = exact(sub, name, xr)
                e_sum, e_full = rel(total_, ex), rel(ref, ex)
                bound = SLICE_RATIO * e_full + tp * MESH_SUM_ULP
                cos = measure(total_, ref)[2]
                text = (f"{tag} {sub}.{name} {n_rows} rows: the sum of {tp} partials {e_sum:.3e} "
                        f"from the exact f32 product, the unsharded kernel {e_full:.3e} (bound "
                        f"{bound:.3e}), cosine {cos:.6f} to the unsharded product")
                if not (e_sum <= bound and cos > 0.999):
                    raise AssertionError(f"{text}: outside")
                log(text)
                readings["row"].append((e_sum, e_full))
                dropped = sum(parts[:-1][1:], parts[0]) if tp > 1 else torch.zeros_like(ref)
                readings["drop"].append(rel(dropped, ex) / e_sum)
                wrong = layers.linear(views[1][sub][name], xr[..., :kb].contiguous())
                readings["wrong"].append(rel(sum(parts[1:], wrong), ex) / e_sum)
            # the other entry of the format on the same local leaves
            for v, lc in zip(views, locs):
                for sub, name, k in [(s, n, None) for s, n, _ in cols] + rows_:
                    leaf = lc["layers"][sub][name]
                    kin = x.shape[-1] if k is None else k // tp
                    xx = randn(n_rows, kin, dtype=torch.bfloat16)
                    if "weight_i8" in leaf:
                        i8mm.int8_matmul_stacked(xx, leaf["weight_i8"], leaf["scale_i8"][0], 0,
                                                 out_dtype=torch.bfloat16)
                    elif "weight_q4p" in leaf:
                        w4mm.w4a8_matmul(xx, leaf["weight_q4p"][0], leaf["scales"][0],
                                         leaf["biases"][0])
                    elif "weight_q4s" in leaf:
                        w4mm.w4a8_sg_matmul(xx, leaf["weight_q4s"][0], leaf["scales_sg"][0])
    counts = launch_counts(*mods)
    for n, c in counts.items():
        total[n] = total.get(n, 0) + c
    log(f"{tag}: launches {({n: c for n, c in counts.items() if c})}; the ranks' column "
        f"blocks from the exact f32 product: largest rel {max(readings['col']):.3e}; the "
        f"row-parallel sums: largest rel {max(e for e, _ in readings['row']):.3e} from the exact "
        f"f32 product, the unsharded kernel's {max(e for _, e in readings['row']):.3e}")
    if readings["col faults"]:
        control_ratio(tag, "the fused qkv / gateup unpermuted", readings["col faults"],
                      "a rank's block from the exact f32 product",
                      "the rank's own distance from it")
    control_ratio(tag, "one rank's partial dropped from the sum", readings["drop"],
                  "the sum from the exact f32 product", "the route's sum's distance from it")
    control_ratio(tag, "a rank handed the next rank's shard", readings["wrong"],
                  "the sum from the exact f32 product", "the route's sum's distance from it")


def mesh_slice(dev, card: str) -> dict:
    """Phase 21: tensor-parallel serving. (a) a world-of-one NCCL mesh
    (`make_mesh()`) at Llama-3.2-3B width on the w8a8, W4A8 and q4 trees:
    the first steps' f32 logits and a sampled generate's tokens of
    `CausalLMGenerator(mesh=)` bit for bit those of `mesh=None` on the same
    per-layer route, ms a token of both (in turns), an all-reduce's device
    time, the launches; (b), (c) `mesh_layer` at tp 2 and 4 on one layer of
    each tree, and the super-group tree's refusal at tp 8; (d)
    `TTS.orpheus(mesh=)` on the w8a8 tree: a sentence through SNAC equal to
    the unsharded per-layer engine's; (e) CosyVoice2 (the fp 0.5B LM, the
    flow by local shards under flow_rules) and `CosyVoice3Engine.from_params
    (mesh=)` at world one: each LM's tokens and a voice conversion (the
    flow and HiFT) equal to its unsharded per-layer engine's. Returns the
    launches."""
    import torch.distributed as dist

    from tpu_audio_torch.api.tts import TTS
    from tpu_audio_torch.codecs.s3gen import model as s3gen
    from tpu_audio_torch.codecs.s3tokenizer import model as s3tok
    from tpu_audio_torch.codecs.snac import model as snac
    from tpu_audio_torch.models.cosyvoice2 import lm as cvlm
    from tpu_audio_torch.models.cosyvoice3 import model as cv3
    from tpu_audio_torch.models.orpheus import model as om
    from tpu_audio_torch.models.orpheus.model import LLAMA_3B
    from tpu_audio_torch.ops import quant
    from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
    from tpu_audio_torch.ops.kernels import quant_matmul as qmm
    from tpu_audio_torch.ops.kernels import w4a8_matmul as w4mm
    from tpu_audio_torch.ops.sampling import SamplerConfig
    from tpu_audio_torch.parallel import make_mesh, tp_quant
    from tpu_audio_torch.utils.weights import ShapeRNG

    mods = (i8mm, w4mm, qmm)
    total: dict = {}
    t0 = time.perf_counter()
    q4 = quant.quantize_tree(llama_params(LLAMA_3B, dev, SEED), bits=4)
    trees = {"w8a8": quant.requantize_tree_int8(q4), "w4a8": quant.repack_tree_w4a8(q4),
             "q4": q4}
    torch.cuda.synchronize()
    log(f"mesh: Llama-3.2-3B random weights (seed {SEED}), its q4, w8a8 and W4A8 trees in "
        f"{time.perf_counter() - t0:.1f} s")
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = make_mesh()
    group = mesh.get_group("tp")
    log(f"mesh (a): make_mesh() {tuple(mesh.mesh.shape)} {mesh.mesh_dim_names} on "
        f"{dist.get_backend()}, world {dist.get_world_size()}")
    try:
        buf = torch.randn(1, LLAMA_3B.dim, device=dev, dtype=torch.bfloat16)
        ar_ms = time_ms(lambda: dist.all_reduce(buf, group=group), 200)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(200):
            dist.all_reduce(buf, group=group)
        torch.cuda.synchronize()
        idle_us = (time.perf_counter() - t1) * 5e3
        # behind a spin kernel: a call that waits for the card (a host sync)
        # returns only after the spin, one that queues returns at once
        torch.cuda._sleep(SPIN_CYCLES)
        t1 = time.perf_counter()
        dist.all_reduce(buf, group=group)
        busy_ms = (time.perf_counter() - t1) * 1e3
        torch.cuda.synchronize()
        spin_ms = (time.perf_counter() - t1) * 1e3
        log(f"mesh (a): one all-reduce of a (1, {LLAMA_3B.dim}) bf16 row at world one: "
            f"{ar_ms * 1e3:.2f} us of device time, {idle_us:.1f} us of host time a call, 200 "
            f"in a row; behind a {spin_ms:.1f} ms spin kernel the call returned after "
            f"{busy_ms:.3f} ms ({card})")
        prompt = om.build_prompt_ids([(i * 7919) % 120000 for i in range(20)])
        sampler = SamplerConfig(temperature=0.6, top_p=0.8, repetition_penalty=1.3,
                                repetition_window=om.REPETITION_WINDOW)
        kw = dict(sampler=sampler, eos_ids=(om.END_TOKEN,), max_new=MESH_NEW, seed=1)
        log(f"mesh (a): quant_matmul's rows a launch at 32 rows, K {LLAMA_3B.hidden_dim} → "
            f"{LLAMA_3B.dim} (the q4 tree's prefill of the down projection, ROADMAP C36): "
            + ", ".join(f"{dt} x {qmm.rows_a_launch(dev, 32, LLAMA_3B.hidden_dim, LLAMA_3B.dim, 4, dt)}"
                        for dt in (torch.float32, torch.bfloat16)))
        for kind, tree in trees.items():
            ref, gen = mesh_generators(tree, LLAMA_3B, mesh, dev)
            held_exact(f"mesh (a) {kind}: the prefill's and {MESH_LOGIT_STEPS} steps' f32 "
                       f"logits against mesh=None's",
                       first_logits(gen, prompt, MESH_LOGIT_STEPS, dev),
                       first_logits(ref, prompt, MESH_LOGIT_STEPS, dev))
            walls, toks = {"mesh": [], "none": []}, {}
            for name in ("none", "mesh", "mesh", "none"):
                g = gen if name == "mesh" else ref
                reset(*mods)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                toks[name] = g.generate(prompt, **kw)
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t1) * 1e3 / MESH_NEW)
                if name == "mesh":
                    counts = launch_counts(*mods)
                    for n, c in counts.items():
                        total[n] = total.get(n, 0) + c
            need = {"w8a8": ("int8_matmul",), "w4a8": ("w4a8_matmul", "w4a8_matmul_stacked"),
                    "q4": ("quant_matmul",)}[kind]
            if not all(counts[n] for n in need):
                raise AssertionError(f"mesh (a) {kind}: a kernel of the path never launched: "
                                     f"{counts}")
            if toks["mesh"] != toks["none"] or len(toks["mesh"]) < MESH_NEW // 2:
                raise AssertionError(f"mesh (a) {kind}: tokens {toks['mesh']} against "
                                     f"mesh=None's {toks['none']}")
            if kind == "w8a8":
                mesh_gap(gen, prompt, kw, card)
            log(f"mesh (a) {kind}: {len(toks['mesh'])} tokens equal to mesh=None's; ms a token "
                f"(prefill included) mesh {walls['mesh']}, mesh=None {walls['none']}; launches "
                f"a generate {({n: c for n, c in counts.items() if c})}, "
                f"{sum(counts.values()) / MESH_NEW:.1f} a token ({card})")
        # (d) the engine through SNAC
        snac_params = snac.init_params(SEED + 1, snac.SNACConfig(), torch.bfloat16, dev)
        ref = TTS.orpheus(device=dev).from_params(trees["w8a8"], LLAMA_3B, snac_params)
        ref.lm._fused_ok = lambda: False
        eng = TTS.orpheus(mesh=mesh, device=dev).from_params(trees["w8a8"], LLAMA_3B,
                                                             snac_params, mesh=mesh)
        got, want = (e.generate(MESH_CV_TEXT, max_new_tokens=MESH_TTS_NEW).samples
                     for e in (eng, ref))
        if not (len(got) and np.array_equal(got, want)):
            raise AssertionError(f"mesh (d): {len(got)} samples against mesh=None's "
                                 f"{len(want)}, or unequal")
        log(f"mesh (d): TTS.orpheus(mesh=) on w8a8, {MESH_TTS_NEW} tokens: {len(got)} samples "
            f"({len(got) / 24000:.2f} s) equal to the per-layer engine's bit for bit")
        del trees, q4, ref, eng
        torch.cuda.empty_cache()
        # (e) the CosyVoices at world one
        lm_cfg, s3cfg, tokcfg = cvlm.CosyLMConfig(), s3gen.S3GenConfig(), s3tok.S3TokenizerConfig()
        bf16, _ = cosy_lm_trees(lm_cfg, dev)
        s3 = s3_card_params(s3gen.numpy_params(ShapeRNG(), s3cfg), dev, SEED + 1)
        tokp = s3_card_params(s3tok.numpy_params(ShapeRNG(), tokcfg), dev, SEED + 2)
        flow_cfg = cv3.CV3FlowConfig()
        flow = s3_card_params(cv3.numpy_params(ShapeRNG(), flow_cfg), dev, SEED + 5)
        src = (0.1 * np.random.default_rng(SEED + 21).standard_normal(
            MESH_CV_SECONDS * 16000)).astype(np.float32)
        text_ids = list(MESH_CV_TEXT.encode())
        for name, factory, flow_tree, fcfg in (
                ("CosyVoice2", TTS.cosyvoice2, s3, s3cfg),
                ("CosyVoice3", TTS.cosyvoice3, flow, flow_cfg)):
            engines = [factory(device=dev).from_params(bf16, lm_cfg, flow_tree, fcfg, tokp,
                                                       tokcfg, mesh=m) for m in (None, mesh)]
            engines[0].lm.fused_ok = lambda: False
            t1 = time.perf_counter()
            want, got = (e.lm.generate(text_ids, [], [0, 1, 2, 3], seed=3, max_new=MESH_CV_NEW)
                         for e in engines)
            if got != want or not got:
                raise AssertionError(f"mesh (e) {name}: LM tokens {got} against mesh=None's "
                                     f"{want}")
            want_a, got_a = (e.voice_conversion(src, 16000) for e in engines)
            if not (len(got_a) and np.array_equal(got_a, want_a)):
                raise AssertionError(f"mesh (e) {name}: {len(got_a)} samples against "
                                     f"mesh=None's {len(want_a)}, or unequal")
            log(f"mesh (e) {name} from_params(mesh=): the fp LM's {len(got)} tokens and "
                f"{MESH_CV_SECONDS} s converted by the flow's local shards under flow_rules and "
                f"HiFT ({len(got_a)} samples) equal to the unsharded per-layer engine's bit for "
                f"bit ({time.perf_counter() - t1:.1f} s for both)")
        del bf16, s3, tokp, flow, engines
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    # (b), (c): tp 2 and 4, rank by rank, on one layer
    cfg, layer_trees = mesh_layer_trees(dev)
    randn = randn_on(dev, SEED + 21)
    for tp in MESH_TPS:
        for kind, tree in layer_trees.items():
            mesh_layer(kind, tree, cfg, tp, randn, total)
    missing = [n for n in ("int8_matmul", "int8_matmul_stacked", "w4a8_matmul",
                           "w4a8_matmul_stacked", "w4a8_sg_matmul", "w4a8_sg_matmul_stacked",
                           "quant_matmul") if not total.get(n)]
    if missing:
        raise AssertionError(f"mesh: kernels never launched on the ranks' shapes: {missing}")
    try:
        tp_quant.check_tp_quant_supported(layer_trees["sg"], cfg, 8)
    except ValueError as err:
        log(f"mesh (b) sg tp 8: refused at construction: {err}")
    else:
        raise AssertionError("mesh (b): the super-group tree at tp 8 was not refused")
    return total


def examples_slice(dev, card: str) -> dict:
    """Phase 22: the port's examples on the card. The console
    (`examples.webapp`, its --tiny engines) on 127.0.0.1 at a free port,
    served from a thread: the page, one TTS WAV, one SSE stream and one STT
    upload; then `batch_serving`'s two runs at full width, EXAMPLE_LAYERS
    deep, on random weights: Whisper large-v3-turbo's `transcribe_batch` of
    EXAMPLE_CLIPS and Orpheus's `generate_batch` of two texts on the w8a8
    tree. Returns their launches."""
    import base64
    import threading
    import urllib.request

    from tpu_audio_torch.examples import batch_serving, webapp
    from tpu_audio_torch.ops.kernels import (cross_kv_attention, encoder_attention,
                                             fused_encoder, fused_mel, fused_step, int8_matmul,
                                             quant_matmul, w4a8_matmul)
    from tpu_audio_torch.utils.audio_io import write_wav

    mods = (fused_mel, fused_encoder, encoder_attention, cross_kv_attention, int8_matmul,
            fused_step, quant_matmul, w4a8_matmul)
    t0 = time.perf_counter()
    httpd = webapp.serve(port=0, tiny=True, poll=True, device=str(dev))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        def get(path):
            with urllib.request.urlopen(url + path, timeout=300) as r:
                return r.headers.get("Content-Type", ""), r.read()
        ctype, page = get("/")
        if "text/html" not in ctype or b"tpu-audio" not in page:
            raise AssertionError(f"examples: the console's page: {ctype}")
        ctype, wav = get("/api/tts?engine=marvis&text=Hello%20from%20the%20card")
        n = int.from_bytes(wav[40:44], "little")
        if ctype != "audio/wav" or wav[:4] != b"RIFF" or not n or len(wav) != 44 + n:
            raise AssertionError(f"examples: /api/tts gave {ctype}, {len(wav)} bytes")
        ctype, body = get("/api/tts_stream?engine=marvis&text=Hi")
        events = [json.loads(ln[6:]) for ln in body.decode().splitlines()
                  if ln.startswith("data: ")]
        pcm = [np.frombuffer(base64.b64decode(e["pcm"]), np.float32) for e in events[:-1]]
        if (events[-1] != {"done": True} or not pcm
                or not all(len(p) and np.isfinite(p).all() for p in pcm)):
            raise AssertionError(f"examples: /api/tts_stream gave {len(events)} events")
        audio = (0.1 * np.sin(np.arange(16000) / 10)).astype(np.float32)
        req = urllib.request.Request(url + "/api/stt?engine=funasr",
                                     data=webapp.wav_bytes(audio, 16000), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            stt = json.loads(r.read())
        if not isinstance(stt.get("text"), str) or "seconds" not in stt:
            raise AssertionError(f"examples: /api/stt gave {stt}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    log(f"examples: the console at {url} (--tiny engines on {dev}): the page, a WAV of "
        f"{n // 2} samples, {len(pcm)} SSE chunks, an STT upload in {stt['seconds']:.3f} s; "
        f"{time.perf_counter() - t0:.1f} s")

    total: dict = {}
    rng = np.random.default_rng(SEED + 22)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, secs in enumerate(EXAMPLE_CLIPS):
            paths.append(os.path.join(tmp, f"clip{i}.wav"))
            write_wav(paths[-1], (0.1 * rng.standard_normal(secs * 16000)).astype(np.float32),
                      16000)
        base = ["--device", str(dev), "--layers", str(EXAMPLE_LAYERS)]
        for mode, args, need in (
                ("stt", ["stt", *paths, "--batch-size", "2"], ("fused_log_mel", "ln_qkv")),
                ("tts", ["tts", *ORPHEUS_TEXTS[:2], "--max-new-tokens", "28", "--out-dir", tmp],
                 ("int8_matmul",))):
            reset(*mods)
            t1 = time.perf_counter()
            out = batch_serving.main(base + args)
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts(*mods).items() if v}
            log(f"examples: batch_serving {mode} (full width, {EXAMPLE_LAYERS} layer): "
                f"{len(out)} outputs in {time.perf_counter() - t1:.1f} s; launches {counts}")
            if len(out) != 2 or not all(counts.get(k) for k in need):
                raise AssertionError(f"examples: batch_serving {mode}: a kernel of its path "
                                     f"never launched ({need}) or {len(out)} outputs")
            if mode == "stt" and counts["fused_log_mel"] != len(paths):
                raise AssertionError("examples: batch_serving stt: not one log-mel launch a clip")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    return total


def tts_slices(dev, card: str, phases=((12, oute_slice), (13, marvis_slice))) -> dict:
    """Phases 12 and 13 (or `phases`), each with its wall and its launches
    on a line of its own; returns their launches summed."""
    total = {}
    for phase, run in phases:
        t_phase = time.perf_counter()
        counts = run(dev, card)
        log(f"phase {phase} launches: { {n: c for n, c in counts.items() if c} }")
        log(f"phase {phase} wall: {time.perf_counter() - t_phase:.1f} s ({card})")
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        torch.cuda.empty_cache()
    return total


def print_result(rows: list, launches: dict) -> None:
    """The last two lines: the per-kernel JSON and the ok line, once every
    end-to-end control read at least CV_FAULT_RATIO."""
    refuse_weak_controls()
    print(json.dumps({"kernels": [{**r, "launches": launches[r["name"]]} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    if not (ROOT / "tpu_audio_torch").is_dir():
        raise SystemExit(f"chip_smoke: {ROOT} holds no tpu_audio_torch package")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tpu_audio_torch.models.whisper import load as wload
    from tpu_audio_torch.models.whisper import model as wmodel
    from tpu_audio_torch.models.whisper.config import PRESETS
    from tpu_audio_torch.models.whisper.tokenizer import BPE, WhisperTokenizer
    from tpu_audio_torch.ops import quant
    from tpu_audio_torch.ops.kernels import _build
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
        if any(w in line for w in ("entry function", "registers", "spill", "error")):
            log(f"  ptxas: {line.strip()}")
    hopper_report(lib_path)
    if "--orpheus-only" in sys.argv[1:]:  # phases 1, 2, B6's part of 3, and 10
        rows = []
        o_trees = orpheus_trees(dev)
        randn = randn_on(dev)
        check_w4a8(o_trees, randn, rows)
        check_fused_step_llama(o_trees, dev, randn, rows)
        print_result(rows, orpheus_slice(o_trees, dev, card))
        return
    if "--mel-only" in sys.argv[1:]:  # phases 1, 2, the mel part of 3, phase 4's MelExtractor
        rng = np.random.default_rng(SEED)
        clips = [(rng.standard_normal(CLIP_SECONDS * 16000) * 0.1).astype(np.float32)
                 for _ in range(N_CLIPS)]
        rows, n_mels = [], PRESETS["large-v3-turbo"].n_mels
        check_mel(n_mels, dev, randn_on(dev), rows, card)
        print_result(rows, mel_slice(clips, n_mels, dev, card))
        return
    if "--tts-only" in sys.argv[1:]:  # phases 1, 2, 12 and 13
        print_result([], tts_slices(dev, card))
        return
    if "--cosyvoice-only" in sys.argv[1:]:  # phases 1, 2 and 14
        print_result([], tts_slices(dev, card, ((14, cosyvoice_slice),)))
        return
    if "--spec-only" in sys.argv[1:]:  # phases 1, 2 and 15
        print_result([], tts_slices(dev, card, ((15, spec_slice),)))
        return
    if "--cosyvoice3-only" in sys.argv[1:]:  # phases 1, 2 and 16
        print_result([], tts_slices(dev, card, ((16, cosyvoice3_slice),)))
        return
    if "--chatterbox-only" in sys.argv[1:]:  # phases 1, 2 and 17
        print_result([], tts_slices(dev, card, ((17, chatterbox_slice),)))
        return
    if "--kokoro-only" in sys.argv[1:]:  # phases 1, 2 and 18
        print_result([], tts_slices(dev, card, ((18, kokoro_slice),)))
        return
    if "--serve-only" in sys.argv[1:]:  # phases 1, 2 and 19
        print_result([], tts_slices(dev, card, ((19, serve_slice),)))
        return
    if "--train-only" in sys.argv[1:]:  # phases 1, 2 and 20
        print_result([], tts_slices(dev, card, ((20, train_slice),)))
        return
    if "--mesh-only" in sys.argv[1:]:  # phases 1, 2 and 21
        print_result([], tts_slices(dev, card, ((21, mesh_slice),)))
        return
    if "--examples-only" in sys.argv[1:]:  # phases 1, 2 and 22
        print_result([], tts_slices(dev, card, ((22, examples_slice),)))
        return
    if "--load-only" in sys.argv[1:]:  # phases 1, 2 and 11
        t_phase = time.perf_counter()
        launches = load_slice(dev, card)
        log(f"phase 11 wall: {time.perf_counter() - t_phase:.1f} s ({card})")
        print_result([], launches)
        return
    if "--funasr-only" in sys.argv[1:]:  # phases 1, 2, Fun-ASR's part of 3, and 8
        rows, randn = [], randn_on(dev)
        trees = funasr_trees(dev)
        check_quant_matmul(trees, randn, rows)
        check_fused_step(trees, dev, randn, rows)
        print_result(rows, funasr_slice(trees, dev, card))
        return

    # ------------------------------------------------ model (random weights)
    cfg = PRESETS["large-v3-turbo"]
    t0 = time.perf_counter()
    params = wmodel.init_params(SEED, cfg, torch.bfloat16, dev)
    model = wmodel.Whisper(cfg, params)
    tok = WhisperTokenizer(BPE({bytes([i]): i for i in range(256)}), True, cfg.num_languages)
    rng = np.random.default_rng(SEED)
    clips = [(rng.standard_normal(CLIP_SECONDS * 16000) * 0.1).astype(np.float32)
             for _ in range(N_CLIPS)]
    if "--decode-only" in sys.argv[1:]:  # phases 1, 2, the decode kernels' part of 3, 4 and 5
        model_i8 = wmodel.Whisper(cfg, wload.serve_tree_int8(params, encoder=False))
        del params
        rows, randn = [], randn_on(dev)
        check_cross_attention(cfg, randn, rows)
        check_decoder_step({"int8": model_i8, "bf16": model}, cfg, dev, randn, rows)
        launches, _, mel = batch_slice(model, tok, clips, dev, card)
        t_phase = time.perf_counter()
        single = single_stream(model_i8, tok, clips, mel, dev, card)
        launches["fused_whisper_decode_step"] = single["fused_whisper_decode_step"]
        log(f"phase 5 wall: {time.perf_counter() - t_phase:.1f} s")
        print_result(rows, launches)
        return
    if "--encoder-only" in sys.argv[1:]:  # phases 1, 2, the encoder kernels' part of 3, 9's A/B
        del params
        rows, randn = [], randn_on(dev)
        check_encoder_kernels(model, cfg, randn, rows)
        check_encoder_attention(cfg, randn, rows)
        counts = encoder_ab(model, clips, dev, card)
        print_result(rows, {name: n for c in counts.values() for name, n in c.items() if n})
        return
    if "--int8-only" in sys.argv[1:]:  # phases 1, 2, the int8 matmuls' part of 3, and 6
        model_i8 = wmodel.Whisper(cfg, wload.serve_tree_int8(params, encoder=False))
        del params, model
        rows = []
        check_int8_matmul(model_i8, randn_on(dev), rows)
        t_phase = time.perf_counter()
        mixed_batch(model_i8, tok, clips, None, card)
        log(f"phase 6 wall: {time.perf_counter() - t_phase:.1f} s")
        from tpu_audio_torch.ops.kernels import int8_matmul as i8mm
        print_result(rows, dict(i8mm.LAUNCHES))
        return
    if "--w8a8-only" in sys.argv[1:]:  # phases 1, 2, the W8A8 kernels' part of 3, 7's A/B
        model_w8a8 = wmodel.Whisper(cfg, wload.serve_tree_int8(params))
        del params
        rows = []
        check_int8_encoder(model_w8a8, randn_on(dev), rows)
        print_result(rows, w8a8_encoder_ab(model_w8a8, model, clips, dev, card)[1])
        return
    # the mlx group-affine trees of the published quantised checkpoints
    model_q4 = wmodel.Whisper(cfg, quant.quantize_tree(params, bits=4))
    model_q8 = wmodel.Whisper(cfg, quant.quantize_tree(params, bits=8))
    if "--q4-only" in sys.argv[1:]:  # phases 1, 2, encoder attention's part of 3, and 9
        del params
        rows = []
        check_encoder_attention(cfg, randn_on(dev), rows)
        print_result(rows, whisper_q4(model_q4, model_q8, model, tok, clips, dev, card))
        return
    # the int8 decoder tree: bf16 encoder (shared), int8 decoder and lm head
    model_i8 = wmodel.Whisper(cfg, wload.serve_tree_int8(params, encoder=False))
    # the full w8a8 tree: int8 encoder, decoder and lm head
    model_w8a8 = wmodel.Whisper(cfg, wload.serve_tree_int8(params))
    del params
    torch.cuda.synchronize()
    log(f"models: large-v3-turbo random bf16 weights (seed {SEED}), their q4 and q8 trees, "
        f"their int8 decoder tree and their full w8a8 tree in {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------- 3. kernels against plain
    t_phase = time.perf_counter()
    rows, randn = [], randn_on(dev)

    check_mel(cfg.n_mels, dev, randn, rows, card)
    check_encoder_kernels(model, cfg, randn, rows)
    check_encoder_attention(cfg, randn, rows)

    check_cross_attention(cfg, randn, rows)
    check_int8_matmul(model_i8, randn, rows)
    check_decoder_step({"int8": model_i8, "bf16": model}, cfg, dev, randn, rows)
    check_int8_encoder(model_w8a8, randn, rows)
    t0 = time.perf_counter()
    trees = funasr_trees(dev)
    torch.cuda.synchronize()
    log(f"models: Fun-ASR-Nano random bf16 weights (seed {SEED}), its q4 and int8 LLM trees "
        f"in {time.perf_counter() - t0:.1f} s")
    check_quant_matmul(trees, randn, rows)
    check_fused_step(trees, dev, randn, rows)
    t0 = time.perf_counter()
    o_trees = orpheus_trees(dev)
    torch.cuda.synchronize()
    log(f"models: Orpheus's Llama-3.2-3B random weights (seed {SEED}), its W4A8 and w8a8 trees "
        f"and the super-group 3b tree in {time.perf_counter() - t0:.1f} s")
    check_w4a8(o_trees, randn, rows)
    check_fused_step_llama(o_trees, dev, randn, rows)
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"time {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib} ({card})")
    log(f"phase 3 wall: {time.perf_counter() - t_phase:.1f} s")

    # ------------------------------------------------------- 4. the slice
    launches, wall, mel = batch_slice(model, tok, clips, dev, card)

    # ------------------------------------------- 5. single stream, 6. mixed
    t_phase = time.perf_counter()
    single = single_stream(model_i8, tok, clips, mel, dev, card)
    launches.update({name: single[name] for name in
                     ("fused_whisper_decode_step", "int8_matmul", "int8_matmul_stacked")})
    log(f"phase 5 wall: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    walls = {"bf16": wall, "mixed": mixed_batch(model_i8, tok, clips, wall, card)}
    log(f"phase 6 wall: {time.perf_counter() - t_phase:.1f} s")
    del model_i8

    # ------------------------------------------------------- 7. full w8a8
    t_phase = time.perf_counter()
    w8a8 = full_w8a8(model_w8a8, model, tok, clips, dev, walls, card)
    launches.update({name: w8a8[name] for name in
                     ("ln_qkv_int8", "attn_oproj_ln_int8", "fc1_gelu_int8", "fc2_residual_int8")})
    log(f"phase 7 wall: {time.perf_counter() - t_phase:.1f} s")
    del model_w8a8

    # ----------------------------------------------- 9. Whisper q4/q8, per-op
    t_phase = time.perf_counter()
    q4 = whisper_q4(model_q4, model_q8, model, tok, clips, dev, card)
    launches.update({name: q4[name] for name in ("encoder_attention", "encoder_attention_packed")})
    log(f"phase 9 wall: {time.perf_counter() - t_phase:.1f} s")
    del model, model_q4, model_q8

    # ------------------------------------------------------- 8. Fun-ASR
    t_phase = time.perf_counter()
    fun = funasr_slice(trees, dev, card)
    launches.update({name: fun[name] for name in ("fused_decode_step", "quant_matmul")})
    log(f"phase 8 wall: {time.perf_counter() - t_phase:.1f} s")
    del trees

    # ------------------------------------------------------- 10. Orpheus
    t_phase = time.perf_counter()
    orph = orpheus_slice(o_trees, dev, card)
    log(f"fused_decode_step launches: phase 8 {fun['fused_decode_step']}, phase 10 "
        f"{orph['fused_decode_step']}")
    launches["fused_decode_step"] += orph["fused_decode_step"]
    launches.update({name: orph[name] for name in ("w4a8_matmul", "w4a8_matmul_stacked",
                                                   "w4a8_sg_matmul", "w4a8_sg_matmul_stacked")})
    log(f"phase 10 wall: {time.perf_counter() - t_phase:.1f} s")
    del o_trees
    torch.cuda.empty_cache()

    # ------------------------------------------------- 11. checkpoints, files
    t_phase = time.perf_counter()
    loaded = load_slice(dev, card)
    # the kernels line keeps the launches of phases 4-10; phase 11's go on
    # their own line
    log(f"phase 11 launches: { {n: c for n, c in loaded.items() if c} }")
    log(f"phase 11 wall: {time.perf_counter() - t_phase:.1f} s ({card})")
    torch.cuda.empty_cache()

    # ------- 12. OuteTTS, 13. Marvis, 14. CosyVoice2, 15. speculative, 16. CosyVoice3,
    # 17. Chatterbox, 18. Kokoro, 19. serving and playback, 20. fine-tuning, 21.
    # tensor-parallel serving, 22. the examples: their launches, too, go on lines of
    # their own
    tts_slices(dev, card, ((12, oute_slice), (13, marvis_slice), (14, cosyvoice_slice),
                           (15, spec_slice), (16, cosyvoice3_slice), (17, chatterbox_slice),
                           (18, kokoro_slice), (19, serve_slice), (20, train_slice),
                           (21, mesh_slice), (22, examples_slice)))
    print_result(rows, launches)


if __name__ == "__main__":
    main()
