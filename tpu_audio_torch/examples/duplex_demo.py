"""Streaming duplex demo: Marvis streaming TTS feeding Fun-ASR streaming
transcription, chunk by chunk (port of examples/duplex_demo.py).

    python -m tpu_audio_torch.examples.duplex_demo --text "The quick brown fox." [--tiny]

--tiny runs random miniature models (`build_tiny`, the reference's
configs); without it the engines run at their published widths on random
weights, or with --checkpoint DIR on the checkpoints of a local cache.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_tiny(device="cuda"):
    """(a Marvis engine, a Fun-ASR engine) of miniature random models."""
    from tpu_audio_torch.api.stt_funasr import FunASREngine
    from tpu_audio_torch.codecs.mimi import model as mimi
    from tpu_audio_torch.models.funasr import model as fmodel
    from tpu_audio_torch.models.marvis import model as mmodel
    from tpu_audio_torch.models.marvis.engine import MarvisEngine
    from tpu_audio_torch.nn import transformer

    mimi_cfg = mimi.MimiConfig(dimension=32, n_filters=4, ratios=(4, 3, 2), t_layers=2,
                               t_heads=4, t_ff=64, n_q=4, bins=16, q_dim=8)
    marvis_cfg = mmodel.MarvisConfig(
        backbone=transformer.TransformerConfig(dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                                               hidden_dim=64),
        decoder=transformer.TransformerConfig(dim=16, n_layers=1, n_heads=2, n_kv_heads=2,
                                              hidden_dim=32),
        text_vocab_size=300, audio_vocab_size=32, n_codebooks=4)
    tts = MarvisEngine.from_params(
        mmodel.init_params(0, marvis_cfg, torch.float32, device), marvis_cfg,
        mimi.init_params(1, mimi_cfg, torch.float32, device), mimi_cfg, max_frames=12)
    tts.quality = "low"

    fcfg = fmodel.FunASRConfig(
        encoder=fmodel.SenseVoiceConfig(input_dim=560, encoder_dim=32, num_heads=4, ffn_dim=64,
                                        num_encoders0=1, num_encoders=2, num_tp_encoders=1,
                                        kernel_size=5),
        adaptor=fmodel.AdaptorConfig(encoder_dim=32, downsample_rate=2, ffn_dim=64, llm_dim=48,
                                     n_layer=1, attention_heads=4),
        llm=transformer.TransformerConfig(dim=48, n_layers=2, n_heads=4, n_kv_heads=2,
                                          hidden_dim=96, vocab_size=300, qk_norm=True,
                                          tie_word_embeddings=True))
    stt = FunASREngine.from_params(fmodel.init_params(2, fcfg, torch.float32, device), fcfg,
                                   max_cache=768)
    return tts, stt


def run(tts, stt, text: str, out=print) -> np.ndarray:
    """Stream `text` through the TTS, each chunk into streaming ASR at
    16 kHz; returns the audio."""
    from tpu_audio_torch.ops.resample import resample

    t0 = time.perf_counter()
    first_audio = None
    pieces = []
    for chunk in tts.generate_streaming(text):
        if not len(chunk.samples):
            continue
        if first_audio is None:
            first_audio = time.perf_counter() - t0
            out(f"[tts ] first audio after {first_audio * 1e3:.0f} ms")
        pieces.append(chunk.samples)
        out(f"[tts ] chunk: {len(chunk.samples) / 24000 * 1e3:.0f} ms of audio")
        seg16 = resample(chunk.samples, 24000, 16000)
        if len(seg16) >= 1600:
            for piece in stt.transcribe_streaming(seg16, max_new_tokens=8):
                out(f"[asr ] {piece!r}")
    total = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
    out(f"[done] {len(total) / 24000:.2f}s audio in {time.perf_counter() - t0:.2f}s wall")
    return total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--text", default="Streaming duplex test sentence.")
    ap.add_argument("--tiny", action="store_true", help="random miniature models")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint", default=None,
                    help="a local cache of the checkpoints (the Hugging Face layout)")
    ap.add_argument("--layers", type=int, default=None,
                    help="random weights: cut the LMs' depth to this many layers")
    args = ap.parse_args(argv)

    from tpu_audio_torch.examples import engine_manager as em

    if args.tiny:
        tts, stt = build_tiny(args.device)
    elif args.checkpoint:
        from tpu_audio_torch.api.stt import STT
        from tpu_audio_torch.api.tts import TTS

        em.use_checkpoints(args.checkpoint)
        tts, stt = TTS.marvis(device=args.device), STT.fun_asr(device=args.device)
        tts.load()
        stt.load()
    else:
        tts = em.random_tts("marvis", args.device, layers=args.layers)
        stt = em.random_stt("funasr", args.device, layers=args.layers)
    return run(tts, stt, args.text)


if __name__ == "__main__":
    main()
