"""Batch serving demo: many clips or many texts through one batched loop
(port of examples/batch_serving.py).

The decode weights stream from device memory once a step for the whole
batch: Whisper's `transcribe_batch` decodes 30 s windows `--batch-size` at
a time, Orpheus's `generate_batch` decodes every text in one loop.

    # transcribe wav files in batches of 8
    python -m tpu_audio_torch.examples.batch_serving stt --model large-v3-turbo *.wav

    # synthesise several texts as one batched decode
    python -m tpu_audio_torch.examples.batch_serving tts --voice tara \
        "First sentence." "Second one." "And a third."

Random weights (seed 0) at the published widths unless --checkpoint names
a local cache of the checkpoints; --layers cuts the random models' depth,
--tiny serves miniature random models instead.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


def tiny_orpheus(device="cuda"):
    """An Orpheus engine on a miniature random LM (the Orpheus vocabulary,
    so that its ids are prompts and codes) and SNAC."""
    from tpu_audio_torch.codecs.snac import model as snac
    from tpu_audio_torch.models.orpheus import model as om
    from tpu_audio_torch.models.orpheus.engine import OrpheusEngine
    from tpu_audio_torch.nn import transformer

    cfg = transformer.TransformerConfig(dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                                        hidden_dim=128, tie_word_embeddings=True,
                                        vocab_size=om.CODE_OFFSET + 7 * om.CODEBOOK_SIZE)
    scfg = snac.SNACConfig(decoder_dim=64, decoder_rates=(4, 4, 2, 2), latent_dim=32,
                           codebook_size=64, codebook_dim=4, vq_strides=(4, 2, 1))
    return OrpheusEngine.from_params(transformer.init_params(2, cfg, torch.float32, device), cfg,
                                     snac.init_params(3, scfg, torch.float32, device), scfg)


def engine(args, kind: str):
    from tpu_audio_torch.examples import engine_manager as em

    if args.checkpoint:
        em.use_checkpoints(args.checkpoint)
        if kind == "stt":
            from tpu_audio_torch.api.stt import STT

            eng = STT.whisper(model=args.model, quantization=args.quantization,
                              device=args.device)
        else:
            from tpu_audio_torch.api.tts import TTS

            eng = TTS.orpheus(voice=args.voice, device=args.device)
        eng.load()
        return eng
    if kind == "stt":
        return em.random_stt("whisper", args.device, layers=args.layers,
                             model="tiny" if args.tiny else args.model)
    eng = tiny_orpheus(args.device) if args.tiny else em.random_tts("orpheus", args.device,
                                                                    layers=args.layers)
    eng.voice = args.voice
    return eng


def run_stt(args) -> list[str]:
    eng = engine(args, "stt")
    t0 = time.perf_counter()
    texts = eng.transcribe_batch(args.inputs, batch_size=args.batch_size,
                                 language=args.language)
    dt = time.perf_counter() - t0
    for path, text in zip(args.inputs, texts):
        print(f"{path}: {text}")
    print(f"\n{len(texts)} clips in {dt:.2f}s (batch_size={args.batch_size})", file=sys.stderr)
    return texts


def run_tts(args) -> list:
    from tpu_audio_torch.utils.audio_io import write_wav

    eng = engine(args, "tts")
    results = eng.generate_batch(args.inputs, max_new_tokens=args.max_new_tokens)
    total_audio = sum(r.duration for r in results)
    for i, r in enumerate(results):
        out = os.path.join(args.out_dir, f"batch_out_{i}.wav")
        write_wav(out, r.samples, r.sample_rate)
        print(f"{out}: {r.duration:.2f}s")
    print(f"\n{len(results)} texts, {total_audio:.1f}s audio in {eng.generation_time:.2f}s "
          f"(aggregate RTF {eng.generation_time / max(total_audio, 1e-9):.3f})", file=sys.stderr)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint", default=None,
                    help="a local cache of the checkpoints (the Hugging Face layout)")
    ap.add_argument("--layers", type=int, default=None,
                    help="random weights: cut the depth to this many layers")
    ap.add_argument("--tiny", action="store_true", help="miniature random models")
    sub = ap.add_subparsers(dest="mode", required=True)
    st = sub.add_parser("stt")
    st.add_argument("inputs", nargs="+", help="wav files")
    st.add_argument("--model", default="large-v3-turbo")
    st.add_argument("--quantization", default="fp16")
    st.add_argument("--language", default="en")
    st.add_argument("--batch-size", type=int, default=8)
    tt = sub.add_parser("tts")
    tt.add_argument("inputs", nargs="+", help="texts to synthesise")
    tt.add_argument("--voice", default="tara")
    tt.add_argument("--max-new-tokens", type=int, default=1200)
    tt.add_argument("--out-dir", default=".")
    args = ap.parse_args(argv)
    return (run_stt if args.mode == "stt" else run_tts)(args)


if __name__ == "__main__":
    main()
