"""TTS demo: synthesise text with any engine into a WAV file (port of
examples/tts_demo.py).

    python -m tpu_audio_torch.examples.tts_demo --engine kokoro --voice af_heart \
        --text "Hello world" --out out.wav [--checkpoint DIR] [--layers N]

Random weights (seed 0) at the engine's published width unless
--checkpoint names a local cache of the checkpoints; --layers cuts the
random LM's depth.
"""

from __future__ import annotations

import argparse

from tpu_audio_torch.examples.engine_manager import (TTS_ENGINES, EngineManager, random_tts,
                                                     use_checkpoints)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="kokoro", choices=sorted(TTS_ENGINES))
    ap.add_argument("--text", required=True)
    ap.add_argument("--out", default="tts_output.wav")
    ap.add_argument("--voice", default=None)
    ap.add_argument("--ref-audio", default=None, help="reference wav for voice-cloning engines")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint", default=None,
                    help="a local cache of the checkpoints (the Hugging Face layout)")
    ap.add_argument("--layers", type=int, default=None,
                    help="random weights: cut the LM's depth to this many layers")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-new-tokens", type=int, default=None,
                    help="the LM's new tokens a sentence (the LM engines)")
    args = ap.parse_args(argv)

    if args.checkpoint:
        use_checkpoints(args.checkpoint)
        kw = {"device": args.device}
        if args.voice and args.engine in ("kokoro", "orpheus"):
            kw["voice"] = args.voice
        engine = EngineManager().tts(args.engine, **kw)
        engine.load()
    else:
        engine = random_tts(args.engine, args.device, args.seed, args.layers)
        if args.voice and hasattr(engine, "voice"):
            engine.voice = args.voice

    if args.ref_audio and hasattr(engine, "prepare_conditionals"):
        from tpu_audio_torch.utils.audio_io import read_wav

        ref, sr = read_wav(args.ref_audio)
        engine.prepare_conditionals(ref, sr)

    kw = {} if args.max_new_tokens is None else {"max_new_tokens": args.max_new_tokens}
    path = engine.save(args.text, args.out, **kw)
    print(f"wrote {path} ({engine.generation_time:.2f}s generation)")
    return path


if __name__ == "__main__":
    main()
