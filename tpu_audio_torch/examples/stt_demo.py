"""STT demo: transcribe or translate a WAV file, or the microphone (port of
examples/stt_demo.py).

    python -m tpu_audio_torch.examples.stt_demo clip.wav --engine whisper \
        --model large-v3-turbo --word-timestamps [--checkpoint DIR] [--layers N]

Random weights (seed 0) at the model's published width unless
--checkpoint names a local cache of the checkpoints (random weights
transcribe noise into noise: the demo shows the path, not the words).
"""

from __future__ import annotations

import argparse

from tpu_audio_torch.examples.engine_manager import (STT_ENGINES, EngineManager, random_stt,
                                                     use_checkpoints)


def run_mic(engine, args) -> None:
    """Live microphone → transcription: windows of --mic-window seconds,
    each transcribed as it completes (Ctrl-C to stop), through the port's
    `utils/recorder.AudioRecorder`."""
    from tpu_audio_torch.utils.recorder import AudioRecorder

    rec = AudioRecorder(target_rate=engine.sample_rate)
    print(f"listening (windows of {args.mic_window:.1f}s; Ctrl-C to stop)...")
    kw = {"language": args.language} if args.language else {}
    try:
        for _ in rec.record_stream(chunk_seconds=0.25):
            chunk = rec.pull(args.mic_window)
            if chunk is None:
                continue
            result = engine.transcribe(chunk, **kw)
            if result.text.strip():
                print(result.text.strip(), flush=True)
    except KeyboardInterrupt:
        tail = rec.drain()
        if len(tail) > engine.sample_rate // 2:
            result = engine.transcribe(tail)
            if result.text.strip():
                print(result.text.strip(), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("audio", nargs="?", default=None, help="wav file (omit with --mic)")
    ap.add_argument("--engine", default="whisper", choices=sorted(STT_ENGINES))
    ap.add_argument("--model", default="large-v3-turbo")
    ap.add_argument("--task", default="transcribe", choices=["transcribe", "translate"])
    ap.add_argument("--language", default=None)
    ap.add_argument("--word-timestamps", action="store_true")
    ap.add_argument("--mic", action="store_true", help="transcribe the default input device")
    ap.add_argument("--mic-window", type=float, default=5.0,
                    help="seconds of audio per transcribed window")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint", default=None,
                    help="a local cache of the checkpoints (the Hugging Face layout)")
    ap.add_argument("--layers", type=int, default=None,
                    help="random weights: cut the depth to this many layers")
    args = ap.parse_args(argv)
    if args.audio is None and not args.mic:
        ap.error("provide an audio file or --mic")

    if args.checkpoint:
        use_checkpoints(args.checkpoint)
        mgr = EngineManager()
        engine = (mgr.stt("whisper", model=args.model, device=args.device)
                  if args.engine == "whisper" else mgr.stt("funasr", device=args.device))
        engine.load()
    else:
        engine = random_stt(args.engine, args.device, layers=args.layers, model=args.model)

    if args.mic:
        engine.warmup()
        run_mic(engine, args)
        return None

    fn = engine.translate if args.task == "translate" else engine.transcribe
    kw = {"language": args.language}
    if args.engine == "whisper" and args.word_timestamps:
        kw["word_timestamps"] = True
    result = fn(args.audio, **{k: v for k, v in kw.items() if v is not None})

    print(result.text)
    for seg in result.segments:
        print(f"  [{seg.start:7.2f} → {seg.end:7.2f}] {seg.text}")
        for w in seg.words or []:
            print(f"      {w.start:7.2f}–{w.end:7.2f} {w.word!r} p={w.probability:.2f}")
    print(f"(RTF {result.rtf:.3f}, {1 / max(result.rtf, 1e-9):.1f}x real time)")
    return result


if __name__ == "__main__":
    main()
