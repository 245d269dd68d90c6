"""The port's example scripts (port of the repository's examples/), run as
`python -m tpu_audio_torch.examples.<name>`: engine_manager (the engine
tables), tts_demo, stt_demo, batch_serving, duplex_demo and webapp (a
stdlib console on 127.0.0.1). Each takes `--device` (the card by default)
and runs on random weights drawn from a seed, or with `--checkpoint DIR` on
the checkpoints of a local cache; none downloads."""
