"""PyTorch/CUDA port of tpu_audio for NVIDIA Hopper (H100).

The layout mirrors `tpu_audio/` module for module (`ops/`, `nn/`,
`models/`), so every ported module has one JAX reference module. Plain
tensor code is PyTorch; each Pallas kernel of the JAX package becomes a
hand-written CUDA C++ kernel under `csrc/`, bound through `ctypes` by
`ops/kernels/_build.py`.

Importing this package imports neither jax nor `tpu_audio`, and builds no
kernel: the kernels compile on the first launch on a CUDA tensor.

Ported so far: Whisper batch transcription (`models/whisper/batch.py`,
`transcribe_windows`) and single-stream transcription through the public
API (`api/stt.py` → `models/whisper/pipeline.WhisperPipeline` →
`decoding.SegmentDecoder`, word timestamps in `timing.py`), with the
log-mel front-end, the fused bf16 and W8A8 encoder blocks, the per-op
encoder around the encoder-attention kernel (the mlx group-affine q4/q8
trees), the int8 cross-K/V decode step, the int8 (W8A8) decoder serving
tree and the whole B=1 decoder step; Fun-ASR-Nano through
`api/stt_funasr.py` on the shared decoder stack (`nn/transformer.py`),
with bf16, group-affine q4 and int8 LLM weights; and Orpheus TTS through
`api/tts.py` (`models/orpheus/`: `CausalLMGenerator` on a Llama-3.2-3B
stack, the SNAC codec in `codecs/snac/`) on the bf16, int8 and W4A8
(pair-packed and super-group int4) trees; OuteTTS (`models/outetts/`, the
DAC codec in `codecs/dac/`) on the same generator, and Marvis
(`models/marvis/`: a Llama backbone and a depth decoder, both through the
whole-stack step, the Mimi codec and its exact streaming decoder in
`codecs/mimi/`). Each engine's `load()` reads its
checkpoint from a local directory or a pre-seeded Hugging Face cache
(`utils/hub.py`): the safetensors reader and key remaps (`utils/weights.py`,
`models/*/load.py`, `nn/load_llama.py`), the Whisper and `tokenizer.json`
BPEs in plain Python (`utils/tokenizer.py`), and WAV files in and out
(`utils/audio_io.py`, `ops/resample.py`). CosyVoice2 and CosyVoice3,
Chatterbox and Chatterbox Turbo, and Kokoro run through the same API.
The serving and playback layer: `api/serving.ContinuousBatcher` (rolling
admission into a static batch decoding in spans), `api/player.py` and
`api/playback.py` (the sinks behind `say`), `api/providers.py`,
`api/voice.py`, `native.py` (NumPy versions and an SPSC ring), and the
utilities `utils/logging.py`, `utils/profiling.py` (stages timed by CUDA
events), `utils/memory.py`, `utils/trimmer.py` and `utils/recorder.py`.
Whisper fine-tuning (`training/`) runs on the training route, the JAX XLA
formulation in autograd ops (no kernel has a backward), over a (dp, tp)
mesh of torch.distributed where `parallel/` places it.

The public names below load lazily, on first use:

    from tpu_audio_torch import TTS, PlaybackController
    engine = TTS.orpheus()
"""

_LAZY = {
    "STT": "tpu_audio_torch.api.stt",
    "TTS": "tpu_audio_torch.api.tts",
    "AudioResult": "tpu_audio_torch.api.results",
    "TranscriptionResult": "tpu_audio_torch.api.results",
    "StreamingGranularity": "tpu_audio_torch.api.tts",
    "AudioSamplePlayer": "tpu_audio_torch.api.player",
    "AudioFilePlayer": "tpu_audio_torch.api.player",
    "PlaybackController": "tpu_audio_torch.api.playback",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'tpu_audio_torch' has no attribute {name!r}")


__all__ = list(_LAZY)
