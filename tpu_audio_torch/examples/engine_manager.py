"""EngineManager: one object over every TTS and STT engine of the port
(port of examples/engine_manager.py: the name tables and EngineManager),
with random-weight engines for the demos.

The name tables map the reference's names to the port's factories
(`"funasr": STT.fun_asr`). `EngineManager` builds an engine on first use,
keeps one active engine of each kind and unloads the previous one on a
switch.

The demos run on random weights unless given `--checkpoint DIR`:
`random_tts` / `random_stt` build an engine by its `from_params` on a tree
drawn from a seed, at the model's published width, its depth cut to
`layers` where given (`load()` serves the same trees from a checkpoint).
With a checkpoint, `use_checkpoints(DIR)` points the engines' `load()` at
DIR, a local cache in the Hugging Face layout (`utils/hub.py`); nothing is
downloaded.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from tpu_audio_torch.api.stt import STT
from tpu_audio_torch.api.tts import TTS
from tpu_audio_torch.convert import serving_dtype

TTS_ENGINES = {
    "kokoro": TTS.kokoro,
    "orpheus": TTS.orpheus,
    "marvis": TTS.marvis,
    "oute": TTS.oute,
    "chatterbox": TTS.chatterbox,
    "chatterbox_turbo": TTS.chatterbox_turbo,
    "cosyvoice2": TTS.cosyvoice2,
    "cosyvoice3": TTS.cosyvoice3,
}

STT_ENGINES = {
    "whisper": STT.whisper,
    "funasr": STT.fun_asr,
}


class EngineManager:
    def __init__(self):
        self._tts = {}
        self._stt = {}
        self.active_tts: str | None = None
        self.active_stt: str | None = None

    def tts(self, name: str, **kw):
        if name not in TTS_ENGINES:
            raise KeyError(f"unknown TTS engine {name!r}; choose from {sorted(TTS_ENGINES)}")
        if name not in self._tts:
            self._tts[name] = TTS_ENGINES[name](**kw)
        if self.active_tts not in (None, name) and self.active_tts in self._tts:
            self._tts[self.active_tts].unload()
        self.active_tts = name
        return self._tts[name]

    def stt(self, name: str, **kw):
        if name not in STT_ENGINES:
            raise KeyError(f"unknown STT engine {name!r}; choose from {sorted(STT_ENGINES)}")
        if name not in self._stt:
            self._stt[name] = STT_ENGINES[name](**kw)
        if self.active_stt not in (None, name) and self.active_stt in self._stt:
            self._stt[self.active_stt].unload()
        self.active_stt = name
        return self._stt[name]

    def cleanup(self):
        for eng in list(self._tts.values()) + list(self._stt.values()):
            eng.cleanup()


def use_checkpoints(directory: str) -> None:
    """Point every engine's `load()` at `directory`, a local cache in the
    Hugging Face layout (`utils/hub.py`)."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"--checkpoint {directory}: no such directory")
    os.environ["TPU_AUDIO_CACHE"] = directory


def _depth(cfg, layers: int | None, *fields: str):
    """cfg with each of `fields` (a layer count) cut to `layers`."""
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, **{f: min(layers, getattr(cfg, f)) for f in fields})


def random_stt(name: str, device="cuda", seed: int = 0, layers: int | None = None,
               model: str = "large-v3-turbo"):
    """An STT engine on random weights at its published width: Whisper
    (`model`'s preset; a byte-level BPE stands in for the vocabulary) or
    Fun-ASR-Nano; `layers` cuts the decoder's and the encoder's depth."""
    dtype = serving_dtype(device)
    if name == "whisper":
        from tpu_audio_torch.api.stt import WhisperEngine
        from tpu_audio_torch.models.whisper import model as wmodel
        from tpu_audio_torch.models.whisper.config import PRESETS
        from tpu_audio_torch.models.whisper.pipeline import WhisperPipeline
        from tpu_audio_torch.models.whisper.tokenizer import BPE, WhisperTokenizer

        cfg = _depth(PRESETS[model], layers, "n_audio_layer", "n_text_layer")
        tok = WhisperTokenizer(BPE({bytes([i]): i for i in range(256)}), True, cfg.num_languages)
        params = wmodel.init_params(seed, cfg, dtype, device)
        return WhisperEngine.from_pipeline(WhisperPipeline(wmodel.Whisper(cfg, params), tok,
                                                           compute_dtype=dtype))
    if name == "funasr":
        from tpu_audio_torch.api.stt_funasr import FunASREngine
        from tpu_audio_torch.models.funasr import model as fmodel

        cfg = fmodel.FunASRConfig()
        cfg = dataclasses.replace(cfg, llm=_depth(cfg.llm, layers, "n_layers"))
        return FunASREngine.from_params(fmodel.init_params(seed, cfg, dtype, device), cfg)
    raise KeyError(f"unknown STT engine {name!r}; choose from {sorted(STT_ENGINES)}")


def random_tts(name: str, device="cuda", seed: int = 0, layers: int | None = None):
    """A TTS engine on random weights at its published width, its LM's
    depth cut to `layers` where given; the Orpheus LM in its default
    serving format (w8a8), the others fp."""
    dtype = serving_dtype(device)
    if name == "orpheus":
        from tpu_audio_torch.codecs.snac import model as snac
        from tpu_audio_torch.models.orpheus.engine import OrpheusEngine
        from tpu_audio_torch.models.orpheus.model import LLAMA_3B
        from tpu_audio_torch.nn import transformer
        from tpu_audio_torch.ops import quant

        cfg = _depth(LLAMA_3B, layers, "n_layers")
        lm = quant.requantize_tree_int8(quant.quantize_tree(
            transformer.init_params(seed, cfg, dtype, device), bits=4))
        return OrpheusEngine.from_params(lm, cfg, snac.init_params(seed + 1, snac.SNACConfig(),
                                                                   dtype, device))
    if name == "kokoro":
        from tpu_audio_torch.models.kokoro import model as kmodel
        from tpu_audio_torch.models.kokoro.config import KokoroConfig
        from tpu_audio_torch.models.kokoro.engine import KokoroEngine

        cfg = KokoroConfig()
        return KokoroEngine.from_params(kmodel.init_params(seed, cfg, torch.float32, device), cfg)
    if name == "marvis":
        from tpu_audio_torch.codecs.mimi import model as mimi
        from tpu_audio_torch.models.marvis import model as mm
        from tpu_audio_torch.models.marvis.engine import MarvisEngine

        cfg = mm.MarvisConfig()
        cfg = dataclasses.replace(cfg, backbone=_depth(cfg.backbone, layers, "n_layers"))
        return MarvisEngine.from_params(mm.init_params(seed, cfg, dtype, device), cfg,
                                        mimi.init_params(seed + 1, mimi.MimiConfig(), dtype,
                                                         device), mimi.MimiConfig())
    if name == "oute":
        from tpu_audio_torch.codecs.dac import model as dac
        from tpu_audio_torch.models.outetts.engine import OuteTTSEngine
        from tpu_audio_torch.nn import transformer

        cfg = _depth(transformer.TransformerConfig(
            dim=2048, n_layers=16, n_heads=32, n_kv_heads=8, hidden_dim=8192, vocab_size=134400,
            rope_theta=500000.0, rope_scaling={"rope_type": "llama3", "factor": 32.0,
                                               "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                               "original_max_position_embeddings": 8192},
            tie_word_embeddings=True), layers, "n_layers")
        return OuteTTSEngine.from_params(transformer.init_params(seed, cfg, dtype, device), cfg,
                                         dac.init_params(seed + 1, dac.DACConfig(), dtype,
                                                         device), dac.DACConfig())
    if name in ("chatterbox", "chatterbox_turbo"):
        from tpu_audio_torch.codecs.s3gen import model as s3gen
        from tpu_audio_torch.codecs.s3tokenizer import model as s3tok
        from tpu_audio_torch.models.chatterbox import voice_encoder as ve

        s3cfg, tokcfg, vecfg = s3gen.S3GenConfig(), s3tok.S3TokenizerConfig(), ve.VoiceEncConfig()
        shared = (s3tok.init_params(seed + 2, tokcfg, dtype, device), tokcfg,
                  ve.init_params(seed + 3, vecfg, dtype, device), vecfg)
        if name == "chatterbox":
            from tpu_audio_torch.models.chatterbox import t3
            from tpu_audio_torch.models.chatterbox.engine import ChatterboxEngine

            cfg = t3.T3Config()
            cfg = dataclasses.replace(cfg, llama=_depth(cfg.llama, layers, "n_layers"))
            return ChatterboxEngine.from_params(
                t3.init_params(seed, cfg, dtype, device), cfg,
                s3gen.init_params(seed + 1, s3cfg, dtype, device), s3cfg, *shared)
        from tpu_audio_torch.models.chatterbox_turbo import model as turbo
        from tpu_audio_torch.models.chatterbox_turbo.engine import ChatterboxTurboEngine

        cfg = turbo.T3TurboConfig()
        cfg = dataclasses.replace(cfg, gpt2=_depth(cfg.gpt2, layers, "n_layers"))
        s3cfg = dataclasses.replace(s3cfg, estimator=dataclasses.replace(s3cfg.estimator,
                                                                         meanflow=True))
        return ChatterboxTurboEngine.from_turbo_params(
            turbo.init_params(seed, cfg, dtype, device), cfg,
            s3gen.init_params(seed + 1, s3cfg, dtype, device), s3cfg, *shared)
    if name in ("cosyvoice2", "cosyvoice3"):
        from tpu_audio_torch.codecs.s3tokenizer import model as s3tok
        from tpu_audio_torch.models.cosyvoice2 import lm as cvlm

        lm_cfg, tokcfg = cvlm.CosyLMConfig(), s3tok.S3TokenizerConfig()
        lm_cfg = dataclasses.replace(lm_cfg, qwen=_depth(lm_cfg.qwen, layers, "n_layers"))
        lm = cvlm.init_params(seed, lm_cfg, dtype, device)
        tok = s3tok.init_params(seed + 2, tokcfg, dtype, device)
        if name == "cosyvoice2":
            from tpu_audio_torch.codecs.s3gen import model as s3gen
            from tpu_audio_torch.models.cosyvoice2.engine import CosyVoice2Engine

            s3cfg = s3gen.S3GenConfig()
            return CosyVoice2Engine.from_params(lm, lm_cfg, s3gen.init_params(
                seed + 1, s3cfg, dtype, device), s3cfg, tok, tokcfg)
        from tpu_audio_torch.models.cosyvoice3 import model as cv3
        from tpu_audio_torch.models.cosyvoice3.engine import CosyVoice3Engine

        fcfg = cv3.CV3FlowConfig()
        return CosyVoice3Engine.from_params(lm, lm_cfg, cv3.init_params(seed + 1, fcfg, dtype,
                                                                         device), fcfg, tok,
                                            tokcfg)
    raise KeyError(f"unknown TTS engine {name!r}; choose from {sorted(TTS_ENGINES)}")
