"""Fun-ASR STT engine: LLM-based transcription and translation (port of
tpu_audio/api/stt_funasr.py: build_prompt_text, clean_output,
FunASREngine).

Reference: package/STT/FunASR/FunASREngine.swift + FunASRSTT.swift:70-278 —
Qwen3 chat prompt with the audio embedding spliced between
<|startofspeech|><|endofspeech|>, a decode loop yielding token ids, output
cleaning (FunASRTokenizer.swift:130-229).

`load()` reads the checkpoint (`models/funasr/load.py`: safetensors and
its `tokenizer.json`) from a local directory or the pre-seeded cache;
`FunASREngine.from_params` builds an engine on a parameter tree.
"""

from __future__ import annotations

import logging
import time
from typing import Iterator

import torch

from tpu_audio_torch.api.results import TranscriptionResult, TranscriptionSegment
from tpu_audio_torch.api.stt import STTEngineBase
from tpu_audio_torch.convert import serving_dtype
from tpu_audio_torch.models.funasr import model as fmodel
from tpu_audio_torch.ops import frontends
from tpu_audio_torch.ops.sampling import SamplerConfig
from tpu_audio_torch.utils.tokenizer import load_tokenizer

_log = logging.getLogger("tpu_audio_torch.stt")

REPOS = {"nano": "mlx-community/Fun-ASR-Nano-4bit",
         "mlt_nano": "mlx-community/Fun-ASR-MLT-Nano-4bit"}

SOS_TOKEN = "<|startofspeech|>"
EOS_TOKEN = "<|endofspeech|>"
IM_START = "<|im_start|>"
IM_END = "<|im_end|>"

LANGUAGE_NAMES = {"auto": None, "en": "English", "zh": "Chinese",
                  "ja": "Japanese", "ko": "Korean", "es": "Spanish",
                  "fr": "French", "de": "German", "ru": "Russian"}


def build_prompt_text(task: str = "transcribe", language: str = "auto",
                      target_language: str = "en",
                      initial_prompt: str | None = None) -> tuple[str, str]:
    """(pre_text, post_text) around the audio span (FunASRTokenizer.buildPrompt)."""
    if task == "translate":
        tgt = LANGUAGE_NAMES.get(target_language, target_language)
        system = (f"You are a speech translation assistant. Listen to the "
                  f"audio and translate the speech into {tgt}. Output only "
                  f"the translation, nothing else.")
    else:
        system = ("You are a speech recognition assistant. Listen to the "
                  "audio and transcribe the speech exactly as spoken. "
                  "Output only the transcription, nothing else.")
    if language not in (None, "auto") and LANGUAGE_NAMES.get(language):
        system += f" The speech is in {LANGUAGE_NAMES[language]}."
    if initial_prompt:
        system += " " + initial_prompt
    pre = f"{IM_START}system\n{system}{IM_END}{IM_START}user\n{SOS_TOKEN}"
    post = f"{EOS_TOKEN}{IM_END}{IM_START}assistant\n"
    return pre, post


def clean_output(text: str) -> str:
    """Strip special-token remnants (FunASRTokenizer's output cleaner)."""
    for tok in (IM_END, IM_START, SOS_TOKEN, EOS_TOKEN, "<|endoftext|>",
                "assistant\n", "system\n", "user\n"):
        text = text.replace(tok, "")
    return text.strip()


class FunASREngine(STTEngineBase):
    sample_rate = 16000

    def __init__(self, model_type: str = "nano", quantization: str = "q4",
                 device: torch.device | str = "cuda"):
        super().__init__(device)
        self.model_type = model_type
        self.quantization = quantization
        self.generator: fmodel.FunASRGenerator | None = None
        self.cfg = fmodel.FunASRConfig()
        self.tokenizer = None
        self._eos_ids: tuple = (2,)

    def load(self, progress_handler=None) -> None:
        if self.is_loaded:
            return
        from tpu_audio_torch.models.funasr import load as fload

        params, self.cfg, self.tokenizer = fload.load(
            REPOS.get(self.model_type, self.model_type), serving_dtype(self.device),
            self.device)
        # the decoder cache sized for each request, as from_params's default
        self.generator = fmodel.FunASRGenerator(params, self.cfg, max_cache=None)
        self._resolve_eos()
        self.is_loaded = True

    @classmethod
    def from_params(cls, params, cfg, tokenizer=None,
                    max_cache: int | None = None) -> "FunASREngine":
        """An engine on a parameter tree (random weights, tests); the
        tokenizer defaults to the byte-level stand-in. `max_cache` fixes the
        decoder cache's slots; None sizes it for each request, to the prompt
        plus `max_new_tokens`."""
        eng = cls()
        eng.cfg = cfg
        eng.generator = fmodel.FunASRGenerator(params, cfg, max_cache=max_cache)
        eng.device = eng.generator.device
        eng.tokenizer = tokenizer or load_tokenizer(None)
        eng._resolve_eos()
        eng.is_loaded = True
        return eng

    def _resolve_eos(self):
        ids = set()
        for tok in (IM_END, "<|endoftext|>"):
            enc = self.tokenizer.encode(tok)
            if len(enc) == 1:
                ids.add(enc[0])
        self._eos_ids = tuple(sorted(ids)) or (2,)

    # ---------------------------------------------------------------- API

    def transcribe(self, audio, *, language: str = "auto", initial_prompt: str | None = None,
                   max_new_tokens: int = 256, **kw) -> TranscriptionResult:
        return self._run(audio, task="transcribe", language=language,
                         initial_prompt=initial_prompt, max_new_tokens=max_new_tokens)

    def translate(self, audio, *, language: str = "auto", target_language: str = "en",
                  max_new_tokens: int = 256, **kw) -> TranscriptionResult:
        return self._run(audio, task="translate", language=language,
                         target_language=target_language, max_new_tokens=max_new_tokens)

    def transcribe_streaming(self, audio, chunk_tokens: int = 8, **kw) -> Iterator[str]:
        """Yields the text in groups of three words (as the JAX engine does
        without a checkpoint tokenizer)."""
        words = self.transcribe(audio, **kw).text.split(" ")
        for i in range(0, len(words), 3):
            yield " ".join(words[i: i + 3]) + " "

    def _run(self, audio, *, task, language="auto", target_language="en",
             initial_prompt=None, max_new_tokens=256) -> TranscriptionResult:
        self._ensure_loaded()
        samples = self._resolve_audio(audio)
        duration = len(samples) / self.sample_rate
        t0 = time.perf_counter()
        self.is_transcribing = True
        try:
            feats = frontends.funasr_features(
                torch.as_tensor(samples, device=self.generator.device))
            pre, post = build_prompt_text(task, language, target_language, initial_prompt)
            tokens = self.generator.generate(
                self.tokenizer.encode(pre), self.tokenizer.encode(post), feats,
                eos_ids=self._eos_ids, max_new=max_new_tokens,
                sampler=SamplerConfig(temperature=0.0))
            text = clean_output(self.tokenizer.decode(tokens))
        finally:
            self.is_transcribing = False
        processing = time.perf_counter() - t0
        self.transcription_time = processing
        _log.info("funasr.%s: %.3f s for %.2f s of audio", task, processing, duration)
        return TranscriptionResult(
            text=text, segments=[TranscriptionSegment(id=0, seek=0, start=0.0, end=duration,
                                                      text=text)],
            language=language, duration=duration, processing_time=processing)

    def _ensure_loaded(self):
        if self.generator is None:
            self.load()
