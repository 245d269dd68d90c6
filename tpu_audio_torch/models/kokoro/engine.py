"""Kokoro TTS engine: sentences, and the 510-token cap split at 450 (port
of tpu_audio/models/kokoro/engine.py: SAFE_TOKEN_LIMIT, KokoroEngine).

Each sentence of `utils/text.split_into_sentences` is phonemized (espeak-ng,
a lexicon or the offline rules, `phonemize.Phonemizer`); one over
SAFE_TOKEN_LIMIT ids is split at the punctuation nearest its middle,
recursively, or on the token boundary where it has none. Each piece is
synthesised by `KokoroSynthesizer` with the voice's style pack and
streamed at SENTENCE granularity. `load()` reads mlx-community/
Kokoro-82M-bf16 and its voices/ onto `device` (the card unless the caller
asks for the CPU); `from_params` takes a built tree and a pack.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from tpu_audio_torch.api.tts import AudioChunk, StreamingGranularity, TTSEngineBase
from tpu_audio_torch.convert import tree_device
from tpu_audio_torch.models.kokoro import voices as kvoices
from tpu_audio_torch.models.kokoro.config import KokoroConfig
from tpu_audio_torch.models.kokoro.phonemize import Phonemizer
from tpu_audio_torch.models.kokoro.synth import KokoroSynthesizer
from tpu_audio_torch.utils import text as textutils

SAFE_TOKEN_LIMIT = 450  # split point below the hard 510 cap


class KokoroEngine(TTSEngineBase):
    sample_rate = 24000
    supported_streaming_granularities = (StreamingGranularity.SENTENCE,)
    default_streaming_granularity = StreamingGranularity.SENTENCE

    def __init__(self, voice: str = "af_heart", repo: str | None = None,
                 device: torch.device | str = "cuda"):
        """voice: one of `voices.VOICES`; repo: the checkpoint `load()`
        reads (a directory or a cached repo id; the published one by
        default)."""
        super().__init__()
        self.voice = voice
        self.repo = repo
        self.device = device
        self.synth: KokoroSynthesizer | None = None
        self.phonemizer: Phonemizer | None = None
        self._voice_packs: dict[str, np.ndarray] = {}
        self._model_dir: str | None = None

    # ---------------------------------------------------------------- lifecycle

    def load(self, progress_handler=None) -> None:
        if self.is_loaded:
            return
        from tpu_audio_torch.models.kokoro import load as kload

        params, cfg, path = kload.load(self.repo, self.device)
        self._model_dir = path
        self.synth = KokoroSynthesizer(params, cfg)
        self.phonemizer = Phonemizer(kvoices.voice_language(self.voice), path)
        self.is_loaded = True

    @classmethod
    def from_params(cls, params, cfg: KokoroConfig | None = None,
                    voice_pack: np.ndarray | None = None,
                    device: torch.device | str | None = None) -> "KokoroEngine":
        """An engine over a built tree on `device` (by default the tree's
        own) with `voice_pack` (by default `voices.random_voice()`) for its
        voice and the en-us phonemizer."""
        eng = cls(device=tree_device(params) if device is None else device)
        eng.synth = KokoroSynthesizer(params, cfg)
        eng.phonemizer = Phonemizer("en-us", None)
        eng._voice_packs[eng.voice] = (
            voice_pack if voice_pack is not None else kvoices.random_voice())
        eng.is_loaded = True
        return eng

    def set_voice(self, voice: str) -> None:
        self.voice = voice
        if self.is_loaded and self._model_dir:
            self.phonemizer = Phonemizer(kvoices.voice_language(voice), self._model_dir)

    def _voice_pack(self) -> np.ndarray:
        if self.voice not in self._voice_packs:
            self._voice_packs[self.voice] = kvoices.load_voice(self.voice, self._model_dir)
        return self._voice_packs[self.voice]

    # ---------------------------------------------------------------- synthesis

    def generate_streaming(self, text: str, granularity: StreamingGranularity | None = None,
                           speed: float = 1.0, **kw) -> Iterator[AudioChunk]:
        if self.synth is None:
            self.load()
        pack = self._voice_pack()
        sentences = textutils.split_into_sentences(text)
        for si, sentence in enumerate(sentences):
            self._check_stopped()
            for ids in self._tokenize_bounded(sentence):
                audio = self.synth.synthesize(ids, pack, speed=speed)
                yield AudioChunk(samples=audio, sample_rate=self.sample_rate, text=sentence,
                                 is_final=si == len(sentences) - 1)

    def _tokenize_bounded(self, sentence: str) -> list[list[int]]:
        """Phonemize; split any piece over SAFE_TOKEN_LIMIT ids at its
        middle punctuation, recursively, or on the token boundary."""
        ids = self.phonemizer.to_ids(sentence)
        if len(ids) <= SAFE_TOKEN_LIMIT:
            return [ids] if ids else []
        parts = textutils.split_at_punctuation_boundary(sentence)
        if parts is None:
            return [ids[i: i + SAFE_TOKEN_LIMIT] for i in range(0, len(ids), SAFE_TOKEN_LIMIT)]
        out = []
        for p in parts:
            out.extend(self._tokenize_bounded(p))
        return out
