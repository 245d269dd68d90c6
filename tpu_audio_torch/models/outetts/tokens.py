"""OuteTTS special tokens, prompt grammar, speaker profiles (port of
tpu_audio/models/outetts/tokens.py, the whole module, which imports no JAX).

Reference: package/TTS/OuteTTS/OuteTTSTokens.swift:11-152 and
OuteTTSPromptProcessor.swift:44-360 — Llama-1B with an extended vocab of
word/time/feature/c1/c2 tokens; prompt:
  <|im_start|><|text_start|>{text}<|text_end|>\n<|audio_start|>\n
then per word:
  <|word_start|>{word}<|features|><|t_D.DD|><|energy_E|>
  <|spectral_centroid_S|><|pitch_P|><|code|><|c1_X|><|c2_Y|>...<|word_end|>
Speaker profiles are JSON {text, words[{word, duration, c1[], c2[]}],
global_features} saved/loaded as first-class values.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

BOS = "<|im_start|>"
TEXT_START = "<|text_start|>"
TEXT_END = "<|text_end|>"
AUDIO_START = "<|audio_start|>"
AUDIO_END = "<|audio_end|>"
CODE = "<|code|>"
WORD_START = "<|word_start|>"
WORD_END = "<|word_end|>"
FEATURES = "<|features|>"
GLOBAL_FEATURES_START = "<|global_features_start|>"
GLOBAL_FEATURES_END = "<|global_features_end|>"


def format_time(seconds: float) -> str:
    return f"<|t_{seconds:.2f}|>"


def format_c1(v: int) -> str:
    return f"<|c1_{v}|>"


def format_c2(v: int) -> str:
    return f"<|c2_{v}|>"


@dataclass
class AudioFeatures:
    energy: int = 50
    spectral_centroid: int = 50
    pitch: int = 50

    def tokens(self) -> str:
        return (f"<|energy_{self.energy}|>"
                f"<|spectral_centroid_{self.spectral_centroid}|>"
                f"<|pitch_{self.pitch}|>")


@dataclass
class WordData:
    word: str
    duration: float
    features: AudioFeatures = field(default_factory=AudioFeatures)
    c1: list[int] = field(default_factory=list)
    c2: list[int] = field(default_factory=list)

    def to_codes(self) -> str:
        pairs = "".join(format_c1(a) + format_c2(b)
                        for a, b in zip(self.c1, self.c2))
        return (WORD_START + self.word + FEATURES + format_time(self.duration)
                + self.features.tokens() + CODE + pairs + WORD_END)


@dataclass
class SpeakerProfile:
    text: str
    words: list[WordData] = field(default_factory=list)
    global_features: AudioFeatures = field(default_factory=AudioFeatures)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(asdict(self), f, indent=2)
        return path

    @staticmethod
    def load(path: str) -> "SpeakerProfile":
        with open(path) as f:
            d = json.load(f)
        words = [WordData(word=w["word"], duration=w["duration"],
                          features=AudioFeatures(**w.get("features", {})),
                          c1=w.get("c1", []), c2=w.get("c2", []))
                 for w in d.get("words", [])]
        return SpeakerProfile(
            text=d.get("text", ""), words=words,
            global_features=AudioFeatures(**d.get("global_features", {})))
