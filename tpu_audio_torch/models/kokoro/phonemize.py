"""Kokoro's text front-end: G2P and phoneme ids (port of
tpu_audio/models/kokoro/phonemize.py: VOCAB, tokenize, EspeakBackend,
LexiconBackend, RuleBackend, Phonemizer).

The backends, in order of preference:
  1. espeak-ng through ctypes, where libespeak-ng is installed;
  2. a misaki-format lexicon (JSON word → IPA) in the model directory;
  3. English letter-to-sound rules, so the engine always runs offline
     (lower quality; logged).
`Phonemizer.kind` names the one in use, and the choice is logged on the
"tpu_audio_torch.tts" logger. The 178-symbol phoneme id table is the
checkpoint's vocabulary.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import logging
import os
import re

_log = logging.getLogger("tpu_audio_torch.tts")

# model phoneme vocabulary (ids are fixed by the checkpoint)
VOCAB: dict[str, int] = {
    ";": 1, ":": 2, ",": 3, ".": 4, "!": 5, "?": 6, "—": 9, "…": 10, '"': 11,
    "(": 12, ")": 13, "“": 14, "”": 15, " ": 16, "̃": 17,
    "ʣ": 18, "ʥ": 19, "ʦ": 20, "ʨ": 21, "ᵝ": 22, "ꭧ": 23, "A": 24,
    "I": 25, "O": 31, "Q": 33, "S": 35, "T": 36, "W": 39, "Y": 41, "ᵊ": 42,
    "a": 43, "b": 44, "c": 45, "d": 46, "e": 47, "f": 48, "h": 50, "i": 51,
    "j": 52, "k": 53, "l": 54, "m": 55, "n": 56, "o": 57, "p": 58, "q": 59,
    "r": 60, "s": 61, "t": 62, "u": 63, "v": 64, "w": 65, "x": 66, "y": 67,
    "z": 68, "ɑ": 69, "ɐ": 70, "ɒ": 71, "æ": 72, "β": 75, "ɔ": 76, "ɕ": 77,
    "ç": 78, "ɖ": 80, "ð": 81, "ʤ": 82, "ə": 83, "ɚ": 85, "ɛ": 86, "ɜ": 87,
    "ɟ": 90, "ɡ": 92, "ɥ": 99, "ɨ": 101, "ɪ": 102, "ʝ": 103, "ɯ": 110,
    "ɰ": 111, "ŋ": 112, "ɳ": 113, "ɲ": 114, "ɴ": 115, "ø": 116, "ɸ": 118,
    "θ": 119, "œ": 120, "ɹ": 123, "ɾ": 125, "ɻ": 126, "ʁ": 128, "ɽ": 129,
    "ʂ": 130, "ʃ": 131, "ʈ": 132, "ʧ": 133, "ʊ": 135, "ʋ": 136, "ʌ": 138,
    "ɣ": 139, "ɤ": 140, "χ": 142, "ʎ": 143, "ʒ": 147, "ʔ": 148, "ˈ": 156,
    "ˌ": 157, "ː": 158, "ʰ": 162, "ʲ": 164, "↓": 169, "→": 171, "↗": 172,
    "↘": 173, "ᵻ": 177,
}


def tokenize(phonemes: str) -> list[int]:
    """Phoneme string → model ids, silently dropping unknown symbols
    (PhonemeTokenizer semantics, Tokenizer.swift:14-19)."""
    return [VOCAB[ch] for ch in phonemes if ch in VOCAB]


# ------------------------------------------------------------------ espeak

class EspeakBackend:
    """ctypes binding to espeak-ng's phoneme API (host-side C library)."""

    def __init__(self, voice: str = "en-us"):
        path = (ctypes.util.find_library("espeak-ng")
                or ctypes.util.find_library("espeak"))
        if not path:
            raise RuntimeError("espeak-ng library not found")
        self.lib = ctypes.CDLL(path)
        self.lib.espeak_Initialize(0x02, 0, None, 0)  # AUDIO_OUTPUT_RETRIEVAL
        self.lib.espeak_SetVoiceByName(voice.encode())
        self.lib.espeak_TextToPhonemes.restype = ctypes.c_char_p

    def phonemize(self, text: str) -> str:
        data = ctypes.c_char_p(text.encode("utf-8"))
        ptr = ctypes.pointer(ctypes.cast(data, ctypes.c_void_p))
        # phoneme mode: IPA (0x02 in bits 0-1 selects IPA), text mode UTF-8 (1)
        out = self.lib.espeak_TextToPhonemes(ptr, 1, 0x02)
        return (out or b"").decode("utf-8")


# ------------------------------------------------------------------ lexicon

class LexiconBackend:
    """misaki-format lexicon (word → IPA) with stress-aware lookup."""

    def __init__(self, paths: list[str]):
        self.table: dict[str, str] = {}
        for p in paths:
            if os.path.exists(p):
                with open(p) as f:
                    data = json.load(f)
                for word, pron in data.items():
                    if isinstance(pron, str):
                        self.table[word.lower()] = pron
                    elif isinstance(pron, dict) and "DEFAULT" in pron:
                        if isinstance(pron["DEFAULT"], str):
                            self.table[word.lower()] = pron["DEFAULT"]
        if not self.table:
            raise RuntimeError("no lexicon entries loaded")

    def phonemize(self, text: str) -> str:
        out = []
        for tok in re.findall(r"\w+'?\w*|[^\w\s]|\s+", text):
            if tok.isspace():
                out.append(" ")
            elif tok.lower() in self.table:
                out.append(self.table[tok.lower()])
            elif not tok[0].isalnum():
                out.append(tok)
            else:
                out.append(RuleBackend._word(tok.lower()))
        return "".join(out)


# ------------------------------------------------------------------ fallback

class RuleBackend:
    """Deterministic English letter-to-sound rules. Not linguistically
    faithful — it exists so the pipeline runs end-to-end without espeak or
    lexicon files; quality users should provide either."""

    _DIGRAPHS = [
        ("tch", "ʧ"), ("sch", "sk"), ("ough", "ʌf"), ("tion", "ʃən"),
        ("sion", "ʒən"), ("igh", "aɪ"), ("ch", "ʧ"), ("sh", "ʃ"),
        ("th", "θ"), ("ph", "f"), ("wh", "w"), ("ck", "k"), ("ng", "ŋ"),
        ("qu", "kw"), ("ee", "i"), ("oo", "u"), ("ea", "i"), ("ou", "aʊ"),
        ("ow", "oʊ"), ("ai", "eɪ"), ("ay", "eɪ"), ("oi", "ɔɪ"),
        ("oy", "ɔɪ"), ("ar", "ɑɹ"), ("er", "ɚ"), ("or", "ɔɹ"), ("ir", "ɜɹ"),
        ("ur", "ɜɹ"),
    ]
    _SINGLE = {
        "a": "æ", "b": "b", "c": "k", "d": "d", "e": "ɛ", "f": "f",
        "g": "ɡ", "h": "h", "i": "ɪ", "j": "ʤ", "k": "k", "l": "l",
        "m": "m", "n": "n", "o": "ɑ", "p": "p", "q": "k", "r": "ɹ",
        "s": "s", "t": "t", "u": "ʌ", "v": "v", "w": "w", "x": "ks",
        "y": "j", "z": "z",
    }

    @classmethod
    def _word(cls, word: str) -> str:
        out, i = ["ˈ"], 0
        while i < len(word):
            for pat, rep in cls._DIGRAPHS:
                if word.startswith(pat, i):
                    out.append(rep)
                    i += len(pat)
                    break
            else:
                out.append(cls._SINGLE.get(word[i], ""))
                i += 1
        # final silent 'e' heuristic
        s = "".join(out)
        if word.endswith("e") and len(word) > 2 and s.endswith("ɛ"):
            s = s[:-1]
        return s

    def phonemize(self, text: str) -> str:
        out = []
        for tok in re.findall(r"\w+'?\w*|[^\w\s]|\s+", text):
            if tok.isspace():
                out.append(" ")
            elif tok[0].isalnum():
                out.append(self._word(tok.lower()))
            else:
                out.append(tok)
        return "".join(out)


class Phonemizer:
    """Backend-selecting front door: espeak → lexicon → rules."""

    def __init__(self, language: str = "en-us", model_dir: str | None = None):
        self.backend = None
        try:
            self.backend = EspeakBackend(language)
            self.kind = "espeak"
            _log.info("kokoro: espeak-ng G2P (%s)", language)
            return
        except (RuntimeError, OSError, AttributeError):
            pass
        if model_dir:
            paths = [os.path.join(model_dir, n)
                     for n in ("us_gold.json", "us_silver.json",
                               "gb_gold.json", "gb_silver.json")]
            try:
                self.backend = LexiconBackend(paths)
                self.kind = "lexicon"
                _log.info("kokoro: lexicon G2P from %s", model_dir)
                return
            except (RuntimeError, OSError, ValueError):
                pass
        self.backend = RuleBackend()
        self.kind = "rules"
        _log.warning("kokoro: using rule-based G2P fallback (no espeak-ng "
                     "library or lexicon files found) — pronunciation quality "
                     "will be reduced")

    def phonemize(self, text: str) -> str:
        return self.backend.phonemize(text)

    def to_ids(self, text: str) -> list[int]:
        return tokenize(self.phonemize(text))
