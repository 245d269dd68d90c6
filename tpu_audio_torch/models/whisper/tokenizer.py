"""Whisper tiktoken-format BPE tokenizer (port of
tpu_audio/models/whisper/tokenizer.py).

Vocabulary files are the standard OpenAI `multilingual.tiktoken` /
`gpt2.tiktoken` (base64 token + rank per line). Special-token ids follow
from the base vocab size and the language count
(WhisperTokenizer.swift:84-98):

  eot, sot, <languages×N>, translate, transcribe, sotLm, sotPrev,
  noSpeech, noTimestamps, timestamps <|0.00|>..

Pre-tokenisation uses `re` with the pattern's \\p{L}, \\p{N} and \\s
spelled out as code-point classes (`utils/_unicode.py`), which split every
assigned code point as `regex` does. The merge is pure Python.
"""

from __future__ import annotations

import base64
import functools
import os

from tpu_audio_torch.utils import _unicode

GPT2_PAT = (r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"""
            r"""| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")


# Whisper language registry, in token-id order (token id = sot + 1 + index).
# 100 entries; models with num_languages == 99 exclude the final "yue".
LANGUAGES = [
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
]


class BPE:
    """Byte-level BPE over a rank table (tiktoken semantics)."""

    def __init__(self, ranks: dict[bytes, int]):
        self.ranks = ranks
        self.id_to_bytes = {v: k for k, v in ranks.items()}
        self.pat = _unicode.compile(GPT2_PAT)

    @staticmethod
    def from_tiktoken_file(path: str) -> "BPE":
        ranks = {}
        with open(path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                tok, rank = line.split()
                ranks[base64.b64decode(tok)] = int(rank)
        return BPE(ranks)

    def _bpe_merge(self, piece: bytes) -> list[int]:
        if piece in self.ranks:
            return [self.ranks[piece]]
        parts = [piece[i : i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_rank, best_i = None, None
            for i in range(len(parts) - 1):
                r = self.ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i is None:
                break
            parts = (parts[:best_i] + [parts[best_i] + parts[best_i + 1]]
                     + parts[best_i + 2 :])
        out = []
        for p in parts:
            if p in self.ranks:
                out.append(self.ranks[p])
            else:  # unknown byte: emit per-byte ids (all 256 bytes are in vocab)
                out.extend(self.ranks[bytes([b])] for b in p)
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for piece in self.pat.findall(text):
            ids.extend(self._bpe_merge(piece.encode("utf-8")))
        return ids

    def decode_bytes(self, ids) -> bytes:
        return b"".join(self.id_to_bytes.get(int(i), b"") for i in ids)

    def decode(self, ids) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")


class WhisperTokenizer:
    def __init__(self, bpe: BPE, multilingual: bool, num_languages: int):
        self.bpe = bpe
        self.multilingual = multilingual
        self.num_languages = num_languages

        base = 50257 if multilingual else 50256
        nid = base
        self.eot = nid; nid += 1
        self.sot = nid; nid += 1
        self.language_tokens = {lang: nid + i
                                for i, lang in enumerate(LANGUAGES[:num_languages])}
        nid += num_languages
        self.translate = nid; nid += 1
        self.transcribe = nid; nid += 1
        self.sot_lm = nid; nid += 1
        self.sot_prev = nid; nid += 1
        self.no_speech = nid; nid += 1
        self.no_timestamps = nid; nid += 1
        self.timestamp_begin = nid

        self._special_names = {self.eot: "<|endoftext|>", self.sot: "<|startoftranscript|>",
                               self.translate: "<|translate|>", self.transcribe: "<|transcribe|>",
                               self.sot_lm: "<|startoflm|>", self.sot_prev: "<|startofprev|>",
                               self.no_speech: "<|nospeech|>",
                               self.no_timestamps: "<|notimestamps|>"}
        for lang, tid in self.language_tokens.items():
            self._special_names[tid] = f"<|{lang}|>"

    @staticmethod
    def load(model_dir: str | None = None, multilingual: bool = True,
             num_languages: int = 99) -> "WhisperTokenizer":
        """Read `multilingual.tiktoken` (or `gpt2.tiktoken`) from model_dir,
        else from ~/.cache/tpu_audio/whisper/."""
        name = "multilingual.tiktoken" if multilingual else "gpt2.tiktoken"
        candidates = []
        if model_dir:
            candidates.append(os.path.join(model_dir, name))
        candidates.append(os.path.join(os.path.expanduser("~"), ".cache", "tpu_audio",
                                       "whisper", name))
        for path in candidates:
            if os.path.exists(path):
                return WhisperTokenizer(BPE.from_tiktoken_file(path), multilingual,
                                        num_languages)
        raise FileNotFoundError(
            f"{name} not found in {candidates}; place the OpenAI Whisper "
            "vocabulary file in the model directory")

    # -------------------------------------------------------------- encode/decode

    def encode(self, text: str) -> list[int]:
        return self.bpe.encode(text)

    def decode(self, ids) -> str:
        return self.bpe.decode([i for i in ids if i < self.eot])

    def decode_with_timestamps(self, ids) -> str:
        parts = []
        for i in ids:
            i = int(i)
            if i >= self.timestamp_begin:
                parts.append(f"<|{(i - self.timestamp_begin) * 0.02:.2f}|>")
            elif i in self._special_names:
                parts.append(self._special_names[i])
            else:
                parts.append(self.bpe.decode([i]))
        return "".join(parts)

    # -------------------------------------------------------------- sequences

    def sot_sequence(self, language: str = "en", task: str = "transcribe") -> list[int]:
        if not self.multilingual:
            return [self.sot]
        lang_tok = self.language_tokens.get(language)
        if lang_tok is None:
            raise KeyError(f"unsupported language {language!r}")
        task_tok = self.translate if task == "translate" else self.transcribe
        return [self.sot, lang_tok, task_tok]

    @functools.cached_property
    def non_speech_tokens(self) -> list[int]:
        """Token ids suppressed during decoding: symbols/sounds the model
        should never emit mid-transcript (matches openai-whisper's
        SuppressTokens default list construction)."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += ("<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] "
                    "{{ }} ♪♪ ♪♪♪").split()
        miscellaneous = set("♩♪♫♬♭♮♯")
        result = {self.encode(" -")[0], self.encode(" '")[0]}
        for symbol in symbols + list(miscellaneous):
            for tokens in [self.encode(symbol), self.encode(" " + symbol)]:
                if len(tokens) == 1 or symbol in miscellaneous:
                    result.add(tokens[0])
        return sorted(result)
