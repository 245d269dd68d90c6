"""Text segmentation for TTS (port of tpu_audio/utils/text.py:
detect_script, split_into_sentences, split_at_punctuation_boundary): a
sentence split, then short sentences merged up to the script's chunk
length until a strong ending (latin chunks 50-300 characters, CJK 30-200,
Indic 40-250). Scripts are told apart by Unicode block. Kokoro splits a
sentence over its token cap at the punctuation nearest its middle.
"""

from __future__ import annotations

import re

_SENTENCE_END = r"[.!?。！？…।॥]"
# split after sentence-ending punctuation (+ closing quotes/brackets) followed
# by whitespace, or after CJK terminators directly
_SPLIT_RE = re.compile(
    rf"(?<={_SENTENCE_END})[\"'”’\)\]]*\s+"
    r"|(?<=[。！？…])",
)

_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3040, 0x30FF), (0x3400, 0x4DBF),
               (0xAC00, 0xD7AF), (0xF900, 0xFAFF))
_INDIC_RANGES = ((0x0900, 0x0DFF),)  # Devanagari..Sinhala


def detect_script(text: str) -> str:
    cjk = indic = latin = 0
    for ch in text[:400]:
        cp = ord(ch)
        if any(lo <= cp <= hi for lo, hi in _CJK_RANGES):
            cjk += 1
        elif any(lo <= cp <= hi for lo, hi in _INDIC_RANGES):
            indic += 1
        elif ch.isalpha() and cp < 0x250:
            latin += 1
    top = max(cjk, indic, latin)
    if top == 0:
        return "other"
    if top == cjk:
        return "cjk"
    if top == indic:
        return "indic"
    return "latin"


_CHUNK_PARAMS = {
    "latin": (50, 300, " ", (".", "!", "?")),
    "other": (50, 300, " ", (".", "!", "?")),
    "cjk": (30, 200, "", ("。", "！", "？", "…")),
    "indic": (40, 250, " ", ("।", "॥", ".", "!", "?")),
}


def split_into_sentences(text: str) -> list[str]:
    """Split text into TTS-sized chunks: sentence split, then merge short
    sentences up to the script's max length until a strong ending."""
    text = text.strip()
    if not text:
        return []
    script = detect_script(text)
    sentences = [s.strip() for s in _SPLIT_RE.split(text) if s and s.strip()]
    if not sentences:
        sentences = [text]

    min_len, max_len, sep, endings = _CHUNK_PARAMS[script]

    def should_merge(chunk: str) -> bool:
        return len(chunk) < min_len or not chunk.endswith(endings)

    result: list[str] = []
    current = ""
    for s in sentences:
        if not current:
            current = s
        elif (len(current) + len(s) + len(sep) <= max_len
              and should_merge(current)):
            current = current + sep + s
        else:
            result.append(current)
            current = s
    if current:
        result.append(current)
    return result


_PUNCT_PRIORITY = [".", "!", "?", ";", ":", ",", " "]


def split_at_punctuation_boundary(text: str, min_length: int = 10
                                  ) -> tuple[str, str] | None:
    """Split near the middle at the highest-priority punctuation, searching
    outward from the centre (right side first); None for a text of at
    most min_length characters or one with no such mark."""
    trimmed = text.strip()
    if len(trimmed) <= min_length:
        return None
    mid = len(trimmed) // 2
    max_dist = len(trimmed) // 2
    for punct in _PUNCT_PRIORITY:
        left, right = 1, 0
        while left < max_dist or right < max_dist:
            if right < max_dist:
                i = mid + right
                if i < len(trimmed) and trimmed[i] == punct:
                    first, second = trimmed[: i + 1].strip(), trimmed[i + 1:].strip()
                    if first and second:
                        return first, second
                right += 1
            if left < max_dist:
                i = mid - left
                if i > 0 and trimmed[i] == punct:
                    first, second = trimmed[: i + 1].strip(), trimmed[i + 1:].strip()
                    if first and second:
                        return first, second
                left += 1
    return None
