"""Text tokenizers for the LLM-based engines (port of
tpu_audio/utils/tokenizer.py: ByteFallbackTokenizer, load_tokenizer).

A checkpoint's `tokenizer.json` needs the HF `tokenizers` runtime, which
the port does not use yet (ROADMAP A10): `load_tokenizer` raises for one
rather than falling back in silence. Without a model directory it gives
the deterministic byte-level stand-in that engines on random weights use.
"""

from __future__ import annotations

import os


class ByteFallbackTokenizer:
    """Maps UTF-8 bytes to ids 0..255. Not a real BPE: a stand-in that
    keeps prompt construction working without vocabulary files."""

    vocab_size = 256

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", "replace")


def load_tokenizer(model_dir: str | None):
    if model_dir and os.path.exists(os.path.join(model_dir, "tokenizer.json")):
        raise NotImplementedError(
            "tokenizer.json needs the HF tokenizers runtime, not ported yet (ROADMAP A10)")
    return ByteFallbackTokenizer()
