"""Text tokenizers for the LLM-based engines (port of
tpu_audio/utils/tokenizer.py: ByteFallbackTokenizer, HFTokenizer,
load_tokenizer).

The JAX package reads a checkpoint's `tokenizer.json` with the HF
`tokenizers` runtime; the card's Python has neither it nor `regex`, so
`HFTokenizer` here reads the file in plain Python, for the byte-level BPE
tokenizers of the Llama-3, Qwen2/Qwen3 and GPT-2 families:
  - model: BPE (`vocab`, `merges` as "a b" strings or as pairs,
    `ignore_merges`);
  - normalizer: none, NFC, or a Sequence of those;
  - pre-tokenizer: Split on a Regex pattern (behaviour Isolated, not
    inverted), ByteLevel (`add_prefix_space`, `use_regex` with the
    GPT-2 pattern), or a Sequence of those; the patterns go through
    `utils/_unicode.py` for `re`;
  - added tokens, split out of the text before pre-tokenisation whatever
    `add_special_tokens` says, with `special`, `lstrip`, `rstrip`,
    `single_word` and `normalized` honoured (matched leftmost-longest, as
    the runtime's Aho-Corasick automaton does);
  - decoder: ByteLevel.
`encode` is the runtime's `encode(text, add_special_tokens=False)`, so the
post-processor (which only adds special tokens) does not apply. Anything
else (WordPiece, Unigram, other normalizers, pre-tokenizers or decoders,
truncation, padding, dropout, an unknown token, a subword prefix or suffix,
byte fallback) raises ValueError naming it. `single_word` takes a word character to be
one that str.isalnum() accepts; the runtime also counts the combining
marks of Unicode's Other_Alphabetic.

Without a `tokenizer.json`, `load_tokenizer` gives the deterministic
byte-level stand-in that engines on random weights use.
"""

from __future__ import annotations

import functools
import json
import os
import re
import unicodedata

from tpu_audio_torch.utils import _unicode

# the pattern of the ByteLevel pre-tokenizer's `use_regex`
GPT2_PAT = (r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"""
            r"""| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
_WHITE_SPACE = frozenset(map(chr, _unicode.WHITE_SPACE))
_WORD_CACHE = 1 << 16  # pre-tokens whose ids are kept


class ByteFallbackTokenizer:
    """Maps UTF-8 bytes to ids 0..255. Not a real BPE: a stand-in that
    keeps prompt construction working without vocabulary files."""

    vocab_size = 256

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", "replace")

    decode_raw = decode


@functools.cache
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte → printable character table of the ByteLevel steps."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
            *range(ord("®"), ord("ÿ") + 1)]
    table, extra = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + extra)
            extra += 1
    return table


def _unsupported(what: str, spec) -> ValueError:
    return ValueError(f"tokenizer.json: unsupported {what}: {json.dumps(spec)[:200]}")


def _normalizer(spec):
    """str → str for the normalizer spec."""
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "NFC":
        return functools.partial(unicodedata.normalize, "NFC")
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]
        return functools.reduce(lambda f, g: lambda s: g(f(s)), steps, lambda s: s)
    raise _unsupported(f"normalizer {kind!r}", spec)


def _isolated(pat: re.Pattern, text: str) -> list[str]:
    """Split `text` into the matches of `pat` and the gaps between them
    (the Isolated behaviour), empty pieces dropped."""
    out, last = [], 0
    for m in pat.finditer(text):
        if m.start() > last:
            out.append(text[last:m.start()])
        if m.end() > m.start():
            out.append(m.group())
        last = m.end()
    if last < len(text):
        out.append(text[last:])
    return out


def _pre_tokenizer(spec):
    """str → list of pre-tokens (byte-level mapped where ByteLevel runs)."""
    if spec is None:
        return lambda s: [s]
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def run(s):
            pieces = [s]
            for step in steps:
                pieces = [q for p in pieces for q in step(p)]
            return pieces
        return run
    if kind == "Split":
        pattern = spec.get("pattern", {})
        if spec.get("behavior") != "Isolated" or spec.get("invert") or "Regex" not in pattern:
            raise _unsupported("Split (a Regex pattern, Isolated, not inverted, only)", spec)
        return functools.partial(_isolated, _unicode.compile(pattern["Regex"]))
    if kind == "ByteLevel":
        table = bytes_to_unicode()
        pat = _unicode.compile(GPT2_PAT) if spec.get("use_regex", True) else None
        prefix = spec.get("add_prefix_space", True)

        def run(s):
            if prefix and not s.startswith(" "):
                s = " " + s
            pieces = _isolated(pat, s) if pat is not None else [s]
            return ["".join(table[b] for b in p.encode("utf-8")) for p in pieces]
        return run
    raise _unsupported(f"pre_tokenizer {kind!r}", spec)


class HFTokenizer:
    """A checkpoint's byte-level BPE `tokenizer.json`, read in plain Python."""

    def __init__(self, path: str):
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise _unsupported(key, spec[key])
        model = spec.get("model") or {}
        if model.get("type", "BPE") != "BPE" or "vocab" not in model or "merges" not in model:
            raise _unsupported(f"model {model.get('type')!r} (BPE only)",
                               {k: v for k, v in model.items() if k not in ("vocab", "merges")})
        for key in ("dropout", "unk_token", "continuing_subword_prefix", "end_of_word_suffix",
                    "byte_fallback"):
            if model.get(key):
                raise _unsupported(f"BPE {key}", model[key])
        decoder = spec.get("decoder") or {}
        if decoder.get("type") != "ByteLevel":
            raise _unsupported(f"decoder {decoder.get('type')!r} (ByteLevel only)", decoder)
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))

        self.vocab: dict[str, int] = model["vocab"]
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(model["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self.id_to_token = {i: t for t, i in self.vocab.items()}

        self.added = spec.get("added_tokens") or []
        for t in self.added:
            self.id_to_token[t["id"]] = t["content"]
        self.special_ids = {t["id"] for t in self.added if t.get("special")}
        self.vocab_size = len(set(self.vocab) | {t["content"] for t in self.added})
        self._raw = self._matcher([t for t in self.added if not t.get("normalized")])
        self._normed = self._matcher([t for t in self.added if t.get("normalized")],
                                     self.normalize)
        self._byte_of = {c: b for b, c in bytes_to_unicode().items()}
        self._words: dict[str, list[int]] = {}

    # ------------------------------------------------------------ encode

    @staticmethod
    def _matcher(tokens: list[dict], normalize=None):
        """(pattern finding the added tokens leftmost-longest, content → token)."""
        if not tokens:
            return None
        by_content = {}
        for t in tokens:
            by_content.setdefault(normalize(t["content"]) if normalize else t["content"], t)
        alts = sorted(by_content, key=len, reverse=True)
        return re.compile("|".join(map(re.escape, alts))), by_content

    @staticmethod
    def _split_added(text: str, matcher) -> list[tuple[str, int | None]]:
        """text → [(piece, added token id or None)], as the runtime's
        AddedVocabulary.find_matches splits it."""
        if matcher is None or not text:
            return [(text, None)] if text else []
        pat, by_content = matcher
        out, start_offset = [], 0
        for m in pat.finditer(text):
            tok = by_content[m.group()]
            start, stop = m.start(), m.end()
            if tok.get("single_word") and (
                    (start > 0 and text[start - 1].isalnum())
                    or (stop < len(text) and text[stop].isalnum())):
                continue
            if tok.get("lstrip"):
                s = start
                while s > 0 and text[s - 1] in _WHITE_SPACE:
                    s -= 1
                start = max(s, start_offset)
            if tok.get("rstrip"):
                while stop < len(text) and text[stop] in _WHITE_SPACE:
                    stop += 1
            if start_offset < start:
                out.append((text[start_offset:start], None))
            out.append((text[start:stop], tok["id"]))
            start_offset = stop
        if start_offset < len(text):
            out.append((text[start_offset:], None))
        return out

    def _bpe(self, word: str) -> list[int]:
        ids = self._words.get(word)
        if ids is not None:
            return ids
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            # the runtime drops a character it cannot map (none, byte-level)
            ids = [self.vocab[ch] for ch in word if ch in self.vocab]
            while len(ids) > 1:
                best = None
                for p in range(len(ids) - 1):
                    m = self.merges.get((ids[p], ids[p + 1]))
                    if m is not None and (best is None or m[0] < best[0]):
                        best = (m[0], p, m[1])
                if best is None:
                    break
                _, p, new = best
                ids[p:p + 2] = [new]
        if len(self._words) < _WORD_CACHE:
            self._words[word] = ids
        return ids

    def encode(self, text: str) -> list[int]:
        """Token ids of `text`, as `encode(text, add_special_tokens=False)`."""
        out: list[int] = []
        for piece, tid in self._split_added(text, self._raw):
            if tid is not None:
                out.append(tid)
                continue
            for part, tid2 in self._split_added(self.normalize(piece), self._normed):
                if tid2 is not None:
                    out.append(tid2)
                    continue
                for word in self.pre_tokenize(part):
                    out.extend(self._bpe(word))
        return out

    # ------------------------------------------------------------ decode

    def _decode(self, ids, skip_special: bool) -> str:
        data = bytearray()
        for i in map(int, ids):
            tok = self.id_to_token.get(i)
            if tok is None or (skip_special and i in self.special_ids):
                continue
            try:
                data.extend([self._byte_of[c] for c in tok])
            except KeyError:  # a character outside the byte table: the token's own UTF-8
                data.extend(tok.encode("utf-8"))
        return data.decode("utf-8", "replace")

    def decode(self, ids) -> str:
        """Text of `ids`, special tokens skipped."""
        return self._decode(ids, True)

    def decode_raw(self, ids) -> str:
        """Text of `ids`, special tokens kept (the <|c1_N|>-style audio-code
        tokens of a generated stream)."""
        return self._decode(ids, False)


def load_tokenizer(model_dir: str | None):
    """HFTokenizer of model_dir/tokenizer.json, or the byte-level stand-in
    when there is no such file."""
    if model_dir:
        p = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(p):
            return HFTokenizer(p)
    return ByteFallbackTokenizer()
