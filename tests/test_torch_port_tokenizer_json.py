"""The port's `tokenizer.json` reader (tpu_audio_torch/utils/tokenizer.py:
HFTokenizer), its Unicode classes for `re` (utils/_unicode.py) and the
Whisper BPE's pattern without `regex` (ROADMAP C10), against the HF
`tokenizers` runtime, the `regex` module and the JAX package.

The port runs in a subprocess with `regex` blocked, as on the card, which
has neither `regex` nor `tokenizers`. The small tokenizers under
tests/data/tokenizer_golden/ were trained by `tokenizers`' own trainer
(`make_golden.py` there): Llama-3's Split pattern with `ignore_merges`,
Qwen2's pattern with NFC, GPT-2's ByteLevel(use_regex=True), each with
added tokens (special, lstrip, rstrip, single_word, normalized).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import unicodedata
from pathlib import Path

import numpy as np
import pytest
import regex
from tokenizers import Tokenizer

from tpu_audio.models.whisper.tokenizer import BPE as JBPE
from tpu_audio.models.whisper.tokenizer import WhisperTokenizer as JWhisperTokenizer
from tpu_audio_torch.models.whisper import tokenizer as ttokenizer
from tpu_audio_torch.utils import _unicode
from tpu_audio_torch.utils.tokenizer import ByteFallbackTokenizer, HFTokenizer, load_tokenizer
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
GOLD = ROOT / "tests" / "data" / "tokenizer_golden"
NAMES = ("llama3", "qwen2", "gpt2")
# code points where Python's unicodedata (Unicode 15.0 on Python 3.12)
# and the newer `regex` disagree on \p{L} or \p{N}: all unassigned (Cn) in 15.0
LN_DIFFER_CN = 9661


def golden() -> dict:
    return json.loads((GOLD / "golden.json").read_text())


def fuzz_texts(n: int = 300) -> list[str]:
    """Seeded strings over the characters where pre-tokenisers differ."""
    pool = (list("abcXYZ019 '_-.,!?\t\n\r") + ["'S", "'LL", "DON'T", "ſ", "K", "x²", "3½",
            "Ⅻ", "①", "٣", "\x1c", "\x1d", "\x1e", "\x1f", "\x85", "\xa0", "　", "​",
            "é", "́", "東京", "한", "😀", "👍🏽", "👨‍👩", "<|im_start|>",
            "<|im_end|>", " <mask> ", "<sep>  ", "a<word>", " <word> ", "naïve", "\r\n\r\n",
            "   ", "12345", "<|eot_id|>", "<laugh>"])
    rng = np.random.default_rng(0)
    return ["".join(pool[int(i)] for i in rng.integers(0, len(pool), int(rng.integers(1, 25))))
            for _ in range(n)]


def run_port(code: str) -> dict:
    """Run `code` (which prints one JSON object) with regex blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", "import sys\nsys.modules['regex'] = None\n" + code],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env={**os.environ})
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


# ------------------------------------------------------------ golden

@pytest.mark.parametrize("name", NAMES)
def test_golden_ids_still_those_of_tokenizers(name):
    gold = golden()
    tok = Tokenizer.from_file(str(GOLD / f"{name}.json"))
    got = [tok.encode(t, add_special_tokens=False).ids for t in gold["texts"]]
    assert got == gold["ids"][name]


def test_golden_whisper_ids_still_those_of_jax():
    gold = golden()
    tok = JWhisperTokenizer(JBPE.from_tiktoken_file(str(GOLD / "whisper.tiktoken")), True, 100)
    assert [tok.encode(t) for t in gold["texts"]] == gold["ids"]["whisper"]


# ------------------------------------------------------------ the reader

@pytest.mark.parametrize("name", NAMES)
def test_reader_matches_tokenizers_without_regex(name):
    """encode, decode (special tokens skipped), decode_raw (kept) and
    vocab_size of the port, with regex blocked, against `tokenizers` on the
    golden texts, a seeded fuzz and random id runs."""
    gold = golden()
    texts = gold["texts"] + fuzz_texts()
    tok = Tokenizer.from_file(str(GOLD / f"{name}.json"))
    rng = np.random.default_rng(1)
    id_runs = [gold["ids"][name][i] for i in range(len(gold["texts"]))]
    id_runs += [[int(x) for x in rng.integers(0, tok.get_vocab_size() + 2, 12)]
                for _ in range(200)]
    code = (
        "import json\n"
        "from tpu_audio_torch.utils.tokenizer import HFTokenizer\n"
        f"tok = HFTokenizer({str(GOLD / f'{name}.json')!r})\n"
        f"texts, runs = json.loads({json.dumps([texts, id_runs])!r})\n"
        "print(json.dumps({'enc': [tok.encode(t) for t in texts],\n"
        "                  'dec': [tok.decode(r) for r in runs],\n"
        "                  'raw': [tok.decode_raw(r) for r in runs],\n"
        "                  'vocab': tok.vocab_size}))\n")
    port = run_port(code)
    want_enc = [tok.encode(t, add_special_tokens=False).ids for t in texts]
    bad = [(t, g, w) for t, g, w in zip(texts, port["enc"], want_enc) if g != w]
    assert not bad, bad[:3]
    assert port["dec"] == [tok.decode(r, skip_special_tokens=True) for r in id_runs]
    assert port["raw"] == [tok.decode(r, skip_special_tokens=False) for r in id_runs]
    assert port["vocab"] == tok.get_vocab_size()
    assert port["enc"][: len(gold["texts"])] == gold["ids"][name]


def test_added_tokens_split_before_pretokenisation():
    """Mid-text added tokens with lstrip / rstrip / single_word and a
    normalized one, in-process against `tokenizers` (either regex engine
    gives these ids)."""
    text = "a <mask>  b<sep>   c x<word>y (<word>) naïve <|im_start|>d"
    for name in NAMES:
        ours = HFTokenizer(str(GOLD / f"{name}.json"))
        ref = Tokenizer.from_file(str(GOLD / f"{name}.json"))
        assert ours.encode(text) == ref.encode(text, add_special_tokens=False).ids
        ids = ours.encode(text)
        assert ref.token_to_id("<mask>") in ids and ref.token_to_id("<sep>") in ids
        assert ids.count(ref.token_to_id("<word>")) == 1  # "x<word>y" is not a single word


def _spec(name: str = "qwen2") -> dict:
    return json.loads((GOLD / f"{name}.json").read_text())


@pytest.mark.parametrize("edit, names", [
    (lambda s: s["model"].update(type="WordPiece"), "WordPiece"),
    (lambda s: s["model"].update(type="Unigram"), "Unigram"),
    (lambda s: s.update(normalizer={"type": "Lowercase"}), "Lowercase"),
    (lambda s: s.update(pre_tokenizer={"type": "Whitespace"}), "Whitespace"),
    (lambda s: s["pre_tokenizer"]["pretokenizers"][0].update(behavior="Removed"), "Isolated"),
    (lambda s: s.update(decoder={"type": "WordPiece"}), "WordPiece"),
    (lambda s: s.update(truncation={"max_length": 8}), "truncation"),
    (lambda s: s["model"].update(byte_fallback=True), "byte_fallback"),
    (lambda s: s["model"].update(dropout=0.1), "dropout"),
    (lambda s: s["model"].update(unk_token="<unk>"), "unk_token"),
    (lambda s: s.update(normalizer={"type": "NFKC"}), "NFKC"),
    (lambda s: s["pre_tokenizer"]["pretokenizers"][0].update(pattern={"Regex": r" ?\w+|\s+"}),
     r"escape \\w"),
], ids=["wordpiece", "unigram", "normalizer", "pre_tokenizer", "split behaviour", "decoder",
        "truncation", "byte_fallback", "dropout", "unknown token", "other normal form",
        "class escape re reads otherwise"])
def test_reader_refuses_unsupported(tmp_path, edit, names):
    spec = _spec()
    edit(spec)
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec))
    with pytest.raises(ValueError, match=names):
        HFTokenizer(str(path))


def test_load_tokenizer_picks_the_file(tmp_path):
    assert isinstance(load_tokenizer(None), ByteFallbackTokenizer)
    assert isinstance(load_tokenizer(str(tmp_path)), ByteFallbackTokenizer)
    (tmp_path / "tokenizer.json").write_text((GOLD / "gpt2.json").read_text())
    tok = load_tokenizer(str(tmp_path))
    assert isinstance(tok, HFTokenizer)
    assert tok.encode(golden()["texts"][0]) == golden()["ids"]["gpt2"][0]
    (tmp_path / "tokenizer.json").write_text("{}")
    with pytest.raises(ValueError):
        load_tokenizer(str(tmp_path))
    stand_in = ByteFallbackTokenizer()
    assert stand_in.decode_raw(stand_in.encode("héllo")) == "héllo"


# ------------------------------------------------------------ Unicode classes

def _all_chars() -> str:
    return "".join(chr(c) for c in range(sys.maxunicode + 1) if not 0xD800 <= c <= 0xDFFF)


@pytest.mark.parametrize("cat", ["L", "N"])
def test_unicode_classes_match_regex_on_assigned_code_points(cat):
    """\\p{cat} through `_unicode` against `regex` on every code point:
    equal on each one Python's unicodedata assigns; where they differ the
    code point is unassigned (Cn) in Python's Unicode version."""
    chars = _all_chars()
    ours = set(_unicode.compile(rf"\p{{{cat}}}").findall(chars))
    theirs = set(regex.findall(rf"\p{{{cat}}}", chars))
    differ = ours ^ theirs
    assert {unicodedata.category(c) for c in differ} <= {"Cn"}
    inside = set(_unicode.compile(rf"[\p{{{cat}}}]").findall(chars))
    assert inside == ours


def test_unicode_l_and_n_differ_only_on_the_stated_count():
    if unicodedata.unidata_version != "15.0.0":
        pytest.skip(f"the count is stated for Unicode 15.0, not {unicodedata.unidata_version}")
    chars = _all_chars()
    n = sum(len(set(_unicode.compile(rf"\p{{{c}}}").findall(chars))
                ^ set(regex.findall(rf"\p{{{c}}}", chars))) for c in "LN")
    assert n == LN_DIFFER_CN


def test_white_space_matches_regex_not_re():
    """`\\s` becomes Unicode's White_Space, as in `regex` and Oniguruma;
    `re`'s own also takes U+001C..U+001F."""
    chars = _all_chars()
    assert set(_unicode.compile(r"\s").findall(chars)) == set(regex.findall(r"\s", chars))
    not_s = _unicode.compile(r"\S")
    assert not_s.match("\x1c") and not not_s.match("\xa0")


@pytest.mark.parametrize("pattern", [
    r"\P{L}", r"[\S]", r"\p{M}", r"\p{Letter}", r"\p{L",
    # escapes that re reads otherwise than regex and Oniguruma: re's \w and
    # \d follow str.isalnum()/isdecimal(), \b the \w boundary
    r"\w+", r"[^\W]", r"\d{1,3}", r"[\D]", r"\bx", r"\B", r"\h",
    # a POSIX bracket, a nested class, an intersection: literals to re
    r"[[:alpha:]]", r"[a[bc]]", r"[\p{L}&&a]"])
def test_unicode_refuses_what_it_cannot_translate(pattern):
    with pytest.raises(ValueError):
        _unicode.translate(pattern)


def test_unicode_compile_names_a_pattern_re_refuses():
    with pytest.raises(ValueError, match="unsupported pattern"):
        _unicode.compile(r"(?<x")


# ------------------------------------------------------------ Whisper (C10)

def test_whisper_bpe_without_regex_matches_jax():
    """ROADMAP C10: without `regex` the port's Whisper pre-tokeniser took
    `[^\\W\\d_]` for \\p{L} and `\\d` for \\p{N}, so numerals of categories
    No and Nl split otherwise: "x² 3½" gave ['x²', ' 3', '½'] where `regex`
    gives ['x', '²', ' 3½'], and "Ⅻa" ['Ⅻa'] where it gives ['Ⅻ', 'a']."""
    texts = ["x² 3½", "Ⅻa", "a\x1c\x1d b\xa0c", "DON'T 12345 東京 😀"] + golden()["texts"]
    jtok = JWhisperTokenizer(JBPE.from_tiktoken_file(str(GOLD / "whisper.tiktoken")), True, 100)
    code = (
        "import json\n"
        "from tpu_audio_torch.models.whisper.tokenizer import BPE, WhisperTokenizer\n"
        f"tok = WhisperTokenizer(BPE.from_tiktoken_file({str(GOLD / 'whisper.tiktoken')!r}),\n"
        "                       True, 100)\n"
        f"texts = json.loads({json.dumps(texts)!r})\n"
        "print(json.dumps({'ids': [tok.encode(t) for t in texts],\n"
        "                  'pieces': [tok.bpe.pat.findall(t) for t in texts[:2]]}))\n")
    port = run_port(code)
    assert port["pieces"] == [["x", "²", " 3½"], ["Ⅻ", "a"]]
    assert port["ids"] == [jtok.encode(t) for t in texts]
    with_regex = ttokenizer.WhisperTokenizer(ttokenizer.BPE.from_tiktoken_file(
        str(GOLD / "whisper.tiktoken")), True, 100)
    assert [with_regex.encode(t) for t in texts] == port["ids"]


def test_whisper_tokenizer_load_looks_in_the_cache(tmp_path, monkeypatch):
    """`WhisperTokenizer.load` reads the model directory's rank table, else
    ~/.cache/tpu_audio/whisper/'s, as the JAX one does; else it raises."""
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="multilingual.tiktoken"):
        ttokenizer.WhisperTokenizer.load(str(tmp_path))
    cache = tmp_path / ".cache" / "tpu_audio" / "whisper"
    cache.mkdir(parents=True)
    (cache / "multilingual.tiktoken").write_text((GOLD / "whisper.tiktoken").read_text())
    for model_dir in (None, str(tmp_path)):
        tok = ttokenizer.WhisperTokenizer.load(model_dir, num_languages=100)
        jtok = JWhisperTokenizer.load(model_dir, num_languages=100)
        assert tok.encode("x² 3½ Ⅻa") == jtok.encode("x² 3½ Ⅻa")
        assert (tok.eot, tok.timestamp_begin) == (jtok.eot, jtok.timestamp_begin)
