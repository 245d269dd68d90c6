"""Writes the golden files of tests/test_torch_port_tokenizer_json.py:

    python tests/data/tokenizer_golden/make_golden.py

  - llama3.json, qwen2.json, gpt2.json: byte-level BPE tokenizers trained
    by the HF `tokenizers` trainer on a small seeded corpus, with Llama-3's
    Split pattern and `ignore_merges`, Qwen2's pattern and NFC, and GPT-2's
    ByteLevel(use_regex=True), each with added tokens;
  - whisper.tiktoken: a rank table in the tiktoken format (the 256 bytes,
    then the GPT-2 tokenizer's merges in order);
  - golden.json: the texts, and the ids that `tokenizers` and the JAX
    package's WhisperTokenizer give them.
Needs `tokenizers`, `regex` and the JAX package; the test re-checks the ids.
"""

from __future__ import annotations

import base64
import json
import os
import sys

import numpy as np
from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, normalizers
from tokenizers import pre_tokenizers, trainers

HERE = os.path.dirname(os.path.abspath(__file__))
LLAMA3_PAT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
              r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN2_PAT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
             r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

TEXTS = [
    "Hello, world! It's 2024 -- don't_stop",
    "DON'T SHOUT, I'LL HEAR YOU'RE HERE. We'd've WON'T",
    "digits 1 12 123 1234 12345 3.14159 0x1F 1,000,000",
    "x² 3½ Ⅻa", "x² 3½", "Ⅻa", "ⅷ ① ٣ ४",
    "東京は日本の首都です。你好，世界！ 한국어 텍스트",
    "naïve café résumé é äò Zalgo: z̶̵a̷",
    "emoji 😀👍🏽 family 👨‍👩‍👧 flags 🇫🇷 ✨",
    "lines\r\n\r\nand\n\n\nmore \r\n  indented\ttab\t\tend  ",
    "seps a\x1cb\x1dc\x1ed\x1fe \x85 f",
    "nbsp a\xa0b c　d​e",
    "<|im_start|>system\nYou are helpful.<|im_end|><|im_start|>user\nhi<|im_end|>",
    "mid <mask>  text and  <|endoftext|> after, <sep>   right",
    "single <word> inside a<word>b and (<word>)",
    "normalized NAÏVE naïve naïve ſtop Kelvin",
    "tara: <laugh> well, <|begin_of_text|>hi<|eot_id|> there",
    "   leading spaces and trailing   ",
    "",
]


def corpus(n: int = 3000) -> list[str]:
    rng = np.random.default_rng(0)
    words = ("the quick brown fox jumps over lazy dog speech audio token model "
             "transcribe whisper llama qwen orpheus voice sentence number "
             "東京 日本 首都 你好 世界 한국어 café naïve résumé DON'T It's we'll "
             "2024 123 45 6789 3.14 ½ ² 😀 ✨ --").split()
    out = []
    for _ in range(n):
        k = int(rng.integers(3, 12))
        s = " ".join(words[int(i)] for i in rng.integers(0, len(words), k))
        if rng.random() < 0.2:
            s += "\n"
        out.append(s)
    return out


def added_tokens() -> list[AddedToken]:
    return [AddedToken("<|endoftext|>", special=True, normalized=False),
            AddedToken("<|im_start|>", special=True, normalized=False),
            AddedToken("<|im_end|>", special=True, normalized=False),
            AddedToken("<mask>", special=True, lstrip=True, normalized=False),
            AddedToken("<sep>", special=False, rstrip=True, normalized=False),
            AddedToken("<word>", special=False, single_word=True, normalized=False),
            AddedToken("naïve", special=False, normalized=True),
            AddedToken("<|begin_of_text|>", special=True, normalized=False),
            AddedToken("<|eot_id|>", special=True, normalized=False),
            AddedToken("<laugh>", special=False, normalized=False)]


def train(name: str) -> Tokenizer:
    bpe = models.BPE(ignore_merges=name == "llama3")
    tok = Tokenizer(bpe)
    if name == "gpt2":
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True, use_regex=True)
    else:
        pat = LLAMA3_PAT if name == "llama3" else QWEN2_PAT
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(pat), behavior="isolated", invert=False),
            pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    if name == "qwen2":
        tok.normalizer = normalizers.NFC()
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=700, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(corpus(), trainer)
    tok.add_tokens(added_tokens())
    return tok


def whisper_ranks(gpt2: Tokenizer) -> dict[bytes, int]:
    """The 256 bytes, then each merge of the GPT-2 tokenizer in order."""
    byte_of = {c: b for b, c in bytes_to_unicode().items()}
    spec = json.loads(gpt2.to_str())
    ranks = {bytes([b]): b for b in range(256)}
    for m in spec["model"]["merges"]:
        a, b = m.split(" ") if isinstance(m, str) else m
        piece = bytes(byte_of[c] for c in a + b)
        ranks.setdefault(piece, len(ranks))
    return ranks


def bytes_to_unicode() -> dict[int, str]:
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
            *range(ord("®"), ord("ÿ") + 1)]
    extra = iter(range(256, 512))
    return {b: chr(b) if b in keep else chr(next(extra)) for b in range(256)}


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    from tpu_audio.models.whisper.tokenizer import BPE, WhisperTokenizer

    golden = {"texts": TEXTS, "ids": {}}
    toks = {}
    for name in ("llama3", "qwen2", "gpt2"):
        toks[name] = tok = train(name)
        tok.save(os.path.join(HERE, f"{name}.json"))
        golden["ids"][name] = [tok.encode(t, add_special_tokens=False).ids for t in TEXTS]
    ranks = whisper_ranks(toks["gpt2"])
    with open(os.path.join(HERE, "whisper.tiktoken"), "w") as f:
        for piece, rank in sorted(ranks.items(), key=lambda kv: kv[1]):
            f.write(f"{base64.b64encode(piece).decode()} {rank}\n")
    wtok = WhisperTokenizer(BPE(ranks), True, 100)
    golden["ids"]["whisper"] = [wtok.encode(t) for t in TEXTS]
    with open(os.path.join(HERE, "golden.json"), "w") as f:
        json.dump(golden, f, ensure_ascii=True, indent=0)
        f.write("\n")


if __name__ == "__main__":
    main()
