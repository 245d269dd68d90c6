"""Unicode property classes for the standard `re` module, which lacks
`\\p{..}`: the pre-tokeniser patterns of Whisper and of a checkpoint's
`tokenizer.json` are written for `regex` (and Oniguruma, which the HF
`tokenizers` runtime uses), and the card's Python has no `regex`.

`translate(pattern)` rewrites, inside and outside `[...]`:
  - `\\p{L}` and `\\p{N}` (the classes those patterns use) into the code
    points whose general category Python's `unicodedata` gives as a letter
    or a number;
  - `\\s` into Unicode's White_Space (25 code points) and `\\S` outside a
    class into its complement. `re`'s own `\\s` follows str.isspace(),
    which also takes U+001C..U+001F; `regex` and Oniguruma do not.
The ranges are built once per class and cached. Where Python's Unicode
version is older than that of `regex` or of `tokenizers`, the classes
differ on the code points it leaves unassigned (category Cn), and only
there.

Everything else that `re` would read otherwise than `regex` and Oniguruma
raises ValueError naming it: any other `\\p`/`\\P` form, `\\S` inside a
class, every escape of a letter that is not translated here and not the
same control character in all three (`\\w`, `\\d`, `\\b`, `\\A`, `\\h`,
…: `re`'s `\\w` follows str.isalnum(), for one), and a `[` or `&&` inside
a class (a POSIX bracket, a nested class or an intersection there). A
pattern that `re` still cannot compile raises ValueError too.
"""

from __future__ import annotations

import functools
import re
import sys
import unicodedata

WHITE_SPACE = (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
               0x2028, 0x2029, 0x202F, 0x205F, 0x3000)
CATEGORIES = ("L", "N")
# letters whose escape means the same character in re, regex and Oniguruma
# (\t \n \v \f \r \a and the \xHH / \uHHHH / \UHHHHHHHH code points)
SAME_ESCAPES = frozenset("tnvfraxuU")


def _ranges(cps) -> str:
    """Sorted code points → the body of a character class."""
    out, cps = [], sorted(cps)
    i = 0
    while i < len(cps):
        j = i
        while j + 1 < len(cps) and cps[j + 1] == cps[j] + 1:
            j += 1
        out.append(f"\\U{cps[i]:08x}" if i == j else f"\\U{cps[i]:08x}-\\U{cps[j]:08x}")
        i = j + 1
    return "".join(out)


@functools.cache
def category_body(cat: str) -> str:
    """The class body of a major class: every code point whose general
    category starts with `cat`."""
    if cat not in CATEGORIES:
        raise ValueError(f"unsupported Unicode property \\p{{{cat}}}; one of {CATEGORIES}")
    return _ranges(cp for cp in range(sys.maxunicode + 1)
                   if unicodedata.category(chr(cp)).startswith(cat))


@functools.cache
def _white_space() -> str:
    return _ranges(WHITE_SPACE)


def translate(pattern: str) -> str:
    """A `regex`-style pattern → the same pattern for `re`."""
    out, i, in_class, n = [], 0, False, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            if e == "P":
                raise ValueError(f"\\P is not supported (pattern {pattern!r})")
            if e == "p":
                if i + 2 < n and pattern[i + 2] == "{":
                    close = pattern.find("}", i + 3)
                    if close < 0:
                        raise ValueError(f"unterminated \\{e}{{ in {pattern!r}")
                    cat, i = pattern[i + 3:close], close + 1
                else:
                    cat, i = pattern[i + 2:i + 3], i + 3
                body = category_body(cat)
                out.append(body if in_class else f"[{body}]")
                continue
            if e in "sS":
                if e == "S" and in_class:
                    raise ValueError(f"\\S inside a class is not supported (pattern {pattern!r})")
                body = _white_space()
                out.append(body if in_class else (f"[{body}]" if e == "s" else f"[^{body}]"))
                i += 2
                continue
            if e.isascii() and e.isalpha() and e not in SAME_ESCAPES:
                raise ValueError(f"unsupported escape \\{e} (pattern {pattern!r}): re reads it "
                                 f"otherwise than regex and Oniguruma")
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if in_class and (c == "[" or pattern.startswith("&&", i)):
            what = "a POSIX bracket or nested class" if c == "[" else "a class intersection"
            raise ValueError(f"{what} at {i} is not supported (pattern {pattern!r})")
        if not in_class and c == "[":
            in_class = True
            out.append(c)
            i += 1
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < n and pattern[i] == "]":  # a leading ']' is a literal
                out.append("\\]")
                i += 1
            continue
        if in_class and c == "]":
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


@functools.cache
def compile(pattern: str) -> re.Pattern:
    """`re.compile(translate(pattern))`, cached; ValueError if `re` refuses
    it."""
    try:
        return re.compile(translate(pattern))
    except re.error as e:
        raise ValueError(f"unsupported pattern {pattern!r}: {e}") from None
