"""Tokenizer split patterns on the standard library's ``re``.

The patterns of byte-level BPE tokenizers (tiktoken's, and the ``Split``
pre-tokenizers of Llama-3's and Qwen2's ``tokenizer.json``) use Unicode
properties such as ``\\p{L}`` and ``\\p{N}``, which ``re`` does not take.
The reference compiles them with the ``regex`` package (tiktoken) or the
``tokenizers`` library's Oniguruma; the port takes neither, on the CPU
and on the card alike, and compiles every pattern through ``compile``
here, which rewrites each such escape into an explicit class of code-point
ranges built from ``unicodedata``:

- ``\\p{X}`` / ``\\pX`` for a general category (``Lu``) or a group of them
  (``L``), and its negation ``\\P{X}``, inside and outside brackets;
- ``\\s`` / ``\\S`` as the White_Space set that Oniguruma and ``regex``
  use (``re`` also counts U+001C-U+001F, which neither does);
- ``\\w`` / ``\\W`` as Unicode's word class (UTS #18: Alphabetic, marks,
  decimal digits, connector punctuation and the two joiners), which
  ``regex`` and the Rust ``regex`` crate behind the ``Whitespace``
  pre-tokenizer use; ``re`` counts ``str.isalnum`` characters (``²``
  among them) and no marks. Alphabetic is the letters, ``Nl`` and the
  four ``So`` blocks of circled and squared Latin letters.

Divergences that remain (tests/test_torch_tokenizer.py pins them): the
classes follow the Unicode version of this Python's ``unicodedata``, so a
code point assigned in a later version is unassigned here; and a ``Split``
pattern of a ``tokenizer.json`` runs on Oniguruma, whose ``\\w`` also
takes ``No`` (``²``) and not the joiners (no Llama-3, Qwen2 or Gemma-2
pattern uses ``\\w``).
"""

from __future__ import annotations

import functools
import re
import sys
import unicodedata

# Oniguruma's \s under Unicode (and regex's White_Space): U+0009-U+000D,
# U+0085 and the Zs, Zl and Zp categories.
_WS_EXTRA = [(0x09, 0x0D), (0x85, 0x85)]
# The word class beyond L, M, Nd, Nl and Pc: the joiners ZWNJ and ZWJ, and
# the Alphabetic So blocks (circled, squared, negative circled and
# negative squared Latin letters).
_WORD_EXTRA = [(0x200C, 0x200D), (0x24B6, 0x24E9), (0x1F130, 0x1F149),
               (0x1F150, 0x1F169), (0x1F170, 0x1F189)]


@functools.lru_cache(maxsize=None)
def _category_ranges() -> dict[str, tuple[tuple[int, int], ...]]:
    """General category -> sorted code-point ranges, over all of Unicode."""
    out: dict[str, list[list[int]]] = {}
    for cp in range(sys.maxunicode + 1):
        runs = out.setdefault(unicodedata.category(chr(cp)), [])
        if runs and runs[-1][1] == cp - 1:
            runs[-1][1] = cp
        else:
            runs.append([cp, cp])
    return {k: tuple(map(tuple, v)) for k, v in out.items()}


def _merge(ranges) -> tuple[tuple[int, int], ...]:
    out: list[list[int]] = []
    for a, b in sorted(ranges):
        if out and a <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return tuple(map(tuple, out))


def _complement(ranges) -> tuple[tuple[int, int], ...]:
    out, nxt = [], 0
    for a, b in ranges:
        if a > nxt:
            out.append((nxt, a - 1))
        nxt = b + 1
    if nxt <= sys.maxunicode:
        out.append((nxt, sys.maxunicode))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def property_ranges(name: str) -> tuple[tuple[int, int], ...]:
    """Code-point ranges of ``\\p{name}``: a general category (``Lu``) or
    a one-letter group (``L``), or the port's ``space`` and ``word``
    classes. Any other name raises ``ValueError``."""
    cats = _category_ranges()
    if name == "space":
        return _merge(list(_WS_EXTRA) + [r for c in ("Zs", "Zl", "Zp")
                                         for r in cats.get(c, ())])
    if name == "word":
        return _merge(list(_WORD_EXTRA) + [
            r for c, rs in cats.items()
            if c[0] in "LM" or c in ("Nd", "Nl", "Pc") for r in rs])
    if len(name) == 1 and name in "LMNPSZC":
        return _merge([r for c, rs in cats.items() if c[0] == name
                       for r in rs])
    if len(name) == 2 and name[0] in "LMNPSZC" and name in cats:
        return cats[name]
    raise ValueError(f"unsupported Unicode property \\p{{{name}}} in a "
                     "tokenizer pattern (general categories only)")


def _class_body(ranges) -> str:
    def esc(cp: int) -> str:
        return f"\\U{cp:08x}" if cp > 0xFFFF else f"\\u{cp:04x}"

    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}"
                   for a, b in ranges)


_SHORT = {"s": ("space", False), "S": ("space", True),
          "w": ("word", False), "W": ("word", True)}


def translate(pattern: str) -> str:
    """``pattern`` with every ``\\p``/``\\P``/``\\s``/``\\S``/``\\w``/
    ``\\W`` escape rewritten into explicit ranges (see the module's
    docstring); everything else is passed through as written."""
    out: list[str] = []
    i, n = 0, len(pattern)
    in_class = False
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            if e in "pP":
                if i + 2 < n and pattern[i + 2] == "{":
                    end = pattern.find("}", i + 3)
                    if end < 0:
                        raise ValueError(f"unterminated \\{e}{{ in pattern "
                                         f"{pattern!r}")
                    name, i = pattern[i + 3:end], end + 1
                else:
                    name, i = pattern[i + 2:i + 3], i + 3
                negate = e == "P"
                if name.startswith("^"):
                    name, negate = name[1:], not negate
            elif e in _SHORT:
                (name, negate), i = _SHORT[e], i + 2
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            ranges = property_ranges(name)
            if in_class:
                out.append(_class_body(_complement(ranges) if negate
                                       else ranges))
            else:
                out.append(("[^" if negate else "[") + _class_body(ranges)
                           + "]")
            continue
        if in_class:
            if c == "[":
                raise ValueError(f"nested character class in pattern "
                                 f"{pattern!r} is not supported")
            if c == "]":
                in_class = False
            out.append(c)
            i += 1
            continue
        if c == "[":
            in_class = True
            out.append(c)
            i += 1
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < n and pattern[i] == "]":      # a leading literal ]
                out.append("\\]")
                i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=64)
def compile(pattern: str, flags: int = 0) -> "re.Pattern[str]":
    """``re.compile(translate(pattern), flags)``."""
    return re.compile(translate(pattern), flags)
