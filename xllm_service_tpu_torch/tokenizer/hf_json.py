"""Hugging Face ``tokenizer.json`` on the standard library (the port of the
reference's ``HFTokenizer``, ``xllm_service_tpu/tokenizer/factory.py``,
which wraps the ``tokenizers`` library; the card's machine has no
``tokenizers``).

The pipeline is the library's: added tokens are split out of the raw text
(leftmost-longest), the rest is normalized, split again on normalized
added tokens, pre-tokenized into words, and each word goes through the
model. ``encode`` runs as the reference calls it, without the
post-processor's special tokens (``add_special_tokens=False``); ``decode``
maps ids to tokens (added tokens first), drops special ones when asked,
and runs the decoder chain.

Components, those of the published Llama-3, Qwen2 and Gemma-2 files:

- models: ``BPE`` (``byte_fallback``, ``ignore_merges``, ``unk_token`` and
  ``fuse_unk``, ``continuing_subword_prefix``, ``end_of_word_suffix``;
  merges by rank through a heap, the library's order) and ``WordLevel``;
- normalizers: ``Sequence``, ``Replace``, ``Prepend``, ``NFC``;
- pre-tokenizers: ``Sequence``, ``Split`` (``Isolated`` or ``Removed``),
  ``ByteLevel`` (with and without its regex), ``Whitespace``,
  ``Metaspace``;
- decoders: ``ByteLevel``, ``Replace``, ``ByteFallback``, ``Fuse``,
  ``Strip``, ``Metaspace``, ``Sequence``.

Regex patterns compile through ``unicode_re`` (the library runs them on
Oniguruma). Any other component, option or setting that would change the
ids (truncation, padding, BPE dropout, an added token's ``lstrip``,
``rstrip`` or ``single_word``) raises ``ValueError`` naming it: a
``tokenizer.json`` that exists is never passed over for another tokenizer.
"""

from __future__ import annotations

import heapq
import json
import re
import unicodedata
from pathlib import Path
from typing import Callable, Optional, Sequence, Union

from . import unicode_re
from .base import Tokenizer

# GPT-2's pre-split, the ByteLevel pre-tokenizer's own regex.
_BYTE_LEVEL_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                       r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
_WHITESPACE_PATTERN = r"\w+|[^\w\s]+"
_BPE_CACHE = 10_000    # words the BPE model remembers, as the library's


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte <-> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_TO_CHAR = _bytes_to_unicode()
CHAR_TO_BYTE = {c: b for b, c in BYTE_TO_CHAR.items()}


def _refuse(kind: str, spec) -> ValueError:
    what = spec.get("type") if isinstance(spec, dict) else spec
    return ValueError(f"tokenizer.json: {kind} {what!r} is not supported "
                      "by the port's reader")


def _pattern(spec: dict, kind: str) -> "re.Pattern[str]":
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        return unicode_re.compile(spec["Regex"])
    raise _refuse(f"{kind} pattern", spec)


# ------------------------------------------------------------- normalizers
def _normalizer(spec: Optional[dict]) -> Optional[Callable[[str], str]]:
    if spec is None:
        return None
    t = spec.get("type")
    if t == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]

        def seq(s: str) -> str:
            for f in steps:
                if f is not None:
                    s = f(s)
            return s
        return seq
    if t == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    if t == "Replace":
        pat, content = _pattern(spec["pattern"], "Replace"), spec["content"]
        return lambda s: pat.sub(lambda _m: content, s)
    if t == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    raise _refuse("normalizer", spec)


# ---------------------------------------------------------- pre-tokenizers
# A piece is (text, starts_at_the_input's_first_byte).
Pieces = list[tuple[str, bool]]


def _split(text: str, pat: "re.Pattern[str]", behavior: str) -> list[str]:
    out: list[str] = []
    last = 0
    for m in pat.finditer(text):
        if m.start() == m.end():
            continue
        if m.start() > last:
            out.append(text[last:m.start()])
        if behavior == "Isolated":
            out.append(m.group())
        last = m.end()
    if last < len(text):
        out.append(text[last:])
    return out


def _keep_matches(text: str, pat: "re.Pattern[str]") -> list[str]:
    return [m.group() for m in pat.finditer(text) if m.group()]


def _pre_tokenizer(spec: Optional[dict]
                   ) -> Optional[Callable[[Pieces], Pieces]]:
    if spec is None:
        return None
    t = spec.get("type")
    if t == "Sequence":
        steps = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(pieces: Pieces) -> Pieces:
            for f in steps:
                if f is not None:
                    pieces = f(pieces)
            return pieces
        return seq
    if t == "Split":
        behavior, invert = spec.get("behavior"), bool(spec.get("invert"))
        if behavior not in ("Isolated", "Removed"):
            raise _refuse("Split behavior", behavior)
        pat = _pattern(spec["pattern"], "Split")

        def split(pieces: Pieces) -> Pieces:
            out: Pieces = []
            for text, first in pieces:
                # Inverted, the matches are what is kept and the gaps are
                # the delimiters; Isolated keeps both either way.
                parts = (_keep_matches(text, pat) if invert
                         and behavior == "Removed" else
                         _split(text, pat, behavior))
                out.extend((p, first and i == 0 and text.startswith(p))
                           for i, p in enumerate(parts))
            return out
        return split
    if t == "Whitespace":
        pat = unicode_re.compile(_WHITESPACE_PATTERN)
        return lambda pieces: [(p, first and i == 0 and text.startswith(p))
                               for text, first in pieces
                               for i, p in enumerate(_keep_matches(text,
                                                                   pat))]
    if t == "ByteLevel":
        prefix = bool(spec.get("add_prefix_space"))
        pat = unicode_re.compile(_BYTE_LEVEL_PATTERN) \
            if spec.get("use_regex", True) else None

        def byte_level(pieces: Pieces) -> Pieces:
            out: Pieces = []
            for text, first in pieces:
                if prefix and not text.startswith(" "):
                    text = " " + text
                parts = _split(text, pat, "Isolated") if pat else [text]
                out.extend(("".join(BYTE_TO_CHAR[b]
                                    for b in p.encode("utf-8")),
                            first and i == 0) for i, p in enumerate(parts)
                           if p)
            return out
        return byte_level
    if t == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme", "always")
        if scheme not in ("always", "first", "never"):
            raise _refuse("Metaspace prepend_scheme", scheme)
        do_split = bool(spec.get("split", True))

        def metaspace(pieces: Pieces) -> Pieces:
            out: Pieces = []
            for text, first in pieces:
                text = text.replace(" ", rep)
                if not text.startswith(rep) and (
                        scheme == "always" or (scheme == "first" and first)):
                    text = rep + text
                parts = [text]
                if do_split:       # MergedWithNext on the replacement
                    parts = [p for p in re.split(
                        f"(?={re.escape(rep)})", text) if p]
                out.extend((p, first and i == 0)
                           for i, p in enumerate(parts))
            return out
        return metaspace
    raise _refuse("pre_tokenizer", spec)


# ------------------------------------------------------------------ models
class _BPE:
    def __init__(self, spec: dict):
        if spec.get("dropout") not in (None, 0, 0.0):
            raise _refuse("BPE dropout", spec.get("dropout"))
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.unk = spec.get("unk_token")
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.fuse_unk = bool(spec.get("fuse_unk"))
        self.byte_fallback = bool(spec.get("byte_fallback"))
        self.ignore_merges = bool(spec.get("ignore_merges"))
        # (left id, right id) -> (rank, merged id); a pair listed twice
        # keeps its last rank, as the library's map does.
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        cut = len(self.prefix)
        for rank, m in enumerate(spec.get("merges") or ()):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            try:
                self.merges[(self.vocab[a], self.vocab[b])] = (
                    rank, self.vocab[a + b[cut:]])
            except KeyError as e:
                raise ValueError(f"tokenizer.json: merge {a!r} {b!r} names "
                                 f"a token out of the vocabulary ({e})"
                                 ) from None
        self.id_to_tok = {v: k for k, v in self.vocab.items()}
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        hit = self._cache.get(word)
        if hit is None:
            hit = self._merge_word(word)
            if len(self._cache) >= _BPE_CACHE:
                self._cache.clear()
            self._cache[word] = hit
        return list(hit)

    def _merge_word(self, w: str) -> list[int]:
        ids: list[int] = []
        unk: Optional[int] = None
        last = len(w) - 1
        for i, ch in enumerate(w):
            s = (self.prefix if i else "") + ch + (self.suffix if i == last
                                                   else "")
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(tid)
                continue
            if self.byte_fallback:
                codes = [self.vocab.get(f"<0x{b:02X}>")
                         for b in s.encode("utf-8")]
                if all(c is not None for c in codes):
                    # A pending unk stays pending past byte tokens (the
                    # library adds it before the next vocabulary hit).
                    ids.extend(codes)
                    continue
            if self.unk is not None:
                unk_id = self.vocab.get(self.unk)
                if unk_id is None:
                    raise ValueError(f"tokenizer.json: unk_token "
                                     f"{self.unk!r} is not in the vocabulary")
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = unk_id
        if unk is not None:
            ids.append(unk)
        return self._merge_all(ids)

    def _merge_all(self, ids: list[int]) -> list[int]:
        """The library's ``Word::merge_all``: the lowest rank first (the
        leftmost among equals), stale entries skipped."""
        n = len(ids)
        if n < 2:
            return ids
        sym = list(ids)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = self.merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new_id:
                continue
            sym[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prev[nxt[pos]] = pos
            if prev[pos] >= 0:
                p = prev[pos]
                m = self.merges.get((sym[p], sym[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            if nxt[pos] < n:
                m = self.merges.get((sym[pos], sym[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(sym, alive) if a]


class _WordLevel:
    def __init__(self, spec: dict):
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.unk = spec.get("unk_token")
        self.id_to_tok = {v: k for k, v in self.vocab.items()}

    def tokenize(self, word: str) -> list[int]:
        tid = self.vocab.get(word)
        if tid is None:
            tid = self.vocab.get(self.unk) if self.unk is not None else None
            if tid is None:
                raise ValueError(f"WordLevel: {word!r} is not in the "
                                 f"vocabulary and unk_token {self.unk!r} "
                                 "is missing from it")
        return [tid]


def _model(spec: dict):
    t = spec.get("type")
    if t == "BPE":
        return _BPE(spec)
    if t == "WordLevel":
        return _WordLevel(spec)
    raise _refuse("model", spec)


# ---------------------------------------------------------------- decoders
def _byte_level_decode(tokens: list[str]) -> list[str]:
    data = bytearray()
    for t in tokens:
        try:
            data.extend(CHAR_TO_BYTE[c] for c in t)
        except KeyError:
            data.extend(t.encode("utf-8"))
    return [data.decode("utf-8", errors="replace")]


def _byte_fallback_decode(tokens: list[str]) -> list[str]:
    out: list[str] = []
    pending = bytearray()

    def flush():
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" * len(pending))
            pending.clear()

    for t in tokens:
        b = None
        if len(t.encode("utf-8")) == 6 and t.startswith("<0x") and \
                t.endswith(">"):
            try:
                b = int(t[3:5], 16)
            except ValueError:
                b = None
        if b is not None:
            pending.append(b)
        else:
            flush()
            out.append(t)
    flush()
    return out


def _strip(token: str, content: str, start: int, stop: int) -> str:
    lo = 0
    while lo < min(start, len(token)) and token[lo] == content:
        lo += 1
    hi, n = len(token), 0
    while n < stop and hi > lo and token[hi - 1] == content:
        hi -= 1
        n += 1
    return token[lo:hi]


def _decoder(spec: Optional[dict]
             ) -> Optional[Callable[[list[str]], list[str]]]:
    if spec is None:
        return None
    t = spec.get("type")
    if t == "Sequence":
        steps = [_decoder(s) for s in spec["decoders"]]

        def seq(tokens: list[str]) -> list[str]:
            for f in steps:
                if f is not None:
                    tokens = f(tokens)
            return tokens
        return seq
    if t == "ByteLevel":
        return _byte_level_decode
    if t == "ByteFallback":
        return _byte_fallback_decode
    if t == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if t == "Replace":
        pat, content = _pattern(spec["pattern"], "Replace"), spec["content"]
        return lambda tokens: [pat.sub(lambda _m: content, t_)
                               for t_ in tokens]
    if t == "Strip":
        c, a, b = spec["content"], int(spec["start"]), int(spec["stop"])
        return lambda tokens: [_strip(t_, c, a, b) for t_ in tokens]
    if t == "Metaspace":
        rep = spec.get("replacement", "▁")
        drop_first = spec.get("prepend_scheme", "always") != "never"
        return lambda tokens: [
            "".join(("" if i == 0 and drop_first else " ") if ch == rep
                    else ch for ch in tok) for i, tok in enumerate(tokens)]
    raise _refuse("decoder", spec)


# --------------------------------------------------------------- tokenizer
class HFTokenizer(Tokenizer):
    """A ``tokenizer.json`` read on the standard library."""

    def __init__(self, tokenizer_json: Union[str, Path]):
        spec = json.loads(Path(tokenizer_json).read_text(encoding="utf-8"))
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise ValueError(f"tokenizer.json: {key} is set; the port's "
                                 "reader takes none")
        self._model = _model(spec["model"])
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._decode = _decoder(spec.get("decoder"))
        self._added: dict[str, int] = {}
        self._added_by_id: dict[int, str] = {}
        self._special: set[str] = set()
        # A normalized added token is matched in the normalized text, by
        # its normalized content.
        self._normed: dict[str, int] = {}
        raw = []
        for tok in spec.get("added_tokens") or ():
            for opt in ("lstrip", "rstrip", "single_word"):
                if tok.get(opt):
                    raise ValueError(f"tokenizer.json: added token "
                                     f"{tok['content']!r} sets {opt}, which "
                                     "the port's reader does not take")
            content, tid = tok["content"], int(tok["id"])
            self._added[content] = tid
            self._added_by_id[tid] = content
            if tok.get("special"):
                self._special.add(content)
            if tok.get("normalized"):
                self._normed[self._normalize(content) if self._normalize
                             else content] = tid
            else:
                raw.append(content)
        self._split_raw = self._alternation(raw)
        self._split_normed = self._alternation(list(self._normed))

    @staticmethod
    def _alternation(tokens: list[str]) -> Optional["re.Pattern[str]"]:
        # Longest first: at the leftmost match, the longest token wins.
        tokens = [t for t in tokens if t]
        if not tokens:
            return None
        return re.compile("|".join(re.escape(t) for t in sorted(
            tokens, key=len, reverse=True)))

    @staticmethod
    def _cut(text: str, pat) -> list[tuple[str, bool]]:
        """``text`` cut around the matches of ``pat``: (piece, is_token)."""
        if pat is None:
            return [(text, False)] if text else []
        out, last = [], 0
        for m in pat.finditer(text):
            if m.start() > last:
                out.append((text[last:m.start()], False))
            out.append((m.group(), True))
            last = m.end()
        if last < len(text):
            out.append((text[last:], False))
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for n, (piece, is_tok) in enumerate(self._cut(text,
                                                      self._split_raw)):
            if is_tok:
                ids.append(self._added[piece])
                continue
            # Metaspace's "first" scheme: only the piece at offset 0.
            first = n == 0
            normed = self._normalize(piece) if self._normalize else piece
            for sub, sub_tok in self._cut(normed, self._split_normed):
                if sub_tok:
                    ids.append(self._normed[sub])
                    first = False
                    continue
                words = self._pre([(sub, first)]) if self._pre else \
                    [(sub, first)]
                first = False
                for word, _ in words:
                    ids.extend(self._model.tokenize(word))
        return ids

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            tok = self._added_by_id.get(int(i))
            if tok is None:
                tok = self._model.id_to_tok.get(int(i))
            if tok is None or (skip_special_tokens and tok in self._special):
                continue
            tokens.append(tok)
        if self._decode is None:
            return " ".join(tokens)
        return "".join(self._decode(tokens))

    def vocab_size(self) -> int:
        return len(set(self._model.vocab) | set(self._added))

    def id_to_token(self, token_id: int) -> Optional[str]:
        tok = self._added_by_id.get(token_id)
        return tok if tok is not None else self._model.id_to_tok.get(
            token_id)

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self._added.get(token)
        return tid if tid is not None else self._model.vocab.get(token)
