"""The port's tokenizers against the reference's and against the
``tokenizers`` library, on the CPU, with no download: every tokenizer is
built here from a seed.

- ``hf_json.HFTokenizer`` against ``tokenizers.Tokenizer`` (what the
  reference's ``HFTokenizer`` wraps) on hypothesis text (letters, marks,
  numbers, punctuation and symbols of all of Unicode, runs of spaces,
  tabs and newlines, special tokens inside the text): identical ids from
  ``encode`` (``add_special_tokens=False``, as the reference calls it) and
  identical strings from ``decode`` with and without special tokens, for
  byte-level BPEs trained here under Llama-3's split pattern with
  ``ignore_merges`` and under Qwen2's with ``NFC``, GPT-2's ``ByteLevel``
  with its own regex and a prefix space, a Gemma-style BPE (``▁`` replace,
  ``byte_fallback``, ``unk`` fused), a ``Metaspace`` BPE, a BPE with a
  continuing-subword prefix and an end-of-word suffix, and the reference's
  ``WordLevel`` serving fixture.
- ``tiktoken.TiktokenTokenizer`` against the reference's on a vocabulary
  built here (ranks of the Llama-3-style BPE), under Llama-3's pattern.
- ``unicode_re`` against the ``regex`` package on the split patterns, with
  the divergences that remain pinned.
- Unsupported components raise; the factory's selection order and
  ``args`` against the reference's.
"""

import base64
import dataclasses
import json
import re
import unicodedata

import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st
from tokenizers import AddedToken, Regex
from tokenizers import Tokenizer as LibTokenizer
from tokenizers import decoders, models, normalizers, pre_tokenizers, trainers

from xllm_service_tpu.tokenizer import args as ref_args
from xllm_service_tpu.tokenizer.factory import TokenizerFactory as RefFactory
from xllm_service_tpu.tokenizer.tiktoken import (
    TiktokenTokenizer as RefTiktoken,
)
from xllm_service_tpu_torch.tokenizer import (
    HFTokenizer,
    SimpleTokenizer,
    TiktokenTokenizer,
    TokenizerFactory,
    args,
    unicode_re,
)
from xllm_service_tpu_torch.tokenizer.hf_json import CHAR_TO_BYTE

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                  r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                  r"|\s+(?!\S)|\s+")
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                 r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)"
                 r"|\s+")
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
O200K_PATTERN = (r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*"
                 r"[\p{Ll}\p{Lm}\p{Lo}\p{M}]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
                 r"|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+"
                 r"[\p{Ll}\p{Lm}\p{Lo}\p{M}]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?"
                 r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+"
                 r"|\s+(?!\S)|\s+")
SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>"]
GEMMA_SPECIALS = ["<bos>", "<eos>", "<start_of_turn>", "<end_of_turn>"]
WS = [" ", "  ", "   ", "\n", "\n\n", "\t", " \n", "\r\n", " \t ", "\n  "]
HYP = settings(max_examples=150, deadline=None, derandomize=True)


def corpus(seed: int, n: int = 400) -> list[str]:
    """Lines of words in several scripts, numbers, punctuation and runs of
    whitespace, drawn from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alphabets = ["abcdefghijklmnopqrstuvwxyz", "ABCDEFGHIJKLMNOPQRSTUVWXYZ",
                 "àéîõüçñßøå", "абвгдежзиклмнопрст", "αβγδεζηθικλμ",
                 "的一是不了人我在有他这中大来上", "0123456789", "²³½٣४",
                 ".,;:!?'\"()-", "+=*/<>|&%$#@"]
    weights = np.asarray([30, 6, 3, 4, 3, 3, 6, 1, 5, 2], float)
    weights /= weights.sum()
    lines = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(3, 14))):
            a = alphabets[rng.choice(len(alphabets), p=weights)]
            parts.append("".join(rng.choice(list(a), size=int(
                rng.integers(1, 8)))))
            parts.append(WS[int(rng.integers(0, 3))] if rng.random() < 0.9
                         else WS[int(rng.integers(0, len(WS)))])
        lines.append("".join(parts))
    return lines


def _byte_level_bpe(pattern, normalizer=None, ignore_merges=False,
                    use_regex=False, prefix_space=False, seed=0):
    tok = LibTokenizer(models.BPE(ignore_merges=ignore_merges))
    if normalizer is not None:
        tok.normalizer = normalizer
    steps = [pre_tokenizers.ByteLevel(add_prefix_space=prefix_space,
                                      use_regex=use_regex)]
    if pattern is not None:
        steps.insert(0, pre_tokenizers.Split(Regex(pattern), "isolated"))
    tok.pre_tokenizer = pre_tokenizers.Sequence(steps)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(corpus(seed), trainers.BpeTrainer(
        vocab_size=900, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False))
    tok.add_special_tokens([AddedToken(s, special=True, normalized=False)
                            for s in SPECIALS])
    tok.add_tokens([AddedToken("<think>", normalized=False)])
    return tok


def _gemma_style(seed=3):
    """Gemma's layout: spaces replaced by ``▁``, no pre-tokenizer, a BPE
    with byte tokens for what its alphabet lacks, ``<unk>`` fused."""
    tok = LibTokenizer(models.BPE())
    tok.normalizer = normalizers.Replace(" ", "▁")
    tok.train_from_iterator(corpus(seed, 200), trainers.BpeTrainer(
        vocab_size=500, limit_alphabet=60, show_progress=False))
    spec = json.loads(tok.to_str())
    vocab = spec["model"]["vocab"]
    for b in range(256):
        vocab.setdefault(f"<0x{b:02X}>", len(vocab))
    vocab["<unk>"] = len(vocab)
    spec["model"].update(byte_fallback=True, fuse_unk=True,
                         unk_token="<unk>")
    spec["decoder"] = json.loads(decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(),
        decoders.Fuse()]).__getstate__())
    tok = LibTokenizer.from_str(json.dumps(spec))
    tok.add_special_tokens([AddedToken(s, special=True, normalized=False)
                            for s in GEMMA_SPECIALS])
    return tok


def _metaspace(seed=4):
    tok = LibTokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="first")
    tok.decoder = decoders.Metaspace(prepend_scheme="first")
    tok.train_from_iterator(corpus(seed, 200), trainers.BpeTrainer(
        vocab_size=500, limit_alphabet=50, special_tokens=["<unk>"],
        show_progress=False))
    tok.add_special_tokens([AddedToken("<s>", special=True,
                                       normalized=False)])
    return tok


def _subword(seed=5):
    tok = LibTokenizer(models.BPE(unk_token="[UNK]",
                                  continuing_subword_prefix="##",
                                  end_of_word_suffix="</w>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(corpus(seed, 200), trainers.BpeTrainer(
        vocab_size=600, limit_alphabet=70, special_tokens=["[UNK]"],
        continuing_subword_prefix="##", end_of_word_suffix="</w>",
        show_progress=False))
    return tok


def _wordlevel(tmp):
    """The reference's serving fixture (tests/test_hf_parity.py)."""
    from test_hf_parity import write_tokenizer

    write_tokenizer(tmp)
    return LibTokenizer.from_file(str(tmp / "tokenizer.json"))


BUILDERS = {
    "llama3": lambda d: _byte_level_bpe(LLAMA3_PATTERN, ignore_merges=True),
    "qwen2": lambda d: _byte_level_bpe(QWEN2_PATTERN, normalizers.NFC(),
                                       seed=1),
    "gpt2": lambda d: _byte_level_bpe(None, use_regex=True,
                                      prefix_space=True, seed=2),
    "gemma": lambda d: _gemma_style(),
    "metaspace": lambda d: _metaspace(),
    "subword": lambda d: _subword(),
    "wordlevel": _wordlevel,
}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """name -> (the library's tokenizer, the port's, on its saved file)."""
    out = {}
    for name, build in BUILDERS.items():
        d = tmp_path_factory.mktemp(name)
        lib = build(d)
        lib.save(str(d / "tokenizer.json"))
        out[name] = (lib, HFTokenizer(d / "tokenizer.json"), d)
    return out


def texts(specials=(), extra_ws=True):
    chars = st.characters(categories=["L", "M", "N", "P", "S", "Zs"])
    word = st.text(chars, min_size=1, max_size=8)
    ascii_word = st.text(st.characters(min_codepoint=33, max_codepoint=126),
                         min_size=1, max_size=8)
    pieces = [word, ascii_word, ascii_word, st.sampled_from(WS)]
    if specials:
        pieces.append(st.sampled_from(list(specials)))
    return st.lists(st.one_of(*pieces), max_size=24).map("".join)


ALL_SPECIALS = SPECIALS + GEMMA_SPECIALS + ["<think>", "<s>"]


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_encode_matches_tokenizers(pairs, name):
    lib, port, _ = pairs[name]

    @HYP
    @given(texts(ALL_SPECIALS))
    def check(text):
        assert port.encode(text) == lib.encode(
            text, add_special_tokens=False).ids

    check()


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_decode_matches_tokenizers(pairs, name):
    lib, port, _ = pairs[name]
    n = lib.get_vocab_size()

    @HYP
    @given(st.lists(st.integers(0, n + 2), max_size=30))
    def check(ids):
        for skip in (True, False):
            assert port.decode(ids, skip_special_tokens=skip) == \
                lib.decode(ids, skip_special_tokens=skip)

    check()
    # Round trips of encoded text decode alike too.
    for text in corpus(7, 20):
        ids = lib.encode(text, add_special_tokens=False).ids
        assert port.decode(ids) == lib.decode(ids)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_vocabulary_lookups_match_tokenizers(pairs, name):
    lib, port, _ = pairs[name]
    assert port.vocab_size() == lib.get_vocab_size()
    for i in range(lib.get_vocab_size() + 2):
        assert port.id_to_token(i) == lib.id_to_token(i)
    for tok in list(lib.get_vocab())[:300] + ["<|eot_id|>", "nope!"]:
        assert port.token_to_id(tok) == lib.token_to_id(tok)


def test_special_tokens_split_out_of_text(pairs):
    lib, port, _ = pairs["llama3"]
    text = "hi<|eot_id|>there<|begin_of_text|><think>x"
    ids = port.encode(text)
    assert ids == lib.encode(text, add_special_tokens=False).ids
    assert port.token_to_id("<|eot_id|>") in ids
    assert port.decode(ids) == "hithere<think>x"
    assert port.decode(ids, skip_special_tokens=False) == text


# --------------------------------------------------------------- tiktoken
@pytest.fixture(scope="module")
def tiktoken_pair(pairs, tmp_path_factory):
    """The Llama-3-style BPE's ranks as a tiktoken vocabulary, with its
    special tokens after them."""
    lib = pairs["llama3"][0]
    vocab = lib.get_vocab(with_added_tokens=False)
    d = tmp_path_factory.mktemp("tiktoken")
    lines = [f"{base64.b64encode(bytes(CHAR_TO_BYTE[c] for c in tok)).decode()}"
             f" {i}" for tok, i in sorted(vocab.items(), key=lambda kv: kv[1])]
    (d / "vocab.tiktoken").write_text("\n".join(lines))
    special = {s: len(vocab) + i for i, s in enumerate(SPECIALS)}
    kw = dict(pattern=LLAMA3_PATTERN, special_tokens=special,
              prefix_tokens=["<|begin_of_text|>"])
    return (RefTiktoken(d / "vocab.tiktoken", **kw),
            TiktokenTokenizer(d / "vocab.tiktoken", **kw))


def test_tiktoken_matches_the_reference(tiktoken_pair):
    ref, port = tiktoken_pair
    assert port.vocab_size() == ref.vocab_size()

    @HYP
    @given(texts(SPECIALS))
    def check(text):
        ids = port.encode(text)
        assert ids == ref.encode(text)
        for skip in (True, False):
            assert port.decode(ids, skip_special_tokens=skip) == \
                ref.decode(ids, skip_special_tokens=skip)

    check()


# ----------------------------------------------------- pattern translation
@pytest.mark.parametrize("pattern", [
    LLAMA3_PATTERN, QWEN2_PATTERN, GPT2_PATTERN, O200K_PATTERN,
    r"\w+|[^\w\s]+", r"\p{Lu}\p{Ll}*|\P{L}+", r"\pN+|\p{^N}", r"[\S]+",
    r"[\p{Nd}\p{Pc}]+|\W"])
def test_translation_matches_regex(pattern):
    mine, theirs = unicode_re.compile(pattern), regex.compile(pattern)

    @HYP
    @given(texts())
    def check(text):
        assert mine.findall(text) == theirs.findall(text)

    check()


def test_translation_divergences_are_pinned():
    """What the translation cannot avoid, and what it fixes."""
    # Fixed: `re`'s own \s takes U+001C-U+001F, its \w takes "²" and no
    # marks; the translation agrees with regex (and Oniguruma) there.
    for ch, cls in (("\x1c", r"\s"), ("²", r"\w"), ("\u0301", r"\w"),
                    ("²", r"\p{N}"), ("Ⅻ", r"\w"), ("\u200d", r"\w")):
        assert bool(unicode_re.compile(cls).fullmatch(ch)) == \
            bool(regex.fullmatch(cls, ch)), (ch, cls)
    assert re.fullmatch(r"\s", "\x1c") and re.fullmatch(r"\w", "²")
    # Divergence 1: code points assigned after this Python's Unicode
    # version are unassigned here (U+2EBF0, CJK Extension I, Unicode 15.1).
    late = "\U0002ebf0"
    assert unicodedata.unidata_version == "15.0.0"
    assert regex.fullmatch(r"\p{L}", late)
    assert not unicode_re.compile(r"\p{L}").fullmatch(late)
    # Divergence 2: a tokenizer.json Split pattern runs on Oniguruma, whose
    # \w takes No ("²") and not the joiners; the port's is Unicode's.
    split = pre_tokenizers.Split(Regex(r"\w+"), "isolated")
    assert [p for p, _ in split.pre_tokenize_str("x²y")] == ["x²y"]
    assert unicode_re.compile(r"\w+").findall("x²y") == ["x", "y"]
    # No Llama-3, Qwen2 or GPT-2 pattern uses \w; "²" is a number there on
    # both sides.
    split = pre_tokenizers.Split(Regex(LLAMA3_PATTERN), "isolated")
    assert [p for p, _ in split.pre_tokenize_str("a ²³ b")] == \
        unicode_re.compile(LLAMA3_PATTERN).findall("a ²³ b")


def test_unsupported_properties_raise():
    with pytest.raises(ValueError, match=r"\\p\{Han\}"):
        unicode_re.compile(r"\p{Han}+")
    with pytest.raises(ValueError, match="nested"):
        unicode_re.compile(r"[a[b]]")


# ------------------------------------------------------------ refusals
def _edit(spec: dict, what: str) -> dict:
    spec = json.loads(json.dumps(spec))
    if what == "NFKC":
        spec["normalizer"] = {"type": "NFKC"}
    elif what == "Digits":
        spec["pre_tokenizer"] = {"type": "Digits", "individual_digits": True}
    elif what == "WordPiece":
        spec["decoder"] = {"type": "WordPiece", "prefix": "##",
                           "cleanup": True}
    elif what == "Unigram":
        spec["model"] = {"type": "Unigram", "unk_id": 0,
                         "vocab": [["a", 0.0]], "byte_fallback": False}
    elif what == "truncation":
        spec["truncation"] = {"direction": "Right", "max_length": 8,
                              "strategy": "LongestFirst", "stride": 0}
    elif what == "lstrip":
        spec["added_tokens"][0]["lstrip"] = True
    elif what == "MergedWithPrevious":
        spec["pre_tokenizer"]["pretokenizers"][0]["behavior"] = what
    elif what == "dropout":
        spec["model"]["dropout"] = 0.1
    return spec


@pytest.mark.parametrize("what", ["NFKC", "Digits", "WordPiece", "Unigram",
                                  "truncation", "lstrip",
                                  "MergedWithPrevious", "dropout"])
def test_unsupported_components_raise(pairs, tmp_path, what):
    spec = json.loads(pairs["llama3"][0].to_str())
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(_edit(spec, what)))
    with pytest.raises(ValueError, match=what):
        HFTokenizer(path)
    # The factory never passes over a tokenizer.json it cannot read.
    with pytest.raises(ValueError, match=what):
        TokenizerFactory.create_tokenizer(str(tmp_path))


# ------------------------------------------------------------ the factory
def _tiktoken_dir(d, name="m.tiktoken"):
    vocab = {b"a": 0, b"b": 1, b"c": 2, b" ": 5, b"ab": 3, b"abc": 4,
             b"ab ": 6}
    (d / name).write_text("\n".join(
        f"{base64.b64encode(k).decode()} {v}" for k, v in vocab.items()))


@pytest.mark.parametrize("layout", ["tokenizer.json dir",
                                    "tokenizer.json file", "tiktoken dir",
                                    "tiktoken by config", "sentencepiece",
                                    "empty dir", "no path"])
def test_factory_selection_order(pairs, tmp_path, layout):
    """The port's factory picks what the reference's picks, and the two
    tokenizers encode alike."""
    path = str(tmp_path)
    if layout.startswith("tokenizer.json"):
        pairs["wordlevel"][0].save(str(tmp_path / "tokenizer.json"))
        _tiktoken_dir(tmp_path)          # tokenizer.json comes first
        if layout.endswith("file"):
            path = str(tmp_path / "tokenizer.json")
    elif layout == "tiktoken dir":
        _tiktoken_dir(tmp_path)
    elif layout == "tiktoken by config":
        # The named vocabulary, not the first *.tiktoken, and the pattern.
        _tiktoken_dir(tmp_path, "z.tiktoken")
        (tmp_path / "a.tiktoken").write_text(
            base64.b64encode(b"a").decode() + " 0")
        (tmp_path / "tokenizer_config.json").write_text(json.dumps({
            "tokenizer_type": "tiktoken", "vocab_file": "z.tiktoken",
            "pattern": r"\p{L}+|\s+"}))
    elif layout == "sentencepiece":
        (tmp_path / "tokenizer.model").write_bytes(b"\x00")
    elif layout == "no path":
        path = ""
    ref = RefFactory.create_tokenizer(path)
    port = TokenizerFactory.create_tokenizer(path)
    kinds = {"HFTokenizer": "hf", "TiktokenTokenizer": "tiktoken",
             "SimpleTokenizer": "simple"}
    assert kinds[type(port).__name__] == kinds[type(ref).__name__]
    assert type(port).__name__ == {
        "tokenizer.json dir": "HFTokenizer",
        "tokenizer.json file": "HFTokenizer",
        "tiktoken dir": "TiktokenTokenizer",
        "tiktoken by config": "TiktokenTokenizer",
        "sentencepiece": "SimpleTokenizer",    # no sentencepiece package
        "empty dir": "SimpleTokenizer", "no path": "SimpleTokenizer"}[layout]
    for text in ("the capital of france is paris", "ab ab abc", "héllo"):
        assert port.encode(text) == ref.encode(text)


def test_sentencepiece_matches_the_reference(tmp_path):
    """The port's copy against the reference's on a model trained here,
    with special tokens and a prefix from args. Both need the
    ``sentencepiece`` package, which neither this machine nor the card's
    has: the factory then falls through to the byte tokenizer (above)."""
    spm = pytest.importorskip(
        "sentencepiece", reason="the sentencepiece package is not installed "
                                "(nor on the card's machine)")
    from xllm_service_tpu.tokenizer.sentencepiece_tok import (
        SentencePieceTokenizer as RefSentencePiece,
    )
    from xllm_service_tpu_torch.tokenizer.sentencepiece_tok import (
        SentencePieceTokenizer,
    )

    (tmp_path / "corpus.txt").write_text("\n".join(corpus(8, 300)))
    spm.SentencePieceTrainer.train(input=str(tmp_path / "corpus.txt"),
                                   model_prefix=str(tmp_path / "sp"),
                                   vocab_size=300)
    _write_cfg(tmp_path, added_tokens_decoder={
        "300": {"content": "<|eot|>"}})
    a = args.load_tokenizer_args(tmp_path)
    ref = RefSentencePiece(tmp_path / "sp.model", args=a)
    port = SentencePieceTokenizer(tmp_path / "sp.model", args=a)
    for text in corpus(9, 30) + ["x<|eot|>y"]:
        ids = port.encode(text)
        assert ids == ref.encode(text)
        for skip in (True, False):
            assert port.decode(ids, skip) == ref.decode(ids, skip)
    assert port.vocab_size() == ref.vocab_size()


# ------------------------------------------------------------------- args
def _write_cfg(d, **extra):
    cfg = {"add_bos_token": True, "bos_token": {"content": "<s>"},
           "eos_token": "</s>", "pad_token": "<pad>",
           "tokenizer_class": "TikTokenTokenizer",
           "chat_template": "CFG-TEMPLATE", **extra}
    (d / "tokenizer_config.json").write_text(json.dumps(cfg))


IMPLS = {"reference": (ref_args, RefFactory),
         "port": (args, TokenizerFactory)}


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_args_loaded_from_config(tmp_path, impl):
    _, factory = IMPLS[impl]
    _write_cfg(tmp_path, added_tokens_decoder={
        "100": {"content": "<|eot|>"}, "101": {"content": "<|pad|>"}})
    a = factory.load_args(str(tmp_path))
    assert a.add_bos_token is True and a.bos_token == "<s>"
    assert a.eos_token == "</s>" and a.pad_token == "<pad>"
    assert a.tokenizer_class == "TikTokenTokenizer"
    assert ("<|eot|>", 100) in a.special_tokens
    assert a.chat_template == "CFG-TEMPLATE"


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_chat_template_file_takes_priority(tmp_path, impl):
    _, factory = IMPLS[impl]
    _write_cfg(tmp_path)
    (tmp_path / "chat_template.json").write_text(
        json.dumps({"chat_template": "FILE-TEMPLATE"}))
    assert factory.load_args(str(tmp_path)).chat_template == "FILE-TEMPLATE"
    assert factory.load_chat_template(str(tmp_path)) == "FILE-TEMPLATE"
    (tmp_path / "chat_template.json").unlink()
    (tmp_path / "chat_template.jinja").write_text("JINJA")
    assert factory.load_chat_template(str(tmp_path)) == "JINJA"
    assert factory.load_chat_template("") is None


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_tiktoken_with_pattern_specials_and_prefix(tmp_path, impl):
    _, factory = IMPLS[impl]
    _tiktoken_dir(tmp_path)
    _write_cfg(tmp_path, tokenizer_type="tiktoken", pattern=r"\p{L}+|\s+",
               prefix_tokens=["<|bos|>"],
               added_tokens_decoder={"100": {"content": "<|eot|>"},
                                     "101": {"content": "<|bos|>"}})
    tok = factory.create_tokenizer(str(tmp_path))
    assert tok.encode("ab ab") == [101, 3, 5, 3]
    assert tok.encode("ab<|eot|>c") == [101, 3, 100, 2]
    plain = type(tok)(tmp_path / "m.tiktoken")
    assert plain.encode("ab ab") == [6, 3]
    x = type(tok)(tmp_path / "m.tiktoken", special_tokens={"<|x|>": -1})
    assert x.token_to_id("<|x|>") == 7 and x.vocab_size() == 8


@pytest.mark.parametrize("model_type", ["llama", "gemma2"])
def test_args_equal_the_reference_on_model_directories(tmp_path,
                                                       model_type):
    from test_checkpoint_serving import TEMPLATE
    from test_checkpoint_serving import make_model_dir as serving_dir
    from test_hf_parity import make_model_dir

    from xllm_service_tpu.models.base import tiny_config

    (tmp_path / "parity").mkdir()
    (tmp_path / "serving").mkdir()
    d = make_model_dir(tmp_path / "parity", model_type)
    s = serving_dir(tmp_path / "serving", tiny_config())
    for path in (d, s):
        assert dataclasses.asdict(args.load_tokenizer_args(path)) == \
            dataclasses.asdict(ref_args.load_tokenizer_args(path))
    assert TokenizerFactory.load_chat_template(str(s)) == TEMPLATE
    assert isinstance(TokenizerFactory.create_tokenizer(str(s)),
                      HFTokenizer)
    assert isinstance(TokenizerFactory.create_tokenizer(""),
                      SimpleTokenizer)
