"""A HuggingFace ``tokenizer.json`` reader in the standard library.

The reference's ``HFTokenizer`` (dynamo_tpu/frontend/tokenizer.py) wraps
``transformers.AutoTokenizer``, which runs the Rust ``tokenizers`` library.
The port imports neither, so this module reads the same files and
computes the same function:

- ``encode(text)`` is the reference's ``encode(text,
  add_special_tokens=False)``: the added-vocabulary split (special-token
  text becomes its id), the normalizer on each remaining piece, the
  pre-tokenizer, and the BPE model; no post-processor.
- ``decode(ids)`` is ``decode(ids, skip_special_tokens=True)``: special
  added tokens are skipped, ids outside the vocabulary decode to nothing,
  invalid UTF-8 decodes lossily, and transformers' clean-up of spaces
  runs when ``tokenizer_config.json`` asks for it.
- ``apply_chat_template`` renders as transformers does
  (frontend/chat_template.py).

What it reads: the BPE model (vocab and merges in rank order, in either
JSON form; ``ignore_merges``; ``byte_fallback``, ``unk_token`` and
``fuse_unk``), the
normalizers NFC / NFD / NFKC / NFKD / Prepend / Replace / Sequence, the
pre-tokenizers Split / ByteLevel / Metaspace / Digits / Sequence, and the
decoders ByteLevel / Metaspace / Replace / ByteFallback / Fuse / Strip /
Sequence. Any other component type, a BPE ``dropout`` or subword affix, or a directory
with only a SentencePiece ``tokenizer.model`` raises NotImplementedError
naming it: nothing is encoded with a part left out. Regex patterns go
through frontend/unicode_regex.py (Oniguruma's ``\\p{..}`` / ``\\s`` in
Python's ``re``).
"""

from __future__ import annotations

import heapq
import json
import os
import re
import unicodedata
from typing import Any, Callable, Sequence

from dynamo_tpu_torch.frontend.chat_template import ChatTemplate
from dynamo_tpu_torch.frontend.unicode_regex import WHITE_SPACE, compile_pattern

__all__ = ["HFTokenizer", "has_tokenizer_files"]

TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model")

# GPT-2's pre-tokenizer pattern (ByteLevel with use_regex)
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
                r"|\s+(?!\S)|\s+")
# the special-token attributes transformers keeps, in its order
SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "sep_token",
                 "pad_token", "cls_token", "mask_token")
# special tokens a tokenizer class supplies when tokenizer_config.json names
# none (the defaults of its transformers __init__)
_CLASS_DEFAULTS = {
    "LlamaTokenizer": {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>"},
    "Qwen2Tokenizer": {"eos_token": "<|endoftext|>", "unk_token": "<|endoftext|>",
                       "pad_token": "<|endoftext|>"},
    "GPT2Tokenizer": {"bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
                      "unk_token": "<|endoftext|>"},
}
# Unicode White_Space: Rust's char::is_whitespace
_WHITE_SPACE = frozenset(chr(c) for lo, hi in WHITE_SPACE for c in range(lo, hi + 1))


def has_tokenizer_files(path: str) -> bool:
    return any(os.path.exists(os.path.join(path, f)) for f in TOKENIZER_FILES)


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte -> printable character table (ByteLevel)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_CHAR = _bytes_to_unicode()
CHAR_BYTE = {c: b for b, c in BYTE_CHAR.items()}


def _refuse(kind: str, spec: Any) -> NotImplementedError:
    name = spec.get("type") if isinstance(spec, dict) else spec
    return NotImplementedError(
        f"tokenizer {kind} {name!r} is not read by the port's tokenizer "
        "(frontend/hf_tokenizer.py): it refuses rather than encode without it")


# -- patterns -----------------------------------------------------------------

class _Pattern:
    """A Split / Replace pattern: ``{"String": s}`` or ``{"Regex": r}``."""

    def __init__(self, spec: dict | str):
        if isinstance(spec, str):
            self.regex = re.compile(re.escape(spec)) if spec else None
        elif "String" in spec:
            s = spec["String"]
            self.regex = re.compile(re.escape(s)) if s else None
        elif "Regex" in spec:
            self.regex = compile_pattern(spec["Regex"])
        else:
            raise _refuse("pattern", str(spec))

    def find_matches(self, text: str) -> list[tuple[int, int, bool]]:
        """Every span of ``text`` in order, each flagged as a match or not
        (the library's Pattern::find_matches)."""
        if not text:
            return [(0, 0, False)]
        if self.regex is None:
            return [(0, len(text), False)]
        out, prev = [], 0
        for m in self.regex.finditer(text):
            s, e = m.span()
            if prev != s:
                out.append((prev, s, False))
            out.append((s, e, True))
            prev = e
        if prev != len(text):
            out.append((prev, len(text), False))
        return out

    def replace(self, text: str, content: str) -> str:
        if self.regex is None:
            return text
        return self.regex.sub(lambda _m: content, text)


def _split(spans: list[tuple[int, int, bool]], behavior: str) -> list[tuple[int, int]]:
    """NormalizedString::split: the kept spans for a delimiter behavior."""
    if behavior == "Isolated":
        return [(s, e) for s, e, _ in spans]
    if behavior == "Removed":
        return [(s, e) for s, e, m in spans if not m]
    out: list[list[int]] = []
    prev = False
    if behavior == "Contiguous":
        for s, e, m in spans:
            if m == prev and out:
                out[-1][1] = e
            else:
                out.append([s, e])
            prev = m
    elif behavior == "MergedWithPrevious":
        for s, e, m in spans:
            if m and not prev and out:
                out[-1][1] = e
            else:
                out.append([s, e])
            prev = m
    elif behavior == "MergedWithNext":
        for s, e, m in reversed(spans):
            if m and not prev and out:
                out[-1][0] = s
            else:
                out.append([s, e])
            prev = m
        out.reverse()
    else:
        raise _refuse("split behavior", behavior)
    return [(s, e) for s, e in out]


# -- normalizers ----------------------------------------------------------------

def _normalizer(spec: dict | None) -> Callable[[str], str] | None:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s, form=kind: unicodedata.normalize(form, s)
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        pat, content = _Pattern(spec["pattern"]), spec["content"]
        return lambda s: pat.replace(s, content)
    if kind == "Sequence":
        parts = [_normalizer(n) for n in spec["normalizers"]]
        parts = [p for p in parts if p is not None]

        def seq(s: str) -> str:
            for p in parts:
                s = p(s)
            return s
        return seq
    raise _refuse("normalizer", spec)


# -- pre-tokenizers --------------------------------------------------------------
# A piece is (text, original start): the start tells Metaspace's "first"
# scheme whether the piece opens the input.

Piece = tuple[str, int]


def _is_numeric(c: str) -> bool:  # Rust char::is_numeric: Nd, Nl, No
    return unicodedata.category(c) in ("Nd", "Nl", "No")


def _pre_tokenizer(spec: dict | None) -> Callable[[list[Piece]], list[Piece]] | None:
    if spec is None:
        return None
    kind = spec.get("type")

    def each(fn: Callable[[str], list[tuple[int, int]] | str]):
        def run(pieces: list[Piece]) -> list[Piece]:
            out: list[Piece] = []
            for text, start in pieces:
                for s, e in fn(text):
                    if e > s:
                        out.append((text[s:e], start + s))
            return out
        return run

    if kind == "Split":
        pat, behavior = _Pattern(spec["pattern"]), spec["behavior"]
        invert = spec.get("invert", False)

        def split(text: str) -> list[tuple[int, int]]:
            spans = pat.find_matches(text)
            if invert:
                spans = [(s, e, not m) for s, e, m in spans]
            return _split(spans, behavior)
        return each(split)
    if kind == "ByteLevel":
        prefix = spec.get("add_prefix_space", True)
        regex = _Pattern({"Regex": GPT2_PATTERN}) if spec.get("use_regex", True) else None

        def byte_level(pieces: list[Piece]) -> list[Piece]:
            out: list[Piece] = []
            for text, start in pieces:
                if prefix and not text.startswith(" "):
                    text = " " + text
                spans = (_split(regex.find_matches(text), "Isolated") if regex
                         else [(0, len(text))])
                out.extend((text[s:e], start + s) for s, e in spans if e > s)
            return [("".join(map(BYTE_CHAR.__getitem__, t.encode("utf-8"))), st)
                    for t, st in out]
        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:  # the format before prepend_scheme
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        do_split = spec.get("split", True)
        delim = _Pattern({"String": rep})

        def metaspace(pieces: list[Piece]) -> list[Piece]:
            out: list[Piece] = []
            for text, start in pieces:
                text = text.replace(" ", rep)
                if not text.startswith(rep) and (
                        scheme == "always" or (scheme == "first" and start == 0)):
                    text = rep + text
                spans = (_split(delim.find_matches(text), "MergedWithNext")
                         if do_split else [(0, len(text))])
                out.extend((text[s:e], start + s) for s, e in spans if e > s)
            return out
        return metaspace
    if kind == "Digits":
        behavior = "Isolated" if spec.get("individual_digits", False) else "Contiguous"

        def digits(text: str) -> list[tuple[int, int]]:
            spans: list[tuple[int, int, bool]] = []
            last = 0
            for i, c in enumerate(text):
                if _is_numeric(c):
                    if last < i:
                        spans.append((last, i, False))
                    spans.append((i, i + 1, True))
                    last = i + 1
            if last < len(text):
                spans.append((last, len(text), False))
            return _split(spans, behavior)
        return each(digits)
    if kind == "Sequence":
        parts = [_pre_tokenizer(p) for p in spec["pretokenizers"]]
        parts = [p for p in parts if p is not None]

        def seq(pieces: list[Piece]) -> list[Piece]:
            for p in parts:
                pieces = p(pieces)
            return pieces
        return seq
    raise _refuse("pre-tokenizer", spec)


# -- decoders ----------------------------------------------------------------------
# Each maps a list of token strings to a list of strings (the library's
# decode_chain); decode joins the last list.

def _lossy(data: bytes) -> str:
    return data.decode("utf-8", errors="replace")


def _decoder(spec: dict | None) -> Callable[[list[str]], list[str]] | None:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "ByteLevel":
        def byte_level(tokens: list[str]) -> list[str]:
            data = bytearray()
            for t in tokens:
                try:
                    raw = bytes(CHAR_BYTE[c] for c in t)
                except KeyError:  # a token outside the byte alphabet: raw
                    raw = t.encode("utf-8")
                data.extend(raw)
            return [_lossy(bytes(data))]
        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"

        def metaspace(tokens: list[str]) -> list[str]:
            return [t.replace(rep, "" if i == 0 and scheme != "never" else " ")
                    for i, t in enumerate(tokens)]
        return metaspace
    if kind == "Replace":
        pat, content = _Pattern(spec["pattern"]), spec["content"]
        return lambda tokens: [pat.replace(t, content) for t in tokens]
    if kind == "ByteFallback":
        def byte_fallback(tokens: list[str]) -> list[str]:
            out: list[str] = []
            pending = bytearray()

            def flush() -> None:
                try:
                    out.append(bytes(pending).decode("utf-8"))
                except UnicodeDecodeError:
                    out.extend("�" for _ in pending)
                pending.clear()

            for t in tokens:
                b = _fallback_byte(t)
                if b is not None:
                    pending.append(b)
                    continue
                if pending:
                    flush()
                out.append(t)
            if pending:
                flush()
            return out
        return byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        ch, start, stop = spec["content"], spec["start"], spec["stop"]

        def strip(tokens: list[str]) -> list[str]:
            out = []
            for t in tokens:
                lo = 0
                while lo < min(start, len(t)) and t[lo] == ch:
                    lo += 1
                hi = len(t)
                for _ in range(stop):
                    if hi > lo and t[hi - 1] == ch:
                        hi -= 1
                    else:
                        break
                out.append(t[lo:hi])
            return out
        return strip
    if kind == "Sequence":
        parts = [_decoder(d) for d in spec["decoders"]]
        parts = [p for p in parts if p is not None]

        def seq(tokens: list[str]) -> list[str]:
            for p in parts:
                tokens = p(tokens)
            return tokens
        return seq
    raise _refuse("decoder", spec)


def _fallback_byte(token: str) -> int | None:
    """The byte of a ``<0xHH>`` byte-fallback token, else None."""
    if len(token) == 6 and token.startswith("<0x") and token.endswith(">"):
        try:
            return int(token[3:5], 16)
        except ValueError:
            return None
    return None


# -- the BPE model -----------------------------------------------------------------

class _BPE:
    CACHE_ENTRIES = 10_000

    def __init__(self, spec: dict):
        if spec.get("dropout") not in (None, 0, 0.0):
            raise NotImplementedError(
                f"BPE dropout {spec['dropout']!r}: the port's tokenizer encodes "
                "deterministically only")
        self.vocab: dict[str, int] = spec["vocab"]
        self.vocab_r = {i: t for t, i in self.vocab.items()}
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise NotImplementedError(
                    f"BPE {key} {spec[key]!r} is not read by the port's tokenizer")
        vocab = self.vocab
        merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", ())):
            if isinstance(m, str):
                parts = m.split(" ")
                if len(parts) != 2:
                    raise ValueError(f"merge {m!r} is not two tokens")
                a, b = parts
            else:
                a, b = m
            try:
                merges[vocab[a], vocab[b]] = (rank, vocab[a + b])
            except KeyError as e:
                raise ValueError(f"merge ({a!r}, {b!r}) names {e} outside the vocab") from None
        self.merges = merges
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, seq: str) -> list[int]:
        if not seq:
            return []
        if self.ignore_merges:
            i = self.vocab.get(seq)
            if i is not None:
                return [i]
        hit = self._cache.get(seq)
        if hit is not None:
            return hit
        ids = self._merge_all(self._symbols(seq))
        if len(self._cache) < self.CACHE_ENTRIES:
            self._cache[seq] = ids
        return ids

    def _symbols(self, word: str) -> list[int]:
        """One id per character (byte-fallback ids or unk where the
        character is not in the vocab), before any merge."""
        vocab, ids = self.vocab, []
        unk: int | None = None
        for s in word:
            i = vocab.get(s)
            if i is not None:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(i)
                continue
            if self.byte_fallback:
                fb = [vocab.get(f"<0x{b:02X}>") for b in s.encode("utf-8")]
                if None not in fb:
                    ids.extend(fb)
                    continue
            if self.unk_token is not None:
                unk_id = vocab.get(self.unk_token)
                if unk_id is None:
                    raise ValueError(f"unk token {self.unk_token!r} is not in the vocab")
                if unk is None:
                    unk = unk_id
                elif not self.fuse_unk:
                    ids.append(unk)
                    unk = unk_id
        if unk is not None:
            ids.append(unk)
        return ids

    def _merge_all(self, sym: list[int]) -> list[int]:
        """Apply merges lowest rank first, leftmost first among equal
        ranks (the library's Word::merge_all)."""
        n = len(sym)
        if n < 2:
            return sym
        merges = self.merges
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for p in range(n - 1):
            m = merges.get((sym[p], sym[p + 1]))
            if m is not None:
                heap.append((m[0], p, m[1]))
        heapq.heapify(heap)
        while heap:
            _rank, p, new = heapq.heappop(heap)
            if not alive[p]:
                continue
            q = nxt[p]
            if q < 0:
                continue
            m = merges.get((sym[p], sym[q]))
            if m is None or m[1] != new:
                continue  # a stale entry
            sym[p] = new
            alive[q] = False
            nq = nxt[q]
            nxt[p] = nq
            if nq >= 0:
                prv[nq] = p
            pp = prv[p]
            if pp >= 0:
                m = merges.get((sym[pp], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], pp, m[1]))
            if nq >= 0:
                m = merges.get((new, sym[nq]))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
        return [s for s, a in zip(sym, alive) if a]


# -- the added vocabulary --------------------------------------------------------------

class _Added:
    __slots__ = ("id", "content", "special", "single_word", "lstrip", "rstrip",
                 "normalized")

    def __init__(self, id: int, content: str, *, special: bool = False,
                 single_word: bool = False, lstrip: bool = False,
                 rstrip: bool = False, normalized: bool | None = None):
        self.id, self.content, self.special = id, content, special
        self.single_word, self.lstrip, self.rstrip = single_word, lstrip, rstrip
        self.normalized = (not special) if normalized is None else normalized

    @classmethod
    def from_dict(cls, id: int, d: dict) -> "_Added":
        return cls(id, d["content"], special=d.get("special", False),
                   single_word=d.get("single_word", False),
                   lstrip=d.get("lstrip", False), rstrip=d.get("rstrip", False),
                   normalized=d.get("normalized"))

    def flags(self) -> tuple:
        return (self.content, self.special, self.single_word, self.lstrip,
                self.rstrip, self.normalized)


def _alnum(c: str) -> bool:
    # Rust's char::is_alphanumeric (Alphabetic or Numeric); str.isalnum
    # differs only on Other_Alphabetic marks, which a single_word added
    # token's neighbours rarely are
    return c.isalnum() or _is_numeric(c)


class TokenizerModel:
    """The ``tokenizer.json`` pipeline: added vocabulary, normalizer,
    pre-tokenizer, BPE model and decoder."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        if model.get("type", "BPE" if "merges" in model else None) != "BPE":
            raise _refuse("model", model)
        self.model = _BPE(model)
        self.normalizer = _normalizer(spec.get("normalizer"))
        self.pre_tokenizer_spec = spec.get("pre_tokenizer")
        self.pre_tokenizer = _pre_tokenizer(self.pre_tokenizer_spec)
        self.decoder = _decoder(spec.get("decoder"))
        self.added: dict[str, _Added] = {}
        self.added_r: dict[int, _Added] = {}
        for d in spec.get("added_tokens") or ():
            tok = _Added.from_dict(d["id"], d)
            self.added[tok.content] = tok
            self.added_r[tok.id] = tok
        self._refresh()

    @property
    def vocab_size(self) -> int:
        """The model's vocabulary without added tokens."""
        return len(self.model.vocab)

    def set_byte_level_prefix(self, add_prefix_space: bool) -> None:
        spec = dict(self.pre_tokenizer_spec, add_prefix_space=add_prefix_space)
        self.pre_tokenizer_spec = spec
        self.pre_tokenizer = _pre_tokenizer(spec)

    def token_to_id(self, token: str) -> int | None:
        tok = self.added.get(token)
        return tok.id if tok is not None else self.model.vocab.get(token)

    def id_to_token(self, i: int) -> str | None:
        tok = self.added_r.get(i)
        return tok.content if tok is not None else self.model.vocab_r.get(i)

    def add_token(self, tok: _Added) -> None:
        """Add or update one added token (the library's add_tokens): it
        keeps its vocab id if it has one, else takes the next free id."""
        old = self.added.get(tok.content)
        if old is not None and old.flags() == tok.flags():
            return
        i = self.token_to_id(tok.content)
        if i is None:
            top = max(self.added_r, default=-1)
            size = self.vocab_size
            i = top + 1 if top >= size or size == 0 else size
        tok.id = i
        self.added[tok.content] = tok
        self.added_r[i] = tok
        self._refresh()

    def _refresh(self) -> None:
        def trie(toks: list[tuple[str, _Added]]):
            toks = [(s, t) for s, t in toks if s]
            if not toks:
                return None, []
            order = sorted(range(len(toks)), key=lambda k: -len(toks[k][0]))
            regex = re.compile("|".join(re.escape(toks[k][0]) for k in order))
            by_text = {}
            for k in order:
                by_text.setdefault(toks[k][0], toks[k][1])
            return regex, by_text

        raw = [(t.content, t) for t in self.added.values() if not t.normalized]
        norm = [(self.normalizer(t.content) if self.normalizer else t.content, t)
                for t in self.added.values() if t.normalized]
        self._raw_trie = trie(raw)
        self._norm_trie = trie(norm)

    @staticmethod
    def _find_added(text: str, trie) -> list[tuple[int, int, _Added | None]]:
        """The library's AddedVocabulary::find_matches: spans of ``text``,
        each an added token or a gap, after single_word / lstrip / rstrip."""
        regex, by_text = trie
        if regex is None:
            return [(0, len(text), None)]
        out: list[tuple[int, int, _Added | None]] = []
        prev = 0
        for m in regex.finditer(text):
            s, e = m.span()
            tok = by_text[m.group()]
            if tok.single_word:
                if (s > 0 and _alnum(text[s - 1])) or (e < len(text) and _alnum(text[e])):
                    continue
            if tok.lstrip:
                k = s
                while k > 0 and text[k - 1] in _WHITE_SPACE:
                    k -= 1
                s = max(k, prev)
            if tok.rstrip:
                while e < len(text) and text[e] in _WHITE_SPACE:
                    e += 1
            if prev < s:
                out.append((prev, s, None))
            out.append((s, e, tok))
            prev = e
        if prev != len(text):
            out.append((prev, len(text), None))
        return out

    def encode(self, text: str) -> list[int]:
        # (text, original start, id of an added token or None)
        pieces: list[tuple[str, int, int | None]] = []
        for s, e, tok in self._find_added(text, self._raw_trie):
            if e <= s:
                continue
            if tok is not None:
                pieces.append((text[s:e], s, tok.id))
                continue
            part = text[s:e]
            if self.normalizer is not None:
                part = self.normalizer(part)
            for s2, e2, tok2 in self._find_added(part, self._norm_trie):
                if e2 > s2:
                    pieces.append((part[s2:e2], s + s2,
                                   tok2.id if tok2 is not None else None))
        ids: list[int] = []
        pre, model = self.pre_tokenizer, self.model
        for piece, start, tid in pieces:
            if tid is not None:
                ids.append(tid)
            elif pre is None:
                ids.extend(model.tokenize(piece))
            else:
                for sub, _ in pre([(piece, start)]):
                    ids.extend(model.tokenize(sub))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        added_r, vocab_r = self.added_r, self.model.vocab_r
        for i in ids:
            tok = added_r.get(i)
            if tok is not None:
                if not (skip_special_tokens and tok.special):
                    tokens.append(tok.content)
                continue
            t = vocab_r.get(i)
            if t is not None:
                if skip_special_tokens and t in self.added and self.added[t].special:
                    continue
                tokens.append(t)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))


# -- the transformers layer ---------------------------------------------------------------

def _token_str(v: Any) -> str | None:
    """A special token from tokenizer_config.json: a string or an
    AddedToken dict."""
    if isinstance(v, dict):
        return v.get("content")
    return v if isinstance(v, str) else None


def _clean_up(text: str) -> str:
    """transformers' clean_up_tokenization."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


def _read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class HFTokenizer:
    """A checkpoint directory's HuggingFace tokenizer, read without
    ``transformers`` (the reference's class, attribute for attribute:
    ``eos_token_id``, ``vocab_size``, ``encode``, ``decode``,
    ``apply_chat_template``). Like the reference's it has no
    ``decode_bytes``, so IncrementalDecoder streams it through the
    sliding window, as the reference's frontend does."""

    def __init__(self, path: str):
        tj = os.path.join(path, "tokenizer.json")
        if not os.path.exists(tj):
            if os.path.exists(os.path.join(path, "tokenizer.model")):
                raise NotImplementedError(
                    f"{path} holds a SentencePiece tokenizer.model and no "
                    "tokenizer.json: the port reads tokenizer.json only (the "
                    "reference converts the .model through sentencepiece)")
            raise FileNotFoundError(f"no tokenizer.json in {path}")
        cfg_path = os.path.join(path, "tokenizer_config.json")
        cfg = _read_json(cfg_path) if os.path.exists(cfg_path) else {}
        self._tok = tok = TokenizerModel(_read_json(tj))
        self.config = cfg

        cls = (cfg.get("tokenizer_class") or "").removesuffix("Fast")
        specials: dict[str, Any] = dict(_CLASS_DEFAULTS.get(cls, {}))
        specials.update({a: cfg[a] for a in SPECIAL_ATTRS if a in cfg})
        self.special_tokens: dict[str, Any] = {}
        for attr in SPECIAL_ATTRS:
            s = _token_str(specials.get(attr))
            if s:
                self.special_tokens[attr] = s
        extra = [_token_str(t) for t in cfg.get("additional_special_tokens") or ()]
        extra = [t for t in extra if t]
        if extra:
            self.special_tokens["additional_special_tokens"] = extra

        # transformers re-adds tokenizer_config.json's added tokens, then
        # every named special token the tokenizer does not hold as added
        special_set = set(self.special_tokens.get("additional_special_tokens", [])) | {
            v for k, v in self.special_tokens.items() if k != "additional_special_tokens"}
        decl = cfg.get("added_tokens_decoder") or {}
        for i in sorted(decl, key=int):
            t = _Added.from_dict(int(i), decl[i])
            t.special = t.special or t.content in special_set
            tok.add_token(t)
        for s in [v for k, v in self.special_tokens.items()
                  if k != "additional_special_tokens"] + extra:
            if s not in tok.added:
                tok.add_token(_Added(-1, s, special=True))
        # transformers resets a top-level ByteLevel's add_prefix_space to
        # the config's (default False)
        pre = tok.pre_tokenizer_spec or {}
        want = cfg.get("add_prefix_space", False)
        if "add_prefix_space" in pre and pre.get("type") != "Metaspace" \
                and pre["add_prefix_space"] != want and isinstance(want, bool):
            tok.set_byte_level_prefix(want)

        eos = self.special_tokens.get("eos_token")
        self.eos_token_id = (self._token_id(eos) if eos else None) or 2
        self.vocab_size = tok.vocab_size
        self.clean_up_tokenization_spaces = bool(
            cfg.get("clean_up_tokenization_spaces", False))
        self.chat_template = ChatTemplate.from_dir(path, cfg)

    def _token_id(self, token: str) -> int | None:
        i = self._tok.token_to_id(token)
        if i is None and "unk_token" in self.special_tokens:
            return self._tok.token_to_id(self.special_tokens["unk_token"])
        return i

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        text = self._tok.decode(ids, skip_special_tokens=True)
        return _clean_up(text) if self.clean_up_tokenization_spaces else text

    def apply_chat_template(
        self, messages: list[dict], add_generation_prompt: bool = True,
        tools: list[dict] | None = None,
    ) -> str:
        return self.chat_template.render(
            messages, add_generation_prompt=add_generation_prompt, tools=tools,
            special_tokens=self.special_tokens)
