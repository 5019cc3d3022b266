"""Character-level regex -> DFA compiler for guided decoding.

The grammar compiler (guided/schema.py) lowers JSON-Schema / forced
tool-call grammars to a regex SOURCE string; this module lowers that
source to a deterministic finite automaton over characters, which
guided/runtime.py then lifts to token-level transitions + allowed-token
bitmasks over the model vocabulary (the xgrammar/outlines construction:
char DFA once per grammar, token walks once per (state, token)).

Supported syntax — exactly what the generators emit plus a practical
regex surface for ``nvext.guided_regex``:

  literals, ``\\``-escapes (incl. ``\\n \\t \\r \\uXXXX \\d \\w \\s``),
  ``.`` (any char but newline), ``[...]`` classes with ranges and ``^``
  negation, grouping ``(...)``, alternation ``|``, and the quantifiers
  ``* + ? {m} {m,} {m,n}``.

Anchors are implicit: the whole output must match (there is no ``^``/
``$``; a bare ``$``/``^`` outside a class is a syntax error rather than
a silently-different semantic).

Alphabet handling: transitions carry explicit char sets plus a single
OTHER symbol standing for "any character no grammar position mentions"
— correct because positive classes only ever contain mentioned chars,
so an unmentioned char can only match negated classes, which it always
does. This keeps subset construction linear in the MENTIONED alphabet
instead of Unicode.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["RegexError", "Dfa", "parse_regex", "compile_regex", "OTHER"]


class RegexError(ValueError):
    """Malformed or unsupported regex source (maps to a client 400)."""


# sentinel symbol: any character not mentioned by the pattern
OTHER = "\x00OTHER"

_ESCAPE_CLASSES = {
    "d": frozenset("0123456789"),
    "w": frozenset(
        "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"
    ),
    "s": frozenset(" \t\n\r\f\v"),
}
_ESCAPE_CHARS = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v",
                 "0": "\0"}

# AST node shapes (plain tuples keep the compiler allocation-light):
#   ("cls", frozenset[str], negated: bool)
#   ("cat", [nodes])  ("alt", [nodes])
#   ("star", node)  ("plus", node)  ("opt", node)
#   ("eps",)


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.i = 0

    def error(self, msg: str) -> RegexError:
        return RegexError(f"{msg} at position {self.i} in pattern")

    def peek(self) -> str | None:
        return self.src[self.i] if self.i < len(self.src) else None

    def take(self) -> str:
        ch = self.src[self.i]
        self.i += 1
        return ch

    # alt := cat ('|' cat)*
    def parse_alt(self):
        parts = [self.parse_cat()]
        while self.peek() == "|":
            self.take()
            parts.append(self.parse_cat())
        return parts[0] if len(parts) == 1 else ("alt", parts)

    def parse_cat(self):
        parts = []
        while self.peek() is not None and self.peek() not in "|)":
            parts.append(self.parse_repeat())
        if not parts:
            return ("eps",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def parse_repeat(self):
        node = self.parse_atom()
        while True:
            ch = self.peek()
            if ch == "*":
                self.take()
                node = ("star", node)
            elif ch == "+":
                self.take()
                node = ("plus", node)
            elif ch == "?":
                self.take()
                node = ("opt", node)
            elif ch == "{":
                node = self.parse_bound(node)
            else:
                return node

    def parse_bound(self, node):
        # {m} {m,} {m,n} — expanded structurally (copies + optionals), so
        # the NFA stays a plain Thompson construction
        start = self.i
        self.take()  # '{'
        digits = ""
        while self.peek() is not None and self.peek().isdigit():
            digits += self.take()
        if not digits:
            raise self.error("bad repetition bound")
        m = int(digits)
        n: int | None = m
        if self.peek() == ",":
            self.take()
            digits = ""
            while self.peek() is not None and self.peek().isdigit():
                digits += self.take()
            n = int(digits) if digits else None
        if self.peek() != "}":
            self.i = start
            raise self.error("unterminated repetition bound")
        self.take()
        if n is not None and (n < m or n > 256):
            raise self.error("bad repetition bound (need m <= n <= 256)")
        if m > 256:
            raise self.error("repetition bound too large (max 256)")
        parts = [node] * m
        if n is None:
            parts.append(("star", node))
        else:
            parts.extend(("opt", node) for _ in range(n - m))
        if not parts:
            return ("eps",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def parse_atom(self):
        ch = self.peek()
        if ch is None:
            raise self.error("unexpected end of pattern")
        if ch == "(":
            self.take()
            node = self.parse_alt()
            if self.peek() != ")":
                raise self.error("unclosed group")
            self.take()
            return node
        if ch == "[":
            return self.parse_class()
        if ch == ".":
            self.take()
            return ("cls", frozenset("\n"), True)
        if ch == "\\":
            return self.parse_escape()
        if ch in "*+?{":
            raise self.error(f"quantifier {ch!r} with nothing to repeat")
        if ch in ")]":
            raise self.error(f"unbalanced {ch!r}")
        if ch in "^$":
            raise self.error(
                f"anchor {ch!r} unsupported (the whole output always "
                "matches the full pattern)"
            )
        self.take()
        return ("cls", frozenset((ch,)), False)

    def parse_escape(self):
        self.take()  # backslash
        if self.peek() is None:
            raise self.error("dangling backslash")
        ch = self.take()
        if ch in _ESCAPE_CLASSES:
            return ("cls", _ESCAPE_CLASSES[ch], False)
        if ch in ("D", "W", "S"):
            return ("cls", _ESCAPE_CLASSES[ch.lower()], True)
        if ch in _ESCAPE_CHARS:
            return ("cls", frozenset((_ESCAPE_CHARS[ch],)), False)
        if ch == "u":
            return ("cls", frozenset((self._take_unicode(),)), False)
        # any other escaped char is that literal char
        return ("cls", frozenset((ch,)), False)

    def _take_unicode(self) -> str:
        hexs = self.src[self.i : self.i + 4]
        if len(hexs) != 4:
            raise self.error("\\u needs 4 hex digits")
        try:
            cp = int(hexs, 16)
        except ValueError:
            raise self.error("\\u needs 4 hex digits") from None
        self.i += 4
        return chr(cp)

    def parse_class(self):
        self.take()  # '['
        negated = False
        if self.peek() == "^":
            negated = True
            self.take()
        chars: set[str] = set()
        # shorthand escapes inside the class (\d/\w/\s) union into this
        # same set via _class_item
        self._pending_chars = chars
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                raise self.error("unclosed character class")
            if ch == "]" and not first:
                self.take()
                if not chars:
                    raise self.error("empty character class")
                return ("cls", frozenset(chars), negated)
            lo = self._class_item()
            if lo is None:  # \d/\w/\s inside a class: union the set
                first = False
                continue
            if self.peek() == "-" and self.src[self.i + 1 : self.i + 2] not in ("]", ""):
                self.take()
                hi = self._class_item()
                if hi is None:
                    raise self.error("bad class range endpoint")
                if ord(hi) < ord(lo):
                    raise self.error(f"reversed class range {lo!r}-{hi!r}")
                # patterns reach this parser from untrusted clients
                # (nvext.guided_regex): a tiny source like "[ -\\uffff]"
                # would otherwise expand to a 65k alphabet that makes
                # subset construction effectively unbounded, so refuse
                # wide ranges BEFORE materializing them — same cap the
                # compiler enforces on the distinct-alphabet union
                if ord(hi) - ord(lo) >= _MAX_ALPHABET:
                    raise self.error(
                        f"class range wider than {_MAX_ALPHABET} chars "
                        "— wide Unicode ranges belong in a negated "
                        "class, which costs nothing"
                    )
                chars.update(chr(c) for c in range(ord(lo), ord(hi) + 1))
                if len(chars) > _MAX_ALPHABET:
                    raise self.error(
                        f"character class mentions > {_MAX_ALPHABET} "
                        "distinct characters"
                    )
            else:
                chars.add(lo)
            first = False

    def _class_item(self) -> str | None:
        """One class member: a literal char, an escape, or None when a
        class-shorthand escape (\\d/\\w/\\s) was unioned in directly."""
        ch = self.take()
        if ch != "\\":
            return ch
        if self.peek() is None:
            raise self.error("dangling backslash in class")
        e = self.take()
        if e in _ESCAPE_CLASSES:
            self._pending_chars.update(_ESCAPE_CLASSES[e])
            return None
        if e in _ESCAPE_CHARS:
            return _ESCAPE_CHARS[e]
        if e == "u":
            return self._take_unicode()
        return e


def parse_regex(src: str):
    """Parse to AST; raises RegexError on malformed/unsupported source.
    Cheap (no vocab) — the frontend calls this at the edge so generator
    or client mistakes become typed 400s, never worker-side 500s."""
    if not isinstance(src, str) or not src:
        raise RegexError("empty pattern")
    if len(src) > 65536:
        raise RegexError("pattern too large (max 64 KiB)")
    p = _Parser(src)
    ast = p.parse_alt()
    if p.i != len(src):
        raise p.error("unbalanced ')'")
    return ast


# ------------------------------------------------------------------- NFA


@dataclass
class _Nfa:
    # eps[i] = states reachable by epsilon from i;
    # edges[i] = [(chars, negated, dst)]
    eps: list[list[int]] = field(default_factory=list)
    edges: list[list[tuple[frozenset, bool, int]]] = field(default_factory=list)

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1


def _build(nfa: _Nfa, node) -> tuple[int, int]:
    """Thompson construction: returns (start, accept) for one AST node."""
    kind = node[0]
    if kind == "eps":
        s = nfa.state()
        return s, s
    if kind == "cls":
        s, a = nfa.state(), nfa.state()
        nfa.edges[s].append((node[1], node[2], a))
        return s, a
    if kind == "cat":
        first_s, prev_a = _build(nfa, node[1][0])
        for sub in node[1][1:]:
            s, a = _build(nfa, sub)
            nfa.eps[prev_a].append(s)
            prev_a = a
        return first_s, prev_a
    if kind == "alt":
        s, a = nfa.state(), nfa.state()
        for sub in node[1]:
            ss, sa = _build(nfa, sub)
            nfa.eps[s].append(ss)
            nfa.eps[sa].append(a)
        return s, a
    if kind in ("star", "plus", "opt"):
        s, a = nfa.state(), nfa.state()
        ss, sa = _build(nfa, node[1])
        nfa.eps[s].append(ss)
        if kind != "plus":
            nfa.eps[s].append(a)
        nfa.eps[sa].append(a)
        if kind != "opt":
            nfa.eps[sa].append(ss)
        return s, a
    raise AssertionError(f"unknown AST node {kind}")


# ------------------------------------------------------------------- DFA


class Dfa:
    """Deterministic automaton over characters.

    ``trans[state]`` maps symbol -> next state, where a symbol is a
    concrete char from the pattern's mentioned ``alphabet`` or OTHER
    (any unmentioned char). ``accept[state]`` flags final states. Every
    state is trimmed co-accessible: a transition always leads somewhere
    an accepting state is still reachable from, so a token walk that
    finds a transition can never be a dead end.
    """

    def __init__(self, start: int, trans: list[dict], accept: list[bool],
                 alphabet: frozenset):
        self.start = start
        self.trans = trans
        self.accept = accept
        self.alphabet = alphabet

    def step_char(self, state: int, ch: str) -> int | None:
        t = self.trans[state]
        if ch in self.alphabet:
            return t.get(ch)
        return t.get(OTHER)

    @property
    def num_states(self) -> int:
        return len(self.trans)


_MAX_DFA_STATES = 50_000
# subset construction iterates every mentioned symbol at every state, so
# the alphabet — not the state count — is the lever an untrusted pattern
# can pull to burn worker CPU. The parser enforces this per range/class
# (the edge 400 path never materializes a wide range); compile enforces
# it on the distinct-char union across ALL classes and literals before
# construction starts. Real grammars (the JSON lowering, tool-call
# markers) mention well under 200 distinct chars.
_MAX_ALPHABET = 1024


def compile_regex(src: str) -> Dfa:
    """Regex source -> trimmed char DFA (subset construction)."""
    ast = parse_regex(src)
    nfa = _Nfa()
    start, accept = _build(nfa, ast)

    # mentioned alphabet: all chars any positive OR negated class names
    alphabet: set[str] = set()
    for edges in nfa.edges:
        for chars, _neg, _dst in edges:
            alphabet.update(chars)
    if len(alphabet) > _MAX_ALPHABET:
        raise RegexError(
            f"pattern mentions {len(alphabet)} distinct characters "
            f"(max {_MAX_ALPHABET}) — use negated classes for wide "
            "Unicode ranges"
        )
    symbols = sorted(alphabet) + [OTHER]

    def closure(states: frozenset) -> frozenset:
        seen = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    def matches(chars: frozenset, negated: bool, sym: str) -> bool:
        if sym is OTHER:
            return negated
        return (sym in chars) != negated

    start_set = closure(frozenset((start,)))
    index: dict[frozenset, int] = {start_set: 0}
    order: list[frozenset] = [start_set]
    trans: list[dict] = [{}]
    work = [start_set]
    while work:
        cur = work.pop()
        ci = index[cur]
        for sym in symbols:
            nxt = set()
            for s in cur:
                for chars, neg, dst in nfa.edges[s]:
                    if matches(chars, neg, sym):
                        nxt.add(dst)
            if not nxt:
                continue
            nset = closure(frozenset(nxt))
            ni = index.get(nset)
            if ni is None:
                ni = len(order)
                if ni >= _MAX_DFA_STATES:
                    raise RegexError(
                        f"grammar automaton too large (> {_MAX_DFA_STATES} "
                        "states) — simplify the schema or lower the "
                        "nesting depth"
                    )
                index[nset] = ni
                order.append(nset)
                trans.append({})
                work.append(nset)
            trans[ci][sym] = ni
    accepting = [accept in st for st in order]

    # trim: keep only co-accessible states (accept reachable), so token
    # walks can never enter a state that silently strands the stream
    rev: list[list[int]] = [[] for _ in order]
    for i, t in enumerate(trans):
        for dst in t.values():
            rev[dst].append(i)
    live = {i for i, a in enumerate(accepting) if a}
    stack = list(live)
    while stack:
        s = stack.pop()
        for p in rev[s]:
            if p not in live:
                live.add(p)
                stack.append(p)
    if 0 not in live:
        raise RegexError("pattern matches nothing")
    trimmed = [
        {sym: dst for sym, dst in t.items() if dst in live}
        for i, t in enumerate(trans)
    ]
    return Dfa(0, trimmed, accepting, frozenset(alphabet))
