r"""Oniguruma-style Unicode regexes as Python ``re`` patterns.

A ``tokenizer.json`` writes its split patterns for the Oniguruma engine
the tokenizers library compiles them with: ``\p{L}``, ``\p{N}``, general
categories such as ``\p{Lu}`` and their negations ``\P{...}`` / ``\p{^...}``,
inside and outside brackets. Python's ``re`` has no ``\p``, and its
``\s`` / ``\d`` / ``\w`` are not Oniguruma's:

- ``\s`` in Python matches U+001C..U+001F (str.isspace); Oniguruma's is
  the Unicode White_Space set, which leaves them out. With llama-3's
  pattern, ``"a\x1c  b"`` splits into ``['a', '\x1c', ' ', ' b']`` there
  and ``['a', '\x1c ', ' b']`` under a literal Python ``\s``.
- ``\w`` is Alphabetic | Mark | Decimal_Number | Connector_Punctuation,
  plus six Latin-1 number signs; Python's is str.isalnum() plus ``_``.
- ``\d`` is Decimal_Number in both, but the data differ (below).

So every class escape becomes an explicit codepoint-range class built
from ``unicodedata`` once per process and cached per pattern. Python
3.12's ``unicodedata`` is Unicode 15.0; the tokenizers library's engine
has Unicode 16.0's tables, so the 16.0 assignments are kept below
(``_UNICODE_16``) and applied on top. Anything this translator cannot
express exactly (scripts, POSIX brackets, class intersection, other
Oniguruma-only escapes or flags) raises NotImplementedError naming it.
"""

from __future__ import annotations

import functools
import itertools
import re
import unicodedata

__all__ = ["translate", "compile_pattern", "category_ranges", "WHITE_SPACE"]

MAX_CP = 0x10FFFF

# where Unicode 16.0's general category differs from Python 3.12's
# unicodedata (Unicode 15.0): the 16.0 assignments, which 15.0 reads as
# unassigned, and U+1171E (Mn -> Mc). (first, last, 16.0 category)
_UNICODE_16 = (
    (0x897, 0x897, 'Mn'), (0x1b4e, 0x1b4f, 'Po'), (0x1b7f, 0x1b7f, 'Po'),
    (0x1c89, 0x1c89, 'Lu'), (0x1c8a, 0x1c8a, 'Ll'), (0x2427, 0x2429, 'So'),
    (0x2ffc, 0x2fff, 'So'), (0x31e4, 0x31e5, 'So'), (0x31ef, 0x31ef, 'So'),
    (0xa7cb, 0xa7cc, 'Lu'), (0xa7cd, 0xa7cd, 'Ll'), (0xa7da, 0xa7da, 'Lu'),
    (0xa7db, 0xa7db, 'Ll'), (0xa7dc, 0xa7dc, 'Lu'), (0x105c0, 0x105f3, 'Lo'),
    (0x10d40, 0x10d49, 'Nd'), (0x10d4a, 0x10d4d, 'Lo'), (0x10d4e, 0x10d4e, 'Lm'),
    (0x10d4f, 0x10d4f, 'Lo'), (0x10d50, 0x10d65, 'Lu'), (0x10d69, 0x10d6d, 'Mn'),
    (0x10d6e, 0x10d6e, 'Pd'), (0x10d6f, 0x10d6f, 'Lm'), (0x10d70, 0x10d85, 'Ll'),
    (0x10d8e, 0x10d8f, 'Sm'), (0x10ec2, 0x10ec4, 'Lo'), (0x10efc, 0x10efc, 'Mn'),
    (0x11380, 0x11389, 'Lo'), (0x1138b, 0x1138b, 'Lo'), (0x1138e, 0x1138e, 'Lo'),
    (0x11390, 0x113b5, 'Lo'), (0x113b7, 0x113b7, 'Lo'), (0x113b8, 0x113ba, 'Mc'),
    (0x113bb, 0x113c0, 'Mn'), (0x113c2, 0x113c2, 'Mc'), (0x113c5, 0x113c5, 'Mc'),
    (0x113c7, 0x113ca, 'Mc'), (0x113cc, 0x113cd, 'Mc'), (0x113ce, 0x113ce, 'Mn'),
    (0x113cf, 0x113cf, 'Mc'), (0x113d0, 0x113d0, 'Mn'), (0x113d1, 0x113d1, 'Lo'),
    (0x113d2, 0x113d2, 'Mn'), (0x113d3, 0x113d3, 'Lo'), (0x113d4, 0x113d5, 'Po'),
    (0x113d7, 0x113d8, 'Po'), (0x113e1, 0x113e2, 'Mn'), (0x116d0, 0x116e3, 'Nd'),
    (0x1171e, 0x1171e, 'Mc'), (0x11bc0, 0x11be0, 'Lo'), (0x11be1, 0x11be1, 'Po'),
    (0x11bf0, 0x11bf9, 'Nd'), (0x11f5a, 0x11f5a, 'Mn'), (0x13460, 0x143fa, 'Lo'),
    (0x16100, 0x1611d, 'Lo'), (0x1611e, 0x16129, 'Mn'), (0x1612a, 0x1612c, 'Mc'),
    (0x1612d, 0x1612f, 'Mn'), (0x16130, 0x16139, 'Nd'), (0x16d40, 0x16d42, 'Lm'),
    (0x16d43, 0x16d6a, 'Lo'), (0x16d6b, 0x16d6c, 'Lm'), (0x16d6d, 0x16d6f, 'Po'),
    (0x16d70, 0x16d79, 'Nd'), (0x18cff, 0x18cff, 'Lo'), (0x1cc00, 0x1ccef, 'So'),
    (0x1ccf0, 0x1ccf9, 'Nd'), (0x1cd00, 0x1ceb3, 'So'), (0x1e5d0, 0x1e5ed, 'Lo'),
    (0x1e5ee, 0x1e5ef, 'Mn'), (0x1e5f0, 0x1e5f0, 'Lo'), (0x1e5f1, 0x1e5fa, 'Nd'),
    (0x1e5ff, 0x1e5ff, 'Po'), (0x1f8b2, 0x1f8bb, 'So'), (0x1f8c0, 0x1f8c1, 'So'),
    (0x1fa89, 0x1fa89, 'So'), (0x1fa8f, 0x1fa8f, 'So'), (0x1fabe, 0x1fabe, 'So'),
    (0x1fac6, 0x1fac6, 'So'), (0x1fadc, 0x1fadc, 'So'), (0x1fadf, 0x1fadf, 'So'),
    (0x1fae9, 0x1fae9, 'So'), (0x1fbcb, 0x1fbef, 'So'), (0x2ebf0, 0x2ee5d, 'Lo'),
)

# Unicode White_Space: Oniguruma's \s
WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))
# Oniguruma's \w beyond the general categories L, M, Nd, Nl and Pc:
# Latin-1's superscript digits and fractions, and the Other_Alphabetic
# circled and squared letters
_WORD_EXTRA = ((0xB2, 0xB3), (0xB9, 0xB9), (0xBC, 0xBE), (0x24B6, 0x24E9),
               (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189))

_CATEGORIES = frozenset(
    "Lu Ll Lt Lm Lo Mn Mc Me Nd Nl No Pc Pd Ps Pe Pi Pf Po Sm Sc Sk So "
    "Zs Zl Zp Cc Cf Cs Co Cn".split())


# every codepoint outside these blocks is unassigned (planes 4-13, and
# plane 14 past its tags and variation selectors); planes 15-16 are
# scanned for their private-use runs (the tests check a full scan)
_SCANNED = ((0, 0x3FFFF), (0xE0000, 0xE0FFF), (0xF0000, MAX_CP))


@functools.cache
def _runs() -> tuple[tuple[int, int, str], ...]:
    """(first, last, category) runs over every codepoint, Unicode 16.0."""
    category = unicodedata.category
    runs: list[list] = []

    def add(lo: int, n: int, cat: str) -> None:
        if runs and runs[-1][2] == cat:
            runs[-1][1] += n
        else:
            runs.append([lo, lo + n - 1, cat])

    for first, last in _SCANNED:
        cats = [category(chr(cp)) for cp in range(first, last + 1)]
        for lo, hi, cat in _UNICODE_16:
            if first <= lo <= last:
                cats[lo - first:hi + 1 - first] = [cat] * (hi + 1 - lo)
        lo = first
        for cat, group in itertools.groupby(cats):
            n = sum(1 for _ in group)
            add(lo, n, cat)
            lo += n
        nxt = next((f for f, _ in _SCANNED if f > last), MAX_CP + 1)
        if nxt > last + 1:  # the unscanned block after it
            add(last + 1, nxt - 1 - last, "Cn")
    return tuple(tuple(r) for r in runs)


def _merge(ranges) -> tuple[tuple[int, int], ...]:
    out: list[list[int]] = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return tuple((lo, hi) for lo, hi in out)


@functools.cache
def category_ranges(cats: frozenset) -> tuple[tuple[int, int], ...]:
    """Merged codepoint ranges of a set of two-letter general categories."""
    return _merge((lo, hi) for lo, hi, cat in _runs() if cat in cats)


def _complement(ranges) -> tuple[tuple[int, int], ...]:
    out, nxt = [], 0
    for lo, hi in ranges:
        if lo > nxt:
            out.append((nxt, lo - 1))
        nxt = hi + 1
    if nxt <= MAX_CP:
        out.append((nxt, MAX_CP))
    return tuple(out)


def _property(name: str) -> tuple[tuple[int, int], ...]:
    if name in _CATEGORIES:
        cats = frozenset((name,))
    elif name in ("L", "M", "N", "P", "S", "Z", "C"):
        cats = frozenset(c for c in _CATEGORIES if c[0] == name)
    else:
        raise NotImplementedError(
            f"regex property \\p{{{name}}}: only general categories are "
            "translated (scripts and other properties are not)")
    return category_ranges(cats)


@functools.cache
def _escape_class(kind: str) -> tuple[tuple[int, int], ...]:
    if kind == "s":
        return WHITE_SPACE
    if kind == "d":
        return category_ranges(frozenset(("Nd",)))
    return _merge(category_ranges(frozenset(
            c for c in _CATEGORIES if c[0] in "LM" or c in ("Nd", "Nl", "Pc")))
            + _WORD_EXTRA)


def _cp(cp: int) -> str:
    if cp < 0x100:
        return f"\\x{cp:02x}"
    return f"\\u{cp:04x}" if cp < 0x10000 else f"\\U{cp:08x}"


def _class_body(ranges) -> str:
    return "".join(_cp(lo) if lo == hi else f"{_cp(lo)}-{_cp(hi)}"
                   for lo, hi in ranges)


_FLAGS_OK = frozenset("i")


def translate(pattern: str) -> str:
    """The Python ``re`` pattern (compiled with re.MULTILINE: Oniguruma's
    Ruby syntax anchors ``^`` / ``$`` at lines) that matches what
    ``pattern`` matches under Oniguruma."""
    out: list[str] = []
    in_class = False
    i, n = 0, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\":
            if i + 1 >= n:
                raise ValueError(f"regex {pattern!r} ends in a backslash")
            e = pattern[i + 1]
            if e in "pP":
                if pattern.startswith("{", i + 2):
                    j = pattern.find("}", i + 3)
                    if j < 0:
                        raise ValueError(f"regex {pattern!r}: unclosed \\{e}{{")
                    name, i = pattern[i + 3:j], j + 1
                else:
                    name, i = pattern[i + 2:i + 3], i + 3
                neg = e == "P"
                if name.startswith("^"):
                    name, neg = name[1:], not neg
                ranges = _property(name)
            elif e in "sSdDwW":
                ranges, neg, i = _escape_class(e.lower()), e.isupper(), i + 2
            elif e in "hHzZGKRXkgQEOyYN" or (e == "x" and pattern.startswith("{", i + 2)):
                raise NotImplementedError(
                    f"regex escape \\{e} in {pattern!r} is not translated")
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if in_class:
                out.append(_class_body(_complement(ranges) if neg else ranges))
            else:
                out.append(f"[{'^' if neg else ''}{_class_body(ranges)}]")
            continue
        if in_class:
            if c == "]":
                in_class = False
            elif c == "[" or pattern.startswith("&&", i):
                raise NotImplementedError(
                    f"regex {pattern!r}: nested classes, POSIX brackets and "
                    "class intersection are not translated")
            out.append(c)
            i += 1
            continue
        if c == "[":
            in_class = True
            out.append("[")
            i += 1
            if pattern.startswith("^", i):
                out.append("^")
                i += 1
            if pattern.startswith("]", i):  # a leading ']' is literal
                out.append(r"\]")
                i += 1
            continue
        if c == "(" and pattern.startswith("(?", i):
            m = re.match(r"\(\?([A-Za-z-]*)([:)])", pattern[i:])
            if m and m.group(1):
                if not set(m.group(1)) <= _FLAGS_OK | {"-"}:
                    raise NotImplementedError(
                        f"regex flags (?{m.group(1)}) in {pattern!r}: "
                        "only (?i) is translated")
                if m.group(2) == ")" and i != 0:
                    raise NotImplementedError(
                        f"regex {pattern!r}: an inline (?i) past the start "
                        "is not translated")
        out.append(c)
        i += 1
    if in_class:
        raise ValueError(f"regex {pattern!r}: unclosed [")
    return "".join(out)


@functools.lru_cache(maxsize=64)
def compile_pattern(pattern: str) -> re.Pattern:
    return re.compile(translate(pattern), re.MULTILINE)
