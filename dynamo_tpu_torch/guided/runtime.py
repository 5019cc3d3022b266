"""Token-level constraint engine: grammar DFA x vocabulary -> masks.

The engine-side half of guided decoding. A compiled grammar is a char
DFA (guided/regex_dfa.py) lifted over the model vocabulary:

- ``TokenDFA.step(state, tok)`` walks the token's surface chars through
  the char DFA (memoized per (state, token) on first use);
- ``TokenDFA.mask(state)`` is the [V] allowed-token bitmask, computed
  lazily per visited state and cached — the per-step serving cost is a
  dict hit + one numpy copy, never a vocab scan.

``GrammarCompiler`` caches compiled grammars in an LRU keyed by
(grammar key, vocab digest) — the same shape as the engine's persistent
compile cache: agentic traffic reuses a handful of schemas, so steady
state is all hits. Compilation carries the ``engine.guided_compile``
fault site; a failure surfaces as a typed request rejection (HTTP 400),
never a wedged slot.

``GuidedState`` is the per-slot cursor the engine advances on the host
as tokens land (engine/core.py _accept_token), with a non-mutating
``lookahead`` for speculative verify: draft tokens are walked on a
scratch cursor so a rejected tail needs NO rollback — the real state
only ever advances over emitted tokens.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np

from dynamo_tpu_torch.guided.regex_dfa import Dfa, compile_regex
from dynamo_tpu_torch.guided.vocab import TokenVocab
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry, register_registry

__all__ = ["TokenDFA", "GrammarCompiler", "GuidedState", "GUIDED_REQUESTS"]

# Guided-decoding observability on every /metrics surface: outcomes are
# ok (the grammar reached acceptance before the stream ended —
# conformance DELIVERED) | truncated (max_tokens or a stop sequence cut
# the stream mid-grammar: the client got a conformant PREFIX, not a
# parseable document) | violation (an unmasked path emitted an
# off-grammar token and the slot fell back to free decoding) | aborted
# (cancelled / engine error before a natural finish) | compile_error
# (grammar rejected -> client 400) | unavailable (no vocab /
# guided_mode=off on this worker).
_METRICS = MetricsRegistry()
GUIDED_REQUESTS = _METRICS.counter(
    "guided_requests_total",
    "Guided-decoding requests by outcome.",
    ["outcome"],
)
register_registry("guided", _METRICS)


class TokenDFA:
    """Char DFA lifted to token-level transitions + allowed masks."""

    def __init__(self, dfa: Dfa, vocab: TokenVocab):
        self.dfa = dfa
        self.vocab = vocab
        self._steps: dict[tuple[int, int], int | None] = {}
        self._masks: dict[int, np.ndarray] = {}

    def _walk(self, state: int, tok: int) -> int | None:
        text = (
            self.vocab.tokens[tok]
            if 0 <= tok < len(self.vocab.tokens) else ""
        )
        nxt: int | None = state if text else None
        for ch in text:
            nxt = self.dfa.step_char(nxt, ch)
            if nxt is None:
                break
        return nxt

    def step(self, state: int, tok: int) -> int | None:
        """Next char-DFA state after emitting token ``tok``, or None if
        the token leaves the grammar (or decodes empty). Memoized —
        called once per EMITTED token (advance/lookahead), so the memo
        stays proportional to traffic, not to states x vocab (mask
        computation walks the vocab WITHOUT touching this memo for the
        same reason)."""
        key = (state, tok)
        cached = self._steps.get(key, _MISS)
        if cached is not _MISS:
            return cached
        nxt = self._walk(state, tok)
        self._steps[key] = nxt
        return nxt

    def mask(self, state: int) -> np.ndarray:
        """Allowed-token bitmask [V] for one state (no EOS bit — the
        caller owns end-of-stream ids). Computed lazily per visited
        state (an O(V) vocab walk, once) and cached PACKED — V/8 bytes
        per state instead of V, which is what keeps a big-vocab grammar
        cache (128k tokens x thousands of DFA states) from pinning
        hundreds of MB through the process-shared LRU. The unpack per
        call is microseconds. Do not mutate the returned array."""
        V = len(self.vocab.tokens)
        packed = self._masks.get(state)
        if packed is None:
            m = np.zeros((V,), bool)
            for tok in range(V):
                if self._walk(state, tok) is not None:
                    m[tok] = True
            self._masks[state] = np.packbits(m)
            return m
        return np.unpackbits(packed, count=V).view(bool)

    def accepting(self, state: int) -> bool:
        return self.dfa.accept[state]


_MISS = object()


class CompiledGrammar:
    __slots__ = ("key", "kind", "tdfa", "compile_ms")

    def __init__(self, key: str, kind: str, tdfa: TokenDFA,
                 compile_ms: float):
        self.key = key
        self.kind = kind
        self.tdfa = tdfa
        self.compile_ms = compile_ms


# process-wide second-level cache: compiled grammars are pure functions
# of (regex, vocab digest), so engines in one process (bench pairs, the
# test suite's many tiny engines) share them instead of re-paying the
# DFA construction. Bounded like the per-compiler LRUs.
_SHARED: collections.OrderedDict[str, "CompiledGrammar"] = (
    collections.OrderedDict()
)
_SHARED_CAP = 128
_SHARED_LOCK = threading.Lock()


class GrammarCompiler:
    """LRU of (grammar key, vocab) -> TokenDFA, shared by every slot.

    Thread-safe: ``compile`` is called from the worker event loop (the
    pre-admission validation pass in engine.generate) and from the step
    thread (slot creation after an LRU eviction).
    """

    def __init__(self, vocab, *, vocab_size: int | None = None,
                 cache_entries: int = 32):
        self.vocab = TokenVocab.coerce(vocab, vocab_size)
        if vocab_size is not None and len(self.vocab) != vocab_size:
            raise ValueError(
                f"guided vocab has {len(self.vocab)} entries but the "
                f"model vocab is {vocab_size}"
            )
        self.cache_entries = max(1, int(cache_entries))
        self._lru: collections.OrderedDict[str, CompiledGrammar] = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()
        self.stats = {
            "compiles": 0, "hits": 0, "evictions": 0,
            "compile_ms_total": 0.0, "errors": 0,
        }

    def compile(self, guided: dict) -> CompiledGrammar:
        """Compile (or fetch) one wire grammar spec {regex, key, kind}."""
        src = guided.get("regex")
        if not isinstance(src, str) or not src:
            self.stats["errors"] += 1
            raise ValueError("guided request carries no grammar regex")
        key = f"{guided.get('key') or src}:{self.vocab.digest}"
        with self._lock:
            hit = self._lru.get(key)
            if hit is not None:
                self._lru.move_to_end(key)
                self.stats["hits"] += 1
                return hit
        with _SHARED_LOCK:
            shared = _SHARED.get(key)
            if shared is not None:
                _SHARED.move_to_end(key)
        if shared is not None:
            with self._lock:
                self._lru[key] = shared
                self.stats["hits"] += 1
                while len(self._lru) > self.cache_entries:
                    self._lru.popitem(last=False)
                    self.stats["evictions"] += 1
            return shared
        try:
            if FAULTS.enabled:
                # injected compile failure: the request must bounce as a
                # typed 400 with zero pages/slots touched, and the
                # outcome counter must show the trip
                FAULTS.fire_sync("engine.guided_compile")
            t0 = time.perf_counter()
            tdfa = TokenDFA(compile_regex(src), self.vocab)
            # eagerly realize the start-state mask: admission needs it
            # anyway, and doing it here keeps the fault/latency surface
            # in ONE place instead of the first sampling step
            tdfa.mask(tdfa.dfa.start)
            dt_ms = (time.perf_counter() - t0) * 1e3
        except Exception:
            self.stats["errors"] += 1
            raise
        cg = CompiledGrammar(key, guided.get("kind") or "regex", tdfa, dt_ms)
        with self._lock:
            self._lru[key] = cg
            self._lru.move_to_end(key)
            self.stats["compiles"] += 1
            self.stats["compile_ms_total"] += dt_ms
            while len(self._lru) > self.cache_entries:
                self._lru.popitem(last=False)
                self.stats["evictions"] += 1
        with _SHARED_LOCK:
            _SHARED[key] = cg
            _SHARED.move_to_end(key)
            while len(_SHARED) > _SHARED_CAP:
                _SHARED.popitem(last=False)
        return cg

    def state_for(self, guided: dict, *, eos_ids,
                  prefix_tokens=()) -> "GuidedState":
        """Fresh per-slot cursor, advanced over ``prefix_tokens`` — the
        completion tokens a migration/disagg resume folded into the
        prompt, so a resumed stream continues mid-grammar exactly where
        the dead worker left it."""
        cg = self.compile(guided)
        st = GuidedState(cg.tdfa, eos_ids=eos_ids)
        for tok in prefix_tokens:
            st.advance(int(tok))
        return st

    def snapshot(self) -> dict:
        """Compile-cache stats for bench/profile attribution."""
        with self._lock:
            total = self.stats["hits"] + self.stats["compiles"]
            return {
                **self.stats,
                "entries": len(self._lru),
                "hit_rate": (
                    round(self.stats["hits"] / total, 4) if total else None
                ),
                "compile_ms_mean": (
                    round(
                        self.stats["compile_ms_total"]
                        / self.stats["compiles"], 3,
                    )
                    if self.stats["compiles"] else None
                ),
            }


class GuidedState:
    """Per-slot grammar cursor (host side).

    ``violated`` flips when an UNMASKED path lands an off-grammar token
    (defensive: every sampling path is masked, so this marks a bug or a
    deliberately unconstrained fallback) — the slot then decodes free
    rather than wedging, and the request counts as outcome=violation.
    """

    __slots__ = ("tdfa", "state", "eos_ids", "done", "violated")

    def __init__(self, tdfa: TokenDFA, *, eos_ids):
        self.tdfa = tdfa
        self.state = tdfa.dfa.start
        self.eos_ids = frozenset(int(e) for e in eos_ids)
        self.done = False
        self.violated = False

    @property
    def constraining(self) -> bool:
        return not self.violated

    @property
    def conformant(self) -> bool:
        """The grammar has reached acceptance — the stream may legally
        end here and the emitted text parses. False mid-grammar, where
        an external cut (max_tokens, stop sequence) leaves the client a
        conformant prefix but not a conformant document."""
        return not self.violated and (
            self.done or self.tdfa.accepting(self.state)
        )

    def mask_for(self, state: int) -> np.ndarray:
        """[V] writable mask for one char-DFA state: grammar-allowed
        tokens, plus the end-of-stream ids exactly when the state
        accepts (a finished grammar means ONLY eos remains; an
        unfinished one must not stop early)."""
        m = self.tdfa.mask(state).copy()
        accept = self.tdfa.accepting(state)
        for e in self.eos_ids:
            if 0 <= e < m.shape[0]:
                m[e] = accept
        if not m.any():
            # dead end (a grammar whose accept state has no eos id in
            # range): fail open — an unconstrained step beats an argmax
            # over an all -inf row
            m[:] = True
        return m

    def mask(self) -> np.ndarray:
        return self.mask_for(self.state)

    def advance(self, tok: int) -> bool:
        """Consume one EMITTED token; returns False on an off-grammar
        token (state then freezes and the slot stops constraining)."""
        if self.done or self.violated:
            return True
        if tok in self.eos_ids:
            self.done = True
            if not self.tdfa.accepting(self.state):
                self.violated = True
                return False
            return True
        nxt = self.tdfa.step(self.state, tok)
        if nxt is None:
            self.violated = True
            return False
        self.state = nxt
        return True

    def lookahead(self, draft: list[int]) -> tuple[list[int], list[np.ndarray]]:
        """Walk a speculative draft WITHOUT mutating the cursor.

        Returns (valid_prefix, masks) where ``valid_prefix`` is the
        longest grammar-legal prefix of ``draft`` and ``masks[j]`` is
        the allowed mask for verify position j (the target's choice
        after consuming valid_prefix[:j]) — len(valid_prefix)+1 masks.
        The real state is untouched, so a rejected speculative tail
        needs no rollback by construction.
        """
        masks = [self.mask()]
        if self.done or self.violated:
            return [], masks
        st = self.state
        valid: list[int] = []
        for tok in draft:
            if tok in self.eos_ids:
                break
            nxt = self.tdfa.step(st, tok)
            if nxt is None:
                break
            st = nxt
            valid.append(tok)
            masks.append(self.mask_for(st))
        return valid, masks
