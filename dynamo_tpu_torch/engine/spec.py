"""Speculative decoding: prompt-lookup drafting + per-slot adaptive k.

The port's copy of dynamo_tpu/engine/spec.py; its counter registers on the
port's own metrics registry. The latency-optimized serving scenario:
instead of one token per decode dispatch, a DRAFTER proposes up to k continuation
tokens from the slot's own history and the target model verifies all of
them in one packed short-prefill dispatch (engine/core.py _spec_phase ->
models/*.verify_forward). With greedy accept-longest-prefix rejection,
the emitted stream is the target's own greedy stream — bit-identical to
``spec_mode=off`` at temperature 0 — while each verify dispatch lands
1..k+1 tokens.

The drafter here is vLLM's ``[ngram]`` / prompt-lookup scheme: no draft
model, no extra weights — the longest n-gram suffix of the slot's token
history (``spec_ngram_min..spec_ngram_max``) is matched against its
previous occurrence in that same history, and the tokens that followed
it last time are the draft. This wins exactly where low-concurrency
serving hurts most: repetitive/agentic traffic (tool-call loops, code
edits, RAG with quoted context, self-repeating greedy cycles), and
costs nearly nothing where it loses — per-slot acceptance-rate EWMA
decays k to 0, which transparently returns the slot to the normal
decode-burst path (mixed spec/non-spec slots share one engine cycle).

This module is engine-local: nothing here touches the wire. The only cross-cutting surface is the
``dynamo_spec_tokens_total{outcome}`` counter, appended to every
/metrics exposition like the fault-trip counters.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from dynamo_tpu_torch.runtime.metrics import MetricsRegistry, register_registry

__all__ = ["PromptLookupDrafter", "SlotSpec", "SPEC_TOKENS"]

# Speculation observability, appended to every /metrics surface: the
# accepted:rejected ratio IS the live acceptance rate — a dashboard that
# watches it knows whether spec mode is paying for its verify dispatches
# without scraping engine internals.
_METRICS = MetricsRegistry()
SPEC_TOKENS = _METRICS.counter(
    "spec_tokens_total",
    "Speculative draft tokens by verify outcome.",
    ["outcome"],  # accepted | rejected
)
register_registry("spec_decode", _METRICS)


class PromptLookupDrafter:
    """Longest n-gram suffix match over one slot's full token history.

    For each n in [ngram_min, ngram_max] an incremental index maps every
    n-gram to its (latest, previous) start positions, so a propose() is
    O(ngram_max) dict lookups and an extend() is O(tokens * ngrams) —
    no rescan of the history (the reference behavior of vLLM's ngram
    proposer, which re-slides a window per step, is O(history) per
    token). The draft for a match at position p is the tokens that
    FOLLOWED that occurrence: ``history[p+n : p+n+k]``.
    """

    def __init__(self, ngram_min: int, ngram_max: int):
        self.ngram_min = max(1, int(ngram_min))
        self.ngram_max = max(self.ngram_min, int(ngram_max))
        self.tokens: list[int] = []
        # per-n: ngram tuple -> (latest start, previous start | None)
        self._index: dict[int, dict[tuple, tuple[int, int | None]]] = {
            n: {} for n in range(self.ngram_min, self.ngram_max + 1)
        }

    def extend(self, tokens: list[int]) -> None:
        for t in tokens:
            self.tokens.append(int(t))
            p = len(self.tokens)
            for n, idx in self._index.items():
                if p < n:
                    continue
                key = tuple(self.tokens[p - n:p])
                prev = idx.get(key)
                idx[key] = (p - n, prev[0] if prev is not None else None)

    def propose(self, k: int) -> list[int]:
        """Up to ``k`` draft tokens continuing the current suffix, from
        the most recent PRIOR occurrence of the longest matching n-gram
        (longest first: a longer context match is a stronger predictor).
        Empty when nothing in the history matches."""
        L = len(self.tokens)
        if k <= 0:
            return []
        for n in range(self.ngram_max, self.ngram_min - 1, -1):
            if L < n:
                continue
            entry = self._index[n].get(tuple(self.tokens[L - n:]))
            if entry is None:
                continue
            last, prev = entry
            # the suffix itself is indexed too — continue from the
            # occurrence strictly before it
            pos = prev if last == L - n else last
            if pos is None:
                continue
            return self.tokens[pos + n: pos + n + k]
        return []


@dataclass
class SlotSpec:
    """Per-slot speculation state: drafter + acceptance-adaptive k.

    ``k = floor(ewma * k_max)``: a slot whose drafts keep verifying
    holds k at k_max; misses (rejections OR no-match steps) decay the
    EWMA until k hits 0, which hands the slot back to the decode-burst
    path. While parked there, every ``reprobe_tokens`` emitted tokens
    bumps the EWMA back to a k=1 probe, so a request whose output turns
    repetitive later (think: an agent entering a tool-call loop) finds
    its way back into spec mode. An injected verify failure
    (engine.spec_verify fault) disables the slot outright — correctness
    first, the request just decodes normally.
    """

    drafter: PromptLookupDrafter
    k_max: int
    alpha: float
    reprobe_tokens: int
    ewma: float = 1.0  # optimistic start: first verify probes at k_max
    cooldown: int = 0  # tokens until the next k=1 reprobe while parked
    disabled: bool = False  # verify fault: permanently off for this slot
    # per-slot counters (rolled into the engine totals by _spec_phase)
    drafted: int = field(default=0)
    accepted: int = field(default=0)

    @classmethod
    def for_config(cls, cfg) -> "SlotSpec":
        return cls(
            drafter=PromptLookupDrafter(
                cfg.spec_ngram_min, cfg.spec_ngram_max
            ),
            k_max=max(1, cfg.spec_k_max),
            alpha=cfg.spec_ewma_alpha,
            reprobe_tokens=cfg.spec_reprobe_tokens,
        )

    @property
    def k(self) -> int:
        if self.disabled:
            return 0
        return min(self.k_max, int(self.ewma * self.k_max))

    @property
    def active(self) -> bool:
        """True while this slot is spec-managed (verify path, excluded
        from decode bursts). k decaying to 0 flips it back."""
        return self.k >= 1

    def disable(self) -> None:
        self.disabled = True
        self.ewma = 0.0

    def sync(self, tokens: list[int]) -> None:
        """Catch the drafter up to the slot's full token history (prompt
        + every emitted token, drafted or not — resumed/migrated slots
        arrive with drafted tokens already folded into their prompt)."""
        d = self.drafter
        if len(tokens) > len(d.tokens):
            d.extend(tokens[len(d.tokens):])

    def sync_from_seq(self, seq) -> None:
        """sync() against a TokenBlockSequence WITHOUT materializing the
        whole history: only the tokens past the drafter's high-water
        mark are extracted (block tail slices + the partial buffer), so
        the per-cycle drafting cost stays O(new tokens) on long
        contexts instead of O(seq_len) list rebuilds."""
        d = self.drafter
        start = len(d.tokens)
        total = len(seq)
        if total <= start:
            return
        bs = seq.block_size
        tail: list[int] = []
        for bi in range(start // bs, len(seq.blocks)):
            blk = seq.blocks[bi].tokens
            tail.extend(blk[max(start - bi * bs, 0):])
        tail.extend(seq.partial[max(start - len(seq.blocks) * bs, 0):])
        d.extend(tail)

    def propose(self, k_cap: int) -> list[int]:
        """Draft up to min(adaptive k, caller cap) tokens."""
        return self.drafter.propose(min(self.k, max(k_cap, 0)))

    def observe(self, drafted: int, accepted: int) -> None:
        """Fold one verify outcome into the EWMA. A no-draft step counts
        as rate 0: a history the drafter can't match is the same
        evidence of incompressibility as a rejected draft, and decaying
        on it is what caps the random-prompt overhead at a handful of
        one-token verifies before the slot rejoins the bursts."""
        self.drafted += drafted
        self.accepted += accepted
        rate = accepted / drafted if drafted else 0.0
        self.ewma = self.alpha * rate + (1.0 - self.alpha) * self.ewma
        if not self.active:
            self.cooldown = self.reprobe_tokens

    def on_tokens(self, n: int) -> None:
        """Non-spec tokens emitted while parked (k == 0): count down to
        the next k=1 reprobe."""
        if self.disabled or self.active or self.reprobe_tokens <= 0:
            return
        self.cooldown -= n
        if self.cooldown <= 0:
            # just enough EWMA for k=1: one cheap probe, not a k_max burst
            self.ewma = max(self.ewma, 1.5 / self.k_max)
            self.cooldown = self.reprobe_tokens
