"""Trace coverage: n-grams over the canonical monitor-event stream.

The guided chaos campaign needs a notion of "this scenario reached an
engine state no earlier scenario reached".  Source-line coverage is
meaningless for a deterministic event-loop engine — every scenario runs
the same dispatcher — so coverage is defined over *behaviour*: the
ordered sequence of monitor events a run emits.

Each trace line (``build_trace`` format: ``<t> <scope> <event> <json>``)
is normalized to a token.  Task scopes are collapsed to the literal
``task`` (task ids are relabelled per run and their count is a measure of
scenario *size*, not novelty); system scope stays ``system``.  The
coverage unit is the n-gram of consecutive tokens: 1-grams distinguish
*which* failure machinery fired, higher n distinguishes *orderings* —
retry-after-steal-after-partition is a different 3-gram path than
retry-after-steal alone, which is exactly the kind of interleaving a
correlated-fault search is hunting.
"""
from __future__ import annotations

from typing import Iterable

__all__ = ["trace_tokens", "trace_ngrams", "CoverageMap"]


def trace_tokens(trace: str) -> list[str]:
    """Canonical trace text -> normalized ``scope:event`` token sequence."""
    tokens: list[str] = []
    for line in trace.splitlines():
        parts = line.split(" ", 3)
        if len(parts) < 3:
            continue
        _, scope, event = parts[0], parts[1], parts[2]
        scope_class = "system" if scope == "system" else "task"
        tokens.append(f"{scope_class}:{event}")
    return tokens


def trace_ngrams(trace: str, n: int = 3) -> set[tuple[str, ...]]:
    """All n-grams (orders 1..n) of the normalized token sequence.

    Including the lower orders makes coverage monotone in n and keeps a
    single novel *event kind* visible even when its context n-gram was
    already seen.
    """
    tokens = trace_tokens(trace)
    grams: set[tuple[str, ...]] = set()
    for order in range(1, n + 1):
        for i in range(len(tokens) - order + 1):
            grams.add(tuple(tokens[i:i + order]))
    return grams


class CoverageMap:
    """Accumulated n-gram coverage across a campaign."""

    def __init__(self, n: int = 3):
        self.n = n
        self.seen: set[tuple[str, ...]] = set()

    def novelty(self, trace: str) -> int:
        """How many n-grams of ``trace`` are new, without recording them."""
        return len(trace_ngrams(trace, self.n) - self.seen)

    def add(self, trace: str) -> int:
        """Record a trace; returns the number of newly-covered n-grams."""
        grams = trace_ngrams(trace, self.n)
        new = len(grams - self.seen)
        self.seen |= grams
        return new

    def add_tokens(self, grams: Iterable[tuple[str, ...]]) -> int:
        before = len(self.seen)
        self.seen.update(grams)
        return len(self.seen) - before

    def distinct(self) -> int:
        return len(self.seen)

    def __len__(self) -> int:
        return len(self.seen)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<CoverageMap n={self.n} distinct={len(self.seen)}>"
