"""Findings and the baseline waiver file.

A :class:`Finding` is one rule violation at one source location.  The
committed ``analysis_baseline.json`` waives *intentional* violations —
each entry needs a one-line justification — and ``--strict`` fails on
anything not waived.

Baseline entries match on ``(rule, file, symbol)`` rather than line
numbers, so routine edits to a file don't invalidate its waivers; a
waiver only goes stale when the violating code moves to a different
function or is removed (reported as an unused waiver).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any


@dataclass(frozen=True)
class Finding:
    """One rule violation: ruff-style location + code + fix hint."""

    rule: str       # e.g. "CLK001"
    file: str       # package-relative posix path, e.g. "engine/dfk.py"
    line: int
    col: int
    symbol: str     # enclosing qualname ("Class.method", "func", "<module>")
    message: str
    hint: str = ""  # how to fix it

    def render(self) -> str:
        s = f"{self.file}:{self.line}:{self.col} {self.rule} [{self.symbol}] {self.message}"
        if self.hint:
            s += f"\n    fix: {self.hint}"
        return s


class Baseline:
    """The committed waiver list: intentional violations + justifications."""

    def __init__(self, entries: list[dict[str, Any]]):
        for e in entries:
            for field in ("rule", "file", "symbol", "justification"):
                if not e.get(field):
                    raise ValueError(
                        f"baseline entry missing {field!r}: {e!r}")
        self.entries = entries
        self._used = [False] * len(entries)

    @classmethod
    def load(cls, path: str | Path) -> "Baseline":
        path = Path(path)
        if not path.exists():
            return cls([])
        data = json.loads(path.read_text())
        return cls(data.get("waivers", []))

    def match(self, finding: Finding) -> bool:
        """True (and mark the entry used) if ``finding`` is waived."""
        for i, e in enumerate(self.entries):
            if (e["rule"] == finding.rule and e["file"] == finding.file
                    and e["symbol"] == finding.symbol):
                self._used[i] = True
                return True
        return False

    def unused(self) -> list[dict[str, Any]]:
        """Waivers that matched nothing — stale entries to prune."""
        return [e for i, e in enumerate(self.entries) if not self._used[i]]


def split_baselined(findings: list[Finding],
                    baseline: Baseline) -> tuple[list[Finding], list[Finding]]:
    """Partition into (active, waived)."""
    active: list[Finding] = []
    waived: list[Finding] = []
    for f in findings:
        (waived if baseline.match(f) else active).append(f)
    return active, waived
