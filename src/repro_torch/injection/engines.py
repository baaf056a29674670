"""Failure-injection engines (paper §VII-A, Table III).

The paper modifies TaPS with a "Parsl-fail engine" that replaces a
specified fraction of an application's tasks with *failure tasks*.  We do
the same at the :class:`~repro_torch.engine.task.TaskDef` level: an injector
deterministically (seeded) selects task invocations and rewrites them into
one of the Table III failure behaviours.

Two flavours exist, matching how the corresponding real failures arise:

* **function-replacement** failures always fail, wherever they run
  (``zero_division``, ``exception``, ``worker_killed``, ``dependency``) —
  these are the "destined to fail" tasks of the time-to-failure experiment
  (Fig 4);
* **spec-modification** failures rewrite the task's *resource spec* so the
  task fails on inadequate nodes but succeeds on adequate ones
  (``memory`` → needs 200 GB, ``import`` → needs a package, ``ulimit`` →
  opens 1M files) — these are the *resolvable* failures of §VII-C that
  WRATH's hierarchical retry can fix by re-placement.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any

from repro_torch.engine.cluster import kill_current_worker
from repro_torch.engine.task import TaskDef


def _fail_zero_division(*a: Any, **k: Any) -> Any:
    x = 0
    return 1 / x  # ZeroDivisionError — application-layer logic error


def _fail_exception(*a: Any, **k: Any) -> Any:
    raise RuntimeError("injected failure: runtime exception")


def _fail_worker_killed(*a: Any, **k: Any) -> Any:
    kill_current_worker("injected failure: worker killed")


FN_REPLACEMENT: dict[str, Any] = {
    "zero_division": _fail_zero_division,
    "exception": _fail_exception,
    "worker_killed": _fail_worker_killed,
    # 'dependency' replaces a *parent* with an exception: same fn, but the
    # interesting measurement is on the children that dep-fail.
    "dependency": _fail_exception,
}

# spec-modification failures: (spec field, injected value)
SPEC_MODIFICATION: dict[str, dict[str, Any]] = {
    "memory": {"memory_gb": 200.0},           # > 192 GB small nodes (§VII-C)
    "import": {"packages": ("wrathpkg",)},    # missing on default nodes
    "ulimit": {"open_files": 1_000_000},      # "open 1M files" (Table III)
}

FAILURE_TYPES = tuple(FN_REPLACEMENT) + tuple(SPEC_MODIFICATION)


@dataclass
class FailureInjector:
    """Deterministically replaces a fraction of task invocations.

    ``rate`` is the fraction of invocations selected (paper: 0.1–0.3).
    Selection is a stable hash of ``(seed, app_tag, index)`` so a retried
    task keeps its injected behaviour — "tasks destined to fail" stay
    destined to fail, as in the paper's engine.
    """

    failure_type: str
    rate: float = 0.3
    seed: int = 0
    app_tag: str = ""
    only_parents: bool = False   # for 'dependency': restrict to parent tasks
    injected: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.failure_type not in FAILURE_TYPES:
            raise ValueError(
                f"unknown failure type {self.failure_type!r}; "
                f"expected one of {FAILURE_TYPES}")

    # ------------------------------------------------------------------ #
    def _selected(self, index: int) -> bool:
        h = hashlib.sha256(
            f"{self.seed}:{self.app_tag}:{index}".encode()).digest()
        return (int.from_bytes(h[:8], "big") / 2**64) < self.rate

    def maybe(self, td: TaskDef, index: int, *, is_parent: bool = True) -> TaskDef:
        """Return ``td`` unchanged, or its injected-failure variant."""
        if self.only_parents and not is_parent:
            return td
        if not self._selected(index):
            return td
        self.injected.append(f"{td.name}[{index}]")
        if self.failure_type in FN_REPLACEMENT:
            fail_fn = FN_REPLACEMENT[self.failure_type]
            return TaskDef(fail_fn, td.name, td.resources, td.max_retries)
        overrides = SPEC_MODIFICATION[self.failure_type]
        return td.options(**overrides)

    @property
    def count(self) -> int:
        return len(self.injected)


class NoInjector:
    """Null injector: the unmodified application."""

    failure_type = "none"
    rate = 0.0
    injected: list[str] = []
    count = 0

    def maybe(self, td: TaskDef, index: int, *, is_parent: bool = True) -> TaskDef:
        return td
