"""Retry-handler contract between the DataFlowKernel and resilience modules.

Parsl exposes a ``retry_handler`` hook on the DFK; WRATH is implemented as
such a handler (paper §VI-B).  The baseline handler reproduces Parsl's
default behaviour: always retry on the same executor, regardless of failure
type or resource availability (paper §VII-A "Baseline").
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Protocol

from repro_torch.core.failures import FailureReport
from repro_torch.engine.events import REAL_CLOCK


class Action(enum.Enum):
    RETRY = "retry"                      # re-execute (possibly elsewhere)
    FAIL = "fail"                        # terminal: fail-fast, no more retries
    RESTART_AND_RETRY = "restart_retry"  # restart failed component, then retry
    # proactive-plane actions (paper §IV↔§V feedback loop): emitted by the
    # ProactiveSentinel and honoured by the DFK; handlers may return them too
    PREEMPT = "preempt"                  # migrate off the current node now
    DRAIN = "drain"                      # drain the node, then retry elsewhere


@dataclass
class RetryDecision:
    action: Action
    # placement for the retry (None = scheduler default)
    target_pool: str | None = None
    target_node: str | None = None
    # rung-1 resource overrides (e.g. raise memory_gb after OOM analysis)
    resource_overrides: dict[str, Any] = field(default_factory=dict)
    # component to restart for RESTART_AND_RETRY ("worker:<node>", "manager:<node>")
    restart_component: str | None = None
    reason: str = ""
    # which retry-ladder rung produced this decision (for metrics; 0=none)
    rung: int = 0
    # dispatch delay (exponential backoff for transient contention)
    delay_s: float = 0.0


class RetryHandler(Protocol):
    def __call__(self, record: Any, report: FailureReport, context: "SchedulingContext") -> RetryDecision: ...


@dataclass
class SchedulingContext:
    """What a retry handler may inspect: the cluster view + history access.

    ``scheduler`` is the engine's active placement policy
    (:class:`repro.engine.scheduler.Scheduler`); handlers and the retry
    planner use it to choose among equally-valid rung candidates, so e.g. a
    least-loaded engine also load-balances its retries.  ``None`` preserves
    the legacy first-feasible-candidate behaviour.
    """

    cluster: Any                      # repro.engine.cluster.Cluster
    monitor: Any                      # repro.core.monitoring.MonitoringDatabase | None
    denylist: set[str] = field(default_factory=set)   # node names
    default_pool: str | None = None
    scheduler: Any = None             # repro.engine.scheduler.Scheduler | None
    # nodes denylisted by the proactive sentinel's drain (subset of
    # denylist); the policy engine's heartbeat-resume rule must not
    # un-denylist these — the sentinel owns their lifecycle (undrain)
    drained: set[str] = field(default_factory=set)
    # the engine's time source (repro.engine.events.Clock | None).
    # Handlers comparing "now" against monitor timestamps (heartbeat
    # recency, backoff windows) must read it from here so they stay
    # correct on a virtual clock.
    clock: Any = None

    def now(self) -> float:
        """Wall-clock "now" on the engine's clock (real-time fallback)."""
        clock = self.clock if self.clock is not None else REAL_CLOCK
        return clock.time()


def baseline_retry_handler(record, report: FailureReport, ctx: SchedulingContext) -> RetryDecision:
    """Parsl default: uniform retry on the same executor until retries run
    out.  Dependency failures are not retried (Parsl dep_fail semantics)."""
    from repro_torch.core.failures import DependencyError

    if isinstance(report.exception, DependencyError):
        return RetryDecision(Action.FAIL, reason="dependency failed (dep_fail)")
    if record.retry_count >= record.max_retries:
        return RetryDecision(Action.FAIL, reason="retries exhausted")
    return RetryDecision(
        Action.RETRY,
        target_pool=report.pool or ctx.default_pool,
        reason="baseline: retry on same executor",
    )
