"""Proactive resilience sentinel (paper §IV↔§V feedback loop).

WRATH's headline result is that the monitoring system and the resilient
module collaborate *in real time*: tasks destined to fail are identified
and terminated before they burn retries, and nodes trending toward failure
are evacuated before hard loss.  This module is that collaboration: the
:class:`ProactiveSentinel` consumes the :class:`~repro.core.monitoring.
MonitoringDatabase`'s streaming profiles and health trends and emits
proactive decisions into the engine:

* **predictive fast-fail** — a task whose (rung-1-corrected) requirements
  can never fit any live node is failed *now*, at dispatch time or between
  retries, instead of after N doomed attempts;
* **failure-streak fast-fail** — a placement-sensitive framework/application
  failure that has recurred identically on multiple nodes that *did*
  satisfy the task's requirements is declared destined-to-fail: placement
  cannot fix it, so remaining retries are cut short (the single-pool
  generalization of the categorizer's cross-pool fail-fast heuristic);
* **node drain** — a node whose heartbeat is trending toward silence or
  whose memory-growth slope projects OOM within the horizon is drained:
  placement stops (denylist), in-flight tasks are preempted/migrated, and
  the node is released back (undrain) when its trends recover.

The sentinel runs two ways at once: a *periodic event* on the DFK event
loop (:meth:`tick` — drain/undrain sweeps and the queued-task feasibility
sweep) and *inline hooks* the DFK calls on the dispatch and retry paths
(:meth:`check_dispatch`, :meth:`review_retry`) so a destined-to-fail task
never has to wait for the next tick.  All sentinel time is accounted into
``stats["wrath_overhead_s"]`` — it is resilience-module overhead.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any

from repro_torch.core.failures import Layer
from repro_torch.core.taxonomy import DEFAULT_FTL, FailureTaxonomyLibrary
from repro_torch.engine.retry_api import Action, RetryDecision


@dataclass
class ProactiveConfig:
    """Tunables of the proactive plane."""

    period: float = 0.05               # sentinel tick period (seconds)
    streak_threshold: int = 2          # identical failures on >= N adequate nodes
    oom_horizon_s: float = 1.0         # project memory trends this far ahead
    drain_silence_factor: float = 0.6  # drain at this fraction of the loss threshold
    min_profile_samples: int = 3       # trend/profile confidence floor
    enable_fast_fail: bool = True
    enable_drain: bool = True
    enable_preempt: bool = True


@dataclass
class ProactiveDecision:
    """Audit-log entry for one proactive intervention."""

    kind: str                          # fast_fail | streak_fail | drain | undrain | preempt
    reason: str
    task_id: str | None = None
    node: str | None = None
    action: Action | None = None
    # stamped from the engine's clock in ``_note`` (0.0 = never attached)
    time: float = 0.0


class ProactiveSentinel:
    """Streams monitoring data into proactive engine decisions."""

    def __init__(self, config: ProactiveConfig | None = None,
                 ftl: FailureTaxonomyLibrary | None = None):
        self.config = config or ProactiveConfig()
        self.ftl = ftl or DEFAULT_FTL
        self.decisions: list[ProactiveDecision] = []
        self.dfk: Any = None
        self._event = None
        self._last_cluster_sig: tuple | None = None
        # feasibility verdicts per (spec fingerprint) for the current
        # cluster signature — tasks of one template share a spec, so the
        # per-dispatch check is usually one dict hit.  The lock serializes
        # the sig-check/compute/store sequence across the event-loop thread
        # and worker threads (review_retry) so a verdict computed against a
        # stale node set can never be stored under the new signature.
        self._feas_cache: dict[tuple, str | None] = {}
        self._feas_sig: tuple | None = None
        self._feas_lock = threading.Lock()

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def attach(self, dfk: Any) -> "ProactiveSentinel":
        """Bind to a DataFlowKernel and start the periodic sweep."""
        self.dfk = dfk
        self._event = dfk.events.schedule_periodic(
            self.config.period, self.tick, name="proactive-sentinel")
        return self

    def detach(self) -> None:
        if self._event is not None:
            self._event.cancel()
            self._event = None
        self.dfk = None

    def _note(self, kind: str, reason: str, *, task_id: str | None = None,
              node: str | None = None, action: Action | None = None) -> None:
        decision = ProactiveDecision(
            kind=kind, reason=reason, task_id=task_id, node=node, action=action)
        if self.dfk is not None:
            decision.time = self.dfk.clock.time()
        self.decisions.append(decision)
        if self.dfk is not None and self.dfk.monitor is not None:
            self.dfk.monitor.record_system_event(
                f"proactive_{kind}", task_id=task_id, node=node, reason=reason)

    # ------------------------------------------------------------------ #
    # feasibility analysis
    # ------------------------------------------------------------------ #
    def _live_nodes(self) -> list[Any]:
        dfk = self.dfk
        return [n for n in dfk.cluster.all_nodes()
                if n.healthy and n.name not in dfk.denylist]

    def _cluster_sig(self) -> tuple:
        dfk = self.dfk
        return (tuple(sorted(dfk.denylist)),
                tuple(n.healthy for n in dfk.cluster.all_nodes()))

    _MISS = object()

    def _infeasible_reason(self, spec: Any) -> str | None:
        """Reason string if ``spec`` fits no live node; None when placeable.

        With *zero* live nodes this is not a verdict on the task (nodes may
        resume or be un-denylisted), so no fast-fail is issued.  Verdicts
        are cached per spec fingerprint: a cached *feasible* verdict is
        trusted as-is (the periodic tick invalidates the cache when the
        live-node set changes, and the sweep re-examines stranded tasks),
        while an *infeasible* verdict — the one that fails a task — is
        revalidated against the current cluster signature before acting.
        """
        key = (spec.memory_gb, spec.packages, spec.open_files)
        if self._feas_cache.get(key, self._MISS) is None:
            return None                       # feasible: lock-free dict hit
        with self._feas_lock:
            sig = self._cluster_sig()
            if sig != self._feas_sig:
                self._feas_sig = sig
                self._feas_cache.clear()
            cached = self._feas_cache.get(key, self._MISS)
            if cached is not self._MISS:
                return cached
            nodes = self._live_nodes()
            reason = None
            if nodes and not any(n.satisfies(spec)[0] for n in nodes):
                reason = (f"requirements (mem={spec.memory_gb}GB, "
                          f"pkgs={list(spec.packages)}, fds={spec.open_files}) "
                          f"fit none of {len(nodes)} live nodes")
            self._feas_cache[key] = reason
            return reason

    def _corrected_spec(self, rec: Any, overrides: dict[str, Any] | None = None) -> Any:
        """The task's requirements after rung-1 corrections (and a pending
        decision's overrides), i.e. what any future attempt would demand."""
        spec = rec.effective_resources()
        if overrides:
            d = spec.asdict()
            d.update(overrides)
            d["packages"] = tuple(d["packages"])
            spec = type(spec)(**d)
        return spec

    # ------------------------------------------------------------------ #
    # inline hooks (called by the DFK on its event thread)
    # ------------------------------------------------------------------ #
    def check_dispatch(self, rec: Any) -> str | None:
        """Predictive fast-fail at dispatch time: fail before attempt 1.

        Returns the reason string when the task should be failed now, or
        ``None`` to proceed with dispatch.
        """
        if not self.config.enable_fast_fail:
            return None
        reason = self._infeasible_reason(self._corrected_spec(rec))
        if reason is not None:
            reason = f"predictive fast-fail at dispatch: {reason}"
            self._note("fast_fail", reason, task_id=rec.task_id,
                       action=Action.FAIL)
        return reason

    def review_retry(self, rec: Any, report: Any,
                     decision: RetryDecision) -> RetryDecision:
        """Second opinion on a RETRY decision: veto retries destined to fail."""
        if not self.config.enable_fast_fail or decision.action not in (
                Action.RETRY, Action.RESTART_AND_RETRY, Action.PREEMPT,
                Action.DRAIN):
            return decision

        spec = self._corrected_spec(rec, decision.resource_overrides)
        reason = self._infeasible_reason(spec)
        if reason is not None:
            reason = f"predictive fast-fail: corrected {reason}"
            self._note("fast_fail", reason, task_id=rec.task_id,
                       action=Action.FAIL)
            self.dfk.stats["fast_fails"] += 1
            return RetryDecision(Action.FAIL, reason=reason,
                                 rung=decision.rung)

        streak = self._streak_reason(rec, report, spec)
        if streak is not None:
            self._note("streak_fail", streak, task_id=rec.task_id,
                       action=Action.FAIL)
            self.dfk.stats["fast_fails"] += 1
            return RetryDecision(Action.FAIL, reason=streak,
                                 rung=decision.rung)
        return decision

    def _streak_reason(self, rec: Any, report: Any, spec: Any) -> str | None:
        """Destined-to-fail detection for placement-sensitive failures.

        The reactive categorizer only fail-fasts when a failure recurred
        across >= 2 *pools*; on a single-pool cluster it burns the whole
        retry budget.  The streak rule drops the pool requirement but adds
        a stronger condition: every failing node must have *satisfied* the
        task's corrected requirements — nodes that should have worked,
        didn't, so no placement can fix this task.  Environment-layer
        failures are exempt (the node itself is the cause; denylist +
        placement genuinely fixes them).
        """
        monitor = self.dfk.monitor
        if monitor is None:
            return None
        entry = self.ftl.classify_exception(
            report.exception, exc_type_name=report.exception_type,
            message=report.message)
        if not entry.placement_sensitive or entry.layer not in (
                Layer.FRAMEWORK, Layer.APPLICATION):
            return None
        cluster = self.dfk.cluster
        adequate_nodes: set[str] = set()
        for f in monitor.failures_for(rec.task_id):
            if f.exception_type != report.exception_type or not f.node:
                continue
            node = cluster.find_node(f.node)
            if node is not None and node.satisfies(spec)[0]:
                adequate_nodes.add(f.node)
        if report.node:
            node = cluster.find_node(report.node)
            if node is not None and node.satisfies(spec)[0]:
                adequate_nodes.add(report.node)
        if len(adequate_nodes) >= self.config.streak_threshold:
            return (f"predictive fast-fail: {report.exception_type} recurred "
                    f"on {len(adequate_nodes)} nodes that satisfied the "
                    f"task's requirements — placement cannot fix it")
        return None

    # ------------------------------------------------------------------ #
    # periodic sweep
    # ------------------------------------------------------------------ #
    def tick(self) -> None:
        dfk = self.dfk
        if dfk is None:
            return
        t0 = time.perf_counter()
        try:
            if self.config.enable_fast_fail:
                # feasibility of an in-flight task only changes when the
                # cluster's live-node set does (submission and retry are
                # covered inline) — the O(tasks) sweep runs on transitions
                sig = self._cluster_sig()
                if sig != self._last_cluster_sig:
                    self._last_cluster_sig = sig
                    # cluster changed: drop stale feasibility verdicts so
                    # the inline fast path re-learns the new live-node set
                    with self._feas_lock:
                        if sig != self._feas_sig:
                            self._feas_sig = sig
                            self._feas_cache.clear()
                    self._sweep_infeasible_tasks()
            if self.config.enable_drain and dfk.monitor is not None:
                self._sweep_node_health()
        finally:
            dfk.stats["wrath_overhead_s"] += time.perf_counter() - t0

    def _sweep_infeasible_tasks(self) -> None:
        """Fast-fail queued tasks stranded by cluster-state changes."""
        from repro_torch.engine.task import TaskState

        dfk = self.dfk
        for tid, rec in list(dfk.tasks.items()):
            if rec.cancel_requested or rec.state not in (
                    TaskState.READY, TaskState.SCHEDULED, TaskState.RETRYING):
                continue
            reason = self._infeasible_reason(self._corrected_spec(rec))
            if reason is None:
                continue
            reason = f"predictive fast-fail (sweep): {reason}"
            self._note("fast_fail", reason, task_id=tid, action=Action.FAIL)
            dfk.fast_fail_task(tid, reason)

    def _sweep_node_health(self) -> None:
        dfk = self.dfk
        cfg = self.config
        stale_after = dfk.heartbeat_period * dfk.heartbeat_threshold
        now = dfk.clock.time()
        for node in dfk.cluster.all_nodes():
            health = dfk.monitor.node_health(node.name)
            if node.name in dfk.drained:
                # undrain when the trends that caused the drain recover
                recovered = (node.healthy
                             and health.last_heartbeat
                             and health.silent_for(now) < stale_after * 0.5
                             and not health.trending_oom(cfg.oom_horizon_s))
                if recovered:
                    self._note("undrain", "heartbeat and memory trends "
                               "recovered", node=node.name)
                    dfk.undrain_node(node.name)
                continue
            if not node.healthy or node.name in dfk.denylist:
                continue
            reason = None
            if (health.last_heartbeat
                    and health.silent_for(now) > cfg.drain_silence_factor * stale_after):
                reason = (f"heartbeat trending to silence: "
                          f"{health.silent_for(now):.3f}s since last beat "
                          f"(loss threshold {stale_after:.3f}s)")
            elif health.trending_oom(cfg.oom_horizon_s):
                reason = (f"memory trending to OOM: {health.mem_in_use_gb:.1f}GB "
                          f"in use, slope {health.mem_slope_gb_s:.2f}GB/s, "
                          f"projected {health.projected_mem_gb(cfg.oom_horizon_s):.1f}GB "
                          f"> capacity {health.mem_capacity_gb:.1f}GB")
            if reason is not None:
                self._note("drain", reason, node=node.name, action=Action.DRAIN)
                dfk.drain_node(node.name, reason=reason,
                               preempt=cfg.enable_preempt)


def make_sentinel(proactive: "bool | ProactiveConfig | ProactiveSentinel",
                  ) -> ProactiveSentinel | None:
    """Normalize the DFK's ``proactive=`` argument into a sentinel."""
    if isinstance(proactive, ProactiveSentinel):
        return proactive
    if isinstance(proactive, ProactiveConfig):
        return ProactiveSentinel(proactive)
    return ProactiveSentinel() if proactive else None
