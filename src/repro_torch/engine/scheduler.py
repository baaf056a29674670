"""Pluggable placement policies for the task, training and serving planes.

WRATH's hierarchical retry (paper §V-B) treats *where* a task runs as a
first-class, queryable decision.  This module extracts that decision out of
the executor into a :class:`Scheduler` strategy so every plane — the
DataFlowKernel dispatch path, the retry-ladder rungs, the training
supervisor's shard assignment and the serving driver's replica selection —
goes through one interface:

* :class:`RoundRobinScheduler` — baseline parity: cycles eligible nodes in
  pool order exactly as the pre-refactor ``Executor.select_node`` did;
* :class:`FeasibilityScheduler` — static resource-spec filtering (memory
  capacity, package environment, ulimits) before round-robin, so a task
  that can never run on a node is never placed there;
* :class:`LeastLoadedScheduler` — queue-depth-aware placement using the
  per-node load the executors expose (queued + in-flight tasks);
* :class:`HistoryAwareScheduler` — consults the
  :class:`~repro.core.monitoring.MonitoringDatabase` placement history
  (success rate and mean duration per node), the scheduling-time analog of
  retry rung 3: tasks gravitate to nodes where their template historically
  succeeded fast, with one exploration pass over unobserved nodes.

Select a scheduler by instance (``DataFlowKernel(scheduler=...)``) or by
name via :func:`make_scheduler` (CLI flags in ``launch/train.py`` and the
``fig6`` benchmark use the names in :data:`SCHEDULERS`).
"""
from __future__ import annotations

import itertools
import threading
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.engine.cluster import Node, ResourcePool
    from repro_torch.engine.task import TaskRecord


def node_load(node: "Node") -> float:
    """Current load of a node: queued tasks + busy workers.

    This is the per-node metric executors expose for load-aware placement;
    a slow node holds its workers busy longer and its queue backs up, so
    load alone steers traffic away from stragglers without needing to know
    node speeds.

    Both terms are O(1) reads of incrementally-maintained counters — the
    run-queue depth and the ``busy_workers`` count the pickup/release
    paths keep current — so :class:`LeastLoadedScheduler`, victim
    selection and the monitoring snapshots never rescan the worker list.
    """
    return node.task_queue.qsize() + node.busy_workers


class Scheduler:
    """Placement strategy: pick one node for a task among eligible nodes.

    ``select`` receives the *already-filtered* eligible list (healthy,
    non-denylisted, pin honoured by the caller) in pool order and returns
    the chosen node, or ``None`` to signal "no acceptable node" (the caller
    routes that through the failure path as resource starvation).
    """

    name = "base"

    def bind(self, *, cluster: Any = None, monitor: Any = None) -> "Scheduler":
        """Late-bind engine context (called by the DFK at start)."""
        return self

    def select(self, record: "TaskRecord", nodes: list["Node"], *,
               pool: "ResourcePool | None" = None) -> "Node | None":
        raise NotImplementedError

    def select_victim(self, thief: "Node", nodes: list["Node"], *,
                      pool: "ResourcePool | None" = None) -> "Node | None":
        """Pick the node an idle ``thief`` should steal queued work from.

        The work-stealing half of the placement interface: ``nodes`` is
        the already-filtered candidate list (healthy, non-denylisted,
        thief excluded) in pool order.  The default shared by every
        strategy picks the deepest run queue — the same load index
        ``select`` consumes — with ties broken by pool order (first
        wins), so victim choice is deterministic under the sim plane's
        virtual clock.  ``None`` means nothing is worth stealing.
        """
        best: "Node | None" = None
        best_depth = 0
        for n in nodes:
            depth = n.task_queue.qsize()
            if depth > best_depth:
                best, best_depth = n, depth
        return best

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} {self.name!r}>"


class RoundRobinScheduler(Scheduler):
    """Baseline parity: cycle eligible nodes in pool order.

    One independent counter per pool, starting at the first eligible node —
    the placement sequence of the pre-refactor ``Executor.select_node``
    (which kept one ``itertools.count`` per executor, i.e. per pool).
    Failure-free dispatch is node-for-node identical to the old engine;
    once WRATH rungs or speculation also select through this scheduler,
    their picks advance the same counter (by design: one rotation per
    pool), where the old code took the first feasible candidate instead.
    """

    name = "round_robin"

    def __init__(self) -> None:
        self._counters: dict[str, "itertools.count[int]"] = {}
        self._lock = threading.Lock()

    def select(self, record: "TaskRecord", nodes: list["Node"], *,
               pool: "ResourcePool | None" = None) -> "Node | None":
        if not nodes:
            return None
        key = pool.name if pool is not None else "?"
        with self._lock:
            counter = self._counters.get(key)
            if counter is None:
                # not setdefault: that would build (and discard) a fresh
                # itertools.count per placement once the key exists
                counter = self._counters[key] = itertools.count()
            return nodes[next(counter) % len(nodes)]


class FeasibilityScheduler(RoundRobinScheduler):
    """Static feasibility filter (memory, packages, ulimits) + round-robin.

    A node that can never satisfy the task's (possibly rung-1-corrected)
    resource spec is excluded up front instead of failing the task at run
    time; returns ``None`` when no node in the pool is feasible, which the
    DFK routes through the retry handler (and a WRATH handler escalates to
    rung 4, a different pool).
    """

    name = "feasibility"

    def select(self, record: "TaskRecord", nodes: list["Node"], *,
               pool: "ResourcePool | None" = None) -> "Node | None":
        spec = record.effective_resources()
        feasible = [n for n in nodes if n.satisfies(spec)[0]]
        return super().select(record, feasible, pool=pool)


class LeastLoadedScheduler(Scheduler):
    """Queue-depth-aware placement: pick the least-loaded eligible node.

    Load is :func:`node_load` (queued + in-flight); ties break by pool
    order, so an idle cluster degrades to first-fit and a busy one spreads.
    """

    name = "least_loaded"

    def select(self, record: "TaskRecord", nodes: list["Node"], *,
               pool: "ResourcePool | None" = None) -> "Node | None":
        if not nodes:
            return None
        return min(nodes, key=node_load)


class HistoryAwareScheduler(Scheduler):
    """Placement informed by the monitoring database's placement history.

    The scheduling-time analog of retry rung 3 ("retry where the task has
    historically succeeded"): for each task template the scheduler queries
    per-node success counts and mean durations.  Unobserved nodes are
    explored first (round-robin) so history accumulates; once every
    eligible node has history, nodes are restricted to the *good* set —
    success rate within ``rate_slack`` of the best and mean duration within
    ``duration_slack``× of the fastest — and the least-loaded good node
    wins, spreading traffic across the fast, reliable nodes.

    Exploration is load-gated: an unobserved node is only probed while it
    is idle, so a slow unknown node accumulates at most one probe task at
    a time instead of absorbing the whole submission burst while the fast
    nodes wait to be "discovered".

    Falls back to least-loaded when no monitor is bound.
    """

    name = "history"

    def __init__(self, monitor: Any = None, *, rate_slack: float = 0.25,
                 duration_slack: float = 1.5) -> None:
        self.monitor = monitor
        self._monitor_pinned = monitor is not None
        self.rate_slack = rate_slack
        self.duration_slack = duration_slack
        self._explore = RoundRobinScheduler()

    def bind(self, *, cluster: Any = None, monitor: Any = None) -> "Scheduler":
        # a constructor-supplied monitor is pinned; otherwise the scheduler
        # follows whichever engine most recently bound it, so one instance
        # reused across engines reads the *live* history database
        if monitor is not None and not self._monitor_pinned:
            self.monitor = monitor
        return self

    def select(self, record: "TaskRecord", nodes: list["Node"], *,
               pool: "ResourcePool | None" = None) -> "Node | None":
        if not nodes:
            return None
        if self.monitor is None:
            return min(nodes, key=node_load)
        hist = self.monitor.node_history(record.name)
        unseen = [n for n in nodes
                  if n.name not in hist or hist[n.name].total == 0]
        if unseen:
            idle_unseen = [n for n in unseen if node_load(n) < 1]
            if idle_unseen:
                return self._explore.select(record, idle_unseen, pool=pool)
            if len(unseen) == len(nodes):
                return min(nodes, key=node_load)
        seen = [n for n in nodes if n not in unseen]
        best_rate = max(hist[n.name].success_rate for n in seen)
        durations = [hist[n.name].avg_duration for n in seen
                     if hist[n.name].avg_duration > 0]
        best_dur = min(durations) if durations else 0.0
        good = [n for n in seen
                if hist[n.name].success_rate >= best_rate - self.rate_slack
                and (best_dur == 0.0 or hist[n.name].avg_duration
                     <= self.duration_slack * best_dur)]
        return min(good or seen, key=node_load)


SCHEDULERS: dict[str, type[Scheduler]] = {
    RoundRobinScheduler.name: RoundRobinScheduler,
    FeasibilityScheduler.name: FeasibilityScheduler,
    LeastLoadedScheduler.name: LeastLoadedScheduler,
    HistoryAwareScheduler.name: HistoryAwareScheduler,
}


def make_scheduler(name: str, *, monitor: Any = None) -> Scheduler:
    """Build a scheduler by name (see :data:`SCHEDULERS` for choices)."""
    try:
        cls = SCHEDULERS[name.replace("-", "_")]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; choose from {sorted(SCHEDULERS)}"
        ) from None
    sched = cls()
    return sched.bind(monitor=monitor)
