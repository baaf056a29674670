"""Executors: schedule tasks from the DFK onto node managers (paper §VI-A).

One :class:`Executor` wraps one :class:`~repro_torch.engine.cluster.ResourcePool`
(the Parsl executor ↔ resource-pool correspondence the paper's hierarchical
retry rung 4 moves tasks across).  The executor maintains the pool's node
managers, relays worker results back to the DFK, and exposes per-node load
metrics — but *node selection is delegated to an injected*
:class:`~repro_torch.engine.scheduler.Scheduler` (round-robin by default, for
baseline parity).  Placement pins from the retry handler
(``record.target_node``) are honoured before the scheduler is consulted.
"""
from __future__ import annotations

import threading
from typing import Any, Callable

from repro_torch.core.failures import PilotJobInitError
from repro_torch.engine.cluster import Node, NodeManager, ResourcePool
from repro_torch.engine.events import REAL_CLOCK, Clock
from repro_torch.engine.scheduler import RoundRobinScheduler, Scheduler, node_load
from repro_torch.engine.task import TaskRecord


class Executor:
    def __init__(
        self,
        pool: ResourcePool,
        on_result: Callable[[TaskRecord, Any, BaseException | None, Any], None],
        *,
        scheduler: Scheduler | None = None,
        heartbeat: Callable[[str, float], None] | None = None,
        denylisted: Callable[[str], bool] = lambda node: False,
        heartbeat_period: float = 0.05,
        clock: Clock | None = None,
        steal: bool = False,
        on_steal: Callable[[TaskRecord, str, str], None] | None = None,
    ):
        self.pool = pool
        self.on_result = on_result
        self.scheduler = scheduler or RoundRobinScheduler()
        self.denylisted = denylisted
        self.managers: dict[str, NodeManager] = {}
        self._lock = threading.Lock()
        self._heartbeat = heartbeat
        self._heartbeat_period = heartbeat_period
        self.clock = clock or REAL_CLOCK
        # decentralized work stealing: idle workers pull queued records off
        # loaded siblings via steal_task(); on_steal(rec, victim, thief) is
        # the DFK bookkeeping callback fired before the thief runs it
        self.steal = steal
        self.on_steal = on_steal
        self._started = False

    # -- pilot-job lifecycle ---------------------------------------------
    def _make_manager(self, node: Node) -> NodeManager:
        return NodeManager(node, self.on_result, self._heartbeat,
                           heartbeat_period=self._heartbeat_period,
                           clock=self.clock,
                           steal_source=self.steal_task if self.steal
                           else None)

    def start(self) -> None:
        failures = []
        for node in self.pool.nodes:
            mgr = self._make_manager(node)
            node.manager = mgr
            try:
                mgr.start()
                self.managers[node.name] = mgr
            except PilotJobInitError as e:
                failures.append(e)
        self._started = True
        if failures and not self.managers:
            raise PilotJobInitError(
                f"all pilot jobs failed in pool {self.pool.name}: {failures[0]}")

    def stop(self) -> None:
        for mgr in self.managers.values():
            mgr.stop()
        self._started = False

    # -- elastic membership ------------------------------------------------
    def add_node(self, node: Node) -> None:
        """A node joins the running pool: pilot job starts immediately and
        the scheduler sees it on the next placement."""
        self.pool.add_node(node)
        mgr = self._make_manager(node)
        node.manager = mgr
        if self._started:
            mgr.start()
            self.managers[node.name] = mgr

    def remove_node(self, node_name: str) -> Node | None:
        """A node leaves the running pool: pilot job stops, placement
        stops immediately.  The caller sweeps any assigned work first."""
        mgr = self.managers.pop(node_name, None)
        if mgr is not None:
            mgr.stop()
        return self.pool.remove_node(node_name)

    # -- scheduling --------------------------------------------------------
    def eligible_nodes(self, record: TaskRecord) -> list[Node]:
        """Healthy, non-denylisted nodes in pool order.

        Static feasibility (spec vs. node) is NOT applied here — baseline
        Parsl does not check it; feasibility-aware placement is the job of
        :class:`~repro_torch.engine.scheduler.FeasibilityScheduler` or of WRATH
        pinning ``target_node``/``target_pool``.
        """
        # one pass, one list: health and denylist checks fused (this runs
        # once per placement, so the extra healthy_nodes() round-trip and
        # intermediate list were pure overhead at 100k-task scale)
        denylisted = self.denylisted
        return [n for n in self.pool.nodes
                if n.healthy and not denylisted(n.name)]

    def select_node(self, record: TaskRecord) -> Node | None:
        if record.target_node:
            n = next((n for n in self.pool.nodes if n.name == record.target_node), None)
            if n is not None and n.healthy and not self.denylisted(n.name):
                return n
        return self.scheduler.select(record, self.eligible_nodes(record),
                                     pool=self.pool)

    def submit(self, record: TaskRecord) -> Node | None:
        """Queue the task on a node; returns the chosen node (None = no node)."""
        node = self.select_node(record)
        if node is None:
            return None
        for w in node.workers:
            if w.alive:
                break
        else:
            # every worker on the target died (e.g. killed mid-task) and the
            # manager's periodic respawn hasn't fired yet: respawn now so
            # the submission doesn't stall for up to a heartbeat period
            mgr = self.managers.get(node.name)
            if mgr is not None:
                mgr.restart_dead_workers()
        node.task_queue.put(record)
        return node

    # -- work stealing -----------------------------------------------------
    def steal_task(self, thief: Node) -> TaskRecord | None:
        """Steal one queued record for an idle ``thief`` node.

        Victim selection goes through the scheduler interface
        (:meth:`~repro_torch.engine.scheduler.Scheduler.select_victim`, fed by
        the same O(1) load index placement uses); the removal takes the
        *newest* stealable record off the victim's run-queue tail.  A
        record is stealable only when nothing pinned it (``target_node``
        pins cover retry-rung placement; speculative copies are excluded
        outright so a racing copy can't migrate away from the diversity
        it was launched for), no cancellation or resolution raced it, and
        the thief can statically satisfy its resource spec.  ``on_steal``
        fires before the record is handed over, so the DFK re-points its
        assignment table while the task is still invisible to the thief's
        execution path.
        """
        if not self.steal or not thief.healthy or self.denylisted(thief.name):
            return None
        victims = [n for n in self.pool.healthy_nodes()
                   if n is not thief and not self.denylisted(n.name)]
        victim = self.scheduler.select_victim(thief, victims, pool=self.pool)
        if victim is None:
            return None
        rec = victim.task_queue.steal_tail(
            lambda r: self._stealable(r, thief))
        if rec is None:
            return None
        if self.on_steal is not None:
            self.on_steal(rec, victim.name, thief.name)
        return rec

    def _stealable(self, rec: TaskRecord, thief: Node) -> bool:
        return (not rec.cancel_requested
                and not rec.is_speculative
                and rec.target_node is None
                and not (rec.future is not None and rec.future.done())
                and thief.satisfies(rec.effective_resources())[0])

    def cancel_queued(self, task_id: str, node_name: str) -> TaskRecord | None:
        """Real cancellation: pull a still-queued task off its node.

        Returns the removed record (truthy) if one was dequeued before any
        worker picked it up — callers inspect ``is_speculative`` to tell a
        racing copy from the original; ``None`` means nothing matching is
        queued (already running or finished) and the caller must use the
        migration/ignore path instead.
        """
        mgr = self.managers.get(node_name)
        if mgr is None:
            return None
        return mgr.cancel(task_id)

    # -- component restart (WRATH policy action) --------------------------
    def restart_workers(self, node_name: str) -> int:
        mgr = self.managers.get(node_name)
        if mgr is None:
            return 0
        return mgr.restart_dead_workers()

    # -- load metrics (scheduler inputs) -----------------------------------
    def loads(self) -> dict[str, float]:
        """Per-node load (queued + in-flight) — the metric the load-aware
        schedulers consume via :func:`~repro_torch.engine.scheduler.node_load`."""
        return {n.name: node_load(n) for n in self.pool.nodes}

    def queued_tasks(self) -> int:
        return sum(n.task_queue.qsize() for n in self.pool.nodes)
