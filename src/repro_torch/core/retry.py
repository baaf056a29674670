"""Hierarchical retry planner (paper §V-B).

Implements the four-rung retry ladder:

1. retry according to the **resource requirements** provided by the failure
   categorization engine (corrected placement within the current pool);
2. retry on a **different node of the same resource pool**;
3. retry where the task has **historically succeeded** most frequently;
4. retry on a **different resource pool**.

The planner is feasibility-aware: a candidate node must satisfy the task's
(possibly corrected) resource requirements, must be healthy, must not be
denylisted, and — for placement-sensitive failures — must not be a node on
which this task already failed with the same error.

Each rung expresses its placement through the engine's
:class:`~repro.engine.scheduler.Scheduler` when one is provided (via
``SchedulingContext.scheduler``): the rung computes the *feasible candidate
set* and the scheduler picks within it, so retries inherit the engine's
load-/history-awareness.  Without a scheduler the first candidate in pool
order wins (legacy behaviour).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.categorization import Categorization
from repro_torch.core.failures import FailureReport
from repro_torch.engine.cluster import Cluster, Node
from repro_torch.engine.task import ResourceSpec


@dataclass
class Placement:
    pool: str
    node: str | None
    rung: int
    reason: str


class HierarchicalRetryPlanner:
    def __init__(self, cluster: Cluster, monitor=None):
        self.cluster = cluster
        self.monitor = monitor

    # ------------------------------------------------------------------ #
    def plan(self, record, report: FailureReport, cat: Categorization,
             denylist: set[str], scheduler=None) -> Placement | None:
        spec = self._effective_spec(record, cat)
        failed_nodes = {a["node"] for a in record.attempts if not a["ok"]}
        if report.node:
            failed_nodes.add(report.node)
        home_pool = report.pool or (record.attempts[-1]["pool"] if record.attempts else None)

        def ok(node: Node, *, allow_failed_nodes: bool) -> bool:
            if not node.healthy or node.name in denylist:
                return False
            if not allow_failed_nodes and node.name in failed_nodes:
                return False
            sat, _ = node.satisfies(spec)
            return sat

        def choose(candidates: list[Node], pool=None) -> Node | None:
            """Rung placement goes through the engine scheduler when bound."""
            if not candidates:
                return None
            if scheduler is not None:
                picked = scheduler.select(record, candidates, pool=pool)
                if picked is not None:
                    return picked
            return candidates[0]

        # Rung 1: corrected-requirements placement inside the home pool.
        # Meaningful when the categorizer adjusted requirements or when the
        # failure was transient contention (same node may be fine once idle).
        if home_pool and home_pool in self.cluster.pools:
            pool = self.cluster.pools[home_pool]
            allow_same = not cat.placement_sensitive
            node = choose([n for n in pool.nodes
                           if ok(n, allow_failed_nodes=allow_same)], pool)
            if node is not None:
                return Placement(home_pool, node.name, 1,
                                 "rung1: requirement-aware retry in home pool")

        # Rung 2: a different node of the same pool (even one we have not
        # profiled), skipping nodes this task already failed on.
        if home_pool and home_pool in self.cluster.pools:
            pool = self.cluster.pools[home_pool]
            node = choose([n for n in pool.nodes if n.name not in failed_nodes
                           and ok(n, allow_failed_nodes=True)], pool)
            if node is not None:
                return Placement(home_pool, node.name, 2,
                                 "rung2: different node, same pool")

        # Rung 3: historically most-successful node for this task template.
        if self.monitor is not None:
            best = self.monitor.best_historical_node(record.name, exclude=failed_nodes)
            if best:
                node = self.cluster.find_node(best)
                if node is not None and ok(node, allow_failed_nodes=False):
                    return Placement(node.pool.name if node.pool else home_pool or "?",
                                     best, 3, "rung3: historically successful node")

        # Rung 4: a different resource pool, preferring pools with the best
        # historical success rate for this task template.
        pools = [p for name, p in self.cluster.pools.items() if name != home_pool]
        if self.monitor is not None:
            hist = self.monitor.pool_history(record.name)
            pools.sort(key=lambda p: hist.get(p.name).success_rate
                       if hist.get(p.name) else 0.0, reverse=True)
        for pool in pools:
            node = choose([n for n in pool.nodes
                           if ok(n, allow_failed_nodes=False)], pool)
            if node is not None:
                return Placement(pool.name, node.name, 4,
                                 f"rung4: different pool {pool.name!r}")
        # last resort: any feasible node anywhere, even previously failed,
        # for non-placement-sensitive failures (pure re-execution semantics)
        if not cat.placement_sensitive:
            for pool in self.cluster.pools.values():
                node = choose([n for n in pool.nodes
                               if ok(n, allow_failed_nodes=True)], pool)
                if node is not None:
                    return Placement(pool.name, node.name, 1,
                                     "rung1: re-execute (transient failure)")
        return None

    # ------------------------------------------------------------------ #
    def _effective_spec(self, record, cat: Categorization) -> ResourceSpec:
        d = record.effective_resources().asdict()
        if cat.suggested_overrides:
            d.update(cat.suggested_overrides)
        if cat.required_memory_gb:
            d["memory_gb"] = max(d["memory_gb"], cat.required_memory_gb)
        if cat.required_packages:
            d["packages"] = sorted(set(d["packages"]) | set(cat.required_packages))
        d["packages"] = tuple(d["packages"])
        return ResourceSpec(**d)
