"""Resilience Policy Engine (paper §V-B, Fig 2) — WRATH's retry handler.

Maps categorized failures to actions:

* **resource denylist** — components that stopped communicating (or whose
  hardware failed) are denylisted; HTCondor-style, they are removed from
  the list if they later resume heartbeating;
* **immediate termination** — non-recoverable failures terminate the task
  (and thus the application) at once to avoid wasted compute ("fail fast");
* **hierarchical retry** — recoverable failures are replanned by the
  four-rung :class:`~repro.core.retry.HierarchicalRetryPlanner`;
* **restart of failed components** — system failures restart the failed
  worker/manager before the retry (Fig 2, left branch).

The engine is installed into the DFK as ``retry_handler=`` (paper §VI-B:
"We implement the resilience module as a retry handler in Parsl").
"""
from __future__ import annotations


from repro_torch.core.categorization import Categorization, FailureCategorizationEngine
from repro_torch.core.failures import FailureReport
from repro_torch.core.retry import HierarchicalRetryPlanner
from repro_torch.core.taxonomy import DEFAULT_FTL, FailureTaxonomyLibrary
from repro_torch.engine.retry_api import Action, RetryDecision, SchedulingContext


class ResiliencePolicyEngine:
    def __init__(
        self,
        ftl: FailureTaxonomyLibrary | None = None,
        *,
        fail_fast_distinct_nodes: int = 2,
        heartbeat_resume_window: float = 0.5,
    ):
        self.ftl = ftl or DEFAULT_FTL
        self.fail_fast_distinct_nodes = fail_fast_distinct_nodes
        self.heartbeat_resume_window = heartbeat_resume_window
        self.decisions: list[dict] = []   # audit log for tests/benchmarks
        # one categorization engine + planner reused across failures
        # (rebuilt only if the engine context's cluster/monitor changes)
        self._engine: FailureCategorizationEngine | None = None
        self._planner: HierarchicalRetryPlanner | None = None

    # ------------------------------------------------------------------ #
    def _cached(self, ctx: SchedulingContext) -> tuple[
            FailureCategorizationEngine, HierarchicalRetryPlanner]:
        if self._engine is None or self._engine.monitor is not ctx.monitor:
            self._engine = FailureCategorizationEngine(
                self.ftl, ctx.monitor,
                fail_fast_distinct_nodes=self.fail_fast_distinct_nodes)
        if (self._planner is None or self._planner.cluster is not ctx.cluster
                or self._planner.monitor is not ctx.monitor):
            self._planner = HierarchicalRetryPlanner(ctx.cluster, ctx.monitor)
        return self._engine, self._planner

    def __call__(self, record, report: FailureReport,
                 ctx: SchedulingContext) -> RetryDecision:
        engine, planner = self._cached(ctx)

        self._refresh_denylist(ctx)
        cat = engine.categorize(record, report)
        decision = self._decide(record, report, cat, ctx, planner)
        self.decisions.append({
            "task_id": record.task_id,
            "failure_type": cat.entry.failure_type,
            "layer": cat.entry.layer.value,
            "resolvable": cat.resolvable,
            "action": decision.action.value,
            "rung": decision.rung,
            "reason": decision.reason,
        })
        return decision

    # ------------------------------------------------------------------ #
    def _decide(self, record, report: FailureReport, cat: Categorization,
                ctx: SchedulingContext,
                planner: HierarchicalRetryPlanner) -> RetryDecision:
        # Fig 2 step 1: non-recoverable -> immediate termination (fail fast).
        if not cat.resolvable:
            return RetryDecision(Action.FAIL,
                                 reason=f"immediate termination: {cat.explanation}")

        # Denylist malfunctioning components before planning placement.
        if cat.denylist_node and report.node:
            ctx.denylist.add(report.node)
            if ctx.monitor is not None:
                ctx.monitor.record_system_event("denylist_add", node=report.node,
                                                cause=cat.entry.failure_type)

        if record.retry_count >= record.max_retries:
            return RetryDecision(Action.FAIL, reason="retries exhausted")

        placement = planner.plan(record, report, cat, ctx.denylist,
                                 scheduler=getattr(ctx, "scheduler", None))
        if placement is None:
            return RetryDecision(
                Action.FAIL,
                reason=f"no feasible placement anywhere: {cat.explanation}")

        overrides = dict(cat.suggested_overrides)
        action = Action.RETRY
        restart = None
        if cat.restart_component:
            # Fig 2: system failures -> restart failed component, then retry
            action = Action.RESTART_AND_RETRY
            restart = cat.restart_component

        delay = cat.retry_delay_s * (2 ** record.retry_count) if cat.retry_delay_s else 0.0
        return RetryDecision(
            action,
            target_pool=placement.pool,
            target_node=placement.node,
            resource_overrides=overrides,
            restart_component=restart,
            reason=f"{cat.explanation} | {placement.reason}",
            rung=placement.rung,
            delay_s=delay,
        )

    # ------------------------------------------------------------------ #
    def _refresh_denylist(self, ctx: SchedulingContext) -> None:
        """HTCondor-style: resources resuming communication leave the list.

        Nodes the proactive sentinel *drained* are exempt: a draining node
        typically still heartbeats (the drain fired on a trend, before hard
        loss), so the resume rule would immediately re-admit it.  The
        sentinel owns the drained lifecycle and un-denylists on recovery.
        """
        if ctx.monitor is None:
            return
        # SchedulingContext.now() is the contract: clock-aware wall "now"
        # with a REAL_CLOCK fallback — no hasattr hedge, no raw time.time()
        now = ctx.now()
        beats = ctx.monitor.last_heartbeats()
        drained = getattr(ctx, "drained", None) or set()
        # sorted, not set order: denylist_remove events land in the monitor's
        # event log, and the sim plane's trace contract is "same seed =>
        # identical trace on every machine" — hash order is per-process
        for node in sorted(ctx.denylist):
            if node in drained:
                continue
            last = beats.get(node)
            if last is not None and now - last < self.heartbeat_resume_window:
                node_obj = ctx.cluster.find_node(node)
                if node_obj is not None and node_obj.healthy:
                    ctx.denylist.discard(node)
                    ctx.monitor.record_system_event("denylist_remove", node=node)


def wrath_retry_handler(**kwargs) -> ResiliencePolicyEngine:
    """Convenience factory: ``DataFlowKernel(retry_handler=wrath_retry_handler())``."""
    return ResiliencePolicyEngine(**kwargs)
