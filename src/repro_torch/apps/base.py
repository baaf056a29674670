"""Shared application harness: run an app on a cluster and collect the
paper's metrics (§VII-A): makespan, time-to-failure, overhead ratio, task /
retry / application success rates.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.engine.cluster import Cluster
from repro_torch.engine.dfk import DataFlowKernel
from repro_torch.engine.policies import normalize_policies, shim_legacy_kwargs
from repro_torch.injection.engines import NoInjector

# registry: name -> submit(injector, scale, **kw) -> list[AppFuture]
APPS: dict[str, Callable[..., list]] = {}


def register_app(name: str):
    def deco(fn):
        APPS[name] = fn
        return fn
    return deco


@dataclass
class AppRunResult:
    app: str
    success: bool
    makespan: float
    time_to_failure: float | None
    error: str | None
    stats: dict[str, float]
    task_success_rate: float
    retry_success_rate: float
    overhead_ratio: float
    injected: int = 0
    extra: dict[str, Any] = field(default_factory=dict)

    def row(self) -> dict[str, Any]:
        return {
            "app": self.app, "success": int(self.success),
            "makespan_s": round(self.makespan, 4),
            "ttf_s": round(self.time_to_failure, 4) if self.time_to_failure else "",
            "task_sr": round(self.task_success_rate, 4),
            "retry_sr": round(self.retry_success_rate, 4),
            "overhead_ratio": round(self.overhead_ratio, 6),
            "injected": self.injected,
            "error": self.error or "",
        }


def run_app(
    app: str,
    cluster: Cluster,
    *,
    policy: Any = None,
    retry_handler=None,
    monitor=None,
    injector=None,
    proactive: bool = False,
    scale: str = "small",
    default_pool: str | None = None,
    default_retries: int = 2,
    wait_timeout: float = 300.0,
    **app_kwargs: Any,
) -> AppRunResult:
    """Execute one application run and collect the §VII-A metrics.

    Resilience is configured with ``policy=`` — a
    :class:`~repro_torch.engine.policies.ResiliencePolicy`, a list of them, or
    a bare retry-handler callable.  The historical ``retry_handler=`` /
    ``proactive=`` arguments still work: they are adapted into
    equivalent stack members (appended after ``policy``'s), so both
    spellings drive identical decisions.  Each run executes inside a
    :class:`~repro_torch.engine.workflow.Workflow` scope named after the app;
    its subtree stats land in ``extra["workflow"]``.  The per-task
    time-to-failure of terminally failed tasks is reported in
    ``extra["ttf_per_task_mean"]`` for every mode, so reactive and
    proactive runs are directly comparable (fig 4's normalized TTF).
    """
    injector = injector or NoInjector()
    submit = APPS[app]
    # run_app's own retry_handler=/proactive= kwargs are part of the same
    # deprecated surface: external callers get the migration warning too
    parts = normalize_policies(policy) + shim_legacy_kwargs(
        retry_handler=retry_handler, proactive=proactive)
    t0 = time.time()
    error: str | None = None
    ttf: float | None = None
    success = True
    with DataFlowKernel(
        cluster, policy=parts, monitor=monitor,
        default_pool=default_pool, default_retries=default_retries,
    ) as dfk:
        with dfk.workflow(app) as wf:
            futures = submit(injector=injector, scale=scale, **app_kwargs)
        for f in futures:
            try:
                f.result(timeout=wait_timeout)
            except Exception as e:  # noqa: BLE001 - application failed
                if success:
                    ttf = time.time() - t0
                success = False
                error = type(e).__name__
        # drain remaining work so stats are complete
        dfk.wait_all(timeout=wait_timeout)
        makespan = time.time() - t0
        rates = dfk.success_rates()
        overhead = dfk.stats["wrath_overhead_s"] / makespan if makespan > 0 else 0.0
        stats = dict(dfk.stats)
        task_ttfs = dfk.failed_task_ttfs()
    extra: dict[str, Any] = {"workflow": wf.stats()}
    if task_ttfs:
        extra["ttf_per_task_mean"] = sum(task_ttfs) / len(task_ttfs)
        extra["failed_tasks"] = len(task_ttfs)
    return AppRunResult(
        app=app, success=success, makespan=makespan, time_to_failure=ttf,
        error=error, stats=stats,
        task_success_rate=rates["task_success_rate"],
        retry_success_rate=rates["retry_success_rate"],
        overhead_ratio=overhead,
        injected=getattr(injector, "count", 0),
        extra=extra,
    )
