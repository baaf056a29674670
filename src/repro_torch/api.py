"""``repro_torch.api`` — the task-hierarchy facade: one import for everything.

The paper's thesis is that resilience must follow the *layered structure*
of TBPP frameworks (WRATH §III–§V).  This module is that structure as an
API::

    from repro_torch.api import (
        Cluster, DataFlowKernel, Workflow, task,
        WrathPolicy, ProactivePolicy, replay, replicate,
    )

    @task(memory_gb=2)
    def f(x):
        return x + 1

    with DataFlowKernel(Cluster.paper_testbed(),
                        policy=[WrathPolicy(), ProactivePolicy()]) as dfk:
        with dfk.workflow("pipeline", pool="small-mem",
                          propagate="siblings") as wf:
            with wf.workflow("stage1", policy=replay(3)) as stage:
                futs = [f(i) for i in range(8)]
            wf.wait(timeout=30)

Three ideas, one surface:

* **Workflow scopes** (:class:`Workflow`) make the task hierarchy
  explicit: named, nestable, with per-scope defaults (pool / retries /
  node), scope-wide ``cancel()``/``wait()``/``stats()``, and failure
  propagation (``propagate="none"|"siblings"|"ancestors"``).
* **Composable resilience** (:class:`ResiliencePolicy`,
  :class:`PolicyStack`): middleware with lifecycle hooks, resolved per
  invocation (task > workflow chain > engine), first decisive
  :class:`RetryDecision` wins.
* **HPX-style combinators**: :func:`replay` (re-execute up to *n*
  times) and :func:`replicate` (race *n* copies, first ``validate``-d
  result wins), per Gupta et al.'s task-level resiliency primitives.
"""
from repro_torch.checkpoint.task_store import CheckpointPolicy, TaskStore, lineage_key
from repro_torch.core.failures import (
    DependencyError,
    FailureReport,
    TaskCancelledError,
)
from repro_torch.core.monitoring import MonitoringDatabase
from repro_torch.core.proactive import ProactiveConfig, ProactiveSentinel
from repro_torch.engine.cluster import Cluster, Node, ResourcePool
from repro_torch.engine.dfk import DataFlowKernel
from repro_torch.engine.policies import (
    PolicyStack,
    ProactivePolicy,
    ReplayPolicy,
    ReplicatePolicy,
    ReplicationError,
    ResiliencePolicy,
    RetryHandlerPolicy,
    StragglerPolicy,
    WrathPolicy,
    normalize_policies,
    replay,
    replicate,
)
from repro_torch.engine.retry_api import Action, RetryDecision, SchedulingContext
from repro_torch.engine.scheduler import SCHEDULERS, Scheduler, make_scheduler
from repro_torch.engine.task import (
    AppFuture,
    ResourceSpec,
    TaskDef,
    TaskRecord,
    TaskState,
    task,
)
from repro_torch.engine.workflow import PROPAGATE_MODES, Workflow

__all__ = [
    # engine & hierarchy
    "Cluster", "Node", "ResourcePool", "DataFlowKernel", "Workflow",
    "PROPAGATE_MODES", "task", "TaskDef", "TaskRecord", "TaskState",
    "AppFuture", "ResourceSpec",
    # resilience policies
    "ResiliencePolicy", "PolicyStack", "RetryHandlerPolicy", "WrathPolicy",
    "ProactivePolicy", "StragglerPolicy", "ReplayPolicy", "ReplicatePolicy",
    "ReplicationError", "normalize_policies", "replay", "replicate",
    # decisions & context
    "Action", "RetryDecision", "SchedulingContext", "FailureReport",
    "DependencyError", "TaskCancelledError",
    # monitoring & proactive tunables
    "MonitoringDatabase", "ProactiveConfig", "ProactiveSentinel",
    # lineage-aware checkpoint/restart plane
    "TaskStore", "CheckpointPolicy", "lineage_key",
    # placement
    "Scheduler", "SCHEDULERS", "make_scheduler",
]
