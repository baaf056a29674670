"""TBPP substrate: tasks, DAG, simulated cluster, executors, DataFlowKernel.

This is the Parsl-analog layer of the reproduction (paper §VI-A): a real,
runnable task-based parallel programming engine with futures and DAG
dependency resolution, executing on a simulated heterogeneous cluster.
Resilience plugs in as a composable :class:`PolicyStack`
(:mod:`repro_torch.engine.policies`); the task hierarchy is first-class via
:class:`Workflow` scopes (:mod:`repro_torch.engine.workflow`).  The curated
user-facing surface is re-exported by :mod:`repro_torch.api`.
"""
from repro_torch.engine.task import task, TaskDef, TaskRecord, AppFuture, TaskState, ResourceSpec
from repro_torch.engine.cluster import Cluster, ResourcePool, Node, Worker
from repro_torch.engine.events import EventLoop, ScheduledEvent
from repro_torch.engine.executor import Executor
from repro_torch.engine.scheduler import (
    SCHEDULERS,
    FeasibilityScheduler,
    HistoryAwareScheduler,
    LeastLoadedScheduler,
    RoundRobinScheduler,
    Scheduler,
    make_scheduler,
)
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
from repro_torch.engine.workflow import Workflow
from repro_torch.engine.dfk import DataFlowKernel

__all__ = [
    "task",
    "TaskDef",
    "TaskRecord",
    "AppFuture",
    "TaskState",
    "ResourceSpec",
    "Cluster",
    "ResourcePool",
    "Node",
    "Worker",
    "Executor",
    "DataFlowKernel",
    "EventLoop",
    "ScheduledEvent",
    "Scheduler",
    "RoundRobinScheduler",
    "FeasibilityScheduler",
    "LeastLoadedScheduler",
    "HistoryAwareScheduler",
    "SCHEDULERS",
    "make_scheduler",
    # task-hierarchy API
    "Workflow",
    "ResiliencePolicy",
    "PolicyStack",
    "RetryHandlerPolicy",
    "WrathPolicy",
    "ProactivePolicy",
    "StragglerPolicy",
    "ReplayPolicy",
    "ReplicatePolicy",
    "ReplicationError",
    "normalize_policies",
    "replay",
    "replicate",
]
