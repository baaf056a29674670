"""Task definitions, futures, and per-task bookkeeping (Application layer).

Mirrors Parsl's ``python_app`` interface: decorating a function with
``@task`` yields a :class:`TaskDef`; invoking it while a
:class:`~repro_torch.engine.dfk.DataFlowKernel` session is active returns an
:class:`AppFuture`.  Futures may be passed as arguments to other tasks to
express DAG dependencies.
"""
from __future__ import annotations

import enum
import itertools
import threading
import time
from concurrent.futures import CancelledError, Future, TimeoutError
from concurrent.futures._base import (
    CANCELLED as _CANCELLED,
    CANCELLED_AND_NOTIFIED as _CANCELLED_AND_NOTIFIED,
    FINISHED as _FINISHED,
    PENDING as _PENDING,
)
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.engine.events import REAL_CLOCK


class TaskState(enum.Enum):
    PENDING = "pending"        # waiting on dependencies
    READY = "ready"            # dependencies met, waiting for dispatch
    SCHEDULED = "scheduled"    # handed to an executor
    RUNNING = "running"        # picked up by a worker
    RETRYING = "retrying"      # failed, retry decision pending/made
    COMPLETED = "completed"
    FAILED = "failed"          # terminally failed (no retries remain / fail-fast)
    DEP_FAILED = "dep_failed"  # a parent terminally failed


@dataclass(frozen=True)
class ResourceSpec:
    """Declared resource requirements of a task (Runtime-layer contract).

    ``memory_gb`` is matched against node capacity; ``packages`` against the
    node environment; ``open_files`` against the node ulimit.  These drive
    both the failure *injection* (a node that can't satisfy the spec fails
    the task the way a real machine would) and the WRATH resource analysis
    (the categorization engine compares spec vs. node profile).
    """

    memory_gb: float = 0.5
    cpus: int = 1
    packages: tuple[str, ...] = ()
    open_files: int = 16
    # estimated duration used by straggler detection (0 = unknown)
    est_duration_s: float = 0.0

    def asdict(self) -> dict[str, Any]:
        return {
            "memory_gb": self.memory_gb,
            "cpus": self.cpus,
            "packages": list(self.packages),
            "open_files": self.open_files,
            "est_duration_s": self.est_duration_s,
        }


# One process-wide condition shared by every AppFuture.
#
# ``threading.Condition()`` costs several microseconds and ~400 bytes per
# instance (RLock, waiter deque, bound-method rebinds) — the single
# largest allocation on the submit hot path when the engine mints one
# future per task at 100k-task scale.  Future's locking discipline makes
# sharing safe: every internal method holds ``_condition`` only for
# short state transitions (callbacks and waiter notification run outside
# it), and ``concurrent.futures.wait`` acquires the conditions of all
# waited futures in sequence — with one shared *recursive* lock those
# nested acquires simply re-enter.  The one semantic caveat is spurious
# wakeups: a completion of ANY future notifies the shared condition, so
# blocking reads must re-check state in a loop — which is exactly what
# :meth:`AppFuture.result` / :meth:`AppFuture.exception` below do,
# replacing the base class's single-``wait`` versions.
_SHARED_FUTURE_CONDITION = threading.Condition()


class AppFuture(Future):
    """Future for a task invocation; hashable and usable as a dependency."""

    def __init__(self, record: "TaskRecord"):
        # mirrors Future.__init__ field-for-field (asserted by the engine
        # test suite); the super() call is skipped only to avoid building
        # a throwaway per-instance Condition (see note above)
        self._condition = _SHARED_FUTURE_CONDITION
        self._state = _PENDING
        self._result = None
        self._exception = None
        self._waiters: list = []
        self._done_callbacks: list = []
        self.record = record

    def result(self, timeout: float | None = None) -> Any:
        """As :meth:`Future.result`, robust to the shared condition's
        spurious wakeups (wait in a deadline loop, not a single pass)."""
        with self._condition:
            deadline = (time.monotonic() + timeout
                        if timeout is not None else None)
            while True:
                if self._state in (_CANCELLED, _CANCELLED_AND_NOTIFIED):
                    raise CancelledError()
                if self._state == _FINISHED:
                    return self._Future__get_result()
                if deadline is None:
                    self._condition.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError()
                    self._condition.wait(remaining)

    def exception(self, timeout: float | None = None) -> BaseException | None:
        """As :meth:`Future.exception`, spurious-wakeup robust."""
        with self._condition:
            deadline = (time.monotonic() + timeout
                        if timeout is not None else None)
            while True:
                if self._state in (_CANCELLED, _CANCELLED_AND_NOTIFIED):
                    raise CancelledError()
                if self._state == _FINISHED:
                    return self._exception
                if deadline is None:
                    self._condition.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError()
                    self._condition.wait(remaining)

    @property
    def task_id(self) -> str:
        return self.record.task_id

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<AppFuture {self.record.task_id} {self.record.state.value}>"


_task_counter = itertools.count()

# Shared empty-container defaults for TaskRecord's list/dict fields.
# Most records never retry, never get stolen, and never receive resource
# overrides, so four per-record empty containers at 100k-task scale are
# pure allocator pressure.  Every default below is a shared sentinel that
# is NEVER mutated in place — the appending sites (record_attempt,
# DataFlowKernel._record_steal, the rung-1 override merge) copy-on-write
# a private container into the field first.
_NO_DEPS: list = []
_NO_ATTEMPTS: list = []
_NO_OVERRIDES: dict = {}
_NO_STEALS: list = []


@dataclass(slots=True)
class TaskRecord:
    """Full bookkeeping for one task invocation (Framework layer state).

    ``slots=True`` matters at engine-throughput scale: a 100k-task sweep
    keeps 100k of these alive for the session, and slotted storage both
    drops the per-record ``__dict__`` allocation and keeps attribute reads
    on the dispatch/result hot paths at fixed offsets.
    """

    task_id: str
    fn: Callable[..., Any]
    name: str
    args: tuple
    kwargs: dict
    resources: ResourceSpec
    max_retries: int
    state: TaskState = TaskState.PENDING
    depends_on: list["TaskRecord"] = field(default_factory=lambda: _NO_DEPS)
    future: AppFuture | None = None
    # --- execution history ---------------------------------------------
    retry_count: int = 0
    attempts: list[dict[str, Any]] = field(
        default_factory=lambda: _NO_ATTEMPTS)
    # placement chosen by the scheduler / retry handler for next attempt
    target_pool: str | None = None
    target_node: str | None = None
    # resource overrides suggested by the resilience module (rung 1)
    resource_overrides: dict[str, Any] = field(
        default_factory=lambda: _NO_OVERRIDES)
    submit_time: float = 0.0
    # first time the DFK tried to place this task (dependencies resolved);
    # per-task TTF measures from here so dependency wait isn't billed
    first_dispatch_time: float = 0.0
    start_time: float = 0.0
    end_time: float = 0.0
    # terminal-failure wall-clock timestamp (0 = not terminally failed);
    # the per-task time-to-failure metric is terminal_time minus
    # first_dispatch_time (falling back to submit_time if never dispatched)
    terminal_time: float = 0.0
    exception: BaseException | None = None
    # cancellation (proactive plane): a worker that dequeues a record with
    # cancel_requested set drops it without executing
    cancel_requested: bool = False
    cancel_reason: str = ""
    # backup copy launched by straggler speculation / preemptive migration;
    # its result is only used if it finishes before the original
    is_speculative: bool = False
    # work-stealing migration history, one hop per steal (newest last):
    # ``{"from": victim, "to": thief, "time": wall}``.  The steal tree the
    # hierarchical response consults — a stolen task's failure must
    # categorize and propagate against the node that actually held it, not
    # the one the dispatcher originally picked
    steal_path: list[dict[str, Any]] = field(default_factory=lambda: _NO_STEALS)
    # --- hierarchy & policy plumbing (set by the DFK at submit) ---------
    # owning Workflow scope (None = engine root scope)
    workflow: Any = field(default=None, repr=False)
    # resolved per-invocation PolicyStack (task > workflow chain > engine)
    stack: Any = field(default=None, repr=False)
    # fallback pool when neither the task nor a retry decision pinned one
    # (the enclosing workflow's pool default)
    pool_default: str | None = None
    # racing copies requested by replicate(n) (launched after placement)
    replicas: int = 0
    # invocation hash (template + resolved args, which embed every parent's
    # result) computed at dispatch when a CheckpointPolicy is in the stack;
    # the key of this task's entry in the lineage-aware TaskStore
    lineage_key: str | None = None
    # engine callback fired by the worker on the RUNNING transition (only
    # set when some policy in the stack overrides on_running)
    on_running: Any = field(default=None, repr=False)
    # set (exactly once, under the DFK's _all_done condition) when the
    # engine resolves this task's future and releases its outstanding slot
    _finished: bool = field(default=False, repr=False)

    def effective_resources(self) -> ResourceSpec:
        """Resources after applying WRATH rung-1 overrides."""
        if not self.resource_overrides:
            return self.resources
        d = self.resources.asdict()
        d.update(self.resource_overrides)
        d["packages"] = tuple(d["packages"])
        return ResourceSpec(**d)

    def record_attempt(self, *, node: str, pool: str, worker: str,
                       ok: bool, error: str | None, duration: float,
                       now: float | None = None) -> None:
        if self.attempts is _NO_ATTEMPTS:
            self.attempts = []  # copy-on-write off the shared default
        self.attempts.append({
            "attempt": len(self.attempts),
            "node": node,
            "pool": pool,
            "worker": worker,
            "ok": ok,
            "error": error,
            "duration": duration,
            "time": now if now is not None else REAL_CLOCK.time(),
        })


@dataclass(frozen=True)
class TaskDef:
    """A task template produced by the :func:`task` decorator.

    Per-invocation placement and resilience are settable via
    :meth:`options`: ``pool=`` pins the target resource pool,
    ``workflow=`` routes the invocation into a specific
    :class:`~repro_torch.engine.workflow.Workflow` scope (instead of the
    thread's active scope), and ``policy=`` pushes per-call resilience
    middleware (a :class:`~repro_torch.engine.policies.ResiliencePolicy`, a
    list of them, or a bare retry-handler callable) that resolves ahead
    of the workflow's and the engine's stacks.
    """

    fn: Callable[..., Any]
    name: str
    resources: ResourceSpec
    max_retries: int | None
    pool: str | None = None
    workflow: Any = None
    policy: Any = None

    def __call__(self, *args: Any, **kwargs: Any) -> AppFuture:
        from repro_torch.engine.dfk import DataFlowKernel

        dfk = DataFlowKernel.current()
        if dfk is None and self.workflow is not None:
            dfk = self.workflow.dfk
        if dfk is None:
            raise RuntimeError(
                f"task {self.name!r} invoked outside a DataFlowKernel session; "
                "use `with DataFlowKernel(...) as dfk:`"
            )
        return dfk.submit(self, args, kwargs)

    def options(self, **overrides: Any) -> "TaskDef":
        """Return a copy with modified resources / retry / placement /
        resilience settings (``pool=``, ``workflow=``, ``policy=``).

        For sweeps, build the policied TaskDef **once** and reuse it
        (``fd = f.options(policy=replay(3)); [fd(x) for x in xs]``): the
        engine caches one resolved stack per distinct policy object and
        registers each with the engine for its lifetime — constructing a
        fresh policy inside the loop grows that registry per call (the
        same lifetime the engine already gives task records).
        """
        res = dict(self.resources.asdict())
        max_retries = overrides.pop("max_retries", self.max_retries)
        pool = overrides.pop("pool", self.pool)
        workflow = overrides.pop("workflow", self.workflow)
        policy = overrides.pop("policy", self.policy)
        if policy is not None:
            # normalize once here, not per submission: a bare callable is
            # wrapped in a stable RetryHandlerPolicy so the engine's
            # resolved-stack cache hits for every invocation of this def
            from repro_torch.engine.policies import normalize_policies
            policy = normalize_policies(policy)
        for k in list(overrides):
            if k in res:
                res[k] = overrides.pop(k)
        if overrides:
            raise TypeError(f"unknown task options: {sorted(overrides)}")
        res["packages"] = tuple(res["packages"])
        return TaskDef(self.fn, self.name, ResourceSpec(**res), max_retries,
                       pool=pool, workflow=workflow, policy=policy)


def task(
    fn: Callable[..., Any] | None = None,
    *,
    name: str | None = None,
    memory_gb: float = 0.5,
    cpus: int = 1,
    packages: tuple[str, ...] | list[str] = (),
    open_files: int = 16,
    est_duration_s: float = 0.0,
    max_retries: int | None = None,
) -> Any:
    """Declare a TBPP task (Parsl ``python_app`` analog).

    Example::

        @task(memory_gb=2, packages=("numpy",))
        def f(x):
            return x + 1
    """

    def deco(f: Callable[..., Any]) -> TaskDef:
        spec = ResourceSpec(
            memory_gb=memory_gb,
            cpus=cpus,
            packages=tuple(packages),
            open_files=open_files,
            est_duration_s=est_duration_s,
        )
        return TaskDef(f, name or f.__name__, spec, max_retries)

    if fn is not None:
        return deco(fn)
    return deco


def new_task_record(
    td: TaskDef, args: tuple, kwargs: dict, *, default_retries: int,
    now: float | None = None
) -> TaskRecord:
    tid = f"task-{next(_task_counter):06d}"
    rec = TaskRecord(
        task_id=tid,
        fn=td.fn,
        name=td.name,
        args=args,
        kwargs=kwargs,
        resources=td.resources,
        max_retries=td.max_retries if td.max_retries is not None else default_retries,
        submit_time=now if now is not None else REAL_CLOCK.time(),
    )
    rec.future = AppFuture(rec)
    return rec
