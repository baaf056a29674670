"""DataFlowKernel: the central manager of the TBPP framework (paper §VI-A).

Responsibilities mirror Parsl's DFK: dependency resolution (DAG), task
scheduling onto executors, task status tracking — and the *retry handler*
hook through which WRATH's resilience module is attached (paper §VI-B).

Since the event-driven refactor the DFK is built on two injected
subsystems:

* a **scheduler** (:mod:`repro_torch.engine.scheduler`) that owns every
  placement decision.  ``DataFlowKernel(scheduler=...)`` accepts any of
  the four strategies (round-robin, feasibility, least-loaded,
  history-aware); the default :class:`RoundRobinScheduler` reproduces the
  pre-refactor dispatch placements (failure-free runs are node-for-node
  identical).  The same scheduler instance is shared with the executors
  (per-pool dispatch) and the retry planner (rung candidate selection), so
  load- and history-awareness apply uniformly;
* an **event loop** (:mod:`repro_torch.engine.events`) through which every
  dispatch, delayed retry, heartbeat check and straggler check flows as a
  time-ordered event — no per-retry ``threading.Timer``, no polling
  watcher thread.

The proactive refactor adds a third: an optional **proactive sentinel**
(:mod:`repro_torch.core.proactive`, enabled with ``proactive=True``) that closes
the paper's monitoring↔resilience feedback loop.  It reviews dispatches
and retry decisions inline (predictive fast-fail) and runs a periodic
health sweep (node drain / preemptive migration) — backed by a real task
**cancellation path**: :meth:`cancel_task` pulls still-queued records off
node queues, :meth:`preempt_task` migrates queued or running tasks away
from a node, and :meth:`drain_node` evacuates a node before hard loss.

The framework-side watchers are periodic events:

* a **heartbeat watcher** that declares nodes lost when their system
  monitoring agent goes silent (paper §IV), failing in-flight tasks with
  :class:`HardwareShutdownError` so they flow through the retry handler;
* a **straggler watcher** that (optionally) speculatively re-executes
  tasks running far beyond their expected duration on a different node.
  The expected duration is *profile-derived* — the p95 of the template's
  observed durations from the monitoring database — with the static
  user-supplied ``est_duration_s`` as fallback while history accumulates.

Batched submission with backpressure is available via :meth:`map`: the
number of outstanding (submitted, unfinished) tasks is capped so a large
sweep cannot flood the executors' queues.

Since the task-hierarchy API redesign, resilience is configured through a
**composable policy stack** (:mod:`repro_torch.engine.policies`): pass
``policy=`` a :class:`~repro_torch.engine.policies.ResiliencePolicy` (or a list
of them) and every lifecycle transition — submit, dispatch, running,
failure, result, periodic tick — flows through the stack, with the first
decisive :class:`RetryDecision` winning and Parsl's baseline retry as the
terminal fallback.  Stacks resolve per task invocation: per-call policies
(``TaskDef.options(policy=...)``) run first, then the enclosing
:class:`~repro_torch.engine.workflow.Workflow` chain, then the engine stack.
The historical kwargs — ``retry_handler=``, ``proactive=``,
``speculative_execution=`` — still work but are deprecated shims that
adapt into single-element policy stacks.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Iterable

from repro_torch.core.failures import (
    DependencyError,
    FailureReport,
    HardwareShutdownError,
    ResourceStarvationError,
    TaskCancelledError,
)
from repro_torch.engine.cluster import Cluster
from repro_torch.engine.events import REAL_CLOCK, Clock, EventLoop
from repro_torch.engine.executor import Executor
from repro_torch.engine.policies import (
    PolicyStack,
    ProactivePolicy,
    ResiliencePolicy,
    normalize_policies,
    shim_legacy_kwargs,
)
from repro_torch.engine.retry_api import (
    Action,
    RetryDecision,
    SchedulingContext,
)
from repro_torch.engine.scheduler import RoundRobinScheduler, Scheduler
from repro_torch.engine.task import AppFuture, TaskDef, TaskRecord, TaskState, new_task_record
from repro_torch.engine.workflow import Workflow


# map() internals: distinguish "no positional args" and "iterator ran dry"
# from legitimate user values (None, (), ...)
_NO_ARGS = object()
_EXHAUSTED = object()


def _iter_futures(obj: Any):
    if isinstance(obj, AppFuture):
        yield obj
    elif isinstance(obj, (list, tuple, set)):
        for x in obj:
            yield from _iter_futures(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _iter_futures(x)


def _resolve(obj: Any):
    """Replace finished AppFutures inside args with their results."""
    if isinstance(obj, AppFuture):
        return obj.result(timeout=0)
    if isinstance(obj, list):
        return [_resolve(x) for x in obj]
    if isinstance(obj, tuple):
        return tuple(_resolve(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _resolve(v) for k, v in obj.items()}
    return obj


class DataFlowKernel:
    _current: "DataFlowKernel | None" = None

    def __init__(
        self,
        cluster: Cluster,
        *,
        policy: Any = None,
        checkpoint: Any = None,          # TaskStore | CheckpointPolicy | path
        retry_handler=None,              # deprecated: use policy=
        monitor=None,
        scheduler: Scheduler | None = None,
        work_stealing: bool = False,
        proactive: Any = False,          # deprecated: use policy=[ProactivePolicy()]
        default_retries: int = 2,
        default_pool: str | None = None,
        heartbeat_period: float = 0.05,
        heartbeat_threshold: float = 5.0,   # missed periods before node is lost
        speculative_execution: bool = False,  # deprecated: StragglerPolicy
        straggler_factor: float = 3.0,
        map_backpressure: int | None = None,
        clock: Clock | None = None,
        executor_factory: Any = None,
        _warn_legacy: bool = True,
    ):
        self.cluster = cluster
        self.monitor = monitor
        # injected time source: every timer, heartbeat check, straggler
        # sweep, retry delay and TTF stamp flows through this clock.  A
        # virtual clock (repro_torch.sim.VirtualClock) runs the whole engine in
        # deterministic inline mode — see EventLoop.run_until.
        self.clock = clock or REAL_CLOCK
        # executor construction hook: (dfk, pool) -> Executor.  The sim
        # plane swaps in SimExecutor so tasks execute inline on the event
        # loop instead of on worker threads.
        self._executor_factory = executor_factory
        self.scheduler = scheduler or RoundRobinScheduler()
        # decentralized work stealing: idle nodes pull the newest queued
        # record off the most-loaded sibling in their pool (victim picked
        # through Scheduler.select_victim).  Off by default: stealing
        # intentionally departs from the baseline round-robin placement
        # parity, and pinned/speculative records are never stolen.
        self.work_stealing = work_stealing
        # canonical resilience configuration: an ordered policy stack.  The
        # deprecated kwargs adapt into equivalent single-element stacks
        # appended after any explicitly-passed policies; checkpoint= joins
        # last so result validators ahead of it veto a commit.
        ckpt_parts: tuple = ()
        if checkpoint is not None:
            from repro_torch.checkpoint.task_store import as_checkpoint_policy
            ckpt_parts = (as_checkpoint_policy(checkpoint),)
        self.policies = PolicyStack(
            normalize_policies(policy)
            + shim_legacy_kwargs(
                retry_handler=retry_handler, proactive=proactive,
                speculative_execution=speculative_execution,
                straggler_factor=straggler_factor, warn=_warn_legacy)
            + ckpt_parts,
            on_error=self._on_event_error)
        # engine-level task-output store (None when not checkpointing):
        # the lineage-aware memoization plane tests and tooling introspect
        self.task_store = next(
            (p.store for p in self.policies._checkpointers
             if getattr(p, "store", None) is not None), None)
        # legacy introspection points: the adapted handler/sentinel (tests
        # and tooling read dfk.sentinel.decisions)
        self.retry_handler = retry_handler
        self.sentinel = next(
            (p.sentinel for p in self.policies if isinstance(p, ProactivePolicy)),
            None)
        self.default_retries = default_retries
        self.default_pool = default_pool or next(iter(cluster.pools))
        self.heartbeat_period = heartbeat_period
        self.heartbeat_threshold = heartbeat_threshold
        self.speculative_execution = speculative_execution
        self.straggler_factor = straggler_factor
        self.map_backpressure = map_backpressure

        self.tasks: dict[str, TaskRecord] = {}
        self.executors: dict[str, Executor] = {}
        self.denylist: set[str] = set()
        self.drained: set[str] = set()   # sentinel-drained subset of denylist
        self._assignment: dict[str, tuple[str, str]] = {}  # task -> (pool, node)
        self._speculated: set[str] = set()
        # task -> [(racing copy record, node it was queued on), ...]; every
        # losing attempt is cancelled when the winner resolves the task
        self._spec_copies: dict[str, list[tuple[TaskRecord, str | None]]] = {}
        self._replicated: set[str] = set()  # tasks whose replicas launched
        # task -> number of racing copies still in flight; a terminal
        # failure of the original DEFERS while copies remain (a healthy
        # replica may still win — HPX replicate semantics), resolving with
        # the stashed error only once every attempt has failed
        self._live_copies: dict[str, int] = {}
        self._pending_terminal: dict[str, BaseException] = {}
        self._done_first: dict[str, bool] = {}
        self._resume_logged: set[str] = set()  # nodes whose resume was recorded
        self._workflows: list[Workflow] = []
        # per-call policies (TaskDef.options(policy=)) bound to this engine;
        # keyed by id so bind/unbind runs once per object.  Tickers among
        # them are tracked separately so the 50 ms policy tick stays
        # O(tickers), not O(all policies ever used)
        self._adhoc_bound: dict[int, ResiliencePolicy] = {}
        self._adhoc_tickers: list[ResiliencePolicy] = []
        # ticker policies contributed by workflow scopes, collected
        # incrementally at registration so the 50 ms tick never rescans
        # the (append-only) workflow list
        self._workflow_tickers: list[ResiliencePolicy] = []
        self._ticker_ids: set[int] = set()
        # resolved-stack cache keyed by the identity tuple of the extra
        # (task + workflow) parts: a policied workflow's map() submits
        # thousands of tasks but builds one PolicyStack.  Cached stacks
        # hold strong refs to their policies, keeping the ids stable.
        self._stack_cache: dict[tuple, PolicyStack] = {}
        self._started = False
        self._shutting_down = False

        # LOCKING DISCIPLINE: _lock guards the bookkeeping tables (tasks,
        # stats, assignment, race/copy state) and nothing else.  Policy
        # hooks, future resolution (set_result / set_exception and the
        # done-callbacks they fire) and monitor writes always run OUTSIDE
        # it — a callback that re-enters the engine (submit, cancel_task,
        # preempt_task) while the lock is held would deadlock non-reentrant
        # callers and inflates the critical section for every thread.
        self._lock = threading.RLock()
        self._all_done = threading.Condition(self._lock)
        self._outstanding = 0
        # batched dispatch: ready submissions land here and one "dispatch"
        # drain event places the whole burst — one event-loop entry and one
        # bookkeeping lock acquisition per batch instead of per task
        self._dispatch_queue: deque[TaskRecord] = deque()
        self._drain_scheduled = False
        self._dispatch_lock = threading.Lock()
        self.events = EventLoop(name="dfk-events", on_error=self._on_event_error,
                                clock=self.clock)

        self.stats: dict[str, float] = {
            "submitted": 0, "completed": 0, "failed": 0, "dep_failed": 0,
            "retries": 0, "retry_success": 0, "wrath_overhead_s": 0.0,
            "restarts": 0, "speculations": 0, "start_time": 0.0,
            # proactive plane
            "fast_fails": 0, "preemptions": 0, "drains": 0, "cancelled": 0,
            # replicate(n) racing copies
            "replicas": 0,
            # lineage-aware checkpoint plane: tasks resolved from the store
            "memo_hits": 0,
            # decentralized work stealing: queued records migrated to an
            # idle node (one count per hop)
            "steals": 0,
            # elastic cluster membership
            "joins": 0, "leaves": 0,
        }

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def __enter__(self) -> "DataFlowKernel":
        self.start()
        DataFlowKernel._current = self
        return self

    def __exit__(self, *exc) -> None:
        DataFlowKernel._current = None
        self.shutdown()

    @classmethod
    def current(cls) -> "DataFlowKernel | None":
        return cls._current

    def _make_executor(self, pool) -> Executor:
        hb = self.monitor.heartbeat if self.monitor is not None else None
        return Executor(
            pool, self._on_result, scheduler=self.scheduler, heartbeat=hb,
            # the live set's bound __contains__: same live view as a
            # lambda, minus a Python frame per check on the dispatch path
            # (the set is only ever mutated in place, never rebound)
            denylisted=self.denylist.__contains__,
            heartbeat_period=self.heartbeat_period, clock=self.clock,
            steal=self.work_stealing, on_steal=self._record_steal)

    def start(self) -> None:
        self.stats["start_time"] = self.clock.time()
        self.scheduler.bind(cluster=self.cluster, monitor=self.monitor)
        factory = self._executor_factory or DataFlowKernel._make_executor
        for name, pool in self.cluster.pools.items():
            ex = factory(self, pool)
            ex.start()
            self.executors[name] = ex
        self.events.start()
        self.events.schedule_periodic(
            self.heartbeat_period, self._check_heartbeats, name="heartbeat-check")
        self.events.schedule_periodic(
            self.heartbeat_period, self._policy_tick, name="policy-tick")
        self._started = True
        self.policies.bind(self)
        for wf in list(self._workflows):
            for p in wf.policies:
                p.bind(self)

    def shutdown(self) -> None:
        self._shutting_down = True
        self.policies.unbind()
        for wf in list(self._workflows):
            for p in wf.policies:
                p.unbind()
        for p in self._adhoc_bound.values():
            p.unbind()
        self.events.stop()
        # resolve every future the engine can never run again, so no
        # AppFuture.result() call hangs on a dead kernel.  RUNNING tasks
        # are left alone: their worker finishes the in-flight fn and
        # delivers the real result (a post-shutdown *failure* is made
        # terminal by _route_failure's shutting-down guard, so those
        # futures resolve too instead of waiting on a stopped event loop).
        # Under a virtual clock there are no worker threads — a RUNNING
        # task's completion is an event on the now-stopped loop, so it can
        # never deliver; those futures must be resolved here too.
        pending = [rec for rec in list(self.tasks.values())
                   if rec.future is not None and not rec.future.done()
                   and (rec.state is not TaskState.RUNNING
                        or self.clock.virtual)]
        for rec in pending:
            self.cancel_task(
                rec.task_id, reason="DataFlowKernel shut down",
                exc=RuntimeError(
                    f"DataFlowKernel shut down while task {rec.task_id} "
                    f"({rec.name}) was {rec.state.value}"))
        # terminal failures stashed while racing copies were in flight:
        # copies that never got to run can no longer save the task
        for task_id, err in list(self._pending_terminal.items()):
            self._pending_terminal.pop(task_id, None)
            rec = self.tasks.get(task_id)
            if rec is not None:
                self._fail_terminally(rec, err)
        for ex in self.executors.values():
            ex.stop()
        self._started = False

    def workflow(self, name: str, **kwargs: Any) -> Workflow:
        """Create a top-level :class:`Workflow` scope on this kernel."""
        return Workflow(name, dfk=self, **kwargs)

    def _register_workflow(self, wf: Workflow) -> None:
        self._workflows.append(wf)
        for p in wf.policies:
            if (type(p).on_tick is not ResiliencePolicy.on_tick
                    and id(p) not in self._ticker_ids):
                self._ticker_ids.add(id(p))
                self._workflow_tickers.append(p)
        if self._started:
            for p in wf.policies:
                p.bind(self)

    def _policy_tick(self) -> None:
        """Periodic ``on_tick`` fan-out over engine + workflow policies."""
        tickers = list(self.policies._tickers)
        seen = {id(p) for p in tickers}
        for p in (*self._workflow_tickers, *self._adhoc_tickers):
            if id(p) not in seen:
                seen.add(id(p))
                tickers.append(p)
        if not tickers:
            return
        t0 = time.perf_counter()
        ctx = self.context()
        for p in tickers:
            try:
                p.on_tick(ctx)
            except Exception as err:  # noqa: BLE001 - a policy bug must not kill the tick
                self._on_event_error("policy-tick", err)
        self.stats["wrath_overhead_s"] += time.perf_counter() - t0

    def context(self) -> SchedulingContext:
        return SchedulingContext(
            cluster=self.cluster, monitor=self.monitor,
            denylist=self.denylist, default_pool=self.default_pool,
            scheduler=self.scheduler, drained=self.drained,
            clock=self.clock)

    def _on_event_error(self, event_name: str, err: BaseException) -> None:
        """Swallowed watcher/callback exceptions stay visible as events."""
        if self.monitor is not None:
            self.monitor.record_system_event(
                "event_error", event=event_name, error=type(err).__name__,
                message=str(err))

    # ------------------------------------------------------------------ #
    # submission & dependency resolution
    # ------------------------------------------------------------------ #
    def _resolve_stack(self, td: TaskDef, wf: Workflow | None) -> PolicyStack:
        """Per-invocation policy stack: task > workflow chain > engine."""
        parts = normalize_policies(td.policy)
        if wf is not None:
            parts = parts + wf.chain_policies()
        if not parts:
            return self.policies          # common case: share the engine stack
        key = tuple(id(p) for p in parts)
        with self._lock:
            cached = self._stack_cache.get(key)
        if cached is not None:
            return cached
        # per-call policies must participate in the engine lifecycle like
        # engine/workflow ones: bind them (idempotent) and register any
        # tickers so the periodic policy tick reaches them too.  bind() is
        # policy code — it runs outside _lock; the registry mutations
        # themselves are guarded so concurrent submitters can't corrupt it
        for p in parts:
            with self._lock:
                fresh = id(p) not in self._adhoc_bound
                if fresh:
                    self._adhoc_bound[id(p)] = p
                    if type(p).on_tick is not ResiliencePolicy.on_tick:
                        self._adhoc_tickers.append(p)
            if fresh:
                p.bind(self)
        stack = PolicyStack(parts + self.policies.policies,
                            on_error=self._on_event_error)
        with self._lock:
            return self._stack_cache.setdefault(key, stack)

    def submit(self, td: TaskDef, args: tuple, kwargs: dict) -> AppFuture:
        if self._shutting_down:
            # PR-3 contract: shutdown resolves every pending future with
            # RuntimeError — a post-shutdown submit must not hang either.
            # The task is never registered (no _outstanding increment, no
            # event on the stopped loop); its future resolves immediately.
            rec = new_task_record(td, args, kwargs, default_retries=0,
                                  now=self.clock.time())
            rec.state = TaskState.FAILED
            rec.exception = RuntimeError(
                f"DataFlowKernel is shut down: cannot submit task "
                f"{td.name!r}")
            rec.future.set_exception(rec.exception)  # type: ignore[union-attr]
            return rec.future  # type: ignore[return-value]
        # hierarchy resolution: an explicit options(workflow=...) pin wins,
        # else the thread's innermost active scope (None = engine root)
        wf = td.workflow if td.workflow is not None else Workflow.current()
        default_retries = self.default_retries
        if td.max_retries is None and wf is not None:
            wf_retries = wf.effective_retries()
            if wf_retries is not None:
                default_retries = wf_retries
        rec = new_task_record(td, args, kwargs, default_retries=default_retries,
                              now=self.clock.time())
        rec.workflow = wf
        rec.pool_default = td.pool or (wf.effective_pool() if wf else None)
        if wf is not None and rec.target_node is None:
            rec.target_node = wf.effective_node()
        rec.stack = self._resolve_stack(td, wf)
        if rec.stack.wants_running:
            rec.on_running = self._notify_running
        # dependency scan: the generic walk handles futures nested inside
        # containers, but the overwhelmingly common sweep shape — scalar
        # positional args, no kwargs — needs only one isinstance per arg
        # to prove there is nothing to walk
        deps: Any = ()
        if kwargs or any(isinstance(a, (AppFuture, list, tuple, set, dict))
                         for a in args):
            deps = list({f.task_id: f
                         for f in _iter_futures((args, kwargs))}.values())
            if deps:
                rec.depends_on = [f.record for f in deps]
        with self._lock:
            self.tasks[rec.task_id] = rec
            self.stats["submitted"] += 1
            self._outstanding += 1
            pending = [f for f in deps if not f.done()] if deps else ()
            if not pending:
                # claim READY inline under the registration lock (no second
                # acquisition): dependency callbacks aren't registered yet,
                # so nothing else can race the PENDING->READY transition
                rec.state = TaskState.READY
        try:
            if wf is not None:
                wf._add(rec)
            if self.monitor is not None:
                scope = {"workflow": wf.path} if wf is not None else {}
                self.monitor.record_task_event(
                    rec.task_id, "submitted", name=rec.name,
                    resources=rec.resources.asdict(), **scope)
            if wf is not None and wf.cancelled:
                # submissions into a cancelled scope resolve immediately
                self.cancel_task(rec.task_id,
                                 reason=f"workflow {wf.path!r} is cancelled")
                return rec.future  # type: ignore[return-value]
            if rec.stack._submitters:
                t0 = time.perf_counter()
                rec.stack.on_submit(rec, self.context())
                self.stats["wrath_overhead_s"] += time.perf_counter() - t0
            if not pending:
                self._enqueue_dispatch(rec)
            else:
                for f in pending:
                    f.add_done_callback(lambda _f, r=rec: self._dep_done(r))
        except BaseException as sub_err:
            # a submission that dies after registering must not leave a
            # phantom outstanding task behind (wait_all would never return
            # and a map() sweep would lose capacity forever)
            with self._all_done:
                if not rec._finished:
                    self.tasks.pop(rec.task_id, None)
                    self.stats["submitted"] -= 1
                    self._outstanding -= 1
                    if self._outstanding <= 0:
                        self._all_done.notify_all()
            # the record may already sit in a workflow scope's member list:
            # resolve its future so Workflow.wait()/futures() can't hang on
            # a task the engine disowned
            if rec.future is not None and not rec.future.done():
                rec.state = TaskState.FAILED
                rec.exception = RuntimeError(
                    f"submission of task {rec.task_id} ({rec.name}) "
                    f"failed: {sub_err!r}")
                rec.future.set_exception(rec.exception)
            raise
        return rec.future  # type: ignore[return-value]

    def _notify_running(self, rec: TaskRecord) -> None:
        """Worker RUNNING-transition callback -> policy ``on_running``."""
        stack = rec.stack
        if stack is not None:
            stack.on_running(rec, self.context())

    def map(self, td: TaskDef, arg_iter: Iterable[Any] | None = None, *,
            kwargs_iter: Iterable[dict] | None = None, unpack: bool = True,
            max_outstanding: int | None = None) -> list[AppFuture]:
        """Batched submission with an outstanding-task backpressure cap.

        Each element of ``arg_iter`` becomes one task invocation.  With
        ``unpack=True`` (the historical default) a *tuple* element is
        splatted as positional args; with ``unpack=False`` every element
        — tuples included — is passed as the single positional argument.
        ``kwargs_iter`` supplies per-invocation keyword arguments: a
        parallel iterable of dicts (zipped 1:1 with ``arg_iter``; lengths
        must match), or the sole iterable when ``arg_iter`` is omitted.

        At most ``max_outstanding`` (default: the DFK's
        ``map_backpressure``; ``None`` = unlimited) tasks from this map
        are outstanding — submitted but unfinished — at once; further
        submissions block until earlier tasks finish, bounding executor
        queue depth for large sweeps.
        """
        if arg_iter is None and kwargs_iter is None:
            raise ValueError("map() needs arg_iter and/or kwargs_iter")
        cap = max_outstanding if max_outstanding is not None else self.map_backpressure
        if cap is not None and cap < 1:
            raise ValueError(f"max_outstanding must be >= 1, got {cap}")
        gate = threading.BoundedSemaphore(cap) if cap else None

        def invocations():
            if kwargs_iter is None:
                for args in arg_iter:  # type: ignore[union-attr]
                    yield args, {}
            elif arg_iter is None:
                for kwargs in kwargs_iter:
                    yield _NO_ARGS, kwargs
            else:
                args_it, kw_it = iter(arg_iter), iter(kwargs_iter)
                while True:
                    a = next(args_it, _EXHAUSTED)
                    k = next(kw_it, _EXHAUSTED)
                    if a is _EXHAUSTED and k is _EXHAUSTED:
                        return
                    if a is _EXHAUSTED or k is _EXHAUSTED:
                        raise ValueError(
                            "map(): arg_iter and kwargs_iter lengths differ")
                    yield a, k

        futures: list[AppFuture] = []
        for args, kwargs in invocations():
            if args is _NO_ARGS:
                args = ()
            elif unpack and isinstance(args, tuple):
                pass                      # tuple-splat (historical default)
            else:
                args = (args,)
            if not isinstance(kwargs, dict):
                raise TypeError(
                    f"kwargs_iter elements must be dicts, got {type(kwargs).__name__}")
            if gate is not None:
                if self.clock.virtual:
                    # inline mode: a blocking acquire would deadlock (this
                    # thread is the one that resolves tasks) — drive the
                    # loop until a slot frees up instead.  The memoized
                    # predicate acquires at most once, so a run that ends
                    # without a slot (stopped loop, exhausted horizon) is
                    # detected instead of leaking a phantom release later.
                    held = {"ok": False}

                    def _try_acquire() -> bool:
                        if not held["ok"]:
                            held["ok"] = gate.acquire(blocking=False)
                        return held["ok"]

                    if not self._drive_until(_try_acquire):
                        raise RuntimeError(
                            "map(): backpressure slot never freed (engine "
                            "stopped or virtual horizon exhausted)")
                else:
                    gate.acquire()
                try:
                    fut = self.submit(td, args, dict(kwargs))
                except BaseException:
                    # a failed submission must give its slot back — leaking
                    # it would strand the rest of the sweep at cap-1 (and a
                    # later failure would eventually deadlock the map)
                    gate.release()
                    raise
                fut.add_done_callback(lambda _f, g=gate: g.release())
            else:
                fut = self.submit(td, args, dict(kwargs))
            futures.append(fut)
        return futures

    def _dep_done(self, rec: TaskRecord) -> None:
        if not self._claim_ready(rec):
            return
        self._enqueue_dispatch(rec)

    def _claim_ready(self, rec: TaskRecord) -> bool:
        """Atomically move PENDING -> READY once all parents resolved.

        Multiple parent futures may complete concurrently and each fires a
        callback; exactly one caller wins the claim, preventing duplicate
        dispatch (and duplicate execution) of multi-parent tasks.
        """
        with self._lock:
            if rec.state is not TaskState.PENDING:
                return False
            if not all(p.future.done() for p in rec.depends_on):  # type: ignore[union-attr]
                return False
            rec.state = TaskState.READY
            return True

    def _enqueue_dispatch(self, rec: TaskRecord) -> None:
        """Queue a READY record for the next batched dispatch drain.

        At most one drain event is in flight regardless of burst size, so
        a 100k-task submission storm costs one event-loop entry per batch
        instead of one per task.
        """
        with self._dispatch_lock:
            self._dispatch_queue.append(rec)
            if self._drain_scheduled:
                return
            self._drain_scheduled = True
        self.events.call_soon(self._drain_dispatches, name="dispatch")

    def _drain_dispatches(self) -> None:
        """The dispatch event: place every queued submission in one pass.

        Successful placements collect into a batch whose SCHEDULED
        transition and assignment-table writes happen under one lock
        acquisition (:meth:`_bookkeep_placements`); records that route to
        a failure/memo path bookkeep themselves.  Loops until the queue is
        empty, so records becoming READY mid-drain (memo hits resolving a
        child's last dependency, policy-hook submissions) dispatch in this
        same event rather than scheduling another.
        """
        while True:
            with self._dispatch_lock:
                if not self._dispatch_queue:
                    self._drain_scheduled = False
                    return
                batch = list(self._dispatch_queue)
                self._dispatch_queue.clear()
            placed = []
            for rec in batch:
                out = self._maybe_dispatch(rec)
                if out is not None:
                    placed.append((rec, *out))
            if placed:
                self._bookkeep_placements(placed)

    def _maybe_dispatch(self, rec: TaskRecord) -> tuple[str, Any, int] | None:
        """Dispatch a READY-claimed task (or fail it on parent failure).

        Returns the placement tuple for the drain loop's batched
        bookkeeping, or ``None`` when the task resolved some other way
        (parent failure, memo hit, fast-fail, resource starvation).
        """
        if rec.depends_on:
            failed_parent = next(
                (p for p in rec.depends_on
                 if p.state in (TaskState.FAILED, TaskState.DEP_FAILED)), None)
            if failed_parent is not None:
                err = DependencyError(
                    f"dependency {failed_parent.task_id} ({failed_parent.name}) failed",
                    root_cause=failed_parent.exception)
                report = self._make_report(rec, err, node=None, pool=None, worker=None)
                self._route_failure(rec, report, err)
                return None
            # dependencies satisfied: materialize parent results into the
            # args.  Dependency-free records skip the walk — their args
            # cannot contain futures, or they would have had dependencies.
            rec.args = _resolve(rec.args)
            rec.kwargs = _resolve(rec.kwargs)
        # lineage-aware memoization: with a CheckpointPolicy in the stack
        # and the args now embedding every parent's result, a committed
        # result for this invocation hash resolves the future right here —
        # the restart path that skips the completed frontier
        stack = rec.stack if rec.stack is not None else self.policies
        if (stack._checkpointers and rec.retry_count == 0
                and not rec.cancel_requested
                and self._try_memoized(rec, stack)):
            return None
        return self._place(rec)

    def _try_memoized(self, rec: TaskRecord, stack: PolicyStack) -> bool:
        """Probe the checkpoint stores for this record's lineage key.

        A hit still runs the stack's result validators (the same gate a
        fresh execution passes through); a cached result that fails
        validation triggers **dependency-aware rollback** — the entry and
        all its descendants are invalidated — and the task re-executes.

        The store probe runs synchronously on the event-loop thread,
        like every other dispatch-time policy hook.  For an on-disk
        store this is local-file I/O (values cache in memory after the
        first load); replaying a frontier of very large cached results
        on a *real-clock* engine can delay heartbeat/straggler timers —
        widen ``heartbeat_threshold`` there, or keep bulky results out
        of the task store.  Moving hydration off-loop is future work.
        """
        t0 = time.perf_counter()
        hit, value = stack.memo_lookup(rec, self.context())
        self.stats["wrath_overhead_s"] += time.perf_counter() - t0
        if not hit:
            return False
        vexc = (stack.on_result(rec, value, self.context())
                if stack._validators else None)
        if vexc is not None:
            removed = stack.memo_invalidate(rec, reason=str(vexc))
            if self.monitor is not None:
                self.monitor.record_task_event(
                    rec.task_id, "memo_rollback", name=rec.name,
                    error=type(vexc).__name__, invalidated=len(removed))
            return False
        # a hit reached via a *different* parent lineage (converging
        # DAGs: two parents, same output value, one child key) must still
        # register the new parent edges — commit is a value no-op here
        # but unions parents, keeping rollback dependency-complete
        stack.memo_commit(rec, value, self.context())
        self._complete_memoized(rec, value)
        return True

    def _complete_memoized(self, rec: TaskRecord, value: Any) -> bool:
        """Resolve a task from the checkpoint store without dispatching."""
        with self._lock:
            if self._done_first.get(rec.task_id):
                return False
            self._done_first[rec.task_id] = True
            rec.state = TaskState.COMPLETED
            rec.end_time = self.clock.time()
            self.stats["completed"] += 1
            self.stats["memo_hits"] += 1
        if self.monitor is not None:
            self.monitor.record_task_event(
                rec.task_id, "memoized", name=rec.name,
                key=(rec.lineage_key or "")[:12])
        self._cancel_race_loser(rec, rec.task_id)
        self._finish(rec, result=value)
        return True

    def _place(self, rec: TaskRecord) -> tuple[str, Any, int] | None:
        """Hand one record to its pool executor.

        Returns ``(pool_name, node, steal_hops_before_queueing)`` for the
        bookkeeping write, or ``None`` when the record took a
        failure/fast-fail path instead (those bookkeep themselves).
        """
        if self._done_first.get(rec.task_id) or rec.cancel_requested:
            return None  # cancelled/resolved while queued for dispatch
        if rec.first_dispatch_time <= 0:
            rec.first_dispatch_time = self.clock.time()
        stack = rec.stack if rec.stack is not None else self.policies
        if stack._dispatchers:
            t0 = time.perf_counter()
            reason = stack.on_dispatch(rec, self.context())
            self.stats["wrath_overhead_s"] += time.perf_counter() - t0
            if reason is not None:
                self.fast_fail_task(rec.task_id, reason)
                return None
        pool_name = rec.target_pool or rec.pool_default or self.default_pool
        ex = self.executors.get(pool_name)
        if ex is None:
            err = ResourceStarvationError(f"no executor for pool {pool_name!r}")
            self._route_failure(rec, self._make_report(rec, err), err)
            return None
        # snapshot the steal-hop count before the record becomes visible
        # to workers: if a thief migrates it before our bookkeeping write
        # lands, that write must not clobber the thief's assignment
        hops = len(rec.steal_path)
        node = ex.submit(rec)
        if node is None:
            err = ResourceStarvationError(
                f"no eligible node in pool {pool_name!r} "
                f"(denylist={sorted(self.denylist)})", pool=pool_name)
            self._route_failure(rec, self._make_report(rec, err, pool=pool_name), err)
            return None
        return pool_name, node, hops

    def _bookkeep_placements(
            self, batch: list[tuple[TaskRecord, str, Any, int]]) -> None:
        """State + assignment writes for a batch of placements under ONE
        lock acquisition, then the out-of-lock side effects (monitor
        events, replica launches).

        Guards: only READY/RETRYING records are promoted to SCHEDULED — a
        worker that already marked the task RUNNING, or a cancellation
        that already made it terminal, is never clobbered — and a record
        stolen between queueing and this write keeps the thief's
        assignment (the hop count moved past the snapshot).
        """
        with self._lock:
            for rec, pool_name, node, hops in batch:
                if rec.state in (TaskState.READY, TaskState.RETRYING):
                    rec.state = TaskState.SCHEDULED
                if len(rec.steal_path) == hops:
                    self._assignment[rec.task_id] = (pool_name, node.name)
        monitor = self.monitor
        for rec, pool_name, node, _hops in batch:
            if monitor is not None:
                monitor.record_task_event(
                    rec.task_id, "scheduled", pool=pool_name, node=node.name,
                    attempt=rec.retry_count)
            if rec.replicas > 0 and rec.retry_count == 0:
                self._launch_replicas(rec, first_node=node.name)

    def _dispatch(self, rec: TaskRecord) -> None:
        """Place one record immediately (retry / preempt / delayed-retry
        paths; first-time submissions go through the batched drain)."""
        out = self._place(rec)
        if out is not None:
            self._bookkeep_placements([(rec, *out)])

    def _record_steal(self, rec: TaskRecord, victim: str, thief: str) -> None:
        """Executor ``on_steal`` callback: re-point bookkeeping at the
        thief before it runs the record.

        The assignment table is what heartbeat-loss sweeps, cancellation,
        preemption and drain key on, so it must follow the task; the
        appended steal-path hop keeps the full migration history on the
        record so a later failure categorizes and propagates (workflow
        scope, retry rung, checkpoint lineage) against the node that
        actually held the task.
        """
        with self._lock:
            pool_name, _ = self._assignment.get(
                rec.task_id,
                (rec.target_pool or rec.pool_default or self.default_pool,
                 None))
            if not rec.steal_path:
                rec.steal_path = []  # copy-on-write off the shared default
            rec.steal_path.append(
                {"from": victim, "to": thief, "time": self.clock.time()})
            self._assignment[rec.task_id] = (pool_name, thief)
            self.stats["steals"] += 1
        if self.monitor is not None:
            self.monitor.record_task_event(
                rec.task_id, "stolen", node=thief, source=victim,
                hops=len(rec.steal_path))

    # ------------------------------------------------------------------ #
    # cancellation / preemption / drain (the proactive action surface)
    # ------------------------------------------------------------------ #
    def fast_fail_task(self, task_id: str, reason: str) -> bool:
        """Predictive fast-fail: terminally fail a destined-to-fail task."""
        err = ResourceStarvationError(reason)
        if self.cancel_task(task_id, reason=reason, exc=err):
            self.stats["fast_fails"] += 1
            return True
        return False

    def cancel_task(self, task_id: str, *, reason: str = "",
                    exc: BaseException | None = None) -> bool:
        """Terminally cancel a task, pulling it off a node queue if queued.

        The future is resolved with ``exc`` (default
        :class:`TaskCancelledError`); a record already picked up by a
        worker keeps running to completion but its result is dropped (the
        worker's ``finally`` still releases node memory).  Returns False
        when the task is unknown or already resolved.
        """
        rec = self.tasks.get(task_id)
        if rec is None:
            return False
        with self._lock:
            if self._done_first.get(task_id) or rec.state in (
                    TaskState.COMPLETED, TaskState.FAILED, TaskState.DEP_FAILED):
                return False
            rec.cancel_requested = True
            rec.cancel_reason = reason
            pool_name, node_name = self._assignment.get(task_id, (None, None))
        if node_name:
            ex = self.executors.get(pool_name or self.default_pool)
            if ex is not None:
                ex.cancel_queued(task_id, node_name)  # real dequeue if still queued
        err = exc or TaskCancelledError(reason or f"task {task_id} cancelled",
                                        task_id=task_id)
        with self._lock:
            if self._done_first.get(task_id):
                return False  # completed in the window between the two locks
            self._done_first[task_id] = True
            rec.state = TaskState.FAILED
            rec.exception = err
            rec.terminal_time = self.clock.time()
            self.stats["cancelled"] += 1
            self.stats["failed"] += 1
        if self.monitor is not None:
            self.monitor.record_task_event(task_id, "cancelled", reason=reason)
        self._cancel_race_loser(rec, task_id)
        self._finish(rec, error=err)
        if not isinstance(err, TaskCancelledError):
            # a fast-fail (real error, not a plain cancel) is a genuine
            # terminal failure — let the owning scope propagate it; plain
            # cancellations must not re-trigger propagation storms
            self._propagate_workflow_failure(rec)
        return True

    def preempt_task(self, task_id: str, *, reason: str = "") -> bool:
        """Migrate a task away from its current node (proactive PREEMPT).

        A still-queued record is *really* cancelled (pulled off the node
        queue) and re-dispatched elsewhere; a running record gets a backup
        copy on another node — first finisher wins, exactly the
        speculative-execution race — because a thread-based worker cannot
        be interrupted mid-``fn``.
        """
        rec = self.tasks.get(task_id)
        if rec is None or self._done_first.get(task_id):
            return False
        with self._lock:
            pool_name, node_name = self._assignment.get(task_id, (None, None))
        if node_name is None:
            return False
        ex = self.executors.get(pool_name or self.default_pool)
        if ex is None:
            return False
        removed = ex.cancel_queued(task_id, node_name)
        if removed is not None and removed.is_speculative:
            # copies share the original's task id: we dequeued a racing
            # COPY, not the original (which is still running).  Retire the
            # copy's live-attempt slot — re-dispatching the running
            # original here would double-execute it.
            removed.cancel_requested = True
            self._copy_attempt_failed(removed)
            removed = None
        if removed is not None:
            # real cancellation: steer the re-dispatch away from the node
            candidates = [n for n in ex.eligible_nodes(rec)
                          if n.name != node_name]
            target = self.scheduler.select(rec, candidates, pool=ex.pool)
            rec.target_node = target.name if target is not None else None
            self.events.call_soon(self._dispatch, rec, name="preempt-dispatch")
        elif task_id not in self._speculated:
            # already running: migrate via a backup copy (winner-takes-future)
            self._speculated.add(task_id)
            if self._launch_copy(rec, avoid_node=node_name) is None:
                return False
        else:
            return False  # a backup already races this task; nothing to do
        self.stats["preemptions"] += 1
        if self.monitor is not None:
            self.monitor.record_task_event(
                task_id, "preempted", node=node_name, reason=reason)
        return True

    def drain_node(self, node_name: str, *, reason: str = "",
                   preempt: bool = True) -> bool:
        """Drain a node before hard loss: stop placing, migrate in-flight.

        The node joins the denylist *and* the drained set: the policy
        engine's heartbeat-resume rule leaves drained nodes alone — only
        :meth:`undrain_node` (the sentinel, once trends recover) releases
        them.
        """
        if node_name in self.drained:
            return False
        self.drained.add(node_name)
        self.denylist.add(node_name)
        self.stats["drains"] += 1
        if self.monitor is not None:
            self.monitor.record_system_event("node_drain", node=node_name,
                                             reason=reason)
        if preempt:
            victims = [tid for tid, rec in list(self.tasks.items())
                       if self._assignment.get(tid, (None, None))[1] == node_name
                       and rec.state in (TaskState.SCHEDULED, TaskState.RUNNING)
                       and not self._done_first.get(tid)]
            for tid in victims:
                self.preempt_task(tid, reason=f"node {node_name} draining")
        return True

    def undrain_node(self, node_name: str) -> None:
        self.drained.discard(node_name)
        self.denylist.discard(node_name)
        if self.monitor is not None:
            self.monitor.record_system_event("node_undrain", node=node_name)

    # ------------------------------------------------------------------ #
    # elastic cluster membership
    # ------------------------------------------------------------------ #
    def join_node(self, node: Any, *, pool: str | None = None) -> bool:
        """A new node joins a *running* pool: its pilot job starts, it
        heartbeats immediately, and the scheduler sees it on the next
        placement — no engine restart.  Returns False if the pool is
        unknown or a node by that name already exists."""
        pool_name = pool or self.default_pool
        ex = self.executors.get(pool_name)
        if ex is None or self.cluster.find_node(node.name) is not None:
            return False
        ex.add_node(node)
        with self._lock:
            self.stats["joins"] += 1
        if self.monitor is not None:
            self.monitor.record_system_event("node_join", node=node.name,
                                             pool=pool_name)
        return True

    def leave_node(self, node_name: str, *,
                   reason: str = "decommissioned") -> bool:
        """A node leaves the running cluster (scale-in, spot reclaim with
        notice, maintenance).  Placement stops immediately; everything
        queued or running there is swept through the normal failure
        routing so the retry hierarchy re-places it elsewhere.  Unlike
        :meth:`drain_node` the node is *gone* afterwards — the heartbeat
        watcher stops tracking it and a later join under the same name is
        a brand-new member."""
        ex = None
        for pool_name, cand in self.executors.items():
            if any(n.name == node_name for n in cand.pool.nodes):
                ex = cand
                break
        if ex is None:
            return False
        if self.monitor is not None:
            self.monitor.record_system_event("node_leave", node=node_name,
                                             reason=reason)
        # detach first: the failure sweep below re-places victims, and the
        # scheduler must already be blind to the leaving node
        ex.remove_node(node_name)
        with self._lock:
            self.stats["leaves"] += 1
            victims = [rec for tid, rec in self.tasks.items()
                       if self._assignment.get(tid, (None, None))[1] == node_name
                       and rec.state in (TaskState.SCHEDULED, TaskState.RUNNING)
                       and not self._done_first.get(tid)]
        for rec in victims:
            err = HardwareShutdownError(
                f"node {node_name} left the cluster ({reason})",
                node=node_name)
            report = self._make_report(rec, err, node=node_name,
                                       pool=self._assignment[rec.task_id][0])
            self._route_failure(rec, report, err)
        # departed nodes carry no denylist/drain baggage into a future
        # join under the same name
        self.denylist.discard(node_name)
        self.drained.discard(node_name)
        self._resume_logged.discard(node_name)
        return True

    def _launch_copy(self, rec: TaskRecord, *,
                     avoid_node: str | set[str] | None) -> TaskRecord | None:
        """Start a racing copy of ``rec`` on a different node.

        Shared by straggler speculation, preemptive migration and
        ``replicate(n)``: the copy shares the original's future and task
        id; whichever attempt finishes first wins (``_done_first``), and
        every losing attempt is cancelled.  ``avoid_node`` (a name or a
        set of names) steers placement; when every eligible node is
        avoided the copy degrades gracefully to any eligible node rather
        than not launching.
        """
        avoid = ({avoid_node} if isinstance(avoid_node, str)
                 else (avoid_node or set()))
        pool_name, _ = self._assignment.get(rec.task_id,
                                            (self.default_pool, None))
        ex = self.executors.get(pool_name or self.default_pool)
        if ex is None:
            return None
        copy = TaskRecord(
            task_id=rec.task_id, fn=rec.fn, name=rec.name, args=rec.args,
            kwargs=rec.kwargs, resources=rec.resources,
            max_retries=0, future=rec.future)
        copy.is_speculative = True
        candidates = [c for c in ex.eligible_nodes(copy)
                      if c.name not in avoid]
        target = self.scheduler.select(copy, candidates, pool=ex.pool)
        if target is not None:
            copy.target_node = target.name
        placed = ex.submit(copy)
        if placed is None:
            # no eligible node: the copy never queued, never runs, and must
            # not count as a live attempt the terminal path could wait on
            return None
        with self._lock:
            self._spec_copies.setdefault(rec.task_id, []).append(
                (copy, placed.name))
            self._live_copies[rec.task_id] = (
                self._live_copies.get(rec.task_id, 0) + 1)
        return copy

    def _launch_replicas(self, rec: TaskRecord, *, first_node: str) -> None:
        """Launch the racing copies requested by ``replicate(n)``.

        Runs once per task, right after the original's first placement;
        each copy steers away from the original's node *and* the nodes
        earlier copies landed on, so replication buys real placement
        diversity (degrading to reuse only when the pool is smaller than
        the replica count).  Replicated tasks join ``_speculated`` so the
        straggler watcher and the preemption path don't stack yet more
        copies on top of the race.
        """
        with self._lock:
            if rec.task_id in self._replicated:
                return
            if self._done_first.get(rec.task_id):
                # a sub-millisecond original already resolved the task (and
                # its loser-cancellation pass already ran): copies launched
                # now could never be cancelled and would execute for nothing
                return
            self._replicated.add(rec.task_id)
            self._speculated.add(rec.task_id)
        used: set[str] = {first_node}
        for _ in range(rec.replicas):
            copy = self._launch_copy(rec, avoid_node=used)
            if copy is None:
                break
            if copy.target_node:
                used.add(copy.target_node)
            self.stats["replicas"] += 1
        if self.monitor is not None:
            self.monitor.record_task_event(
                rec.task_id, "replicated", copies=rec.replicas,
                original_node=first_node)

    def _cancel_race_loser(self, winner: TaskRecord, task_id: str) -> None:
        """When one attempt resolves the task, cancel every other attempt."""
        if not self._spec_copies:
            # no speculation in flight anywhere: skip the lock round-trip
            # on the result hot path.  The unlocked emptiness read is
            # benign — a copy registered concurrently with this result is
            # already harmless, because a loser that keeps running is
            # dropped by the winner-takes-future guard at pickup/delivery
            return
        with self._lock:
            copies = self._spec_copies.pop(task_id, None)
            if copies is None:
                return
            pool_name, orig_node = self._assignment.get(task_id, (None, None))
            original = self.tasks.get(task_id)
        losers = [(c, n) for c, n in copies if c is not winner]
        if original is not None and original is not winner:
            losers.append((original, orig_node))
        ex = self.executors.get(pool_name or self.default_pool)
        for loser, loser_node in losers:
            loser.cancel_requested = True
            loser.cancel_reason = "lost the speculative race"
            if ex is not None and loser_node:
                ex.cancel_queued(task_id, loser_node)  # never runs if still queued

    # ------------------------------------------------------------------ #
    # results & failure routing
    # ------------------------------------------------------------------ #
    def _on_result(self, rec: TaskRecord, result: Any,
                   err: BaseException | None, worker: Any) -> None:
        tid = rec.task_id
        pool, node = self._assignment.get(tid, (None, None))
        # attribute the attempt to the node that actually ran it: for a
        # speculative copy the assignment table still points at the
        # straggler, which would credit the backup's fast finish to the
        # slow node and poison the placement history
        wnode = getattr(worker, "node", None)
        if wnode is not None:
            node = wnode.name
            pool = wnode.pool.name if wnode.pool is not None else pool
        primary = self.tasks.get(tid, rec)
        stack = primary.stack if primary.stack is not None else self.policies
        if err is None and not rec.cancel_requested and stack._validators:
            # result validation (e.g. replicate(validate=)): an invalid
            # result — from the original or any racing copy — is discarded
            # and converted into a failure of this attempt
            t0 = time.perf_counter()
            vexc = stack.on_result(primary, result, self.context())
            self.stats["wrath_overhead_s"] += time.perf_counter() - t0
            if vexc is not None:
                err = vexc
        duration = rec.end_time - rec.start_time
        rec.record_attempt(node=node or "?", pool=pool or "?",
                           worker=getattr(worker, "worker_id", "?"),
                           ok=err is None, error=type(err).__name__ if err else None,
                           duration=duration, now=self.clock.time())
        if self.monitor is not None:
            self.monitor.record_task_event(
                tid, "finished" if err is None else "error",
                node=node, pool=pool, duration=duration,
                error=type(err).__name__ if err else None)
            if node:
                self.monitor.record_task_placement(
                    rec.name, node, pool, ok=err is None, duration=duration,
                    memory_gb=rec.effective_resources().memory_gb)
        with self._lock:
            if self._done_first.get(tid):
                return  # another attempt (or a cancellation) resolved this task
            if err is None:
                self._done_first[tid] = True
                rec.state = TaskState.COMPLETED
                # a winning copy must also complete the *original* record —
                # it is the one registered in workflow scopes and stats
                if primary is not rec:
                    primary.state = TaskState.COMPLETED
                if rec.retry_count > 0:
                    self.stats["retry_success"] += 1
                self.stats["completed"] += 1
        if err is None:
            # only the attempt that claimed _done_first reaches here:
            # commit the winning value to the checkpoint stores (a losing
            # racing copy's different result must never overwrite what the
            # future actually resolved with)
            if stack._checkpointers and not rec.cancel_requested:
                t0 = time.perf_counter()
                stack.memo_commit(primary, result, self.context())
                self.stats["wrath_overhead_s"] += time.perf_counter() - t0
            self._pending_terminal.pop(tid, None)
            self._cancel_race_loser(rec, tid)
            self._finish(rec, result=result)
        else:
            if rec.is_speculative:
                # a racing copy failed; the original (or a stashed terminal
                # error awaiting the last copy) decides the task's fate
                self._copy_attempt_failed(rec)
                return
            report = self._make_report(rec, err, node=node, pool=pool,
                                       worker=getattr(worker, "worker_id", None))
            self._route_failure(rec, report, err)

    def _make_report(self, rec: TaskRecord, err: BaseException, *,
                     node: str | None = None, pool: str | None = None,
                     worker: str | None = None) -> FailureReport:
        profile: dict[str, float] = {}
        if node:
            n = self.cluster.find_node(node)
            if n is not None:
                profile = {
                    "node_memory_gb": n.memory_gb,
                    "node_mem_in_use_gb": n.mem_in_use_gb,
                    "node_speed": n.speed,
                    "node_healthy": float(n.healthy),
                    "node_ulimit_files": float(n.ulimit_files),
                }
        report = FailureReport.from_exception(
            err, task_id=rec.task_id, node=node, pool=pool, worker=worker,
            resource_profile=profile, requirements=rec.effective_resources().asdict(),
            retry_count=rec.retry_count, timestamp=self.clock.time())
        if self.monitor is not None:
            self.monitor.report_failure(report)
        return report

    def _route_failure(self, rec: TaskRecord, report: FailureReport,
                       err: BaseException) -> None:
        stack = rec.stack if rec.stack is not None else self.policies
        t0 = time.perf_counter()
        # the full middleware protocol: first decisive on_failure wins
        # (baseline retry as terminal fallback), then every policy's
        # review_decision pass (e.g. the proactive retry veto)
        decision = stack.decide(rec, report, self.context())
        self.stats["wrath_overhead_s"] += time.perf_counter() - t0

        # engine invariant: a child whose parent terminally failed can never
        # be re-executed (its arguments are unresolvable) — coerce to FAIL
        # even if a (buggy) handler says otherwise.
        if isinstance(err, DependencyError) and decision.action is not Action.FAIL:
            decision = RetryDecision(
                Action.FAIL, reason=f"dependency failure is terminal "
                                    f"(handler said {decision.action.value})")

        # a retry scheduled on a stopped event loop would never fire and
        # the future would hang: post-shutdown failures are terminal
        if self._shutting_down and decision.action is not Action.FAIL:
            decision = RetryDecision(
                Action.FAIL, reason="DataFlowKernel is shutting down: "
                                    "no further retries will run")

        if self.monitor is not None:
            self.monitor.record_task_event(
                rec.task_id, "retry_decision", action=decision.action.value,
                reason=decision.reason, rung=decision.rung,
                target_pool=decision.target_pool, target_node=decision.target_node)

        if decision.action is Action.DRAIN and report.node:
            # drain the failing node, then retry the task elsewhere
            self.drain_node(report.node, reason=decision.reason)

        if decision.action is Action.RESTART_AND_RETRY and decision.restart_component:
            kind, _, where = decision.restart_component.partition(":")
            if kind == "worker" and where:
                pool, _node = self._assignment.get(rec.task_id, (None, None))
                ex = self.executors.get(pool or self.default_pool)
                if ex is not None:
                    self.stats["restarts"] += ex.restart_workers(where)

        if decision.action in (Action.RETRY, Action.RESTART_AND_RETRY,
                               Action.PREEMPT, Action.DRAIN):
            target_node = decision.target_node
            if (decision.action is Action.PREEMPT and target_node is None
                    and report.node):
                # PREEMPT's contract is "migrate off the current node": with
                # no explicit pin, steer the re-dispatch away from it
                ex = self.executors.get(decision.target_pool
                                        or report.pool or self.default_pool)
                if ex is not None:
                    candidates = [n for n in ex.eligible_nodes(rec)
                                  if n.name != report.node]
                    picked = self.scheduler.select(rec, candidates, pool=ex.pool)
                    if picked is not None:
                        target_node = picked.name
            with self._lock:
                rec.retry_count += 1
                self.stats["retries"] += 1
                rec.state = TaskState.RETRYING
                rec.target_pool = decision.target_pool
                rec.target_node = target_node
                if decision.resource_overrides:
                    # copy-on-write: the record's default is a shared
                    # empty mapping that must never be mutated in place
                    rec.resource_overrides = {
                        **rec.resource_overrides,
                        **decision.resource_overrides}
            # delayed retries are ordinary events on the engine loop — no
            # per-retry Timer thread
            if decision.delay_s > 0:
                self.events.call_later(decision.delay_s, self._dispatch, rec,
                                       name="delayed-retry")
            else:
                self.events.call_soon(self._dispatch, rec, name="retry-dispatch")
            return

        # terminal failure — but racing copies may still save the task: a
        # healthy replica's result wins over the original's error (HPX
        # replicate semantics), so defer while any copy is in flight.
        # During shutdown queued copies die with the executors, so a stash
        # made after shutdown's flush would never resolve — fail directly.
        with self._lock:
            if (not self._shutting_down
                    and self._live_copies.get(rec.task_id, 0) > 0
                    and not self._done_first.get(rec.task_id)):
                self._pending_terminal[rec.task_id] = err
                return
        self._fail_terminally(rec, err)

    def _fail_terminally(self, rec: TaskRecord, err: BaseException) -> None:
        is_dep = isinstance(err, DependencyError)
        with self._lock:
            if self._done_first.get(rec.task_id):
                return
            self._done_first[rec.task_id] = True
            rec.state = TaskState.DEP_FAILED if is_dep else TaskState.FAILED
            rec.exception = err
            rec.terminal_time = self.clock.time()
            self.stats["dep_failed" if is_dep else "failed"] += 1
        self._finish(rec, error=err)
        if not is_dep:
            # hierarchical failure propagation: the task's innermost
            # workflow scope decides whether siblings/ancestors fast-fail.
            # DEP_FAILED children are excluded — their root cause already
            # propagated when the parent task terminally failed.
            self._propagate_workflow_failure(rec)

    def _copy_attempt_failed(self, copy: TaskRecord) -> None:
        """A racing copy failed: if the original already failed terminally
        and this was the last copy in flight, resolve the task now."""
        task_id = copy.task_id
        with self._lock:
            left = max(self._live_copies.get(task_id, 1) - 1, 0)
            self._live_copies[task_id] = left
            if left > 0 or self._done_first.get(task_id):
                return
            err = self._pending_terminal.pop(task_id, None)
        if err is not None:
            primary = self.tasks.get(task_id)
            if primary is not None:
                self._fail_terminally(primary, err)

    def _propagate_workflow_failure(self, rec: TaskRecord) -> None:
        if self._shutting_down or rec.workflow is None:
            return
        try:
            rec.workflow.on_member_failed(rec)
        except Exception as err:  # noqa: BLE001 - propagation bug must not kill routing
            self._on_event_error("workflow-propagate", err)

    def _finish(self, rec: TaskRecord, *, result: Any = None,
                error: BaseException | None = None) -> None:
        fut = rec.future
        assert fut is not None
        with self._all_done:
            if rec._finished or fut.done():
                return  # idempotent: speculation/races must not double-set
            rec._finished = True
            self._outstanding -= 1
            if self._outstanding <= 0:
                self._all_done.notify_all()
        if error is None:
            fut.set_result(result)
        else:
            fut.set_exception(error)

    # ------------------------------------------------------------------ #
    # watchers: heartbeat loss + stragglers (periodic events)
    # ------------------------------------------------------------------ #
    def _check_heartbeats(self) -> None:
        if self.monitor is None:
            return
        now = self.clock.time()
        stale_after = self.heartbeat_period * self.heartbeat_threshold
        for node_name, last in list(self.monitor.last_heartbeats().items()):
            node = self.cluster.find_node(node_name)
            if node is None:
                continue
            if now - last > stale_after:
                # silence re-arms the next resume transition even while the
                # node is denylisted — a second lost->resumed cycle must
                # produce a second heartbeat_resumed event
                self._resume_logged.discard(node_name)
                if node_name not in self.denylist:
                    # silent node: environment-layer failure detected via
                    # heartbeat loss (paper §III-B / §IV)
                    self.monitor.record_system_event(
                        "heartbeat_lost", node=node_name, stale_s=now - last)
                    self._fail_tasks_on_node(node_name)
            elif node_name in self.denylist:
                # node resumed communication: HTCondor-style un-denylist is
                # handled by the policy engine via monitor events.  Record
                # the resume once per transition, not on every check while
                # the node awaits un-denylisting.
                if node_name not in self._resume_logged:
                    self._resume_logged.add(node_name)
                    self.monitor.record_system_event(
                        "heartbeat_resumed", node=node_name)
            else:
                # healthy & trusted again: arm the next resume transition
                self._resume_logged.discard(node_name)

    def _fail_tasks_on_node(self, node_name: str) -> None:
        # snapshot under the lock: concurrent submits mutate self.tasks,
        # and an unguarded comprehension over the live dict can raise
        # "dictionary changed size during iteration" mid-sweep
        with self._lock:
            victims = [rec for tid, rec in self.tasks.items()
                       if self._assignment.get(tid, (None, None))[1] == node_name
                       and rec.state in (TaskState.SCHEDULED, TaskState.RUNNING)
                       and not self._done_first.get(tid)]
        for rec in victims:
            err = HardwareShutdownError(
                f"node {node_name} lost (heartbeat silent)", node=node_name)
            report = self._make_report(rec, err, node=node_name,
                                       pool=self._assignment[rec.task_id][0])
            self._route_failure(rec, report, err)

    def _straggler_estimate(self, rec: TaskRecord) -> float:
        """Expected duration for straggler detection.

        Profile-derived (template p95 from the monitoring database) when
        enough history exists; the static user-declared ``est_duration_s``
        is the cold-start fallback.  0.0 = no estimate, no detection.
        """
        if self.monitor is not None:
            est = self.monitor.expected_duration(rec.name)
            if est > 0:
                return est
        return rec.resources.est_duration_s

    def check_stragglers(self, *, factor: float | None = None,
                         scope: Any = None) -> None:
        """One straggler sweep: speculate on tasks running far beyond their
        expected duration.  Driven by :class:`~repro_torch.engine.policies.
        StragglerPolicy` on the periodic policy tick; ``scope`` (a
        :class:`~repro_torch.engine.workflow.Workflow`) restricts the watch to
        that scope's subtree."""
        factor = self.straggler_factor if factor is None else factor
        scope_ids: set[str] | None = None
        if scope is not None:
            scope_ids = {r.task_id for r in scope.tasks()}
        now = self.clock.time()
        for tid, rec in list(self.tasks.items()):
            if self._done_first.get(tid) or tid in self._speculated:
                continue
            if scope_ids is not None and tid not in scope_ids:
                continue
            # only tasks a worker actually picked up accrue runtime — the
            # RUNNING transition is set by the worker on pickup
            if rec.state is not TaskState.RUNNING or rec.start_time <= 0:
                continue
            est = self._straggler_estimate(rec)
            if est <= 0:
                continue
            if now - rec.start_time > factor * est:
                self._speculated.add(tid)
                self.stats["speculations"] += 1
                _, node = self._assignment.get(tid, (self.default_pool, None))
                copy = self._launch_copy(rec, avoid_node=node)
                if copy is not None and self.monitor is not None:
                    self.monitor.record_task_event(
                        tid, "speculative_copy", original_node=node)

    # ------------------------------------------------------------------ #
    # sync helpers
    # ------------------------------------------------------------------ #
    def _drive_until(self, predicate, timeout: float | None = None) -> bool:
        """Virtual-clock engines *drive* the event loop instead of blocking
        on it (the calling thread is the one that resolves tasks).
        ``timeout`` is virtual seconds — default a generous simulated hour.
        Returns the predicate's final value."""
        deadline = self.clock.now() + (timeout if timeout is not None
                                       else 3600.0)
        self.events.run_until(predicate, deadline=deadline)
        return bool(predicate())

    def wait_all(self, timeout: float | None = None) -> bool:
        if self.clock.virtual:
            return self._drive_until(lambda: self._outstanding <= 0, timeout)
        with self._all_done:
            if self._outstanding <= 0:
                return True
            return self._all_done.wait(timeout)

    def makespan(self) -> float:
        return self.clock.time() - self.stats["start_time"]

    def success_rates(self) -> dict[str, float]:
        total = self.stats["submitted"]
        retried = self.stats["retries"]
        return {
            "task_success_rate": self.stats["completed"] / total if total else 0.0,
            "retry_success_rate": (self.stats["retry_success"] / retried) if retried else 0.0,
            "tasks": total,
            "retries": retried,
        }

    def failed_task_ttfs(self, *, include_dep_failed: bool = False) -> list[float]:
        """Per-task time-to-failure (first dispatch -> terminal) of failed
        tasks; dependency-wait before the first placement is excluded.

        The proactive plane's headline metric: destined-to-fail tasks
        should terminate sooner (fig 4's normalized TTF < 1).  Dep-failed
        children are excluded by default: their terminal time is gated by
        when their *healthy* sibling parents finish, which says nothing
        about how fast the doomed parent itself was terminated.
        """
        states = ((TaskState.FAILED, TaskState.DEP_FAILED)
                  if include_dep_failed else (TaskState.FAILED,))
        return [rec.terminal_time - (rec.first_dispatch_time or rec.submit_time)
                for rec in self.tasks.values()
                if rec.terminal_time > 0 and rec.submit_time > 0
                and rec.state in states]
