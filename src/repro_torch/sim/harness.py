"""Simulation harness: drive a virtual-clock engine, run scenarios, run
seeded chaos campaigns, and check the invariants WRATH promises.

Three layers:

* :class:`SimHarness` — ergonomic wrapper for tests: builds a
  virtual-clock :class:`~repro_torch.engine.dfk.DataFlowKernel` wired to
  :class:`~repro_torch.sim.cluster.SimExecutor`, and exposes ``run_until`` /
  ``advance`` / ``result`` so "sleep and poll" test code becomes
  "advance virtual time and assert";
* :func:`run_scenario` — execute one :class:`~repro_torch.sim.scenario.
  Scenario` end to end, returning its event trace, engine stats and any
  invariant violations;
* :func:`campaign` — N seeded scenarios with invariant checking and
  same-seed determinism spot-checks; the CI chaos gate.

**Reproducing a failure**: every scenario is fully determined by its
seed, so a failing campaign line like ``seed=1337: unresolved futures``
reproduces as ``run_scenario(Scenario.random(1337))`` — same trace,
byte for byte.
"""
from __future__ import annotations

import json
import math
import re
import time as _wall
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.core.monitoring import MonitoringDatabase
from repro_torch.engine.dfk import DataFlowKernel
from repro_torch.engine.policies import WrathPolicy
from repro_torch.engine.task import ResourceSpec, TaskDef, TaskState
from repro_torch.injection.engines import FN_REPLACEMENT, SPEC_MODIFICATION
from repro_torch.sim.clock import VirtualClock
from repro_torch.sim.cluster import Node, ResourcePool, SimCluster, SimExecutor
from repro_torch.sim.scenario import Scenario

__all__ = ["SimHarness", "ScenarioResult", "CampaignResult", "run_scenario",
           "campaign", "build_trace"]

_TERMINAL = (TaskState.COMPLETED, TaskState.FAILED, TaskState.DEP_FAILED)


# --------------------------------------------------------------------------
# test-facing harness
# --------------------------------------------------------------------------
class SimHarness:
    """A virtual-clock engine session for tests.

    ``durations`` scripts task durations by template name (see
    :class:`~repro_torch.sim.cluster.SimExecutor`); every other kwarg goes to
    the :class:`~repro_torch.engine.dfk.DataFlowKernel`.  Use as a context
    manager — inside the block the DFK is current, so ``@task``
    invocations submit to it::

        with SimHarness(SimCluster.homogeneous(2),
                        durations={"work": 0.3}) as h:
            fut = work(1)
            h.run_until(lambda: fut.done())
            assert fut.result(timeout=0) == 1
    """

    def __init__(self, cluster: Any = None, *,
                 durations: dict[str, float] | Callable[..., Any] | None = None,
                 monitor: MonitoringDatabase | None = None,
                 trace: bool = False,
                 **dfk_kwargs: Any):
        self.clock = VirtualClock()
        if monitor is None:
            monitor = MonitoringDatabase(clock=self.clock,
                                         keep_event_log=trace)
        else:
            # a user-supplied monitor must still live on the virtual
            # timebase (real stamps would break every now-vs-last-beat
            # comparison) and honor trace=
            monitor.clock = self.clock
            monitor._time = self.clock.time
            if trace and monitor.event_log is None:
                monitor.event_log = []
        self.monitor = monitor
        if cluster is None:
            cluster = SimCluster.homogeneous(2)
        self.cluster = cluster
        self.dfk = DataFlowKernel(
            cluster, monitor=self.monitor, clock=self.clock,
            executor_factory=SimExecutor.factory(durations), **dfk_kwargs)

    # -- session ----------------------------------------------------------
    def __enter__(self) -> "SimHarness":
        self.dfk.__enter__()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.dfk.__exit__(*exc)

    # -- virtual-time control ---------------------------------------------
    def run_until(self, predicate: Callable[[], bool] | None = None,
                  timeout: float = 60.0) -> bool:
        """Drive events until ``predicate()`` holds or ``timeout`` virtual
        seconds pass; returns whether the predicate holds."""
        self.dfk.events.run_until(predicate,
                                  deadline=self.clock.now() + timeout)
        return predicate() if predicate is not None else True

    def advance(self, dt: float) -> None:
        """Run everything scheduled in the next ``dt`` virtual seconds and
        land the clock exactly ``dt`` later — the sim replacement for
        ``time.sleep(dt)``."""
        self.dfk.events.run_until(deadline=self.clock.now() + dt)

    def result(self, fut: Any, timeout: float = 60.0) -> Any:
        """Drive the sim until ``fut`` resolves, then return its result
        (raising its exception) — the sim ``fut.result(timeout=...)``."""
        if not self.run_until(fut.done, timeout=timeout):
            raise TimeoutError(
                f"future {fut!r} unresolved after {timeout} virtual seconds")
        return fut.result(timeout=0)

    def wait_all(self, timeout: float = 60.0) -> bool:
        return self.dfk.wait_all(timeout)

    # -- fault injection ---------------------------------------------------
    def _manager(self, node_name: str):
        for ex in self.dfk.executors.values():
            mgr = ex.managers.get(node_name)
            if mgr is not None:
                return ex, mgr
        raise KeyError(f"no sim node named {node_name!r}")

    def fail_node(self, node_name: str) -> None:
        node = self.cluster.find_node(node_name)
        if node is not None:
            node.healthy = False
        ex, _ = self._manager(node_name)
        ex.fail_node(node_name)

    def restore_node(self, node_name: str) -> None:
        ex, _ = self._manager(node_name)
        ex.restore_node(node_name)

    def pause_heartbeats(self, node_name: str) -> None:
        self._manager(node_name)[1].pause_heartbeats()

    def resume_heartbeats(self, node_name: str) -> None:
        self._manager(node_name)[1].resume_heartbeats()

    def kill_worker(self, node_name: str) -> bool:
        return self._manager(node_name)[1].kill_worker()

    def trace(self) -> str:
        return build_trace(self.monitor)


# --------------------------------------------------------------------------
# event traces
# --------------------------------------------------------------------------
_TASK_ID_RE = re.compile(r"task-\d{6}")


def build_trace(monitor: MonitoringDatabase,
                epoch: float = VirtualClock.EPOCH) -> str:
    """Serialize the monitor's ordered event log as a canonical trace.

    Raw task ids come from a process-global counter, so two runs of the
    same scenario in one process would differ spuriously; ids are
    relabelled ``T0, T1, ...`` in order of first appearance (including
    inside reason strings).  Everything else — virtual timestamps, node
    names, retry decisions, failure reasons — is emitted verbatim:
    *identical trace* means identical behaviour.
    """
    if monitor.event_log is None:
        raise ValueError("monitor was not built with keep_event_log=True")
    rename: dict[str, str] = {}

    def norm(value: Any) -> Any:
        if isinstance(value, str):
            return _TASK_ID_RE.sub(
                lambda m: rename.setdefault(m.group(0), f"T{len(rename)}"),
                value)
        return value

    lines = []
    for entry in monitor.event_log:
        d = {k: norm(v) for k, v in entry.items()}
        t = d.pop("time") - epoch
        scope = d.pop("scope")
        event = d.pop("event")
        payload = json.dumps(d, sort_keys=True, default=repr)
        lines.append(f"{t:014.6f} {scope} {event} {payload}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# scenario execution
# --------------------------------------------------------------------------
@dataclass
class ScenarioResult:
    seed: int
    scenario: Scenario
    trace: str
    stats: dict[str, float]
    violations: list[str]
    #: per-task outcome: ("ok", result) or ("error", exception type name)
    outcomes: dict[str, tuple[str, Any]]
    events_executed: int = 0
    # -- checkpoint/restart bookkeeping (engine_crash scenarios) ----------
    #: number of engine crash/restart cycles that occurred
    crashes: int = 0
    #: TaskStore size (committed results) snapshotted at each crash
    committed_at_crash: list[int] = field(default_factory=list)
    #: tasks the *final* engine incarnation actually executed (dispatched
    #: to a worker at least once) — after a restart this is the incomplete
    #: frontier, everything else resolves from the store
    reexecuted: int = 0

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        status = "ok" if self.ok else f"VIOLATIONS={len(self.violations)}"
        return (f"seed={self.seed}: {status} "
                f"submitted={int(self.stats['submitted'])} "
                f"completed={int(self.stats['completed'])} "
                f"failed={int(self.stats['failed'])} "
                f"dep_failed={int(self.stats['dep_failed'])} "
                f"retries={int(self.stats['retries'])} "
                f"fast_fails={int(self.stats['fast_fails'])}")


def _make_fn(index: int, fail: str | None) -> Callable[..., Any]:
    if fail in FN_REPLACEMENT:
        return FN_REPLACEMENT[fail]

    def ok_fn(*deps: Any) -> int:
        return index
    return ok_fn


def _build_cluster(scenario: Scenario) -> SimCluster:
    nodes = [Node(name=s.name, memory_gb=s.memory_gb, speed=s.speed,
                  workers_per_node=s.workers, packages=frozenset(s.packages),
                  ulimit_files=s.ulimit_files)
             for s in scenario.nodes]
    return SimCluster([ResourcePool("sim", nodes)])


def run_scenario(scenario: Scenario, *,
                 policy_factory: Callable[[], Any] | None = None,
                 default_retries: int = 3,
                 heartbeat_period: float = 0.1,
                 heartbeat_threshold: float = 5.0,
                 task_store: Any = None,
                 engine_kwargs: dict[str, Any] | None = None) -> ScenarioResult:
    """Execute one scenario on a fresh virtual-clock engine.

    ``policy_factory`` builds the resilience stack per run (policies bind
    to one engine, so a *factory*, not an instance); default is WRATH's
    taxonomy-driven hierarchical retry.

    ``engine_kwargs`` are forwarded verbatim to every
    :class:`~repro_torch.engine.dfk.DataFlowKernel` the scenario builds
    (including post-crash incarnations) — e.g.
    ``engine_kwargs={"work_stealing": True}`` runs the whole campaign
    with decentralized work stealing on.

    ``engine_crash`` faults tear the whole engine down and rebuild it
    against the same lineage-aware :class:`~repro_torch.checkpoint.task_store.
    TaskStore` (``task_store=``; a fresh in-memory store is created when
    the scenario crashes and none was given), then replay the workflow
    script: already-committed tasks resolve from the store by
    memoization, only the incomplete frontier re-executes.  Environment
    state survives the crash (dead hardware stays dead, silent
    monitoring agents stay silent, scope cancellations are re-issued);
    engine-private state (denylist, drain sets, in-flight attempts) is
    lost, exactly as a real restart loses it.
    """
    clock = VirtualClock()
    monitor = MonitoringDatabase(clock=clock, keep_event_log=True)
    store = task_store
    if store is None and any(f.kind == "engine_crash" for f in scenario.faults):
        from repro_torch.checkpoint.task_store import TaskStore
        store = TaskStore()

    n_tasks = len(scenario.tasks)
    futures: dict[int, Any] = {}
    cancel_times: dict[str, float] = {}
    fired: set[int] = set()          # indices of faults already applied
    crash = {"pending": False}
    state: dict[str, Any] = {}       # current engine incarnation

    def build_engine() -> None:
        cluster = _build_cluster(scenario)
        policy = (policy_factory() if policy_factory is not None
                  else WrathPolicy())
        dfk = DataFlowKernel(
            cluster, monitor=monitor, clock=clock, policy=policy,
            checkpoint=store,
            executor_factory=SimExecutor.factory(scenario.durations),
            default_retries=default_retries,
            heartbeat_period=heartbeat_period,
            heartbeat_threshold=heartbeat_threshold,
            **(engine_kwargs or {}))
        dfk.start()
        state["dfk"] = dfk
        state["cluster"] = cluster
        state["wfs"] = {name: dfk.workflow(name, propagate=mode)
                        for name, mode in scenario.workflows.items()}

    def submit(i: int) -> None:
        spec = scenario.tasks[i]
        res = {"memory_gb": spec.memory_gb}
        if spec.fail in SPEC_MODIFICATION:
            res.update(SPEC_MODIFICATION[spec.fail])
        packages = tuple(res.pop("packages", ()))
        td = TaskDef(_make_fn(i, spec.fail), spec.name,
                     ResourceSpec(packages=packages, **res),
                     spec.max_retries,
                     workflow=state["wfs"].get(spec.workflow))
        args = tuple(futures[j] for j in spec.depends_on)
        futures[i] = state["dfk"].submit(td, args, {})

    def apply_fault(idx: int, fault: Any) -> None:
        fired.add(idx)
        payload: dict[str, Any] = {"node": fault.node,
                                   "workflow": fault.workflow}
        if fault.nodes:
            payload["nodes"] = list(fault.nodes)
        if fault.kind == "mass_preempt":
            payload["fraction"] = fault.fraction
        if fault.spec is not None:
            payload["node"] = fault.spec.name
        monitor.record_system_event(f"fault_{fault.kind}", **payload)
        if fault.kind == "engine_crash":
            # flagged only: the teardown/rebuild happens *outside* the
            # event loop (run_until checks the predicate between events)
            crash["pending"] = True
            return
        dfk, cluster, wfs = state["dfk"], state["cluster"], state["wfs"]
        ex = dfk.executors["sim"]
        if fault.kind == "node_down":
            node = cluster.find_node(fault.node)
            if node is not None:
                node.healthy = False
            ex.fail_node(fault.node)
        elif fault.kind == "node_up":
            ex.restore_node(fault.node)
        elif fault.kind == "hb_pause":
            mgr = ex.managers.get(fault.node)
            if mgr is not None:
                mgr.pause_heartbeats()
        elif fault.kind == "hb_resume":
            mgr = ex.managers.get(fault.node)
            if mgr is not None:
                mgr.resume_heartbeats()
        elif fault.kind == "worker_kill":
            mgr = ex.managers.get(fault.node)
            if mgr is not None:
                mgr.kill_worker()
        elif fault.kind == "drain":
            dfk.drain_node(fault.node, reason="scripted drain")
        elif fault.kind == "undrain":
            dfk.undrain_node(fault.node)
        elif fault.kind == "cancel_workflow":
            wf = wfs.get(fault.workflow)
            if wf is not None:
                cancel_times[fault.workflow] = clock.time()
                wf.cancel("scripted cancellation")
        elif fault.kind == "zone_down":
            # the whole group at once — one fault event, many nodes
            for name in fault.nodes:
                node = cluster.find_node(name)
                if node is not None:
                    node.healthy = False
                ex.fail_node(name)
        elif fault.kind == "zone_up":
            for name in fault.nodes:
                ex.restore_node(name)
        elif fault.kind == "partition":
            mgr = ex.managers.get(fault.node)
            if mgr is not None:
                mgr.partition()
        elif fault.kind == "partition_heal":
            mgr = ex.managers.get(fault.node)
            if mgr is not None:
                mgr.heal_partition()
        elif fault.kind == "mass_preempt":
            # spot reclaim: kill fraction of alive workers in one tick.
            # Victim order is deterministic — busy workers first (maximum
            # disruption), then (node, worker id) lexicographic
            alive = [(mgr, w) for _, mgr in sorted(ex.managers.items())
                     for w in mgr.node.workers if w.alive]
            alive.sort(key=lambda mw: (not mw[1].busy,
                                       mw[1].node.name, mw[1].worker_id))
            n_kill = math.ceil(fault.fraction * len(alive))
            for mgr, w in alive[:n_kill]:
                mgr.kill_worker(w)
        elif fault.kind == "node_join":
            s = fault.spec
            dfk.join_node(Node(name=s.name, memory_gb=s.memory_gb,
                               speed=s.speed, workers_per_node=s.workers,
                               packages=frozenset(s.packages),
                               ulimit_files=s.ulimit_files),
                          pool="sim")
        elif fault.kind == "node_leave":
            dfk.leave_node(fault.node, reason="scripted node_leave")

    build_engine()
    t0 = clock.now()
    for i, spec in enumerate(scenario.tasks):
        state["dfk"].events.call_at(t0 + spec.at, submit, i,
                                    name="scenario-submit")
    for idx, fault in enumerate(scenario.faults):
        state["dfk"].events.call_at(t0 + fault.at, apply_fault, idx, fault,
                                    name=f"fault:{fault.kind}")

    def all_done() -> bool:
        return (len(futures) == n_tasks
                and all(f.done() for f in futures.values()))

    def restart(generation: int) -> None:
        """Tear the crashed engine down and bring a new one up on the
        same store/monitor/clock, replaying the workflow script."""
        old_dfk, old_cluster = state["dfk"], state["cluster"]
        dead = [n.name for pool in old_cluster.pools.values()
                for n in pool.nodes if not n.healthy]
        hb_paused = [name for name, mgr
                     in old_dfk.executors["sim"].managers.items()
                     if mgr._hb_paused]
        partitioned = [name for name, mgr
                       in old_dfk.executors["sim"].managers.items()
                       if mgr._partitioned]
        # elastic membership survives the crash too: nodes that joined are
        # still physically there, departed nodes are still gone
        base_names = {s.name for s in scenario.nodes}
        old_nodes = [n for pool in old_cluster.pools.values()
                     for n in pool.nodes]
        joined = [n for n in old_nodes if n.name not in base_names]
        departed = base_names - {n.name for n in old_nodes}
        cancelled = {name: wf.cancel_reason
                     for name, wf in state["wfs"].items() if wf.cancelled}
        already_submitted = sorted(futures)
        old_dfk.shutdown()
        monitor.record_system_event("engine_restart", generation=generation)
        build_engine()
        dfk, cluster = state["dfk"], state["cluster"]
        ex = dfk.executors["sim"]
        for n in joined:
            dfk.join_node(Node(name=n.name, memory_gb=n.memory_gb,
                               speed=n.speed,
                               workers_per_node=n.workers_per_node,
                               packages=n.packages,
                               ulimit_files=n.ulimit_files),
                          pool="sim")
        for name in sorted(departed):
            dfk.leave_node(name, reason="departed before restart")
        # environment state survives an engine restart: dead hardware
        # stays dead until a scripted node_up revives it, a silent
        # monitoring agent stays silent until a scripted hb_resume, and a
        # partition stays cut until a scripted partition_heal (anything
        # that finished behind it was lost with the old engine)
        for name in dead:
            node = cluster.find_node(name)
            if node is not None:
                node.healthy = False
            ex.fail_node(name)
        for name in hb_paused:
            mgr = ex.managers.get(name)
            if mgr is not None:
                mgr.pause_heartbeats()
        for name in partitioned:
            mgr = ex.managers.get(name)
            if mgr is not None:
                mgr.partition()
        # scope cancellation is coordinator state the replayed script
        # re-issues; members resubmitted below auto-cancel at submit
        for name, reason in cancelled.items():
            wf = state["wfs"].get(name)
            if wf is not None:
                wf.cancel(reason or "cancellation restored after restart")
        # replay: resubmit everything the script had already submitted
        # (committed lineage resolves from the store without dispatch) ...
        for i in already_submitted:
            submit(i)
        # ... and re-schedule arrivals/faults that had not happened yet
        now = clock.now()
        for i, spec in enumerate(scenario.tasks):
            if i not in futures:
                dfk.events.call_at(max(t0 + spec.at, now), submit, i,
                                   name="scenario-submit")
        for idx, fault in enumerate(scenario.faults):
            if idx not in fired:
                dfk.events.call_at(max(t0 + fault.at, now), apply_fault,
                                   idx, fault, name=f"fault:{fault.kind}")

    executed = 0
    crashes = 0
    committed_at_crash: list[int] = []
    while True:
        executed += state["dfk"].events.run_until(
            lambda: all_done() or crash["pending"],
            deadline=t0 + scenario.horizon)
        if not crash["pending"]:
            break
        crash["pending"] = False
        crashes += 1
        committed_at_crash.append(len(store) if store is not None else 0)
        restart(crashes)

    dfk, wfs = state["dfk"], state["wfs"]
    violations = _check_invariants(scenario, dfk, futures, wfs, cancel_times)
    trace = build_trace(monitor)
    stats = dict(dfk.stats)
    reexecuted = sum(1 for rec in dfk.tasks.values() if rec.attempts)
    outcomes: dict[str, tuple[str, Any]] = {}
    for i, fut in futures.items():
        name = scenario.tasks[i].name
        if not fut.done():
            outcomes[name] = ("unresolved", None)
        elif fut.exception(timeout=0) is not None:
            outcomes[name] = ("error",
                              type(fut.exception(timeout=0)).__name__)
        else:
            outcomes[name] = ("ok", fut.result(timeout=0))
    dfk.shutdown()
    return ScenarioResult(seed=scenario.seed, scenario=scenario, trace=trace,
                          stats=stats, violations=violations,
                          outcomes=outcomes, events_executed=executed,
                          crashes=crashes,
                          committed_at_crash=committed_at_crash,
                          reexecuted=reexecuted)


def _check_invariants(scenario: Scenario, dfk: DataFlowKernel,
                      futures: dict[int, Any], wfs: dict[str, Any],
                      cancel_times: dict[str, float]) -> list[str]:
    """The campaign's correctness contract, checked before shutdown."""
    v: list[str] = []
    # 1. every submission happened and every future resolved by the horizon
    if len(futures) != len(scenario.tasks):
        v.append(f"only {len(futures)}/{len(scenario.tasks)} tasks were "
                 f"submitted within the horizon")
    unresolved = [scenario.tasks[i].name for i, f in futures.items()
                  if not f.done()]
    if unresolved:
        v.append(f"unresolved futures at horizon: {unresolved}")
    # 2. no task lost: every primary record reached a terminal state
    stuck = [rec.task_id for rec in dfk.tasks.values()
             if rec.future is not None and rec.future.done()
             and rec.state not in _TERMINAL]
    if stuck:
        v.append(f"records resolved but not terminal: {stuck}")
    # 3. conservation: submitted == completed + failed + dep_failed
    s = dfk.stats
    if s["submitted"] != s["completed"] + s["failed"] + s["dep_failed"]:
        v.append(
            f"task conservation broken: submitted={s['submitted']} != "
            f"completed={s['completed']} + failed={s['failed']} + "
            f"dep_failed={s['dep_failed']}")
    # 4. cancelled scopes stay cancelled
    for name, wf in wfs.items():
        if not wf.cancelled:
            continue
        cancelled_at = cancel_times.get(name)
        for rec in wf.tasks():
            if rec.state not in _TERMINAL:
                v.append(f"cancelled scope {name!r} member {rec.task_id} "
                         f"not terminal ({rec.state.value})")
            if (cancelled_at is not None
                    and rec.state is TaskState.COMPLETED
                    and rec.start_time > cancelled_at):
                v.append(f"cancelled scope {name!r} member {rec.task_id} "
                         f"started after the scope was cancelled")
    return v


# --------------------------------------------------------------------------
# campaigns
# --------------------------------------------------------------------------
@dataclass
class CampaignResult:
    results: list[ScenarioResult] = field(default_factory=list)
    #: (seed, violation) pairs, including determinism-check mismatches
    violations: list[tuple[int, str]] = field(default_factory=list)
    wall_seconds: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        n = len(self.results)
        bad_seeds = sorted({s for s, _ in self.violations})
        head = (f"campaign: {n} scenarios, "
                f"{sum(r.events_executed for r in self.results)} events, "
                f"{self.wall_seconds:.2f}s wall")
        if self.ok:
            return head + " — all invariants held"
        return (head + f" — {len(self.violations)} violations in seeds "
                f"{bad_seeds}; reproduce with "
                f"run_scenario(Scenario.random(<seed>))")


def campaign(n: int, *, base_seed: int = 0,
             policy_factory: Callable[[], Any] | None = None,
             determinism_checks: int = 1,
             scenario_kwargs: dict[str, Any] | None = None,
             engine_kwargs: dict[str, Any] | None = None) -> CampaignResult:
    """Run ``n`` seeded chaos scenarios and check every invariant.

    Seeds are ``base_seed .. base_seed + n - 1``.  The first
    ``determinism_checks`` scenarios are executed *twice* and their
    traces compared byte-for-byte — the "same seed ⇒ identical event
    trace" invariant guarding against nondeterminism creeping into the
    engine.  Any violation names its seed; the seed alone reproduces the
    run.
    """
    kw = scenario_kwargs or {}
    out = CampaignResult()
    start = _wall.perf_counter()
    for k in range(n):
        seed = base_seed + k
        scenario = Scenario.random(seed, **kw)
        result = run_scenario(scenario, policy_factory=policy_factory,
                              engine_kwargs=engine_kwargs)
        out.results.append(result)
        for viol in result.violations:
            out.violations.append((seed, viol))
        if k < determinism_checks:
            replay = run_scenario(Scenario.random(seed, **kw),
                                  policy_factory=policy_factory,
                                  engine_kwargs=engine_kwargs)
            if replay.trace != result.trace:
                out.violations.append(
                    (seed, "nondeterminism: same seed produced a "
                           "different event trace"))
    out.wall_seconds = _wall.perf_counter() - start
    return out
