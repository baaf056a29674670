"""Thread-free cluster execution for the deterministic simulation plane.

The real :class:`~repro_torch.engine.executor.Executor` runs a pilot job per
node: a heartbeat thread plus worker threads pulling tasks off the node
queue.  :class:`SimExecutor` keeps the exact same surface — node
selection, queueing, memory/package/ulimit enforcement, worker-killed
semantics, heartbeats, cancellation, worker respawn — but runs all of it
as *events on the engine's single event loop*:

* task pickup is a ``sim-pump`` event; the task's function executes
  **inline on the loop thread** (scenario task bodies are cheap and
  pure), while its *scripted duration* is virtual: the result is
  delivered by a ``sim-complete`` event ``duration / node.speed`` virtual
  seconds later, holding the node's memory in between;
* heartbeats are periodic ``sim-hb:<node>`` events stamping the engine
  clock's time, so the DFK's heartbeat watcher, the proactive sentinel's
  silence trend and the policy engine's resume rule all see one timebase;
* Table III failure behaviours arise exactly as on the real cluster: an
  unsatisfiable spec raises :class:`EnvironmentMismatchError` /
  :class:`MemoryError` / :class:`UlimitExceededError` at pickup,
  :func:`~repro_torch.engine.cluster.kill_current_worker` inside a task body
  kills the :class:`SimWorker`, and scripted faults (node loss, heartbeat
  silence, worker kill) are applied between events by the scenario
  harness.

No real thread exists anywhere, so a whole failure scenario executes in
(timestamp, FIFO) order on one thread — deterministically.
"""
from __future__ import annotations

import queue
import traceback
from concurrent.futures._base import PENDING as _F_PENDING
from typing import Any, Callable

from repro_torch.core.failures import PilotJobInitError, WorkerLostError
from repro_torch.engine.cluster import (
    Cluster,
    Node,
    ResourcePool,
    _WorkerKilled,
    _current,
    enforce_and_reserve,
)
from repro_torch.engine.events import EventLoop
from repro_torch.engine.executor import Executor
from repro_torch.engine.task import TaskRecord, TaskState

__all__ = ["SimCluster", "SimExecutor", "SimWorker", "SimNodeManager",
           "sim_duration"]


def sim_duration(seconds: float):
    """Decorator: script a task function's *virtual* duration.

    ``@sim_duration(0.3)`` on a task body makes every simulated run of it
    occupy its worker for 0.3 virtual seconds (scaled by node speed) —
    the sim-plane replacement for ``time.sleep(0.3)`` in test tasks.
    """
    def deco(fn):
        fn.sim_duration = seconds
        return fn
    return deco


class SimCluster(Cluster):
    """A :class:`~repro_torch.engine.cluster.Cluster` earmarked for simulation.

    Structurally identical (same pools, same :class:`Node` dataclass);
    exists so harness code can assert it is not accidentally handed to a
    real, thread-spawning engine and as the home of the sim convenience
    constructors.
    """

    @staticmethod
    def from_cluster(cluster: Cluster) -> "SimCluster":
        return SimCluster(list(cluster.pools.values()))

    @staticmethod
    def homogeneous(n_nodes: int = 4, **kwargs: Any) -> "SimCluster":
        return SimCluster.from_cluster(Cluster.homogeneous(n_nodes, **kwargs))

    @staticmethod
    def paper_testbed(*args: Any, **kwargs: Any) -> "SimCluster":
        return SimCluster.from_cluster(Cluster.paper_testbed(*args, **kwargs))


class SimWorker:
    """Worker-process analog without the process: a capacity slot.

    Duck-types the fields the engine reads off a real
    :class:`~repro_torch.engine.cluster.Worker` (``alive``, ``busy``, ``node``,
    ``worker_id``) plus the in-flight bookkeeping the sim needs to cancel
    a completion when its node dies.
    """

    __slots__ = ("node", "worker_id", "alive", "busy", "current",
                 "completion", "held_gb")

    def __init__(self, node: Node, worker_id: str):
        self.node = node
        self.worker_id = worker_id
        self.alive = True
        self.busy = False
        self.current: TaskRecord | None = None
        self.completion: Any = None          # pending sim-complete event
        self.held_gb = 0.0


class SimNodeManager:
    """Pilot-job node manager as pure event-loop state (no threads)."""

    def __init__(self, node: Node, executor: "SimExecutor"):
        self.node = node
        self.executor = executor
        self._spawned = 0
        self._hb_paused = False
        self._hb_event: Any = None
        # pump coalescing: a submission burst to this node schedules ONE
        # sim-pump event, not one per record (the flag is cleared when the
        # event fires, single-threaded and therefore deterministic)
        self._pump_scheduled = False
        # network partition: the *data* path is cut while heartbeats keep
        # flowing — no pickups, and in-flight completions are buffered
        # here until the partition heals (or dropped if the node dies)
        self._partitioned = False
        self._held_deliveries: list[tuple[Any, Any, Any, BaseException | None]] = []

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if not self.node.healthy:
            raise PilotJobInitError(
                f"pilot job failed to initialize on {self.node.name}",
                node=self.node.name)
        for _ in range(self.node.workers_per_node):
            self.spawn_worker()
        # the real NodeManager's heartbeat thread beats immediately on
        # start, then every period — mirror both
        self.executor.events.call_soon(self.beat,
                                       name=f"sim-hb:{self.node.name}")
        self._hb_event = self.executor.events.schedule_periodic(
            self.executor._heartbeat_period, self.beat,
            name=f"sim-hb:{self.node.name}")

    def stop(self) -> None:
        if self._hb_event is not None:
            self._hb_event.cancel()
        for w in self.node.workers:
            w.alive = False

    # -- heartbeat / worker supervision (NodeManager._hb_loop parity) -----
    def beat(self) -> None:
        if not self.node.healthy:
            return
        if self.executor._heartbeat is not None and not self._hb_paused:
            self.executor._heartbeat(self.node.name,
                                     self.executor.clock.time())
        self.restart_dead_workers()
        self.pump()

    def spawn_worker(self) -> SimWorker:
        self._spawned += 1
        w = SimWorker(self.node, f"{self.node.name}/sw{self._spawned:04d}")
        self.node.workers.append(w)
        return w

    def alive_workers(self) -> list[SimWorker]:
        return [w for w in self.node.workers if w.alive]

    def restart_dead_workers(self) -> int:
        n = 0
        self.node.workers = [w for w in self.node.workers if w.alive]
        while len(self.node.workers) < self.node.workers_per_node:
            self.spawn_worker()
            n += 1
        return n

    def cancel(self, task_id: str) -> TaskRecord | None:
        return self.node.remove_queued(task_id)

    def pause_heartbeats(self) -> None:
        self._hb_paused = True

    def resume_heartbeats(self) -> None:
        self._hb_paused = False

    # -- scripted faults ---------------------------------------------------
    def hardware_down(self) -> None:
        """The node died: heartbeats stop, no new pickups happen.

        Real-cluster parity end to end: a busy worker's in-flight task
        still *delivers* at its scheduled completion (the real worker
        thread finishes its fn), but the ensuing heartbeat silence
        normally trips the DFK's watcher first, which fails and re-routes
        the task — the §III-B manifestation chain — and the late delivery
        is dropped by the winner-takes-future guard.  If the node is
        restored *before* the watcher's staleness window (a quick blip),
        the in-flight task simply succeeds and queued records are picked
        back up by fresh workers, exactly like the real cluster; queue
        entries whose task the watcher already re-routed and resolved are
        skipped at pickup.
        """
        self.node.healthy = False
        for w in self.node.workers:
            w.alive = False
        # completions trapped behind a partition die with the node
        for held_worker, _rec, _res, _err in self._held_deliveries:
            self._release(held_worker)
        self._held_deliveries.clear()

    def kill_worker(self, worker: SimWorker | None = None) -> bool:
        """Externally SIGKILL one (busy, else any alive) worker."""
        if worker is None:
            worker = next((w for w in self.node.workers if w.alive and w.busy),
                          None) or next(
                (w for w in self.node.workers if w.alive), None)
        if worker is None:
            return False
        worker.alive = False
        rec = worker.current
        # a completion already buffered behind a partition dies with its
        # worker — the loss error below supersedes it
        self._held_deliveries = [h for h in self._held_deliveries
                                 if h[0] is not worker]
        if rec is not None:
            if worker.completion is not None:
                worker.completion.cancel()
            self._release(worker)
            err = WorkerLostError("worker killed by injected failure",
                                  node=self.node.name, worker=worker.worker_id)
            self.executor.events.call_soon(
                self.executor._deliver, worker, rec, None, err,
                name="sim-complete")
        return True

    # -- network partition (data path cut, heartbeats flowing) ------------
    def partition(self) -> None:
        self._partitioned = True

    def heal_partition(self) -> None:
        """Reconnect the data path: flush completions that finished behind
        the partition (in completion order), then resume pickups."""
        if not self._partitioned:
            return
        self._partitioned = False
        held, self._held_deliveries = self._held_deliveries, []
        for worker, rec, result, err in held:
            self.executor._deliver(worker, rec, result, err)
        self.schedule_pump()

    # -- execution ---------------------------------------------------------
    def schedule_pump(self) -> None:
        """Request a pickup pass; coalesces into one pending pump event."""
        if self._pump_scheduled:
            return
        self._pump_scheduled = True
        self.executor.events.call_soon(self._pump_event, name="sim-pump")

    def _pump_event(self) -> None:
        self._pump_scheduled = False
        self.pump()

    def pump(self) -> None:
        """Assign queued records to free workers (the pickup event).

        When this node's own queue is dry and a free worker remains, the
        pump tries to *steal* the newest queued record off a loaded
        sibling (a no-op unless the engine enabled work stealing) — the
        event-loop analog of the real worker's steal-on-idle, running
        deterministically in (timestamp, FIFO) event order.
        """
        if not self.node.healthy or self._partitioned:
            return
        while True:
            # plain loop, not next(genexp): restart_dead_workers() may
            # rebind node.workers mid-drain (a task body killing the last
            # worker triggers an inline respawn), so re-read it each pass
            worker = None
            for w in self.node.workers:
                if w.alive and not w.busy:
                    worker = w
                    break
            if worker is None:
                return
            try:
                rec = self.node.task_queue.get_nowait()
            except queue.Empty:
                rec = self.executor.steal_task(self.node)
                if rec is None:
                    return
            if rec is None or rec.cancel_requested or (
                    rec.future is not None
                    and rec.future._state != _F_PENDING):
                # cancelled while queued, or a stale entry whose task was
                # already re-routed and resolved elsewhere (e.g. failed by
                # the heartbeat watcher while this node was down): drop.
                # The raw _state read (vs. future.done(), which takes the
                # condition) is safe here: the sim is single-threaded, and
                # engine futures only ever leave PENDING to terminal states
                continue
            self.executor._start_task(self, worker, rec)

    def _release(self, worker: SimWorker) -> None:
        if worker.held_gb:
            with self.node._mem_lock:
                self.node.mem_in_use_gb -= worker.held_gb
            worker.held_gb = 0.0
        if worker.busy:
            self.node.adjust_busy(-1)
        worker.busy = False
        worker.current = None
        worker.completion = None


class SimExecutor(Executor):
    """Executor whose pool executes as events on the engine's loop.

    Construction mirrors :class:`~repro_torch.engine.executor.Executor` plus the
    loop itself and an optional duration script::

        SimExecutor(pool, on_result, events=dfk.events, clock=vclock,
                    durations={"train_step": 0.5})

    ``durations`` maps task-template names to *nominal* virtual seconds
    (or is a callable ``(record, node) -> seconds | None``); unscripted
    tasks fall back to an ``@sim_duration`` attribute on the function,
    then to the spec's ``est_duration_s``.  Nominal time divides by
    ``node.speed``, so stragglers straggle in virtual time too.
    """

    def __init__(self, pool: ResourcePool,
                 on_result: Callable[..., Any], *,
                 events: EventLoop,
                 durations: dict[str, float] | Callable[..., Any] | None = None,
                 **kwargs: Any):
        super().__init__(pool, on_result, **kwargs)
        self.events = events
        self.durations = durations
        self.managers: dict[str, SimNodeManager] = {}

    @classmethod
    def factory(cls, durations: dict[str, float] | Callable[..., Any] | None
                = None) -> Callable[..., "SimExecutor"]:
        """An ``executor_factory`` for :class:`~repro_torch.engine.dfk.
        DataFlowKernel`: ``DataFlowKernel(..., clock=vclock,
        executor_factory=SimExecutor.factory(durations))``."""
        def make(dfk: Any, pool: ResourcePool) -> "SimExecutor":
            hb = dfk.monitor.heartbeat if dfk.monitor is not None else None
            return cls(pool, dfk._on_result, events=dfk.events,
                       durations=durations, scheduler=dfk.scheduler,
                       heartbeat=hb,
                       denylisted=dfk.denylist.__contains__,
                       heartbeat_period=dfk.heartbeat_period,
                       clock=dfk.clock,
                       steal=getattr(dfk, "work_stealing", False),
                       on_steal=dfk._record_steal)
        return make

    # -- pilot-job lifecycle ----------------------------------------------
    def _make_manager(self, node: Node) -> SimNodeManager:  # type: ignore[override]
        # the base Executor's start()/add_node() call this, so elastic
        # join reuses the real executor's membership path verbatim
        return SimNodeManager(node, self)

    def stop(self) -> None:
        for mgr in self.managers.values():
            mgr.stop()
        self._started = False

    # -- scheduling ---------------------------------------------------------
    def submit(self, record: TaskRecord) -> Node | None:
        node = super().submit(record)
        if node is not None:
            mgr = self.managers.get(node.name)
            if mgr is not None:
                mgr.schedule_pump()
        return node

    # -- scripted faults ----------------------------------------------------
    def fail_node(self, node_name: str) -> None:
        """Hardware loss: node down, heartbeats stop, in-flight tasks lost."""
        mgr = self.managers.get(node_name)
        if mgr is not None:
            mgr.hardware_down()

    def restore_node(self, node_name: str) -> None:
        node = next((n for n in self.pool.nodes if n.name == node_name), None)
        if node is not None:
            node.restore_hardware()
        mgr = self.managers.get(node_name)
        if mgr is not None:
            mgr.restart_dead_workers()
            # records still queued from before the outage get picked back up
            mgr.schedule_pump()

    # -- inline execution ---------------------------------------------------
    def _duration(self, rec: TaskRecord, node: Node,
                  spec: Any = None) -> float:
        base: float | None = None
        if callable(self.durations):
            base = self.durations(rec, node)
        elif self.durations is not None:
            base = self.durations.get(rec.name)
        if base is None:
            base = getattr(rec.fn, "sim_duration", None)
        if base is None:
            base = (spec if spec is not None
                    else rec.effective_resources()).est_duration_s
        if not base:
            return 0.0
        return max(float(base), 0.0) / max(node.speed, 1e-6)

    def _start_task(self, mgr: SimNodeManager, worker: SimWorker,
                    rec: TaskRecord) -> None:
        """One pickup: enforce the environment, run the body inline, and
        schedule the completion at +duration virtual seconds.

        Enforcement is the *same* :func:`~repro_torch.engine.cluster.
        enforce_and_reserve` chain the real worker runs — the paper's
        "200 GB task on a 192 GB node" arises naturally here too, not by
        scripting the error.
        """
        node = mgr.node
        spec = rec.effective_resources()
        rec.start_time = self.clock.time()
        if rec.state in (TaskState.READY, TaskState.SCHEDULED,
                         TaskState.RETRYING):
            rec.state = TaskState.RUNNING
            if rec.on_running is not None:
                try:
                    rec.on_running(rec)
                except Exception:  # noqa: BLE001 - policy bug must not kill the sim
                    pass
        err: BaseException | None = None
        result: Any = None
        duration = 0.0
        try:
            worker.held_gb = enforce_and_reserve(node, spec)
        except BaseException as e:  # noqa: BLE001 - env failures deliver at +0
            err = e
        if err is None:
            # expose the node/worker through the same thread-local the real
            # Worker sets, so task bodies calling current_node() behave
            # identically under simulation
            _current.node, _current.worker = node, worker
            try:
                result = rec.fn(*rec.args, **rec.kwargs)
                duration = self._duration(rec, node, spec)
            except _WorkerKilled as wk:
                worker.alive = False
                err = WorkerLostError(str(wk), node=node.name,
                                      worker=worker.worker_id)
            except BaseException as e:  # noqa: BLE001 - capture everything
                err = e
                err._wrath_traceback = traceback.format_exc()  # type: ignore[attr-defined]
            finally:
                _current.node = _current.worker = None
        if duration == 0.0:
            # Inline delivery: a zero-duration completion scheduled at +0
            # virtual seconds would fire at this same timestamp anyway, so
            # skipping the sim-complete round-trip (heap push/pop, release,
            # re-pump) changes no virtual time and no task outcome — it
            # removes the dominant per-task event cost of large sweeps.
            # The worker is never marked busy: it is free again before the
            # pump loop's next pickup, exactly as after a +0 delivery.
            if worker.held_gb:
                with node._mem_lock:
                    node.mem_in_use_gb -= worker.held_gb
                worker.held_gb = 0.0
            rec.end_time = rec.start_time
            self.on_result(rec, result, err, worker)
            return
        worker.busy = True
        node.adjust_busy(+1)
        worker.current = rec
        worker.completion = self.events.call_later(
            duration, self._deliver, worker, rec, result, err,
            name="sim-complete")

    def _deliver(self, worker: SimWorker, rec: TaskRecord, result: Any,
                 err: BaseException | None) -> None:
        """The completion event: release resources, hand the DFK the result."""
        mgr = self.managers.get(worker.node.name)
        if mgr is not None and mgr._partitioned:
            # data path cut: the task finished on the far side but the
            # result can't cross; buffer until partition_heal (or drop on
            # node death).  Heartbeats keep flowing elsewhere, so the
            # engine sees a healthy node that delivers nothing.
            mgr._held_deliveries.append((worker, rec, result, err))
            return
        if mgr is not None:
            mgr._release(worker)
        rec.end_time = self.clock.time()
        self.on_result(rec, result, err, worker)
        if mgr is not None:
            mgr.schedule_pump()
