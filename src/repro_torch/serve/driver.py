"""WRATH-supervised serving driver: static batches or a continuous plane.

Serving plane of the reproduction: requests are batched and decoded
token-by-token on a pool of *replicas* (virtual serving hosts, an
``engine.cluster`` pool).  WRATH supervises replica health exactly as it
supervises tasks: a replica lost mid-decode (environment layer) is
denylisted and its in-flight requests are retried on a healthy replica —
generated tokens are replayed by teacher-forcing, so none are lost
(atomic-step semantics, the serving analog of the paper's atomic tasks).

Two serving modes share the replica pool, scheduler, policy stack and
monitoring plumbing:

* :meth:`WrathServeDriver.serve` — the **static batcher** baseline: form
  a batch, run it to the *longest* member's completion, then form the
  next one.  Simple, synchronous, and pays head-of-line blocking twice
  (short requests wait for long slot-mates; the queue waits for the
  whole batch).
* :meth:`WrathServeDriver.serve_continuous` — the **production plane**:
  a clock-driven :class:`~repro.serve.queue.RequestQueue` feeds replica
  slots at every step boundary (continuous batching — a finished request
  vacates its slot and the next queued request takes it immediately),
  the policy stack's ``admit_request`` hook applies SLO-aware admission
  control before a request ever holds a slot, and a periodic policy tick
  lets a :class:`~repro.serve.autoscaler.ReplicaAutoscaler` grow or
  shrink the pool from monitored queue-depth trends.

All time flows through an injected :class:`~repro.engine.events.Clock`
(default :data:`~repro.engine.events.REAL_CLOCK`).  With a
:class:`repro.sim.VirtualClock` and the simulated decode backend the
whole plane — arrivals, decode steps, chaos faults, deadlines, autoscale
ticks — executes deterministically inline via the event loop's
``run_until``: a minute of traffic replays byte-identically in
milliseconds.

Replica selection goes through the pluggable
:class:`~repro.engine.scheduler.Scheduler` interface
(``WrathServeDriver(scheduler=...)``), and failover decisions flow
through the composable :class:`~repro.engine.policies.PolicyStack`
(``policy=...``, default a single
:class:`~repro.engine.policies.WrathPolicy`).  The serving loop drives
the decision subset of the policy protocol — ``on_submit``,
``on_failure``, ``review_decision``, ``admit_request``, ``on_tick``.
Engine-execution policies (``replicate``'s racing copies) need the
DataFlowKernel's copy machinery and are inert here.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import MonitoringDatabase
from repro_torch.core.failures import FailureReport, HardwareShutdownError
from repro_torch.engine.cluster import Cluster, Node, ResourcePool
from repro_torch.engine.events import REAL_CLOCK, Clock, EventLoop
from repro_torch.engine.policies import PolicyStack, WrathPolicy, normalize_policies
from repro_torch.engine.retry_api import Action, RetryDecision, SchedulingContext
from repro_torch.engine.scheduler import RoundRobinScheduler, Scheduler
from repro_torch.engine.task import ResourceSpec, TaskDef, new_task_record
from repro_torch.models.config import ModelConfig
from repro_torch.serve.batcher import (DecodeBackend, ReplicaSlots,
                                       SimDecodeBackend, TorchDecodeBackend,
                                       advance_slots)
from repro_torch.serve.queue import RequestQueue, ServeRequest, SLOAdmissionPolicy

#: back-compat alias — the request type grew SLO fields and moved to
#: repro.serve.queue
Request = ServeRequest


def _quantile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank quantile of an ascending-sorted sample."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[i]


@dataclasses.dataclass
class ServeReport:
    completed: int
    failed: int
    tokens_generated: int
    recoveries: list[dict]
    denylisted: list[str]
    wall_s: float
    # per-replica health snapshot from the monitoring database's streaming
    # profiles (success rate + decode-duration mean/p95)
    replica_health: dict[str, dict] = dataclasses.field(default_factory=dict)
    # -- continuous-plane extensions (zero in static mode) ---------------
    rejected: int = 0            # refused at admission (no decode steps)
    shed: int = 0                # expired in queue / drained at horizon
    decode_steps: int = 0
    queue_peak: int = 0
    p50_s: float = 0.0           # arrival -> finish latency percentiles
    p99_s: float = 0.0
    autoscaled_up: int = 0
    autoscaled_down: int = 0
    replicas_final: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / max(self.wall_s, 1e-9)

    @property
    def requests_per_s(self) -> float:
        return self.completed / max(self.wall_s, 1e-9)

    @property
    def shed_rate(self) -> float:
        """Fraction of arrivals refused or expired before completion."""
        total = self.completed + self.failed + self.rejected + self.shed
        return (self.rejected + self.shed) / max(total, 1)


class WrathServeDriver:
    """Replica-pool serving with WRATH failover, admission and autoscale.

    ``decode`` selects the execution backend: ``"torch"`` (default, the
    real model via :class:`~repro_torch.serve.batcher.TorchDecodeBackend`
    on ``cuda``),
    ``"sim"`` (modeled step costs, deterministic tokens — pairs with a
    :class:`repro.sim.VirtualClock`), or any
    :class:`~repro.serve.batcher.DecodeBackend` instance.

    ``admission=True`` installs an
    :class:`~repro.serve.queue.SLOAdmissionPolicy` after the user stack
    (pass an instance to tune it).  Policies with a true
    ``serve_plane_aware`` attribute (the admission policy, the
    autoscaler) are bound to this driver at construction.
    """

    def __init__(self, cfg: ModelConfig, *, n_replicas: int = 3,
                 max_batch: int = 4, seed: int = 0,
                 scheduler: Scheduler | None = None,
                 policy: object = None,
                 health_gate: bool = True,
                 clock: Clock | None = None,
                 monitor: MonitoringDatabase | None = None,
                 decode: str | DecodeBackend = "torch",
                 admission: object = None,
                 queue_capacity: int | None = None,
                 max_len: int = 64):
        self.cfg = cfg
        self.max_batch = max_batch
        self.health_gate = health_gate
        self.clock = clock or REAL_CLOCK
        nodes = [Node(f"replica{i}", workers_per_node=1)
                 for i in range(n_replicas)]
        self._replica_seq = n_replicas
        self.cluster = Cluster([ResourcePool("serve", nodes)])
        self.monitor = monitor if monitor is not None else \
            MonitoringDatabase(clock=clock)
        # policy=None -> WRATH default; an explicit empty stack ([]) is a
        # valid choice meaning Parsl-style baseline retry only
        stack = tuple(normalize_policies(policy) if policy is not None
                      else (WrathPolicy(),))
        if admission is True:
            stack += (SLOAdmissionPolicy(),)
        elif admission:
            stack += (admission,)
        self.policies = PolicyStack(stack, on_error=self._policy_error)
        self.scheduler = (scheduler or RoundRobinScheduler()).bind(
            cluster=self.cluster, monitor=self.monitor)
        self.denylist: set[str] = set()
        if isinstance(decode, DecodeBackend):
            self.backend = decode
        elif decode == "sim":
            self.backend = SimDecodeBackend()
        else:
            self.backend = TorchDecodeBackend(cfg, max_batch=max_batch,
                                              seed=seed, max_len=max_len)
        # -- continuous plane state ------------------------------------
        self.queue = RequestQueue(clock=self.clock, capacity=queue_capacity,
                                  monitor=self.monitor)
        self.events: EventLoop | None = None
        self._slots: dict[str, ReplicaSlots] = {}
        for n in nodes:
            self.backend.start_replica(n)
            self._slots[n.name] = ReplicaSlots(max_batch)
        self._step_scheduled: set[str] = set()
        self._requests: list[ServeRequest] = []
        self.recoveries: list[dict] = []
        self.decode_steps = 0
        self.autoscaled_up = 0
        self.autoscaled_down = 0
        # bind serve-plane-aware policies (admission, autoscaler)
        for p in self.policies.policies:
            if getattr(p, "serve_plane_aware", False):
                p.bind(self)

    # -- lifecycle ------------------------------------------------------ #
    def __enter__(self) -> "WrathServeDriver":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def shutdown(self) -> None:
        if self.events is not None:
            self.events.stop()
            self.events.join(timeout=2.0)
            self.events = None

    def _ensure_loop(self) -> EventLoop:
        if self.events is None:
            self.events = EventLoop("serve-events", clock=self.clock,
                                    on_error=self._loop_error).start()
        return self.events

    def _loop_error(self, name: str, err: BaseException) -> None:
        self.monitor.record_system_event(
            "serve_event_error", source=name, error=type(err).__name__,
            message=str(err))

    def _policy_error(self, hook: str, err: BaseException) -> None:
        """Swallowed policy-hook exceptions stay visible as system events."""
        self.monitor.record_system_event(
            "policy_error", hook=hook, error=type(err).__name__,
            message=str(err))

    def _ctx(self) -> SchedulingContext:
        return SchedulingContext(cluster=self.cluster, monitor=self.monitor,
                                 denylist=self.denylist, default_pool="serve",
                                 scheduler=self.scheduler, clock=self.clock)

    # -- replica pool ---------------------------------------------------- #
    def replicas(self) -> list[Node]:
        return [n for n in self.cluster.pools["serve"].nodes
                if n.healthy and n.name not in self.denylist]

    def live_replicas(self) -> list[Node]:
        """Replicas with decode state attached (the continuous plane's
        serving set) — healthy, not denylisted, not retired."""
        return [n for n in self.replicas() if n.name in self._slots]

    def total_slots(self) -> int:
        return sum(self._slots[n.name].max_batch
                   for n in self.live_replicas())

    def backlog_steps(self) -> int:
        """Decode steps owed to queued + in-flight requests (admission's
        queue-delay estimator).  Queued requests are counted from their
        replay state (failover requeues owe prompt + recovered tokens),
        in-flight occupants from their live slot state — both via the
        request's own step accounting, which ends on the step that emits
        the final token (the old inline formula double-counted that
        boundary step for every occupant)."""
        steps = sum(r.steps_total for r in self.queue.queued())
        for n in self.live_replicas():
            steps += sum(r.steps_remaining
                         for r in self._slots[n.name].occupants())
        return steps

    def replica_idle(self, node: Node) -> bool:
        slots = self._slots.get(node.name)
        return (slots is not None and not slots.occupants()
                and node.name not in self._step_scheduled)

    def add_replica(self, *, reason: str = "") -> Node | None:
        """Grow the serve pool by one replica (autoscaler/ops entry)."""
        name = f"replica{self._replica_seq}"
        self._replica_seq += 1
        node = Node(name, workers_per_node=1)
        self.cluster.pools["serve"].add_node(node)
        self.backend.start_replica(node)
        self._slots[name] = ReplicaSlots(self.max_batch)
        self.autoscaled_up += 1
        self.monitor.record_system_event(
            "autoscale_grow", node=name, reason=reason,
            replicas=len(self.live_replicas()))
        if self.events is not None:
            self.events.call_soon(self._pump, name="pump")
        return node

    def remove_replica(self, name: str, *, reason: str = "") -> bool:
        """Retire an *idle* replica (refuses while requests are in
        flight — scale-down never evicts work)."""
        slots = self._slots.get(name)
        if slots is None or slots.occupants() or name in self._step_scheduled:
            return False
        del self._slots[name]
        self.backend.drop_replica(name)
        pool = self.cluster.pools["serve"]
        pool.nodes = [n for n in pool.nodes if n.name != name]
        self.autoscaled_down += 1
        self.monitor.record_system_event(
            "autoscale_shrink", node=name, reason=reason,
            replicas=len(self.live_replicas()))
        return True

    def _pick_replica(self, rec, exclude: str | None = None) -> Node | None:
        """Scheduler-driven replica selection over the healthy serve pool.

        With ``health_gate`` the monitoring database's placement profile is
        consulted first: a replica that has only ever failed batches
        (>= 2 failures, 0 successes) is skipped while healthier candidates
        exist — the serving analog of the proactive plane's "stop placing
        on a node trending toward failure".
        """
        pool = self.cluster.pools["serve"]
        candidates = [n for n in self.replicas() if n.name != exclude]
        if self.health_gate and candidates:
            hist = self.monitor.node_history("decode_batch")

            def suspect(n: Node) -> bool:
                s = hist.get(n.name)
                return s is not None and s.failures >= 2 and s.successes == 0

            vetted = [n for n in candidates if not suspect(n)]
            candidates = vetted or candidates
        return self.scheduler.select(rec, candidates or self.replicas(),
                                     pool=pool)

    def _apply_denylist(self, replica: Node, decision: RetryDecision) -> None:
        """Driver-owned denylisting of a lost replica.

        Historically only :class:`~repro.core.policy.WrathPolicy`'s engine
        updated the denylist (it mutates ``ctx.denylist`` directly), so a
        custom stack — ``policy=[replay(3)]`` — silently kept routing
        retries at the dead replica.  The driver now denylists on the
        *decision*: the replica is down, or the policy explicitly moved
        the work elsewhere.  Guarded so WrathPolicy's own denylist event
        is not duplicated.
        """
        if replica.name in self.denylist:
            return
        moved = bool(decision.target_node
                     and decision.target_node != replica.name)
        if not replica.healthy or moved:
            self.denylist.add(replica.name)
            self.monitor.record_system_event(
                "denylist_add", node=replica.name, source="serve_driver")

    def replica_health(self) -> dict[str, dict]:
        """Streaming-profile health snapshot of every replica."""
        hist = self.monitor.node_history("decode_batch")
        out: dict[str, dict] = {}
        for n in self.cluster.pools["serve"].nodes:
            stats = hist.get(n.name)
            dur = self.monitor.duration_stats("decode_batch", node=n.name)
            out[n.name] = {
                "live": n.healthy and n.name not in self.denylist,
                "batches": stats.total if stats else 0,
                "success_rate": stats.success_rate if stats else None,
                "decode_s_mean": dur.mean if dur else None,
                "decode_s_p95": dur.p95 if dur else None,
            }
        return out

    # ================== static batcher (baseline) ===================== #
    def serve(self, requests: list[ServeRequest], *,
              kill_replica_at: tuple[str, int] | None = None) -> ServeReport:
        """Static batching: fixed batches run to the longest member.

        Optionally kills a replica after N decode calls (chaos hook for
        the failover tests)."""
        t0 = self.clock.now()
        recoveries: list[dict] = []
        completed = failed = tokens = 0
        decode_calls = 0
        queue = list(requests)
        while queue:
            batch_reqs = queue[:self.max_batch]
            queue = queue[len(batch_reqs):]
            # one task record per batch: retry budget and attempt history
            # are tracked across replica failovers of the same batch
            rec = new_task_record(
                TaskDef(lambda: None, "decode_batch", ResourceSpec(), 2),
                (), {}, default_retries=2)
            # full middleware protocol: on_submit lets policies set up
            # per-record state (e.g. deferred replay's budget extension)
            self.policies.on_submit(rec, self._ctx())
            replica = self._pick_replica(rec)
            if replica is None:
                failed += len(batch_reqs)
                for r in batch_reqs:
                    r.status, r.reason = "failed", "no live replica"
                continue
            # a scratch slot frame per batch: static mode never refills a
            # vacated slot, so the batch steps until its longest member
            slots = ReplicaSlots(self.max_batch)
            for r in batch_reqs:
                slots.admit(r)
            batch_t0 = self.clock.now()
            step = 0
            while slots.occupants():
                if kill_replica_at and decode_calls == kill_replica_at[1]:
                    victim = self.cluster.find_node(kill_replica_at[0])
                    if victim is not None:
                        victim.shutdown_hardware()
                inputs = [r.feed[r.pos] if r is not None else None
                          for r in slots.slots]
                try:
                    nxt = self.backend.step(replica, inputs)
                except HardwareShutdownError as err:
                    rec.record_attempt(node=replica.name, pool="serve",
                                       worker="-", ok=False,
                                       error=type(err).__name__,
                                       duration=self.clock.now() - batch_t0,
                                       now=self.clock.time())
                    self.monitor.record_task_placement(
                        "decode_batch", replica.name, "serve", ok=False)
                    report = FailureReport.from_exception(
                        err, task_id=rec.task_id, node=replica.name,
                        pool="serve")
                    decision = self.policies.decide(rec, report, self._ctx())
                    self._apply_denylist(replica, decision)
                    recoveries.append({
                        "replica": replica.name, "step": step,
                        "action": decision.action.value,
                        "rung": decision.rung})
                    survivors = slots.evict_all()
                    if decision.action is Action.FAIL or not self.replicas():
                        failed += len(survivors)
                        for r in survivors:
                            r.status, r.reason = "failed", "replica lost"
                        break
                    rec.retry_count += 1
                    replica = (self.cluster.find_node(decision.target_node)
                               or self._pick_replica(rec,
                                                     exclude=replica.name))
                    if replica is None:
                        failed += len(survivors)
                        for r in survivors:
                            r.status, r.reason = "failed", "no live replica"
                        break
                    # recovery: teacher-forced replay of prompt+generated
                    # on the rescuer — no generated token is lost
                    for r in survivors:
                        r.recoveries += 1
                        slots.admit(r)
                    batch_t0 = self.clock.now()  # rescuer timed from takeover
                    continue
                decode_calls += 1
                cost = self.backend.step_cost_s(replica)
                if cost is not None and self.clock.virtual:
                    self.clock.advance(cost)  # type: ignore[attr-defined]
                for r in advance_slots(slots, nxt):
                    r.status = "done"
                    r.finish_t = self.clock.now()
                    tokens += len(r.generated)
                    completed += 1
                step += 1
            else:
                self.monitor.record_task_placement(
                    "decode_batch", replica.name, "serve", ok=True,
                    duration=self.clock.now() - batch_t0)
        return ServeReport(completed=completed, failed=failed,
                           tokens_generated=tokens, recoveries=recoveries,
                           denylisted=sorted(self.denylist),
                           wall_s=self.clock.now() - t0,
                           replica_health=self.replica_health(),
                           decode_steps=decode_calls,
                           replicas_final=len(self.replicas()))

    # ================== continuous plane =============================== #
    def submit(self, req: ServeRequest) -> bool:
        """Admit one request into the continuous plane; False = rejected.

        Admission (capacity + the policy stack's ``admit_request`` veto)
        happens here — a rejected request never holds a queue position,
        a batch slot, or a decode step.
        """
        self._ensure_loop()
        self._requests.append(req)
        rec = new_task_record(
            TaskDef(lambda: None, "serve_request", ResourceSpec(), 2),
            (), {}, default_retries=2)
        req._rec = rec
        ok = self.queue.push(req, stack=self.policies, ctx=self._ctx())
        if ok:
            self.policies.on_submit(rec, self._ctx())
            self.events.call_soon(self._pump, name="pump")
        return ok

    def _pump(self) -> None:
        """Refill free slots from the queue (the continuous-batching core).

        Runs on the event loop whenever capacity may have appeared: a
        request finished, a replica joined, a request arrived.  Each
        pulled request is placed by the scheduler among replicas that
        currently have a free slot and joins that replica's in-flight
        batch at its next step boundary.
        """
        while True:
            candidates = [n for n in self.live_replicas()
                          if self._slots[n.name].free_count() > 0]
            if not candidates:
                return
            free = sum(self._slots[n.name].free_count() for n in candidates)
            batch = self.queue.pop_ready(free)
            if not batch:
                return
            for req in batch:
                candidates = [n for n in self.live_replicas()
                              if self._slots[n.name].free_count() > 0]
                if not candidates:  # pragma: no cover - free counted above
                    self.queue.push(req, front=True)
                    return
                node = self.scheduler.select(
                    req._rec, candidates, pool=self.cluster.pools["serve"])
                if node is None:
                    node = candidates[0]
                self._slots[node.name].admit(req)
                self._schedule_step(node)

    def _schedule_step(self, node: Node) -> None:
        """Arm the next decode step for ``node`` (one in flight at most)."""
        name = node.name
        if name in self._step_scheduled or name not in self._slots:
            return
        if not self._slots[name].occupants():
            return
        self._step_scheduled.add(name)
        cost = self.backend.step_cost_s(node)
        if cost is None:
            self.events.call_soon(self._step, name, name="decode_step")
        else:
            # the step completes cost seconds from now (modeled decode)
            self.events.call_later(cost, self._step, name,
                                   name="decode_step")

    def _step(self, name: str) -> None:
        """One decode step on one replica: the padded program ticks, every
        occupant advances one token, finished occupants vacate."""
        self._step_scheduled.discard(name)
        node = self.cluster.find_node(name)
        slots = self._slots.get(name)
        if node is None or slots is None:
            return
        occ = slots.occupants()
        if not occ:
            return
        inputs = [r.feed[r.pos] if r is not None else None
                  for r in slots.slots]
        t0 = self.clock.now()
        try:
            nxt = self.backend.step(node, inputs)
        except HardwareShutdownError as err:
            self._on_replica_loss(node, slots, err)
            self._pump()
            return
        cost = self.backend.step_cost_s(node)
        duration = cost if cost is not None else (self.clock.now() - t0)
        self.decode_steps += 1
        # the streaming decode_step profile drives admission's p95 estimate
        self.monitor.record_task_placement("decode_step", name, "serve",
                                           ok=True, duration=duration)
        finished = advance_slots(slots, nxt)
        now = self.clock.now()
        for req in occ:
            if req.generated and not req.first_token_t:
                req.first_token_t = now
        for req in finished:
            req.status = "done"
            req.finish_t = now
            if req._rec is not None:
                req._rec.record_attempt(node=name, pool="serve", worker="-",
                                        ok=True, error=None,
                                        duration=req.latency_s,
                                        now=self.clock.time())
            self.monitor.record_system_event(
                "request_done", rid=req.rid, node=name,
                latency_s=round(req.latency_s, 6))
        if finished:
            self._pump()
        self._schedule_step(node)

    def _on_replica_loss(self, node: Node, slots: ReplicaSlots,
                         err: HardwareShutdownError) -> None:
        """Failover: evict occupants, consult the policy stack per request,
        requeue survivors at the head (they already waited their turn)."""
        evicted = slots.evict_all()
        self._slots.pop(node.name, None)
        self.backend.drop_replica(node.name)
        self.monitor.record_system_event("replica_lost", node=node.name,
                                         in_flight=len(evicted))
        now = self.clock.now()
        for req in evicted:
            rec = req._rec
            rec.record_attempt(node=node.name, pool="serve", worker="-",
                               ok=False, error=type(err).__name__,
                               duration=now - req.arrival_t,
                               now=self.clock.time())
            self.monitor.record_task_placement("decode_step", node.name,
                                               "serve", ok=False)
            report = FailureReport.from_exception(
                err, task_id=rec.task_id, node=node.name, pool="serve")
            decision = self.policies.decide(rec, report, self._ctx())
            self._apply_denylist(node, decision)
            self.recoveries.append({
                "replica": node.name, "rid": req.rid,
                "action": decision.action.value, "rung": decision.rung})
            if (decision.action is Action.FAIL
                    or rec.retry_count >= rec.max_retries
                    or not self.live_replicas()):
                req.status = "failed"
                req.reason = f"replica {node.name} lost"
                req.finish_t = now
                continue
            rec.retry_count += 1
            req.recoveries += 1
            self.queue.push(req, front=True)

    def _tick(self) -> None:
        """Periodic policy tick: sample serve gauges, run ``on_tick``."""
        slots_total = self.total_slots()
        occupied = sum(len(self._slots[n.name].occupants())
                       for n in self.live_replicas())
        self.monitor.record_gauge("serve.queue_depth", self.queue.depth())
        self.monitor.record_gauge("serve.slot_occupancy",
                                  occupied / max(slots_total, 1))
        self.policies.on_tick(self._ctx())

    def inject_fault(self, kind: str, name: str) -> None:
        """Chaos hook: ``kill`` or ``restore`` a replica by name."""
        node = self.cluster.find_node(name)
        if node is None:
            return
        if kind == "kill":
            node.shutdown_hardware()
            self.monitor.record_system_event("fault_injected", node=name,
                                             kind="kill")
            slots = self._slots.get(name)
            if slots is not None and not slots.occupants():
                # idle victim: no pending step will trip over it, so
                # retire its decode state directly
                self._slots.pop(name, None)
                self.backend.drop_replica(name)
                self.monitor.record_system_event("replica_lost", node=name,
                                                 in_flight=0)
        elif kind == "restore":
            node.restore_hardware()
            self.denylist.discard(name)
            if name not in self._slots:
                self.backend.start_replica(node)
                self._slots[name] = ReplicaSlots(self.max_batch)
            self.monitor.record_system_event("fault_injected", node=name,
                                             kind="restore")
            if self.events is not None:
                self.events.call_soon(self._pump, name="pump")

    def serve_continuous(self, requests: list[ServeRequest], *,
                         arrivals: list[float] | None = None,
                         faults: list[tuple[float, str, str]] | None = None,
                         horizon: float = 60.0,
                         tick_period: float = 0.25,
                         drain_s: float = 0.0) -> ServeReport:
        """Run the continuous plane over a request window.

        ``arrivals[i]`` is request i's arrival offset in seconds from the
        start (default: everything arrives at t=0); ``faults`` are
        ``(offset_s, "kill"|"restore", replica_name)`` chaos events.  The
        call returns when every request in the window is terminal or the
        ``horizon`` elapses (stragglers are then shed/failed, never left
        dangling); ``drain_s`` keeps the policy tick running that much
        longer after the last request settles, giving the autoscaler its
        idle window to scale back down.  Under a virtual clock the whole
        window executes deterministically inline.
        """
        events = self._ensure_loop()
        t_start = self.clock.now()
        window = list(requests)
        for i, req in enumerate(window):
            at = arrivals[i] if arrivals else 0.0
            events.call_at(t_start + at, self.submit, req, name="arrival")
        for at, kind, victim in faults or ():
            events.call_at(t_start + at, self.inject_fault, kind, victim,
                           name="fault")
        tick = events.schedule_periodic(tick_period, self._tick,
                                        name="policy_tick")

        def settled() -> bool:
            return all(r.terminal for r in window)

        if self.clock.virtual:
            events.run_until(settled, deadline=t_start + horizon)
            if drain_s > 0:
                events.run_until(deadline=self.clock.now() + drain_s)
        else:
            while not settled() and self.clock.now() < t_start + horizon:
                self.clock.sleep(0.001)
            if drain_s > 0:
                self.clock.sleep(drain_s)
        tick.cancel()
        now = self.clock.now()
        for req in self.queue.drain("horizon reached"):
            pass
        for req in window:
            if not req.terminal:  # still seated in a slot at the horizon
                req.status, req.reason = "failed", "horizon reached"
                req.finish_t = now
        return self._report(window, wall_s=now - t_start)

    def _report(self, window: list[ServeRequest], *,
                wall_s: float) -> ServeReport:
        done = [r for r in window if r.status == "done"]
        lat = sorted(r.latency_s for r in done)
        return ServeReport(
            completed=len(done),
            failed=sum(1 for r in window if r.status == "failed"),
            tokens_generated=sum(len(r.generated) for r in window),
            recoveries=list(self.recoveries),
            denylisted=sorted(self.denylist),
            wall_s=wall_s,
            replica_health=self.replica_health(),
            rejected=sum(1 for r in window if r.status == "rejected"),
            shed=sum(1 for r in window if r.status == "shed"),
            decode_steps=self.decode_steps,
            queue_peak=self.queue.peak_depth,
            p50_s=_quantile(lat, 0.50),
            p99_s=_quantile(lat, 0.99),
            autoscaled_up=self.autoscaled_up,
            autoscaled_down=self.autoscaled_down,
            replicas_final=len(self.live_replicas()),
        )
