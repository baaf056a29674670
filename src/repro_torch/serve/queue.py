"""Request plane: clock-driven queue + SLO-aware admission control.

The front half of the serving subsystem (queue → admission → batcher →
replicas).  A :class:`ServeRequest` carries its SLO (``deadline_s``,
relative to arrival); the :class:`RequestQueue` stamps arrivals on the
engine's :class:`~repro.engine.events.Clock`, runs every push through the
driver's :class:`~repro.engine.policies.PolicyStack` ``admit_request``
hook, and sheds queued requests whose deadline expires before a decode
slot frees up.

:class:`SLOAdmissionPolicy` is the WRATH fast-fail idea applied to the
request plane: instead of letting a request that *cannot* meet its
deadline consume decode steps and fail late, admission projects its
completion time from the monitoring database's streaming decode-step
profile (p95) plus the current queue backlog, and rejects it at the door.
Rejection is cheap (no slot, no decode step, no KV cache); the client
gets an immediate signal to back off or route elsewhere — the serving
analog of the paper's "immediate termination to avoid wasted compute".
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any

from repro_torch.engine.events import REAL_CLOCK, Clock
from repro_torch.engine.policies import ResiliencePolicy
from repro_torch.engine.retry_api import SchedulingContext

#: terminal request states
TERMINAL_STATUSES = ("done", "failed", "rejected", "shed")


@dataclass
class ServeRequest:
    """One generation request with its SLO.

    ``deadline_s`` is the request's latency budget relative to arrival
    (``None`` = best-effort, never rejected or shed on time).  Timing
    fields are stamped on the serving driver's clock (virtual-time-exact
    under ``repro.sim``).
    """

    rid: int
    prompt: list[int]
    max_new_tokens: int = 8
    deadline_s: float | None = None
    generated: list[int] = field(default_factory=list)

    # -- lifecycle (stamped by the queue/batcher on the driver's clock) --
    status: str = "new"          # new|queued|running|done|failed|rejected|shed
    reason: str = ""             # rejection/shed/failure detail
    arrival_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0
    #: replica failovers this request survived
    recoveries: int = 0
    # -- batcher slot state (owned by repro.serve.batcher) ---------------
    feed: list[int] = field(default_factory=list, repr=False)
    pos: int = 0
    _rec: Any = field(default=None, repr=False)

    @property
    def steps_total(self) -> int:
        """Decode steps this request needs from (re)admission, derived
        from its replay state: the batcher teacher-forces the prompt plus
        every token recovered from a lost replica (``generated``), then
        decodes the remaining new tokens — the final step both consumes
        the last feed position and emits the last token, hence the -1."""
        remaining_new = self.max_new_tokens - len(self.generated)
        if remaining_new <= 0:
            return 0
        feed_len = len(self.prompt) + len(self.generated)
        return feed_len + remaining_new - 1

    @property
    def steps_remaining(self) -> int:
        """Steps still owed by an *in-flight* slot occupant, from its
        live batcher state (feed position + tokens still to generate).
        Queued requests have no slot state — use :attr:`steps_total`."""
        remaining_new = self.max_new_tokens - len(self.generated)
        if remaining_new <= 0:
            return 0
        return max(len(self.feed) - self.pos, 0) + remaining_new - 1

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL_STATUSES

    @property
    def latency_s(self) -> float:
        """Arrival→finish latency (0 while not finished)."""
        if not self.finish_t:
            return 0.0
        return max(0.0, self.finish_t - self.arrival_t)

    def deadline_at(self) -> float | None:
        """Absolute clock deadline (None = best-effort)."""
        if self.deadline_s is None:
            return None
        return self.arrival_t + self.deadline_s


class RequestQueue:
    """FIFO admission queue in front of the continuous batcher.

    ``push`` is the admission point: the driver's policy stack gets one
    ``admit_request`` veto per request *before* it is enqueued, and a
    bounded ``capacity`` sheds overflow instead of growing without bound
    (overload must degrade by rejecting cheap, not by queueing forever).
    ``pop_ready`` is the slot-refill point: requests whose deadline has
    already passed are shed there — a request that waited too long must
    not waste the decode slot it was waiting for.
    """

    def __init__(self, *, clock: Clock | None = None,
                 capacity: int | None = None,
                 monitor: Any = None):
        self.clock = clock or REAL_CLOCK
        self.capacity = capacity
        self.monitor = monitor
        self._items: deque[ServeRequest] = deque()
        self.stats = {"arrived": 0, "admitted": 0, "rejected": 0, "shed": 0}
        self.peak_depth = 0

    def __len__(self) -> int:
        return len(self._items)

    def depth(self) -> int:
        return len(self._items)

    def queued(self) -> tuple[ServeRequest, ...]:
        """Snapshot of waiting requests (head first)."""
        return tuple(self._items)

    def _event(self, event: str, req: ServeRequest, **data: Any) -> None:
        if self.monitor is not None:
            self.monitor.record_system_event(event, rid=req.rid, **data)

    def push(self, req: ServeRequest, *, stack: Any = None,
             ctx: SchedulingContext | None = None,
             front: bool = False) -> bool:
        """Admit ``req`` (stamping arrival) or reject it; returns admitted.

        ``front=True`` requeues a recovered in-flight request at the head
        (failover path — it already waited its turn once).  Recovered
        requests skip admission: the policy already decided to retry them.
        """
        now = self.clock.now()
        if not front:
            req.arrival_t = now
            self.stats["arrived"] += 1
            reason = None
            if self.capacity is not None and len(self._items) >= self.capacity:
                reason = f"queue full ({self.capacity})"
            elif stack is not None and ctx is not None:
                reason = stack.admit_request(req, ctx)
            if reason is not None:
                req.status = "rejected"
                req.reason = reason
                req.finish_t = now
                self.stats["rejected"] += 1
                self._event("request_rejected", req, reason=reason)
                return False
            self.stats["admitted"] += 1
            self._event("request_admitted", req,
                        depth=len(self._items),
                        deadline_s=req.deadline_s)
        req.status = "queued"
        if front:
            self._items.appendleft(req)
        else:
            self._items.append(req)
        self.peak_depth = max(self.peak_depth, len(self._items))
        return True

    def pop_ready(self, n: int) -> list[ServeRequest]:
        """Up to ``n`` requests for free slots, shedding expired ones."""
        out: list[ServeRequest] = []
        now = self.clock.now()
        while self._items and len(out) < n:
            req = self._items.popleft()
            deadline = req.deadline_at()
            if deadline is not None and now > deadline:
                req.status = "shed"
                req.reason = (f"deadline blown in queue "
                              f"(+{now - deadline:.3f}s)")
                req.finish_t = now
                self.stats["shed"] += 1
                self._event("request_shed", req, reason="deadline")
                continue
            out.append(req)
        return out

    def drain(self, reason: str = "shutdown") -> list[ServeRequest]:
        """Shed everything still queued (horizon/shutdown path)."""
        out = []
        now = self.clock.now()
        while self._items:
            req = self._items.popleft()
            req.status = "shed"
            req.reason = reason
            req.finish_t = now
            self.stats["shed"] += 1
            self._event("request_shed", req, reason=reason)
            out.append(req)
        return out


class SLOAdmissionPolicy(ResiliencePolicy):
    """Deadline-aware admission: reject requests that cannot make their SLO.

    Projected completion = estimated queue delay + the request's own
    service time, both derived from the monitoring database's streaming
    ``decode_step`` latency profile (p95 once ``min_samples`` steps have
    been observed, ``default_step_s`` before that).  Queue delay models
    the backlog draining through every live decode slot at that step
    cadence.  If the projection overshoots the deadline, the request is
    rejected *at admission* — before it holds a queue position, a batch
    slot or a single decode step.

    ``safety`` scales the projection (>1 rejects earlier, trading
    goodput for tail-latency headroom).  Installed automatically by
    :class:`~repro.serve.driver.WrathServeDriver` when admission control
    is enabled; composes with any user stack (first veto wins).
    """

    serve_plane_aware = True

    def __init__(self, *, default_step_s: float = 0.02,
                 min_samples: int = 3, safety: float = 1.0):
        self.default_step_s = default_step_s
        self.min_samples = min_samples
        self.safety = safety
        self.plane: Any = None

    def bind(self, plane: Any) -> None:
        self.plane = plane

    def unbind(self) -> None:
        self.plane = None

    # ------------------------------------------------------------------ #
    def step_estimate_s(self, monitor: Any) -> float:
        """p95 decode-step latency from the streaming profile."""
        if monitor is not None:
            stats = monitor.duration_stats("decode_step")
            if stats is not None and stats.n >= self.min_samples:
                return stats.p95
        return self.default_step_s

    def admit_request(self, req: Any, ctx: SchedulingContext) -> str | None:
        deadline = getattr(req, "deadline_s", None)
        if deadline is None:
            return None
        step_s = self.step_estimate_s(ctx.monitor)
        service_s = req.steps_total * step_s
        queued = backlog_steps = 0
        slots: int | None = None
        if self.plane is not None:
            queued = self.plane.queue.depth()
            slots = self.plane.total_slots()
            backlog_steps = self.plane.backlog_steps()
        if slots == 0:
            # total replica outage: zero live decode slots means nothing
            # drains and no completion time can be projected — any
            # deadline is infeasible until capacity returns (the old
            # max(slots, 1) floor projected one phantom slot and admitted
            # everything mid-outage)
            return ("SLO infeasible: no live decode slots (replica "
                    f"outage); deadline {deadline:.3f}s cannot be met")
        queue_delay_s = (backlog_steps * step_s / (slots or 1)
                         if queued or backlog_steps else 0.0)
        projected = self.safety * (queue_delay_s + service_s)
        if projected > deadline:
            return (f"SLO infeasible: projected {projected:.3f}s "
                    f"(queue {queue_delay_s:.3f}s + service {service_s:.3f}s)"
                    f" > deadline {deadline:.3f}s")
        return None

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<SLOAdmissionPolicy safety={self.safety}>"
