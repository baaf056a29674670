"""Seeded serving-plane scenarios: deterministic chaos for the serve stack.

The serving analog of :mod:`repro_torch.sim.scenario`: a :class:`ServeScenario`
declares one complete serving run — replica pool shape, a timed request
arrival schedule (with per-request SLOs), and a timed replica fault
schedule — and :func:`run_serve_scenario` executes it on the **real**
serving driver (continuous batcher, admission stack, autoscaler, policy
failover) under a :class:`~repro_torch.sim.clock.VirtualClock` with the
simulated decode backend.  Same seed ⇒ byte-identical event trace.

As with task scenarios, **the seed is the scenario**:
:meth:`ServeScenario.random` draws every choice (pool size, arrival
pattern, prompt shapes, deadlines, kill/restore schedule, whether
admission control and autoscaling are enabled) from one
``random.Random(seed)``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

from repro_torch.core import MonitoringDatabase
from repro_torch.engine.policies import WrathPolicy
from repro_torch.engine.scheduler import make_scheduler
from repro_torch.serve import (ReplicaAutoscaler, ServeRequest, SLOAdmissionPolicy,
                         WrathServeDriver)
from repro_torch.sim.clock import VirtualClock
from repro_torch.sim.harness import build_trace

__all__ = ["ServeFault", "ServeRequestSpec", "ServeScenario",
           "ServeScenarioResult", "run_serve_scenario", "serve_campaign",
           "SERVE_FAULT_KINDS"]

#: replica fault kinds the serving driver knows how to inject
SERVE_FAULT_KINDS = ("kill", "restore")


@dataclass(frozen=True)
class ServeFault:
    """One timed replica fault (``kill`` / ``restore``)."""

    at: float                      # virtual seconds from scenario start
    kind: str
    replica: str

    def __post_init__(self) -> None:
        if self.kind not in SERVE_FAULT_KINDS:
            raise ValueError(f"unknown serve fault kind {self.kind!r}; "
                             f"expected one of {SERVE_FAULT_KINDS}")


@dataclass(frozen=True)
class ServeRequestSpec:
    """One request arrival: prompt, generation budget, SLO."""

    at: float
    prompt: tuple[int, ...]
    max_new_tokens: int = 8
    deadline_s: float | None = None


@dataclass
class ServeScenario:
    """A complete seeded serving-plane script."""

    seed: int
    n_replicas: int = 3
    max_batch: int = 4
    step_s: float = 0.02           # modeled decode-step cost (speed 1.0)
    requests: list[ServeRequestSpec] = field(default_factory=list)
    faults: list[ServeFault] = field(default_factory=list)
    horizon: float = 60.0
    tick_period: float = 0.25
    admission: bool = True
    autoscale: bool = False
    max_replicas: int = 6
    scheduler: str | None = None
    queue_capacity: int | None = None

    def describe(self) -> str:
        slo = sum(1 for r in self.requests if r.deadline_s is not None)
        return (f"ServeScenario(seed={self.seed}): {self.n_replicas}x"
                f"{self.max_batch} slots, {len(self.requests)} requests "
                f"({slo} with SLO), {len(self.faults)} faults, "
                f"admission={self.admission}, autoscale={self.autoscale}")

    # ------------------------------------------------------------------ #
    @staticmethod
    def random(seed: int, *, max_requests: int = 32,
               fault_rate: float = 0.6, horizon: float = 60.0,
               vocab_size: int = 256,
               outage_rate: float = 0.0) -> "ServeScenario":
        """Sample a serving chaos scenario; every choice flows from the seed.

        At least one replica is never targeted by a *partial* fault, so a
        healthy floor always exists and "every admitted request reaches a
        terminal state" stays assertable.  With ``outage_rate`` > 0 a
        scenario may additionally script a **total replica outage**: every
        replica (floor included) killed in one window, then every one
        restored — the zero-live-slot regime the SLO admission policy must
        reject into rather than divide through.  The block draws nothing
        from the RNG at rate 0.0, so pre-existing seeds keep their traces
        byte for byte.
        """
        rng = random.Random(seed)
        n_replicas = rng.randint(2, 4)
        max_batch = rng.choice([2, 2, 4])
        step_s = rng.choice([0.01, 0.02, 0.02, 0.05])
        n_requests = rng.randint(8, max_requests)
        requests: list[ServeRequestSpec] = []
        t = 0.0
        for _ in range(n_requests):
            t += rng.uniform(0.0, 4 * step_s)
            prompt = tuple(rng.randrange(vocab_size)
                           for _ in range(rng.randint(2, 6)))
            deadline = None
            if rng.random() < 0.5:
                deadline = round(rng.uniform(0.2, 3.0), 6)
            requests.append(ServeRequestSpec(
                at=round(t, 6), prompt=prompt,
                max_new_tokens=rng.randint(3, 10),
                deadline_s=deadline))
        faults: list[ServeFault] = []
        # replica0 is the guaranteed-healthy floor: never targeted
        for i in range(1, n_replicas):
            if rng.random() >= fault_rate:
                continue
            name = f"replica{i}"
            at = round(rng.uniform(0.05, max(t, 0.1)), 6)
            faults.append(ServeFault(at=at, kind="kill", replica=name))
            if rng.random() < 0.5:
                faults.append(ServeFault(
                    at=round(at + rng.uniform(0.2, 2.0), 6),
                    kind="restore", replica=name))
        if outage_rate > 0.0 and rng.random() < outage_rate:
            # total outage window: correlated kill of the whole pool,
            # correlated restore — always healed so terminality holds
            ot = round(rng.uniform(0.05, max(t, 0.1)), 6)
            heal = round(ot + rng.uniform(0.3, 1.5), 6)
            for i in range(n_replicas):
                name = f"replica{i}"
                faults.append(ServeFault(at=ot, kind="kill", replica=name))
                faults.append(ServeFault(at=heal, kind="restore",
                                         replica=name))
        faults.sort(key=lambda f: (f.at, f.kind, f.replica))
        return ServeScenario(
            seed=seed, n_replicas=n_replicas, max_batch=max_batch,
            step_s=step_s, requests=requests, faults=faults,
            horizon=horizon,
            tick_period=rng.choice([0.1, 0.25]),
            admission=rng.random() < 0.7,
            autoscale=rng.random() < 0.4,
            scheduler=rng.choice([None, None, "least_loaded",
                                  "round_robin"]))


@dataclass
class ServeScenarioResult:
    seed: int
    scenario: ServeScenario
    report: object                  # repro_torch.serve.ServeReport
    trace: str
    violations: list[str]

    @property
    def ok(self) -> bool:
        return not self.violations


def _check_invariants(scenario: ServeScenario, requests: list[ServeRequest],
                      report, monitor: MonitoringDatabase) -> list[str]:
    """Serving-plane invariants every scenario must satisfy."""
    v: list[str] = []
    # autoscaler cooldown contract: two *load-following* grows can never
    # land within the patience window (capacity repair is exempt — it
    # answers replica loss, not the gauge trend)
    grows = [e for e in monitor.system_events
             if e["event"] == "autoscale_grow"
             and e.get("reason") == "sustained backlog"]
    min_gap = 2 * scenario.tick_period        # autoscaler runs patience=2
    for a, b in zip(grows, grows[1:]):
        if b["time"] - a["time"] < min_gap - 1e-9:
            v.append(f"back-to-back autoscale grows at {a['time']:.3f}s "
                     f"and {b['time']:.3f}s (inside the "
                     f"{min_gap:.3f}s cooldown window)")
    total = (report.completed + report.failed + report.rejected
             + report.shed)
    if total != len(requests):
        v.append(f"request conservation: {total} terminal != "
                 f"{len(requests)} submitted")
    for r in requests:
        if not r.terminal:
            v.append(f"request {r.rid} left non-terminal ({r.status})")
        if r.status == "rejected" and r.generated:
            v.append(f"rejected request {r.rid} consumed decode steps")
        if r.status == "done" and len(r.generated) != r.max_new_tokens:
            v.append(f"done request {r.rid} has {len(r.generated)} tokens, "
                     f"wanted {r.max_new_tokens}")
    if report.rejected and not scenario.admission \
            and scenario.queue_capacity is None:
        v.append("rejections without admission control or a bounded queue")
    return v


def run_serve_scenario(scenario: ServeScenario) -> ServeScenarioResult:
    """Execute one serving scenario deterministically; returns the report,
    the canonical event trace, and any invariant violations."""
    from repro_torch.serve.batcher import SimDecodeBackend

    clock = VirtualClock()
    monitor = MonitoringDatabase(clock=clock, keep_event_log=True)
    policy: list = [WrathPolicy()]
    if scenario.autoscale:
        policy.append(ReplicaAutoscaler(
            min_replicas=1, max_replicas=scenario.max_replicas,
            patience=2, idle_ticks=4))
    driver = WrathServeDriver(
        None, n_replicas=scenario.n_replicas,
        max_batch=scenario.max_batch,
        clock=clock, monitor=monitor,
        decode=SimDecodeBackend(step_s=scenario.step_s),
        policy=policy,
        admission=SLOAdmissionPolicy(default_step_s=scenario.step_s)
        if scenario.admission else None,
        queue_capacity=scenario.queue_capacity,
        scheduler=(make_scheduler(scenario.scheduler)
                   if scenario.scheduler else None))
    requests = [ServeRequest(rid=i, prompt=list(spec.prompt),
                             max_new_tokens=spec.max_new_tokens,
                             deadline_s=spec.deadline_s)
                for i, spec in enumerate(scenario.requests)]
    report = driver.serve_continuous(
        requests,
        arrivals=[spec.at for spec in scenario.requests],
        faults=[(f.at, f.kind, f.replica) for f in scenario.faults],
        horizon=scenario.horizon,
        tick_period=scenario.tick_period)
    driver.shutdown()
    return ServeScenarioResult(
        seed=scenario.seed, scenario=scenario, report=report,
        trace=build_trace(monitor),
        violations=_check_invariants(scenario, requests, report, monitor))


def serve_campaign(n_scenarios: int, *, base_seed: int = 0,
                   check_determinism: bool = False,
                   scenario_kwargs: dict | None = None,
                   ) -> list[ServeScenarioResult]:
    """Run ``n_scenarios`` seeded serving scenarios; with
    ``check_determinism`` each scenario runs twice and a trace mismatch is
    recorded as a violation.  ``scenario_kwargs`` forwards to
    :meth:`ServeScenario.random` (e.g. ``outage_rate=0.3`` to mix in
    total-outage windows)."""
    results = []
    kw = scenario_kwargs or {}
    for i in range(n_scenarios):
        scenario = ServeScenario.random(base_seed + i, **kw)
        res = run_serve_scenario(scenario)
        if check_determinism:
            again = run_serve_scenario(
                ServeScenario.random(base_seed + i, **kw))
            if again.trace != res.trace:
                res.violations.append("trace not deterministic across runs")
        results.append(res)
    return results
