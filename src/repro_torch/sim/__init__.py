"""Deterministic simulation plane (virtual time + seeded chaos).

WRATH's claims are statements about behaviour under *many* failure
interleavings; wall-clock tests can afford a handful.  This package runs
the **real engine** — scheduler, event loop, retries, heartbeat and
straggler watchers, proactive sentinel, policy stacks, workflow
propagation — on a :class:`VirtualClock`: no threads, no sleeps, events
execute inline in timestamp order, and a 60-second failure scenario
costs microseconds.  On top of that sit a scenario DSL
(:class:`Scenario`, seeded generation), a test harness
(:class:`SimHarness`) and a :func:`campaign` runner that executes
thousands of seeded chaos scenarios per CI run and checks the engine's
invariants — reproducibly: **same seed, same event trace, byte for
byte**.

Quick start::

    from repro_torch.sim import SimCluster, SimHarness

    with SimHarness(SimCluster.homogeneous(2),
                    durations={"work": 0.3}) as h:
        fut = work(7)                       # @task-decorated as usual
        h.run_until(fut.done)
        assert fut.result(timeout=0) == 7

Chaos campaign (also ``python -m repro_torch.sim --scenarios 500``)::

    from repro_torch.sim import campaign
    report = campaign(500, base_seed=0)
    assert report.ok, report.summary()
"""
from repro_torch.sim.clock import VirtualClock
from repro_torch.sim.coverage import CoverageMap, trace_ngrams, trace_tokens
from repro_torch.sim.search import (
    GuidedCampaignResult,
    guided_campaign,
    load_corpus,
    mutate_scenario,
    promote_repro,
    scenario_id,
    shrink_scenario,
    uniform_campaign_coverage,
    violation_signature,
)
from repro_torch.sim.cluster import (
    SimCluster,
    SimExecutor,
    SimNodeManager,
    SimWorker,
    sim_duration,
)
from repro_torch.sim.harness import (
    CampaignResult,
    ScenarioResult,
    SimHarness,
    build_trace,
    campaign,
    run_scenario,
)
from repro_torch.sim.scenario import (
    CORRELATED_FAULT_KINDS,
    FAULT_KINDS,
    TASK_FAILURE_KINDS,
    Fault,
    NodeSpec,
    Scenario,
    SimTaskSpec,
)
from repro_torch.sim.serve import (
    SERVE_FAULT_KINDS,
    ServeFault,
    ServeRequestSpec,
    ServeScenario,
    ServeScenarioResult,
    run_serve_scenario,
    serve_campaign,
)

__all__ = [
    "VirtualClock",
    "SimCluster",
    "SimExecutor",
    "SimNodeManager",
    "SimWorker",
    "sim_duration",
    "SimHarness",
    "ScenarioResult",
    "CampaignResult",
    "run_scenario",
    "campaign",
    "build_trace",
    "Scenario",
    "SimTaskSpec",
    "NodeSpec",
    "Fault",
    "FAULT_KINDS",
    "CORRELATED_FAULT_KINDS",
    "TASK_FAILURE_KINDS",
    "CoverageMap",
    "trace_tokens",
    "trace_ngrams",
    "GuidedCampaignResult",
    "guided_campaign",
    "uniform_campaign_coverage",
    "mutate_scenario",
    "shrink_scenario",
    "scenario_id",
    "violation_signature",
    "promote_repro",
    "load_corpus",
    "ServeFault",
    "ServeRequestSpec",
    "ServeScenario",
    "ServeScenarioResult",
    "run_serve_scenario",
    "serve_campaign",
    "SERVE_FAULT_KINDS",
]
