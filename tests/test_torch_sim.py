"""The port's simulation plane held to the reference's own tests and to
the JAX package's traces.

Ports, against ``repro_torch``, of all of ``tests/test_sim_scenarios.py``
and ``tests/test_serve_plane.py`` (the serve plane on the virtual clock),
bodies as the reference's with the imports rewritten.  Then the same
seeds through both packages: chaos and serve campaigns give equal traces
per scenario, the seeded samplers equal scenarios, and fedlearn under
``SimHarness`` (the port's on the CPU) equal traces and weights within
``FP32_TOL``, clean and with a node lost mid-round.  Last, the host checks
of ``chip_smoke.py``'s ``wrath_sim`` phase at a small size.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import repro.sim as ref_sim
import repro_torch.sim as port_sim
from repro.apps import fedlearn as ref_fed
from repro.engine.policies import WrathPolicy as RefWrathPolicy
from repro_torch.apps import fedlearn
from repro_torch.core import MonitoringDatabase
from repro_torch.engine.events import EventLoop
from repro_torch.engine.policies import ProactivePolicy, WrathPolicy, replay
from repro_torch.serve import (ReplicaAutoscaler, RequestQueue, ServeRequest,
                               SLOAdmissionPolicy, WrathServeDriver)
from repro_torch.sim import (
    Fault,
    NodeSpec,
    Scenario,
    ServeFault,
    ServeRequestSpec,
    ServeScenario,
    SimTaskSpec,
    VirtualClock,
    campaign,
    run_scenario,
    run_serve_scenario,
    serve_campaign,
)

try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                      # pragma: no cover - optional dep
    HAVE_HYPOTHESIS = False

# the sim phase's helpers, imported from the script at the repo's root
_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)

FP32_TOL = 1e-5


# ===== ported from tests/test_sim_scenarios.py =====
# --------------------------------------------------------------------- #
# virtual clock + event loop basics
# --------------------------------------------------------------------- #
def test_virtual_clock_advances_only_by_decree():
    clock = VirtualClock()
    assert clock.now() == 0.0
    clock.advance(5.0)
    assert clock.now() == 5.0
    clock.advance_to(3.0)                 # never backwards
    assert clock.now() == 5.0
    assert clock.time() == VirtualClock.EPOCH + 5.0


def test_event_loop_run_until_executes_in_timestamp_order():
    clock = VirtualClock()
    loop = EventLoop(clock=clock)
    seen = []
    loop.call_later(2.0, lambda: seen.append(("b", clock.now())))
    loop.call_later(1.0, lambda: seen.append(("a", clock.now())))
    loop.call_later(3.0, lambda: seen.append(("c", clock.now())))
    n = loop.run_until()
    assert n == 3
    assert seen == [("a", 1.0), ("b", 2.0), ("c", 3.0)]
    assert clock.now() == 3.0


def test_event_loop_run_until_deadline_stops_and_lands_clock():
    clock = VirtualClock()
    loop = EventLoop(clock=clock)
    seen = []
    loop.schedule_periodic(1.0, lambda: seen.append(clock.now()))
    loop.run_until(deadline=4.5)
    assert seen == [1.0, 2.0, 3.0, 4.0]
    assert clock.now() == 4.5             # landed exactly on the deadline


def test_event_loop_run_until_predicate_stops_between_events():
    clock = VirtualClock()
    loop = EventLoop(clock=clock)
    seen = []
    for i in range(10):
        loop.call_later(float(i + 1), lambda i=i: seen.append(i))
    loop.run_until(lambda: len(seen) >= 3)
    assert seen == [0, 1, 2]
    assert clock.now() == 3.0


def test_event_loop_refuses_run_until_on_real_clock():
    loop = EventLoop()
    with pytest.raises(RuntimeError, match="virtual clock"):
        loop.run_until()


# --------------------------------------------------------------------- #
# a "60-second" scenario in microseconds
# --------------------------------------------------------------------- #
def test_minute_long_heartbeat_loss_scenario_runs_instantly():
    """The tentpole claim: a long heartbeat-silence scenario needs no
    wall-clock time — virtual time jumps straight between events."""
    import time as wall

    scenario = Scenario(
        seed=0,
        nodes=[NodeSpec("n0", workers=1), NodeSpec("n1", workers=1)],
        tasks=[SimTaskSpec(at=0.0, name="long", duration=60.0)],
        faults=[Fault(at=30.0, kind="node_down", node="n1")],
        horizon=200.0)
    t0 = wall.perf_counter()
    result = run_scenario(scenario, heartbeat_period=1.0)
    elapsed = wall.perf_counter() - t0
    assert result.ok, result.violations
    assert result.outcomes["long"][0] == "ok"
    assert elapsed < 2.0                  # ~200 virtual seconds of events


# --------------------------------------------------------------------- #
# determinism regression (satellite)
# --------------------------------------------------------------------- #
def test_same_seed_produces_byte_identical_event_trace():
    first = run_scenario(Scenario.random(1234))
    second = run_scenario(Scenario.random(1234))
    assert first.trace == second.trace
    assert first.trace                      # non-trivial scenario
    # every counter matches; wrath_overhead_s is *real* measured seconds
    # (policy-hook cost) and is the one legitimately wall-clock stat
    drop = "wrath_overhead_s"
    assert ({k: v for k, v in first.stats.items() if k != drop}
            == {k: v for k, v in second.stats.items() if k != drop})


def test_different_seeds_produce_different_traces():
    a = run_scenario(Scenario.random(1234))
    b = run_scenario(Scenario.random(4321))
    assert a.trace != b.trace


def test_scenario_generation_is_seed_deterministic():
    assert Scenario.random(77) == Scenario.random(77)
    assert Scenario.random(77) != Scenario.random(78)


# --------------------------------------------------------------------- #
# campaign invariants (the CI chaos gate, small here; 500 runs nightly)
# --------------------------------------------------------------------- #
def test_chaos_campaign_invariants_hold_across_seeds():
    report = campaign(30, base_seed=0, determinism_checks=2)
    assert report.ok, report.summary()
    assert len(report.results) == 30
    # the sweep must actually exercise chaos, not trivially-green runs
    assert any(r.stats["failed"] or r.stats["dep_failed"]
               for r in report.results)
    assert any(r.stats["retries"] for r in report.results)


def test_chaos_campaign_with_proactive_stack():
    report = campaign(15, base_seed=100,
                      policy_factory=lambda: [ProactivePolicy(),
                                              WrathPolicy()],
                      determinism_checks=1)
    assert report.ok, report.summary()


def test_chaos_campaign_baseline_policy_still_conserves_tasks():
    report = campaign(15, base_seed=200, policy_factory=lambda: None,
                      determinism_checks=1)
    assert report.ok, report.summary()


# --------------------------------------------------------------------- #
# WRATH-specific properties
# --------------------------------------------------------------------- #
def test_resolvable_spec_modification_failures_succeed_by_replacement():
    """§VII-C: a 200 GB spec-injected task fails on the 192 GB node but a
    big-memory node exists — WRATH's hierarchical retry must save it."""
    scenario = Scenario(
        seed=0,
        nodes=[NodeSpec("small", memory_gb=192.0),
               NodeSpec("big", memory_gb=6144.0)],
        tasks=[SimTaskSpec(at=0.0, name="hungry", fail="memory"),
               SimTaskSpec(at=0.0, name="needs-pkg", fail="import")],
        horizon=60.0)
    # wrathpkg exists nowhere -> only the memory task is resolvable
    result = run_scenario(scenario)
    assert result.ok, result.violations
    assert result.outcomes["hungry"] == ("ok", 0)
    assert result.outcomes["needs-pkg"][0] == "error"


def test_destined_to_fail_tasks_fast_fail_under_proactive_policy():
    """Fig 4: with no feasible node anywhere, the proactive plane must
    terminate the task before it burns a single attempt."""
    scenario = Scenario(
        seed=0,
        nodes=[NodeSpec("a", memory_gb=8.0), NodeSpec("b", memory_gb=8.0)],
        tasks=[SimTaskSpec(at=0.0, name="monster", fail="memory")],
        horizon=60.0)
    reactive = run_scenario(scenario)
    proactive = run_scenario(
        scenario, policy_factory=lambda: [ProactivePolicy(), WrathPolicy()])
    assert reactive.outcomes["monster"][0] == "error"
    assert proactive.outcomes["monster"][0] == "error"
    assert proactive.stats["fast_fails"] >= 1
    assert proactive.stats["retries"] == 0       # terminated pre-attempt
    assert proactive.stats["retries"] < reactive.stats["retries"] or (
        reactive.stats["retries"] == 0)


def test_cancelled_scope_stays_cancelled_under_chaos():
    scenario = Scenario(
        seed=0,
        nodes=[NodeSpec("n0", workers=1)],
        tasks=[SimTaskSpec(at=0.0, name="member0", duration=5.0,
                           workflow="wf"),
               SimTaskSpec(at=0.1, name="member1", duration=5.0,
                           workflow="wf"),
               SimTaskSpec(at=6.0, name="late", duration=5.0,
                           workflow="wf")],
        faults=[Fault(at=1.0, kind="cancel_workflow", workflow="wf")],
        horizon=60.0,
        workflows={"wf": "none"})
    result = run_scenario(scenario)
    assert result.ok, result.violations
    # every member resolved with the cancellation, including the one
    # submitted after the scope died
    assert all(kind == "error" for kind, _ in result.outcomes.values()), \
        result.outcomes


# --------------------------------------------------------------------- #
# engine crash/restart: the lineage-aware checkpoint plane under chaos
# --------------------------------------------------------------------- #
def _crash_dag(crash_at=None):
    """A linear 8-task DAG, one arrival per 0.5s; optionally crash mid-run."""
    tasks = [SimTaskSpec(at=i * 0.5, name=f"t{i:03d}", duration=0.3,
                         depends_on=(i - 1,) if i else ())
             for i in range(8)]
    faults = ([Fault(at=crash_at, kind="engine_crash")]
              if crash_at is not None else [])
    return Scenario(seed=7, tasks=tasks, faults=faults, horizon=60.0)


def _outcome_bytes(result):
    return json.dumps(result.outcomes, sort_keys=True, default=repr).encode()


def test_engine_crash_reexecutes_only_the_incomplete_frontier():
    """Acceptance property: after a mid-campaign crash the rebuilt engine
    re-executes exactly the tasks without a committed result, and the
    final results match the crash-free run byte for byte."""
    crashed = run_scenario(_crash_dag(crash_at=2.2))
    clean = run_scenario(_crash_dag())
    assert crashed.ok, crashed.violations
    assert crashed.crashes == 1
    committed = crashed.committed_at_crash[0]
    assert 0 < committed < 8              # the crash landed mid-DAG
    assert crashed.stats["memo_hits"] == committed
    assert crashed.reexecuted == 8 - committed
    assert _outcome_bytes(crashed) == _outcome_bytes(clean)


def test_engine_crash_trace_is_seed_deterministic():
    first = run_scenario(_crash_dag(crash_at=2.2))
    second = run_scenario(_crash_dag(crash_at=2.2))
    assert first.trace == second.trace
    assert "engine_restart" in first.trace
    assert "memoized" in first.trace


def test_engine_crash_with_injected_failures_keeps_failures_uncommitted():
    """Destined-to-fail tasks are never memoized: they re-execute after
    the restart and fail identically, while healthy committed siblings
    resolve from the store."""
    tasks = [SimTaskSpec(at=0.0, name="ok0", duration=0.2),
             SimTaskSpec(at=0.1, name="doomed", duration=0.2,
                         fail="zero_division", max_retries=0),
             SimTaskSpec(at=0.2, name="ok1", duration=0.2),
             SimTaskSpec(at=5.0, name="late", duration=0.2)]
    scenario = Scenario(seed=3, tasks=tasks,
                        faults=[Fault(at=1.0, kind="engine_crash")],
                        horizon=60.0)
    result = run_scenario(scenario)
    assert result.ok, result.violations
    assert result.outcomes["doomed"][0] == "error"
    assert result.outcomes["ok0"] == ("ok", 0)
    assert result.outcomes["late"] == ("ok", 3)
    # ok0/ok1 committed pre-crash -> memo hits; doomed + late re-executed
    assert result.committed_at_crash == [2]
    assert result.stats["memo_hits"] == 2


def test_engine_crash_preserves_heartbeat_silence():
    """Heartbeat silence is *environment* state: a paused monitoring
    agent must stay paused across the engine restart, so the rebuilt
    engine still detects the loss instead of the fault healing itself."""
    scenario = Scenario(
        seed=5,
        nodes=[NodeSpec("n0", workers=1), NodeSpec("n1", workers=1)],
        # the second arrival keeps the run alive past the staleness
        # window (last beat t=1 + 0.5*5 threshold -> loss check at t=4)
        tasks=[SimTaskSpec(at=3.0, name="late", duration=0.2),
               SimTaskSpec(at=6.0, name="later", duration=0.2)],
        faults=[Fault(at=1.0, kind="hb_pause", node="n1"),
                Fault(at=2.0, kind="engine_crash")],
        horizon=60.0)
    result = run_scenario(scenario, heartbeat_period=0.5)
    assert result.ok, result.violations
    assert result.crashes == 1
    assert "heartbeat_lost" in result.trace   # detected *after* the restart


def test_random_campaign_samples_engine_crashes_and_invariants_hold():
    report = campaign(40, base_seed=300, determinism_checks=2)
    assert report.ok, report.summary()
    crashed = [r for r in report.results if r.crashes]
    assert crashed                        # the sampler exercises the path
    assert any(r.stats["memo_hits"] for r in crashed)


# --------------------------------------------------------------------- #
# the chaos property, hypothesis-driven when available
# --------------------------------------------------------------------- #
def _assert_campaign_property(seed: int) -> None:
    scenario = Scenario.random(seed, max_tasks=12)
    result = run_scenario(scenario)
    assert result.ok, (
        f"invariants violated for seed={seed}: {result.violations}\n"
        f"reproduce: run_scenario(Scenario.random({seed}, max_tasks=12))")
    replay = run_scenario(Scenario.random(seed, max_tasks=12))
    assert replay.trace == result.trace, (
        f"nondeterminism for seed={seed}")


if HAVE_HYPOTHESIS:
    @settings(max_examples=25, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(seed=st.integers(min_value=0, max_value=2**32 - 1))
    def test_chaos_property_any_seed(seed):
        _assert_campaign_property(seed)
else:                                    # seeded fallback sweep
    @pytest.mark.parametrize("seed", [3, 17, 404, 9_001, 123_456,
                                      2**31 - 1])
    def test_chaos_property_any_seed(seed):
        _assert_campaign_property(seed)


# ===== ported from tests/test_serve_plane.py =====
STEP_S = 0.02


def _driver(**kw):
    clock = kw.pop("clock", None) or VirtualClock()
    monitor = kw.pop("monitor", None) or MonitoringDatabase(
        clock=clock, keep_event_log=True)
    kw.setdefault("decode", "sim")
    return WrathServeDriver(None, clock=clock, monitor=monitor, **kw)


def _req(rid, prompt_len=3, new=6, deadline_s=None):
    return ServeRequest(rid=rid, prompt=list(range(1, prompt_len + 1)),
                        max_new_tokens=new, deadline_s=deadline_s)


# ---------------------------------------------------- continuous batching --
def test_slot_vacated_and_reused_before_batch_mates_finish():
    """A finished request's slot is refilled at the step boundary — the
    queued request completes while the long slot-mate is still decoding."""
    driver = _driver(n_replicas=1, max_batch=2)
    long = _req(0, new=10)
    short = _req(1, new=2)
    queued = _req(2, new=2)
    rep = driver.serve_continuous([long, short, queued], horizon=30.0)
    driver.shutdown()
    assert rep.completed == 3 and rep.failed == 0
    # static batching would hold `queued` until `long` finished
    assert short.finish_t < long.finish_t
    assert queued.finish_t < long.finish_t
    assert len(long.generated) == 10 and len(queued.generated) == 2


def test_virtual_clock_timing_is_exact():
    """Decode wall time is the modeled step cost, nothing else — the
    driver's clock protocol keeps the whole plane on virtual time."""
    driver = _driver(n_replicas=1, max_batch=1)
    req = _req(0, prompt_len=3, new=4)       # steps_total = 6
    rep = driver.serve_continuous([req], horizon=10.0)
    driver.shutdown()
    assert rep.decode_steps == 6
    assert req.latency_s == pytest.approx(6 * STEP_S)


def test_static_serve_runs_on_virtual_clock():
    driver = _driver(n_replicas=2, max_batch=2)
    reqs = [_req(i, prompt_len=3, new=4) for i in range(2)]
    rep = driver.serve(reqs)
    assert rep.completed == 2
    # 6 steps at the modeled cost, measured on the virtual clock
    assert rep.wall_s == pytest.approx(rep.decode_steps * STEP_S)


# ------------------------------------------------------------- admission --
def test_infeasible_deadline_rejected_at_admission_without_decode():
    driver = _driver(n_replicas=1, max_batch=2,
                     admission=SLOAdmissionPolicy(default_step_s=STEP_S))
    doomed = _req(0, prompt_len=5, new=16, deadline_s=0.1)   # needs 0.4s
    fine = _req(1, prompt_len=3, new=4, deadline_s=5.0)
    rep = driver.serve_continuous([doomed, fine], horizon=30.0)
    driver.shutdown()
    assert doomed.status == "rejected" and "SLO infeasible" in doomed.reason
    assert doomed.generated == []            # zero decode steps consumed
    assert fine.status == "done"
    assert rep.rejected == 1 and rep.completed == 1
    # only the feasible request's steps ever ran (steps_total is 0 once
    # a request is complete — it derives from replay state, not history)
    assert rep.decode_steps == len(fine.prompt) + fine.max_new_tokens - 1
    assert fine.steps_total == 0
    events = [e["event"] for e in driver.monitor.event_log
              if e.get("rid") == 0]
    assert events == ["request_rejected"]


def test_admission_estimate_tracks_monitored_decode_profile():
    clock = VirtualClock()
    monitor = MonitoringDatabase(clock=clock)
    pol = SLOAdmissionPolicy(default_step_s=0.01, min_samples=3)
    assert pol.step_estimate_s(monitor) == 0.01      # no samples yet
    for _ in range(5):
        monitor.record_task_placement("decode_step", "replica0", "serve",
                                      ok=True, duration=0.25)
    assert pol.step_estimate_s(monitor) == pytest.approx(0.25)


def test_bounded_queue_sheds_overflow():
    clock = VirtualClock()
    q = RequestQueue(clock=clock, capacity=2)
    assert q.push(_req(0)) and q.push(_req(1))
    r = _req(2)
    assert not q.push(r)
    assert r.status == "rejected" and "queue full" in r.reason


def test_queue_sheds_expired_deadline_at_pop():
    clock = VirtualClock()
    q = RequestQueue(clock=clock)
    r = _req(0, deadline_s=0.5)
    q.push(r)
    clock.advance(1.0)
    assert q.pop_ready(4) == []
    assert r.status == "shed" and "deadline" in r.reason


# ------------------------------------------------------------ autoscaler --
def test_autoscaler_grows_into_backlog_and_shrinks_after_drain():
    driver = _driver(
        n_replicas=1, max_batch=2,
        policy=[ReplicaAutoscaler(min_replicas=1, max_replicas=4,
                                  patience=2, idle_ticks=3)])
    reqs = [_req(i, prompt_len=4, new=6) for i in range(30)]
    rep = driver.serve_continuous(reqs, arrivals=[0.0] * 30, horizon=60.0,
                                  tick_period=0.1, drain_s=2.0)
    driver.shutdown()
    assert rep.completed == 30
    assert rep.autoscaled_up > 0
    assert rep.autoscaled_down > 0
    assert rep.replicas_final == 1           # back to the floor
    events = [e["event"] for e in driver.monitor.event_log]
    assert "autoscale_grow" in events and "autoscale_shrink" in events


def test_autoscaler_replaces_lost_replica_below_floor():
    driver = _driver(
        n_replicas=2, max_batch=2,
        policy=[ReplicaAutoscaler(min_replicas=2, max_replicas=4,
                                  patience=2, idle_ticks=100)])
    reqs = [_req(i, new=8) for i in range(8)]
    rep = driver.serve_continuous(
        reqs, arrivals=[0.02 * i for i in range(8)],
        faults=[(0.1, "kill", "replica1")], horizon=60.0, tick_period=0.1)
    driver.shutdown()
    assert rep.completed == 8
    assert rep.autoscaled_up >= 1            # capacity repair
    assert len(driver.live_replicas()) >= 2


# ---------------------------------------------------------------- chaos --
def test_failover_requeues_in_flight_without_token_loss():
    driver = _driver(n_replicas=3, max_batch=2)
    reqs = [_req(i, new=6) for i in range(6)]
    rep = driver.serve_continuous(
        reqs, arrivals=[0.01 * i for i in range(6)],
        faults=[(0.05, "kill", "replica0")], horizon=60.0)
    driver.shutdown()
    assert rep.completed == 6 and rep.failed == 0
    assert rep.recoveries and "replica0" in rep.denylisted
    assert all(len(r.generated) == r.max_new_tokens for r in reqs)
    assert any(r.recoveries > 0 for r in reqs)


def test_denylist_updates_with_custom_policy_stack_continuous():
    """Regression: with a non-WRATH stack nothing used to maintain the
    driver denylist — retries could be routed back at the dead replica."""
    driver = _driver(n_replicas=3, max_batch=2, policy=[replay(3)])
    reqs = [_req(i, new=6) for i in range(6)]
    rep = driver.serve_continuous(
        reqs, arrivals=[0.01 * i for i in range(6)],
        faults=[(0.05, "kill", "replica0")], horizon=60.0)
    driver.shutdown()
    assert rep.completed == 6
    assert "replica0" in rep.denylisted
    adds = [e for e in driver.monitor.event_log
            if e["event"] == "denylist_add"]
    assert adds and adds[0]["source"] == "serve_driver"


def test_denylist_updates_with_custom_policy_stack_static():
    driver = _driver(n_replicas=3, max_batch=2, policy=[replay(3)])
    reqs = [_req(i, new=6) for i in range(4)]
    rep = driver.serve(reqs, kill_replica_at=("replica0", 2))
    assert rep.completed == 4
    assert "replica0" in rep.denylisted


def test_chaos_scenario_trace_byte_identical():
    scenario = ServeScenario(
        seed=0, n_replicas=3, max_batch=2, step_s=STEP_S,
        requests=[ServeRequestSpec(at=0.01 * i, prompt=(1, 2, 3),
                                   max_new_tokens=5,
                                   deadline_s=2.0 if i % 2 else None)
                  for i in range(12)],
        faults=[ServeFault(at=0.08, kind="kill", replica="replica1"),
                ServeFault(at=0.5, kind="restore", replica="replica1")],
        admission=True, autoscale=True)
    a = run_serve_scenario(scenario)
    b = run_serve_scenario(scenario)
    assert a.ok, a.violations
    assert a.trace == b.trace
    assert "replica_lost" in a.trace and "fault_injected" in a.trace


def test_seeded_serve_campaign_invariants_hold():
    results = serve_campaign(8, base_seed=1234, check_determinism=True)
    bad = [(r.seed, r.violations) for r in results if not r.ok]
    assert not bad, bad


# --------------------------------- decode-step accounting regressions --
def test_steps_total_derives_from_replay_state():
    """Regression: steps_total used to read only the original prompt, so
    a failed-over request (recovered tokens teacher-forced back into the
    feed) under-counted its remaining work in every backlog projection."""
    fresh = _req(0, prompt_len=3, new=6)
    assert fresh.steps_total == 3 + 6 - 1          # classic prefill+decode
    recovered = _req(1, prompt_len=3, new=6)
    recovered.generated = [7, 8]                   # survived a replica loss
    # replay feeds prompt+recovered (5 tokens), then decodes the 4 left;
    # the final step consumes the last feed slot AND emits the last token
    assert recovered.steps_total == 5 + 4 - 1
    finished = _req(2, prompt_len=3, new=2)
    finished.generated = [1, 2]
    assert finished.steps_total == 0               # nothing left to owe


def test_steps_remaining_tracks_live_slot_state():
    req = _req(0, prompt_len=3, new=6)
    req.feed = list(req.prompt)
    req.pos = 2                                    # mid-prefill
    assert req.steps_remaining == (3 - 2) + 6 - 1
    req.pos = 3
    req.generated = [9, 9, 9]
    assert req.steps_remaining == 3 - 1            # 3 tokens still to emit
    req.generated = [9] * 6
    assert req.steps_remaining == 0


def test_backlog_steps_sums_queue_totals_and_occupant_remainders():
    """Regression: each occupant used to contribute one phantom step to
    the backlog (its final step double-counted), inflating admission's
    queue-delay projection."""
    driver = _driver(n_replicas=1, max_batch=1)
    occupant = _req(0, prompt_len=3, new=8)
    waiting = _req(1, prompt_len=2, new=4)
    # seat the occupant mid-flight and queue the waiter
    driver._slots["replica0"].admit(occupant)
    occupant.pos = 2                              # two prefill steps done
    driver.queue.push(waiting)
    # occupant owes (3-2) feed + 8 new - 1 shared final step = 8;
    # the waiter owes its full 2 + 4 - 1 = 5 from admission
    assert occupant.steps_remaining == 8
    assert waiting.steps_total == 5
    assert driver.backlog_steps() == 13           # not 14: no phantom step
    driver.shutdown()


def test_failover_replay_steps_match_steps_total():
    """After a mid-decode replica loss the requeued request's
    steps_total equals the steps its replay actually consumes."""
    driver = _driver(n_replicas=2, max_batch=1)
    victim = _req(0, prompt_len=3, new=8)
    rep = driver.serve_continuous(
        [victim], arrivals=[0.0],
        faults=[(0.05, "kill", "replica0")],
        horizon=30.0)
    driver.shutdown()
    assert rep.completed == 1
    assert victim.recoveries >= 1
    assert len(victim.generated) == 8              # no token loss
    # replay accounting: steps after recovery = what steps_total promised
    # at requeue time (generated tokens teacher-forced, not re-decoded)
    assert victim.status == "done"


# ------------------------------------------- zero-slot admission gate --
def test_total_outage_rejects_slo_requests_at_admission():
    """Regression: with zero live replicas the old projection divided by
    max(slots, 1) — one phantom slot — and admitted requests that could
    not possibly start, let alone meet a deadline."""
    clock = VirtualClock()
    monitor = MonitoringDatabase(clock=clock, keep_event_log=True)
    driver = _driver(clock=clock, monitor=monitor, n_replicas=2,
                     max_batch=2,
                     admission=SLOAdmissionPolicy(default_step_s=STEP_S))
    slo = _req(0, prompt_len=3, new=4, deadline_s=5.0)
    besteffort = _req(1, prompt_len=3, new=4)
    rep = driver.serve_continuous(
        [slo, besteffort], arrivals=[0.2, 0.25],
        faults=[(0.05, "kill", "replica0"), (0.05, "kill", "replica1"),
                (1.0, "restore", "replica0")],
        horizon=30.0)
    driver.shutdown()
    # the SLO request arrived mid-outage: rejected at the door, no decode
    assert slo.status == "rejected"
    assert "no live decode slots" in slo.reason
    assert slo.generated == []
    # best-effort requests queue through the outage and finish after heal
    assert besteffort.status == "done"
    assert rep.rejected == 1 and rep.completed == 1


def test_serve_scenarios_sample_total_outage_windows():
    """The seeded sampler reaches the zero-slot regime: outage windows
    kill the whole pool (floor replica included) and always heal."""
    from repro_torch.sim import ServeScenario, serve_campaign

    results = serve_campaign(20, base_seed=0, check_determinism=True,
                             scenario_kwargs={"outage_rate": 0.6})
    bad = [(r.seed, r.violations) for r in results if not r.ok]
    assert not bad, bad
    outage = [r for r in results
              if any(f.replica == "replica0" and f.kind == "kill"
                     for f in r.scenario.faults)]
    assert outage, "outage_rate=0.6 sampled no total outages in 20 seeds"
    # rate 0.0 must leave pre-existing seeds byte-identical (gated RNG)
    for seed in (0, 3, 11):
        assert ServeScenario.random(seed) == ServeScenario.random(
            seed, outage_rate=0.0)


# ------------------------------------------------ autoscaler cooldown --
def test_autoscaler_never_grows_back_to_back():
    """Regression: after a grow the gauge window still held pre-decision
    samples, so a sustained burst triggered a second grow on the very
    next tick — two replicas for one backlog signal.  The post-decision
    cooldown must keep load-following grows a full patience window apart
    without changing what the run converges to."""
    driver = _driver(
        n_replicas=1, max_batch=2,
        policy=[ReplicaAutoscaler(min_replicas=1, max_replicas=6,
                                  patience=2, idle_ticks=3)])
    reqs = [_req(i, prompt_len=4, new=8) for i in range(40)]
    rep = driver.serve_continuous(reqs, arrivals=[0.0] * 40, horizon=60.0,
                                  tick_period=0.1, drain_s=2.0)
    events = [e for e in driver.monitor.event_log
              if e["event"] == "autoscale_grow"
              and e.get("reason") == "sustained backlog"]
    driver.shutdown()
    assert rep.completed == 40
    assert len(events) >= 2                  # the burst still scales out
    gaps = [b["time"] - a["time"] for a, b in zip(events, events[1:])]
    assert all(g >= 2 * 0.1 - 1e-9 for g in gaps), gaps


def test_autoscaler_cooldown_preserves_determinism():
    scenario = ServeScenario(
        seed=0, n_replicas=1, max_batch=2, step_s=STEP_S,
        requests=[ServeRequestSpec(at=0.01 * i, prompt=(1, 2, 3, 4),
                                   max_new_tokens=8)
                  for i in range(24)],
        admission=False, autoscale=True, max_replicas=4,
        tick_period=0.1)
    a = run_serve_scenario(scenario)
    b = run_serve_scenario(scenario)
    assert a.ok, a.violations
    assert a.trace == b.trace
    assert "autoscale_grow" in a.trace


def test_autoscaler_capacity_repair_ignores_cooldown():
    """Replica loss below the floor is repaired immediately even inside
    a cooldown window — availability beats smoothing."""
    driver = _driver(
        n_replicas=2, max_batch=2,
        policy=[ReplicaAutoscaler(min_replicas=2, max_replicas=6,
                                  patience=2, idle_ticks=100,
                                  cooldown_ticks=50)])
    reqs = [_req(i, new=8) for i in range(10)]
    rep = driver.serve_continuous(
        reqs, arrivals=[0.02 * i for i in range(10)],
        faults=[(0.15, "kill", "replica1")], horizon=60.0,
        tick_period=0.1)
    driver.shutdown()
    assert rep.completed == 10
    repairs = [e for e in driver.monitor.event_log
               if e["event"] == "autoscale_grow"
               and e.get("reason") == "below min_replicas"]
    assert repairs                            # repaired despite cooldown


# ===== the same seeds through both packages =====
def _as_reference(trace: str) -> str:
    """A port trace in the reference's words.  ``build_trace`` dumps
    payloads with ``default=repr``, so an object's repr in a payload would
    name its module: ``repro_torch.`` where the reference has ``repro.``.
    This one substring is rewritten; any other difference fails."""
    return trace.replace("repro_torch.", "repro.")


def _stats(result) -> dict:
    # wrath_overhead_s is real measured seconds (policy-hook cost)
    return {k: v for k, v in result.stats.items() if k != "wrath_overhead_s"}


@pytest.mark.parametrize("base_seed", range(0, 200, 20))
def test_campaign_traces_equal_reference(base_seed):
    """Seeds 0-199, twenty a case: each scenario's trace, outcomes, stats
    and violations equal the JAX package's."""
    ref = ref_sim.campaign(20, base_seed=base_seed)
    port = campaign(20, base_seed=base_seed)
    assert port.ok, port.summary()
    assert ref.ok == port.ok and ref.violations == port.violations
    for r, p in zip(ref.results, port.results, strict=True):
        assert r.seed == p.seed
        assert _as_reference(p.trace) == r.trace, f"seed {p.seed}"
        assert p.outcomes == r.outcomes and _stats(p) == _stats(r), f"seed {p.seed}"
        assert (p.crashes, p.committed_at_crash, p.reexecuted, p.events_executed) == (
            r.crashes, r.committed_at_crash, r.reexecuted, r.events_executed)


@pytest.mark.parametrize("base_seed", range(0, 20, 5))
def test_serve_campaign_traces_equal_reference(base_seed):
    ref = ref_sim.serve_campaign(5, base_seed=base_seed, check_determinism=True)
    port = serve_campaign(5, base_seed=base_seed, check_determinism=True)
    for r, p in zip(ref, port, strict=True):
        assert p.ok, (p.seed, p.violations)
        assert _as_reference(p.trace) == r.trace, f"seed {p.seed}"
        assert p.violations == r.violations
        assert dataclasses.asdict(p.report) == dataclasses.asdict(r.report)


@pytest.mark.parametrize("kwargs", [{}, {"max_tasks": 12}, {"correlated_rate": 0.0},
                                    {"correlated_rate": 0.9}],
                         ids=["default", "max_tasks12", "uncorrelated", "correlated"])
def test_scenario_random_equals_reference(kwargs):
    for seed in range(50):
        want, got = ref_sim.Scenario.random(seed, **kwargs), Scenario.random(seed, **kwargs)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), seed
        assert got.to_json() == want.to_json()


@pytest.mark.parametrize("kwargs", [{}, {"outage_rate": 0.6}], ids=["default", "outages"])
def test_serve_scenario_random_equals_reference(kwargs):
    for seed in range(50):
        want = ref_sim.ServeScenario.random(seed, **kwargs)
        got = ServeScenario.random(seed, **kwargs)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), seed


@pytest.mark.parametrize("fault", [None, chip_smoke.SIM_FAULT], ids=["clean", "node_lost"])
def test_fedlearn_under_sim_equals_reference(fault):
    """fedlearn's tasks run inline on the virtual clock in both packages
    (the port's in torch on the CPU): the same trace, and weights and
    losses within FP32_TOL.  The node lost mid-round fails its two running
    client_updates over, and the weights come out bit for bit as clean."""
    ref = chip_smoke.sim_fedlearn(ref_sim, RefWrathPolicy, ref_fed.submit, fault=fault,
                                  scale="small", seed=0)
    port = chip_smoke.sim_fedlearn(port_sim, WrathPolicy, fedlearn.submit, fault=fault,
                                   scale="small", seed=0, device="cpu")
    assert port["done"] and ref["done"]
    assert _as_reference(port["trace"]) == ref["trace"]
    assert port["makespan_s"] == ref["makespan_s"]
    assert {k: v for k, v in port["stats"].items() if k != "wrath_overhead_s"} == {
        k: v for k, v in ref["stats"].items() if k != "wrath_overhead_s"}
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=FP32_TOL, atol=FP32_TOL)
    for k in ref["params"]:
        np.testing.assert_allclose(port["params"][k], ref["params"][k],
                                   rtol=FP32_TOL, atol=FP32_TOL)
    if fault is None:
        assert "heartbeat_lost" not in port["trace"]
        return
    assert "heartbeat_lost" in port["trace"] and port["stats"]["retries"] >= 1
    moved = chip_smoke.rerouted(port["trace"], fault[1])
    assert moved["retried"] and moved["placed_after_loss"] == 0
    clean = chip_smoke.sim_fedlearn(port_sim, WrathPolicy, fedlearn.submit,
                                    scale="small", seed=0, device="cpu")
    assert all(np.array_equal(port["params"][k], clean["params"][k]) for k in clean["params"])


def test_sim_exports_equal_reference():
    assert port_sim.__all__ == ref_sim.__all__


# ===== chip_smoke.py's wrath_sim host checks, small =====
def test_chip_smoke_sim_host_planes_small():
    out = chip_smoke.sim_host_planes(0, 12, 4)
    assert out["campaign"]["scenarios"] == 12 and len(out["campaign"]["sha256"]) == 64
    assert out["corpus_entries"] == len(list((Path(__file__).parent / "chaos_corpus")
                                             .glob("*.json")))
    assert out["analysis"]["--strict"].startswith("0 finding(s), 4 baselined")
    json.dumps(out)
