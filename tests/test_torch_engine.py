"""The port's engine held to the reference's own tests.

Ports, against ``repro_torch``, of all of ``tests/test_scheduler.py`` and
``tests/test_wrath_policy.py``, and of the tests of ``tests/test_engine.py``
and ``tests/test_work_stealing.py``: those on the wall clock, then those on the
port's ``SimCluster``/``SimHarness``.  Bodies are the reference's with the
imports rewritten; ``_sched_record`` is
``test_scheduler.py``'s ``_record``, renamed apart from the policy tests'.
"""
import queue
import threading
import time
from concurrent.futures import CancelledError
from concurrent.futures import TimeoutError as FuturesTimeoutError
from concurrent.futures import wait as futures_wait

import pytest
from helpers import wait_until

from repro_torch.core import MonitoringDatabase, wrath_retry_handler
from repro_torch.core.categorization import FailureCategorizationEngine
from repro_torch.core.failures import (
    DependencyError,
    EnvironmentMismatchError,
    FailureReport,
    HardwareShutdownError,
    RandomSeedError,
    ResourceStarvationError,
    UlimitExceededError,
)
from repro_torch.core.monitoring import SystemMonitoringAgent, TCPRadio, TCPRadioServer
from repro_torch.engine import (
    Cluster,
    DataFlowKernel,
    FeasibilityScheduler,
    HistoryAwareScheduler,
    LeastLoadedScheduler,
    Node,
    ResourcePool,
    RoundRobinScheduler,
    make_scheduler,
    task,
)
from repro_torch.engine.cluster import RunQueue
from repro_torch.engine.events import EventLoop
from repro_torch.engine.policies import StragglerPolicy, WrathPolicy
from repro_torch.engine.task import ResourceSpec, TaskDef, new_task_record
from repro_torch.sim import SimCluster, SimHarness, campaign


# ===== ported from tests/test_scheduler.py =====
def _sched_record(name="t", memory_gb=0.5, packages=()):
    td = TaskDef(lambda: None, name,
                 ResourceSpec(memory_gb=memory_gb, packages=tuple(packages)), 0)
    return new_task_record(td, (), {}, default_retries=0)


def _hetero_pools():
    """Heterogeneous 2-pool cluster: small-mem pool + one big/pkg pool."""
    small = ResourcePool("small", [
        Node("s0", memory_gb=8), Node("s1", memory_gb=8),
        Node("s2", memory_gb=64)])
    big = ResourcePool("big", [
        Node("b0", memory_gb=512, packages=frozenset({"numpy", "jax", "scipy"}))])
    return small, big


# ------------------------------------------------------------ unit level --
def test_round_robin_cycles_pool_order():
    small, big = _hetero_pools()
    rr = RoundRobinScheduler()
    picks = [rr.select(_sched_record(), small.nodes, pool=small).name for _ in range(5)]
    assert picks == ["s0", "s1", "s2", "s0", "s1"]
    # independent counter per pool, like one counter per executor before
    assert rr.select(_sched_record(), big.nodes, pool=big).name == "b0"
    assert rr.select(_sched_record(), small.nodes, pool=small).name == "s2"


def test_feasibility_filters_by_spec():
    small, big = _hetero_pools()
    fs = FeasibilityScheduler()
    # 32 GB task: only s2 can ever hold it in the small pool
    rec = _sched_record(memory_gb=32)
    assert fs.select(rec, small.nodes, pool=small).name == "s2"
    assert fs.select(rec, small.nodes, pool=small).name == "s2"
    # package-constrained task: infeasible everywhere in small -> None
    rec = _sched_record(packages=("scipy",))
    assert fs.select(rec, small.nodes, pool=small) is None
    assert fs.select(rec, big.nodes, pool=big).name == "b0"


def test_least_loaded_picks_emptiest_queue():
    small, _ = _hetero_pools()
    small.nodes[0].task_queue.put(_sched_record())
    small.nodes[0].task_queue.put(_sched_record())
    small.nodes[1].task_queue.put(_sched_record())
    ll = LeastLoadedScheduler()
    assert ll.select(_sched_record(), small.nodes, pool=small).name == "s2"
    small.nodes[2].task_queue.put(_sched_record())
    small.nodes[2].task_queue.put(_sched_record())
    small.nodes[2].task_queue.put(_sched_record())
    assert ll.select(_sched_record(), small.nodes, pool=small).name == "s1"


def test_history_aware_explores_then_exploits():
    small, _ = _hetero_pools()
    mon = MonitoringDatabase()
    hs = HistoryAwareScheduler(mon)
    # no history: unseen nodes are explored round-robin (selection itself
    # does not write history, so all three stay unseen here)
    first = [hs.select(_sched_record("u"), small.nodes, pool=small).name
             for _ in range(4)]
    assert first == ["s0", "s1", "s2", "s0"]
    # seed history: s0 fast+reliable, s1 slow, s2 failing
    for _ in range(4):
        mon.record_task_placement("u", "s0", "small", ok=True, duration=0.01)
        mon.record_task_placement("u", "s1", "small", ok=True, duration=1.0)
        mon.record_task_placement("u", "s2", "small", ok=False)
    picks = {hs.select(_sched_record("u"), small.nodes, pool=small).name
             for _ in range(4)}
    assert picks == {"s0"}


def test_make_scheduler_names():
    for name in ("round_robin", "feasibility", "least_loaded", "history"):
        assert make_scheduler(name).name == name
    with pytest.raises(ValueError):
        make_scheduler("nope")


# ------------------------------------------------------------ event loop --
def test_event_loop_orders_and_cancels():
    loop = EventLoop().start()
    try:
        order = []
        loop.call_later(0.10, order.append, "late")
        loop.call_later(0.02, order.append, "early")
        ev = loop.call_later(0.05, order.append, "never")
        ev.cancel()
        loop.call_soon(order.append, "now")
        deadline = time.time() + 5
        while len(order) < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert order == ["now", "early", "late"]
    finally:
        loop.stop()


def test_event_loop_periodic_and_exception_isolation():
    loop = EventLoop().start()
    try:
        ticks = []

        def tick():
            ticks.append(1)
            raise RuntimeError("must not kill the loop")

        ev = loop.schedule_periodic(0.02, tick, name="tick")
        deadline = time.time() + 5
        while len(ticks) < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert len(ticks) >= 3
        ev.cancel()
        n = len(ticks)
        time.sleep(0.08)
        assert len(ticks) <= n + 1  # at most one in-flight firing after cancel
    finally:
        loop.stop()


def test_no_timer_threads_in_retry_path():
    """Acceptance: delayed retries flow through the event loop, not Timers."""
    import inspect

    import repro_torch.engine.dfk as dfk_mod

    assert "threading.Timer(" not in inspect.getsource(dfk_mod)


# ------------------------------------------------------------ engine level --
def test_default_round_robin_parity():
    """Default scheduler reproduces pre-refactor placements: serialized
    submissions cycle the pool's healthy nodes in order."""
    mon = MonitoringDatabase()
    with DataFlowKernel(Cluster.homogeneous(3), monitor=mon) as dfk:
        @task
        def unit(i):
            return i

        for i in range(6):
            assert unit(i).result(timeout=10) == i
        placed = [dfk._assignment[tid][1] for tid in sorted(dfk._assignment)]
    assert placed == ["default-n000", "default-n001", "default-n002"] * 2


@pytest.mark.parametrize("sched_name", ["round_robin", "feasibility",
                                        "least_loaded", "history"])
def test_all_schedulers_run_dag_on_hetero_cluster(sched_name):
    """Each scheduler completes a DAG (with a WRATH-retried OOM) on the
    heterogeneous two-pool testbed."""
    cluster = Cluster.paper_testbed(small_nodes=2, big_nodes=1)
    mon = MonitoringDatabase()
    with DataFlowKernel(cluster, monitor=mon,
                        scheduler=make_scheduler(sched_name),
                        retry_handler=wrath_retry_handler(),
                        default_pool="small-mem", default_retries=2) as dfk:
        @task
        def f(x):
            return x + 1

        @task(memory_gb=200)          # only feasible in the big-mem pool
        def hungry(x):
            return x * 10

        a = f(1)
        b = hungry(f(a))
        assert b.result(timeout=20) == 30
        assert dfk.stats["completed"] == 3


def test_feasibility_scheduler_starves_infeasible_pool():
    """With no feasible node in the default pool and no retries, the task
    fails with ResourceStarvationError instead of OOMing at run time."""
    cluster = Cluster([ResourcePool("p", [Node("n0", memory_gb=8)])])
    with DataFlowKernel(cluster, scheduler=FeasibilityScheduler(),
                        default_retries=0) as dfk:
        @task(memory_gb=100)
        def big():
            return 1

        with pytest.raises(ResourceStarvationError):
            big().result(timeout=10)


def test_history_scheduler_avoids_slow_node_end_to_end():
    nodes = [Node("fast", speed=1.0, workers_per_node=1),
             Node("slug", speed=0.05, workers_per_node=1)]
    cluster = Cluster([ResourcePool("p", nodes)])
    mon = MonitoringDatabase()
    # pre-seed placement history: slug is 50x slower on this template
    for _ in range(3):
        mon.record_task_placement("unit", "fast", "p", ok=True, duration=0.01)
        mon.record_task_placement("unit", "slug", "p", ok=True, duration=0.5)
    with DataFlowKernel(cluster, monitor=mon,
                        scheduler=HistoryAwareScheduler()) as dfk:
        @task
        def unit(i):
            return i

        for i in range(4):
            assert unit(i).result(timeout=10) == i
        assert all(node == "fast" for _, node in dfk._assignment.values())


def test_map_backpressure_bounds_outstanding():
    cluster = Cluster.homogeneous(2, workers_per_node=4)
    peak = {"now": 0, "max": 0}
    lock = threading.Lock()
    with DataFlowKernel(cluster) as dfk:
        @task
        def step(i):
            with lock:
                peak["now"] += 1
                peak["max"] = max(peak["max"], peak["now"])
            time.sleep(0.03)
            with lock:
                peak["now"] -= 1
            return i

        futs = dfk.map(step, range(12), max_outstanding=2)
        assert [f.result(timeout=30) for f in futs] == list(range(12))
        loads = dfk.executors["default"].loads()
        assert set(loads) == {"default-n000", "default-n001"}
        assert all(v == 0 for v in loads.values())  # drained after the sweep
    assert peak["max"] <= 2
    assert len(futs) == 12


def test_map_unlimited_and_tuple_args():
    with DataFlowKernel(Cluster.homogeneous(2)) as dfk:
        @task
        def add(a, b):
            return a + b

        futs = dfk.map(add, [(1, 2), (3, 4), (5, 6)])
        assert [f.result(timeout=10) for f in futs] == [3, 7, 11]


def test_map_rejects_bad_cap():
    with DataFlowKernel(Cluster.homogeneous(1)) as dfk:
        @task
        def unit(i):
            return i

        with pytest.raises(ValueError):
            dfk.map(unit, range(2), max_outstanding=0)


def test_heartbeat_resumed_recorded_once_per_transition():
    """Regression (satellite): a recovered node awaiting un-denylisting must
    log heartbeat_resumed once, not on every watcher tick."""
    mon = MonitoringDatabase()
    cluster = Cluster.homogeneous(2, workers_per_node=1)
    with DataFlowKernel(cluster, monitor=mon, heartbeat_period=0.02,
                        heartbeat_threshold=3) as dfk:
        victim = cluster.all_nodes()[0]
        assert wait_until(               # heartbeats flowing
            lambda: victim.name in mon.last_heartbeats(), timeout=5)
        dfk.denylist.add(victim.name)  # denylisted but still heartbeating
        time.sleep(0.3)               # many watcher ticks
        resumed = [e for e in mon.system_events
                   if e["event"] == "heartbeat_resumed"
                   and e["node"] == victim.name]
        assert len(resumed) == 1


def test_heartbeat_resumed_rearms_after_second_outage():
    """A second lost->resumed cycle while still denylisted must produce a
    second heartbeat_resumed event (silence re-arms the transition)."""
    mon = MonitoringDatabase()
    cluster = Cluster.homogeneous(1, workers_per_node=1)
    dfk = DataFlowKernel(cluster, monitor=mon, heartbeat_period=0.02,
                         heartbeat_threshold=3)
    node = cluster.all_nodes()[0].name
    dfk.denylist.add(node)
    mon.heartbeat(node, time.time())
    dfk._check_heartbeats()
    dfk._check_heartbeats()            # still only one resume transition
    mon.heartbeat(node, time.time() - 999)   # silent again while denylisted
    dfk._check_heartbeats()
    mon.heartbeat(node, time.time())         # resumes a second time
    dfk._check_heartbeats()
    resumed = [e for e in mon.system_events
               if e["event"] == "heartbeat_resumed" and e["node"] == node]
    assert len(resumed) == 2


# ===== ported from tests/test_wrath_policy.py =====
def _record(name="t", memory_gb=1.0, packages=(), retries=2):
    td = TaskDef(lambda: None, name, ResourceSpec(memory_gb=memory_gb,
                                                  packages=tuple(packages)), retries)
    return new_task_record(td, (), {}, default_retries=retries)


# -------------------------------------------------------- categorization --
def test_categorize_memory_capacity_mismatch():
    eng = FailureCategorizationEngine()
    rec = _record(memory_gb=200)
    rep = FailureReport.from_exception(
        MemoryError("cannot allocate"), task_id=rec.task_id, node="n0", pool="p",
        resource_profile={"node_memory_gb": 192.0, "node_mem_in_use_gb": 0.0},
        requirements=rec.resources.asdict())
    cat = eng.categorize(rec, rep)
    assert cat.resolvable
    assert cat.resource_related
    assert cat.required_memory_gb == 200
    assert "capacity" in cat.explanation


def test_categorize_transient_contention():
    eng = FailureCategorizationEngine()
    rec = _record(memory_gb=6)
    rep = FailureReport.from_exception(
        MemoryError("cannot allocate"), task_id=rec.task_id, node="n0", pool="p",
        resource_profile={"node_memory_gb": 8.0, "node_mem_in_use_gb": 6.0},
        requirements=rec.resources.asdict())
    cat = eng.categorize(rec, rep)
    assert cat.resolvable
    assert "contention" in cat.explanation


def test_categorize_env_mismatch_extracts_packages():
    eng = FailureCategorizationEngine()
    rec = _record(packages=("scipy",))
    rep = FailureReport.from_exception(
        ImportError("No module named 'scipy'"), task_id=rec.task_id, node="n0",
        pool="p", requirements=rec.resources.asdict())
    cat = eng.categorize(rec, rep)
    assert cat.resolvable
    assert "scipy" in cat.required_packages


def test_categorize_user_error_not_resolvable():
    eng = FailureCategorizationEngine()
    rec = _record()
    rep = FailureReport.from_exception(ZeroDivisionError("div"),
                                       task_id=rec.task_id)
    cat = eng.categorize(rec, rep)
    assert not cat.resolvable


def test_categorize_dependency_nonretriable_root_fails_fast():
    eng = FailureCategorizationEngine()
    rec = _record()
    err = DependencyError("parent failed", root_cause=ValueError("bad"))
    rep = FailureReport.from_exception(err, task_id=rec.task_id)
    cat = eng.categorize(rec, rep)
    assert not cat.resolvable


def test_categorize_hardware_denylists():
    eng = FailureCategorizationEngine()
    rec = _record()
    rep = FailureReport.from_exception(
        HardwareShutdownError("node down"), task_id=rec.task_id, node="n3")
    cat = eng.categorize(rec, rep)
    assert cat.resolvable
    assert cat.denylist_node


def test_fail_fast_heuristic_multi_node_multi_pool():
    eng = FailureCategorizationEngine(fail_fast_distinct_nodes=2)
    rec = _record(memory_gb=500)
    rec.attempts = [
        {"attempt": 0, "node": "a0", "pool": "p1", "worker": "w", "ok": False,
         "error": "MemoryError", "duration": 0.1, "time": 0},
        {"attempt": 1, "node": "b0", "pool": "p2", "worker": "w", "ok": False,
         "error": "MemoryError", "duration": 0.1, "time": 0},
    ]
    rep = FailureReport.from_exception(
        MemoryError("x"), task_id=rec.task_id, node="c0", pool="p3",
        resource_profile={"node_memory_gb": 192.0},
        requirements=rec.resources.asdict())
    cat = eng.categorize(rec, rep)
    assert not cat.resolvable  # recurred across pools -> fail fast


def test_random_seed_error_never_fails_fast():
    eng = FailureCategorizationEngine(fail_fast_distinct_nodes=2)
    rec = _record()
    rec.attempts = [
        {"attempt": i, "node": f"n{i}", "pool": "p", "worker": "w", "ok": False,
         "error": "RandomSeedError", "duration": 0.1, "time": 0}
        for i in range(2)]
    rep = FailureReport.from_exception(RandomSeedError("unlucky"),
                                       task_id=rec.task_id, node="n9", pool="p")
    cat = eng.categorize(rec, rep)
    assert cat.resolvable


# ------------------------------------------------------------- end to end --
def test_memory_failure_hierarchical_retry_to_big_pool():
    """§VII-C memory scenario: 200 GB task, 192 GB pool + 6 TB pool."""
    handler = wrath_retry_handler()
    mon = MonitoringDatabase()
    cluster = Cluster.paper_testbed(small_nodes=3, big_nodes=1)
    with DataFlowKernel(cluster, monitor=mon, retry_handler=handler,
                        default_pool="small-mem", default_retries=2) as dfk:
        @task(memory_gb=200)
        def hungry(x):
            return x + 1

        assert hungry(1).result(timeout=15) == 2
        assert dfk.stats["retry_success"] == 1
    # the decisive retry must have moved pools (rung 4)
    rungs = [d["rung"] for d in handler.decisions]
    assert 4 in rungs


def test_import_failure_hierarchical_retry_to_pkg_pool():
    handler = wrath_retry_handler()
    mon = MonitoringDatabase()
    cluster = Cluster.paper_testbed(small_nodes=3, big_nodes=1,
                                    with_pkg_pool=True, package="scipy")
    with DataFlowKernel(cluster, monitor=mon, retry_handler=handler,
                        default_pool="no-pkg", default_retries=2) as dfk:
        @task(packages=("scipy",))
        def needs(x):
            return x * 2

        assert needs(5).result(timeout=15) == 10
    assert any(d["failure_type"] == "env_mismatch" for d in handler.decisions)


def test_user_error_immediate_termination_no_retries():
    handler = wrath_retry_handler()
    with DataFlowKernel(Cluster.homogeneous(2), monitor=MonitoringDatabase(),
                        retry_handler=handler, default_retries=5) as dfk:
        @task
        def boom():
            raise ValueError("user bug")

        with pytest.raises(ValueError):
            boom().result(timeout=10)
        assert dfk.stats["retries"] == 0
    assert handler.decisions[-1]["action"] == "fail"


def test_dependency_children_fail_fast():
    handler = wrath_retry_handler()
    with DataFlowKernel(Cluster.homogeneous(2), monitor=MonitoringDatabase(),
                        retry_handler=handler, default_retries=5) as dfk:
        @task
        def parent():
            raise KeyError("parent bug")

        @task
        def child(x):
            return x

        c = child(parent())
        with pytest.raises(DependencyError):
            c.result(timeout=10)
        assert dfk.stats["retries"] == 0
        assert dfk.stats["dep_failed"] == 1


def test_random_seed_error_retries_in_place():
    handler = wrath_retry_handler()
    attempts = {"n": 0}
    with DataFlowKernel(Cluster.homogeneous(2), monitor=MonitoringDatabase(),
                        retry_handler=handler, default_retries=3) as dfk:
        @task
        def flaky():
            attempts["n"] += 1
            if attempts["n"] < 3:
                raise RandomSeedError("bad seed")
            return "ok"

        assert flaky().result(timeout=10) == "ok"
        assert dfk.stats["retries"] == 2
    assert all(d["action"] == "retry" for d in handler.decisions)


def test_denylist_added_on_shutdown_and_removed_on_resume():
    handler = wrath_retry_handler(heartbeat_resume_window=10.0)
    mon = MonitoringDatabase()
    cluster = Cluster.homogeneous(3, workers_per_node=1)
    with DataFlowKernel(cluster, monitor=mon, retry_handler=handler,
                        default_retries=3, heartbeat_period=0.03,
                        heartbeat_threshold=3) as dfk:
        @task
        def slow(x):
            time.sleep(0.25)
            return x

        futs = [slow(i) for i in range(3)]
        victim = cluster.all_nodes()[0]
        assert wait_until(lambda: all(f.record.start_time > 0 for f in futs),
                          timeout=5)
        victim.shutdown_hardware()
        for f in futs:
            f.result(timeout=30)
        assert victim.name in dfk.denylist
        # resurrect: wait for a heartbeat *after* the restore, then the
        # next decision refreshes the denylist
        t_restore = time.time()
        victim.restore_hardware()
        assert wait_until(
            lambda: mon.last_heartbeats().get(victim.name, 0) > t_restore,
            timeout=5)
        handler._refresh_denylist(dfk.context())
        assert victim.name not in dfk.denylist


def test_decision_log_records_rungs_and_layers():
    handler = wrath_retry_handler()
    cluster = Cluster.paper_testbed(small_nodes=2, big_nodes=1)
    with DataFlowKernel(cluster, monitor=MonitoringDatabase(),
                        retry_handler=handler, default_pool="small-mem",
                        default_retries=2) as dfk:
        @task(memory_gb=200)
        def hungry():
            return 1

        hungry().result(timeout=15)
    d = handler.decisions[0]
    assert d["layer"] == "runtime"
    assert d["failure_type"] == "resource_starvation"
    assert d["action"] in ("retry", "restart_retry")


# ===== ported from tests/test_engine.py =====
@pytest.fixture()
def mon():
    return MonitoringDatabase()


def test_dag_diamond():
    with DataFlowKernel(Cluster.homogeneous(2)) as dfk:
        @task
        def f(x):
            return x + 1

        @task
        def g(a, b):
            return a * b

        a = f(1)          # 2
        b = f(a)          # 3
        c = f(a)          # 3
        d = g(b, c)       # 9
        assert d.result(timeout=10) == 9


def test_nested_future_args():
    with DataFlowKernel(Cluster.homogeneous(2)) as dfk:
        @task
        def one():
            return 1

        @task
        def total(xs, named=None):
            return sum(xs) + sum(named.values())

        futs = [one() for _ in range(4)]
        t = total(futs[:2], named={"a": futs[2], "b": futs[3]})
        assert t.result(timeout=10) == 4


def test_multiparent_task_executes_exactly_once():
    """Regression: racing parent-completion callbacks must not double-run."""
    import threading
    counter = {"n": 0}
    lock = threading.Lock()

    with DataFlowKernel(Cluster.homogeneous(4)) as dfk:
        @task
        def src(i):
            return i

        @task
        def join(xs):
            with lock:
                counter["n"] += 1
            return sum(xs)

        for _ in range(10):
            parents = [src(i) for i in range(8)]
            j = join(parents)
            assert j.result(timeout=10) == 28
    assert counter["n"] == 10


def test_memory_capacity_enforced_baseline_fails():
    cluster = Cluster.homogeneous(2, memory_gb=8)
    with DataFlowKernel(cluster, default_retries=1) as dfk:
        @task(memory_gb=100)
        def big():
            return 1

        with pytest.raises(MemoryError):
            big().result(timeout=10)
        assert dfk.stats["retries"] == 1  # baseline burned its retry


def test_package_mismatch_raises_env_error():
    cluster = Cluster.homogeneous(1)
    with DataFlowKernel(cluster, default_retries=0) as dfk:
        @task(packages=("nonexistent_pkg",))
        def needs():
            return 1

        with pytest.raises(EnvironmentMismatchError):
            needs().result(timeout=10)


def test_ulimit_enforced():
    cluster = Cluster([ResourcePool("p", [Node("n0", ulimit_files=100)])])
    with DataFlowKernel(cluster, default_retries=0) as dfk:
        @task(open_files=1_000_000)
        def files():
            return 1

        with pytest.raises(UlimitExceededError):
            files().result(timeout=10)


def test_tcp_radio_roundtrip(mon):
    server = TCPRadioServer(mon).start()
    try:
        radio = TCPRadio(server.address)
        radio.send({"kind": "heartbeat", "node": "tcp-node", "time": time.time()})
        radio.send({"kind": "task_event", "task_id": "t1", "event": "submitted",
                    "data": {"name": "x"}})
        assert wait_until(lambda: "tcp-node" in mon.last_heartbeats()
                          and mon.events_for("t1"))
        radio.close()
    finally:
        server.stop()


def test_system_monitoring_agent_heartbeats(mon):
    from repro_torch.core.monitoring import InProcRadio
    agent = SystemMonitoringAgent("comp-x", InProcRadio(mon), period=0.02).start()
    assert wait_until(lambda: "comp-x" in mon.last_heartbeats())
    agent.stop()


def test_placement_history(mon):
    cluster = Cluster.homogeneous(2)
    with DataFlowKernel(cluster, monitor=mon) as dfk:
        @task
        def ok():
            return 1

        for _ in range(6):
            ok().result(timeout=10)
    hist = mon.node_history("ok")
    assert sum(s.successes for s in hist.values()) == 6
    assert mon.best_historical_node("ok") is not None


# ===== ported from tests/test_work_stealing.py =====
def _rec(name: str = "t"):
    return new_task_record(TaskDef(lambda: None, name, ResourceSpec(), 0),
                           (), {}, default_retries=0)


# --------------------------------------------------------------------- #
# run-queue primitive
# --------------------------------------------------------------------- #
def test_run_queue_fifo_for_owner_stealable_at_tail():
    q = RunQueue()
    with pytest.raises(queue.Empty):
        q.get_nowait()
    with pytest.raises(queue.Empty):
        q.get(timeout=0.01)
    recs = [_rec(f"t{i}") for i in range(3)]
    for r in recs:
        q.put(r)
    assert q.qsize() == 3 and not q.empty()
    # stealing takes the newest entry; the owner still drains FIFO
    assert q.steal_tail(lambda r: True) is recs[2]
    assert q.get_nowait() is recs[0]
    assert q.remove(recs[1].task_id) is recs[1]
    assert q.remove("task-999999") is None
    assert q.empty()


def test_steal_tail_skips_cancelled_and_pinned_records():
    q = RunQueue()
    recs = [_rec(f"t{i}") for i in range(3)]
    recs[1].target_node = "elsewhere"     # retry-rung pin: not stealable
    recs[2].cancel_requested = True       # cancelled: never back to life
    for r in recs:
        q.put(r)

    def stealable(r):
        return not r.cancel_requested and r.target_node is None

    assert q.steal_tail(stealable) is recs[0]
    assert q.steal_tail(stealable) is None
    assert q.qsize() == 2


# --------------------------------------------------------------------- #
# AppFuture shared-condition semantics (the batched-dispatch fast path)
# --------------------------------------------------------------------- #
def test_appfuture_shared_condition_semantics():
    futs = [_rec(f"f{i}").future for i in range(3)]
    with pytest.raises(FuturesTimeoutError):
        futs[0].result(timeout=0.01)
    with pytest.raises(FuturesTimeoutError):
        futs[0].exception(timeout=0.01)
    calls = []
    futs[0].add_done_callback(calls.append)
    futs[0].set_result(7)
    assert futs[0].result(timeout=0) == 7
    assert futs[0].exception(timeout=0) is None
    assert calls == [futs[0]]
    futs[1].set_exception(ValueError("x"))
    assert isinstance(futs[1].exception(timeout=0), ValueError)
    with pytest.raises(ValueError):
        futs[1].result(timeout=0)
    futs[2].set_result(1)
    # concurrent.futures.wait acquires every waited future's condition at
    # once; all AppFutures share ONE condition object, so this exercises
    # the reentrant acquisition the shared condition relies on
    done, not_done = futures_wait(futs, timeout=1.0)
    assert done == set(futs) and not not_done


def test_appfuture_result_blocks_until_cross_thread_resolution():
    fut = _rec().future
    timer = threading.Timer(0.05, fut.set_result, args=(42,))
    timer.start()
    try:
        assert fut.result(timeout=5.0) == 42
    finally:
        timer.cancel()


def test_appfuture_cancel_raises_cancelled_error():
    fut = _rec().future
    assert fut.cancel()
    with pytest.raises(CancelledError):
        fut.result(timeout=0)
    with pytest.raises(CancelledError):
        fut.exception(timeout=0)


# ===== ported from tests/test_engine.py: the tests on the sim plane =====
def test_transient_contention_retry_succeeds():
    """Two 6 GB tasks on one 8 GB node: the loser backs off and succeeds."""
    cluster = SimCluster.homogeneous(1, memory_gb=8, workers_per_node=2)
    with SimHarness(cluster, durations={"hold": 0.2}, policy=WrathPolicy(),
                    default_retries=6) as h:
        @task(memory_gb=6)
        def hold(t):
            return t

        futs = [hold(0.2), hold(0.2)]
        assert [h.result(f, timeout=15) for f in futs] == [0.2, 0.2]
        assert h.dfk.stats["retries"] >= 1  # the loser was retried with backoff


def test_heartbeats_flow_to_monitor():
    with SimHarness(SimCluster.homogeneous(2)) as h:
        h.advance(0.25)
        beats = h.monitor.last_heartbeats()
        assert len(beats) == 2
        assert all(h.clock.time() - t < 5 for t in beats.values())


def test_hardware_shutdown_detected_and_rerouted():
    """Kill a node mid-run: heartbeat loss reroutes its tasks (WRATH)."""
    cluster = SimCluster.homogeneous(3, workers_per_node=1)
    with SimHarness(cluster, durations={"slow": 0.3}, policy=WrathPolicy(),
                    default_retries=3, heartbeat_period=0.03,
                    heartbeat_threshold=3) as h:
        @task
        def slow(x):
            return x

        futs = [slow(i) for i in range(3)]
        h.advance(0.05)
        h.fail_node(cluster.all_nodes()[0].name)
        results = sorted(h.result(f, timeout=30) for f in futs)
        assert results == [0, 1, 2]
    events = [e["event"] for e in h.monitor.system_events]
    assert "heartbeat_lost" in events or "denylist_add" in events


def test_worker_killed_respawns():
    from repro_torch.engine.cluster import kill_current_worker
    cluster = SimCluster.homogeneous(2, workers_per_node=1)
    with SimHarness(cluster, policy=WrathPolicy(), default_retries=2) as h:
        killed = {"done": False}

        @task
        def murder():
            if not killed["done"]:
                killed["done"] = True
                kill_current_worker()
            return "survived"

        assert h.result(murder(), timeout=15) == "survived"
        # node managers respawn killed workers
        h.advance(0.2)
        for node in cluster.all_nodes():
            assert sum(1 for w in node.workers if w.alive) >= 1


def test_speculative_execution_beats_straggler():
    nodes = [Node("fast", speed=1.0, workers_per_node=1),
             Node("slug", speed=0.02, workers_per_node=1)]
    cluster = SimCluster([ResourcePool("p", nodes)])
    with SimHarness(cluster, durations={"work": 0.1},
                    policy=[StragglerPolicy(2.0)],
                    heartbeat_period=0.03) as h:
        @task(est_duration_s=0.1)
        def work(x):
            return x

        # keep "fast" busy briefly so one task lands on the straggler
        futs = [work(i) for i in range(2)]
        t0 = h.clock.now()
        assert sorted(h.result(f, timeout=30) for f in futs) == [0, 1]
        elapsed = h.clock.now() - t0
        # without speculation the straggler task would take ~5s (0.1/0.02)
        assert elapsed < 4.0
    assert h.dfk.stats["speculations"] >= 1


# ===== ported from tests/test_work_stealing.py: the tests on the sim plane =====
def _skew() -> SimCluster:
    nodes = [Node("fast", speed=1.0, workers_per_node=1),
             Node("slug", speed=0.25, workers_per_node=1)]
    return SimCluster([ResourcePool("p", nodes)])


def test_steal_moves_queued_task_to_idle_node():
    with SimHarness(_skew(), durations={"work": 1.0},
                    work_stealing=True) as h:
        @task
        def work(i):
            return i

        futs = [work(i) for i in range(4)]
        assert h.wait_all(timeout=30)
        assert [h.result(f) for f in futs] == [0, 1, 2, 3]
        assert h.dfk.stats["steals"] == 1
        stolen = [f.record for f in futs if f.record.steal_path]
        assert len(stolen) == 1
        hop = stolen[0].steal_path[-1]
        assert hop["from"] == "slug" and hop["to"] == "fast"
        # the attempt ran on the thief, not where placement put it
        assert stolen[0].attempts[-1]["node"] == "fast"
        # makespan is bounded by the slug's one *running* task (4 virtual
        # seconds), not its whole backlog (8 without stealing)
        assert h.clock.now() <= 4.5


def test_no_stealing_without_the_flag():
    with SimHarness(_skew(), durations={"work": 1.0}) as h:
        @task
        def work(i):
            return i

        futs = [work(i) for i in range(4)]
        assert h.wait_all(timeout=30)
        assert h.dfk.stats["steals"] == 0
        assert all(not f.record.steal_path for f in futs)
        assert h.clock.now() >= 7.5


def test_stolen_task_failure_propagates_to_owning_scope():
    """A stolen task's failure lands in the Workflow scope that owns it,
    attributed to the thief node — the steal-tree record keeps hierarchy
    bookkeeping correct across the migration."""
    with SimHarness(_skew(), durations={"work": 1.0, "boom": 1.0},
                    work_stealing=True) as h:
        @task
        def work(i):
            return i

        @task(max_retries=0)
        def boom():
            raise ZeroDivisionError("stolen and doomed")

        wf = h.dfk.workflow("grp", propagate="siblings")
        f0 = work(0)                            # fast, 0→1
        sib = work.options(workflow=wf)(1)      # slug, running 0→4
        filler = work(2)                        # fast queue, 1→2
        bad = boom.options(workflow=wf)()       # slug queue → stolen at 2
        assert h.wait_all(timeout=60)
        assert h.result(f0) == 0 and h.result(filler) == 2
        assert h.dfk.stats["steals"] >= 1
        rec = bad.record
        assert rec.steal_path and rec.steal_path[-1]["to"] == "fast"
        assert rec.attempts[-1]["node"] == "fast"
        assert isinstance(bad.exception(timeout=0), ZeroDivisionError)
        # siblings propagation fired in the *owning* scope: the running
        # sibling was cancelled instead of completing at t=4
        assert sib.exception(timeout=0) is not None
        # tasks outside the scope were untouched by the propagation
        assert f0.exception(timeout=0) is None


def test_cancelled_scope_tasks_are_not_stolen_back_to_life():
    with SimHarness(_skew(), durations={"work": 1.0},
                    work_stealing=True) as h:
        @task
        def work(i):
            return i

        wf = h.dfk.workflow("doomed")
        f0 = work(0)                            # fast, 0→1
        running = work.options(workflow=wf)(1)  # slug, running 0→4
        filler = work(2)                        # fast queue, 1→2
        victim = work.options(workflow=wf)(3)   # slug queue
        h.advance(0.5)                          # placed; victim still queued
        wf.cancel("scripted")
        assert h.wait_all(timeout=30)
        assert victim.exception(timeout=0) is not None
        assert not victim.record.attempts       # never ran anywhere
        assert not victim.record.steal_path
        assert running.exception(timeout=0) is not None
        # when the fast node went idle there was nothing left to steal
        assert h.dfk.stats["steals"] == 0
        assert h.result(f0) == 0 and h.result(filler) == 2


def test_node_loss_after_steal_attributes_to_thief():
    """Heartbeat loss on the *thief* fails and reroutes the stolen task:
    the sweep keys on the assignment table, which the steal re-pointed.
    Without that re-pointing the sweep would find nothing on the dead
    node and no retry would ever fire."""
    with SimHarness(_skew(), durations={"work": 1.0, "roam": 5.0},
                    work_stealing=True, heartbeat_period=0.1,
                    heartbeat_threshold=1.0) as h:
        @task
        def work(i):
            return i

        @task
        def roam():
            return "done"

        work(0), work(1), work(2)               # fast 0→1, slug 0→4, fast 1→2
        fut = roam()                            # slug queue → stolen at 2
        assert h.run_until(lambda: h.dfk.stats["steals"] >= 1, timeout=10)
        assert fut.record.steal_path[-1]["to"] == "fast"
        h.fail_node("fast")                     # thief goes silent mid-run
        # the watcher fails the stolen task ON THE THIEF within the
        # staleness window (well before the in-flight delivery at t=7)
        # and reroutes it — only possible with the re-pointed assignment
        assert h.run_until(lambda: h.dfk.stats["retries"] >= 1, timeout=2.5)
        assert h.wait_all(timeout=200)
        assert fut.result(timeout=0) == "done"
        # real-cluster parity: heartbeat silence is not proof of death —
        # the thief's in-flight attempt still delivered (t=7, before the
        # slug-side retry could finish) and won the future
        assert fut.record.attempts[-1]["node"] == "fast"
        assert fut.record.attempts[-1]["ok"]


def test_steal_interleavings_trace_deterministic():
    def one() -> str:
        with SimHarness(_skew(), durations={"work": 1.0},
                        work_stealing=True, trace=True) as h:
            @task
            def work(i):
                return i

            futs = [work(i) for i in range(12)]
            assert h.wait_all(timeout=120)
            assert h.dfk.stats["steals"] >= 1
            assert all(f.exception(timeout=0) is None for f in futs)
            return h.trace()

    first, second = one(), one()
    assert "stolen" in first
    assert first == second


def test_same_seed_campaign_identical_with_stealing():
    rep = campaign(6, determinism_checks=6,
                   engine_kwargs={"work_stealing": True})
    assert rep.ok, rep.violations
