"""The port's task-hierarchy facade and task store held to the reference's
own tests, plus the store's hashing of torch tensors.

Ports, against ``repro_torch``, of the tests of ``tests/test_api.py`` and
``tests/test_task_store.py``: those on the wall clock, then those on the
port's ``SimCluster``/``SimHarness``.  Bodies are the reference's with the
imports rewritten.  Tests between the two parts cover the one deliberate
edit of the copied store, tensors hash by value, and run the same inputs
through both packages: the store's hashes, keys and files, and the
facade's outcomes and counts.
"""
import json
import pickle
import re
import time
import warnings

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro_torch.api as port_api
from repro.checkpoint import task_store as ref_task_store

from repro_torch.api import (
    Action,
    Cluster,
    DataFlowKernel,
    MonitoringDatabase,
    PolicyStack,
    ProactivePolicy,
    ResiliencePolicy,
    RetryDecision,
    TaskCancelledError,
    WrathPolicy,
    replay,
    replicate,
    task,
)
from repro_torch.checkpoint.task_store import (
    CheckpointPolicy,
    TaskStore,
    as_checkpoint_policy,
    hash_value,
    lineage_key,
)
from repro_torch.core import wrath_retry_handler
from repro_torch.sim import SimCluster, SimHarness


# ===== ported from tests/test_api.py =====
@task(memory_gb=1)
def add_one(x):
    return x + 1


@task(memory_gb=200)          # too big for 192 GB small-mem nodes
def hungry(x):
    return x * 2


@task
def napper(x, duration=1.0):
    time.sleep(duration)
    return x


@task(max_retries=0)
def fatal():
    raise ValueError("fatal task error")


# --------------------------------------------------------------------- #
# deprecation shims: old kwargs == equivalent policy stacks
# --------------------------------------------------------------------- #
def _oom_recovery_decisions(**dfk_kwargs):
    """Run the §VII-C OOM-recovery golden path; return (result, decisions)."""
    cluster = Cluster.paper_testbed(small_nodes=2, big_nodes=1)
    with DataFlowKernel(cluster, monitor=MonitoringDatabase(),
                        default_pool="small-mem", default_retries=2,
                        **dfk_kwargs) as dfk:
        result = hungry(21).result(timeout=30)
    return result, dfk


def test_legacy_retry_handler_kwarg_warns_and_matches_policy_stack():
    handler = wrath_retry_handler()
    with pytest.warns(DeprecationWarning, match="retry_handler"):
        old_result, _ = _oom_recovery_decisions(retry_handler=handler)
    wrath = WrathPolicy()
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)  # new path is clean
        new_result, _ = _oom_recovery_decisions(policy=[wrath])
    assert old_result == new_result == 42
    old = [(d["failure_type"], d["action"], d["rung"]) for d in handler.decisions]
    new = [(d["failure_type"], d["action"], d["rung"]) for d in wrath.decisions]
    assert old == new          # identical decision sequence, both spellings
    assert ("resource_starvation", "retry", 4) in new


def test_legacy_proactive_kwarg_matches_proactive_policy():
    """Predictive fast-fail fires identically through both spellings."""
    def run(**kwargs):
        cluster = Cluster.homogeneous(2, memory_gb=8)
        with DataFlowKernel(cluster, monitor=MonitoringDatabase(),
                            **kwargs) as dfk:
            fut = hungry(1)    # 200 GB fits no 8 GB node: destined to fail
            with pytest.raises(Exception):
                fut.result(timeout=10)
            kinds = [d.kind for d in dfk.sentinel.decisions]
            return kinds, dfk.stats["fast_fails"], len(fut.record.attempts)

    with pytest.warns(DeprecationWarning, match="proactive"):
        old_kinds, old_ff, old_attempts = run(
            retry_handler=wrath_retry_handler(), proactive=True)
    new_kinds, new_ff, new_attempts = run(
        policy=[WrathPolicy(), ProactivePolicy()])
    assert "fast_fail" in old_kinds and "fast_fail" in new_kinds
    assert old_ff == new_ff == 1
    assert old_attempts == new_attempts == 0   # failed before any execution


def test_legacy_speculative_execution_kwarg_warns():
    with pytest.warns(DeprecationWarning, match="speculative_execution"):
        dfk = DataFlowKernel(Cluster.homogeneous(2),
                             speculative_execution=True)
    from repro_torch.engine.policies import StragglerPolicy
    assert any(isinstance(p, StragglerPolicy) for p in dfk.policies)


# --------------------------------------------------------------------- #
# workflow scopes
# --------------------------------------------------------------------- #
def test_workflow_scope_defaults_and_nesting():
    cluster = Cluster.paper_testbed(small_nodes=2, big_nodes=1)
    with DataFlowKernel(cluster, default_pool="small-mem") as dfk:
        with dfk.workflow("outer", pool="big-mem", retries=7) as outer:
            with outer.workflow("inner") as inner:
                fut = add_one(1)
        assert fut.result(timeout=10) == 2
        rec = fut.record
        assert rec.workflow is inner
        assert inner.parent is outer
        assert inner.path == "outer/inner"
        assert rec.pool_default == "big-mem"      # inherited from outer
        assert rec.max_retries == 7               # inherited scope default
        pool, node = dfk._assignment[rec.task_id]
        assert pool == "big-mem"
        assert outer.stats()["tasks"] == 1        # subtree includes inner's


def test_workflow_options_pin_beats_active_scope():
    with DataFlowKernel(Cluster.homogeneous(2)) as dfk:
        target = dfk.workflow("target")
        with dfk.workflow("active"):
            fut = add_one.options(workflow=target)(5)
        assert fut.result(timeout=10) == 6
        assert fut.record.workflow is target
        assert target.stats()["tasks"] == 1


def test_submission_into_cancelled_scope_is_cancelled():
    with DataFlowKernel(Cluster.homogeneous(2)) as dfk:
        wf = dfk.workflow("dead")
        wf.cancel("pre-cancelled")
        fut = add_one.options(workflow=wf)(1)
        assert isinstance(fut.exception(timeout=5), TaskCancelledError)


def test_workflow_scoped_policy_beats_engine_stack():
    """Per-invocation stack resolution: task > workflow > engine."""
    class AlwaysFail(ResiliencePolicy):
        def on_failure(self, rec, report, ctx):
            return RetryDecision(Action.FAIL, reason="scope says fail fast")

    with DataFlowKernel(Cluster.homogeneous(2), policy=[WrathPolicy()],
                        default_retries=5) as dfk:
        with dfk.workflow("strict", policy=AlwaysFail()):
            fut = fatal.options(max_retries=5)()
        with pytest.raises(ValueError):
            fut.result(timeout=10)
        assert len(fut.record.attempts) == 1   # scope policy pre-empted retries


# --------------------------------------------------------------------- #
# HPX-style combinators
# --------------------------------------------------------------------- #
def test_replay_runs_exactly_n_attempts():
    with DataFlowKernel(Cluster.homogeneous(2), default_retries=9) as dfk:
        fut = fatal.options(max_retries=9, policy=replay(3))()
        with pytest.raises(ValueError):
            fut.result(timeout=10)
        assert len(fut.record.attempts) == 3


def test_replay_defer_hands_over_to_deeper_policy():
    """Deferred replay must not eat the deeper policy's retry budget:
    with the engine-default budget (2), two replays then WRATH rung 4."""
    wrath = WrathPolicy()
    cluster = Cluster.paper_testbed(small_nodes=2, big_nodes=1)
    with DataFlowKernel(cluster, policy=[wrath],
                        default_pool="small-mem", default_retries=2) as dfk:
        # 2 in-place replays OOM again; then WRATH's rung 4 finds big-mem
        fut = hungry.options(policy=replay(2, on_exhausted="defer"))(21)
        assert fut.result(timeout=30) == 42
        assert len(wrath.decisions) >= 1       # WRATH took over post-replay
        assert fut.record.retry_count >= 2


def test_policy_class_instead_of_instance_raises():
    with pytest.raises(TypeError, match=r"WrathPolicy\(\)"):
        DataFlowKernel(Cluster.homogeneous(2), policy=[WrathPolicy])
    with pytest.raises(TypeError, match="wrath"):
        DataFlowKernel(Cluster.homogeneous(2), policy="wrath")


def test_replica_win_completes_original_record_in_scope_stats():
    with DataFlowKernel(Cluster.homogeneous(3, workers_per_node=1)) as dfk:
        with dfk.workflow("scoped") as wf:
            fut = napper.options(policy=replicate(2))(3, duration=0.05)
            assert fut.result(timeout=10) == 3
        wf.wait(timeout=10)
        st = wf.stats()
        assert st["completed"] == 1 and st["running"] == 0, st


def test_subscope_created_after_cancel_is_cancelled():
    with DataFlowKernel(Cluster.homogeneous(2)) as dfk:
        root = dfk.workflow("root")
        root.cancel("killed")
        late = root.workflow("late")       # born into a killed tree
        assert late.cancelled
        fut = add_one.options(workflow=late)(1)
        assert isinstance(fut.exception(timeout=5), TaskCancelledError)


def test_replicate_validate_rejects_bad_results():
    attempts = []

    @task(max_retries=0)
    def once():
        attempts.append(1)
        return -1

    with DataFlowKernel(Cluster.homogeneous(2)) as dfk:
        fut = once.options(policy=replicate(2, validate=lambda r: r > 0))()
        err = fut.exception(timeout=10)
        from repro_torch.api import ReplicationError
        assert isinstance(err, ReplicationError)
        assert "rejected by validator" in str(err)


# --------------------------------------------------------------------- #
# map(): kwargs_iter + explicit unpack
# --------------------------------------------------------------------- #
@task
def combine(a, b=0, *, scale=1):
    return (a + b) * scale


def test_map_tuple_splat_default_and_opt_out():
    with DataFlowKernel(Cluster.homogeneous(2)) as dfk:
        futs = dfk.map(combine, [(1, 2), (3, 4)])          # historical splat
        assert [f.result(timeout=10) for f in futs] == [3, 7]

        @task
        def length(x):
            return len(x)

        futs = dfk.map(length, [(1, 2), (3, 4, 5)], unpack=False)
        assert [f.result(timeout=10) for f in futs] == [2, 3]


def test_map_kwargs_iter_zipped_and_alone():
    with DataFlowKernel(Cluster.homogeneous(2)) as dfk:
        futs = dfk.map(combine, [1, 2],
                       kwargs_iter=[{"b": 10}, {"b": 20, "scale": 2}])
        assert [f.result(timeout=10) for f in futs] == [11, 44]
        futs = dfk.map(combine, kwargs_iter=[{"a": 5, "b": 1}])
        assert [f.result(timeout=10) for f in futs] == [6]


def test_map_length_mismatch_and_empty_args_raise():
    with DataFlowKernel(Cluster.homogeneous(2)) as dfk:
        with pytest.raises(ValueError, match="lengths differ"):
            dfk.map(combine, [1, 2, 3], kwargs_iter=[{"b": 1}])
        with pytest.raises(ValueError, match="arg_iter"):
            dfk.map(combine)


# --------------------------------------------------------------------- #
# shutdown resolves pending futures
# --------------------------------------------------------------------- #
def test_shutdown_cancels_pending_futures_with_runtime_error():
    dfk = DataFlowKernel(Cluster.homogeneous(1, workers_per_node=1))
    with dfk:
        futs = [napper(i, duration=1.0) for i in range(3)]
        time.sleep(0.3)
        # exit while one task runs and two sit queued: nothing may hang
    # the in-flight task finishes on its worker and delivers the result...
    assert futs[0].result(timeout=10) == 0
    # ...while queued tasks that will never run resolve with a clear error
    for f in futs[1:]:
        err = f.exception(timeout=1)   # resolved, not hung
        assert isinstance(err, RuntimeError)
        assert "shut down" in str(err)


def test_submit_after_shutdown_resolves_immediately_instead_of_hanging():
    """Regression: a post-shutdown submit used to increment _outstanding,
    schedule onto the stopped event loop, and return a future whose
    result() blocked forever."""
    dfk = DataFlowKernel(Cluster.homogeneous(1, workers_per_node=1))
    with dfk:
        assert dfk.submit(add_one, (1,), {}).result(timeout=10) == 2
        before = dict(dfk.stats)
    fut = dfk.submit(add_one, (1,), {})
    err = fut.exception(timeout=1)        # resolved, never hung
    assert isinstance(err, RuntimeError)
    assert "shut down" in str(err)
    # the dead engine's books are untouched: nothing outstanding, nothing
    # counted as submitted
    assert dfk.stats["submitted"] == before["submitted"]
    assert dfk._outstanding == 0
    # and wait_all still returns immediately
    assert dfk.wait_all(timeout=1)


def test_per_call_policy_is_bound_to_engine():
    """options(policy=ProactivePolicy()) must behave like the engine-level
    spelling: the sentinel binds and predictive fast-fail fires."""
    with DataFlowKernel(Cluster.homogeneous(2, memory_gb=8),
                        monitor=MonitoringDatabase()) as dfk:
        fut = hungry.options(policy=ProactivePolicy())(1)   # fits no node
        with pytest.raises(Exception):
            fut.result(timeout=10)
        assert dfk.stats["fast_fails"] == 1
        assert len(fut.record.attempts) == 0   # failed before any execution


# --------------------------------------------------------------------- #
# stack mechanics
# --------------------------------------------------------------------- #
def test_policy_stack_first_decisive_wins_and_review_runs():
    order = []

    class Abstains(ResiliencePolicy):
        def on_failure(self, rec, report, ctx):
            order.append("abstain")
            return None

    class Decides(ResiliencePolicy):
        def on_failure(self, rec, report, ctx):
            order.append("decide")
            return RetryDecision(Action.FAIL, reason="decisive")

    class Never(ResiliencePolicy):
        def on_failure(self, rec, report, ctx):  # pragma: no cover
            order.append("never")
            return RetryDecision(Action.RETRY, reason="unreachable")

    class Reviewer(ResiliencePolicy):
        def review_decision(self, rec, report, decision, ctx):
            order.append(f"review:{decision.reason}")
            return decision

    with DataFlowKernel(Cluster.homogeneous(2),
                        policy=[Abstains(), Decides(), Never(), Reviewer()]) as dfk:
        fut = fatal()
        with pytest.raises(ValueError):
            fut.result(timeout=10)
    assert order == ["abstain", "decide", "review:decisive"]


def test_baseline_fallback_when_no_policy_decides():
    with DataFlowKernel(Cluster.homogeneous(2), default_retries=2) as dfk:
        fut = fatal.options(max_retries=2)()
        with pytest.raises(ValueError):
            fut.result(timeout=10)
        assert len(fut.record.attempts) == 3   # baseline: 1 + 2 retries


def test_normalize_accepts_callables_and_stacks():
    stack = PolicyStack([wrath_retry_handler, PolicyStack([WrathPolicy()])])
    names = [type(p).__name__ for p in stack]
    assert names == ["RetryHandlerPolicy", "WrathPolicy"]


# ===== ported from tests/test_task_store.py =====
# task templates are module-level so every engine incarnation sees the
# same template names — the restart contract
CALLS: list = []


def _reset():
    CALLS.clear()


@task
def inc(x):
    CALLS.append(("inc", x))
    return x + 1


@task
def mul10(x):
    CALLS.append(("mul10", x))
    return x * 10


class _Rec:
    """Minimal record stand-in for hashing tests."""

    def __init__(self, name, args=(), kwargs=None, fn=None):
        self.name = name
        self.args = args
        self.kwargs = kwargs or {}
        self.fn = fn


# --------------------------------------------------------------------- #
# invocation hashing
# --------------------------------------------------------------------- #
def test_lineage_key_is_deterministic_and_arg_sensitive():
    assert lineage_key(_Rec("f", (1, "a"))) == lineage_key(_Rec("f", (1, "a")))
    assert lineage_key(_Rec("f", (1,))) != lineage_key(_Rec("f", (2,)))
    assert lineage_key(_Rec("f", (1,))) != lineage_key(_Rec("g", (1,)))
    # kwargs are order-insensitive; positional/keyword stay distinct
    assert (lineage_key(_Rec("f", (), {"a": 1, "b": 2}))
            == lineage_key(_Rec("f", (), {"b": 2, "a": 1})))
    assert lineage_key(_Rec("f", (1,))) != lineage_key(_Rec("f", (), {"x": 1}))


def test_lineage_key_is_not_confused_by_adjacent_value_boundaries():
    """Regression: without length-prefixing, adjacent variable-length
    elements could collide and alias two different invocations."""
    assert (lineage_key(_Rec("f", ("aS", "b")))
            != lineage_key(_Rec("f", ("a", "Sb"))))
    assert (lineage_key(_Rec("f", (b"aY", b"b")))
            != lineage_key(_Rec("f", (b"a", b"Yb"))))
    assert (lineage_key(_Rec("f", ("ab",)))
            != lineage_key(_Rec("f", ("a", "b"))))


def test_lineage_key_covers_the_function_implementation():
    """A persistent store must not serve results computed by an older
    implementation: changing the task's code changes its keys, and two
    different functions sharing a name never alias."""
    def v1(x):
        return x + 1

    def v2(x):
        return x + 2

    def v1_again(x):
        return x + 1

    assert (lineage_key(_Rec("f", (1,), fn=v1))
            != lineage_key(_Rec("f", (1,), fn=v2)))
    assert (lineage_key(_Rec("f", (1,), fn=v1))
            == lineage_key(_Rec("f", (1,), fn=v1_again)))


def test_hash_value_distinguishes_types_and_handles_arrays():
    import numpy as np

    assert hash_value(1) != hash_value(1.0)
    assert hash_value(True) != hash_value(1)
    assert hash_value("1") != hash_value(1)
    a = np.arange(4, dtype=np.int32)
    assert hash_value(a) == hash_value(np.arange(4, dtype=np.int32))
    assert hash_value(a) != hash_value(a.astype(np.int64))
    assert hash_value(a) != hash_value(a.reshape(2, 2))


# --------------------------------------------------------------------- #
# TaskStore core
# --------------------------------------------------------------------- #
K = {name: hash_value(name)                 # store keys are sha256 digests
     for name in ("k0", "parent", "child", "a", "b", "c", "d", "e")}


def test_store_commit_lookup_roundtrip_memory_and_disk(tmp_path):
    for store in (TaskStore(), TaskStore(tmp_path / "s")):
        assert store.lookup(K["k0"]) == (False, None)
        store.commit(K["k0"], {"v": [1, 2]}, task_name="f")
        assert K["k0"] in store and len(store) == 1
        assert store.lookup(K["k0"]) == (True, {"v": [1, 2]})
    with pytest.raises(ValueError, match="sha256"):
        store.commit("not-a-digest", 1)


def test_store_survives_reopen(tmp_path):
    TaskStore(tmp_path).commit(K["k0"], 42, task_name="f",
                               parents=[K["parent"]])
    reopened = TaskStore(tmp_path)
    assert reopened.lookup(K["k0"]) == (True, 42)
    assert reopened.entry(K["k0"])["parents"] == [K["parent"]]


def test_store_sweeps_interrupted_commits(tmp_path):
    store = TaskStore(tmp_path)
    store.commit(K["k0"], 1)
    # a crash between the value write and the meta write leaves an orphan
    (tmp_path / f"{K['a']}.pkl").write_bytes(pickle.dumps(99))
    (tmp_path / f".tmp-{K['b']}.pkl").write_bytes(b"junk")
    # ... and a meta without its value
    (tmp_path / f"{K['c']}.json").write_text(json.dumps({"value_hash": "x"}))
    reopened = TaskStore(tmp_path)
    assert reopened.keys() == [K["k0"]]
    assert not (tmp_path / f"{K['a']}.pkl").exists()
    assert not (tmp_path / f".tmp-{K['b']}.pkl").exists()
    assert not (tmp_path / f"{K['c']}.json").exists()


def test_open_never_touches_foreign_files(tmp_path):
    """The sweep is scoped to sha256-keyed names: a store pointed at a
    directory holding unrelated user files must not delete them."""
    (tmp_path / "analysis.json").write_text("{}")
    (tmp_path / "model.pkl").write_bytes(pickle.dumps({"w": 1}))
    (tmp_path / ".tmp-notes.txt").write_text("mine")
    store = TaskStore(tmp_path)
    store.commit(K["k0"], 7)
    reopened = TaskStore(tmp_path)
    assert reopened.lookup(K["k0"]) == (True, 7)
    assert (tmp_path / "analysis.json").exists()
    assert (tmp_path / "model.pkl").exists()
    assert (tmp_path / ".tmp-notes.txt").exists()


def test_store_corrupt_value_is_a_miss_and_rolls_back_descendants(tmp_path):
    store = TaskStore(tmp_path)
    store.commit(K["parent"], 1)
    store.commit(K["child"], 2, parents=[K["parent"]])
    (tmp_path / f"{K['parent']}.pkl").write_bytes(b"not a pickle")
    reopened = TaskStore(tmp_path)
    assert reopened.lookup(K["parent"]) == (False, None)
    assert K["child"] not in reopened     # stale child cannot outlive it


def test_invalidate_descendants_walks_the_lineage_dag():
    store = TaskStore()
    store.commit(K["a"], 1)
    store.commit(K["b"], 2, parents=[K["a"]])
    store.commit(K["c"], 3, parents=[K["b"]])
    store.commit(K["d"], 4, parents=[K["a"]])
    store.commit(K["e"], 5)               # unrelated lineage
    removed = store.invalidate(K["a"], descendants=True)
    assert sorted(removed) == sorted([K["a"], K["b"], K["c"], K["d"]])
    assert store.keys() == [K["e"]]


def test_converging_lineages_union_parent_links(tmp_path):
    """Re-committing the same value via a different parent must link the
    new parent edge, or rollback misses descendants."""
    store = TaskStore(tmp_path)
    store.commit(K["child"], 20, parents=[K["a"]])
    store.commit(K["child"], 20, parents=[K["b"]])
    assert store.entry(K["child"])["parents"] == sorted([K["a"], K["b"]])
    store.commit(K["b"], 2)
    assert K["child"] in store.invalidate(K["b"], descendants=True)
    # the merged links also survive a reopen
    store2 = TaskStore(tmp_path)
    store2.commit(K["child"], 20, parents=[K["a"]])
    store2.commit(K["child"], 20, parents=[K["b"]])
    assert TaskStore(tmp_path).entry(K["child"])["parents"] == \
        sorted([K["a"], K["b"]])


def test_as_checkpoint_policy_coercions(tmp_path):
    store = TaskStore()
    assert as_checkpoint_policy(store).store is store
    pol = CheckpointPolicy(store)
    assert as_checkpoint_policy(pol) is pol
    assert as_checkpoint_policy(True).store.directory is None
    assert as_checkpoint_policy(tmp_path / "d").store.directory == tmp_path / "d"
    with pytest.raises(TypeError, match="checkpoint="):
        as_checkpoint_policy(42)


# --------------------------------------------------------------------- #
# the copied store's one deliberate edit: torch tensors hash by value
# --------------------------------------------------------------------- #
def test_tensor_view_hashes_equal_to_its_clone():
    t = torch.arange(12, dtype=torch.float32)
    view = t[:4]                      # shares t's 12-element storage
    assert hash_value(view) == hash_value(view.clone())
    assert hash_value(t.reshape(3, 4)[:, 1]) == hash_value(torch.tensor([1., 5., 9.]))
    assert hash_value(t[:4]) != hash_value(t[1:5])
    # and so a task fed a view has the lineage key of one fed its clone
    assert (lineage_key(_Rec("f", (view,), {"w": view}))
            == lineage_key(_Rec("f", (view.clone(),), {"w": view.clone()})))


def test_tensor_hash_tells_dtype_and_shape_apart():
    t = torch.arange(4, dtype=torch.int32)
    assert hash_value(t) != hash_value(t.to(torch.int64))
    assert hash_value(t) != hash_value(t.reshape(2, 2))
    assert hash_value(t) != hash_value(t.numpy())   # a tensor is not an ndarray
    zeros = torch.zeros(4, dtype=torch.int32)       # same bytes as float32 zeros
    assert hash_value(zeros) != hash_value(zeros.to(torch.float32))
    assert hash_value(torch.tensor(3.0)) == hash_value(torch.tensor([3.0])[0])


def test_bf16_and_grad_tensors_hash():
    a = torch.randn(8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    assert hash_value(a) == hash_value(a.clone())
    assert hash_value(a) != hash_value(a.to(torch.float16))
    assert hash_value(a) != hash_value(a + 1)
    w = torch.ones(3, requires_grad=True)
    assert hash_value(w) == hash_value(torch.ones(3))


# --------------------------------------------------------------------- #
# the copies against the reference: the same inputs through both packages
# --------------------------------------------------------------------- #
def _unpicklable():               # pickle refuses a local function: repr branch
    return lambda: 0


HASH_CORPUS = [
    None, True, False, 0, 1, -7, 2 ** 80, 1.0, -0.0, 1e-300, float("inf"),
    float("nan"), "", "1", "ünïcode", b"", b"\x00\xff", [], (), [1, [2, (3, "a")]],
    (1,), ("aS", "b"), {1, "a", 2.5}, frozenset({b"x", None}), {},
    {"b": [1, 2], "a": {"c": None}}, {1: "x", "1": "y"}, range(5), 1 + 2j,
    np.arange(6, dtype=np.int32), np.arange(6, dtype=np.int64).reshape(2, 3),
    np.linspace(0.0, 1.0, 5), np.arange(12.0)[::2], np.zeros((0, 3), np.float32),
    np.array(True), np.float32(3.5), np.array(["ab", "c"]),
    {"w1": np.ones((2, 2), np.float32), "b1": np.zeros(2, np.float32)},
    [(0, 1.25), (3, -0.5)], _unpicklable(),
]


@pytest.mark.parametrize("value", HASH_CORPUS, ids=lambda v: type(v).__name__)
def test_hash_value_equals_reference(value):
    assert hash_value(value) == ref_task_store.hash_value(value)


def _fn_a(x):
    return x + 1


@pytest.mark.parametrize("i", range(0, len(HASH_CORPUS), 4))
def test_lineage_key_equals_reference(i):
    """The same name, implementation and resolved arguments give the same
    invocation key in both packages, so one store serves either."""
    args = tuple(HASH_CORPUS[i:i + 4])
    kwargs = {f"k{j}": v for j, v in enumerate(HASH_CORPUS[i + 4:i + 6])}
    for rec in (_Rec("f", args), _Rec("f", args, kwargs), _Rec("g", args, kwargs, _fn_a)):
        assert lineage_key(rec) == ref_task_store.lineage_key(rec)


def test_store_files_are_read_by_the_reference_and_back(tmp_path):
    """Each package's store reopens the other's directory: same keys,
    values, parent links and value hashes."""
    value = {"w": np.arange(4, dtype=np.float32), "n": 3}
    ref_task_store.TaskStore(tmp_path / "r").commit(K["a"], value, task_name="f")
    ref_task_store.TaskStore(tmp_path / "r").commit(K["b"], 2, parents=[K["a"]])
    TaskStore(tmp_path / "p").commit(K["a"], value, task_name="f")
    TaskStore(tmp_path / "p").commit(K["b"], 2, parents=[K["a"]])
    for d in ("r", "p"):
        ref, port = ref_task_store.TaskStore(tmp_path / d), TaskStore(tmp_path / d)
        assert port.keys() == ref.keys()
        assert sorted(port.keys()) == sorted([K["a"], K["b"]])
        for k in (K["a"], K["b"]):
            (hit_p, got_p), (hit_r, got_r) = port.lookup(k), ref.lookup(k)
            assert hit_p and hit_r and hash_value(got_p) == hash_value(got_r)
            assert {f: port.entry(k)[f] for f in ("parents", "value_hash")} == \
                {f: ref.entry(k)[f] for f in ("parents", "value_hash")}
        assert sorted(port.invalidate(K["a"], descendants=True)) == sorted([K["a"], K["b"]])


def _checkpointed_sum(api, directory):
    @api.task
    def square(x):
        return x * x

    @api.task
    def total(*xs):
        return sum(xs)

    with api.DataFlowKernel(api.Cluster.homogeneous(2),
                            checkpoint=api.TaskStore(directory)) as dfk:
        result = total(*[square(i) for i in range(4)]).result(timeout=30)
    return result, dfk.stats["memo_hits"], dfk.stats["submitted"]


@pytest.mark.parametrize("first,second", [(ref_api, port_api), (port_api, ref_api)],
                         ids=["reference_then_port", "port_then_reference"])
def test_engine_resumes_from_the_other_package_store(tmp_path, first, second):
    """An engine of one package replays a DAG the other checkpointed: every
    task is a memo hit, as in a rerun on one package."""
    assert _checkpointed_sum(first, tmp_path) == (14, 0, 5)
    assert _checkpointed_sum(second, tmp_path) == (14, 5, 5)


def _timeless(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k not in ("start_time", "wrath_overhead_s")}


def _no_ids(text: str) -> str:
    return re.sub(r"task-\d+", "task-N", text)   # the counter is per process


def _facade_outcomes(api) -> dict:
    """replay, a deferred replay handing over to WRATH, map with and
    without kwargs, nested workflow scopes, then a shutdown with work
    queued and a submit after it: every outcome and count."""
    @api.task(memory_gb=200)
    def hungry(x):
        return x * 2

    @api.task(max_retries=0)
    def fatal():
        raise ValueError("fatal task error")

    @api.task
    def combine(a, b=0, *, scale=1):
        return (a + b) * scale

    @api.task
    def napper(x, duration=1.0):
        time.sleep(duration)
        return x

    out: dict = {}
    wrath = api.WrathPolicy()
    with api.DataFlowKernel(api.Cluster.paper_testbed(small_nodes=2, big_nodes=1),
                            policy=[wrath], monitor=api.MonitoringDatabase(),
                            default_pool="small-mem", default_retries=2) as dfk:
        with dfk.workflow("outer", retries=2) as outer:
            with outer.workflow("inner") as inner:
                replayed = fatal.options(max_retries=9, policy=api.replay(3))()
                deferred = hungry.options(policy=api.replay(2, on_exhausted="defer"))(21)
            mapped = dfk.map(combine, [1, 2], kwargs_iter=[{"b": 10}, {"b": 20, "scale": 2}])
            mapped += dfk.map(combine, [(1, 2), (3, 4)])
        out["replay"] = (_no_ids(repr(replayed.exception(timeout=10))),
                         len(replayed.record.attempts))
        out["deferred"] = (deferred.result(timeout=30), deferred.record.retry_count,
                           dfk._assignment[deferred.record.task_id][0])
        out["map"] = [f.result(timeout=10) for f in mapped]
        outer.wait(timeout=10)
        out["scopes"] = (outer.stats(), inner.stats(), inner.path)
        out["decisions"] = [{k: v for k, v in d.items() if k != "task_id"}
                            for d in wrath.decisions]
        out["rates"] = dfk.success_rates()
    out["stats"] = _timeless(dfk.stats)

    dfk = api.DataFlowKernel(api.Cluster.homogeneous(1, workers_per_node=1))
    with dfk:
        queued = [napper(i, duration=0.5) for i in range(3)]
        time.sleep(0.2)
    out["shutdown"] = [queued[0].result(timeout=10)] + [
        _no_ids(repr(f.exception(timeout=1))) for f in queued[1:]]
    late = dfk.submit(napper, (9,), {"duration": 0.0})
    out["late"] = _no_ids(repr(late.exception(timeout=1)))
    out["shutdown_stats"] = (_timeless(dfk.stats), dfk._outstanding)
    return out


def test_facade_outcomes_equal_reference():
    want, got = _facade_outcomes(ref_api), _facade_outcomes(port_api)
    assert want["decisions"] and want["map"] == [11, 44, 3, 7]
    assert got == want


# ===== ported from tests/test_api.py: the tests on the sim plane =====
@task
def sim_napper(x, duration=1.0):
    return x                  # its nap is the scripted *virtual* duration


def _napper_durations(rec, node):
    """Sim duration script: a task naps its own ``duration=`` kwarg
    (virtually); templates without one fall through to their defaults."""
    return rec.kwargs.get("duration")


def test_nested_cancel_kills_descendants_not_siblings_propagate_none():
    """Satellite acceptance: with propagate="none", cancelling a sub-scope
    kills its queued + running descendants while sibling scopes finish."""
    with SimHarness(SimCluster.homogeneous(1, workers_per_node=2),
                    durations=_napper_durations) as h:
        with h.dfk.workflow("root") as root:
            with root.workflow("victim", propagate="none") as victim:
                # 2 workers: first two run, the rest queue behind them
                running = [sim_napper(i, duration=3.0) for i in range(2)]
                queued = [sim_napper(i, duration=0.1) for i in range(4)]
            with root.workflow("sibling") as sibling:
                safe = [sim_napper(i, duration=0.1) for i in range(2)]
        h.advance(0.3)         # let the first nappers reach RUNNING
        n = victim.cancel("test cancel")
        assert n == len(running) + len(queued)
        for f in running + queued:
            assert isinstance(f.exception(timeout=0), TaskCancelledError)
        # sibling scope is untouched and completes
        assert [h.result(f, timeout=20) for f in safe] == [0, 1]
        assert victim.cancelled and not sibling.cancelled
        assert sibling.stats()["completed"] == 2


def test_propagate_siblings_fast_fails_scope_subtree():
    with SimHarness(SimCluster.homogeneous(2),
                    durations=_napper_durations) as h:
        with h.dfk.workflow("root") as root:
            with root.workflow("doomed", propagate="siblings") as doomed:
                sibs = [sim_napper(i, duration=3.0) for i in range(3)]
                bad = fatal()
            safe = sim_napper(99, duration=0.1)
        with pytest.raises(ValueError):
            h.result(bad, timeout=10)
        # terminal failure of `bad` fast-fails its siblings...
        for f in sibs:
            assert isinstance(f.exception(timeout=0), TaskCancelledError)
        assert doomed.cancelled
        # ...but not the parent scope's other members
        assert h.result(safe, timeout=20) == 99
        assert not root.cancelled


def test_propagate_ancestors_fast_fails_whole_tree():
    with SimHarness(SimCluster.homogeneous(2),
                    durations=_napper_durations) as h:
        with h.dfk.workflow("root") as root:
            other = [sim_napper(i, duration=3.0) for i in range(2)]
            with root.workflow("stage", propagate="ancestors") as stage:
                bad = fatal()
        with pytest.raises(ValueError):
            h.result(bad, timeout=10)
        for f in other:        # the whole ancestor tree is cancelled
            assert isinstance(f.exception(timeout=0), TaskCancelledError)
        assert root.cancelled and stage.cancelled


def test_replicate_races_n_copies_on_distinct_nodes():
    from repro_torch.engine.cluster import current_node
    ran_on = set()

    with SimHarness(SimCluster.homogeneous(3, workers_per_node=1),
                    durations={"where": 0.4}) as h:
        @task
        def where():
            ran_on.add(current_node().name)
            return True

        fut = where.options(policy=replicate(3))()
        assert h.result(fut, timeout=10) is True
        assert h.dfk.stats["replicas"] == 2    # n - 1 racing copies
        h.advance(0.6)                         # let the losing replicas finish
    # placement diversity: original + copies all executed on distinct nodes
    assert len(ran_on) == 3, ran_on


def test_replicate_survives_original_terminal_failure():
    """A healthy replica's result must win over the original's error."""
    from repro_torch.engine.cluster import current_node

    with SimHarness(SimCluster.homogeneous(3, workers_per_node=1),
                    durations={"picky": 0.2}) as h:
        @task(max_retries=0)
        def picky():
            if current_node().name.endswith("n000"):
                raise ValueError("bad node")   # original lands here first
            return "ok"                        # replicas finish at +0.2s

        fut = picky.options(policy=replicate(3))()
        assert h.result(fut, timeout=10) == "ok"
        assert h.dfk.stats["retry_success"] == 0   # won by replica, not retry


def test_replicate_all_attempts_fail_resolves_with_error():
    with SimHarness(SimCluster.homogeneous(3, workers_per_node=1)) as h:
        @task(max_retries=0)
        def doomed():
            raise ValueError("every attempt fails")

        fut = doomed.options(policy=replicate(3))()
        h.run_until(fut.done, timeout=10)
        assert isinstance(fut.exception(timeout=0), ValueError)


def test_map_backpressure_releases_slot_when_submit_raises():
    """Regression: a submission failure after gate.acquire() leaked the
    backpressure slot, deadlocking the rest of the sweep at cap-1."""
    class ExplodesOnBind(ResiliencePolicy):
        def bind(self, dfk):
            raise RuntimeError("bind exploded")

    with SimHarness(SimCluster.homogeneous(1, workers_per_node=1),
                    durations=_napper_durations) as h:
        bad = add_one.options(policy=ExplodesOnBind())
        with pytest.raises(RuntimeError, match="bind exploded"):
            h.dfk.map(bad, [(i,) for i in range(4)], max_outstanding=1)
        # every acquired slot was released and no phantom outstanding task
        # remains: a full-width healthy sweep through the same cap runs dry
        futs = h.dfk.map(add_one, [(i,) for i in range(4)],
                         max_outstanding=1)
        assert [h.result(f) for f in futs] == [1, 2, 3, 4]
        assert h.dfk.wait_all(timeout=10)


def test_failed_submission_rolls_back_books_and_resolves_scope_future(monkeypatch):
    """A submission that dies after registering must neither strand
    wait_all (phantom outstanding) nor hang Workflow.wait() on a member
    future the engine disowned."""
    with SimHarness(SimCluster.homogeneous(1)) as h:
        with h.dfk.workflow("w") as wf:
            ok_fut = add_one(1)

            def boom(*a, **k):
                raise OSError("monitor down")

            monkeypatch.setattr(h.monitor, "record_task_event", boom)
            with pytest.raises(OSError, match="monitor down"):
                add_one(2)
            monkeypatch.undo()
        assert wf.wait(timeout=10)            # scope must not hang
        assert h.result(ok_fut) == 2
        dead = [f for f in wf.futures() if f.exception(timeout=0) is not None]
        assert len(dead) == 1
        assert "submission of task" in str(dead[0].exception(timeout=0))
        assert h.dfk.wait_all(timeout=10)
        assert h.dfk._outstanding == 0


# ===== ported from tests/test_task_store.py: the tests on the sim plane =====
def test_restarted_engine_resumes_from_completed_frontier():
    """The tentpole property: a fresh engine on the same store resolves
    previously-committed lineage without dispatching a single task."""
    store = TaskStore()
    _reset()
    with SimHarness(SimCluster.homogeneous(2), checkpoint=store) as h:
        out = mul10(inc(1))
        assert h.result(out) == 20
    assert CALLS == [("inc", 1), ("mul10", 2)]
    assert len(store) == 2

    _reset()
    with SimHarness(SimCluster.homogeneous(2), checkpoint=store) as h:
        out = mul10(inc(1))
        assert h.result(out) == 20
        assert h.dfk.stats["memo_hits"] == 2
        assert h.dfk.task_store is store
    assert CALLS == []                    # nothing re-executed


def test_memoization_misses_when_an_ancestor_arg_changes():
    store = TaskStore()
    _reset()
    with SimHarness(SimCluster.homogeneous(2), checkpoint=store) as h:
        assert h.result(mul10(inc(1))) == 20
    _reset()
    with SimHarness(SimCluster.homogeneous(2), checkpoint=store) as h:
        # changed root arg -> new lineage keys all the way down
        assert h.result(mul10(inc(2))) == 30
        assert h.dfk.stats["memo_hits"] == 0
    assert CALLS == [("inc", 2), ("mul10", 3)]


def test_explicit_rollback_invalidates_descendants_and_reexecutes():
    store = TaskStore()
    _reset()
    with SimHarness(SimCluster.homogeneous(2), checkpoint=store) as h:
        h.result(mul10(inc(1)))
    [parent_key] = [k for k in store.keys()
                    if store.entry(k)["task_name"] == "inc"]
    store.invalidate(parent_key, descendants=True)
    assert len(store) == 0
    _reset()
    with SimHarness(SimCluster.homogeneous(2), checkpoint=store) as h:
        assert h.result(mul10(inc(1))) == 20
        assert h.dfk.stats["memo_hits"] == 0
    assert CALLS == [("inc", 1), ("mul10", 2)]


def test_invalid_cached_result_triggers_dependency_aware_rollback():
    """A cached result that fails the stack's result validation is rolled
    back *with its descendants*, then the lineage re-executes fresh."""
    from repro_torch.api import replicate

    store = TaskStore()
    _reset()
    with SimHarness(SimCluster.homogeneous(2), checkpoint=store) as h:
        h.result(mul10(inc(1)))
    [parent_key] = [k for k in store.keys()
                    if store.entry(k)["task_name"] == "inc"]
    # poison the committed parent value (e.g. bit-rot in the store)
    store.commit(parent_key, -7, task_name="inc")

    _reset()
    validated = inc.options(policy=replicate(1, validate=lambda v: v >= 0))
    with SimHarness(SimCluster.homogeneous(2), checkpoint=store) as h:
        out = mul10(validated(1))
        assert h.result(out) == 20        # recomputed, not the poisoned -7
        assert h.dfk.stats["memo_hits"] == 0
    # both the parent and its dependent child re-executed
    assert CALLS == [("inc", 1), ("mul10", 2)]
    assert store.lookup(parent_key) == (True, 2)


def test_memo_hit_links_new_parent_lineage():
    """Converging DAGs end to end: a child that memo-hits via a different
    parent (same parent *value*, hence same child key) must gain the new
    parent edge so rolling back that parent also drops the child."""
    @task
    def const_two(x):
        CALLS.append(("const_two", x))
        return 2

    store = TaskStore()
    _reset()
    with SimHarness(SimCluster.homogeneous(2), checkpoint=store) as h:
        h.result(mul10(inc(1)))           # child key via inc's output (2)
    _reset()
    with SimHarness(SimCluster.homogeneous(2), checkpoint=store) as h:
        assert h.result(mul10(const_two(0))) == 20
        assert h.dfk.stats["memo_hits"] == 1      # the child short-circuits
    assert CALLS == [("const_two", 0)]
    [pb] = [k for k in store.keys()
            if store.entry(k)["task_name"] == "const_two"]
    [child] = [k for k in store.keys()
               if store.entry(k)["task_name"] == "mul10"]
    assert pb in store.entry(child)["parents"]
    assert child in store.invalidate(pb, descendants=True)


def test_workflow_scope_checkpoint_kwarg():
    store = TaskStore()
    _reset()
    with SimHarness(SimCluster.homogeneous(2)) as h:
        with h.dfk.workflow("stage", checkpoint=store):
            h.result(inc(5))
    assert len(store) == 1
    _reset()
    with SimHarness(SimCluster.homogeneous(2)) as h:
        with h.dfk.workflow("stage", checkpoint=store):
            fut = inc(5)
        assert h.result(fut) == 6
        assert h.dfk.stats["memo_hits"] == 1
        # unscoped submissions bypass the scope's store
        assert h.result(inc(7)) == 8
    assert CALLS == [("inc", 7)]


def test_failures_are_never_committed():
    @task(max_retries=0)
    def boom():
        CALLS.append(("boom",))
        raise ValueError("nope")

    store = TaskStore()
    _reset()
    for _ in range(2):
        with SimHarness(SimCluster.homogeneous(2), checkpoint=store) as h:
            fut = boom()
            h.run_until(fut.done)
            with pytest.raises(ValueError):
                fut.result(timeout=0)
    assert len(store) == 0
    assert CALLS == [("boom",), ("boom",)]  # re-executed after restart


def test_late_duplicate_delivery_cannot_overwrite_committed_winner():
    """Commits happen only for the attempt that won the task: a stale
    racing attempt delivering a different value after resolution must be
    discarded without touching the store."""
    store = TaskStore()
    _reset()
    with SimHarness(SimCluster.homogeneous(2), checkpoint=store) as h:
        fut = inc(1)
        assert h.result(fut) == 2
        rec = fut.record
        assert store.lookup(rec.lineage_key) == (True, 2)
        h.dfk._on_result(rec, -99, None, None)   # late loser delivery
        assert store.lookup(rec.lineage_key) == (True, 2)
        assert len(store) == 1


def test_memo_commit_only_policy_receives_commits():
    """A policy overriding only memo_commit (e.g. a commit auditor or a
    mirror store) must still be wired into the checkpoint fan-out."""
    seen = []

    class AuditCommits(ResiliencePolicy):
        def memo_commit(self, rec, result, ctx):
            seen.append((rec.name, result))

    _reset()
    with SimHarness(SimCluster.homogeneous(2),
                    policy=[AuditCommits()]) as h:
        assert h.result(inc(1)) == 2
    assert seen == [("inc", 2)]


def test_task_store_attr_resolves_past_non_store_checkpointers():
    """dfk.task_store must find the checkpoint= store even when another
    memo-hook policy precedes it in the stack."""
    class AuditCommits(ResiliencePolicy):
        def memo_commit(self, rec, result, ctx):
            pass

    store = TaskStore()
    with SimHarness(SimCluster.homogeneous(2),
                    policy=[AuditCommits()], checkpoint=store) as h:
        assert h.dfk.task_store is store


def test_memo_lookup_errors_degrade_to_execution():
    """A broken store must never wedge dispatch — the task just runs."""
    class BrokenStore(ResiliencePolicy):
        def memo_lookup(self, rec, ctx):
            raise OSError("store unreachable")

    _reset()
    with SimHarness(SimCluster.homogeneous(2),
                    policy=[BrokenStore()]) as h:
        assert h.result(inc(1)) == 2
    assert CALLS == [("inc", 1)]
