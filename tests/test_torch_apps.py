"""The port's TaPS apps held to the JAX package's.

The two apps that compute (fedlearn's MLP, moldesign's eigenvalue and
ridge surrogate) are torch in the port: their tasks go through both
packages on the same numpy inputs, on the CPU.  Whole ``run_app`` runs of
both packages under the same ``FailureInjector`` seeds must inject the
same tasks and end the same way.  The rest ports ``tests/test_apps.py``
with ``device="cpu"`` for the two torch apps (moldesign at ``"tiny"``
scale, to keep the file light under parallel workers).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import repro.apps as ref_apps
import repro_torch.apps as port_apps
from repro.apps import fedlearn as ref_fed
from repro.apps import moldesign as ref_mol
from repro.core import MonitoringDatabase as RefMonitoringDatabase
from repro.engine import Cluster as RefCluster
from repro.engine.policies import WrathPolicy as RefWrathPolicy
from repro.injection import FailureInjector as RefFailureInjector
from repro_torch.apps import APPS, cholesky, run_app
from repro_torch.apps import fedlearn, moldesign
from repro_torch.core import MonitoringDatabase, wrath_retry_handler
from repro_torch.engine import Cluster, DataFlowKernel
from repro_torch.engine.policies import WrathPolicy
from repro_torch.injection import FailureInjector, NoInjector

# ``run_app`` keeping the app's futures: the helper chip_smoke.py's
# wrath_apps phase drives, imported from the script at the repo's root
_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)
run_app_kept = chip_smoke.run_app_kept

TORCH_APPS = ("fedlearn", "moldesign")
FP32_TOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)


def _cpu(app: str) -> dict:
    return {"device": "cpu"} if app in TORCH_APPS else {}


# --------------------------------------------------------------------- #
# the torch tasks against the jax ones, on the same numpy inputs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("client,n,epochs", [(0, 64, 1), (3, 128, 3)])
def test_client_update_matches_reference(client, n, epochs):
    params = fedlearn.init_params(seed=client + 1)
    want = ref_fed.client_update.fn(params, client, n, epochs)
    got = fedlearn.client_update.fn(params, client, n, epochs, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=FP32_TOL, atol=FP32_TOL)
    # the reference's evaluate on the trained weights, through both packages
    assert fedlearn.evaluate.fn(got, device="cpu") == pytest.approx(
        ref_fed.evaluate.fn(want), rel=FP32_TOL)


def test_evaluate_matches_reference():
    params = fedlearn.init_params(seed=5)
    got = fedlearn.evaluate.fn(params, n=200, device="cpu")
    assert isinstance(got, float)
    assert got == pytest.approx(ref_fed.evaluate.fn(params, n=200), rel=FP32_TOL)


def _simulate_both(mol_id: int, seed: int):
    """Each package's simulate from a fresh attempt counter: the same
    Random Seed Error draw, or the same energy."""
    out = []
    for mod, kw in ((ref_mol, {}), (moldesign, {"device": "cpu"})):
        mod._ATTEMPTS.clear()
        try:
            out.append(mod.simulate.fn(mol_id, seed, **kw))
        except Exception as e:  # noqa: BLE001 - the seed error is compared
            out.append(type(e).__name__)
    return out


def test_simulate_matches_reference():
    outcomes = [_simulate_both(m, seed) for m in range(12) for seed in (0, 3)]
    errors = [w for w, _ in outcomes if isinstance(w, str)]
    assert errors and set(errors) == {"RandomSeedError"}   # the draw is shared
    for want, got in outcomes:
        if isinstance(want, str):
            assert got == want
        else:
            assert got[0] == want[0]
            assert got[1] == pytest.approx(want[1], rel=FP32_TOL)


def test_train_surrogate_and_inference_match_reference():
    results = [(m, float(m) + 0.25 * m * m) for m in (0, 1, 2, 3)]
    want = ref_mol.train_surrogate.fn(results)
    got = moldesign.train_surrogate.fn(results, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    # 4 rows of 16 features and lambda 1e-3: the ridge system's condition
    # number (near 1.6e4 here) times fp32's epsilon bounds the difference
    x = np.stack([moldesign._molecule_features(m) for m, _ in results]).astype(np.float32)
    cond = np.linalg.cond(x.T.astype(np.float64) @ x + 1e-3 * np.eye(x.shape[1]))
    tol = cond * EPS32
    assert 1e3 < cond < 1e5
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= tol
    # inference on one surrogate: the same predictions and the same ranking
    cands = list(range(4, 20))
    p_ref = ref_mol.inference.fn(want, cands)
    p_port = moldesign.inference.fn(want, cands, device="cpu")
    assert [m for m, _ in p_port] == cands
    np.testing.assert_allclose([p for _, p in p_port], [p for _, p in p_ref],
                               rtol=FP32_TOL, atol=FP32_TOL)
    rank = lambda preds: [m for m, _ in sorted(preds, key=lambda t: -t[1])]  # noqa: E731
    assert rank(p_port) == rank(p_ref)


# --------------------------------------------------------------------- #
# whole runs of both packages under the same injector seeds
# --------------------------------------------------------------------- #
def _setting(pkg_cluster, failure: str):
    if failure == "import":
        return (pkg_cluster.paper_testbed(small_nodes=3, big_nodes=1,
                                          with_pkg_pool=True, package="wrathpkg"),
                "no-pkg")
    if failure == "zero_division":
        return pkg_cluster.homogeneous(4), None
    return pkg_cluster.paper_testbed(small_nodes=3, big_nodes=1), "small-mem"


@pytest.mark.parametrize("app,failure,mode,seed", [
    ("mapreduce", "memory", "wrath", 1), ("mapreduce", "memory", "baseline", 1),
    ("mapreduce", "import", "wrath", 3), ("mapreduce", "zero_division", "wrath", 5),
    ("mapreduce", "zero_division", "baseline", 5),
    ("fedlearn", "memory", "wrath", 0), ("fedlearn", "zero_division", "wrath", 3),
    ("moldesign", "memory", "wrath", 0), ("cholesky", "memory", "wrath", 1),
    ("docking", "import", "wrath", 4)])
def test_run_app_matches_reference(app, failure, mode, seed):
    runs = []
    for apps_pkg, cluster_cls, inj_cls, policy_cls, mon_cls, extra in (
            (ref_apps, RefCluster, RefFailureInjector, RefWrathPolicy,
             RefMonitoringDatabase, {}),
            (port_apps, Cluster, FailureInjector, WrathPolicy, MonitoringDatabase,
             _cpu(app))):
        ref_mol._ATTEMPTS.clear()
        moldesign._ATTEMPTS.clear()
        inj = inj_cls(failure, rate=0.4, seed=seed, app_tag=f"parity:{app}")
        cluster, pool = _setting(cluster_cls, failure)
        res, kept = run_app_kept(apps_pkg, app, cluster, injector=inj,
                         policy=[policy_cls()] if mode == "wrath" else [],
                         monitor=mon_cls(), scale="tiny", default_pool=pool,
                         default_retries=2, wait_timeout=60, **extra)
        runs.append((inj, res, kept))
    (inj_r, ref, kept_r), (inj_p, port, kept_p) = runs
    assert inj_p.injected == inj_r.injected and inj_p.count > 0
    assert (port.success, port.error) == (ref.success, ref.error)
    for key in ("submitted", "completed", "failed", "dep_failed", "retries"):
        assert port.stats[key] == ref.stats[key], key
    # the run's workflow scope is the app's own, with the same subtree stats
    assert port.extra["workflow"]["workflow"] == app
    assert port.extra["workflow"] == ref.extra["workflow"]
    if failure == "zero_division":
        assert not port.success
        assert (port.stats["retries"] == 0) == (mode == "wrath")
    if app == "fedlearn" and port.success:
        want, got = kept_r[-1].result(timeout=0), kept_p[-1].result(timeout=0)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=FP32_TOL, atol=FP32_TOL)


def test_fedlearn_run_equals_clean_run_under_memory_injection():
    """Resilience moves tasks, not results: a WRATH run with memory
    failures re-placed onto big-mem ends with the clean run's weights."""
    outs = []
    for inj in (NoInjector(), FailureInjector("memory", rate=0.3, seed=0, app_tag="fl")):
        res, kept = run_app_kept(port_apps, "fedlearn",
                         Cluster.paper_testbed(small_nodes=3, big_nodes=1),
                         injector=inj, policy=[WrathPolicy()], scale="tiny",
                         default_pool="small-mem", wait_timeout=60, device="cpu")
        assert res.success, res.error
        outs.append(kept[-1].result(timeout=0))
    assert inj.count > 0
    for k in outs[0]:
        np.testing.assert_array_equal(outs[1][k], outs[0][k])


# --------------------------------------------------------------------- #
# tests/test_apps.py, ported
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("app", sorted(APPS))
def test_apps_run_clean(app):
    r = run_app(app, Cluster.homogeneous(4), monitor=MonitoringDatabase(),
                retry_handler=wrath_retry_handler(), scale="tiny",
                default_retries=4, wait_timeout=60, **_cpu(app))
    assert r.success, r.error
    assert r.task_success_rate == 1.0
    assert r.overhead_ratio < 0.5


def test_cholesky_numerically_correct():
    assert cholesky.verify(n=256, nb=4) < 1e-8


def test_cholesky_dag_result_matches_numpy():
    a = cholesky.make_spd(4 * 32, seed=3)
    ref = np.linalg.cholesky(a)
    with DataFlowKernel(Cluster.homogeneous(2)):
        futs = APPS["cholesky"](injector=NoInjector(), scale="tiny", seed=3)
        tiles = [f.result(timeout=60) for f in futs]
    bs = 32
    diag = [t for t in tiles if t.shape == (bs, bs)]
    assert np.allclose(diag[0], ref[:bs, :bs], atol=1e-8)


def test_fedlearn_learns():
    with DataFlowKernel(Cluster.homogeneous(2)):
        futs = APPS["fedlearn"](injector=NoInjector(), scale="small", device="cpu")
        losses = [f.result(timeout=120) for f in futs if not isinstance(f, dict)]
    numeric = [x for x in losses if isinstance(x, float)]
    assert len(numeric) >= 2
    assert numeric[-1] < numeric[0]  # loss decreased across rounds


def test_injector_deterministic():
    a = FailureInjector("memory", rate=0.3, seed=7, app_tag="x")
    b = FailureInjector("memory", rate=0.3, seed=7, app_tag="x")
    sel_a = [a._selected(i) for i in range(100)]
    sel_b = [b._selected(i) for i in range(100)]
    assert sel_a == sel_b
    assert 10 < sum(sel_a) < 50  # ~30 of 100
    ref = RefFailureInjector("memory", rate=0.3, seed=7, app_tag="x")
    assert sel_a == [ref._selected(i) for i in range(100)]


def test_injector_rate_zero_and_unknown_type():
    inj = FailureInjector("memory", rate=0.0)
    from repro_torch.apps.mapreduce import map_count
    assert inj.maybe(map_count, 3) is map_count
    with pytest.raises(ValueError):
        FailureInjector("not_a_type")


def test_spec_modification_injection_is_resolvable():
    """Table IV scenario: WRATH recovers memory-injected MapReduce."""
    inj = FailureInjector("memory", rate=0.4, seed=1, app_tag="t4")
    r = run_app("mapreduce", Cluster.paper_testbed(small_nodes=3, big_nodes=1),
                monitor=MonitoringDatabase(), retry_handler=wrath_retry_handler(),
                injector=inj, scale="tiny", default_pool="small-mem",
                default_retries=2, wait_timeout=60)
    assert r.injected > 0
    assert r.success
    assert r.retry_success_rate > 0.4


def test_spec_modification_injection_baseline_fails():
    inj = FailureInjector("memory", rate=0.4, seed=1, app_tag="t4")
    r = run_app("mapreduce", Cluster.paper_testbed(small_nodes=3, big_nodes=1),
                monitor=MonitoringDatabase(), injector=inj, scale="tiny",
                default_pool="small-mem", default_retries=2, wait_timeout=60)
    assert not r.success  # baseline retries in place and keeps OOMing


def test_fn_replacement_injection_fails_fast_with_wrath():
    inj_w = FailureInjector("zero_division", rate=0.3, seed=5, app_tag="ttf")
    rw = run_app("mapreduce", Cluster.homogeneous(4),
                 monitor=MonitoringDatabase(), retry_handler=wrath_retry_handler(),
                 injector=inj_w, scale="tiny", default_retries=2, wait_timeout=60)
    inj_b = FailureInjector("zero_division", rate=0.3, seed=5, app_tag="ttf")
    rb = run_app("mapreduce", Cluster.homogeneous(4),
                 monitor=MonitoringDatabase(), injector=inj_b, scale="tiny",
                 default_retries=2, wait_timeout=60)
    assert not rw.success and not rb.success
    # WRATH performs zero retries on destined-to-fail user errors
    assert rw.stats["retries"] == 0
    assert rb.stats["retries"] > 0


def test_moldesign_random_seed_errors_recovered():
    r = run_app("moldesign", Cluster.homogeneous(4), monitor=MonitoringDatabase(),
                retry_handler=wrath_retry_handler(), scale="tiny",
                default_retries=6, wait_timeout=120, device="cpu")
    assert r.success, r.error
