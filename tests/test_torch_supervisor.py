"""The port's WRATH training supervisor on the CPU: the recovery paths of
tests/test_train_recovery.py at a smaller size, and the recovery
sequence against the JAX supervisor's for the same injected events."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as JM
from repro.configs import get_smoke_config as jax_smoke
from repro.models import spec as JS
from repro.optim import OptConfig as JaxOptConfig
from repro.train import TrainEvent as JaxTrainEvent
from repro.train import WrathTrainSupervisor as JaxSupervisor
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.optim import OptConfig
from repro_torch.train import TrainEvent, WrathTrainSupervisor


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size compute gains nothing from threads, and in a parallel
    test run every worker's default thread count oversubscribes the cores:
    a shard then takes longer than a straggler's 0.5 s sleep, which the
    straggler test must tell apart."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mk(tmp_path, tag, **kw):
    """Straggler speculation follows wall times, so a loaded machine could
    denylist a host in a test about something else: it is out of reach
    (straggler_factor 1e6) except where a test asks for it."""
    defaults = dict(n_hosts=3, global_batch=6, seq_len=32, straggler_factor=1e6,
                    ckpt_dir=str(tmp_path / tag), ckpt_every=5, device="cpu")
    defaults.update(kw)
    return WrathTrainSupervisor(get_smoke_config("granite_3_2b"),
                                OptConfig(lr=5e-3, warmup_steps=5, total_steps=40), **defaults)


def test_clean_run_converges(tmp_path):
    rep = mk(tmp_path, "clean").run(20)
    assert rep.steps_completed == 20
    assert rep.losses[-1] < rep.losses[0]
    assert not rep.recoveries and rep.recovered_all


def test_host_loss_elastic_remesh(tmp_path):
    rep = mk(tmp_path, "hostloss").run(
        15, events=[TrainEvent(step=5, kind="host_down", host="host01")])
    assert rep.final_hosts == 2          # re-meshed to the surviving hosts
    assert rep.steps_completed == 15
    assert rep.losses[-1] < rep.losses[0]


def test_nan_restores_checkpoint(tmp_path):
    rep = mk(tmp_path, "nan").run(16, events=[TrainEvent(step=12, kind="nan")])
    assert rep.restores == 1
    assert [r["error"] for r in rep.recoveries] == ["NumericalDivergenceError"]
    # steps 0-11, the restore to step 10's checkpoint, then steps 11-15
    assert rep.steps_completed == 12 + 5
    assert rep.losses[-1] < rep.losses[0]


def test_oom_shard_routed_to_big_host(tmp_path):
    rep = mk(tmp_path, "oom", host_memory_gb=0.5, shard_memory_gb=1.0).run(4)
    assert rep.steps_completed == 4
    assert any(r["error"] == "MemoryError" and r["action"] != "fail" for r in rep.recoveries)
    assert {r["host"] for r in rep.recoveries} <= {"host00", "host01", "host02"}


def test_straggler_speculation_and_denylist(tmp_path):
    """Speculation compares moving averages of per-sample shard times, so
    the straggler starts once the first steps' one-off costs have decayed
    (the reference's scenario runs 30 steps)."""
    rep = mk(tmp_path, "strag", straggler_factor=3.0).run(
        24, events=[TrainEvent(step=6, kind="straggler", host="host02", factor=50)])
    assert rep.speculations >= 1
    assert "host02" in rep.denylisted     # chronic straggler denylisted


def test_checkpoint_resume_continuity(tmp_path):
    rep1 = mk(tmp_path, "resume").run(12)
    rep2 = mk(tmp_path, "resume").run(16)   # resumes past step 10's checkpoint
    assert rep2.steps_completed <= 5
    assert rep2.losses[-1] <= rep1.losses[0]


def test_elastic_host_join_and_leave(tmp_path):
    sup = mk(tmp_path, "joinleave")
    rep = sup.run(12, events=[TrainEvent(step=3, kind="host_join", host="hostX"),
                              TrainEvent(step=8, kind="host_leave", host="host02")])
    assert rep.final_hosts == 3          # 3 seed hosts + the joiner - the leaver
    assert rep.steps_completed == 12 and not rep.recoveries
    events = [(e["event"], e["node"]) for e in sup.monitor.system_events
              if e["event"] in ("host_join", "host_leave")]
    assert events == [("host_join", "hostX"), ("host_leave", "host02")]


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WrathTrainSupervisor(get_smoke_config("granite_3_2b"), OptConfig(),
                             ckpt_dir=str(tmp_path / "ck"))


def test_recovery_sequence_matches_jax_supervisor(tmp_path):
    """The same host_down + nan events, the same bridged start weights,
    fp32 compute: equal (error, host, action, rung) sequences, restores
    and hosts.  Both run without profile-based shard sizing and without a
    scheduler, and with straggler speculation out of reach
    (straggler_factor 1e6), since those follow measured wall times."""
    jcfg = dataclasses.replace(jax_smoke("granite_3_2b"), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("granite_3_2b"), compute_dtype="float32")
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      JS.materialize(JM.param_defs(jcfg), jax.random.PRNGKey(0)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(n_hosts=3, global_batch=6, seq_len=16, ckpt_every=5,
              profile_shard_sizing=False, straggler_factor=1e6)
    opt = dict(lr=5e-3, warmup_steps=5, total_steps=40)
    jsup = JaxSupervisor(jcfg, JaxOptConfig(**opt), ckpt_dir=str(tmp_path / "jax"), **kw)
    jrep = jsup.run(14, events=[JaxTrainEvent(step=5, kind="host_down", host="host01"),
                                JaxTrainEvent(step=12, kind="nan")], start_params=jp)
    tsup = WrathTrainSupervisor(tcfg, OptConfig(**opt), ckpt_dir=str(tmp_path / "torch"),
                                device="cpu", **kw)
    trep = tsup.run(14, events=[TrainEvent(step=5, kind="host_down", host="host01"),
                                TrainEvent(step=12, kind="nan")], start_params=tp)

    def seq(rep):
        return [(r["step"], r["error"], r["host"], r["action"], r["rung"])
                for r in rep.recoveries]

    assert seq(trep) == seq(jrep) and seq(trep)
    assert (trep.restores, trep.final_hosts, trep.steps_completed, trep.denylisted) == \
        (jrep.restores, jrep.final_hosts, jrep.steps_completed, jrep.denylisted)
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=2e-3)
