"""The port's checkpoint store: the cases of tests/test_checkpoint.py on
torch trees, and checkpoints crossing between the two packages in both
directions with equal tensors (bf16 leaves included)."""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.store as jax_store
import repro.models.model as JM
import repro_torch.checkpoint.store as store
from repro.configs import get_smoke_config as jax_smoke
from repro.models import spec as JS
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.models import materialize, param_defs
from repro_torch.models.spec import tree_leaves
from repro_torch.optim import OptConfig, init_opt_state


@pytest.fixture()
def tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b": torch.ones(4, dtype=torch.bfloat16) * 1.5},
        "opt": {"m": torch.zeros((3, 4), dtype=torch.bfloat16),
                "count": torch.tensor(7, dtype=torch.int32)},
    }


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_roundtrip_with_bf16(tmp_path, tree):
    save_checkpoint(tmp_path, 5, tree, metadata={"note": "x"})
    loaded, meta = load_checkpoint(tmp_path / "step_00000005", tree)
    assert meta["step"] == 5 and meta["note"] == "x"
    assert all(_equal(a, b) for a, b in zip(tree_leaves(tree), tree_leaves(loaded)))


def test_manifest_keys_and_dtypes_are_the_references(tmp_path, tree):
    d = save_checkpoint(tmp_path, 1, tree)
    leaves = json.loads((d / "manifest.json").read_text())["leaves"]
    assert [(x["key"], x["dtype"]) for x in leaves] == [
        ("opt/count", "int32"), ("opt/m", "bfloat16"),
        ("params/b", "bfloat16"), ("params/w", "float32")]
    assert (d / "COMMITTED").exists()


def test_uncommitted_checkpoint_ignored(tmp_path, tree):
    d = save_checkpoint(tmp_path, 1, tree)
    (d / "COMMITTED").unlink()
    mgr = CheckpointManager(tmp_path)
    assert mgr.steps() == []
    assert mgr.restore_latest(tree) is None
    with pytest.raises(FileNotFoundError, match="not committed"):
        load_checkpoint(d, tree)


def test_retention_keeps_last_k(tmp_path, tree):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.steps() == [3, 4]


def test_restore_latest_picks_newest(tmp_path, tree):
    mgr = CheckpointManager(tmp_path, keep=3)
    for s in (1, 5, 9):
        mgr.save(s, {**tree, "params": {"w": tree["params"]["w"] * s, "b": tree["params"]["b"]}})
    loaded, meta = mgr.restore_latest(tree)
    assert meta["step"] == 9
    assert torch.equal(loaded["params"]["w"], tree["params"]["w"] * 9)


def test_save_snapshots_before_the_tree_changes(tmp_path, tree):
    mgr = CheckpointManager(tmp_path, async_save=True)
    w = tree["params"]["w"]
    mgr.save(1, tree)
    w.add_(100)                        # the caller updates in place after saving
    loaded, _ = mgr.restore_latest(tree)
    assert torch.equal(loaded["params"]["w"], w - 100)


def test_async_save_completes(tmp_path, tree):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True)
    mgr.save(1, tree)
    mgr.wait()
    assert mgr.steps() == [1]


def test_async_save_error_surfaces_on_wait(tmp_path, tree, monkeypatch):
    """A failed async write must not die silently in the daemon thread."""
    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(store, "save_checkpoint", boom)
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True)
    mgr.save(1, tree)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                         # consumed once surfaced; the manager stays usable
    monkeypatch.undo()
    mgr.save(2, tree)
    mgr.wait()
    assert mgr.steps() == [2]


def test_async_save_error_surfaces_on_next_save(tmp_path, tree, monkeypatch):
    real = store.save_checkpoint
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient write failure")
        return real(*a, **k)

    monkeypatch.setattr(store, "save_checkpoint", flaky)
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True)
    mgr.save(1, tree)
    with pytest.raises(RuntimeError, match="transient write failure"):
        mgr.save(2, tree)              # the next save surfaces the earlier failure
    mgr.save(3, tree)
    mgr.wait()
    assert mgr.steps() == [3]


def test_stale_tmp_dirs_swept_on_init_and_retain(tmp_path, tree):
    stale = tmp_path / ".tmp_step_00000007"
    stale.mkdir()
    (stale / "shard_00000.npz").write_bytes(b"half-written")
    mgr = CheckpointManager(tmp_path, keep=2)
    assert not stale.exists()
    stale2 = tmp_path / ".tmp_step_00000008"
    stale2.mkdir()
    mgr.save(1, tree)
    assert not stale2.exists()
    assert mgr.steps() == [1]


def test_overwrite_same_step(tmp_path, tree):
    save_checkpoint(tmp_path, 3, tree)
    save_checkpoint(tmp_path, 3, {**tree, "params": {"w": tree["params"]["w"] + 1,
                                                     "b": tree["params"]["b"]}})
    loaded, _ = load_checkpoint(tmp_path / "step_00000003", tree)
    assert torch.equal(loaded["params"]["w"], tree["params"]["w"] + 1)


def test_large_tree_multi_shard(tmp_path):
    tree = {f"w{i}": torch.ones((256, 256)) * i for i in range(8)}
    save_checkpoint(tmp_path, 1, tree, shard_mb=1)   # force several shards
    assert len(list((tmp_path / "step_00000001").glob("shard_*.npz"))) > 1
    loaded, _ = load_checkpoint(tmp_path / "step_00000001", tree)
    assert all(torch.equal(loaded[k], tree[k]) for k in tree)


def test_load_places_leaves_on_the_device_asked(tmp_path, tree):
    save_checkpoint(tmp_path, 2, tree)
    loaded, _ = load_checkpoint(tmp_path / "step_00000002", tree, device="cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(loaded))


def _model_state(arch="granite_3_2b"):
    """A training-plane state of the reference's shape: bf16 params, fp32
    moments, an int32 count."""
    jc = jax_smoke(arch)
    jp = JS.materialize(JM.param_defs(jc), jax.random.PRNGKey(4))
    from repro.optim import OptConfig as JaxOptConfig
    from repro.optim import init_opt_state as jax_init_opt_state

    js = jax_init_opt_state(jp, JaxOptConfig())
    js = {**js, "m": jax.tree.map(lambda x: x + 0.25, js["m"]),
          "count": jnp.asarray(3, jnp.int32)}
    return {"params": jp, "opt": js}


def _torch_like(jtree):
    return params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jtree = _model_state()
    jax_store.save_checkpoint(tmp_path, 4, jtree, metadata={"who": "jax"})
    tc = get_smoke_config("granite_3_2b")
    params = materialize(param_defs(tc), 0, "cpu")
    like = {"params": params, "opt": init_opt_state(params, OptConfig())}
    loaded, meta = load_checkpoint(tmp_path / "step_00000004", like)
    assert meta == {"who": "jax", "step": 4}
    got, want = (dict(store._flatten(t)) for t in (loaded, _torch_like(jtree)))
    assert set(got) == set(want) and len(got) == len(jax.tree.leaves(jtree))
    assert "params/segments/0/0/attn/wq" in got and got["opt/count"].dtype == torch.int32
    assert any(t.dtype == torch.bfloat16 for t in got.values())
    assert all(_equal(got[k], want[k]) for k in want)


def test_port_checkpoint_restores_into_jax(tmp_path):
    jtree = _model_state()
    ttree = _torch_like(jtree)
    save_checkpoint(tmp_path, 6, ttree, metadata={"who": "torch"})
    loaded, meta = jax_store.load_checkpoint(tmp_path / "step_00000006", jtree)
    assert meta == {"who": "torch", "step": 6}
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      np.asarray(b.astype(jnp.float32)))
