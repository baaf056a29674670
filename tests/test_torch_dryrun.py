"""The port's shape presets (``repro_torch.launch.shapes``) against
``repro.launch.shapes``, and its meta-device dry-run
(``repro_torch.launch.dryrun``): per-device counting under a ``fake``
process group (the 1024³ product sharded 16 ways), the kernels' meta
branch (the kernel's shapes, credited at the shard's shapes), one cell in
process and the CLI in a subprocess."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

import repro.launch.shapes as JSh
from repro.configs import get_config as jax_config
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import shapes as TSh
from repro_torch.models.spec import tree_leaves

REPO = Path(__file__).resolve().parent.parent


def _paths(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _paths(tree[k], prefix + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree) for p, v in _paths(t, prefix + (i,)).items()}
    return {prefix: tree}


@pytest.mark.parametrize("shape", list(JSh.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_presets_match_the_reference(arch, shape):
    jc, tc = jax_config(arch), get_config(arch)
    assert TSh.SHAPES[shape].__dict__ == JSh.SHAPES[shape].__dict__
    assert TSh.shape_applicable(tc, shape) == JSh.shape_applicable(jc, shape)
    jb, tb = JSh.batch_specs(jc, shape), TSh.batch_specs(tc, shape)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tb.items()} \
        == {k: (tuple(v.shape), jnp.dtype(v.dtype).name) for k, v in jb.items()}
    assert all(v.device.type == "meta" for v in tb.values())
    assert TSh.batch_axes(tc, shape) == JSh.batch_axes(jc, shape)
    if JSh.SHAPES[shape].kind == "decode":
        jcache = {p: tuple(v.shape) for p, v in _paths(JSh.cache_specs(jc, shape)).items()}
        tcache = {p: tuple(v.shape) for p, v in _paths(TSh.cache_specs(tc, shape)).items()}
        assert tcache == jcache


def test_param_specs_are_meta_tensors():
    params = TSh.param_specs(get_config("granite_3_2b"))
    assert all(t.device.type == "meta" for t in tree_leaves(params))


@pytest.fixture
def mesh16():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    yield make_production_mesh(device_type="cpu")
    dist.destroy_process_group()


def _dt(mesh, shape, placements, dtype=torch.bfloat16):
    from repro_torch.distributed.sharding import _on_mesh, local_shape

    return _on_mesh(torch.empty(local_shape(shape, placements, mesh), dtype=dtype,
                                device="meta"), shape, placements, mesh)


def test_counts_are_per_device(mesh16):
    """A 1024³ product sharded 16 ways over ``model`` is 2·1024·1024·64 =
    1.342e8 FLOPs on each device, not the mesh's 2.147e9."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.roofline import count_step

    a = _dt(mesh16, (1024, 1024), [Replicate(), Shard(1)])
    b = _dt(mesh16, (1024, 1024), [Replicate(), Shard(0)])
    out, cost = count_step(lambda: (a @ b).redistribute(mesh16, [Replicate(), Replicate()]))
    assert cost.aten_flops == 2 * 1024 * 1024 * 64
    assert f"{cost.aten_flops:.3e}" == "1.342e+08"
    # the partial sum's all-reduce, at its per-device operand bytes (twice)
    assert cost.coll == {"all-reduce": 2 * 1024 * 1024 * 2}
    assert tuple(out.to_local().shape) == (1024, 1024)


def test_meta_kernels_credit_the_shard(mesh16):
    """On meta the wrappers return the kernels' shapes and the count credits
    the launch at each rank's shard: batch over data, heads over model, the
    8 kv heads expanded to q's 32 so that they shard with them."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels.ops import flash_attention, ssd_scan
    from repro_torch.roofline import count_step
    from repro_torch.roofline.cost import attention_bound, ssd_bound

    bh = [Shard(0), Shard(2)]
    q = _dt(mesh16, (32, 512, 32, 64), bh)
    kv = _dt(mesh16, (32, 512, 8, 64), [Shard(0), Replicate()])
    o, cost = count_step(flash_attention, q, kv, kv, causal=True)
    assert tuple(o.shape) == (32, 512, 32, 64) and o.placements == tuple(bh)
    assert cost.kernel_launches == {"flash_attention": 1}
    assert cost.kernel_flops["flash_attention"] == attention_bound(
        2, 512, 512, 2, 2, 64, 64, "torch.bfloat16", True, 0)[2]
    x = _dt(mesh16, (32, 256, 48, 64), bh)
    dt = _dt(mesh16, (32, 256, 48), bh)
    a = _dt(mesh16, (48,), [Replicate(), Replicate()], torch.float32)
    bc = _dt(mesh16, (32, 256, 128), [Shard(0), Replicate()])
    (y, state), cost = count_step(ssd_scan, x, dt, a, bc, bc, chunk=128)
    assert tuple(y.shape) == (32, 256, 48, 64) and tuple(state.shape) == (32, 48, 64, 128)
    assert tuple(state.to_local().shape) == (2, 3, 64, 128)
    assert cost.kernel_flops["ssd_scan"] == ssd_bound(
        2, 256, 3, 64, 128, 128, "torch.bfloat16", "torch.float32")[2]


def test_run_cell_in_process():
    """The reference CLI test's cell, in this process: ok, counted per
    device; the total is the arguments plus the step's peak."""
    from repro_torch.launch.dryrun import run_cell

    cell = run_cell("seamless_m4t_medium", "decode_32k", "single", save=False)
    assert cell.status == "ok", cell.error
    mem = cell.memory
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert mem["per_device_total"] == mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert cell.roofline["chips"] == 256 and cell.roofline["fits_hbm"]
    assert not dist.is_initialized()
    skipped = run_cell("granite-3-2b", "long_500k", "single", save=False)
    assert skipped.status == "skip" and "500k" in skipped.skip_reason


@pytest.mark.slow
def test_dryrun_single_cell_subprocess():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "seamless_m4t_medium", "--shape", "decode_32k", "--mesh", "single",
         "--no-save"],
        capture_output=True, text=True, timeout=500, env=env, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ok" in out.stdout
    assert "0 failed" in out.stdout


def test_microbatches_of_a_sharded_batch(mesh16):
    """A batch sharded over ``data`` splits into microbatches on each shard
    where the shard's rows divide, and otherwise is gathered, sliced and
    laid out as the context gives the microbatch's rows."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import ACT_RULES, activation_sharding
    from repro_torch.distributed.step import microbatch

    batch = _dt(mesh16, (64, 8), [Shard(0), Replicate()], torch.int32)   # 4 rows a shard
    with activation_sharding(mesh16, ACT_RULES):
        kept = microbatch(batch, 2, 1)
        regathered = microbatch(batch, 8, 3)
    assert tuple(kept.shape) == (32, 8) and kept.placements == (Shard(0), Replicate())
    assert tuple(kept.to_local().shape) == (2, 8)
    assert tuple(regathered.shape) == (8, 8)
    assert regathered.placements == (Replicate(), Replicate())    # 8 rows on 16 ranks


def test_peak_bytes_follow_storage_lifetimes():
    """The count's peak: what the step's ops allocated and still held at
    once.  A view of an argument allocates nothing; a temporary counts until
    it dies; a tensor saved for the backward counts while the graph holds it."""
    from repro_torch.roofline import count_step

    def step(x):
        a = x * 2                      # 4000 B
        b = a + 1                      # 8000 live
        del a                          # 4000
        c = b.repeat(3)                # 16000 live: the peak
        x.view(10, 100)                # nothing
        return c.sum()                 # 4 B more
    _, cost = count_step(step, torch.zeros(1000))
    assert cost.peak_bytes == 16004

    def saved(x):
        y = x.exp()                    # saved by exp's backward
        return (y * 3).sum(), None     # y, y * 3 and the sum live at once
    (z, _), cost = count_step(saved, torch.zeros(1000, device="meta", requires_grad=True))
    assert cost.peak_bytes == 8004 and z.requires_grad
