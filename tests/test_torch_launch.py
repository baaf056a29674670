"""The port's launch plane: the mesh builders and H100 constants
(``repro_torch.launch.mesh``, against ``repro.launch.mesh``) and the
launch-environment profiles (``repro_torch.launch.env_flags``, the
counterpart of ``repro.launch.xla_flags``)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

import repro.launch.mesh as jax_mesh
from repro_torch.launch import env_flags, mesh
from repro_torch.launch.env_flags import (FLAG_SETS, apply_env_flags, detect_platform,
                                          flag_env, merged_flags)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("n_lost", range(21))
def test_elastic_mesh_shape_matches_reference(n_lost, multi_pod, monkeypatch):
    """The shape the reference's make_elastic_mesh asks jax for equals the
    port's elastic_mesh_shape, axis names included."""
    asked = []
    monkeypatch.setattr(jax_mesh, "make_mesh", lambda shape, axes: asked.append((shape, axes)))
    jax_mesh.make_elastic_mesh(n_lost, multi_pod=multi_pod)
    (shape, axes), = asked
    assert mesh.elastic_mesh_shape(n_lost, multi_pod=multi_pod) == (tuple(shape), tuple(axes))


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(world: int):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod,world", [(False, 256), (True, 512)])
def test_production_and_elastic_meshes_build_under_a_fake_group(multi_pod, world, fake_group):
    fake_group(world)
    prod = mesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert mesh.mesh_chip_count(prod) == world
    assert prod.mesh_dim_names == (("pod", "data", "model") if multi_pod else ("data", "model"))
    assert tuple(prod.shape) == ((2, 16, 16) if multi_pod else (16, 16))
    elastic = mesh.make_elastic_mesh(0, multi_pod=multi_pod, device_type="cpu")
    assert tuple(elastic.shape) == tuple(prod.shape)


def test_elastic_mesh_after_losing_hosts_builds_at_its_size(fake_group):
    """Four hosts lost of 64: 240 chips left, so data 8 x model 16 over a
    128-rank group."""
    shape, axes = mesh.elastic_mesh_shape(4)
    assert (shape, axes) == ((8, 16), ("data", "model"))
    fake_group(128)
    m = mesh.make_elastic_mesh(4, device_type="cpu")
    assert tuple(m.shape) == (8, 16) and mesh.mesh_chip_count(m) == 128


def test_h100_constants():
    """The H100 SXM5 datasheet's dense peaks, not the TPU v5e's."""
    assert mesh.PEAK_FLOPS_BF16 == 989e12 and mesh.PEAK_FLOPS_F32 == 67e12
    assert mesh.HBM_BW == 3.35e12 and mesh.NVLINK_BW_PER_DIRECTION == 450e9
    assert mesh.PEAK_FLOPS_BF16 != jax_mesh.PEAK_FLOPS_BF16
    assert not hasattr(mesh, "ICI_BW_PER_LINK")


def test_mesh_module_import_starts_nothing():
    """Importing the mesh module starts no process group and no CUDA
    context: the builders are functions."""
    code = ("import sys, torch; sys.path.insert(0, 'src'); import repro_torch.launch.mesh; "
            "import torch.distributed as d; "
            "print(d.is_available() and d.is_initialized(), torch.cuda.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120, check=True).stdout.split()
    assert out == ["False", "False"]


# ------------------------------------------------------------ env flags ----
def test_flag_sets_shape():
    assert set(FLAG_SETS) == {"train", "serve", "dryrun"}
    for profile in FLAG_SETS.values():
        assert set(profile) == {"cuda", "cpu"}
        assert profile["cpu"] == {}
    # no variable has shown on the card that a launcher needs it
    assert all(FLAG_SETS[p]["cuda"] == {} for p in FLAG_SETS)
    assert flag_env("serve", platform="cuda") == {}
    assert flag_env("train", platform="cuda", extra={"NCCL_DEBUG": "WARN"}) == {
        "NCCL_DEBUG": "WARN"}
    with pytest.raises(ValueError, match="unknown launch-environment profile"):
        flag_env("bench", platform="cuda")


ALLOC = "PYTORCH_CUDA_ALLOC_CONF"


@pytest.mark.parametrize("existing,want", [
    ({}, "expandable_segments:True"),
    # a blank value counts as unset
    ({ALLOC: ""}, "expandable_segments:True"),
    ({ALLOC: "  "}, "expandable_segments:True"),
    # the user's value wins whole
    ({ALLOC: "expandable_segments:False"}, "expandable_segments:False"),
    ({ALLOC: "max_split_size_mb:128"}, "max_split_size_mb:128"),
])
def test_merge_keeps_the_users_value(existing, want):
    got = merged_flags("serve", existing, platform="cuda",
                       extra={ALLOC: "expandable_segments:True"})
    assert got == {ALLOC: want}


def test_merge_keeps_a_plain_variable_the_user_set():
    got = merged_flags("serve", {"NCCL_DEBUG": "WARN"}, platform="cuda",
                       extra={"NCCL_DEBUG": "INFO", "CUDA_MODULE_LOADING": "LAZY"})
    assert got["NCCL_DEBUG"] == "WARN" and got["CUDA_MODULE_LOADING"] == "LAZY"


def test_apply_sets_only_the_platforms_variables(monkeypatch):
    env = {ALLOC: "max_split_size_mb:64"}
    for profile in FLAG_SETS:
        for platform in ("cpu", "cuda"):
            assert apply_env_flags(profile, platform=platform, env=env) == {}
    assert env == {ALLOC: "max_split_size_mb:64"}
    # a profile's variable reaches the environment on its platform only
    monkeypatch.setitem(FLAG_SETS["serve"], "cuda", {"CUDA_MODULE_LOADING": "LAZY"})
    assert apply_env_flags("serve", platform="cpu", env=env) == {}
    assert apply_env_flags("serve", platform="cuda", env=env) == {"CUDA_MODULE_LOADING": "LAZY"}
    assert env == {ALLOC: "max_split_size_mb:64", "CUDA_MODULE_LOADING": "LAZY"}


@pytest.mark.parametrize("visible", ["", "-1", " "])
def test_detect_platform_hidden_cards_mean_cpu(visible):
    assert detect_platform({"CUDA_VISIBLE_DEVICES": visible}) == "cpu"


def test_detect_platform_never_initialises_cuda():
    """detect_platform and apply_env_flags decide without torch: the module
    imports no torch, and CUDA is not initialised after them."""
    code = """
import json, os, sys
sys.path.insert(0, "src")
from repro_torch.launch import env_flags
no_torch = "torch" not in sys.modules
platform = env_flags.detect_platform()
env_flags.apply_env_flags("train", env=dict(os.environ))
import torch
print(json.dumps([no_torch, platform, torch.cuda.is_initialized()]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120, check=True).stdout.strip().splitlines()[-1]
    no_torch, platform, initialised = json.loads(out)
    assert no_torch and platform in ("cuda", "cpu") and not initialised


@pytest.mark.parametrize("module,profile", [("train", "train"), ("serve", "serve")])
def test_launchers_apply_their_profile_first(module, profile, monkeypatch):
    """As the reference applies its XLA flags first, the port's launchers
    apply their launch-environment profile before parsing anything."""
    import importlib

    launcher = importlib.import_module(f"repro_torch.launch.{module}")
    seen = []

    class Applied(Exception):
        pass

    def record(name, **kw):
        seen.append(name)
        raise Applied

    monkeypatch.setattr(launcher, "apply_env_flags", record)
    monkeypatch.setattr(sys, "argv", [module, "--no-such-flag"])
    with pytest.raises(Applied):
        launcher.main()
    assert seen == [profile]
    assert env_flags.apply_env_flags is not record
