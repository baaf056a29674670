"""The PyTorch port stands alone: no jax, nothing of the JAX package.

Every ``repro_torch`` module and ``chip_smoke.py`` import with jax
blocked and leave no ``repro.*`` module behind; the sources (and
the tools under ``tools/`` and the examples under ``examples/torch/``)
hold no jax or ``repro.`` import; entry points refuse to run on a
missing card.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                        REPO / "tools" / "flash_ab.py",
                                        REPO / "tools" / "ssd_rounding.py",
                                        REPO / "tools" / "decode_sensitivity.py",
                                        REPO / "tools" / "env_profile_ab.py",
                                        REPO / "tools" / "path_ab.py",
                                        REPO / "tools" / "dryrun_table.py",
                                        REPO / "tools" / "ptxas_table.py",
                                        REPO / "tools" / "ssd_host_ab.py",
                                        REPO / "tools" / "ssd_da_precision.py"]
# the port's examples: they import repro_torch alone
SOURCES += sorted((REPO / "examples" / "torch").glob("*.py"))
MODULES = sorted(
    ".".join(p.relative_to(PORT.parent).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))

BAD_IMPORT = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)(\.|\s)(?!_torch))",
    re.MULTILINE)


def test_distribution_slice_modules_are_guarded():
    """The modules of the distribution slice are among those imported with
    jax blocked, and their sources import nothing of jax or repro."""
    new = ("repro_torch.distributed.sharding", "repro_torch.launch.shapes",
           "repro_torch.launch.dryrun", "repro_torch.optim.compress")
    assert set(new) <= set(MODULES)
    for name in new:
        src = (PORT.parent / (name.replace(".", "/") + ".py")).read_text()
        assert not BAD_IMPORT.search(src), name


def test_every_port_module_imports_without_jax_or_repro():
    code = f"""
import importlib, importlib.util, json, sys
sys.modules["jax"] = None           # any `import jax` now raises ImportError
sys.path.insert(0, {str(REPO / "src")!r})
for name in {MODULES!r}:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {str(REPO / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted(m for m in sys.modules
                        if m == "repro" or m.startswith(("repro.", "jax")))))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == ["jax"]  # the None stub


@pytest.mark.parametrize("name", ["repro_torch.models.griffin",
                                  "repro_torch.configs.recurrentgemma_9b",
                                  "repro_torch.configs.gemma3_27b",
                                  "repro_torch.configs.llava_next_34b",
                                  "repro_torch.configs.deepseek_67b",
                                  "repro_torch.configs.deepseek_v3_671b",
                                  "repro_torch.engine.dfk",
                                  "repro_torch.api",
                                  "repro_torch.checkpoint.task_store",
                                  "repro_torch.injection.engines",
                                  "repro_torch.apps.fedlearn",
                                  "repro_torch.apps.moldesign",
                                  "repro_torch.sim",
                                  "repro_torch.sim.cluster",
                                  "repro_torch.sim.harness",
                                  "repro_torch.sim.serve",
                                  "repro_torch.sim.search",
                                  "repro_torch.sim.__main__",
                                  "repro_torch.analysis",
                                  "repro_torch.analysis.event_check",
                                  "repro_torch.analysis.__main__",
                                  "repro_torch.roofline",
                                  "repro_torch.roofline.analysis",
                                  "repro_torch.roofline.cost",
                                  "repro_torch.kernels.autotune",
                                  "repro_torch.kernels.flash_attention",
                                  "repro_torch.launch.mesh",
                                  "repro_torch.launch.env_flags"])
def test_guard_covers_the_newest_modules(name):
    """The RG-LRU block, the newest configs, the engine, the apps, the sim
    plane, the analysis plane, the roofline plane, the autotuner, the
    launch plane and the flash launcher (which launches the MLA kernel,
    csrc/flash_attention_fwd_ws.cu) are among the modules the guard
    imports with jax blocked, and among the sources it scans."""
    assert name in MODULES
    path = PORT.parent.joinpath(*name.split(".")).with_suffix(".py")
    if not path.exists():                       # a package: its __init__
        path = path.with_suffix("") / "__init__.py"
    assert path in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_has_no_jax_or_repro_import(path):
    assert not BAD_IMPORT.findall(path.read_text()), path


def test_import_pattern_catches_what_it_should():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "    from repro.models import x", "import repro.core", "from repro import api"):
        assert BAD_IMPORT.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.models import x",
               "    from repro_torch.engine.dfk import y", "import torch"):
        assert not BAD_IMPORT.search(ok), ok


def test_backend_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.configs import get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.serve import TorchDecodeBackend

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchDecodeBackend(get_smoke_config("granite_3_2b"), max_batch=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_torch_apps_refuse_missing_card():
    """The two apps that compute run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.apps import run_app
    from repro_torch.engine import Cluster

    for app in ("fedlearn", "moldesign"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_app(app, Cluster.homogeneous(2), scale="tiny", wait_timeout=30)
    assert run_app("fedlearn", Cluster.homogeneous(2), scale="tiny",
                   wait_timeout=30, device="cpu").success


def test_chip_smoke_fails_without_card_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    runs = [REPO / "chip_smoke.py"]
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs.append(tmp_path / "chip_smoke.py")
    for script in runs:
        proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                              text=True, timeout=120, cwd=script.parent)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
