"""The port's examples (``examples/torch/*.py``) run on the CPU.

Each example's ``main`` runs in process at its smallest arguments with
``--device cpu``: the quickstart's DAG recovers onto the big-memory pool
and its baseline fails; the serving example completes every request
through its replica kill; the training example's loss falls through its
injected host loss, NaN and straggler, with a restore and the NaN's
recovery; the TaPS example runs fedlearn on
the device it is given.  Without ``--device`` the examples that compute
ask for the card and raise where there is none.  The examples import
nothing of jax or the JAX package (tests/test_torch_import_guard.py).
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parent.parent / "examples" / "torch"


def _example(name: str):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_are_the_four_of_the_reference():
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(
        p.stem for p in EXAMPLES.parent.glob("*.py"))


def test_quickstart_recovers_and_the_baseline_fails():
    out = _example("quickstart").main([])
    assert out["word"] == "programming"
    assert out["decisions"] >= 1 and out["baseline_error"] == "DependencyError"


def test_serving_completes_every_request_through_the_kill():
    out = _example("serving").main(["--device", "cpu", "--requests", "4", "--new-tokens", "4",
                                    "--replicas", "2"])
    assert out["device"] == "cpu"
    assert out["completed"] == out["static_completed"] == out["requests"] == 4
    assert out["failed"] == 0 and out["recoveries"] >= 1 and "replica0" in out["denylisted"]


def test_resilient_training_recovers_and_learns(tmp_path):
    out = _example("resilient_training").main([
        "--device", "cpu", "--steps", "30", "--d-model", "32", "--layers", "1", "--batch", "4",
        "--seq", "16", "--ckpt", str(tmp_path / "ckpt")])
    # steps replayed after the restore count too
    assert out["device"] == "cpu" and out["steps_completed"] >= 30
    assert out["last_loss"] < out["first_loss"]
    # the straggler's denylisting reads wall times, which a loaded host
    # blurs: not asserted
    assert out["restores"] >= 1 and "NumericalDivergenceError" in out["recoveries"]


def test_taps_workflows_runs_fedlearn_on_the_given_device():
    rows = _example("taps_workflows").main(["--device", "cpu", "--app", "fedlearn",
                                            "--scale", "tiny"])
    assert [(r["app"], r["mode"]) for r in rows] == [("fedlearn", "wrath"),
                                                     ("fedlearn", "baseline")]
    assert rows[0]["success"] and rows[0]["device"] == "cpu"


@pytest.mark.parametrize("name", ["serving", "resilient_training", "taps_workflows"])
def test_examples_default_to_the_card(name):
    """With no ``--device`` the examples that compute ask for the card:
    without one they raise before any work, rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    argv = ["--app", "fedlearn"] if name == "taps_workflows" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(argv)
