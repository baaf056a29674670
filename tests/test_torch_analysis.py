"""The port's static-analysis plane: fixtures detect, the port stays clean.

A port, against ``repro_torch``, of all of ``tests/test_analysis.py``,
bodies as the reference's with the imports rewritten: ``SRC`` is
``src/repro_torch`` and the CLI runs as ``python -m repro_torch.analysis``,
so its gates (``--strict``, ``--check-registry``) hold over the port with
the port's own baseline and registry.  Then both packages side by side:
the same event sets in the two registries, the same four waivers, and
the same findings over ``tests/analysis_fixtures/`` and over the port.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
import repro.analysis.event_registry as ref_registry
import repro_torch.analysis.event_registry as port_registry
from repro_torch.analysis import find_modules, run_checks
from repro_torch.analysis.clock_check import check_clock
from repro_torch.analysis.event_check import check_events, extract_registry, registry_drift
from repro_torch.analysis.findings import Baseline, Finding, split_baselined
from repro_torch.analysis.hook_check import check_hooks
from repro_torch.analysis.lock_check import check_locks

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src" / "repro_torch"
FIXTURES = Path(__file__).resolve().parent / "analysis_fixtures"
BASELINE = SRC / "analysis" / "analysis_baseline.json"
REF_BASELINE = REPO / "src" / "repro" / "analysis" / "analysis_baseline.json"


def _check(checker, fixture: str) -> list[Finding]:
    return checker(find_modules([FIXTURES / fixture]))


def _codes(findings: list[Finding]) -> list[tuple[str, int]]:
    return sorted((f.rule, f.line) for f in findings)


# --------------------------------------------------------------------- #
# fixture detection: exact rule codes at exact lines
# --------------------------------------------------------------------- #

def test_clock_fixture_detects_every_rule():
    assert _codes(_check(check_clock, "clock_bad.py")) == [
        ("CLK001", 13),   # _t.time()
        ("CLK002", 17),   # _t.sleep(0.5)
        ("CLK003", 21),   # datetime.now()
        ("CLK004", 25),   # random.random()
        ("CLK005", 30),   # default_factory=_t.time
    ]


def test_clock_parity_fixture_is_clean():
    assert _check(check_clock, "clock_good.py") == []


def test_lock_fixture_detects_every_rule():
    assert _codes(_check(check_locks, "lock_bad.py")) == [
        ("LCK001", 18),   # fut.set_result under _lock
        ("LCK001", 32),   # on_failure reachable via _notify
        ("LCK002", 22),   # fut.result under _lock
        ("LCK002", 23),   # time.sleep under _lock
        ("LCK003", 27),   # _queue_mutex under _lock
        ("LCK003", 45),   # a -> b
        ("LCK003", 50),   # b -> a
        ("LCK004", 45),   # the a/b ordering cycle
    ]


def test_lock_fixture_transitive_path_is_named():
    findings = _check(check_locks, "lock_bad.py")
    indirect = [f for f in findings if f.line == 32]
    assert len(indirect) == 1
    assert "via Engine._notify" in indirect[0].message


def test_lock_parity_fixture_is_clean():
    # condition-over-lock aliasing and Condition.wait are both exempt
    assert _check(check_locks, "lock_good.py") == []


def test_event_fixture_detects_every_rule():
    assert _codes(_check(check_events, "events_bad.py")) == [
        ("EVT001", 9),    # "submited" typo
        ("EVT001", 10),   # unregistered system event
        ("EVT001", 11),   # gauge typo
        ("EVT002", 12),   # unregistered f-string family
        ("EVT002", 14),   # dynamic name
    ]


def test_event_parity_fixture_is_clean():
    # literals, a registered prefix family, and an if-else of literals
    assert _check(check_events, "events_good.py") == []


def test_hook_fixture_detects_every_rule():
    assert _codes(_check(check_hooks, "hooks_bad.py")) == [
        ("HOK001", 19),   # p.on_failure with no degrade path
        ("HOK002", 15),   # raising hook override
    ]


def test_hook_parity_fixture_is_clean():
    # stack receiver and try/except both count as degrade paths
    assert _check(check_hooks, "hooks_good.py") == []


# --------------------------------------------------------------------- #
# the repo contract: strict-clean, live baseline, registry in sync
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def repo_findings():
    return run_checks(find_modules([SRC]))


def test_repo_is_strict_clean(repo_findings):
    baseline = Baseline.load(BASELINE)
    active, waived = split_baselined(repo_findings, baseline)
    assert active == [], "non-baselined findings:\n" + "\n".join(
        f.render() for f in active)
    assert baseline.unused() == [], "stale baseline waivers"
    assert waived, "the baseline should be waiving the intentional violations"


def test_baseline_entries_all_have_justifications():
    data = json.loads(BASELINE.read_text())
    assert data["waivers"], "baseline exists and is non-trivial"
    for e in data["waivers"]:
        assert e["justification"].strip(), e


def test_event_registry_matches_code():
    assert registry_drift(find_modules([SRC])) == []


def test_event_registry_covers_known_core_events():
    extracted = extract_registry(find_modules([SRC]))
    # spot-check load-bearing names the chaos coverage keys off
    assert {"finished", "error", "submitted"} <= extracted["task"]
    assert {"denylist_add", "heartbeat_lost", "node_drain"} <= extracted["system"]
    assert "serve.queue_depth" in extracted["gauge"]


def test_stale_waiver_detected():
    baseline = Baseline([{"rule": "CLK001", "file": "nope.py",
                          "symbol": "ghost", "justification": "x"}])
    active, waived = split_baselined([], baseline)
    assert active == [] and waived == []
    assert len(baseline.unused()) == 1


def test_baseline_match_ignores_line_churn():
    baseline = Baseline([{"rule": "CLK001", "file": "a.py",
                          "symbol": "f", "justification": "x"}])
    f1 = Finding(rule="CLK001", file="a.py", line=10, col=0, symbol="f",
                 message="m")
    f2 = Finding(rule="CLK001", file="a.py", line=99, col=4, symbol="f",
                 message="m")
    assert baseline.match(f1) and baseline.match(f2)


def test_finding_render_is_ruff_style():
    f = Finding(rule="CLK001", file="engine/dfk.py", line=12, col=4,
                symbol="DataFlowKernel.submit", message="raw time.time() call",
                hint="use clock.time()")
    out = f.render()
    assert out.startswith("engine/dfk.py:12:4 CLK001 [DataFlowKernel.submit]")
    assert "fix: use clock.time()" in out


# --------------------------------------------------------------------- #
# the CLI: what CI actually runs
# --------------------------------------------------------------------- #

def _run_cli(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})


def test_cli_strict_passes_on_repo():
    proc = _run_cli("--strict")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_check_registry_passes_on_repo():
    proc = _run_cli("--check-registry")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_strict_fails_on_bad_fixture():
    proc = _run_cli("--strict", "--no-baseline",
                    str(FIXTURES / "clock_bad.py"))
    assert proc.returncode == 1
    assert "CLK001" in proc.stdout


# --------------------------------------------------------------------- #
# both packages side by side
# --------------------------------------------------------------------- #

def test_registry_event_sets_equal_reference():
    """The port emits exactly the reference's monitor events and gauges."""
    for name in ("TASK_EVENTS", "SYSTEM_EVENTS", "GAUGES"):
        assert getattr(port_registry, name) == getattr(ref_registry, name), name


def test_baseline_holds_the_reference_waivers_and_no_other():
    port = json.loads(BASELINE.read_text())["waivers"]
    ref = json.loads(REF_BASELINE.read_text())["waivers"]
    assert len(port) == 4
    assert port == ref


def _rows(findings) -> list[dict]:
    """Findings as dicts, in the reference's words: a hint names the CLI
    to run (``python -m repro_torch.analysis``), the one substring that
    the port's copy rewrote."""
    rows = [{**dataclasses.asdict(f), "hint": f.hint.replace("repro_torch.", "repro.")}
            for f in findings]
    return sorted(rows, key=lambda d: (d["file"], d["line"], d["col"], d["rule"]))


@pytest.mark.parametrize("fixture", sorted(p.name for p in FIXTURES.glob("*.py")))
def test_fixture_findings_equal_reference(fixture):
    got = run_checks(find_modules([FIXTURES / fixture]))
    want = ref_analysis.run_checks(ref_analysis.find_modules([FIXTURES / fixture]))
    assert _rows(got) == _rows(want)


def test_reference_analyzer_finds_the_same_over_the_port(repo_findings):
    """The reference's checkers over ``src/repro_torch`` find what the
    port's find: the four waived findings, no other."""
    want = ref_analysis.run_checks(ref_analysis.find_modules([SRC]))
    assert _rows(repo_findings) == _rows(want)
    assert sorted((f.rule, f.file, f.symbol) for f in repo_findings) == sorted(
        (e["rule"], e["file"], e["symbol"])
        for e in json.loads(BASELINE.read_text())["waivers"])
