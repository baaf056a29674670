"""CLI for the contract-enforcing static-analysis suite.

Usage::

    python -m repro_torch.analysis [paths...]      # report all findings
    python -m repro_torch.analysis --strict        # exit 1 on non-baselined
    python -m repro_torch.analysis --update-registry
    python -m repro_torch.analysis --check-registry

With no paths, scans the ``repro_torch`` package this module was imported
from.  Baseline waivers live next to this package in
``analysis_baseline.json`` (override with ``--baseline``).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import find_modules, run_checks
from repro_torch.analysis.event_check import (
    extract_registry,
    registry_drift,
    registry_path,
    render_registry,
)
from repro_torch.analysis.findings import Baseline, split_baselined

_PKG_ROOT = Path(__file__).resolve().parent.parent  # .../src/repro_torch
_DEFAULT_BASELINE = Path(__file__).resolve().parent / "analysis_baseline.json"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="contract-enforcing static analysis (clock/lock/event/hook)")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="package roots or files to scan (default: the "
                         "installed repro_torch package)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any non-baselined finding")
    ap.add_argument("--baseline", type=Path, default=_DEFAULT_BASELINE,
                    help="waiver file (default: %(default)s)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (report everything as active)")
    ap.add_argument("--update-registry", action="store_true",
                    help="regenerate event_registry.py from the scanned code")
    ap.add_argument("--check-registry", action="store_true",
                    help="exit 1 if event_registry.py drifted from the code")
    args = ap.parse_args(argv)

    roots = args.paths or [_PKG_ROOT]
    modules = find_modules(roots)
    if not modules:
        print(f"no python modules found under {', '.join(map(str, roots))}",
              file=sys.stderr)
        return 2

    if args.update_registry:
        text = render_registry(extract_registry(modules))
        registry_path().write_text(text)
        print(f"wrote {registry_path()}")
        return 0

    if args.check_registry:
        drift = registry_drift(modules)
        for line in drift:
            print(f"registry drift: {line}")
        if drift:
            print(f"{len(drift)} drift(s) — regenerate with "
                  "`python -m repro_torch.analysis --update-registry`")
            return 1
        print("event registry in sync")
        return 0

    findings = run_checks(modules)
    baseline = Baseline([]) if args.no_baseline else Baseline.load(args.baseline)
    active, waived = split_baselined(findings, baseline)

    for f in active:
        print(f.render())
    stale = baseline.unused()
    for e in stale:
        print(f"stale baseline waiver (matched nothing): "
              f"{e['rule']} {e['file']} [{e['symbol']}]")

    print(f"{len(active)} finding(s), {len(waived)} baselined, "
          f"{len(stale)} stale waiver(s)")
    if args.strict and (active or stale):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
