"""Chaos-campaign CLI: ``python -m repro_torch.sim --scenarios 500``.

Runs N seeded scenarios on the deterministic simulation plane, checks
the engine invariants plus same-seed trace determinism, and exits
non-zero on any violation.  A failing seed is a complete reproduction
recipe::

    python -m repro_torch.sim --scenarios 1 --base-seed <seed> --show-trace

``--mode guided`` switches to the coverage-guided search
(:mod:`repro_torch.sim.search`): novelty-weighted mutation over monitor-event
n-gram coverage, correlated fault kinds enabled, violations shrunk to
minimal repros.  With ``--repro-out`` the shrunk repros are written as
corpus-format JSON seeds (the nightly CI artifact), and with
``--corpus-dir`` the exit code is the *corpus gate*: non-zero only for a
violation class whose repro is not yet promoted under the corpus.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.engine.policies import ProactivePolicy, WrathPolicy
from repro_torch.sim.harness import campaign, run_scenario
from repro_torch.sim.scenario import Scenario
from repro_torch.sim.search import guided_campaign, promote_repro


def _policy_factory(name: str):
    if name == "wrath":
        return lambda: WrathPolicy()
    if name == "wrath+proactive":
        return lambda: [ProactivePolicy(), WrathPolicy()]
    if name == "baseline":
        return lambda: None
    raise SystemExit(f"unknown --policy {name!r}")


def _guided(args: argparse.Namespace, engine_kwargs: dict | None) -> int:
    result = guided_campaign(
        args.scenarios, base_seed=args.base_seed, ngram=args.ngram,
        policy_factory=_policy_factory(args.policy),
        determinism_checks=args.determinism_checks,
        scenario_kwargs={"max_tasks": args.max_tasks,
                         "correlated_rate": args.correlated_rate},
        engine_kwargs=engine_kwargs)
    print(result.summary())
    if args.repro_out:
        for scenario, expect in result.repros:
            path = promote_repro(
                scenario, expect, args.repro_out,
                note=f"shrunk by guided search (base_seed="
                     f"{args.base_seed}, budget={args.scenarios})")
            print(f"  wrote {path}")
    for failure in result.determinism_failures:
        print(f"  DETERMINISM: {failure}")
    if result.determinism_failures:
        return 2
    if not result.violations:
        return 0
    for sid, sig, viol, _ in result.violations[:20]:
        print(f"  scenario {sid} [{sig}]: {viol}")
    if args.corpus_dir is not None:
        uncovered = result.uncovered_signatures(args.corpus_dir)
        if not uncovered:
            print("all violation classes already pinned in the corpus "
                  f"({args.corpus_dir}); passing")
            return 0
        print(f"violation classes NOT in corpus: {uncovered}")
        print("promote the shrunk repros (see --repro-out) into "
              f"{args.corpus_dir} after fixing or triaging")
    return 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sim",
        description="seeded deterministic chaos campaign")
    ap.add_argument("--scenarios", type=int, default=200,
                    help="number of seeded scenarios (default 200)")
    ap.add_argument("--base-seed", type=int, default=0)
    ap.add_argument("--policy", default="wrath",
                    choices=["baseline", "wrath", "wrath+proactive"])
    ap.add_argument("--determinism-checks", type=int, default=3,
                    help="re-run this many scenarios and compare traces")
    ap.add_argument("--max-tasks", type=int, default=16)
    ap.add_argument("--show-trace", action="store_true",
                    help="print the first scenario's full event trace")
    ap.add_argument("--work-stealing", action="store_true",
                    help="run every scenario with decentralized work "
                         "stealing enabled (determinism checks included)")
    ap.add_argument("--mode", default="uniform",
                    choices=["uniform", "guided"],
                    help="uniform = independent seeded samples; guided = "
                         "coverage-guided mutation search with correlated "
                         "faults and repro shrinking")
    ap.add_argument("--ngram", type=int, default=3,
                    help="coverage n-gram order for --mode guided")
    ap.add_argument("--correlated-rate", type=float, default=0.35,
                    help="correlated-fault sampling rate (guided mode)")
    ap.add_argument("--corpus-dir", default=None,
                    help="repro corpus directory; with --mode guided the "
                         "exit code fails only on violation classes not "
                         "yet pinned there")
    ap.add_argument("--repro-out", default=None,
                    help="write shrunk minimal repros (corpus-format "
                         "JSON) into this directory")
    args = ap.parse_args(argv)

    engine_kwargs = {"work_stealing": True} if args.work_stealing else None
    if args.mode == "guided" and not args.show_trace:
        return _guided(args, engine_kwargs)
    if args.show_trace:
        result = run_scenario(
            Scenario.random(args.base_seed, max_tasks=args.max_tasks),
            policy_factory=_policy_factory(args.policy),
            engine_kwargs=engine_kwargs)
        print(result.scenario.describe())
        print(result.trace)
        print(result.summary())
        return 0 if result.ok else 1

    report = campaign(
        args.scenarios, base_seed=args.base_seed,
        policy_factory=_policy_factory(args.policy),
        determinism_checks=args.determinism_checks,
        scenario_kwargs={"max_tasks": args.max_tasks},
        engine_kwargs=engine_kwargs)
    print(report.summary())
    if not report.ok:
        for seed, viol in report.violations[:20]:
            print(f"  seed={seed}: {viol}")
        print("reproduce: python -m repro_torch.sim --scenarios 1 "
              "--base-seed <seed> --show-trace")
        return 1
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI entry
    sys.exit(main())
