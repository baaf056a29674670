"""WRATH-supervised serving launcher (the port of ``repro.launch.serve``;
it serves the architecture's smoke config, as the reference does).

Static batching (the historical baseline)::

    python -m repro_torch.launch.serve --arch granite-3-2b --requests 16 \
        --replicas 3 --kill replica0:5

Continuous batching with SLO admission and autoscaling::

    python -m repro_torch.launch.serve --continuous --arrival-rate 40 \
        --deadline-ms 800 --autoscale 1:6 --scheduler least_loaded

``--decode sim`` swaps the model for the deterministic simulated
backend on a virtual clock: a minute of traffic replays byte-identically
in milliseconds.  The model decodes on ``--device`` (default ``cuda``;
``--device cpu`` runs it on the CPU).  ``main`` first applies the
``serve`` launch-environment profile (``launch/env_flags.py``), before
CUDA initialises, as the reference applies its XLA flag profile.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.engine.scheduler import SCHEDULERS, make_scheduler
from repro_torch.launch.env_flags import apply_env_flags
from repro_torch.serve import (ReplicaAutoscaler, Request, SLOAdmissionPolicy,
                               TorchDecodeBackend, WrathServeDriver)


def main() -> None:
    # the launch-environment profile must be in the environment before CUDA
    # initialises: importing torch does not initialise it, the first CUDA call does
    apply_env_flags("serve")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b",
                    help=f"one of {', '.join(a.replace('_', '-') for a in ARCH_IDS)}")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=6)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--scheduler", default=None, choices=sorted(SCHEDULERS),
                    help="replica-selection policy (default round_robin)")
    ap.add_argument("--kill", default=None,
                    help="replica:step — kill a replica mid-decode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    # -- continuous plane ------------------------------------------------
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching (queue -> admission -> slots)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request SLO; enables deadline-aware admission")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="mean request arrivals per second (default: all "
                         "requests arrive at t=0); implies --continuous")
    ap.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                    help="enable the replica autoscaler, e.g. 1:6; "
                         "implies --continuous")
    ap.add_argument("--decode", default="torch", choices=("torch", "sim"),
                    help="decode backend; 'sim' runs the modeled-cost "
                         "backend on a virtual clock (deterministic)")
    ap.add_argument("--device", default="cuda",
                    help="device of the torch decode backend (cuda or cpu)")
    args = ap.parse_args()
    continuous = (args.continuous or args.arrival_rate is not None
                  or args.autoscale is not None)

    cfg = get_smoke_config(args.arch)
    clock = None
    decode: object = "sim"
    if args.decode == "sim":
        from repro_torch.sim import VirtualClock
        clock = VirtualClock()
    else:
        decode = TorchDecodeBackend(cfg, max_batch=args.max_batch,
                                    seed=args.seed, device=args.device)
    policy = None
    if args.autoscale:
        lo, _, hi = args.autoscale.partition(":")
        from repro_torch.engine.policies import WrathPolicy
        policy = [WrathPolicy(),
                  ReplicaAutoscaler(min_replicas=int(lo or 1),
                                    max_replicas=int(hi or 6))]
    driver = WrathServeDriver(
        cfg, n_replicas=args.replicas, max_batch=args.max_batch,
        seed=args.seed, clock=clock, decode=decode, policy=policy,
        scheduler=make_scheduler(args.scheduler) if args.scheduler else None,
        admission=SLOAdmissionPolicy() if args.deadline_ms else None)
    rng = np.random.default_rng(args.seed)
    deadline_s = args.deadline_ms / 1e3 if args.deadline_ms else None
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=args.prompt_len).tolist(),
                    max_new_tokens=args.new_tokens,
                    deadline_s=deadline_s)
            for i in range(args.requests)]
    kill = None
    if args.kill:
        name, _, step = args.kill.partition(":")
        kill = (name, int(step or 5))

    if continuous:
        arrivals = None
        if args.arrival_rate:
            gaps = rng.exponential(1.0 / args.arrival_rate,
                                   size=args.requests)
            arrivals = np.cumsum(gaps).tolist()
        faults = None
        if kill:
            # in the continuous plane the kill is time-based: fire it when
            # roughly that many decode steps have elapsed at nominal cost
            faults = [(0.02 * kill[1], "kill", kill[0])]
        rep = driver.serve_continuous(reqs, arrivals=arrivals, faults=faults)
        driver.shutdown()
    else:
        rep = driver.serve(reqs, kill_replica_at=kill)

    if args.json:
        print(json.dumps({
            "arch": cfg.name, "mode": "continuous" if continuous else "static",
            "completed": rep.completed, "failed": rep.failed,
            "rejected": rep.rejected, "shed": rep.shed,
            "tokens": rep.tokens_generated, "tokens_per_s": rep.tokens_per_s,
            "requests_per_s": rep.requests_per_s,
            "p50_s": rep.p50_s, "p99_s": rep.p99_s,
            "denylisted": rep.denylisted, "recoveries": rep.recoveries,
            "autoscaled_up": rep.autoscaled_up,
            "autoscaled_down": rep.autoscaled_down,
            "replicas_final": rep.replicas_final,
        }, indent=1))
        return
    print(f"{cfg.name}: {rep.completed}/{len(reqs)} requests, "
          f"{rep.tokens_generated} tokens ({rep.tokens_per_s:.1f} tok/s)")
    if continuous:
        print(f"  rps={rep.requests_per_s:.2f} p50={rep.p50_s*1e3:.1f}ms "
              f"p99={rep.p99_s*1e3:.1f}ms rejected={rep.rejected} "
              f"shed={rep.shed} replicas={rep.replicas_final} "
              f"(+{rep.autoscaled_up}/-{rep.autoscaled_down})")
    if rep.denylisted:
        print(f"denylisted replicas: {rep.denylisted}")
    for r in rep.recoveries:
        where = f"step {r['step']}" if "step" in r else f"request {r['rid']}"
        print(f"  recovery: {r['replica']} at {where} -> {r['action']}")


if __name__ == "__main__":
    main()
