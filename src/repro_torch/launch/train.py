"""WRATH-supervised training launcher (the port of ``repro.launch.train``).

Single-host execution path (reduced configs, real torch compute, virtual
hosts with failure injection):

    python -m repro_torch.launch.train --arch granite-3-2b --steps 200 \
        --inject host_down:50:host01 --inject nan:80

The model trains on ``--device`` (default ``cuda``; ``--device cpu`` runs
it on the CPU, and without a card the default raises).  As the reference
applies its XLA flag profile first, ``main`` first applies the ``train``
launch-environment profile (``launch/env_flags.py``; it sets nothing yet:
no variable has shown on an H100 that this launcher needs it), before
CUDA initialises.  ``--ckpt-dir`` defaults to
``wrath_train`` under the temporary directory (``$TMPDIR``) rather than
``/tmp`` itself.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.engine.policies import WrathPolicy, replay
from repro_torch.engine.scheduler import SCHEDULERS, make_scheduler
from repro_torch.launch.env_flags import apply_env_flags
from repro_torch.optim import OptConfig
from repro_torch.train import TrainEvent, WrathTrainSupervisor


def parse_event(spec: str) -> TrainEvent:
    """kind:step[:host[:factor]] — e.g. host_down:50:host01, nan:80,
    straggler:100:host02:40"""
    parts = spec.split(":")
    kind, step = parts[0], int(parts[1])
    host = parts[2] if len(parts) > 2 else None
    factor = float(parts[3]) if len(parts) > 3 else 5.0
    return TrainEvent(step=step, kind=kind, host=host, factor=factor)


def main(argv: list[str] | None = None) -> None:
    # the launch-environment profile must be in the environment before CUDA
    # initialises: importing torch does not initialise it, the first CUDA call does
    apply_env_flags("train")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b",
                    help=f"one of {', '.join(a.replace('_', '-') for a in ARCH_IDS)}")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override the smoke config width")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "wrath_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--inject", action="append", default=[],
                    help="failure event kind:step[:host[:factor]] (repeatable)")
    ap.add_argument("--scheduler", default=None, choices=sorted(SCHEDULERS),
                    help="placement policy for shard->host assignment and "
                         "speculation targets (default: legacy fixed order)")
    ap.add_argument("--replay", type=int, default=0,
                    help="prepend an HPX-style replay(N) policy: every "
                         "shard gets N attempts before WRATH's taxonomy "
                         "is even consulted (0 = WRATH stack only)")
    ap.add_argument("--json", action="store_true", help="machine-readable report")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
    if args.layers:
        overrides["n_layers"] = args.layers
    if overrides:
        cfg = cfg.scaled(**overrides)

    # the training plane runs on the same composable policy stack as the
    # task plane: first decisive decision wins, WRATH is the terminal expert
    policy = ([replay(args.replay, on_exhausted="defer")]
              if args.replay else []) + [WrathPolicy()]
    sup = WrathTrainSupervisor(
        cfg, OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                       total_steps=args.steps),
        n_hosts=args.hosts, global_batch=args.global_batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        policy=policy,
        scheduler=make_scheduler(args.scheduler) if args.scheduler else None,
        device=device)
    events = [parse_event(e) for e in args.inject]
    rep = sup.run(args.steps, events=events)

    if args.json:
        print(json.dumps({
            "arch": cfg.name, "steps": rep.steps_completed,
            "loss_first": rep.losses[0] if rep.losses else None,
            "loss_last": rep.losses[-1] if rep.losses else None,
            "restores": rep.restores, "speculations": rep.speculations,
            "denylisted": rep.denylisted, "recoveries": rep.recoveries,
        }, indent=1))
        return
    print(f"{cfg.name}: {rep.steps_completed} steps, "
          f"loss {rep.losses[0]:.3f} -> {rep.losses[-1]:.3f}")
    print(f"restores={rep.restores} speculations={rep.speculations} "
          f"denylisted={rep.denylisted} hosts={rep.final_hosts}")
    for r in rep.recoveries:
        print(f"  step {r['step']:4d} {r['error']:26s} {r['host']:8s} "
              f"-> {r['action']} (rung {r['rung']})")


if __name__ == "__main__":
    main()
