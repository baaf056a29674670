"""End-to-end WRATH-supervised training on the PyTorch port, with
injected failures.

The port's counterpart of ``examples/resilient_training.py``, through
``repro_torch`` alone.  Trains a reduced-config model (any of the 10
assigned architectures) with the WRATH training supervisor while the run
is hit by a host loss, a NaN loss and a chronic straggler.  The run
checkpoint-restarts, elastically re-meshes, denylists the straggler, and
the loss still goes down.  The model trains on ``--device``, the card
unless ``--device cpu`` is given (without a card the default raises
rather than run on the CPU).

    PYTHONPATH=src python examples/torch/resilient_training.py \\
        --arch granite-3-2b --steps 120 --d-model 256 --layers 4

Scale --d-model/--layers up toward ~100M params if you have minutes to
spare; the recovery behaviour is identical at every scale.  Checkpoints
go to ``--ckpt`` (default ``$TMPDIR/wrath_resilient_training``).
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.api import WrathPolicy, replay
from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.optim import OptConfig
from repro_torch.train import TrainEvent, WrathTrainSupervisor


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "wrath_resilient_training"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    cfg = cfg.scaled(d_model=args.d_model, n_layers=args.layers)

    shutil.rmtree(args.ckpt, ignore_errors=True)
    sup = WrathTrainSupervisor(
        cfg, OptConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps),
        n_hosts=args.hosts, global_batch=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt, ckpt_every=10,
        # composable stack: two HPX-style replays first, then WRATH's
        # taxonomy-driven placement takes over (first decisive wins)
        policy=[replay(2, on_exhausted="defer"), WrathPolicy()], device=device)

    third = args.steps // 3
    events = [
        TrainEvent(step=third, kind="host_down", host="host01"),
        TrainEvent(step=third + 10, kind="nan"),
        TrainEvent(step=2 * third, kind="straggler", host="host02", factor=40),
    ]
    print(f"training {cfg.name} (reduced: d={cfg.d_model}, L={cfg.n_layers}) "
          f"for {args.steps} steps on {args.hosts} virtual hosts on {device}; injecting "
          f"host-loss @ {third}, NaN @ {third+10}, straggler @ {2*third}")
    rep = sup.run(args.steps, events=events)
    shutil.rmtree(args.ckpt, ignore_errors=True)

    print(f"\nsteps completed: {rep.steps_completed}")
    print(f"loss: {rep.losses[0]:.3f} -> {rep.losses[-1]:.3f}")
    print(f"checkpoint restores: {rep.restores}, speculations: "
          f"{rep.speculations}, denylisted: {rep.denylisted}, "
          f"surviving hosts: {rep.final_hosts}")
    print("\nrecovery log:")
    for r in rep.recoveries:
        print(f"  step {r['step']:4d} {r['error']:28s} on {r['host']:8s} "
              f"-> {r['action']} (rung {r['rung']})")
    assert rep.losses[-1] < rep.losses[0], "loss did not improve"
    print("\nresilient training complete — loss improved through failures.")
    return {"device": str(device), "steps_completed": rep.steps_completed,
            "first_loss": rep.losses[0], "last_loss": rep.losses[-1],
            "restores": rep.restores, "recoveries": [r["error"] for r in rep.recoveries],
            "denylisted": sorted(rep.denylisted), "final_hosts": rep.final_hosts}


if __name__ == "__main__":
    main()
