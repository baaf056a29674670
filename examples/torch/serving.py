"""Production serving plane on the PyTorch port: continuous batching with
WRATH failover.

The port's counterpart of ``examples/serving.py``, through
``repro_torch`` alone.  Drives the request plane (clock-stamped queue,
SLO-aware admission, continuous batcher, replica failover) against a
reduced model on virtual replicas, killing one mid-traffic and showing
every in-flight request recovered on the survivors.  A first pass runs
the same workload through the static batcher.  The model decodes on
``--device``, the card unless ``--device cpu`` is given (without a card
the default raises rather than run on the CPU).

    PYTHONPATH=src python examples/torch/serving.py --arch olmoe-1b-7b
    PYTHONPATH=src python examples/torch/serving.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.serve import (Request, SLOAdmissionPolicy, TorchDecodeBackend,
                               WrathServeDriver)


def _requests(cfg, n, new_tokens, deadline_s=None):
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, size=6).tolist(),
                    max_new_tokens=new_tokens,
                    deadline_s=deadline_s)
            for i in range(n)]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)

    def backend():
        return TorchDecodeBackend(cfg, max_batch=4, device=device)

    # -- static baseline -------------------------------------------------
    static = WrathServeDriver(cfg, n_replicas=args.replicas, max_batch=4, decode=backend())
    reqs = _requests(cfg, args.requests, args.new_tokens)
    base = static.serve(reqs)
    static.shutdown()
    print(f"static batcher: {base.completed}/{len(reqs)} requests, "
          f"{base.tokens_generated} tokens ({base.tokens_per_s:.1f} tok/s)")

    # -- continuous plane, replica killed mid-traffic --------------------
    driver = WrathServeDriver(cfg, n_replicas=args.replicas, max_batch=4, decode=backend(),
                              admission=SLOAdmissionPolicy())
    reqs = _requests(cfg, args.requests, args.new_tokens, deadline_s=30.0)
    print(f"\ncontinuous plane: submitting {len(reqs)} requests on "
          f"{args.replicas} replicas of {cfg.name} (reduced) on {device}; killing "
          f"replica0 mid-traffic...")
    rep = driver.serve_continuous(reqs, faults=[(0.05, "kill", "replica0")],
                                  horizon=120.0)
    driver.shutdown()

    print(f"\ncompleted: {rep.completed}/{len(reqs)}  failed: {rep.failed}  "
          f"rejected: {rep.rejected}  shed: {rep.shed}")
    print(f"tokens generated: {rep.tokens_generated} "
          f"({rep.requests_per_s:.1f} req/s, p50 {rep.p50_s*1e3:.0f}ms, "
          f"p99 {rep.p99_s*1e3:.0f}ms)")
    print(f"denylisted replicas: {rep.denylisted}")
    for r in rep.recoveries:
        print(f"  recovery: request {r['rid']} lost with {r['replica']} "
              f"-> {r['action']} (rung {r['rung']})")
    sample = reqs[0]
    print(f"\nrequest 0: prompt={sample.prompt} generated={sample.generated}")
    assert rep.completed == len(reqs), "not all requests completed"
    print("all requests completed despite replica loss.")
    return {"device": str(device), "requests": len(reqs), "static_completed": base.completed,
            "completed": rep.completed, "failed": rep.failed,
            "recoveries": len(rep.recoveries), "denylisted": sorted(rep.denylisted),
            "tokens_generated": rep.tokens_generated}


if __name__ == "__main__":
    main()
