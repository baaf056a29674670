"""Run the five TaPS-analog applications of the PyTorch port under
failure injection.

The port's counterpart of ``examples/taps_workflows.py``, through
``repro_torch`` alone.  Reproduces the paper's experimental setup in
miniature: pick an app, a failure type and a rate; compare
resilience-policy stacks, WRATH (``[WrathPolicy()]``) against
Parsl-style baseline retry (the empty stack).  Each app run executes
inside a :class:`~repro_torch.api.Workflow` scope named after the app.
fedlearn and moldesign compute in torch on ``--device``, the card
unless ``--device cpu`` is given (without a card the default raises
rather than run on the CPU); the other three apps compute nothing on a
device.

    PYTHONPATH=src python examples/torch/taps_workflows.py --failure memory --rate 0.3
    PYTHONPATH=src python examples/torch/taps_workflows.py --app cholesky \\
        --failure zero_division --rate 0.2
"""
import argparse

from repro_torch.api import Cluster, MonitoringDatabase, WrathPolicy
from repro_torch.apps import APPS, run_app
from repro_torch.device import resolve_device
from repro_torch.injection import FAILURE_TYPES, FailureInjector, NoInjector

ON_DEVICE = ("fedlearn", "moldesign")   # the apps that compute in torch


def cluster_for(failure: str) -> tuple[Cluster, str | None]:
    if failure == "import":
        return (Cluster.paper_testbed(small_nodes=3, big_nodes=1,
                                      with_pkg_pool=True, package="wrathpkg"),
                "no-pkg")
    if failure in ("memory", "ulimit"):
        cl = Cluster.paper_testbed(small_nodes=3, big_nodes=1)
        if failure == "ulimit":
            for n in cl.pools["big-mem"].nodes:
                n.ulimit_files = 2_000_000
        return cl, "small-mem"
    return Cluster.homogeneous(4), None


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--app", default="all", choices=["all", *sorted(APPS)])
    ap.add_argument("--failure", default="memory",
                    choices=["none", *FAILURE_TYPES])
    ap.add_argument("--rate", type=float, default=0.3)
    ap.add_argument("--scale", default="small")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    apps = sorted(APPS) if args.app == "all" else [args.app]
    device = str(resolve_device(args.device)) if set(apps) & set(ON_DEVICE) else None
    hdr = (f"{'app':12s} {'mode':9s} {'ok':3s} {'makespan':>9s} {'ttf':>8s} "
           f"{'task_sr':>8s} {'retry_sr':>9s} {'overhead':>9s}")
    print(hdr)
    print("-" * len(hdr))
    rows = []
    for app in apps:
        for mode in ("wrath", "baseline"):
            cl, pool = cluster_for(args.failure)
            inj = (NoInjector() if args.failure == "none" else
                   FailureInjector(args.failure, rate=args.rate,
                                   seed=args.seed, app_tag=f"{app}:{mode}"))
            kw = {"device": device} if app in ON_DEVICE else {}
            r = run_app(app, cl,
                        policy=[WrathPolicy()] if mode == "wrath" else [],
                        monitor=MonitoringDatabase(), injector=inj,
                        scale=args.scale, default_pool=pool,
                        default_retries=2, wait_timeout=120, **kw)
            ttf = f"{r.time_to_failure:.3f}" if r.time_to_failure else "-"
            print(f"{app:12s} {mode:9s} {'Y' if r.success else 'N':3s} "
                  f"{r.makespan:9.3f} {ttf:>8s} {r.task_success_rate:8.3f} "
                  f"{r.retry_success_rate:9.3f} {r.overhead_ratio:9.5f}")
            rows.append({"app": app, "mode": mode, "success": r.success,
                         "task_success_rate": r.task_success_rate, "device": kw.get("device")})
    return rows


if __name__ == "__main__":
    main()
