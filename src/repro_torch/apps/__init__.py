"""TaPS-analog benchmark applications (paper §VII-A, Table II).

Five real DAG applications with genuine numerical payloads:

* ``cholesky``  — blocked Cholesky decomposition (potrf/trsm/syrk/gemm DAG)
* ``docking``   — molecular-docking proxy (batched pose scoring rounds)
* ``fedlearn``  — federated learning on a synthetic MNIST with a torch MLP
* ``mapreduce`` — word count over generated files (map + reduce)
* ``moldesign`` — ML-in-the-loop surrogate search for high-energy molecules

Each app exposes ``submit(injector, scale) -> list[AppFuture]`` (to be
called inside an active DFK session) and is registered in :data:`APPS` for
the benchmark harness.
"""
from repro_torch.apps.base import APPS, AppRunResult, run_app
from repro_torch.apps import cholesky, docking, fedlearn, mapreduce, moldesign  # noqa: F401

__all__ = ["APPS", "AppRunResult", "run_app"]
