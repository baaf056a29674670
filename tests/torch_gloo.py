"""Run a piece of the port on a multi-process CPU group (``gloo``).

:func:`run_group` starts ``world`` Python processes on this host, joined
by ``torch.distributed.init_process_group("gloo")`` at a free localhost
port.  Each runs ``body`` with ``rank``, ``world`` and ``payload`` (the
pickled object the test passed) defined, and the ``torch``, ``numpy as
np`` and ``torch.distributed as dist`` modules imported; rank 0 sets
``result``, which comes back to the test.  The children import neither
jax nor the JAX package: the test computes the reference itself and
hands the workers numpy inputs.
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PRELUDE = """
import os, pickle, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                        rank=rank, world_size=world)
with open(os.environ["PAYLOAD"], "rb") as f:
    payload = pickle.load(f)
result = None
"""

EPILOGUE = """
dist.barrier()
if rank == 0:
    with open(os.environ["RESULT"], "wb") as f:
        pickle.dump(result, f)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(world: int, body: str, payload: object, *, timeout: float = 120.0) -> object:
    """Run ``body`` on ``world`` gloo ranks; return rank 0's ``result``."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"PAYLOAD": os.path.join(tmp, "payload.pkl"),
                 "RESULT": os.path.join(tmp, "result.pkl")}
        with open(paths["PAYLOAD"], "wb") as f:
            pickle.dump(payload, f)
        script = PRELUDE + textwrap.dedent(body) + EPILOGUE
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"), PORT=str(_free_port()),
                   WORLD_SIZE=str(world), OMP_NUM_THREADS="1", **paths)
        procs = [subprocess.Popen([sys.executable, "-c", script], cwd=REPO,
                                  env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
        assert not failed, f"ranks failed {failed}:\n" + "\n".join(
            o[-4000:] for o in outs)
        with open(paths["RESULT"], "rb") as f:
            return pickle.load(f)
