#!/usr/bin/env python3
"""Time a model's prefill and decode of several checkouts in turns on one GPU.

    python3 tools/path_ab.py ROOT [ROOT ...] [--arch granite_3_2b] [--rounds 1]

Each ROOT is the root of a checkout of this repository (with its
``chip_smoke.py`` and ``src/``).  All checkouts' kernels are built first,
in parallel.  Then every round runs each checkout once in a process of its
own (the checkouts share package names), in the order given and then
reversed, so two versions run as A B B A.  A run is that checkout's
``chip_smoke.phase_prefill_decode(arch, seed)``: the model at full width
and ``chip_smoke.py``'s card depth, random weights from the seed, with all
of that phase's gates.  Prints one JSON line per run (prefill ms, the
first prefill's ms, the median decode-step ms, the prefill's and decode's
kernel launches), then the median of each number per checkout.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

WORKER = """
import io, json, sys, contextlib
root = sys.argv[1]
sys.path.insert(0, root + "/src"); sys.path.insert(0, root)
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    cs.phase_prefill_decode(sys.argv[2], int(sys.argv[3]))
rec = next(json.loads(ln) for ln in buf.getvalue().splitlines()
           if ln.startswith('{"phase": "prefill_decode"'))
print(json.dumps({k: rec[k] for k in ("prefill_ms", "first_prefill_ms", "decode_step_ms",
                                      "prefill_launches", "bf16_rel_err_max")}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--arch", default="granite_3_2b")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
                                "from repro_torch.kernels import build; build.build_all()",
                                root + "/src"]) for root in args.roots]
    if any(p.wait() for p in builds):
        print("path_ab: a kernel build failed", file=sys.stderr)
        return 1
    runs: dict[str, list[dict]] = {root: [] for root in args.roots}
    for _ in range(args.rounds):
        for root in args.roots + args.roots[::-1]:
            res = subprocess.run([sys.executable, "-c", WORKER, root, args.arch, str(args.seed)],
                                 capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                print(f"path_ab: {root} failed:\n{res.stderr[-3000:]}", file=sys.stderr)
                return 1
            row = {"root": root, "arch": args.arch, **json.loads(res.stdout.splitlines()[-1])}
            runs[root].append(row)
            print(json.dumps(row), flush=True)
    for root, rows in runs.items():
        print(json.dumps({"root": root, "arch": args.arch, "runs": len(rows), **{
            f"median_{k}": statistics.median(r[k] for r in rows)
            for k in ("prefill_ms", "first_prefill_ms", "decode_step_ms")},
            "prefill_launches": rows[0]["prefill_launches"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
