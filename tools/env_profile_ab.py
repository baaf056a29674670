#!/usr/bin/env python3
"""A launch-environment variable on the card: on against off, in turns.

    python3 tools/env_profile_ab.py [--env PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True]
        [--order on,off,off,on] [--out build/env_profile_ab.jsonl]

Runs ``chip_smoke.py``'s ``phase_train_step`` (granite-3-2b at full width
and depth, B 4, S 1024, bf16, remat) and ``phase_serve`` for granite-3-2b
(two replicas, a replica kill, then a continuous run) in one fresh process
per turn: with ``--env``'s variable set ("on"; a candidate for
``repro_torch.launch.env_flags``'s profiles) and unset ("off").  Each
variable is read when CUDA initialises, so every turn is its own
process.  Prints one JSON line per turn (step ms, tokens/s, peak GB,
serve tokens/s and peak GB) and a summary line, and appends them to
``--out``.  The kernels are built once, before the turns.  Needs one
card; without one it exits nonzero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CHILD = """
import json, sys
sys.path.insert(0, {src!r}); sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_train_step(0)
cs.release()
cs.phase_serve("granite_3_2b", 0)
"""


def turn(name: str, value: str, profile_on: bool) -> dict:
    env = dict(os.environ)
    env.pop(name, None)
    if profile_on:
        env[name] = value
    proc = subprocess.run([sys.executable, "-c", CHILD.format(src=str(ROOT / "src"),
                                                              root=str(ROOT))],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"turn with the profile {'on' if profile_on else 'off'} failed:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    lines = {}
    for ln in proc.stdout.splitlines():
        if ln.startswith("{"):
            rec = json.loads(ln)
            lines[rec.get("phase")] = rec
    train, static, cont = lines["train_step"], lines["serve_static_kill"], \
        lines["serve_continuous"]
    return {"profile": "on" if profile_on else "off",
            "env": {name: env.get(name)},
            "train_step_ms": train["step_ms"], "train_steps_ms": [s["ms"] for s in train["steps"]],
            "train_tokens_per_s": train["tokens_per_s"], "train_peak_gb": train["peak_mem_gb"],
            "serve_static_tokens_per_s": static["tokens_per_s"],
            "serve_continuous_tokens_per_s": cont["tokens_per_s"],
            "serve_p50_s": cont["p50_s"], "serve_p99_s": cont["p99_s"],
            "serve_peak_gb": cont["serve_peak_gb"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--env", default="PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True")
    ap.add_argument("--order", default="on,off,off,on")
    ap.add_argument("--out", default=str(ROOT / "build" / "env_profile_ab.jsonl"))
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    if smi.returncode != 0:
        print("env_profile_ab: no NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    build.build_all()
    rows = [{"nvidia_smi": smi.stdout.strip().splitlines()[0]}]
    name, value = args.env.split("=", 1)
    for which in args.order.split(","):
        rows.append(turn(name, value, which == "on"))
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for key in ("train_step_ms", "train_tokens_per_s", "train_peak_gb",
                "serve_static_tokens_per_s", "serve_continuous_tokens_per_s", "serve_peak_gb"):
        for which in ("on", "off"):
            vals = [r[key] for r in rows[1:] if r["profile"] == which]
            summary[f"{key}_{which}"] = vals
    rows.append({"summary": summary})
    print(json.dumps(rows[0]), flush=True)
    print(json.dumps(rows[-1]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
