#!/usr/bin/env python3
"""Time the SSD and flash wrappers of another checkout and of this one in
one process, call batch by call batch in turns, at B/C group count 1.

    python3 tools/ssd_host_ab.py OTHER_SRC [--rounds 30] [--calls 200]

OTHER_SRC is the ``src`` directory of another checkout (the parent).  Its
``repro_torch`` package is copied under ``build/host_ab/`` as
``repro_torch_other`` (imports renamed) so that both load in one process
and share its host: the host's load then moves both alike, which it does
not across the processes of ``tools/flash_ab.py``.  Each round times both
versions, in an order that alternates round by round, on the same bf16
inputs made from a seed: the backward launcher ``ssd_scan_bwd_cuda`` and
the forward ``kernels.ops.ssd_scan`` at one 64-step chunk of two heads
(``*_host_us``: a call's wall time over ``--calls`` calls, host-bound),
the flash forward ``kernels.ops.flash_attention`` and the backward
launcher ``flash_attention_bwd_cuda`` at one 128-key tile of one head
(``flash_*_host_us``, likewise), and by CUDA events over 50 back-to-back
calls mamba2-780m's backward at B 4 and B 2 (the train step's launch
shape) and its forward at B 4, L 1024 (``*_ms``).  Prints one JSON line a round and last the medians per
version and the median and quartiles of the rounds' ratios this / other.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def other_package(src: Path, dest: Path | None = None) -> Path:
    """A copy of ``src/repro_torch`` as ``repro_torch_other`` in ``dest``
    (default build/host_ab/src; its kernels build in ``dest``'s parent's
    build/); returns ``dest``."""
    dest = ROOT / "build" / "host_ab" / "src" if dest is None else dest
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(src / "repro_torch", dest / "repro_torch_other",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in (dest / "repro_torch_other").rglob("*.py"):
        f.write_text(re.sub(r"\brepro_torch\b", "repro_torch_other", f.read_text()))
    return dest


def wall_us(fn, calls: int) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def event_ms(fn, calls: int = 50) -> float:
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def inputs(gen, b: int, l: int, h: int) -> tuple:
    import torch
    import torch.nn.functional as F
    p, n = 64, 128
    x, dy = (torch.randn(b, l, h, p, generator=gen, device="cuda").bfloat16() for _ in "xy")
    bm, cm = (torch.randn(b, l, n, generator=gen, device="cuda").bfloat16() for _ in "bc")
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).bfloat16()
    a = (-torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))).bfloat16()
    return x, dt, a, bm, cm, dy


def calls_of(pkg: str, data: dict) -> dict:
    """The timed calls of package ``pkg`` on ``data``."""
    import importlib
    ops = importlib.import_module(f"{pkg}.kernels.ops")
    bwd = importlib.import_module(f"{pkg}.kernels.ssd_scan").ssd_scan_bwd_cuda
    flash = importlib.import_module(f"{pkg}.kernels.flash_attention")
    tiny, b4, b2 = data["tiny"], data["b4"], data["b2"]
    q, k, v, do = data["flash"]
    o, lse = flash.flash_attention_cuda(q, k, v, causal=True, window=0, return_lse=True)
    out = {"fwd_host_us": lambda: ops.ssd_scan(*tiny[:5], chunk=64),
           "bwd_host_us": lambda: bwd(*tiny),
           "flash_fwd_host_us": lambda: ops.flash_attention(q, k, v, causal=True),
           "flash_bwd_host_us": lambda: flash.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                                      causal=True, window=0),
           "fwd_ms": lambda: ops.ssd_scan(*b4[:5], chunk=128),
           "bwd_b4_ms": lambda: bwd(*b4),
           "bwd_b2_ms": lambda: bwd(*b2)}
    for fn in out.values():   # build, load and warm
        fn()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_src", type=Path)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(other_package(args.other_src.resolve())))
    import torch

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    data = {"tiny": inputs(gen, 1, 64, 2), "b4": inputs(gen, 4, 1024, 48),
            "b2": inputs(gen, 2, 1024, 48),
            "flash": tuple(torch.randn(1, 128, 1, 64, generator=gen, device="cuda").bfloat16()
                           for _ in range(4))}
    versions = {"other": calls_of("repro_torch_other", data), "this": calls_of("repro_torch", data)}
    runs: dict[str, dict[str, list[float]]] = {v: {} for v in versions}
    for r in range(args.rounds):
        row = {"round": r}
        for v in (("other", "this") if r % 2 == 0 else ("this", "other")):
            got = {}
            for key, fn in versions[v].items():
                got[key] = (wall_us(fn, args.calls) if key.endswith("_us") else event_ms(fn))
                runs[v].setdefault(key, []).append(got[key])
            row[v] = got
        print(json.dumps(row), flush=True)
    ratios = {key: sorted(t / o for t, o in zip(runs["this"][key], runs["other"][key]))
              for key in runs["this"]}
    print(json.dumps({
        "median": {v: {k: statistics.median(x) for k, x in by.items()} for v, by in runs.items()},
        "ratio_this_over_other": {k: {"median": statistics.median(x),
                                      "quartiles": statistics.quantiles(x, n=4)[::2]}
                                  for k, x in ratios.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
