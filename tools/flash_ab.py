#!/usr/bin/env python3
"""Time the flash-attention kernel of several checkouts in turns on one GPU.

    python3 tools/flash_ab.py SRC [SRC ...] [--shapes granite,s2048,d128] [--rounds 2]

Each SRC is the ``src`` directory of a checkout of this repository.  All
checkouts' kernels are built first, in parallel.  Then every round runs
each checkout once in a process of its own (the checkouts share package
names), in the order given and then reversed, so two versions run as
A B B A.  A run times ``repro_torch.kernels.ops.flash_attention`` with
CUDA events on bf16 causal inputs made from a seed, beside one
``scaled_dot_product_attention`` call on the same inputs, and reports
the kernel's max |out - ref| / (1 + |ref|) against its checkout's
``flash_attention_ref``.  Prints one JSON line per run, then the median
ms per checkout and shape.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

SHAPES = {  # (B, S, H, KV, D, window): granite-3-2b's prefill, a longer prompt,
    # the other head dim, a sliding window
    "granite": (4, 1024, 32, 8, 64, 0),
    "s2048": (4, 2048, 32, 8, 64, 0),
    "d128": (4, 1024, 32, 8, 128, 0),
    "window256": (4, 1024, 32, 8, 64, 256),
}


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def worker(src: str, shapes: list[str], seed: int) -> dict:
    sys.path.insert(0, src)
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"src": src}
    for name in shapes:
        b, s, h, kv, d, window = SHAPES[name]
        q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda").bfloat16()
                   for n in (h, kv, kv))
        got = flash_attention(q, k, v, causal=True, window=window)
        ref = flash_attention_ref(q, k, v, causal=True, window=window)
        err = ((got.float() - ref.float()).abs() / (1 + ref.float().abs())).max().item()
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib_kw = {"is_causal": True}
        if window:
            pos = torch.arange(s, device="cuda")
            lib_kw = {"attn_mask": (pos[None, :] <= pos[:, None])
                      & (pos[None, :] > pos[:, None] - window)}
        out[name] = {
            "ms": cuda_ms(lambda: flash_attention(q, k, v, causal=True, window=window)),
            "sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **lib_kw)),
            "max_scaled_err": err}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("srcs", nargs="+")
    ap.add_argument("--shapes", default="granite,s2048,d128,window256")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    shapes = args.shapes.split(",")
    if args.worker:
        print(json.dumps(worker(args.srcs[0], shapes, args.seed)), flush=True)
        return 0

    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
                                " from repro_torch.kernels import build; build.build_all()", src])
              for src in args.srcs]
    if any(p.wait() for p in builds):
        raise SystemExit("flash_ab: a build failed")
    runs: dict[str, dict[str, list]] = {src: {} for src in args.srcs}
    for r in range(args.rounds):
        for src in (args.srcs if r % 2 == 0 else args.srcs[::-1]):
            res = subprocess.run([sys.executable, __file__, src, "--worker", "--shapes",
                                  args.shapes, "--seed", str(args.seed)],
                                 capture_output=True, text=True, check=True)
            row = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps({"round": r, **row}), flush=True)
            for name in shapes:
                runs[src].setdefault(name, []).append(row[name])
    summary = {src: {name: {key: statistics.median(x[key] for x in rows)
                            for key in ("ms", "sdpa_ms", "max_scaled_err")}
                     for name, rows in by_shape.items()}
               for src, by_shape in runs.items()}
    print(json.dumps({"median": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
