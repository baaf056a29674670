#!/usr/bin/env python3
"""How far the SSD backward's da lies from float64: kernel and plain version.

    python3 tools/ssd_da_precision.py [--seeds 0,1,2,3] [--smoke-seed 0]

A head's da sums dt_k dda_k over every (batch, step): terms of up to
hundreds that cancel to a total which may lie near zero.  For each seed
and case (fp32, B 1, L 512, H 48, P 64, N 128, the SIMT route: G 1 with
no initial state, G 1 and G 8 from one, G 8 with none), it runs
``ssd_scan_bwd_cuda`` and ``ssd_bwd_ref`` on the same inputs and holds
each da to a float64 referee (``chip_smoke.da_vs_float64``): per version
the max |error|, the max element-by-element scaled error |error| / (1 +
|da|), and the max over heads of |error| / (1 + sum |terms|).  The ``smoke``
case replays the fp32 case of ``chip_smoke.py``'s ssd_groups phase on its
own inputs (``--smoke-seed`` is that script's ``--seed``).  One JSON line
a case; needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

CASES = {"g1": (1, None), "g1_s0": (1, "fp32"), "g8": (8, None), "g8_s0": (8, "fp32")}


def measure(inputs, s0, dy, dstate) -> dict:
    import chip_smoke as cs
    from repro_torch.kernels.ref import ssd_bwd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda

    kernel = ssd_scan_bwd_cuda(*inputs, dy, dstate, s0)[2]
    plain = ssd_bwd_ref(*inputs, dy, dstate, initial_state=s0)[2]
    return cs.da_vs_float64(inputs, s0, dy, dstate, kernel, plain)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--smoke-seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (1, 512, 48, 64, 128)
    for seed in (int(v) for v in args.seeds.split(",")):
        for name, (g, s0_kind) in CASES.items():
            gen = torch.Generator(device="cuda").manual_seed(seed)
            inputs, s0, dy, dstate = cs._group_inputs(gen, *shape, g, s0_kind, torch.float32)
            print(json.dumps({"case": name, "seed": seed, "shape": list(shape), "groups": g,
                              "initial_state": s0_kind, **measure(inputs, s0, dy, dstate)}),
                  flush=True)
    # chip_smoke.py's fp32 ssd_groups case: the cases before it draw from
    # the same generator first
    gen = torch.Generator(device="cuda").manual_seed(args.smoke_seed + 31)
    for name, b, l, h, p, n, g, s0_kind, _, dtype in cs.SSD_GROUP_CASES:
        drawn = cs._group_inputs(gen, b, l, h, p, n, g, s0_kind, dtype)
        if dtype == torch.float32:
            print(json.dumps({"case": f"smoke {name}", "seed": args.smoke_seed,
                              "shape": [b, l, h, p, n], "groups": g, "initial_state": s0_kind,
                              **measure(*drawn)}), flush=True)
        del drawn
    return 0


if __name__ == "__main__":
    sys.exit(main())
