#!/usr/bin/env python3
"""What each bf16 rounding inside the SSD chunked scan costs, on the CPU.

    PYTHONPATH=src python3 tools/ssd_rounding.py [--l 1024] [--h 8] [--seed 0]

Runs the chunked algorithm of ``kernels/csrc/ssd_scan.cu`` in float64 on
bf16 inputs drawn as ``chip_smoke.py`` draws them (P 64, N 128, one
batch), rounding three of its operands as a bf16 tensor-core product
would take them, each as chosen: the decay tile M, the state's copy for
C . state, and x's weighted copy for the state update (``none``: exact;
``bf16``: one rounding; ``hi_lo``: hi = bf16(v) and lo = bf16(v - hi),
both used).  For each choice and chunk 128 and 64 it prints one JSON line
with max |out - ref| / (1 + |ref|) of y and of the final state against
``ssd_ref``, after rounding the outputs to bf16 as the kernel does, and
y at chunk 64 against chunk 128 on the same measure.  chip_smoke.py holds
the kernel to 5e-2 and the two chunks to 1e-2 on it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels.ref import ssd_ref  # noqa: E402

MODES = ("none", "bf16", "hi_lo")


def rounded(t: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "none":
        return t
    hi = t.to(torch.bfloat16).to(t.dtype)
    return hi if mode == "bf16" else hi + (t - hi).to(torch.bfloat16).to(t.dtype)


def chunked(x, dt, a, b, c, q: int, m_mode: str, state_mode: str, xw_mode: str):
    """x (L, H, P), dt (L, H), a (H,), b and c (L, N), float64 -> (y, state)."""
    l, h, p = x.shape
    y = torch.zeros_like(x)
    state = torch.zeros(h, p, b.shape[-1], dtype=x.dtype)
    for l0 in range(0, l, q):
        xs, d, bs, cs = x[l0:l0 + q], dt[l0:l0 + q], b[l0:l0 + q], c[l0:l0 + q]
        n = xs.shape[0]
        cum = torch.cumsum(d * a, 0)                                   # (n, H)
        causal = torch.tril(torch.ones(n, n, dtype=torch.bool))
        s = cs @ bs.T
        for hh in range(h):
            diff = (cum[:, hh, None] - cum[None, :, hh]).masked_fill(~causal, -torch.inf)
            m = rounded(s * torch.exp(diff) * d[None, :, hh], m_mode)
            copy = rounded(state[hh], state_mode)
            y[l0:l0 + n, hh] = m @ xs[:, hh] + torch.exp(cum[:, hh, None]) * (cs @ copy.T)
            w = torch.exp(cum[-1, hh] - cum[:, hh]) * d[:, hh]
            xw = rounded(xs[:, hh] * w[:, None], xw_mode)
            state[hh] = torch.exp(cum[-1, hh]) * state[hh] + xw.T @ bs
    return y, state


def scaled_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    out = out.to(torch.bfloat16).double()
    return ((out - ref).abs() / (1 + ref.abs())).max().item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--l", type=int, default=1024)
    ap.add_argument("--h", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    gen = torch.Generator().manual_seed(args.seed)
    l, h, p, n = args.l, args.h, 64, 128
    x = torch.randn(1, l, h, p, generator=gen).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn(1, l, h, generator=gen)).bfloat16()
    a = (-torch.exp(0.3 * torch.randn(h, generator=gen))).bfloat16()
    b = torch.randn(1, l, n, generator=gen).bfloat16()
    c = torch.randn(1, l, n, generator=gen).bfloat16()
    ref_y, ref_st = (t[0].double() for t in ssd_ref(x.float(), dt.float(), a.float(),
                                                     b.float(), c.float()))
    args64 = [t[0].double() for t in (x, dt)] + [a.double()] + [t[0].double() for t in (b, c)]
    choices = [("none", "none", "none")]
    choices += [tuple("bf16" if i == k else "none" for i in range(3)) for k in range(3)]
    choices += [("hi_lo", "hi_lo", "hi_lo")]
    for m_mode, state_mode, xw_mode in choices:
        row = {"decay_tile": m_mode, "state_copy": state_mode, "xw": xw_mode}
        ys = {}
        for q in (128, 64):
            y, st = chunked(*args64, q, m_mode, state_mode, xw_mode)
            ys[q] = y.to(torch.bfloat16).double()
            row[f"q{q}"] = {"y": scaled_err(y, ref_y), "state": scaled_err(st, ref_st)}
        row["q64_vs_q128"] = ((ys[64] - ys[128]).abs() / (1 + ys[128].abs())).max().item()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
