#!/usr/bin/env python3
"""What each bf16 rounding inside the SSD chunked scan costs, on the CPU.

    PYTHONPATH=src python3 tools/ssd_rounding.py [--l 1024] [--h 8] [--seed 0]
                                                 [--part fwd|bwd|both]

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

``--part bwd`` does the same for the backward of
``kernels/csrc/ssd_scan_bwd.cu``'s tensor-core route (64-step chunks):
its formulas in float64 on the same inputs and a dy drawn alike, with
the six fp32 intermediates that enter its bf16 products rounded as
chosen: W and V (the chunk's decay-weighted C B^T and dy x^T tiles), S
and dS (the states entering and the state gradients leaving each chunk),
e^{cs} C (the operand of the dS recursion) and xw (that of the state
recursion).  Each line holds max |out - ref| / (1 + |ref|) of dx, ddt,
da, db and dc against the unrounded float64 gradient, after rounding the
outputs to bf16; chip_smoke.py holds the kernel to 5e-2 on it (against
autograd of the fp32 ``ssd_ref``).
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
BWD_OPERANDS = ("w", "v", "state", "dstate", "ec", "xw")


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


def chunked_bwd(x, dt, a, b, c, dy, q: int, modes: dict):
    """The backward's formulas (``ref.ssd_bwd_ref``'s, per 64-step chunk),
    x (L, H, P), dt (L, H), a (H,), b and c (L, N), dy (L, H, P), float64,
    with each operand of ``BWD_OPERANDS`` rounded as ``modes`` says where it
    enters a product -> (dx, ddt, da, db, dc)."""
    def r(name, t):
        return rounded(t, modes.get(name, "none"))

    l, h, p = x.shape
    n = b.shape[-1]
    chunks = [(l0, min(l0 + q, l)) for l0 in range(0, l, q)]
    vecs = []
    for l0, l1 in chunks:
        cum = torch.cumsum(dt[l0:l1] * a, 0)                         # (n, H)
        vecs.append((cum, torch.exp(cum), torch.exp(cum[-1] - cum), torch.exp(cum[-1])))
    # the states entering each chunk, and the gradients leaving each chunk
    states = [torch.zeros(h, p, n, dtype=x.dtype)]
    for (l0, l1), (cum, ein, wout, keep) in zip(chunks[:-1], vecs):
        xw = r("xw", x[l0:l1] * (wout * dt[l0:l1])[..., None])        # (n, H, P)
        states.append(keep[:, None, None] * states[-1] + torch.einsum("jhp,jn->hpn", xw, b[l0:l1]))
    ds = [None] * len(chunks)
    cur = torch.zeros(h, p, n, dtype=x.dtype)
    for k in reversed(range(len(chunks))):
        ds[k] = cur
        (l0, l1), (cum, ein, wout, keep) = chunks[k], vecs[k]
        ec = r("ec", ein.T[:, :, None] * c[l0:l1][None])                 # (H, n, N)
        cur = keep[:, None, None] * cur + torch.einsum("ihp,hin->hpn", dy[l0:l1], ec)
    dx, ddt, db, dc = (torch.zeros_like(t) for t in (x, dt, b, c))
    da = torch.zeros_like(a)
    for k, ((l0, l1), (cum, ein, wout, keep)) in enumerate(zip(chunks, vecs)):
        m = l1 - l0
        xs, d, bs, cs, dys = x[l0:l1], dt[l0:l1], b[l0:l1], c[l0:l1], dy[l0:l1]
        causal = torch.tril(torch.ones(m, m, dtype=torch.bool))
        seg = (cum[:, None] - cum[None, :]).masked_fill(~causal[..., None], -torch.inf).exp()
        g = cs @ bs.T                                                    # (i, j)
        w = g[..., None] * seg                                           # (i, j, H)
        dyu = torch.einsum("ihp,jhp->ijh", dys, xs) * d[None]             # dy_i . u_j
        v = seg * dyu
        qm = w * dyu
        s_in, s_out = r("state", states[k]), r("dstate", ds[k])
        bds = torch.einsum("jn,hpn->jhp", bs, s_out)                      # dS' B_j
        du = torch.einsum("ijh,ihp->jhp", r("w", w), dys) + wout[..., None] * bds
        carried = ein[..., None] * torch.einsum("ihp,hpn->ihn", dys, s_in)
        rv = r("v", v)
        dc[l0:l1] = torch.einsum("ijh,jn->in", rv, bs) + carried.sum(1)
        xds = torch.einsum("jhp,hpn->jhn", xs, s_out)
        db[l0:l1] = (torch.einsum("ijh,in->jn", rv, cs)
                     + torch.einsum("jh,jhn->jn", wout * d, xds))
        rdot = torch.einsum("in,ihn->ih", cs, carried)
        tdot = wout * d * torch.einsum("jn,jhn->jh", bs, xds)
        dcs = qm.sum(1) - qm.sum(0) + rdot - tdot
        dcs[-1] += tdot.sum(0) + keep * (s_out * s_in).sum((-1, -2))
        dda = dcs.flip(0).cumsum(0).flip(0)
        ddt[l0:l1] = (xs * du).sum(-1) + a * dda
        da += (d * dda).sum(0)
        dx[l0:l1] = d[..., None] * du
    return dx, ddt, da, db, dc


def bwd_rows(args64, dy, q: int = 64):
    """One JSON row per choice of the backward's operand roundings."""
    ref = chunked_bwd(*args64, dy, q, {})
    choices = [{}]
    choices += [{name: "bf16"} for name in BWD_OPERANDS]
    choices += [{name: "hi_lo" for name in BWD_OPERANDS}]
    choices += [{**{name: "hi_lo" for name in BWD_OPERANDS}, name: "bf16"}
                for name in BWD_OPERANDS]
    for modes in choices:
        got = chunked_bwd(*args64, dy, q, modes)
        row = {name: modes.get(name, "none") for name in BWD_OPERANDS}
        row["err"] = {k: scaled_err(g, w) for k, g, w in
                      zip(("dx", "ddt", "da", "db", "dc"), got, ref)}
        row["worst"] = max(row["err"].values())
        print(json.dumps(row), flush=True)


def scaled_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    out = out.to(torch.bfloat16).double()
    return ((out - ref).abs() / (1 + ref.abs())).max().item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--l", type=int, default=1024)
    ap.add_argument("--h", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--part", choices=("fwd", "bwd", "both"), default="both")
    args = ap.parse_args()
    gen = torch.Generator().manual_seed(args.seed)
    l, h, p, n = args.l, args.h, 64, 128
    x = torch.randn(1, l, h, p, generator=gen).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn(1, l, h, generator=gen)).bfloat16()
    a = (-torch.exp(0.3 * torch.randn(h, generator=gen))).bfloat16()
    b = torch.randn(1, l, n, generator=gen).bfloat16()
    c = torch.randn(1, l, n, generator=gen).bfloat16()
    dy = torch.randn(1, l, h, p, generator=gen).bfloat16()
    args64 = [t[0].double() for t in (x, dt)] + [a.double()] + [t[0].double() for t in (b, c)]
    if args.part != "fwd":
        bwd_rows(args64, dy[0].double())
    if args.part == "bwd":
        return 0
    ref_y, ref_st = (t[0].double() for t in ssd_ref(x.float(), dt.float(), a.float(),
                                                     b.float(), c.float()))
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
