#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: its serving paths on one GPU.

    python3 chip_smoke.py [--seed N]

Runs from the root of a checkout on a machine with one NVIDIA H100 (or
another Hopper card) and the CUDA toolkit.  It builds the port's CUDA
kernels from ``src/repro_torch/kernels/csrc/``, holds each against its
plain PyTorch version, then drives each ported model at full width and
full depth (random weights from ``--seed``) through the port's entry
points: granite-3-2b (flash attention) and mamba2-780m (the SSD scan).
For each: prefill, teacher-forced decode checked against the
kernel-driven forward, and the WRATH serve driver through a replica
kill.  Each phase prints one JSON line; any failed check ends the run
with a nonzero exit.
The line before the last is the kernel table
(``{"kernels": [...]}``), the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Without a CUDA device, or run outside the repository, it exits nonzero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 outside them, HBM
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
PEAK_BYTES_S = 3.35e12

# kernel vs plain tolerances, as tests/test_kernels.py holds the Pallas kernels
# (allclose with rtol = atol = tol, i.e. max |out - ref| / (1 + |ref|) <= tol)
TOL = {"torch.bfloat16": 2e-2, "torch.float32": 1e-4}
SSD_TOL = {"torch.bfloat16": 5e-2, "torch.float32": 2e-3}
# the SSD kernel at chunk 64 against itself at chunk 128, same inputs and
# the same scaled measure: both carry fp32 and differ only in the order of
# their sums and in the two final roundings to bf16 (2^-8 relative each)
CHUNK_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-5}

ARCHS = ("granite_3_2b", "mamba2_780m")

# decode vs forward, per-row relative L2 error of the logits at full
# depth.  The reference's init draws stacked weights with fan-in = layer
# count, so rounding differences grow layer by layer.  fp32 holds the
# algorithms to each other (granite: 4.7e-4 max measured on an H100).
# granite-3-2b (40 layers): attention is near-hard, the bf16 forward is
# 0.5-0.67 away from fp32 on the same weights, and decode differs from
# the kernel-driven forward by 0.13 max (the flash kernel rounds
# unnormalised P to bf16, the decode path normalised p); 0.25 is twice that.
# mamba2-780m (48 layers, 128 decode steps): fp32 1.3e-4 max.  In bf16,
# decode drifts from the kernel-driven forward to 0.44 max (0.08 at the
# first decode step, ~0.4 from the tenth on): every step compounds the
# rounding of 48 layers' recurrent states.  The bf16 forward is itself
# 0.54 away from the fp32 forward on the same weights, so at this depth
# any bf16 rounding difference reads ~0.4-0.5 and no tighter limit
# separates a fault from rounding; 0.9 is twice the measured figure.  What
# holds bf16 decode is the first layer alone (DEPTH1_BF16_REL_TOL): there
# it is 9.3e-3 from the forward with the SSD state in bf16 and 6.7e-3
# with it in fp32, so the state's rounding is not the main part.
FP32_REL_TOL = 1e-3
BF16_REL_TOL = {"granite_3_2b": 0.25, "mamba2_780m": 0.9}
# mamba2-780m cut to its first layer (same weights), bf16 decode vs
# forward over 128 steps: twice the 9.3e-3 measured on an H100
DEPTH1_BF16_REL_TOL = 0.02

SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 8, 16, 16


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def scaled_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (1 + |ref|): allclose(rtol=atol=tol) holds iff
    this is <= tol.  NaN if either holds a NaN."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() / (1 + ref.abs())).max().item()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b: int, s: int, h: int, kv: int, d: int, dtype, causal: bool,
                    window: int) -> tuple[float, str, float, float]:
    """(bound ms, bound_by, flops, bytes) for the unmasked pairs this input has."""
    pairs = 0
    for q in range(s):
        lo = max(0, q - window + 1) if window else 0
        hi = q + 1 if causal else s
        pairs += max(hi - lo, 0)
    flops = 4.0 * b * h * d * pairs                    # q.k and p.v, 2 FLOPs per MAC
    es = 2 if dtype == "torch.bfloat16" else 4
    nbytes = float(es * (2 * b * s * h * d + 2 * b * s * kv * d))   # q, o, k, v
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            flops, nbytes)


def phase_kernel_cases(seed: int) -> list[dict]:
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [  # (name, B, S, H, KV, D, dtype, causal, window)
        ("granite_prefill", 4, 1024, 32, 8, 64, torch.bfloat16, True, 0),
        ("granite_prefill_s2048", 4, 2048, 32, 8, 64, torch.bfloat16, True, 0),
        ("ragged_s1000", 4, 1000, 32, 8, 64, torch.bfloat16, True, 0),
        ("window256", 4, 1024, 32, 8, 64, torch.bfloat16, True, 256),
        ("noncausal", 4, 1024, 32, 8, 64, torch.bfloat16, False, 0),
        ("fp32", 4, 1024, 32, 8, 64, torch.float32, True, 0),
        ("d128", 4, 1024, 32, 8, 128, torch.bfloat16, True, 0),
        ("short_s100", 4, 100, 32, 8, 64, torch.bfloat16, True, 0),   # one partial q tile
    ]
    results = []
    for name, b, s, h, kv, d, dtype, causal, window in cases:
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(b, s, kv, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, s, kv, d, generator=gen, device="cuda").to(dtype)
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = TOL[str(dtype)]
        err = (out.float() - ref.float()).abs().max().item()
        scaled = scaled_err(out, ref)
        # the yardstick: one PyTorch call computing the same function
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = None
        if window:
            pos = torch.arange(s, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        lib_kw = dict(attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)
        lib = F.scaled_dot_product_attention(qt, kt, vt, **lib_kw).transpose(1, 2)
        lib_err = (lib.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal, window=window))
        plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=causal, window=window),
                           iters=5, warmup=1)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib_kw))
        bound_ms, bound_by, flops, nbytes = attention_bound(b, s, h, kv, d, str(dtype),
                                                            causal, window)
        row = {"case": name, "shape": [b, s, h, kv, d], "dtype": str(dtype),
               "causal": causal, "window": window, "max_abs_err": err,
               "ref_abs_max": ref.float().abs().max().item(), "max_scaled_err": scaled,
               "tol": tol, "finite": bool(torch.isfinite(out.float()).all()), "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms, "library_max_abs_err": lib_err,
               "bound_ms": bound_ms, "bound_by": bound_by, "bound_frac": bound_ms / ms,
               "vs_library": ms / library_ms,
               "tflops": flops / (ms * 1e-3) / 1e12, "flops": flops, "bytes": nbytes}
        emit("kernel_vs_plain", **row)
        check(scaled <= tol and row["finite"],
              f"flash_attention {name}: max |out - ref| / (1 + |ref|) = {scaled} > {tol}")
        results.append(row)
        del q, k, v, out, ref, lib
        torch.cuda.empty_cache()
    return results


def ssd_bound(b: int, l: int, h: int, p: int, n: int, q: int, dtype,
              a_dtype) -> tuple[float, str, float, float]:
    """(bound ms, bound_by, flops, bytes) of one SSD scan on these inputs.

    FLOPs count what the function needs, 2 per MAC, chunk by chunk (the
    last one may be short): C B^T on the causal pairs only, once per
    (batch, chunk) since all heads share one B/C group; per head the
    decay tile times x dt on the same pairs (P MACs a pair), C . state
    (P N MACs a step; none in the first chunk, whose carried state is zero)
    and the state update (P N MACs a step).  Bytes: x, dt, a, b, c read
    once, y and the final state written once."""
    pairs = steps = carried = 0
    for l0 in range(0, l, q):
        qc = min(q, l - l0)
        pairs += qc * (qc + 1) // 2
        steps += qc
        carried += qc if l0 else 0
    flops = 2.0 * b * (pairs * n + h * (pairs * p + (carried + steps) * p * n))
    es = 2 if dtype == "torch.bfloat16" else 4
    a_es = 2 if a_dtype == "torch.bfloat16" else 4
    nbytes = float(es * (2 * b * l * h * p + 2 * b * l * n + b * l * h + b * h * p * n)
                   + a_es * h)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            flops, nbytes)


def phase_ssd_cases(seed: int) -> list[dict]:
    """The SSD kernel against ssd_ref at mamba2-780m's head shape (P 64,
    N 128, 48 heads), inputs drawn as tests/test_kernels.py draws them."""
    from repro_torch.kernels.ops import ssd_scan
    from repro_torch.kernels.ref import ssd_ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [  # (name, B, L, H, Q, dtype); chunk64 reuses mamba2_prefill's inputs
        ("mamba2_prefill", 4, 1024, 48, 128, torch.bfloat16),
        ("mamba2_prefill_l2048", 4, 2048, 48, 128, torch.bfloat16),
        ("ragged_l1000", 4, 1000, 48, 128, torch.bfloat16),
        ("chunk64", 4, 1024, 48, 64, torch.bfloat16),
        ("fp32", 4, 1024, 48, 128, torch.float32),
        # x, B and C as the model passes them: views of one conv output
        # (B, L, H P + 2 N), read in place through tensor maps
        ("model_views", 4, 1024, 48, 128, torch.bfloat16),
    ]
    p, n = 64, 128
    results, base = [], None      # base: mamba2_prefill's inputs and output
    for name, b, l, h, q, dtype in cases:
        if name == "chunk64":
            (x, dt, a, bm, cm), y128 = base
        elif name == "model_views":
            conv = torch.randn(b, l, h * p + 2 * n, generator=gen, device="cuda").to(dtype)
            x = conv[..., :h * p].reshape(b, l, h, p)
            bm, cm = conv[..., h * p:h * p + n], conv[..., h * p + n:]
            check(not x.is_contiguous() and not bm.is_contiguous() and not cm.is_contiguous(),
                  "model_views: x, B and C must be views of the conv output")
            dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).to(dtype)
            a = (-torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))).to(dtype)
        else:
            x = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype)
            dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).to(dtype)
            a = (-torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))).to(dtype)
            bm = torch.randn(b, l, n, generator=gen, device="cuda").to(dtype)
            cm = torch.randn(b, l, n, generator=gen, device="cuda").to(dtype)
        y, st = ssd_scan(x, dt, a, bm, cm, chunk=q)
        torch.cuda.synchronize()
        ref_y, ref_st = ssd_ref(x, dt, a, bm, cm)
        torch.cuda.synchronize()
        tol = SSD_TOL[str(dtype)]
        err = max((y.float() - ref_y.float()).abs().max().item(),
                  (st.float() - ref_st.float()).abs().max().item())
        scaled = max(scaled_err(y, ref_y), scaled_err(st, ref_st))
        row = {"case": name, "shape": [b, l, h, p, n], "chunk": q, "dtype": str(dtype),
               "max_abs_err": err,
               "ref_abs_max": max(ref_y.float().abs().max().item(),
                                  ref_st.float().abs().max().item()),
               "max_scaled_err": scaled, "tol": tol,
               "finite": bool(torch.isfinite(y.float()).all()
                              and torch.isfinite(st.float()).all())}
        if name == "chunk64":     # the chunk changes the order of sums, not the function
            row.update(vs_chunk128_max_abs_diff=(y.float() - y128.float()).abs().max().item(),
                       vs_chunk128_max_scaled_diff=scaled_err(y, y128),
                       vs_chunk128_tol=CHUNK_TOL[str(dtype)])
        row["ms"] = cuda_ms(lambda: ssd_scan(x, dt, a, bm, cm, chunk=q))
        row["plain_ms"] = cuda_ms(lambda: ssd_ref(x, dt, a, bm, cm), iters=2, warmup=1)
        row["library_ms"] = None   # no single PyTorch call computes the SSD scan
        bound_ms, bound_by, flops, nbytes = ssd_bound(b, l, h, p, n, q, str(dtype),
                                                      str(a.dtype))
        row.update(bound_ms=bound_ms, bound_by=bound_by, bound_frac=bound_ms / row["ms"],
                   flops=flops, bytes=nbytes, tflops=flops / (row["ms"] * 1e-3) / 1e12,
                   gbytes_s=nbytes / (row["ms"] * 1e-3) / 1e9)
        emit("ssd_kernel_vs_plain", **row)
        check(scaled <= tol and row["finite"],
              f"ssd_scan {name}: max |out - ref| / (1 + |ref|) = {scaled} > {tol}")
        if name == "chunk64":
            check(row["vs_chunk128_max_scaled_diff"] <= row["vs_chunk128_tol"],
                  f"ssd_scan chunk 64 vs chunk 128: max scaled difference "
                  f"{row['vs_chunk128_max_scaled_diff']} > {row['vs_chunk128_tol']}")
        results.append(row)
        if name == "mamba2_prefill":
            base = ((x, dt, a, bm, cm), y)
        del ref_y, ref_st
    del base, x, dt, a, bm, cm, y, st
    torch.cuda.empty_cache()
    return results


def device_profile(fn) -> dict:
    """Device busy time of one call (kernel time summed by torch.profiler)
    and its top kernels; the wall time is taken without the profiler."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernel events only: the aten ops that launch them repeat their time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernels": sum(e.count for e in events),
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top]}


def counters() -> dict:
    """The kernel wrappers whose ``launches`` show what a path ran."""
    from repro_torch.kernels.ops import flash_attention, ssd_scan
    return {"flash_attention": flash_attention, "ssd_scan": ssd_scan}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in counters().items()}


def _rel_rows(a, b):
    """Per-row relative L2 error of logits (..., V) -> (...)."""
    a, b = a.float(), b.float()
    return (a - b).norm(dim=-1) / b.norm(dim=-1)


def _path_logits(params, cfg, ids, s: int, steps: int, *, state_dtype=None,
                 timed: bool = True) -> dict:
    """Prefill ``ids[:, :s]``, teacher-force ``steps`` decode steps, and
    run the forward over all ``s + steps`` tokens; returns both sets of
    logits at positions s-1 .. s+steps-1 with (if ``timed``) the timings
    and device profiles.  ``state_dtype`` recasts the SSD state that the
    prefill hands to decode."""
    from repro_torch.distributed.step import build_prefill_step, build_serve_step
    from repro_torch.models import cache_defs, forward_train, materialize
    from repro_torch.models.model import _logits
    from repro_torch.models.spec import tree_map

    b = ids.shape[0]
    prefill, serve_step = build_prefill_step(cfg), build_serve_step(cfg)
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits, pcache = prefill(params, {"inputs": ids[:, :s]})
    torch.cuda.synchronize()
    first_prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = launch_counts()
    # an attention cache of length s has no free slot: copy it into a
    # longer one; an SSD prefill cache (conv, state) is the decode cache
    cache = tree_map(lambda t: t.to(cfg.cdtype) if t.is_floating_point() else t,
                     materialize(cache_defs(cfg, b, s + steps), 0, "cuda"))
    for dst, src in zip(cache["segments"], pcache["segments"]):
        for u in dst:
            if "ssd" in dst[u]:
                st = src[u]["ssd"]["state"]
                dst[u]["ssd"] = {"conv": src[u]["ssd"]["conv"],
                                 "state": st.to(state_dtype) if state_dtype else st}
                continue
            dst[u]["attn"]["k"][:, :, :s].copy_(src[u]["attn"]["k"])
            dst[u]["attn"]["v"][:, :, :s].copy_(src[u]["attn"]["v"])
            dst[u]["attn"]["len"].copy_(src[u]["attn"]["len"])
    del pcache
    dec, step_ms = [logits[:, 0]], []
    for t in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = serve_step(params, cache, {"inputs": ids[:, s + t:s + t + 1]})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        dec.append(lg[:, 0])
    launches = launch_counts()
    out = {"prefill_launches": prefill_launches, "launches": launches}
    if timed:
        out["profiles"] = {
            "prefill": device_profile(lambda: prefill(params, {"inputs": ids[:, :s]})),
            # one more step on the full cache (an attention ring buffer wraps
            # onto slot 0; timing only)
            "decode_step": device_profile(
                lambda: serve_step(params, cache, {"inputs": ids[:, s:s + 1]})),
        }
    del cache
    h, _, _ = forward_train(params, {"inputs": ids}, cfg)
    out.update(got=torch.stack(dec, dim=1), ref=_logits(params, h[:, s - 1:], cfg))
    if timed:
        prefill_ms = statistics.median(
            cuda_ms(lambda: prefill(params, {"inputs": ids[:, :s]}), iters=1, warmup=0)
            for _ in range(3))
        out.update(step_ms=step_ms, first_prefill_ms=first_prefill_ms, prefill_ms=prefill_ms)
    return out


def ssd_state_readings(params, cfg, ids, s: int, steps: int) -> dict:
    """Decode vs the kernel-driven forward, bf16, on the model cut to its
    first layer (the same weights): once with the SSD state as the
    reference's decode keeps it (bf16, rounded at every step), once with it
    widened to fp32 (the step then promotes what follows it to fp32, as the
    reference's would).  Their gap is what the bf16 state costs before
    depth amplifies it."""
    from repro_torch.models.spec import tree_map

    seg, = params["segments"]
    params1 = {**params, "segments": [tree_map(lambda t: t[:1], seg)]}
    cfg1 = cfg.scaled(n_layers=1)
    out = {}
    for name, state_dtype in (("bf16_state", None), ("fp32_state", torch.float32)):
        r = _path_logits(params1, cfg1, ids, s, steps, state_dtype=state_dtype, timed=False)
        rel = _rel_rows(r["got"], r["ref"])
        out[name] = {"rel_err_max": rel.max().item(),
                     "rel_err_by_pos": rel.max(dim=0).values.tolist()}
    return out


def expected_launches(cfg) -> dict[str, int]:
    """Kernel launches of one prefill: one per attention or SSD layer."""
    mixers = [m for m, _ in cfg.block_kinds()]
    return {"flash_attention": mixers.count("attn"), "ssd_scan": mixers.count("ssd")}


def phase_prefill_decode(arch: str, seed: int) -> dict[str, int]:
    """Returns the kernel launches of the main-path run (prefill + decode)."""
    from repro_torch.configs import get_config
    from repro_torch.models import materialize, param_defs
    from repro_torch.models.spec import tree_map

    cfg = get_config(arch)
    b, s = 4, 1024
    # the forward over prompt + decoded tokens must keep the SSD scan's
    # L % chunk == 0 (the reference asserts it), so an SSD model decodes a chunk
    steps = cfg.ssm.chunk if cfg.ssm else 8
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = materialize(param_defs(cfg), seed, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s + steps),
                                        dtype=np.int32)).cuda()

    # -- the main path in bf16: counts are zeroed inside, read after -------
    want = expected_launches(cfg)
    bf = _path_logits(params, cfg, ids, s, steps)
    check(bf["prefill_launches"] == want,
          f"{arch}: prefill launched {bf['prefill_launches']}, expected {want}")
    check(bf["launches"] == want, f"{arch}: decode launched a kernel: {bf['launches']}")
    depth1 = ssd_state_readings(params, cfg, ids, s, steps) if cfg.ssm else None
    # -- the same weights and tokens in fp32: the algorithms must agree ----
    cfg32 = cfg.scaled(compute_dtype="float32")
    params32 = tree_map(lambda t: t.float() if t.is_floating_point() else t, params)
    del params
    f32 = _path_logits(params32, cfg32, ids, s, steps)
    del params32
    torch.cuda.empty_cache()

    rel_bf = _rel_rows(bf["got"], bf["ref"])           # (B, steps + 1)
    rel_32 = _rel_rows(f32["got"], f32["ref"])
    rel_bf_vs_32 = _rel_rows(bf["ref"], f32["ref"])    # bf16 forward vs fp32 forward
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (bf["got"], bf["ref"], f32["got"], f32["ref"]))
    bf16_tol = BF16_REL_TOL[arch]
    out = {"config": cfg.name, "batch": b, "prompt": s, "decode_steps": steps,
           "init_s": init_s, "prefill_launches": bf["prefill_launches"],
           "first_prefill_ms": bf["first_prefill_ms"], "prefill_ms": bf["prefill_ms"],
           "decode_step_ms": statistics.median(bf["step_ms"]),
           "decode_step_ms_all": bf["step_ms"],
           "fp32_prefill_ms": f32["prefill_ms"],
           "fp32_decode_step_ms": statistics.median(f32["step_ms"]),
           "bf16_rel_err_max": rel_bf.max().item(),
           "bf16_rel_err_by_pos": rel_bf.max(dim=0).values.tolist(),
           "bf16_top1_agreement": (bf["got"].argmax(-1) == bf["ref"].argmax(-1))
           .float().mean().item(),
           "fp32_rel_err_max": rel_32.max().item(),
           "fp32_rel_err_by_pos": rel_32.max(dim=0).values.tolist(),
           "bf16_forward_vs_fp32_forward_max": rel_bf_vs_32.max().item(),
           "bf16_forward_vs_fp32_forward_by_pos": rel_bf_vs_32.max(dim=0).values.tolist(),
           "fp32_tol": FP32_REL_TOL, "bf16_tol": bf16_tol, "finite": finite,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if depth1:
        out.update(depth1=depth1, depth1_bf16_tol=DEPTH1_BF16_REL_TOL)
    emit("prefill_decode", **out)
    emit("device_time", config=cfg.name, bf16=bf["profiles"], fp32=f32["profiles"])
    check(finite, f"{arch}: prefill/decode/forward logits are not all finite")
    check(out["fp32_rel_err_max"] <= FP32_REL_TOL,
          f"{arch}: fp32 decode vs forward: max per-row relative error "
          f"{out['fp32_rel_err_max']} > {FP32_REL_TOL}")
    check(out["bf16_rel_err_max"] <= bf16_tol,
          f"{arch}: bf16 decode vs forward: max per-row relative error "
          f"{out['bf16_rel_err_max']} > {bf16_tol}")
    if depth1:
        got = depth1["bf16_state"]["rel_err_max"]
        check(got <= DEPTH1_BF16_REL_TOL, f"{arch}: bf16 decode vs forward at depth 1: "
              f"max per-row relative error {got} > {DEPTH1_BF16_REL_TOL}")
    return bf["launches"]


def phase_serve(arch: str, seed: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.serve import Request, TorchDecodeBackend, WrathServeDriver

    cfg = get_config(arch)
    backend = TorchDecodeBackend(cfg, max_batch=4, max_len=128, seed=seed, device="cuda")
    rng = np.random.default_rng(seed + 1)

    def requests():
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                   size=SERVE_PROMPT).tolist(),
                        max_new_tokens=SERVE_NEW) for i in range(SERVE_REQUESTS)]

    driver = WrathServeDriver(cfg, n_replicas=2, max_batch=4, decode=backend, max_len=128)
    reqs = requests()
    rep = driver.serve(reqs, kill_replica_at=("replica0", 5))
    emit("serve_static_kill", config=cfg.name, completed=rep.completed, failed=rep.failed,
         tokens=rep.tokens_generated, tokens_per_s=rep.tokens_per_s, wall_s=rep.wall_s,
         decode_steps=rep.decode_steps, denylisted=rep.denylisted,
         recoveries=rep.recoveries)
    check(rep.completed == SERVE_REQUESTS and rep.failed == 0,
          f"{arch}: static serve completed {rep.completed}/{SERVE_REQUESTS}")
    check(all(len(r.generated) == SERVE_NEW for r in reqs), f"{arch}: a request lost tokens")
    check("replica0" in rep.denylisted, f"{arch}: replica0 was not denylisted")
    check(bool(rep.recoveries), f"{arch}: no recovery was recorded")

    with WrathServeDriver(cfg, n_replicas=2, max_batch=4, decode=backend,
                          max_len=128) as cont:
        reqs = requests()
        rep = cont.serve_continuous(reqs, horizon=300.0)
    emit("serve_continuous", config=cfg.name, completed=rep.completed, failed=rep.failed,
         tokens=rep.tokens_generated, tokens_per_s=rep.tokens_per_s,
         requests_per_s=rep.requests_per_s, p50_s=rep.p50_s, p99_s=rep.p99_s,
         wall_s=rep.wall_s, decode_steps=rep.decode_steps)
    check(rep.completed == SERVE_REQUESTS and rep.failed == 0,
          f"{arch}: continuous serve completed {rep.completed}/{SERVE_REQUESTS}")
    del backend, driver
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    # -- 1. device ----------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         kernels={k: {"seconds": v["seconds"], "built": v["built"],
                      "ptxas": [ln.strip() for ln in v["log"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for k, v in built.items()})

    # -- 3. kernels vs plain -------------------------------------------------
    flash_cases = phase_kernel_cases(args.seed)
    ssd_cases = phase_ssd_cases(args.seed)

    # -- 4. prefill + decode at full width and depth, 5. serve, per path -----
    # each path's counts are zeroed just before its run and read just after
    path_launches = {}
    for arch in ARCHS:
        path_launches[arch] = phase_prefill_decode(arch, args.seed)
        phase_serve(arch, args.seed)

    # -- 6. the kernel table ------------------------------------------------
    rows = [("flash_attention", "granite_3_2b", flash_cases, "granite_prefill",
             "src/repro/kernels/flash_attention.py:82"),
            ("ssd_scan", "mamba2_780m", ssd_cases, "mamba2_prefill",
             "src/repro/kernels/ssd_scan.py:80")]
    table = []
    for name, arch, cases, case, replaces in rows:
        c = next(c for c in cases if c["case"] == case)
        table.append({"name": name, "route": "cuda",
                      "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                      "replaces": replaces, "launches": path_launches[arch][name],
                      "max_abs_err": c["max_abs_err"], "ref_abs_max": c["ref_abs_max"],
                      "max_scaled_err": c["max_scaled_err"], "tol": c["tol"], "ms": c["ms"],
                      "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                      "bound_by": c["bound_by"], "bound_frac": c["bound_ms"] / c["ms"],
                      "library_ms": c["library_ms"],
                      "vs_library": c["ms"] / c["library_ms"] if c["library_ms"] else None})
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
