#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: granite-3-2b's serving path on one GPU.

    python3 chip_smoke.py [--seed N]

Runs from the root of a checkout on a machine with one NVIDIA H100 (or
another Hopper card) and the CUDA toolkit.  It builds the port's CUDA
kernels from ``src/repro_torch/kernels/csrc/``, holds each against its
plain PyTorch version, then drives granite-3-2b at full width and full
depth (random weights from ``--seed``) through the port's entry points:
prefill, teacher-forced decode checked against the kernel-driven
forward, and the WRATH serve driver through a replica kill.  Each phase
prints one JSON line; any failed check ends the run with a nonzero exit.
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

# kernel vs plain tolerances, as tests/test_kernels.py holds the Pallas kernel
TOL = {"torch.bfloat16": 2e-2, "torch.float32": 1e-4}

# decode vs forward, per-row relative L2 error of the logits at full
# depth (40 layers).  The reference's init draws stacked weights with
# fan-in = layer count, which makes attention near-hard, so rounding
# differences grow layer by layer.  fp32 holds the algorithms to each
# other (measured 4.7e-4 max on an H100).  In bf16 the forward itself is
# 0.5-0.67 away from fp32 on the same weights, and decode differs from
# the kernel-driven forward by 0.13 max (the flash kernel rounds
# unnormalised P to bf16, the decode path normalised p); 0.25 is twice that.
FP32_REL_TOL = 1e-3
BF16_REL_TOL = 0.25

SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 8, 16, 16


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


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
        within = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
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
               "causal": causal, "window": window, "max_abs_err": err, "tol": tol,
               "finite": bool(torch.isfinite(out.float()).all()), "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms, "library_max_abs_err": lib_err,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": flops / (ms * 1e-3) / 1e12, "flops": flops, "bytes": nbytes}
        emit("kernel_vs_plain", **row)
        check(within and row["finite"], f"flash_attention {name}: max abs err {err} > {tol}")
        results.append(row)
        del q, k, v, out, ref, lib
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


def _rel_rows(a, b):
    """Per-row relative L2 error of logits (..., V) -> (...)."""
    a, b = a.float(), b.float()
    return (a - b).norm(dim=-1) / b.norm(dim=-1)


def _path_logits(params, cfg, ids, s: int, steps: int) -> dict:
    """Prefill ``ids[:, :s]``, teacher-force ``steps`` decode steps, and
    run the forward over all ``s + steps`` tokens; returns both sets of
    logits at positions s-1 .. s+steps-1 with the timings."""
    from repro_torch.distributed.step import build_prefill_step, build_serve_step
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.models import cache_defs, forward_train, materialize
    from repro_torch.models.model import _logits
    from repro_torch.models.spec import tree_map

    b = ids.shape[0]
    prefill, serve_step = build_prefill_step(cfg), build_serve_step(cfg)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    logits, pcache = prefill(params, {"inputs": ids[:, :s]})
    torch.cuda.synchronize()
    first_prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = flash_attention.launches
    # a prefill cache of length s has no free slot: copy it into a longer one
    cache = tree_map(lambda t: t.to(cfg.cdtype) if t.is_floating_point() else t,
                     materialize(cache_defs(cfg, b, s + steps), 0, "cuda"))
    for dst, src in zip(cache["segments"], pcache["segments"]):
        for u in dst:
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
    launches = flash_attention.launches
    profiles = {
        "prefill": device_profile(lambda: prefill(params, {"inputs": ids[:, :s]})),
        # one more step on the full cache: it wraps onto slot 0 (timing only)
        "decode_step": device_profile(
            lambda: serve_step(params, cache, {"inputs": ids[:, s:s + 1]})),
    }
    del cache
    h, _, _ = forward_train(params, {"inputs": ids}, cfg)
    ref = _logits(params, h[:, s - 1:], cfg)
    prefill_ms = statistics.median(
        cuda_ms(lambda: prefill(params, {"inputs": ids[:, :s]}), iters=1, warmup=0)
        for _ in range(3))
    return {"got": torch.stack(dec, dim=1), "ref": ref, "step_ms": step_ms,
            "first_prefill_ms": first_prefill_ms, "prefill_ms": prefill_ms,
            "prefill_launches": prefill_launches, "launches": launches,
            "profiles": profiles}


def phase_prefill_decode(seed: int, steps: int = 8) -> int:
    """Returns the flash launches of the main-path run (prefill + decode)."""
    from repro_torch.configs import get_config
    from repro_torch.models import materialize, param_defs
    from repro_torch.models.spec import tree_map

    cfg = get_config("granite_3_2b")
    b, s = 4, 1024
    t0 = time.perf_counter()
    params = materialize(param_defs(cfg), seed, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s + steps),
                                        dtype=np.int32)).cuda()

    # -- the main path in bf16: counts are zeroed inside, read after -------
    bf = _path_logits(params, cfg, ids, s, steps)
    check(bf["prefill_launches"] == cfg.n_layers,
          f"prefill launched flash_attention {bf['prefill_launches']} times, "
          f"expected {cfg.n_layers}")
    check(bf["launches"] == cfg.n_layers, "decode launched flash_attention")
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
           "fp32_tol": FP32_REL_TOL, "bf16_tol": BF16_REL_TOL, "finite": finite,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit("prefill_decode", **out)
    emit("device_time", bf16=bf["profiles"], fp32=f32["profiles"])
    check(finite, "prefill/decode/forward logits are not all finite")
    check(out["fp32_rel_err_max"] <= FP32_REL_TOL,
          f"fp32 decode vs forward: max per-row relative error "
          f"{out['fp32_rel_err_max']} > {FP32_REL_TOL}")
    check(out["bf16_rel_err_max"] <= BF16_REL_TOL,
          f"bf16 decode vs forward: max per-row relative error "
          f"{out['bf16_rel_err_max']} > {BF16_REL_TOL}")
    return bf["launches"]


def phase_serve(seed: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.serve import Request, TorchDecodeBackend, WrathServeDriver

    cfg = get_config("granite_3_2b")
    backend = TorchDecodeBackend(cfg, max_batch=4, max_len=128, seed=seed, device="cuda")
    rng = np.random.default_rng(seed + 1)

    def requests():
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                   size=SERVE_PROMPT).tolist(),
                        max_new_tokens=SERVE_NEW) for i in range(SERVE_REQUESTS)]

    driver = WrathServeDriver(cfg, n_replicas=2, max_batch=4, decode=backend, max_len=128)
    reqs = requests()
    rep = driver.serve(reqs, kill_replica_at=("replica0", 5))
    emit("serve_static_kill", completed=rep.completed, failed=rep.failed,
         tokens=rep.tokens_generated, tokens_per_s=rep.tokens_per_s, wall_s=rep.wall_s,
         decode_steps=rep.decode_steps, denylisted=rep.denylisted,
         recoveries=rep.recoveries)
    check(rep.completed == SERVE_REQUESTS and rep.failed == 0,
          f"static serve completed {rep.completed}/{SERVE_REQUESTS}")
    check(all(len(r.generated) == SERVE_NEW for r in reqs), "a request lost tokens")
    check("replica0" in rep.denylisted, "replica0 was not denylisted")
    check(bool(rep.recoveries), "no recovery was recorded")

    with WrathServeDriver(cfg, n_replicas=2, max_batch=4, decode=backend,
                          max_len=128) as cont:
        reqs = requests()
        rep = cont.serve_continuous(reqs, horizon=300.0)
    emit("serve_continuous", completed=rep.completed, failed=rep.failed,
         tokens=rep.tokens_generated, tokens_per_s=rep.tokens_per_s,
         requests_per_s=rep.requests_per_s, p50_s=rep.p50_s, p99_s=rep.p99_s,
         wall_s=rep.wall_s, decode_steps=rep.decode_steps)
    check(rep.completed == SERVE_REQUESTS and rep.failed == 0,
          f"continuous serve completed {rep.completed}/{SERVE_REQUESTS}")


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

    # -- 3. kernel vs plain -------------------------------------------------
    cases = phase_kernel_cases(args.seed)

    # -- 4. prefill + decode at full width, 5. serve --------------------------
    main_path_launches = phase_prefill_decode(args.seed)
    phase_serve(args.seed)

    # -- 6. the kernel table ------------------------------------------------
    g = next(c for c in cases if c["case"] == "granite_prefill")
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "launches": main_path_launches,
        "max_abs_err": g["max_abs_err"], "ms": g["ms"], "plain_ms": g["plain_ms"],
        "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
        "library_ms": g["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
