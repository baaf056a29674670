#!/usr/bin/env python3
"""Time the port's kernels of several checkouts in turns on one GPU.

    python3 tools/flash_ab.py SRC [SRC ...] [--shapes granite,s2048,d128] [--rounds 2]
    python3 tools/flash_ab.py SRC [SRC ...] --shapes mla,mla_b1,mla_s1000,granite,d128
    python3 tools/flash_ab.py SRC [SRC ...] --shapes granite_bwd,s2048_bwd,d128_bwd
    python3 tools/flash_ab.py SRC [SRC ...] --shapes d256_bwd,d256_bwd_b1,mla_bwd,mla_bwd_b1
    python3 tools/flash_ab.py SRC [SRC ...] --shapes mamba2,mamba2_b2,mamba2_l2048,model_views
    python3 tools/flash_ab.py SRC [SRC ...] --shapes ssd_bwd,ssd_bwd_b2
    python3 tools/flash_ab.py SRC [SRC ...] --shapes granite_fp16,d128_fp16,granite_bwd_fp16
    python3 tools/flash_ab.py SRC [SRC ...] --shapes fp32_bwd,fp32_d128_bwd,d256_bwd_fp32
    python3 tools/flash_ab.py SRC [SRC ...] --shapes granite_fp32,mla_fp32_b4,d256_fp32,d80_fp32
    python3 tools/flash_ab.py SRC [SRC ...] --shapes d20_fp16,d20_bf16,d20_bwd_fp16,d20_bwd_bf16
    python3 tools/flash_ab.py SRC [SRC ...] --shapes smoke_d16,smoke_mla,smoke_d16_bwd,smoke_mla_bwd

Each SRC is the ``src`` directory of a checkout of this repository.  All
checkouts' kernels are built first, in parallel.  Then every round runs
each checkout once in a process of its own (the checkouts share package
names), in the order given and then reversed, so two versions run as
A B B A.  A run times each shape's kernel with CUDA events on bf16
inputs (fp16 for the ``*_fp16`` shapes, fp32 for the ``*fp32*`` ones) made
from a seed:
``repro_torch.kernels.ops.flash_attention``
(causal), with its kernels' device ms and names from the profiler and
its bound (``roofline/cost.py:attention_bound``), beside one
``scaled_dot_product_attention`` call on the same inputs; the backward launcher ``flash_attention_bwd_cuda`` from the
forward's (o, lse) beside SDPA's backward (``*_bwd`` shapes), with the
device time of each of its CUDA kernels from the profiler (``dq_ms``,
``dkdv_ms``, and ``sum_ms`` for the pass that sums the dK/dV kernel's
head shares) and its bound (``attention_bwd_bound``); both directions
give the staged route's copies' device ms a call (``stage_ms``); or
``repro_torch.kernels.ops.ssd_scan`` (no PyTorch call computes the SSD
scan); or the SSD backward launcher ``ssd_scan_bwd_cuda`` (``ssd_bwd*``
shapes), each with its kernels' device ms from the profiler; the
``ssd_launch`` shape gives the two SSD wrappers' host time a call.  It reports the kernel's max |out - ref| / (1 + |ref|) against
its checkout's plain version (``flash_attention_ref``, for the backward
autograd of it in fp32, ``ssd_ref``, or ``ssd_bwd_ref``).  The ``launch`` shape also
reports the wrapper's host time a call (``host_us``) and, where the
checkout has an autotune cache, the tile lookup's alone (``lookup_us``):
each the best of seven host-clock runs of 500 calls, which filters the
bursts of a shared host.  Prints one JSON line per run,
then the median of each number per checkout and shape.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

SHAPES = {  # flash: (B, S, H, KV, D, Dv, window): granite-3-2b's prefill, a
    # longer prompt, the other head dim, a sliding window
    "granite": ("flash", (4, 1024, 32, 8, 64, 64, 0)),
    "s2048": ("flash", (4, 2048, 32, 8, 64, 64, 0)),
    "d128": ("flash", (4, 1024, 32, 8, 128, 128, 0)),
    "window256": ("flash", (4, 1024, 32, 8, 64, 64, 256)),
    # deepseek-v3's MLA prefill (q/k 192, v 128, 128 heads) at B 4, at the
    # train step's launch shape B 1, and over a ragged length
    "mla": ("flash", (4, 1024, 128, 128, 192, 128, 0)),
    "mla_b1": ("flash", (1, 1024, 128, 128, 192, 128, 0)),
    "mla_s1000": ("flash", (4, 1000, 128, 128, 192, 128, 0)),
    # one 128-key tile of one head: a kernel of a few µs, so the time a call
    # is the wrapper's host time (checks, the tile lookup, the launch)
    "launch": ("host", (1, 128, 1, 1, 64, 64, 0)),
    # the backward, (B, S, H, KV, D, Dv, window): granite-3-2b's train step
    # first, then the forward's other shapes; recurrentgemma-9b's windowed
    # MQA layer and deepseek-v3's MLA (q/k 192, v 128), each at B 2 and at
    # the train step's own launch shape, B 1 (four microbatches of B 4)
    "granite_bwd": ("flash_bwd", (4, 1024, 32, 8, 64, 64, 0)),
    "s2048_bwd": ("flash_bwd", (4, 2048, 32, 8, 64, 64, 0)),
    "d128_bwd": ("flash_bwd", (4, 1024, 32, 8, 128, 128, 0)),
    "window256_bwd": ("flash_bwd", (4, 1024, 32, 8, 64, 64, 256)),
    "d256_bwd": ("flash_bwd", (2, 2560, 16, 1, 256, 256, 2048)),
    "d256_bwd_b1": ("flash_bwd", (1, 2560, 16, 1, 256, 256, 2048)),
    "mla_bwd": ("flash_bwd", (2, 1024, 128, 128, 192, 128, 0)),
    "mla_bwd_b1": ("flash_bwd", (1, 1024, 128, 128, 192, 128, 0)),
    # fp16 on the wgmma kernels, forward and backward: granite's, D 128's,
    # recurrentgemma's and MLA's, and phi-2's D 80 (the (128, 128) bucket)
    "granite_fp16": ("flash", (4, 1024, 32, 8, 64, 64, 0, "float16")),
    "d128_fp16": ("flash", (4, 1024, 32, 8, 128, 128, 0, "float16")),
    "mla_fp16": ("flash", (4, 1024, 128, 128, 192, 128, 0, "float16")),
    "d80_fp16": ("flash", (4, 1024, 32, 32, 80, 80, 0, "float16")),
    "granite_bwd_fp16": ("flash_bwd", (4, 1024, 32, 8, 64, 64, 0, "float16")),
    "d128_bwd_fp16": ("flash_bwd", (4, 1024, 32, 8, 128, 128, 0, "float16")),
    "d256_bwd_fp16": ("flash_bwd", (2, 2560, 16, 1, 256, 256, 2048, "float16")),
    "mla_bwd_fp16": ("flash_bwd", (2, 1024, 128, 128, 192, 128, 0, "float16")),
    "d80_bwd_fp16": ("flash_bwd", (4, 1024, 32, 32, 80, 80, 0, "float16")),
    # fp32: the backward on its register-tiled kernels at chip_smoke.py's
    # flash_bwd_vs_plain fp32 cases (granite's, D 128's, recurrentgemma's
    # one kv head with its window, MLA's) and phi-2's D 80; the forward on
    # its register-tiled kernel at three of them, and at chip_smoke.py's
    # full-width fp32 cases: MLA at B 4, recurrentgemma-9b's windowed MQA
    # layer and D 128
    "fp32_bwd": ("flash_bwd", (4, 1024, 32, 8, 64, 64, 0, "float32")),
    "fp32_d128_bwd": ("flash_bwd", (2, 512, 32, 8, 128, 128, 0, "float32")),
    "d256_bwd_fp32": ("flash_bwd", (2, 1024, 16, 1, 256, 256, 768, "float32")),
    "mla_bwd_fp32": ("flash_bwd", (1, 512, 128, 128, 192, 128, 0, "float32")),
    "d128_bwd_fp32": ("flash_bwd", (4, 1024, 32, 8, 128, 128, 0, "float32")),
    "d80_bwd_fp32": ("flash_bwd", (4, 1024, 32, 32, 80, 80, 0, "float32")),
    "granite_fp32": ("flash", (4, 1024, 32, 8, 64, 64, 0, "float32")),
    "mla_fp32": ("flash", (1, 512, 128, 128, 192, 128, 0, "float32")),
    "d80_fp32": ("flash", (4, 1024, 32, 32, 80, 80, 0, "float32")),
    "mla_fp32_b4": ("flash", (4, 1024, 128, 128, 192, 128, 0, "float32")),
    "d256_fp32": ("flash", (4, 2560, 16, 1, 256, 256, 2048, "float32")),
    "d128_fp32": ("flash", (4, 1024, 32, 8, 128, 128, 0, "float32")),
    # the staged route (a head dim that is no multiple of 8): D 20 at B 4, S
    # 1024, 32 MHA heads in fp16 and bf16, both directions
    "d20_fp16": ("flash", (4, 1024, 32, 32, 20, 20, 0, "float16")),
    "d20_bf16": ("flash", (4, 1024, 32, 32, 20, 20, 0, "bfloat16")),
    "d20_bwd_fp16": ("flash_bwd", (4, 1024, 32, 32, 20, 20, 0, "float16")),
    "d20_bwd_bf16": ("flash_bwd", (4, 1024, 32, 32, 20, 20, 0, "bfloat16")),
    # the bf16 smoke dims' SIMT kernels at chip_smoke.py's smoke cases (B 2,
    # S 64): (16, 16) over 2 kv heads, (24, 16) MHA
    "smoke_d16": ("flash", (2, 64, 4, 2, 16, 16, 0)),
    "smoke_mla": ("flash", (2, 64, 4, 4, 24, 16, 0)),
    "smoke_d16_bwd": ("flash_bwd", (2, 64, 4, 2, 16, 16, 0)),
    "smoke_mla_bwd": ("flash_bwd", (2, 64, 4, 4, 24, 16, 0)),
    # ssd: (B, L, H, chunk, views): mamba2-780m's prefill (P 64, N 128), at
    # the train step's microbatch B 2, a longer prompt, and x, B, C as views
    # of one conv output as the model passes them
    "mamba2": ("ssd", (4, 1024, 48, 128, False)),
    "mamba2_b2": ("ssd", (2, 1024, 48, 128, False)),
    "mamba2_l2048": ("ssd", (4, 2048, 48, 128, False)),
    "model_views": ("ssd", (4, 1024, 48, 128, True)),
    # the SSD backward, (B, L, H): mamba2-780m's train shape and the train
    # step's launch shape (two microbatches of B 2)
    "ssd_bwd": ("ssd_bwd", (4, 1024, 48)),
    "ssd_bwd_b2": ("ssd_bwd", (2, 1024, 48)),
    # one 64-step chunk of two heads: the SSD wrappers' host time a call,
    # forward (ops.ssd_scan) and backward (ssd_scan_bwd_cuda)
    "ssd_launch": ("ssd_host", (1, 64, 2)),
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


def scaled_err(out, ref) -> float:
    return ((out.float() - ref.float()).abs() / (1 + ref.float().abs())).max().item()


def _sdpa_kw(s: int, window: int) -> dict:
    import torch
    if not window:
        return {"is_causal": True, "enable_gqa": True}
    pos = torch.arange(s, device="cuda")
    return {"attn_mask": (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window),
            "enable_gqa": True}


def time_flash(gen, b, s, h, kv, d, dv, window, dtype="bfloat16") -> dict:
    """The forward's ms (CUDA events) and its kernels' device ms (the
    profiler) beside SDPA's ms and the bound (``roofline/cost.py``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.roofline.cost import attention_bound

    dt = getattr(torch, dtype)
    q, k = (torch.randn(b, s, n, d, generator=gen, device="cuda").to(dt) for n in (h, kv))
    v = torch.randn(b, s, kv, dv, generator=gen, device="cuda").to(dt)
    got = flash_attention(q, k, v, causal=True, window=window)
    err = scaled_err(got, flash_attention_ref(q, k, v, causal=True, window=window))
    del got
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True, window=window))
    by_kernel = kernel_device_ms(lambda: flash_attention(q, k, v, causal=True, window=window),
                                 per_call=True)
    bound_ms = attention_bound(b, s, s, h, kv, d, dv, str(dt), True, window)[0]
    return {"ms": ms, "device_ms": sum(by_kernel.values()), "bound_ms": bound_ms,
            "bound_frac": bound_ms / ms, "stage_ms": _stage_ms(by_kernel),
            "sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **_sdpa_kw(s, window))),
            "max_scaled_err": err, "kernels": sorted(by_kernel)}


def _stage_ms(by_kernel: dict[str, float]) -> float:
    """The staged route's copies (flash_stage) in a call's device ms."""
    return sum(ms for name, ms in by_kernel.items() if "flash_stage" in name)


def host_us(fn, calls: int = 500, runs: int = 7) -> float:
    """Best of ``runs`` host-clock runs of ``calls`` calls, µs a call."""
    import time
    import torch
    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return best * 1e6


def time_host(gen, b, s, h, kv, d, dv, window) -> dict:
    """``time_flash`` plus the wrapper's host time a call and, where the
    checkout consults an autotune cache, the lookup's alone."""
    import torch
    from repro_torch.kernels.ops import flash_attention

    out = time_flash(gen, b, s, h, kv, d, dv, window)
    q, k = (torch.randn(b, s, n, d, generator=gen, device="cuda").bfloat16() for n in (h, kv))
    v = torch.randn(b, s, kv, dv, generator=gen, device="cuda").bfloat16()
    out["host_us"] = host_us(lambda: flash_attention(q, k, v, causal=True, window=window))
    try:
        from repro_torch.kernels.autotune import tuned_flash_tile
    except ImportError:                     # a checkout without the autotuner
        return out
    out["lookup_us"] = host_us(lambda: tuned_flash_tile(q, k, v, causal=True, window=window))
    return out


def kernel_device_ms(fn, iters: int = 20, per_call: bool = False) -> dict[str, float]:
    """Mean device ms a launch of each CUDA kernel of ``fn`` takes, from
    torch.profiler, keyed by the kernel's name as the profiler gives it
    (each of the flash backward's kernels launches once a call).  The mean
    is over the launches the profiler recorded, which may be fewer than it
    ran.  ``per_call``: each kernel's device ms a call of ``fn`` instead (a
    kernel may launch more than once a call: the SSD backward's sums, the
    staged flash route's two copies): that mean times its launches a call,
    the nearest whole number to the records over the calls, so that a few
    dropped records do not read as a faster kernel."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / e.count
            * (max(1, round(e.count / iters)) if per_call else 1)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def time_flash_bwd(gen, b, s, h, kv, d, dv, window, dtype="bfloat16") -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.roofline.cost import attention_bwd_bound

    dt = getattr(torch, dtype)
    q, k = (torch.randn(b, s, n, d, generator=gen, device="cuda").to(dt) for n in (h, kv))
    v, do = (torch.randn(b, s, n, dv, generator=gen, device="cuda").to(dt) for n in (kv, h))
    kw = {"causal": True, "window": window}
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    grads = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(flash_attention_ref(*leaves, **kw), leaves, do.float())
    err = max(scaled_err(g, r) for g, r in zip(grads, ref))
    del leaves, ref
    lib_leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_leaves, **_sdpa_kw(s, window))
    do_t = do.transpose(1, 2)

    def bwd():
        return flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)

    by_kernel = kernel_device_ms(bwd, per_call=True)

    def part(tag: str) -> float:
        return sum(ms for name, ms in by_kernel.items() if tag in name)

    ms = cuda_ms(bwd)
    bound_ms = attention_bwd_bound(b, s, h, kv, d, str(dt), True, window, dv=dv)[0]
    return {"ms": ms, "bound_ms": bound_ms, "bound_frac": bound_ms / ms,
            "device_ms": sum(by_kernel.values()), "dq_ms": part("flash_bwd_dq"),
            "dkdv_ms": part("flash_bwd_dkdv"), "sum_ms": part("flash_bwd_sum"),
            "stage_ms": part("flash_stage"),
            "sdpa_ms": cuda_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, do_t,
                                                           retain_graph=True)),
            "max_scaled_err": err, "kernels": sorted(by_kernel)}


def time_ssd(gen, b, l, h, chunk, views) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ops import ssd_scan
    from repro_torch.kernels.ref import ssd_ref

    p, n = 64, 128
    if views:
        conv = torch.randn(b, l, h * p + 2 * n, generator=gen, device="cuda").bfloat16()
        x = conv[..., :h * p].reshape(b, l, h, p)
        bm, cm = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    else:
        x = torch.randn(b, l, h, p, generator=gen, device="cuda").bfloat16()
        bm, cm = (torch.randn(b, l, n, generator=gen, device="cuda").bfloat16() for _ in "bc")
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).bfloat16()
    a = (-torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))).bfloat16()
    y, st = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    ref_y, ref_st = ssd_ref(x, dt, a, bm, cm)
    return {"ms": cuda_ms(lambda: ssd_scan(x, dt, a, bm, cm, chunk=chunk)),
            "device_ms": sum(kernel_device_ms(lambda: ssd_scan(x, dt, a, bm, cm, chunk=chunk),
                                              per_call=True).values()),
            "max_scaled_err": max(scaled_err(y, ref_y), scaled_err(st, ref_st))}


def time_ssd_bwd(gen, b, l, h) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import ssd_bwd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda

    p, n = 64, 128
    x, dy = (torch.randn(b, l, h, p, generator=gen, device="cuda").bfloat16() for _ in "xy")
    bm, cm = (torch.randn(b, l, n, generator=gen, device="cuda").bfloat16() for _ in "bc")
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).bfloat16()
    a = (-torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))).bfloat16()
    grads = ssd_scan_bwd_cuda(x, dt, a, bm, cm, dy)
    ref = ssd_bwd_ref(x, dt, a, bm, cm, dy)
    return {"ms": cuda_ms(lambda: ssd_scan_bwd_cuda(x, dt, a, bm, cm, dy), iters=20),
            "device_ms": sum(kernel_device_ms(lambda: ssd_scan_bwd_cuda(x, dt, a, bm, cm, dy),
                                              per_call=True).values()),
            "max_scaled_err": max(scaled_err(g, r) for g, r in zip(grads[:5], ref[:5]))}


def time_ssd_host(gen, b, l, h) -> dict:
    """The SSD wrappers' host time a call (best of seven runs of 500
    calls) at a shape whose kernels take a few µs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ops import ssd_scan
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda

    p, n = 64, 128
    x, dy = (torch.randn(b, l, h, p, generator=gen, device="cuda").bfloat16() for _ in "xy")
    bm, cm = (torch.randn(b, l, n, generator=gen, device="cuda").bfloat16() for _ in "bc")
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).bfloat16()
    a = (-torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))).bfloat16()
    return {"fwd_host_us": host_us(lambda: ssd_scan(x, dt, a, bm, cm, chunk=64)),
            "bwd_host_us": host_us(lambda: ssd_scan_bwd_cuda(x, dt, a, bm, cm, dy))}


def worker(src: str, shapes: list[str], seed: int) -> dict:
    sys.path.insert(0, src)
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"src": src}
    for name in shapes:
        kind, args = SHAPES[name]
        timer = {"flash": time_flash, "flash_bwd": time_flash_bwd, "ssd": time_ssd,
                 "ssd_bwd": time_ssd_bwd, "host": time_host, "ssd_host": time_ssd_host}[kind]
        out[name] = timer(gen, *args)
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
    unknown = [name for name in shapes if name not in SHAPES]
    if unknown:
        raise SystemExit(f"flash_ab: unknown shapes {unknown}; known: {sorted(SHAPES)}")
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
                            for key in rows[0] if isinstance(rows[0][key], (int, float))}
                     for name, rows in by_shape.items()}
               for src, by_shape in runs.items()}
    print(json.dumps({"median": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
