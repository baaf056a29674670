#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: its serving and training paths on one GPU.

    python3 chip_smoke.py [--seed N]

Runs from the root of a checkout on a machine with one NVIDIA H100 (or
another Hopper card) and the CUDA toolkit.  It builds the port's CUDA
kernels from ``src/repro_torch/kernels/csrc/``, holds each against its
plain PyTorch version (the flash backward against autograd of the plain
forward), then drives each ported model at full width (random weights
from ``--seed``) through the port's entry points at full depth, each with
prefill and teacher-forced decode checked against the kernel-driven
forward: granite-3-2b (flash attention), mamba2-780m (the SSD scan),
minitron-4b (flash at D 128 over padded heads), olmoe-1b-7b (flash, MoE
FFNs), seamless-m4t-medium (flash in the encoder, the decoder and its
cross-attention over the encoder frames), recurrentgemma-9b (the RG-LRU
and windowed flash at D 256, MQA) and gemma3-27b (5 windowed : 1 global
flash layers), the last two over 2560-token prompts that wrap their
ring-buffer caches; llava-next-34b (embedding inputs, flash over padded
heads), deepseek-67b (cut to 40 layers) and deepseek-v3-671b (cut to 3
dense + 2 MoE layers of 256 experts: MLA through flash at q/k dim 192,
v dim 128, its absorbed decode over the latent cache), where the whole
model does not fit the card; all but seamless also through the WRATH
serve driver with a replica kill; then
granite-3-2b's training plane: ``loss_fn`` gradients through the kernels
against the plain attention at depth 2, ``build_train_step`` at full
depth, and ``WrathTrainSupervisor`` at depth 4 through a host loss and a
NaN; last the paper's evaluation path through the port's WRATH engine
(``run_app`` → ``DataFlowKernel`` → ``FailureInjector``): fedlearn and
moldesign at the paper's scale computing on the card inside the DFK's
tasks, held to their CPU runs, with and without injected failures, and
Table IV's and fig 4's MapReduce cases; then fedlearn again on the card
under the sim plane's virtual clock (``SimHarness``), clean and with a
node lost mid-round, its trace equal to the CPU run's byte for byte, and
the sim plane's host checks (chaos and serve campaigns, the chaos corpus,
the analysis CLI's gates); then ``autotune``: the autotuner sweeps every
flash kv tile and SSD chunk tile the kernels are built for at the model
paths' shapes into a fresh cache, each tile held to the plain version,
and ``ops.flash_attention`` / ``ops.ssd_scan`` launch the persisted
winner; ``roofline``: granite-3-2b's train step, prefill and decode
step and mamba2-780m's prefill, each counted once by the port's roofline
counter (FLOPs, bytes, the kernels credited per launch) and read against
the H100's peaks with the phases' measured times (``mfu``); last
``distributed``: the distribution plane on a one-rank NCCL group and a
(1, 1) mesh (granite's prefill and train step and mamba2's prefill under
``activation_sharding``, each equal to the unsharded run; the
expert-parallel MoE of olmoe-1b-7b and deepseek-v3-671b against the
scatter dispatch; the int8 compressor on the step's gradient), then two
meta-device dry-run cells on the host.  Each phase
prints one JSON line; any failed check ends the run with a nonzero exit.
The line before the last is the kernel table
(``{"kernels": [...]}``), the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Without a CUDA device, or run outside the repository, it exits nonzero
and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
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

# the H100's peaks are repro_torch.launch.mesh's; the kernels' bounds (FLOPs
# and bytes a call needs, over those peaks) are repro_torch.roofline.cost's
# attention_bound, attention_bwd_bound and ssd_bound, which the roofline
# counter credits each launch with

# kernel vs plain tolerances, as tests/test_kernels.py holds the Pallas kernels
# (allclose with rtol = atol = tol, i.e. max |out - ref| / (1 + |ref|) <= tol)
TOL = {"torch.bfloat16": 2e-2, "torch.float32": 1e-4}
SSD_TOL = {"torch.bfloat16": 5e-2, "torch.float32": 2e-3}
# the SSD kernel at chunk 64 against itself at chunk 128, same inputs and
# the same scaled measure: both carry fp32 and differ only in the order of
# their sums and in the two final roundings to bf16 (2^-8 relative each)
CHUNK_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-5}

ARCHS = ("granite_3_2b", "mamba2_780m", "minitron_4b", "olmoe_1b_7b", "seamless_m4t_medium",
         "recurrentgemma_9b", "gemma3_27b", "llava_next_34b", "deepseek_67b", "deepseek_v3_671b")
# the reference's serve plane decodes an enc-dec model against a cross memory
# it never fills (ROADMAP.md, Queue 3), so seamless-m4t-medium is not served
SERVE_ARCHS = ("granite_3_2b", "mamba2_780m", "minitron_4b", "olmoe_1b_7b",
               "recurrentgemma_9b", "gemma3_27b", "llava_next_34b", "deepseek_67b",
               "deepseek_v3_671b")
# the depth each model runs at on one card where the whole does not fit in
# bf16, at full width (the port has no sharding yet, ROADMAP.md, Queue 1
# item 7): deepseek-67b's 95 layers are 135 GB, its first 40 58.7 GB;
# deepseek-v3-671b's 61 are 1.34 TB, its first 5 (the 3 dense layers and 2
# of 256-expert MoE, with the embedding, head and MTP block) 54.6 GB.
# llava-next-34b runs whole (60 layers, 68.8 GB)
CARD_DEPTH = {"deepseek_67b": 40, "deepseek_v3_671b": 5}
# the most device memory any phase may hold (max_memory_allocated), of 80 GB
MAX_PEAK_GB = 76.0
# the prompt each path prefills (B 4) before its teacher-forced decode: 1024
# but where named.  The windowed models take 2560 tokens, 2.5 windows of
# gemma3's 1024 and 1.25 of recurrentgemma's 2048: 2560 mod window = 512
# for both, so the prefill's ring buffers roll and the window mask bites
PROMPT = {"seamless_m4t_medium": 256, "recurrentgemma_9b": 2560, "gemma3_27b": 2560}
# the prompt of the decode-vs-forward comparisons where it is not PROMPT's:
# deepseek-v3 compares at the no-drop capacity n_experts / top_k (32), where
# the scatter buffer is (experts, tokens, d): 15 GB in bf16 at 4 x 1032
# tokens, 2.0 GB at 4 x 136
CMP_PROMPT = {"deepseek_v3_671b": 128}
# the cut (cfg.scaled keyword arguments) the fp32 and per-layer fan-in
# comparisons run on where the card's depth does not fit them in fp32
# (gemma3-27b: 108 GB): the first 12 layers' weights, two (5 windowed + 1
# global) units of gemma3, so both kinds of layer and the ring wrap are
# covered; llava-next-34b (30.4 GB in fp32 at 12 layers) and deepseek-67b
# (39.9 GB) alike; the bf16 path runs at the card's depth.
# recurrentgemma-9b's fits in fp32 but its 38 layers take ~4 s a 2560-token
# fp32 prefill, over half its phase; so it compares its first 12 (4 units
# of 2 RG-LRU + 1 windowed layer), to keep the whole run near 9 minutes.
# deepseek-v3 takes the first layer of each segment, one dense and one MoE
# layer (14.63 B parameters, 58.5 GB in fp32): its first layers alone
# would all be dense
CMP_CUT = {"gemma3_27b": {"n_layers": 12}, "llava_next_34b": {"n_layers": 12},
           "deepseek_67b": {"n_layers": 12}, "recurrentgemma_9b": {"n_layers": 12},
           "deepseek_v3_671b": {"n_layers": 2, "first_k_dense": 1}}

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
# minitron-4b, seamless-m4t-medium and olmoe-1b-7b amplify fp32 rounding
# past 1e-3 at this init, and not by a fault of decode (NVIDIA H100 80GB
# HBM3, 700.00 W; tools/decode_sensitivity.py): the prefill's own
# last-token logits, the same kernels and code as the forward's at 8 fewer
# tokens (other GEMM shapes), are 1.6e-3 (minitron) and 1.2e-3 (seamless)
# from the forward's; decode vs forward grows smoothly with depth
# (minitron 6.4e-5 at 1 layer, 4.9e-4 at 8, 1.6e-3 at 32; seamless 2.4e-4
# at 1, 2.1e-3 at 12; olmoe 1.3e-4 at 1, 2.6e-2 at 4, 0.39 at 8, 0.94 at
# 16), and replaying the forward's MoE routing from decode changes none of
# it.  With each stacked matrix rescaled to the fan-in of its input width
# (``_fan_in_per_layer``: the same draws, scores ~N(0, 1)), fp32 decode is
# 6.2e-6, 1.2e-6 and 1.8e-6 from the forward at full depth.  So these three
# hold fp32 decode to FP32_REL_TOL at that init and report the reference
# init's reading beside it.
FP32_REL_TOL = 1e-3
FP32_GATED_AT_REFERENCE_INIT = ("granite_3_2b", "mamba2_780m")
# bf16 limits: twice the first full run's reading on an NVIDIA
# H100 80GB HBM3 at 700.00 W, beside the bf16 forward's distance from the
# fp32 forward on the same weights.  Reference init: minitron 0.107 (0.82),
# seamless 0.345 (1.36), olmoe 1.21 (1.36; at no-drop capacity: the routing
# flips in 371 of 576 compared rows, and two unrelated logit vectors read
# ~1.4, so its limit holds nothing).  Per-layer fan-in init (WC_BF16_REL_TOL):
# minitron 0.0242 (0.0229), seamless 0.0110 (0.0130), olmoe 0.107 (0.107;
# 48 rows flip an expert in bf16, none in fp32, least top-8/9 gap 1.85e-6).
# recurrentgemma-9b and gemma3-27b (same card and limit; fp32 decode vs
# forward at the reference init 1.8e-3 at recurrentgemma's 38 layers and
# 6.6e-4 at gemma3's 12, so both are gated at the per-layer fan-in init,
# 9.7e-6 and 5.1e-6): reference init 0.762 and 0.122 at full depth (bf16
# forward vs fp32 0.96 at recurrentgemma's 38 layers, 0.83 at gemma3's 12);
# fan-in init 0.0174 (0.0175) for gemma3 at 12 layers.  recurrentgemma's
# fan-in comparisons read 0.0501 (0.0401) at 38 layers; cut to 12 (CMP_CUT)
# they read fp32 5.1e-6 (reference init 1.05e-4) and bf16 0.0255 (bf16
# forward vs fp32 0.0189), and its fan-in limit is twice that.  recurrentgemma's
# decode keeps the RG-LRU state h in the model dtype, as the reference's
# does (griffin.py:rglru_block_decode), so its bf16 decode also drifts
# from the prefill's fp32 scan: reference behaviour, part of its reading.
# llava-next-34b (60 layers), deepseek-67b (40) and deepseek-v3-671b (5;
# same card and limit; fp32 decode vs forward at the reference init 1.0e-3
# and 1.4e-3 at 12 layers, 3.1e-4 on one dense + one MoE layer, so all
# three are gated at the per-layer fan-in init, 5.7e-6, 4.2e-6, 2.6e-6):
# reference init 0.147, 0.106 and 0.404 (bf16 forward vs fp32 0.54, 0.61
# at 12 layers, 0.70 at 2; deepseek-v3 compares at the no-drop capacity
# over a 128-token prompt, its experts flip in 27 of 72 compared rows,
# and its absorbed MLA decode sums in another order than the prefill's
# per-head K/V); fan-in init 0.0169 (0.0167), 0.0165 (0.0169) and 0.0652
# (0.0655, 2 of 36 rows flip an expert in bf16, none in fp32)
BF16_REL_TOL = {"granite_3_2b": 0.25, "mamba2_780m": 0.9, "minitron_4b": 0.21,
                "olmoe_1b_7b": 2.4, "seamless_m4t_medium": 0.69,
                "recurrentgemma_9b": 1.52, "gemma3_27b": 0.243,
                "llava_next_34b": 0.294, "deepseek_67b": 0.211, "deepseek_v3_671b": 0.81}
WC_BF16_REL_TOL = {"minitron_4b": 0.048, "olmoe_1b_7b": 0.21, "seamless_m4t_medium": 0.022,
                   "recurrentgemma_9b": 0.051, "gemma3_27b": 0.035,
                   "llava_next_34b": 0.034, "deepseek_67b": 0.033, "deepseek_v3_671b": 0.13}
# mamba2-780m cut to its first layer (same weights), bf16 decode vs
# forward over 128 steps: twice the 9.3e-3 measured on an H100
DEPTH1_BF16_REL_TOL = 0.02

SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 8, 16, 16

# flash backward vs autograd of the plain forward in fp32, max |out - ref| /
# (1 + |ref|) of each of dq, dk, dv: bf16 rounds P and dS as product
# operands and reads the bf16 O for Delta; fp32 is exact arithmetic in
# another order
BWD_TOL = {"torch.bfloat16": 5e-2, "torch.float32": 2e-3}
# each row's logsumexp from the forward against the plain version's
LSE_TOL = 1e-3
# loss_fn's loss and every parameter's gradient (granite-3-2b at full
# width, depth 2), with the kernels and with the plain attention, each
# against the same loss_fn computed in float64 with float64 attention: the
# loss as |a - r| / (1 + |r|), each gradient as the relative L2 error
# ||a - r|| / ||r||.  At this init the stacked fan-in (2 layers) puts the
# attention scores near +-1000, so most rows are one-hot and dS = P (dP -
# Delta) cancels: the gradients through the scores carry the rounding of
# their dtype amplified many times, by any method (a first run read 6.5e-3
# between the fp32 kernel and the fp32 plain path, each 7.6e-2 from
# float64).  So the kernel path must be within twice the plain path's own
# error in the same dtype, or within these limits.  The same weights with
# each layer's matrices rescaled to a fan-in of their input width
# (scores ~N(0, 1)) make a well-conditioned second case, where these
# limits bind
GRAD_CHECK_TOL = {"float32": {"loss": 1e-4, "grad": 1e-3},
                  "bfloat16": {"loss": 2e-2, "grad": 5e-2}}


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


def phase_kernel_cases(seed: int) -> list[dict]:
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.roofline.cost import attention_bound

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [  # (name, B, S, Sk, H, KV, D, Dv, dtype, causal, window)
        ("granite_prefill", 4, 1024, 1024, 32, 8, 64, 64, torch.bfloat16, True, 0),
        ("granite_prefill_s2048", 4, 2048, 2048, 32, 8, 64, 64, torch.bfloat16, True, 0),
        ("ragged_s1000", 4, 1000, 1000, 32, 8, 64, 64, torch.bfloat16, True, 0),
        ("window256", 4, 1024, 1024, 32, 8, 64, 64, torch.bfloat16, True, 256),
        ("noncausal", 4, 1024, 1024, 32, 8, 64, 64, torch.bfloat16, False, 0),
        ("fp32", 4, 1024, 1024, 32, 8, 64, 64, torch.float32, True, 0),
        ("d128", 4, 1024, 1024, 32, 8, 128, 128, torch.bfloat16, True, 0),
        ("short_s100", 4, 100, 100, 32, 8, 64, 64, torch.bfloat16, True, 0),  # one partial q tile
        # the model paths of minitron-4b (24 heads padded to 32, kv expanded
        # to them) and olmoe-1b-7b, seamless-m4t-medium's encoder and its
        # decoder's cross-attention (S 256 queries over the 1024 frames), and
        # that cross-attention over a ragged key length
        ("minitron_prefill", 4, 1024, 1024, 32, 32, 128, 128, torch.bfloat16, True, 0),
        ("olmoe_prefill", 4, 1024, 1024, 16, 16, 128, 128, torch.bfloat16, True, 0),
        ("seamless_encoder", 4, 1024, 1024, 16, 16, 64, 64, torch.bfloat16, False, 0),
        ("seamless_cross", 4, 256, 1024, 16, 16, 64, 64, torch.bfloat16, False, 0),
        ("cross_ragged", 4, 256, 1000, 16, 16, 64, 64, torch.bfloat16, False, 0),
        # recurrentgemma-9b's local attention (D 256, MQA, window 2048) in both
        # dtypes, and gemma3-27b's local and global layers, at their 2560-token
        # prefill
        ("recurrentgemma_prefill", 4, 2560, 2560, 16, 1, 256, 256, torch.bfloat16, True, 2048),
        ("recurrentgemma_prefill_fp32", 4, 2560, 2560, 16, 1, 256, 256, torch.float32, True,
         2048),
        ("gemma3_local", 4, 2560, 2560, 32, 16, 128, 128, torch.bfloat16, True, 1024),
        ("gemma3_global", 4, 2560, 2560, 32, 16, 128, 128, torch.bfloat16, True, 0),
        # deepseek-v3's MLA prefill (128 heads, q/k dim 192, v dim 128) in
        # both dtypes and over a ragged length; llava-next-34b's (56 heads
        # padded to 64, kv expanded to them) and deepseek-67b's (GQA 64 / 8)
        ("deepseek_v3_mla", 4, 1024, 1024, 128, 128, 192, 128, torch.bfloat16, True, 0),
        ("deepseek_v3_mla_fp32", 4, 1024, 1024, 128, 128, 192, 128, torch.float32, True, 0),
        ("mla_ragged_s1000", 4, 1000, 1000, 128, 128, 192, 128, torch.bfloat16, True, 0),
        ("llava_prefill", 4, 1024, 1024, 64, 64, 128, 128, torch.bfloat16, True, 0),
        ("deepseek67b_prefill", 4, 1024, 1024, 64, 8, 128, 128, torch.bfloat16, True, 0),
    ]
    results = []
    for name, b, s, sk, h, kv, d, dv, dtype, causal, window in cases:
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(b, sk, kv, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, sk, kv, dv, generator=gen, device="cuda").to(dtype)
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = TOL[str(dtype)]
        err = (out.float() - ref.float()).abs().max().item()
        scaled = scaled_err(out, ref)
        # the yardstick: one PyTorch call computing the same function
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib_kw = _sdpa_kw(s, causal, window)
        lib = F.scaled_dot_product_attention(qt, kt, vt, **lib_kw).transpose(1, 2)
        lib_err = (lib.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal, window=window))
        plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=causal, window=window),
                           iters=5, warmup=1)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib_kw))
        bound_ms, bound_by, flops, nbytes = attention_bound(b, s, sk, h, kv, d, dv, str(dtype),
                                                            causal, window)
        row = {"case": name, "shape": [b, s, h, kv, d], "dv": dv, "sk": sk, "dtype": str(dtype),
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


def phase_ssd_cases(seed: int) -> list[dict]:
    """The SSD kernel against ssd_ref at mamba2-780m's head shape (P 64,
    N 128, 48 heads), inputs drawn as tests/test_kernels.py draws them."""
    from repro_torch.kernels.ops import ssd_scan
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.roofline.cost import ssd_bound

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


def kernel_device_ms(fn, iters: int = 50) -> float:
    """Mean device time a call of ``fn`` spends in kernels, from
    torch.profiler (host time between launches excluded)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


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


def zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from repro_torch.kernels.ops import flash_attention, ssd_scan
    flash_attention.launches = flash_attention.bwd_launches = ssd_scan.launches = 0


def launch_counts() -> dict[str, int]:
    """The launches that show what a path ran, per kernel."""
    from repro_torch.kernels.ops import flash_attention, ssd_scan
    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention.bwd_launches,
            "ssd_scan": ssd_scan.launches}


def _rel_rows(a, b):
    """Per-row relative L2 error of logits (..., V) -> (...)."""
    a, b = a.float(), b.float()
    return (a - b).norm(dim=-1) / b.norm(dim=-1)


def decode_cache(cfg, pcache, b: int, length: int, state_dtype=None):
    """The decode cache of ``length`` positions that a prefill's cache
    ``pcache`` hands on.  An attention (or MLA latent) cache of the
    prompt's length has no free slot: it is copied into a longer one; a
    sliding window's ring buffer (min(window, s) wide) goes to the front of
    one min(window, length) wide; an SSD or RG-LRU prefill cache (conv and
    state) is the decode cache, and so is an enc-dec model's cross memory
    (the encoder's length).  ``state_dtype`` recasts the SSD state."""
    from repro_torch.models import cache_defs, materialize
    from repro_torch.models.spec import tree_leaves, tree_map

    device = next(t.device for t in tree_leaves(pcache) if isinstance(t, torch.Tensor))
    cache = tree_map(lambda t: t.to(cfg.cdtype) if t.is_floating_point() else t,
                     materialize(cache_defs(cfg, b, length), 0, device))
    for dst, src in zip(cache["segments"], pcache["segments"]):
        for u in dst:
            if "ssd" in dst[u]:
                st = src[u]["ssd"]["state"]
                dst[u]["ssd"] = {"conv": src[u]["ssd"]["conv"],
                                 "state": st.to(state_dtype) if state_dtype else st}
                continue
            if "rglru" in dst[u]:
                dst[u]["rglru"] = src[u]["rglru"]
                continue
            for name, leaf in src[u]["attn"].items():    # k, v or ckv, k_rope; len
                dst_leaf = dst[u]["attn"][name]
                (dst_leaf[:, :, :leaf.shape[2]] if name != "len" else dst_leaf).copy_(leaf)
            if "cross" in dst[u]:
                dst[u]["cross"] = src[u]["cross"]
    return cache


def _path_logits(params, cfg, ids, s: int, steps: int, *, enc=None, state_dtype=None,
                 timed: bool = True) -> dict:
    """Prefill ``ids[:, :s]``, teacher-force ``steps`` decode steps, and
    run the forward over all ``s + steps`` tokens; returns both sets of
    logits at positions s-1 .. s+steps-1 with (if ``timed``) the timings
    and device profiles.  ``ids`` are token ids (B, S), or an ``embeds``
    model's embeddings (B, S, d).  ``enc`` is an enc-dec model's encoder
    frames (B, Se, d), fed to the prefill and the forward.  ``state_dtype``
    recasts the SSD state that the prefill hands to decode."""
    from repro_torch.distributed.step import build_prefill_step, build_serve_step
    from repro_torch.models import forward_train
    from repro_torch.models.model import _logits

    b = ids.shape[0]
    key = "embeds" if cfg.input_kind == "embeds" else "inputs"
    prefill, serve_step = build_prefill_step(cfg), build_serve_step(cfg)
    frames = {} if enc is None else {"enc_embeds": enc}
    prompt = {key: ids[:, :s], **frames}
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    logits, pcache = prefill(params, prompt)
    torch.cuda.synchronize()
    first_prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = launch_counts()
    cache = decode_cache(cfg, pcache, b, s + steps, state_dtype)
    del pcache
    dec, step_ms = [logits[:, 0]], []
    for t in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = serve_step(params, cache, {key: ids[:, s + t:s + t + 1]})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        dec.append(lg[:, 0])
    launches = launch_counts()
    out = {"prefill_launches": prefill_launches, "launches": launches}
    if timed:
        out["profiles"] = {
            "prefill": device_profile(lambda: prefill(params, prompt)),
            # one more step on the full cache (an attention ring buffer wraps
            # onto slot 0; timing only)
            "decode_step": device_profile(
                lambda: serve_step(params, cache, {key: ids[:, s:s + 1]})),
        }
    del cache
    with torch.no_grad():
        h, _, _ = forward_train(params, {key: ids, **frames}, cfg)
    out.update(got=torch.stack(dec, dim=1), ref=_logits(params, h[:, s - 1:], cfg))
    if timed:
        prefill_ms = statistics.median(
            cuda_ms(lambda: prefill(params, prompt), iters=1, warmup=0)
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
    """Kernel launches of one prefill: one per attention (global, windowed
    or MLA) or SSD layer, none for an RG-LRU layer; an enc-dec model adds
    one per encoder layer and a cross-attention per decoder layer."""
    mixers = [m for m, _ in cfg.block_kinds()]
    attn = mixers.count("attn") + mixers.count("swa") + mixers.count("mla")
    if cfg.encoder_layers:
        attn = cfg.encoder_layers + 2 * attn
    return {"flash_attention": attn, "flash_attention_bwd": 0, "ssd_scan": mixers.count("ssd")}


@contextlib.contextmanager
def moe_probe(first_pos: int):
    """Record each MoE call of the model: the share of (token, expert)
    assignments its capacity drops, and over the rows at positions >=
    ``first_pos`` (every row of a one-token decode step) the least gap
    between the k-th and (k+1)-th router probability and the chosen experts.
    Diagnostic only: it routes each call's tokens once more."""
    import repro_torch.models.moe as moe

    ffn, calls = moe.moe_ffn, []

    def probed(params, x, cfg):
        m = cfg.moe
        b, s, d = x.shape
        _, idx, _ = moe._route(params, x.reshape(b * s, d), m)
        cap = moe._capacity(m, b * s)
        keep = moe._positions_hierarchical(idx.reshape(-1), m.n_experts) < cap
        rows = x[:, first_pos:] if s > 1 else x
        probs = torch.softmax(rows.float() @ params["router"].float(), dim=-1)
        top = torch.topk(probs, m.top_k + 1, dim=-1)
        calls.append({"tokens": b * s, "capacity": cap,
                      "dropped": 1.0 - keep.float().mean().item(),
                      "gap": (top.values[..., -2] - top.values[..., -1]).min().item(),
                      "experts": top.indices[..., :-1].sort(dim=-1).values.cpu()})
        return ffn(params, x, cfg)

    moe.moe_ffn = probed
    try:
        yield calls
    finally:
        moe.moe_ffn = ffn


def moe_flips(calls: list, n_layers: int, steps: int) -> dict:
    """From a moe_probe over one ``_path_logits`` run (a prefill, ``steps``
    decode steps, then the forward; each pass calls each of the
    ``n_layers`` MoE layers once): the least top-k gap of each pass and the
    rows, over all layers, whose chosen experts differ between the prefill
    or decode pass and the forward."""
    passes = [calls[i:i + n_layers] for i in range(0, len(calls), n_layers)]
    check(len(passes) == steps + 2, f"moe_probe: {len(calls)} calls, expected "
          f"{(steps + 2) * n_layers}")
    fwd = passes[-1]
    flips = 0
    for t, served in enumerate(passes[:-1]):     # the prefill's row s-1, then s + t - 1
        for layer in range(n_layers):
            got = served[layer]["experts"][:, -1]
            want = fwd[layer]["experts"][:, t]
            flips += int((got != want).any(dim=-1).sum())
    return {"min_gap_prefill_decode": min(c["gap"] for p in passes[:-1] for c in p),
            "min_gap_forward": min(c["gap"] for c in fwd),
            "expert_set_flips": flips, "rows_compared": (steps + 1) * n_layers *
            fwd[0]["experts"].shape[0]}


def _fan_in_per_layer(params: dict, cfg) -> dict:
    """The same weights with each stacked matrix, (L, ..., d_in, d_out),
    rescaled from the reference's fan-in (its stack depth L) to d_in: a
    well-conditioned init where attention is not near-hard.  ``cfg`` is
    the config the weights were drawn at: L comes from its definitions, so
    a cut of them (``_first_layers``, ``_cut_in_place``) is rescaled as the
    whole would be;
    leaves drawn at a scale of their own (convolutions, the RG-LRU's gate
    matrices) keep it."""
    from repro_torch.models import param_defs
    from repro_torch.models.spec import tree_zip_map

    def rescale(t, d):
        if len(d.shape) >= 3 and d.init == "normal" and d.scale is None:
            return t * math.sqrt(d.shape[0] / d.shape[-2])
        return t

    defs = param_defs(cfg)
    out = {**params, "segments": [tree_zip_map(rescale, seg, d)
                                  for seg, d in zip(params["segments"], defs["segments"])]}
    if "encoder" in params:
        out["encoder"] = tree_zip_map(rescale, params["encoder"], defs["encoder"])
    return out


def _first_layers(params: dict, cfg, n: int):
    """(params, cfg) of the model cut to its first ``n`` layers, the same
    weights as views: ``n`` whole units of the first scan segment."""
    from repro_torch.models.spec import tree_map

    unit, repeats = cfg.scan_segments()[0]
    r = n // len(unit)
    cut = cfg.scaled(n_layers=n)
    check(r * len(unit) == n and 0 < r <= repeats and cut.scan_segments() == [(unit, r)],
          f"{cfg.name}: {n} layers are not whole units of the first segment")
    seg = tree_map(lambda t: t[:r], params["segments"][0])
    return {**params, "segments": [seg]}, cut


def _map_in_place(tree, fn) -> None:
    """Replace each leaf of a tree of dicts and lists by ``fn(leaf)``, one
    at a time: the old leaf is freed before the next is made, so the peak
    is the tree plus one leaf."""
    for k in (tree if isinstance(tree, dict) else range(len(tree))):
        if isinstance(tree[k], (dict, list)):
            _map_in_place(tree[k], fn)
        else:
            tree[k] = fn(tree[k])


def _recast(params: dict, dtype) -> dict:
    """Recast ``params``' floating leaves to ``dtype`` in place; returns
    the leaves' dtypes before, for :func:`_restore`."""
    from repro_torch.models.spec import tree_map
    before = tree_map(lambda t: t.dtype, params)
    _map_in_place(params, lambda t: t.to(dtype) if t.is_floating_point() else t)
    return before


def _restore(params: dict, dtypes) -> None:
    """Recast each leaf back, in place, to its dtype in ``dtypes`` (a tree
    like ``params``; fp32 back to bf16 is exact for values drawn in bf16)."""
    from repro_torch.models.spec import tree_leaves
    it = iter(tree_leaves(dtypes, lambda x: isinstance(x, torch.dtype)))
    _map_in_place(params, lambda t: t.to(next(it)))


def _cut_in_place(params: dict, cfg, cut):
    """(params, cut): ``params`` (drawn at ``cfg``) cut in place to the
    config ``cut``, the first r layers of each segment ``cut`` keeps (its
    segments must be cfg's first ones, each unit the same with r no more
    than cfg's repeats), each kept leaf copied and the whole one freed as
    it goes: the peak is the whole tree plus one leaf's copy."""
    segs, kept = cfg.scan_segments(), cut.scan_segments()
    check(len(kept) <= len(segs) and all(
        unit == k_unit and 0 < r <= reps for (unit, reps), (k_unit, r) in zip(segs, kept)),
        f"{cfg.name}: {kept} is not a cut of {segs}")
    for seg, (_, r) in zip(params["segments"], kept):
        _map_in_place(seg, lambda t, r=r: t[:r].clone())
    del params["segments"][len(kept):]
    return params, cut


def _compared(params, cfg, ids, s: int, steps: int, enc, moe_out: dict, key: str) -> dict:
    """An untimed ``_path_logits`` run; an MoE model's under ``moe_probe``,
    its routing readings stored in ``moe_out[key]``."""
    if not cfg.moe:
        return _path_logits(params, cfg, ids, s, steps, enc=enc, timed=False)
    with moe_probe(s - 1) as calls:
        out = _path_logits(params, cfg, ids, s, steps, enc=enc, timed=False)
    moe_out[key] = moe_flips(calls, _moe_layers(cfg), steps)
    return out


def _moe_layers(cfg) -> int:
    return sum(ffn == "moe" for _, ffn in cfg.block_kinds())


def phase_prefill_decode(arch: str, seed: int) -> dict[str, int]:
    """Returns the kernel launches of the main-path run (prefill + decode).

    An enc-dec model prefills a 256-token prompt against 1024 encoder
    frames (so its cross-attention has Sk != S); the windowed models
    prefill 2560 tokens (PROMPT).  An MoE model's timed
    path runs its shipped capacity factor, which drops assignments in the
    prefill and the forward but not in a decode step; its decode is held to
    the forward at capacity factor n_experts / top_k, where nothing drops.
    Archs not in FP32_GATED_AT_REFERENCE_INIT are also compared on the
    weights rescaled by ``_fan_in_per_layer``, where the fp32 gate holds.
    An arch in CMP_CUT runs its fp32 and fan-in comparisons (and the bf16
    forward they are read against) on that cut, after the rest of the
    weights is freed; an arch in
    CARD_DEPTH runs at that depth throughout.  An arch in CMP_PROMPT runs
    its comparisons over that prompt.  ``peak_gb`` holds each part's peak.
    An ``embeds`` model (llava) prefills and decodes embeddings drawn from
    the seed at its embedding table's scale (unit normal)."""
    from repro_torch.distributed.step import build_prefill_step
    from repro_torch.models import materialize, param_defs

    cfg = card_config(arch)
    b, s = 4, PROMPT.get(arch, 1024)
    s_cmp = CMP_PROMPT.get(arch, s)
    enc = None
    if cfg.encoder_layers:
        enc_len = 1024
    # the forward over prompt + decoded tokens must keep the SSD scan's
    # L % chunk == 0 (the reference asserts it), so an SSD model decodes a chunk
    steps = cfg.ssm.chunk if cfg.ssm else 8
    peaks = {}

    def peak(part: str) -> None:   # the peak since the last part, then reset
        peaks[part] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = materialize(param_defs(cfg), seed, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embeds":
        ids = torch.from_numpy(rng.standard_normal((b, s + steps, cfg.d_model))
                               .astype(np.float32)).cuda()
    else:
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s + steps),
                                            dtype=np.int32)).cuda()
    ids_cmp = ids[:, :s_cmp + steps]
    if cfg.encoder_layers:      # frames as data/pipeline.py:batch_for draws them
        enc = torch.from_numpy(rng.standard_normal((b, enc_len, cfg.d_model))
                               .astype(np.float32) * 0.02).cuda()
    cmp_cfg = cfg
    if cfg.moe:
        cmp_cfg = cfg.scaled(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))

    # -- the main path in bf16: counts are zeroed inside, read after -------
    want = expected_launches(cfg)
    bf = _path_logits(params, cfg, ids, s, steps, enc=enc)
    check(bf["prefill_launches"] == want,
          f"{arch}: prefill launched {bf['prefill_launches']}, expected {want}")
    check(bf["launches"] == want, f"{arch}: decode launched a kernel: {bf['launches']}")
    if arch in ROOFLINE_PREFILL:
        count_serving_paths(arch, params, cfg, ids, s, steps, bf)
    depth1 = ssd_state_readings(params, cfg, ids, s, steps) if cfg.ssm else None
    moe_out = {}
    bf_cmp = bf
    if cfg.moe:
        with moe_probe(s - 1) as calls:
            build_prefill_step(cfg)(params, {"inputs": ids[:, :s]})
        moe_out["shipped"] = {"capacity_factor": cfg.moe.capacity_factor,
                              "prefill_tokens": calls[0]["tokens"],
                              "prefill_capacity": calls[0]["capacity"],
                              "prefill_dropped_share_by_layer": [c["dropped"] for c in calls],
                              "decode_vs_forward_rel_err_max":
                              _rel_rows(bf["got"], bf["ref"]).max().item()}
        bf_cmp = _compared(params, cmp_cfg, ids_cmp, s_cmp, steps, enc, moe_out, "bf16")
    peak("bf16_path")
    # -- the comparisons' depth: CMP_CUT's layers, the rest freed ----------
    cut = CMP_CUT.get(arch, {})
    bf_at_depth = bf_cmp              # the bf16 forward the fp32 one is read against
    if cmp_cfg.scaled(**cut).scan_segments() != cfg.scan_segments():
        params, cmp_cfg = _cut_in_place(params, cmp_cfg, cmp_cfg.scaled(**cut))
        torch.cuda.empty_cache()
        bf_at_depth = _compared(params, cmp_cfg, ids_cmp, s_cmp, steps, enc, moe_out,
                                "bf16_cut")
        peak("bf16_cut")
    depth = cmp_cfg.n_layers
    # -- the same weights and tokens in fp32: the algorithms must agree ----
    # (recast in place and back: two copies of a cut's weights may not fit)
    cfg32 = cmp_cfg.scaled(compute_dtype="float32")
    dtypes = _recast(params, torch.float32)
    f32 = _path_logits(params, cfg32, ids_cmp, s_cmp, steps, enc=enc)
    _restore(params, dtypes)
    peak("fp32")
    # -- and on the well-conditioned init ----------------------------------
    wc = None
    if arch not in FP32_GATED_AT_REFERENCE_INIT:
        params = _fan_in_per_layer(params, cfg)    # replaces the reference-init copy
        wc_bf = _compared(params, cmp_cfg, ids_cmp, s_cmp, steps, enc, moe_out,
                          "fan_in_per_layer_bf16")
        _recast(params, torch.float32)
        wc_32 = _compared(params, cfg32, ids_cmp, s_cmp, steps, enc, moe_out,
                          "fan_in_per_layer_fp32")
        wc_rel_32, wc_rel_bf = _rel_rows(wc_32["got"], wc_32["ref"]), _rel_rows(wc_bf["got"],
                                                                                wc_bf["ref"])
        wc = {"init": "fan_in_per_layer", "fp32_rel_err_max": wc_rel_32.max().item(),
              "fp32_rel_err_by_pos": wc_rel_32.max(dim=0).values.tolist(),
              "bf16_rel_err_max": wc_rel_bf.max().item(),
              "bf16_rel_err_by_pos": wc_rel_bf.max(dim=0).values.tolist(),
              "bf16_forward_vs_fp32_forward_max":
              _rel_rows(wc_bf["ref"], wc_32["ref"]).max().item(),
              "bf16_tol": WC_BF16_REL_TOL[arch],
              "finite": all(bool(torch.isfinite(x).all()) for x in
                            (wc_bf["got"], wc_bf["ref"], wc_32["got"], wc_32["ref"]))}
        del wc_bf, wc_32
        peak("fan_in_per_layer")
    del params
    torch.cuda.empty_cache()

    rel_bf = _rel_rows(bf_cmp["got"], bf_cmp["ref"])   # (B, steps + 1)
    rel_32 = _rel_rows(f32["got"], f32["ref"])
    rel_bf_vs_32 = _rel_rows(bf_at_depth["ref"], f32["ref"])   # bf16 forward vs fp32 forward
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (bf["got"], bf["ref"], bf_cmp["got"], bf_cmp["ref"], bf_at_depth["got"],
                  bf_at_depth["ref"], f32["got"], f32["ref"]))
    bf16_tol = BF16_REL_TOL[arch]
    out = {"config": cfg.name, "layers": cfg.n_layers, "batch": b, "prompt": s,
           "compared_prompt": s_cmp, "decode_steps": steps,
           "init_s": init_s, "prefill_launches": bf["prefill_launches"],
           "first_prefill_ms": bf["first_prefill_ms"], "prefill_ms": bf["prefill_ms"],
           "decode_step_ms": statistics.median(bf["step_ms"]),
           "decode_step_ms_all": bf["step_ms"],
           "cmp_layers": depth,
           "fp32_prefill_ms": f32["prefill_ms"],
           "fp32_decode_step_ms": statistics.median(f32["step_ms"]),
           "bf16_rel_err_max": rel_bf.max().item(),
           "bf16_rel_err_by_pos": rel_bf.max(dim=0).values.tolist(),
           "bf16_top1_agreement": (bf_cmp["got"].argmax(-1) == bf_cmp["ref"].argmax(-1))
           .float().mean().item(),
           "fp32_rel_err_max": rel_32.max().item(),
           "fp32_rel_err_by_pos": rel_32.max(dim=0).values.tolist(),
           "bf16_forward_vs_fp32_forward_max": rel_bf_vs_32.max().item(),
           "bf16_forward_vs_fp32_forward_by_pos": rel_bf_vs_32.max(dim=0).values.tolist(),
           "fp32_tol": FP32_REL_TOL, "fp32_gated_at": "fan_in_per_layer" if wc else "reference",
           "bf16_tol": bf16_tol, "finite": finite,
           "peak_mem_gb": max(peaks.values()), "peak_gb": peaks}
    if depth < cfg.n_layers:
        rel_cut = _rel_rows(bf_at_depth["got"], bf_at_depth["ref"])
        out["bf16_cut_rel_err_max"] = rel_cut.max().item()
    if enc is not None:
        out["encoder_frames"] = enc.shape[1]
    if depth1:
        out.update(depth1=depth1, depth1_bf16_tol=DEPTH1_BF16_REL_TOL)
    if wc:
        out["well_conditioned"] = wc
    if moe_out:
        out.update(moe=moe_out, compared_capacity_factor=cmp_cfg.moe.capacity_factor)
    emit("prefill_decode", **out)
    emit("device_time", config=cfg.name, bf16=bf["profiles"], fp32=f32["profiles"],
         fp32_layers=depth)
    check(finite and (wc is None or wc["finite"]),
          f"{arch}: prefill/decode/forward logits are not all finite")
    fp32_err = wc["fp32_rel_err_max"] if wc else out["fp32_rel_err_max"]
    check(fp32_err <= FP32_REL_TOL,
          f"{arch}: fp32 decode vs forward ({out['fp32_gated_at']} init): max per-row "
          f"relative error {fp32_err} > {FP32_REL_TOL}")
    check(out["bf16_rel_err_max"] <= bf16_tol,
          f"{arch}: bf16 decode vs forward: max per-row relative error "
          f"{out['bf16_rel_err_max']} > {bf16_tol}")
    if wc:
        check(wc["bf16_rel_err_max"] <= wc["bf16_tol"],
              f"{arch}: bf16 decode vs forward (fan_in_per_layer init): max per-row relative "
              f"error {wc['bf16_rel_err_max']} > {wc['bf16_tol']}")
    if depth1:
        got = depth1["bf16_state"]["rel_err_max"]
        check(got <= DEPTH1_BF16_REL_TOL, f"{arch}: bf16 decode vs forward at depth 1: "
              f"max per-row relative error {got} > {DEPTH1_BF16_REL_TOL}")
    check(out["peak_mem_gb"] <= MAX_PEAK_GB,
          f"{arch}: peak device memory {peaks} GB over {MAX_PEAK_GB}")
    return bf["launches"]


# the paths the roofline phase reads: granite-3-2b's prefill and decode step
# and mamba2-780m's prefill (counted in phase_prefill_decode), and granite's
# train step (counted in phase_train_step); each runs once, untimed, under
# the port's roofline counter, beside the timed runs whose ms it is read with
ROOFLINE_PREFILL = ("granite_3_2b", "mamba2_780m")
ROOFLINE_DECODE = ("granite_3_2b",)
ROOFLINE_RUNS: dict[str, dict] = {}


def count_serving_paths(arch: str, params, cfg, ids, s: int, steps: int, bf: dict) -> None:
    """One prefill (and for ROOFLINE_DECODE one decode step on its cache)
    under the roofline counter, with the timed runs' prefill and decode ms."""
    from repro_torch.distributed.step import build_prefill_step, build_serve_step
    from repro_torch.roofline import count_step
    from repro_torch.roofline.cost import attention_bound, ssd_bound

    b = ids.shape[0]
    key = "embeds" if cfg.input_kind == "embeds" else "inputs"
    hd = cfg.resolved_head_dim
    per_launch = {}
    if cfg.ssm:
        h, p = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim
        per_launch["ssd_scan"] = ssd_bound(b, s, h, p, cfg.ssm.d_state, min(cfg.ssm.chunk, s),
                                           "torch.bfloat16", "torch.bfloat16")[2]
    else:
        per_launch["flash_attention"] = attention_bound(b, s, s, cfg.n_heads, cfg.n_kv_heads, hd,
                                                        hd, "torch.bfloat16", True, 0)[2]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    (_, pcache), cost = count_step(build_prefill_step(cfg), params, {key: ids[:, :s]})
    ROOFLINE_RUNS[f"{arch} prefill"] = dict(
        cfg=cfg, cost=cost, ms=bf["prefill_ms"], kind="serve", batch=b, seq=s, tokens=b * s,
        expected=expected_launches(cfg), per_launch=per_launch, peak_gb=peak_gb)
    if arch in ROOFLINE_DECODE:
        cache = decode_cache(cfg, pcache, b, s + steps)
        _, cost = count_step(build_serve_step(cfg), params, cache, {key: ids[:, s:s + 1]})
        ROOFLINE_RUNS[f"{arch} decode_step"] = dict(
            cfg=cfg, cost=cost, ms=statistics.median(bf["step_ms"]), kind="serve", batch=b,
            seq=1, tokens=b, expected={k: 0 for k in launch_counts()}, per_launch={},
            peak_gb=peak_gb)
        del cache
    del pcache


def phase_roofline() -> None:
    """Each counted path read against the H100's roofline: FLOPs and bytes
    (aten ops plus the kernels' per-launch credits), the compute and memory
    terms, the dominant one, model FLOPs (6 N D train, 2 N D serve), their
    share of the counted FLOPs (useful_ratio), the roofline fraction and,
    with the path's measured time, mfu = model_flops / (989 TFLOP/s x s)."""
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    from repro_torch.models import param_defs
    from repro_torch.roofline import analyze, mfu

    want_paths = {f"{a} prefill" for a in ROOFLINE_PREFILL} | {
        f"{a} decode_step" for a in ROOFLINE_DECODE} | {"granite_3_2b train_step"}
    check(set(ROOFLINE_RUNS) == want_paths,
          f"roofline: counted paths {sorted(ROOFLINE_RUNS)}, expected {sorted(want_paths)}")
    for path, run in ROOFLINE_RUNS.items():
        cfg, cost = run["cfg"], run["cost"]
        defs = param_defs(cfg)
        rep = analyze(arch=cfg.name, shape=f"b{run['batch']}_s{run['seq']}", mesh_name="single",
                      chips=1, cost=cost, cfg=cfg, defs=defs, kind=run["kind"],
                      tokens=run["tokens"], per_device_hbm_bytes=run["peak_gb"] * 1e9)
        secs = run["ms"] / 1e3
        launches = {k: cost.kernel_launches.get(k, 0) for k in run["expected"]}
        credited = {k: {"launches": launches[k], "flops": cost.kernel_flops.get(k, 0.0),
                        "per_launch_flops": f, "bytes": cost.kernel_bytes.get(k, 0.0)}
                    for k, f in run["per_launch"].items()}
        # the prefill applies the (tied) head to the last position only, so
        # its counted FLOPs may fall short of 2 N D by the other positions' head
        head_skipped = (2.0 * cfg.vocab_size * cfg.d_model * run["batch"] * (run["seq"] - 1)
                        if path.endswith("prefill") else 0.0)
        row = {"path": path, "config": cfg.name, "layers": cfg.n_layers,
               "batch": run["batch"], "seq": run["seq"], **rep.row(),
               "flops": rep.hlo_flops, "bytes": rep.hlo_bytes, "model_flops": rep.model_flops,
               "aten_flops": cost.aten_flops, "aten_bytes": cost.aten_bytes,
               "attn_score_bytes": cost.attn_score_bytes, "coll": dict(cost.coll),
               "compute_s": rep.compute_s, "memory_s": rep.memory_s,
               "collective_s": rep.collective_s, "useful_ratio": rep.useful_ratio,
               "roofline_fraction": rep.roofline_fraction, "head_skipped_flops": head_skipped,
               "measured_ms": run["ms"], "mfu": mfu(rep.model_flops, secs),
               "bound_ms": max(rep.compute_s, rep.memory_s, rep.collective_s) * 1e3,
               "achieved_tflops": rep.hlo_flops / secs / 1e12,
               "achieved_tb_s": rep.hlo_bytes / secs / 1e12,
               "peak_flops_bf16": PEAK_FLOPS_BF16, "kernel_launches": launches,
               "expected_launches": run["expected"], "kernels": credited}
        row["bound_frac"] = row["bound_ms"] / run["ms"]
        emit("roofline", **row)
        check(launches == run["expected"],
              f"roofline {path}: the counter credited {launches} launches, expected "
              f"{run['expected']}")
        for k, c in credited.items():
            check(math.isclose(c["flops"], c["launches"] * c["per_launch_flops"], rel_tol=1e-9),
                  f"roofline {path}: {k} credited {c['flops']} FLOPs, not {c['launches']} "
                  f"launches x {c['per_launch_flops']}")
        check(all(math.isfinite(row[k]) for k in ("flops", "bytes", "mfu", "useful_ratio"))
              and rep.hlo_flops > 0 and rep.hlo_bytes > 0 and rep.coll_bytes == 0,
              f"roofline {path}: counted flops {rep.hlo_flops}, bytes {rep.hlo_bytes}, "
              f"collective bytes {rep.coll_bytes}")
        if path.endswith("prefill"):
            check(0 < rep.useful_ratio and rep.hlo_flops >= rep.model_flops - head_skipped,
                  f"roofline {path}: counted {rep.hlo_flops} FLOPs, below model FLOPs "
                  f"{rep.model_flops} less the skipped head {head_skipped}")
        else:
            check(0 < rep.useful_ratio <= 1,
                  f"roofline {path}: useful_ratio {rep.useful_ratio} not in (0, 1]")


# the autotune phase's sweeps: the flash forward at the model paths' shapes
# (phase_kernel_cases' cases; every (head dims, kv tile) instantiation among
# them), the SSD kernel at mamba2-780m's prefill (P 64, N 128, 48 heads)
AUTOTUNE_FLASH = [  # (case, B, S, H, KV, D, Dv, window), bf16, causal
    ("granite_prefill", 4, 1024, 32, 8, 64, 64, 0),
    ("d128", 4, 1024, 32, 8, 128, 128, 0),
    ("minitron_prefill", 4, 1024, 32, 32, 128, 128, 0),
    ("llava_prefill", 4, 1024, 64, 64, 128, 128, 0),
    ("deepseek_v3_mla", 4, 1024, 128, 128, 192, 128, 0),
    ("recurrentgemma_prefill", 4, 2560, 16, 1, 256, 256, 2048),
]
AUTOTUNE_SSD = ("mamba2_prefill", 4, 1024, 48, 64, 128)   # (case, B, L, H, P, N)


def phase_autotune(seed: int) -> tuple[list[dict], dict[str, int]]:
    """The autotuner on the card into a fresh cache directory: every kv tile
    of the flash forward at AUTOTUNE_FLASH's shapes and every bf16 chunk
    tile of the SSD kernel at AUTOTUNE_SSD's, each held to the plain version
    at the kernel cases' limits, swept (µs per tile, the default's µs, the
    winner) and persisted; then ops.flash_attention and ops.ssd_scan with no
    tile named launch the persisted winners.  Returns a row per tile and the
    launches of those two consulting calls."""
    import tempfile

    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attention import KV_TILES, flash_attention_cuda
    from repro_torch.kernels.ops import flash_attention, ssd_scan
    from repro_torch.kernels.ref import flash_attention_ref, ssd_ref
    from repro_torch.kernels.ssd_scan import CHUNKS, ssd_scan_cuda

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    env = "REPRO_TORCH_AUTOTUNE_CACHE"
    before = os.environ.get(env)
    tiles, winners = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[env] = tmp
        try:
            cache = autotune.default_cache()
            check(len(cache) == 0 and cache.directory == Path(tmp),
                  f"autotune: the cache at {cache.directory} is not fresh")
            tol = TOL["torch.bfloat16"]
            for case, b, s, h, kv, d, dv, window in AUTOTUNE_FLASH:
                q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                k = torch.randn(b, s, kv, d, generator=gen, device="cuda").to(torch.bfloat16)
                v = torch.randn(b, s, kv, dv, generator=gen, device="cuda").to(torch.bfloat16)
                ref = flash_attention_ref(q, k, v, causal=True, window=window)
                rows = {}
                for tile in KV_TILES[(d, dv)]:
                    out = flash_attention_cuda(q, k, v, causal=True, window=window, kv_tile=tile)
                    torch.cuda.synchronize()
                    err = scaled_err(out, ref)
                    rows[tile] = {"kernel": "flash_attention", "case": case, "head_dims": [d, dv],
                                  "kv_tile": tile,
                                  "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                                  "max_scaled_err": err, "tol": tol,
                                  "finite": bool(torch.isfinite(out.float()).all())}
                    check(err <= tol and rows[tile]["finite"],
                          f"autotune {case}: kv tile {tile}: max |out - ref| / (1 + |ref|) = "
                          f"{err} > {tol}")
                res = autotune.autotune_flash_attention(q, k, v, causal=True, window=window,
                                                        cache=cache)
                for r in res.sweep:
                    rows[r["blocks"]["kv_tile"]]["us"] = r["us"]
                tiles += rows.values()
                winners[case] = res.blocks
                emit("autotune", kernel="flash_attention", case=case,
                     shape=[b, s, h, kv, d], dv=dv, window=window, sweep=res.sweep,
                     default_us=res.default_us, winner=res.blocks, us=res.us,
                     speedup=res.speedup, tiles=list(rows.values()))
                check(all(r["agrees"] for r in res.sweep),
                      f"autotune {case}: a tile disagrees with the default: {res.sweep}")
                if case == "granite_prefill":
                    granite = (q, k, v, ref, res.blocks["kv_tile"])
                del q, k, v, ref
            case, b, l, h, p, n = AUTOTUNE_SSD
            x = torch.randn(b, l, h, p, generator=gen, device="cuda").to(torch.bfloat16)
            dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).to(torch.bfloat16)
            a = (-torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))).to(
                torch.bfloat16)
            bm = torch.randn(b, l, n, generator=gen, device="cuda").to(torch.bfloat16)
            cm = torch.randn(b, l, n, generator=gen, device="cuda").to(torch.bfloat16)
            ref_y, ref_st = ssd_ref(x, dt, a, bm, cm)
            rows, tol = {}, SSD_TOL["torch.bfloat16"]
            for chunk in CHUNKS[torch.bfloat16]:
                y, st = ssd_scan_cuda(x, dt, a, bm, cm, chunk=chunk)
                torch.cuda.synchronize()
                err = max(scaled_err(y, ref_y), scaled_err(st, ref_st))
                rows[chunk] = {"kernel": "ssd_scan", "case": case, "chunk": chunk,
                               "max_abs_err": max((y.float() - ref_y.float()).abs().max().item(),
                                                  (st.float() - ref_st.float()).abs().max().item()),
                               "max_scaled_err": err, "tol": tol,
                               "finite": bool(torch.isfinite(y.float()).all()
                                              and torch.isfinite(st.float()).all())}
                check(err <= tol and rows[chunk]["finite"],
                      f"autotune {case}: chunk {chunk}: max scaled error {err} > {tol}")
            res = autotune.autotune_ssd_scan(x, dt, a, bm, cm, cache=cache)
            for r in res.sweep:
                rows[r["blocks"]["chunk"]]["us"] = r["us"]
            tiles += rows.values()
            winners[case] = res.blocks
            emit("autotune", kernel="ssd_scan", case=case, shape=[b, l, h, p, n],
                 sweep=res.sweep, default_us=res.default_us, winner=res.blocks, us=res.us,
                 speedup=res.speedup, tiles=list(rows.values()))
            check(all(r["agrees"] for r in res.sweep),
                  f"autotune {case}: a chunk disagrees with the default: {res.sweep}")
            # the winners are on disk, and the entry points launch them when
            # the caller names no tile
            disk = autotune.AutotuneCache(tmp)
            check(len(disk) == len(winners), f"autotune: {len(disk)} entries persisted, "
                  f"{len(winners)} sweeps")
            q, k, v, ref, tile = granite
            check(autotune.tuned_flash_tile(q, k, v, causal=True, window=0) == tile,
                  "autotune: the consultation path does not resolve to granite's winner")
            zero_counts()
            got = flash_attention(q, k, v, causal=True)
            y, st = ssd_scan(x, dt, a, bm, cm)
            torch.cuda.synchronize()
            launches = launch_counts()
            want = flash_attention_cuda(q, k, v, causal=True, window=0, kv_tile=tile)
            want_y, want_st = ssd_scan_cuda(x, dt, a, bm, cm, chunk=res.blocks["chunk"])
            consult = {"flash_kv_tile": tile, "flash_equal_to_winner": torch.equal(got, want),
                       "flash_max_scaled_err": scaled_err(got, ref),
                       "ssd_chunk": res.blocks["chunk"],
                       "ssd_equal_to_winner": torch.equal(y, want_y) and torch.equal(st, want_st),
                       "ssd_max_scaled_err": max(scaled_err(y, ref_y), scaled_err(st, ref_st)),
                       "launches": launches}
            emit("autotune_consult", cache_entries=len(disk), winners=winners, **consult)
            check(consult["flash_equal_to_winner"] and consult["ssd_equal_to_winner"],
                  f"autotune: the entry points did not launch the persisted winners: {consult}")
            check(consult["flash_max_scaled_err"] <= TOL["torch.bfloat16"]
                  and consult["ssd_max_scaled_err"] <= SSD_TOL["torch.bfloat16"],
                  f"autotune: the winners' outputs are off the plain versions: {consult}")
            check(launches == {"flash_attention": 1, "flash_attention_bwd": 0, "ssd_scan": 1},
                  f"autotune: the consulting calls launched {launches}")
        finally:
            if before is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = before
    del granite, x, dt, a, bm, cm, ref_y, ref_st, got, y, st, want, want_y, want_st
    torch.cuda.empty_cache()
    return tiles, launches


def card_config(arch: str):
    """The configuration an arch runs at on the card: full width, at
    CARD_DEPTH's depth where it has one."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.scaled(n_layers=CARD_DEPTH[arch]) if arch in CARD_DEPTH else cfg


def phase_serve(arch: str, seed: int) -> None:
    from repro_torch.serve import Request, TorchDecodeBackend, WrathServeDriver

    cfg = card_config(arch)
    torch.cuda.reset_peak_memory_stats()
    backend = TorchDecodeBackend(cfg, max_batch=4, max_len=128, seed=seed, device="cuda")
    rng = np.random.default_rng(seed + 1)

    def requests():
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                   size=SERVE_PROMPT).tolist(),
                        max_new_tokens=SERVE_NEW) for i in range(SERVE_REQUESTS)]

    driver = WrathServeDriver(cfg, n_replicas=2, max_batch=4, decode=backend, max_len=128)
    reqs = requests()
    rep = driver.serve(reqs, kill_replica_at=("replica0", 5))
    emit("serve_static_kill", config=cfg.name, layers=cfg.n_layers, completed=rep.completed,
         failed=rep.failed, tokens=rep.tokens_generated, tokens_per_s=rep.tokens_per_s,
         wall_s=rep.wall_s, decode_steps=rep.decode_steps, denylisted=rep.denylisted,
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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("serve_continuous", config=cfg.name, completed=rep.completed, failed=rep.failed,
         tokens=rep.tokens_generated, tokens_per_s=rep.tokens_per_s,
         requests_per_s=rep.requests_per_s, p50_s=rep.p50_s, p99_s=rep.p99_s,
         wall_s=rep.wall_s, decode_steps=rep.decode_steps, serve_peak_gb=peak_gb)
    check(rep.completed == SERVE_REQUESTS and rep.failed == 0,
          f"{arch}: continuous serve completed {rep.completed}/{SERVE_REQUESTS}")
    check(peak_gb <= MAX_PEAK_GB, f"{arch}: serve peak device memory {peak_gb} GB")
    driver.shutdown()
    del backend, driver, cont


def release() -> float:
    """Free what the last phase left: the serve drivers hold their backend
    (and its weights) in reference cycles that only the collector breaks.
    Returns the GB still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def _sdpa_kw(s: int, causal: bool, window: int) -> dict:
    mask = None
    if window:
        pos = torch.arange(s, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    return dict(attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)


def phase_flash_bwd_cases(seed: int) -> list[dict]:
    """The flash backward kernels against autograd of the plain forward in
    fp32, on the same values; and the forward with its lse output on
    against it off."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_lse_ref, flash_attention_ref
    from repro_torch.roofline.cost import attention_bwd_bound

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    cases = [  # (name, B, S, H, KV, D, dtype, causal, window)
        ("granite_train", 4, 1024, 32, 8, 64, torch.bfloat16, True, 0),
        ("granite_train_s2048", 4, 2048, 32, 8, 64, torch.bfloat16, True, 0),
        ("ragged_s100", 4, 100, 32, 8, 64, torch.bfloat16, True, 0),
        ("window256", 4, 1024, 32, 8, 64, torch.bfloat16, True, 256),
        ("d128", 4, 1024, 32, 8, 128, torch.bfloat16, True, 0),
        ("fp32", 4, 1024, 32, 8, 64, torch.float32, True, 0),
        ("fp32_d128", 2, 512, 32, 8, 128, torch.float32, True, 0),
    ]
    results = []
    for name, b, s, h, kv, d, dtype, causal, window in cases:
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(b, s, kv, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, s, kv, d, generator=gen, device="cuda").to(dtype)
        do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
        kw = dict(causal=causal, window=window)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        grads = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        ref_out = flash_attention_ref(*leaves, **kw)
        ref = torch.autograd.grad(ref_out, leaves, do.float(), retain_graph=True)
        lse_ref = flash_attention_lse_ref(q, k, v, **kw)
        # the yardstick: SDPA's backward on the same values
        lib_leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib_leaves, **_sdpa_kw(s, causal, window))
        do_t = do.transpose(1, 2)
        lib = torch.autograd.grad(lib_out, lib_leaves, do_t, retain_graph=True)
        torch.cuda.synchronize()
        tol = BWD_TOL[str(dtype)]
        names = ("dq", "dk", "dv")
        row = {"case": name, "shape": [b, s, h, kv, d], "dtype": str(dtype), "causal": causal,
               "window": window, "tol": tol,
               "max_scaled_err": {n: scaled_err(g, r) for n, g, r in zip(names, grads, ref)},
               "max_abs_err": {n: (g.float() - r).abs().max().item()
                               for n, g, r in zip(names, grads, ref)},
               "ref_abs_max": {n: r.abs().max().item() for n, r in zip(names, ref)},
               "library_max_scaled_err": {n: scaled_err(g.transpose(1, 2), r)
                                          for n, g, r in zip(names, lib, ref)},
               "lse_max_abs_err": (lse - lse_ref).abs().max().item(), "lse_tol": LSE_TOL,
               "finite": all(bool(torch.isfinite(g.float()).all()) for g in grads)}
        # determinism: a second launch on the same inputs gives the same bits
        again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        row["bit_equal"] = all(bool(torch.equal(a, g)) for a, g in zip(again, grads))
        del again

        def bwd():
            return flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)

        def lib_bwd():
            return torch.autograd.grad(lib_out, lib_leaves, do_t, retain_graph=True)

        row["ms"] = cuda_ms(bwd)
        row["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(ref_out, leaves, do.float(),
                                                              retain_graph=True),
                                  iters=3, warmup=1)
        row["library_ms"] = cuda_ms(lib_bwd)
        # device time from the profiler: SDPA's autograd call is paced by the
        # host at these sizes, so its event time varies from call to call
        row["device_ms"] = kernel_device_ms(bwd)
        row["library_device_ms"] = kernel_device_ms(lib_bwd)
        bound_ms, bound_by, flops, nbytes = attention_bwd_bound(b, s, h, kv, d, str(dtype),
                                                                causal, window)
        row.update(bound_ms=bound_ms, bound_by=bound_by, bound_frac=bound_ms / row["ms"],
                   vs_library=row["device_ms"] / row["library_device_ms"], flops=flops,
                   bytes=nbytes, tflops=flops / (row["ms"] * 1e-3) / 1e12)
        emit("flash_bwd_vs_plain", **row)
        worst = max(row["max_scaled_err"].values())
        check(worst <= tol and row["finite"],
              f"flash backward {name}: max |grad - ref| / (1 + |ref|) = {worst} > {tol}")
        check(row["bit_equal"], f"flash backward {name}: two launches differ")
        check(row["lse_max_abs_err"] <= LSE_TOL,
              f"flash forward lse {name}: max |lse - ref| = {row['lse_max_abs_err']}")
        results.append(row)
        del q, k, v, do, o, lse, grads, leaves, ref_out, ref, lib_leaves, lib_out, lib
        torch.cuda.empty_cache()

    # the forward with the lse epilogue against without, in turns (off on on off)
    q = torch.randn(4, 1024, 32, 64, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(4, 1024, 8, 64, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in "kv")
    o_off = flash_attention_cuda(q, k, v, causal=True, window=0)
    o_on, lse = flash_attention_cuda(q, k, v, causal=True, window=0, return_lse=True)
    torch.cuda.synchronize()
    # the kernel's device time from the profiler: back-to-back launches of a
    # 0.05 ms kernel are paced by the host, which the lse buffer's
    # allocation would add to
    times = {"off": [], "on": []}
    for which in ("off", "on", "on", "off"):
        times[which].append(kernel_device_ms(lambda: flash_attention_cuda(
            q, k, v, causal=True, window=0, return_lse=which == "on")))
    row = {"case": "granite_prefill", "shape": [4, 1024, 32, 8, 64], "dtype": "torch.bfloat16",
           "output_equal": bool(torch.equal(o_off, o_on)),
           "lse_max_abs_err": (lse - flash_attention_lse_ref(q, k, v, causal=True))
           .abs().max().item(), "lse_tol": LSE_TOL,
           "ms_lse_off": statistics.mean(times["off"]), "ms_lse_on": statistics.mean(times["on"]),
           "ms_rounds": times}
    emit("flash_fwd_lse", **row)
    check(row["output_equal"], "flash forward: the output changes when lse is written")
    check(row["lse_max_abs_err"] <= LSE_TOL,
          f"flash forward lse: max |lse - ref| = {row['lse_max_abs_err']} > {LSE_TOL}")
    del q, k, v, o_off, o_on, lse
    torch.cuda.empty_cache()
    return results


def attention_in_dtype(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0) -> torch.Tensor:
    """Softmax attention computed in q's dtype (the float64 referee)."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    p = torch.softmax(scores.masked_fill(~mask, -math.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@contextlib.contextmanager
def plain_attention(fn=None):
    """The model's attention through ``fn`` (default: autograd of the plain
    version ``flash_attention_ref``) in place of the kernels."""
    import repro_torch.models.layers as layers
    from repro_torch.kernels.ref import flash_attention_ref

    kernel = layers.flash_attention
    layers.flash_attention = fn or (lambda q, k, v, *, causal=True, window=0:
                                    flash_attention_ref(q, k, v, causal=causal, window=window))
    try:
        yield
    finally:
        layers.flash_attention = kernel


def _leaf_paths(tree, path=""):
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _leaf_paths(val, f"{path}/{key}")
    elif isinstance(tree, list):
        for i, val in enumerate(tree):
            yield from _leaf_paths(val, f"{path}/{i}")
    else:
        yield path, tree


def phase_train_grad_check(seed: int) -> None:
    """granite-3-2b at full width and depth 2: loss_fn and every parameter
    gradient with attention on the kernels (both directions) and with it
    through the plain version, in fp32 and in bf16 compute, each held to
    the same loss_fn in float64 (GRAD_CHECK_TOL says how), at the
    reference's init and at a well-conditioned one."""
    from repro_torch.configs import get_config
    from repro_torch.data import batch_for
    from repro_torch.distributed.step import batch_to
    from repro_torch.models import materialize, param_defs

    base = get_config("granite_3_2b").scaled(n_layers=2)
    b, s = 2, 1024
    batch = batch_to(batch_for(base, b, s, 0, seed=seed), torch.device("cuda"))
    reference = materialize(param_defs(base), seed, "cuda")
    # (L, d_in, d_out) leaves drawn at 1 / sqrt(L): rescaled to 1 / sqrt(d_in)
    fan_in = _fan_in_per_layer(reference, base)      # granite has no encoder
    for init, params_bf in (("reference", reference), ("fan_in_per_layer", fan_in)):
        _grad_check_init(init, params_bf, batch, base)
    del reference, fan_in
    torch.cuda.empty_cache()


def _grad_check_init(init: str, params_bf, batch, base) -> None:
    from repro_torch.distributed.step import loss_and_grads
    from repro_torch.models.spec import tree_map

    def rel_l2(a_tree, r_tree) -> dict[str, float]:
        return {path: ((a.double() - r.double()).norm() / r.double().norm()).item()
                for (path, a), (_, r) in zip(_leaf_paths(a_tree), _leaf_paths(r_tree))}

    def loss_err(a, r) -> float:
        return abs(a.item() - r.item()) / (1 + abs(r.item()))

    b, s = batch["inputs"].shape
    with plain_attention(attention_in_dtype):
        loss64, _, g64 = loss_and_grads(tree_map(lambda t: t.double(), params_bf), batch,
                                        base.scaled(compute_dtype="float64"))
    for compute in ("float32", "bfloat16"):
        cfg = base.scaled(compute_dtype=compute)
        params = params_bf if compute == "bfloat16" else tree_map(lambda t: t.float(), params_bf)
        zero_counts()
        loss_k, _, g_k = loss_and_grads(params, batch, cfg)
        torch.cuda.synchronize()
        kernel_launches = launch_counts()
        with plain_attention():
            zero_counts()
            loss_p, _, g_p = loss_and_grads(params, batch, cfg)
            torch.cuda.synchronize()
            plain_launches = launch_counts()
        err_k, err_p, k_vs_p = rel_l2(g_k, g64), rel_l2(g_p, g64), rel_l2(g_k, g_p)
        tol = GRAD_CHECK_TOL[compute]
        limit = {leaf: max(tol["grad"], 2 * err_p[leaf]) for leaf in err_k}
        worst = max(err_k, key=lambda leaf: err_k[leaf] / limit[leaf])
        lk, lp = loss_err(loss_k, loss64), loss_err(loss_p, loss64)
        loss_limit = max(tol["loss"], 2 * lp)
        finite = bool(torch.isfinite(loss_k)) and all(
            bool(torch.isfinite(g).all()) for _, g in _leaf_paths(g_k))
        want = {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers,
                "ssd_scan": 0}
        what = f"train_grad_check {init} {compute}"
        emit("train_grad_check", config=cfg.name, init=init, layers=cfg.n_layers, batch=b,
             seq=s, compute=compute, remat=True, loss_kernel=loss_k.item(),
             loss_plain=loss_p.item(), loss_f64=loss64.item(), loss_err_kernel=lk,
             loss_err_plain=lp, loss_limit=loss_limit, worst_leaf=worst,
             worst_leaf_err_kernel=err_k[worst], worst_leaf_err_plain=err_p[worst],
             worst_leaf_limit=limit[worst], rel_l2_kernel_vs_f64=err_k,
             rel_l2_plain_vs_f64=err_p, rel_l2_kernel_vs_plain=k_vs_p, tol=tol, finite=finite,
             kernel_launches=kernel_launches, plain_launches=plain_launches)
        check(finite, f"{what}: a loss or gradient is not finite")
        check(kernel_launches == want, f"{what}: kernel launches {kernel_launches}, "
              f"expected {want}")
        check(not any(plain_launches.values()), f"{what}: the plain run launched "
              f"{plain_launches}")
        check(lk <= loss_limit, f"{what}: loss {loss_k.item()} is {lk} from the float64 "
              f"loss {loss64.item()}, limit {loss_limit}")
        check(err_k[worst] <= limit[worst], f"{what}: gradient {worst} is {err_k[worst]} from "
              f"float64 (the plain path {err_p[worst]}), limit {limit[worst]}")
        del params, g_k, g_p
    del g64


def phase_train_step(seed: int) -> dict[str, int]:
    """granite-3-2b at full width and depth through build_train_step: bf16,
    B 4, S 1024, remat; one warm-up step, then three timed steps on one
    fixed batch, and one more under the roofline counter (ROOFLINE_RUNS).
    Returns one step's kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.data import batch_for
    from repro_torch.distributed.step import batch_to, build_train_step
    from repro_torch.models import materialize, param_defs
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.roofline import count_step
    from repro_torch.roofline.cost import attention_bound, attention_bwd_bound

    cfg = get_config("granite_3_2b")
    b, s = 4, 1024
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = materialize(param_defs(cfg), seed, "cuda")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=1)   # the default 100 warm-up steps keep lr ~0
    opt_state = init_opt_state(params, opt_cfg)
    step = build_train_step(cfg, opt_cfg)
    batch = batch_to(batch_for(cfg, b, s, 0, seed=seed), torch.device("cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt_state, _ = step(params, opt_state, batch)
    torch.cuda.synchronize()
    warmup_ms = (time.perf_counter() - t0) * 1e3
    steps = []
    for _ in range(3):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": m["loss"].item(),
                      "ce_loss": m["ce_loss"].item(), "grad_norm": m["grad_norm"].item(),
                      "lr": m["lr"].item(), "launches": launch_counts()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = device_profile(lambda: step(params, opt_state, batch))
    ms = statistics.median(x["ms"] for x in steps)
    attn = [m for m, _ in cfg.block_kinds()].count("attn")
    want = {"flash_attention": 2 * attn, "flash_attention_bwd": attn, "ssd_scan": 0}
    # the counter's peak of what the step allocates, beside the allocator's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, cost = count_step(step, params, opt_state, batch)
    peaks = {"counted_gb": cost.peak_bytes / 1e9,
             "allocator_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
    hd = cfg.resolved_head_dim
    ROOFLINE_RUNS["granite_3_2b train_step"] = dict(
        cfg=cfg, cost=cost, ms=ms, kind="train",
        batch=b, seq=s, tokens=b * s, expected=want, peak_gb=peak_gb,
        per_launch={"flash_attention": attention_bound(b, s, s, cfg.n_heads, cfg.n_kv_heads, hd,
                                                       hd, "torch.bfloat16", True, 0)[2],
                    "flash_attention_bwd": attention_bwd_bound(b, s, cfg.n_heads, cfg.n_kv_heads,
                                                               hd, "torch.bfloat16", True, 0)[2]})
    emit("train_step", config=cfg.name, layers=cfg.n_layers, batch=b, seq=s, remat=True,
         dtype="bfloat16", warmup_step_ms=warmup_ms, step_ms=ms, tokens_per_s=b * s / ms * 1e3,
         steps=steps, peak_mem_gb=peak_gb, expected_launches=want, device_profile=prof,
         count_peak=peaks)
    check(all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"]) for x in steps),
          "train_step: a loss or grad_norm is not finite")
    check(all(x["launches"] == want for x in steps),
          f"train_step: launches {[x['launches'] for x in steps]}, expected {want} a step")
    check(steps[2]["loss"] < steps[0]["loss"],
          f"train_step: loss did not fall: {[x['loss'] for x in steps]}")
    del params, opt_state, batch
    torch.cuda.empty_cache()
    return steps[-1]["launches"]


def phase_train_supervisor(seed: int) -> dict[str, int]:
    """WrathTrainSupervisor on the card: granite-3-2b at full width and
    depth 4, 3 hosts + bighost, global batch 6, seq 256, 20 steps,
    checkpoints every 5, host01 lost at step 5 and a NaN at step 12; then a
    fresh supervisor resumes from the last checkpoint.  Returns the run's
    kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainEvent, WrathTrainSupervisor

    cfg = get_config("granite_3_2b").scaled(n_layers=4)
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    steps, nan_step, every = 20, 12, 5
    kw = dict(n_hosts=3, global_batch=6, seq_len=256, ckpt_dir=str(ckpt), ckpt_every=every,
              data_seed=seed, device="cuda")
    opt = OptConfig(lr=3e-3, warmup_steps=2, total_steps=steps)   # launch/train.py's lr
    events = [TrainEvent(step=5, kind="host_down", host="host01"),
              TrainEvent(step=nan_step, kind="nan")]
    zero_counts()
    t0 = time.perf_counter()
    rep = WrathTrainSupervisor(cfg, opt, **kw).run(steps, events=events)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    rep2 = WrathTrainSupervisor(cfg, opt, **kw).run(steps + 2)   # resumes at step `steps`
    shutil.rmtree(ckpt, ignore_errors=True)
    # the report counts every step it ran: the NaN at step 12 restores step
    # 10's checkpoint, so step 11 runs twice
    replayed = nan_step - 1 - (nan_step - 1) // every * every
    emit("train_supervisor", config=cfg.name, layers=cfg.n_layers, hosts=3, global_batch=6,
         seq=256, steps=steps, steps_completed=rep.steps_completed, replayed_steps=replayed,
         restores=rep.restores, final_hosts=rep.final_hosts, denylisted=rep.denylisted,
         speculations=rep.speculations, losses=rep.losses, wall_s=wall_s,
         recoveries=[[r["step"], r["error"], r["host"], r["action"], r["rung"]]
                     for r in rep.recoveries],
         launches=launches, resumed_steps=rep2.steps_completed, resumed_losses=rep2.losses)
    check(rep.steps_completed == steps + replayed,
          f"train_supervisor: {rep.steps_completed} steps, expected {steps + replayed}")
    check(rep.restores >= 1, "train_supervisor: the NaN did not restore a checkpoint")
    check(any(r["error"] == "NumericalDivergenceError" for r in rep.recoveries),
          "train_supervisor: no NumericalDivergenceError recovery")
    check(rep.final_hosts == 2, f"train_supervisor: {rep.final_hosts} hosts left, expected 2")
    # each step draws a new batch: compare means of three steps
    first, last = statistics.mean(rep.losses[:3]), statistics.mean(rep.losses[-3:])
    check(all(math.isfinite(x) for x in rep.losses) and last < first,
          f"train_supervisor: loss did not fall: {first} -> {last} (means of 3 steps)")
    check(rep2.steps_completed == 2 and statistics.mean(rep2.losses) < first,
          f"train_supervisor: the resumed run ran {rep2.steps_completed} steps at loss "
          f"{rep2.losses}, not from the trained checkpoint (first steps {first})")
    check(launches["flash_attention"] == launches["flash_attention_bwd"] > 0,
          f"train_supervisor: launches {launches}")
    torch.cuda.empty_cache()
    return launches


# the paper's evaluation path (§VII) through the port's engine: fedlearn's
# MLP and moldesign's eigenvalue and ridge surrogate compute on the card
# inside the DFK's tasks; Table IV's and fig 4's MapReduce runs are host-side.
# fedlearn's card-vs-CPU limit is set from its reading: 6.0e-8 with TF32 off
# (NVIDIA H100 80GB HBM3, 700 W), so 1e-6 leaves a margin of ~17x, and the
# phase checks that the same run with TF32 on reads above it
WRATH_APP_TOL = {"fedlearn_card_vs_cpu": 1e-6, "fedlearn_injected_vs_clean": 1e-6,
                 "moldesign_energy": 1e-5}


def run_app_kept(apps, app: str, cluster, **kw):
    """``apps.run_app`` (``apps`` is either package's ``apps``), keeping the
    app's futures, which it reports only as metrics: the registry's entry
    is wrapped in place for the run, so its workflow scope keeps the app's
    name."""
    submit, kept = apps.APPS[app], []

    def keep(**app_kwargs):
        kept.extend(submit(**app_kwargs))
        return kept

    apps.APPS[app] = keep
    try:
        return apps.run_app(app, cluster, **kw), kept
    finally:
        apps.APPS[app] = submit


def _profiled(fn):
    """``fn()`` under the profiler, with the CUDA kernels it launched from
    any thread (CUPTI traces the device, not the calling thread) and
    their summed device ms. After the earlier phases' windows the
    profiler drops records (a client_update read 66 of its 87 kernels,
    NVIDIA H100), so these are readings, not counts to gate on."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset"))]
    return (out, sum(e.count for e in kernels),
            sum(e.self_device_time_total for e in kernels) / 1e3)


def _allocations(fn):
    """``fn()`` and the CUDA allocations it made from any thread: the
    caching allocator's count of requests, which nothing drops."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_stats()["allocation.all.allocated"] - before


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2)) for k in want)
    return math.sqrt(num / sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want))


def _first_calls_ms() -> dict[str, float]:
    """The first CUDA calls fedlearn's and moldesign's tasks make, each
    timed to its synchronize, so no task pays for a library's lazy load
    (client_update's est_duration_s of 0.5 feeds the straggler watch): the
    context, cuBLAS, the solver behind eigvalsh and solve, and cuBLAS
    again from a new thread, as each executor worker makes its own handle."""
    import threading

    def first(fn) -> float:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = {"context": first(lambda: torch.ones(1, device="cuda"))}
    a = torch.eye(16, device="cuda") + 0.1
    out |= {"matmul": first(lambda: a @ a),
            "eigvalsh": first(lambda: torch.linalg.eigvalsh(a)),
            "solve": first(lambda: torch.linalg.solve(a, a[:, 0]))}
    worker = threading.Thread(target=lambda: out.__setitem__("matmul_new_thread",
                                                             first(lambda: a @ a)))
    worker.start()
    worker.join(timeout=60)
    check(not worker.is_alive(), "wrath_apps: a new thread's first matmul did not return")
    return out


def _app_row(res) -> dict:
    return {"success": res.success, "error": res.error, "makespan_s": res.makespan,
            "task_sr": res.task_success_rate, "retry_sr": res.retry_success_rate,
            "overhead_ratio": res.overhead_ratio, "injected": res.injected,
            "retries": res.stats["retries"]}


def phase_wrath_apps(seed: int) -> dict[str, int]:
    """fedlearn and moldesign at the paper's scale on the card through
    ``run_app`` → ``DataFlowKernel`` → ``FailureInjector``, each against
    the same run on the CPU; then Table IV's and fig 4's MapReduce cases."""
    from repro_torch import apps
    from repro_torch.apps import fedlearn as fl, moldesign, run_app
    from repro_torch.core import MonitoringDatabase
    from repro_torch.core.failures import RandomSeedError
    from repro_torch.engine import Cluster
    from repro_torch.engine.policies import WrathPolicy
    from repro_torch.injection import FailureInjector

    out: dict = {"first_call_ms": _first_calls_ms()}
    # the CUDA allocations of the tasks' work, from calls on this thread at
    # the run's shapes: a run makes at least their sum over its tasks, and
    # falls short of it by a whole task's count when one task computed on
    # the CPU (each executor thread's first cuBLAS call adds its workspace,
    # so each probe is the second call, after autograd's thread has its own).
    # simulate runs here on each molecule the run simulates, to its first
    # draw that converges
    clients, rounds, epochs, n = fl.SCALES["paper"]
    init, batch, mrounds, pool = moldesign.SCALES["paper"]
    sim_ids = list(range(init)) + list(range(init, pool))[:mrounds * batch]
    p0 = fl.init_params(seed)

    def simulate_all() -> None:
        for mol_id in sim_ids:
            while True:
                try:
                    moldesign.simulate.fn(mol_id, seed, device="cuda")
                    break
                except RandomSeedError:
                    continue

    def probe(fn) -> int:
        fn()
        return _allocations(fn)[1]

    fit = [(m, float(m)) for m in range(init)]
    w0 = moldesign.train_surrogate.fn(fit, device="cuda")
    probed = {
        "client_update": probe(lambda: fl.client_update.fn(p0, 0, n, epochs, device="cuda")),
        "evaluate": probe(lambda: fl.evaluate.fn(p0, device="cuda")),
        "simulate_all": probe(simulate_all),
        "train_surrogate": probe(lambda: moldesign.train_surrogate.fn(fit, device="cuda")),
        "inference": probe(lambda: moldesign.inference.fn(w0, list(range(init, pool)),
                                                          device="cuda"))}
    check(min(probed.values()) > 0, f"wrath_apps: a task allocated nothing on the card: {probed}")
    out["allocations_probed"] = probed
    zero_counts()

    # -- fedlearn, 8 clients x 3 rounds x 3 epochs x 1024 samples: 30 tasks
    def fedlearn(device: str, **kw):
        kw.setdefault("policy", [WrathPolicy()])
        return run_app_kept(apps, "fedlearn", kw.pop("cluster", Cluster.homogeneous(4)),
                            scale="paper", seed=seed, device=device, wait_timeout=300, **kw)

    ((clean, kept), allocs), kernels, device_ms = _profiled(
        lambda: _allocations(lambda: fedlearn("cuda")))
    check(clean.success, f"wrath_apps: fedlearn on the card failed: {clean.error}")
    losses = [f.result(timeout=0) for f in kept[:-1]]
    params = kept[-1].result(timeout=0)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"wrath_apps: fedlearn's loss did not fall: {losses}")
    least = clients * rounds * probed["client_update"] + rounds * probed["evaluate"]
    check(kernels > 0, "wrath_apps: no CUDA kernel ran inside fedlearn's tasks")
    # a surplus under one client_update's count: one that ran elsewhere shows
    check(least <= allocs < least + probed["client_update"],
          f"wrath_apps: fedlearn's run made {allocs} CUDA allocations, against the "
          f"{least} of its {clients * rounds} client_updates and {rounds} evaluates")
    cpu, kept_cpu = fedlearn("cpu")
    check(cpu.success, f"wrath_apps: fedlearn on the CPU failed: {cpu.error}")
    params_cpu = kept_cpu[-1].result(timeout=0)
    card_vs_cpu = _rel_l2(params, params_cpu)
    check(card_vs_cpu <= WRATH_APP_TOL["fedlearn_card_vs_cpu"],
          f"wrath_apps: fedlearn card vs CPU rel L2 {card_vs_cpu}")
    # the limit tells TF32 from fp32: the same run with TF32's matmuls reads above it
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32, kept_tf32 = fedlearn("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    check(tf32.success, f"wrath_apps: fedlearn with TF32 on failed: {tf32.error}")
    tf32_vs_cpu = _rel_l2(kept_tf32[-1].result(timeout=0), params_cpu)
    check(tf32_vs_cpu > WRATH_APP_TOL["fedlearn_card_vs_cpu"],
          f"wrath_apps: fedlearn with TF32 on reads {tf32_vs_cpu} from the CPU run, within "
          f"the fp32 limit {WRATH_APP_TOL['fedlearn_card_vs_cpu']}")

    mon = MonitoringDatabase()
    inj = FailureInjector("memory", rate=0.3, seed=seed)
    hurt, kept_hurt = fedlearn("cuda", cluster=Cluster.paper_testbed(small_nodes=3, big_nodes=1),
                               injector=inj, monitor=mon, default_pool="small-mem")
    moved = {name: hist["big-mem"].successes for name in ("client_update", "aggregate", "evaluate")
             if "big-mem" in (hist := mon.pool_history(name))}
    check(hurt.success and inj.count > 0 and hurt.stats["retries"] > 0 and any(moved.values()),
          f"wrath_apps: memory-injected fedlearn under WRATH: success {hurt.success}, "
          f"injected {inj.count}, retries {hurt.stats['retries']}, on big-mem {moved}")
    injected_vs_clean = _rel_l2(kept_hurt[-1].result(timeout=0), params)
    check(injected_vs_clean <= WRATH_APP_TOL["fedlearn_injected_vs_clean"],
          f"wrath_apps: memory-injected fedlearn vs the clean run rel L2 {injected_vs_clean}")
    base, _ = fedlearn("cuda", cluster=Cluster.paper_testbed(small_nodes=3, big_nodes=1),
                       injector=FailureInjector("memory", rate=0.3, seed=seed),
                       default_pool="small-mem", policy=[])
    check(not base.success, "wrath_apps: memory-injected fedlearn succeeded with no policy")
    out["fedlearn"] = {
        "scale": "paper", "tasks": clean.stats["submitted"], "losses": losses,
        "card": {**_app_row(clean), "cuda_kernels": kernels, "device_ms": device_ms,
                 "cuda_allocations": allocs, "least_allocations": least},
        "cpu": _app_row(cpu), "card_vs_cpu_rel_l2": card_vs_cpu,
        "tf32_card_vs_cpu_rel_l2": tf32_vs_cpu,
        "memory_injected_wrath": {**_app_row(hurt), "on_big_mem": moved,
                                  "vs_clean_rel_l2": injected_vs_clean},
        "memory_injected_baseline": _app_row(base), "tol": WRATH_APP_TOL}

    # -- moldesign, 16 rounds: Random Seed Errors retried in place --------
    def mol(device: str):
        moldesign._ATTEMPTS.clear()       # the same seed-error draws each run
        mon = MonitoringDatabase()
        res, kept = run_app_kept(apps, "moldesign", Cluster.homogeneous(4),
                                 policy=[WrathPolicy()], monitor=mon, scale="paper",
                                 seed=seed, device=device, default_retries=6,
                                 wait_timeout=300)
        check(res.success, f"wrath_apps: moldesign on {device} failed: {res.error}")
        vals = [f.result(timeout=0) for f in kept]
        seed_errors = sum(r.exception_type == "RandomSeedError" for r in mon.failures)
        return res, vals, seed_errors

    ((mres, mvals, seed_errors), mallocs), mkernels, mdevice_ms = _profiled(
        lambda: _allocations(lambda: mol("cuda")))
    _, cvals, cpu_seed_errors = mol("cpu")
    check(seed_errors > 0, "wrath_apps: moldesign recovered no RandomSeedError")
    energies = [(v, c) for v, c in zip(mvals, cvals) if isinstance(v, tuple)]
    picked = [(v, c) for v, c in zip(mvals, cvals) if isinstance(v, list)]
    energy_err = max(abs(v[1] - c[1]) / abs(c[1]) for v, c in energies)
    check(all(v[0] == c[0] for v, c in energies) and energy_err <= WRATH_APP_TOL["moldesign_energy"],
          f"wrath_apps: moldesign energies card vs CPU {energy_err}")
    check(all(v == c for v, c in picked), "wrath_apps: moldesign picked other molecules on the card")
    check(sorted(v[0] for v, _ in energies) == sim_ids,
          f"wrath_apps: moldesign simulated {sorted(v[0] for v, _ in energies)}")
    mleast = probed["simulate_all"] + mrounds * (probed["train_surrogate"] + probed["inference"])
    check(mkernels > 0, "wrath_apps: no CUDA kernel ran inside moldesign's tasks")
    check(mallocs >= mleast,
          f"wrath_apps: moldesign's run made {mallocs} CUDA allocations, fewer than the "
          f"{mleast} of its {len(energies)} simulates and {mrounds} rounds' surrogate and "
          f"inference")
    out["moldesign"] = {"scale": "paper", "tasks": mres.stats["submitted"],
                        "card": {**_app_row(mres), "cuda_kernels": mkernels,
                                 "device_ms": mdevice_ms, "cuda_allocations": mallocs,
                                 "least_allocations": mleast},
                        "random_seed_errors": {"card": seed_errors, "cpu": cpu_seed_errors},
                        "energy_rel_err": energy_err, "simulations": len(energies),
                        "rounds_picked_equal": len(picked)}

    # -- Table IV: MapReduce, import and memory failures, rate 0.4 --------
    def testbed(failure: str):
        if failure == "import":
            return Cluster.paper_testbed(small_nodes=3, big_nodes=1, with_pkg_pool=True,
                                         package="wrathpkg"), "no-pkg"
        return Cluster.paper_testbed(small_nodes=3, big_nodes=1), "small-mem"

    def mapreduce(failure, mode, inj, scale, cluster=None, pool=None):
        if cluster is None:
            cluster, pool = testbed(failure)
        return run_app("mapreduce", cluster, policy=[WrathPolicy()] if mode == "wrath" else [],
                       monitor=MonitoringDatabase(), injector=inj, scale=scale,
                       default_pool=pool, default_retries=2, wait_timeout=120)

    table4 = {}
    for failure in ("import", "memory"):
        for mode in ("wrath", "baseline"):
            runs = [mapreduce(failure, mode, FailureInjector(
                failure, rate=0.4, seed=r, app_tag=f"t4:{failure}:{r}"), "small")
                for r in range(4)]
            table4[f"{mode}_{failure}"] = {
                key: statistics.mean(float(getattr(x, attr)) for x in runs)
                for key, attr in (("task_sr", "task_success_rate"),
                                  ("retry_sr", "retry_success_rate"), ("app_success", "success"),
                                  ("makespan_s", "makespan"), ("overhead_ratio", "overhead_ratio"))}
            table4[f"{mode}_{failure}"]["task_sr_by_seed"] = [x.task_success_rate for x in runs]
            table4[f"{mode}_{failure}"]["retry_sr_by_seed"] = [x.retry_success_rate for x in runs]
    out["table4"] = table4
    # the CPU tests' own cases (tests/test_apps.py): Table IV's, and fig 4's
    t4 = {mode: mapreduce("memory", mode, FailureInjector("memory", rate=0.4, seed=1,
                                                          app_tag="t4"), "tiny")
          for mode in ("wrath", "baseline")}
    check(t4["wrath"].success and t4["wrath"].retry_success_rate > 0.4
          and not t4["baseline"].success,
          f"wrath_apps: Table IV case: wrath {_app_row(t4['wrath'])}, "
          f"baseline {_app_row(t4['baseline'])}")
    fig4 = {mode: mapreduce("zero_division", mode, FailureInjector(
        "zero_division", rate=0.3, seed=5, app_tag="ttf"), "tiny",
        cluster=Cluster.homogeneous(4)) for mode in ("wrath", "baseline")}
    check(fig4["wrath"].stats["retries"] == 0 and fig4["baseline"].stats["retries"] > 0
          and not fig4["wrath"].success and not fig4["baseline"].success,
          f"wrath_apps: fig 4 case: wrath {_app_row(fig4['wrath'])}, "
          f"baseline {_app_row(fig4['baseline'])}")
    out["table4_test_case"] = {k: _app_row(v) for k, v in t4.items()}
    out["fig4_test_case"] = {k: _app_row(v) for k, v in fig4.items()}
    launches = launch_counts()
    check(not any(launches.values()), f"wrath_apps: a model kernel ran: {launches}")
    emit("wrath_apps", **out)
    return launches


# the sim plane: fedlearn under ``SimHarness`` (the WRATH engine on the
# virtual clock) runs each task's body inline, on the thread that drives the
# clock, and lets it take its est_duration_s in virtual time.  The fault
# takes default-n001 down 0.1 virtual s into the first round, while its two
# client_updates run (0 to 0.5 s): the heartbeat watcher sees the silence
# before they deliver and fails them over (a retry_decision, then a second
# attempt on another node).  A fault at 0.25 s or later finds them done.
SIM_FAULT = (0.1, "default-n001")


def sim_fedlearn(sim, policy, submit, *, fault=None, **kw) -> dict:
    """fedlearn's ``submit`` (either package's: ``sim`` is its ``sim``
    package, ``policy`` its ``WrathPolicy``) inside ``SimHarness`` on four
    nodes with a trace; ``fault`` is (virtual s, node) for ``fail_node``."""
    h = sim.SimHarness(sim.SimCluster.homogeneous(4), policy=[policy()], trace=True)
    t0 = time.perf_counter()
    with h:
        futs = submit(**kw)
        if fault is not None:
            h.advance(fault[0])
            h.fail_node(fault[1])
        done = h.wait_all(timeout=600)
    wall_s = time.perf_counter() - t0
    return {"done": done, "trace": h.trace(), "makespan_s": h.clock.now(),
            "stats": dict(h.dfk.stats), "wall_s": wall_s,
            "losses": [f.result(timeout=0) for f in futs[:-1]],
            "params": futs[-1].result(timeout=0)}


def rerouted(trace: str, node: str) -> dict:
    """What the trace shows of ``node``'s loss: the later attempts placed
    off it, the node each of their tasks finished on, and the placements
    on it after its heartbeat was lost."""
    retried, finished, after_loss, lost = [], {}, 0, False
    for line in trace.splitlines():
        _, scope, event, payload = line.split(" ", 3)
        d = json.loads(payload)
        if event == "heartbeat_lost" and d["node"] == node:
            lost = True
        elif scope == "task" and event == "scheduled":
            if d["attempt"] > 0 and d["node"] != node:
                retried.append(line)
            if lost and d["node"] == node:
                after_loss += 1
        elif scope == "task" and event == "finished":
            finished[d["task_id"]] = d["node"]
    ids = [json.loads(line.split(" ", 3)[3])["task_id"] for line in retried]
    return {"retried": retried, "finished_on": {t: finished.get(t) for t in ids},
            "placed_after_loss": after_loss}


def sim_host_planes(seed: int, scenarios: int, serve_scenarios: int) -> dict:
    """The sim plane's host checks: a seeded chaos campaign twice (every
    invariant, one sha256 of the traces), a serve campaign with its
    determinism check, each chaos-corpus entry replayed twice with its
    promoted signatures, and the analysis CLI's two gates."""
    import hashlib

    from repro_torch.sim import (campaign, load_corpus, run_scenario, serve_campaign,
                                 violation_signature)

    out: dict = {}
    digests, walls = [], []
    for _ in range(2):
        rep = campaign(scenarios, base_seed=seed)
        check(rep.ok, f"wrath_sim: {rep.summary()}")
        digests.append(hashlib.sha256("\n".join(r.trace for r in rep.results).encode())
                       .hexdigest())
        walls.append(rep.wall_seconds)
    check(digests[0] == digests[1], f"wrath_sim: two campaigns, two digests {digests}")
    out["campaign"] = {"scenarios": scenarios, "base_seed": seed, "sha256": digests[0],
                       "events": sum(r.events_executed for r in rep.results),
                       "wall_s": walls, "scenarios_per_s": [scenarios / w for w in walls]}
    t0 = time.perf_counter()
    results = serve_campaign(serve_scenarios, base_seed=seed, check_determinism=True)
    wall = time.perf_counter() - t0
    bad = [(r.seed, r.violations) for r in results if not r.ok]
    check(not bad, f"wrath_sim: serve campaign violations {bad}")
    out["serve_campaign"] = {"scenarios": serve_scenarios, "base_seed": seed, "wall_s": wall,
                             "scenarios_per_s": serve_scenarios / wall}
    entries = load_corpus(ROOT / "tests" / "chaos_corpus")
    check(bool(entries), "wrath_sim: no chaos corpus entry")
    for path, scenario, expect, _ in entries:
        first, second = run_scenario(scenario), run_scenario(scenario)
        check(first.trace == second.trace, f"wrath_sim: {path.name} replays two traces")
        got = sorted({violation_signature(v) for v in first.violations})
        check(got == sorted(expect), f"wrath_sim: {path.name} gave {got}, pinned {expect}")
    out["corpus_entries"] = len(entries)
    out["analysis"] = {}
    for flag in ("--strict", "--check-registry"):
        proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", flag],
                              capture_output=True, text=True, cwd=ROOT, timeout=300,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        check(proc.returncode == 0,
              f"wrath_sim: analysis {flag} exit {proc.returncode}: {proc.stdout}{proc.stderr}")
        out["analysis"][flag] = proc.stdout.strip().splitlines()[-1]
    return out


def phase_wrath_sim(seed: int) -> dict[str, int]:
    """fedlearn at the paper's scale computing on the card under the sim
    plane's virtual clock, clean and with a node lost mid-round, each held
    to the same run on the CPU (trace byte for byte, weights at the
    wrath_apps limit); then the sim plane's host checks."""
    from repro_torch import sim
    from repro_torch.apps import fedlearn as fl
    from repro_torch.engine.policies import WrathPolicy

    clients, rounds, epochs, n = fl.SCALES["paper"]
    p0 = fl.init_params(seed)

    def probe(fn) -> int:
        fn()
        return _allocations(fn)[1]

    # the tasks run on this thread, so each probe is what one task allocates
    probed = {"client_update": probe(lambda: fl.client_update.fn(p0, 0, n, epochs, device="cuda")),
              "evaluate": probe(lambda: fl.evaluate.fn(p0, device="cuda"))}
    check(min(probed.values()) > 0, f"wrath_sim: a task allocated nothing on the card: {probed}")
    least = clients * rounds * probed["client_update"] + rounds * probed["evaluate"]
    zero_counts()

    def run(device: str, fault=None) -> dict:
        return sim_fedlearn(sim, WrathPolicy, fl.submit, fault=fault, scale="paper", seed=seed,
                            device=device)

    tol = WRATH_APP_TOL["fedlearn_card_vs_cpu"]
    out: dict = {"scale": "paper", "fault": list(SIM_FAULT), "allocations_probed": probed,
                 "least_allocations": least, "tol": tol}
    runs = {}
    for name, fault in (("clean", None), ("faulted", SIM_FAULT)):
        card, allocs = _allocations(lambda: run("cuda", fault))
        cpu = run("cpu", fault)
        check(card["done"] and cpu["done"], f"wrath_sim: the {name} run did not finish")
        check(card["trace"] == cpu["trace"],
              f"wrath_sim: the {name} run's trace on the card differs from the CPU's")
        vs_cpu = _rel_l2(card["params"], cpu["params"])
        check(vs_cpu <= tol, f"wrath_sim: {name} card vs CPU rel L2 {vs_cpu}")
        check(allocs >= least, f"wrath_sim: the {name} run made {allocs} CUDA allocations, "
              f"fewer than the {least} of its {clients * rounds} client_updates and "
              f"{rounds} evaluates")
        losses = card["losses"]
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"wrath_sim: the {name} run's loss did not fall: {losses}")
        runs[name] = card
        out[name] = {"virtual_makespan_s": card["makespan_s"], "wall_s": card["wall_s"],
                     "cpu_wall_s": cpu["wall_s"], "trace_lines": len(card["trace"].splitlines()),
                     "tasks": card["stats"]["submitted"], "retries": card["stats"]["retries"],
                     "losses": losses, "card_vs_cpu_rel_l2": vs_cpu, "cuda_allocations": allocs}
    clean, faulted = runs["clean"], runs["faulted"]
    check(all(np.array_equal(faulted["params"][k], clean["params"][k]) for k in clean["params"]),
          "wrath_sim: the faulted run's weights differ from the clean run's")
    # the lost node's running client_updates are failed over; their first
    # attempts may still deliver first (heartbeat silence is not proof of
    # death, sim/cluster.py hardware_down), and no task is placed there again
    moved = rerouted(faulted["trace"], SIM_FAULT[1])
    check("heartbeat_lost" in faulted["trace"] and "heartbeat_lost" not in clean["trace"],
          "wrath_sim: heartbeat_lost is not in the faulted trace alone")
    check(bool(moved["retried"]) and faulted["stats"]["retries"] >= 1
          and moved["placed_after_loss"] == 0,
          f"wrath_sim: {SIM_FAULT[1]}'s loss was not rerouted: retries "
          f"{faulted['stats']['retries']}, {moved}")
    out["faulted"]["rerouted"] = moved
    out["device_profile"] = {k: v for k, v in device_profile(lambda: run("cuda")).items()
                             if k != "top"}
    launches = launch_counts()
    check(not any(launches.values()), f"wrath_sim: a model kernel ran: {launches}")
    out["host"] = sim_host_planes(seed, 500, 50)
    emit("wrath_sim", **out)
    return launches


# -- the distribution plane: the port's mesh path on a one-rank NCCL group --
DIST_REL = 1e-6          # size-1 mesh vs unsharded: the same ops on the same tensors
DIST_MOE = {"olmoe_1b_7b": (4, 256), "deepseek_v3_671b": (4, 256)}   # (B, S) tokens
# deepseek-v3's train_4k cell takes ~150 s on a host core: its decode_32k stands in
DIST_CELLS = (("deepseek-v3-671b", "decode_32k", "single"), ("granite-3-2b", "decode_32k", "multi"))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| (0 where both are 0)."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _leaf_rels(got, want) -> tuple[float, int, int]:
    """(the largest leaf's rel error, leaves bit-equal, leaves) of two trees."""
    from repro_torch.models.spec import tree_leaves
    pairs = list(zip(tree_leaves(got), tree_leaves(want)))
    rels = [_rel(_full(g), w) for g, w in pairs]
    equal = sum(bool(torch.equal(_full(g), w)) for g, w in pairs)
    return max(rels), equal, len(pairs)


def phase_distributed(seed: int) -> dict[str, dict[str, int]]:
    """The distribution plane on the card: a one-rank NCCL group (a local
    store, no network) and a (1, 1) ("data", "model") DeviceMesh.  Under
    ``activation_sharding`` with the weights distributed by
    ``distribute_params``: granite-3-2b's bf16 prefill (B 4, S 1024) and one
    train step (``loss_and_grads`` + ``adamw_apply``, remat) at full depth,
    and mamba2-780m's prefill, each held to the unsharded run on the same
    weights (a size-1 mesh runs every op on the whole tensor, so they should
    be equal bit for bit; gated at DIST_REL) with the same kernel launches;
    the expert-parallel MoE (``moe_shard_map``) on one full-width layer of
    olmoe-1b-7b and of deepseek-v3-671b against ``moe_scatter`` at the same
    capacity, its two all_to_alls and all_gathers counted by CommDebugMode
    and its gradient finite; the int8 compressor on the train step's
    gradient; then, with the group closed, two dry-run cells on the host.
    Returns each mesh path's kernel launches."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.data import batch_for
    from repro_torch.distributed import (ACT_RULES, PARAM_RULES, activation_sharding,
                                         distribute_params)
    from repro_torch.distributed.sharding import distribute_like
    from repro_torch.distributed.step import batch_to, loss_and_grads
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import materialize, param_defs
    from repro_torch.models.model import prefill_forward
    from repro_torch.models.moe import make_moe_defs, moe_scatter, moe_shard_map
    from repro_torch.models.spec import tree_leaves, tree_map
    from repro_torch.optim import OptConfig, adamw_apply, compress_tree, init_opt_state
    from repro_torch.optim.adamw import opt_state_defs

    cuda = torch.device("cuda", 0)
    torch.cuda.set_device(cuda)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=cuda)
    out: dict = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    launches: dict[str, dict[str, int]] = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        out["mesh"] = {"shape": list(mesh.shape), "axes": list(mesh.mesh_dim_names)}

        def sharded(fn, *args):
            with activation_sharding(mesh, ACT_RULES):
                return fn(*args)

        # granite-3-2b: prefill and one train step, unsharded then on the mesh
        cfg = get_config("granite_3_2b")
        b, s = 4, 1024
        defs = param_defs(cfg)
        params = materialize(defs, seed, "cuda")
        batch = batch_to(batch_for(cfg, b, s, 0, seed=seed), cuda)
        zero_counts()
        logits_u, _ = prefill_forward(params, {"inputs": batch["inputs"]}, cfg)
        plain_prefill = launch_counts()
        dparams = distribute_params(params, defs, PARAM_RULES, mesh)
        dbatch = {k: distribute_like(v, ("batch", "seq"), ACT_RULES, mesh)
                  for k, v in batch.items()}
        zero_counts()
        logits_s, _ = sharded(prefill_forward, dparams, {"inputs": dbatch["inputs"]}, cfg)
        torch.cuda.synchronize()
        launches["distributed granite_3_2b prefill"] = launch_counts()
        rel = _rel(_full(logits_s), logits_u)
        out["granite_prefill"] = {"rel_err": rel, "bit_equal": bool(torch.equal(
            _full(logits_s), logits_u)), "launches": launches["distributed granite_3_2b prefill"],
            "unsharded_launches": plain_prefill}
        check(rel <= DIST_REL, f"distributed: granite prefill logits rel err {rel}")
        check(launches["distributed granite_3_2b prefill"] == plain_prefill
              and plain_prefill["flash_attention"] == cfg.n_layers,
              f"distributed: granite prefill launches {launches} vs unsharded {plain_prefill}")
        del logits_u, logits_s

        opt_cfg = OptConfig(lr=1e-3, warmup_steps=1)
        opt_state = init_opt_state(params, opt_cfg)

        def train(p, o, bt):
            loss, _, grads = loss_and_grads(p, bt, cfg, remat=True)
            new_p, _, om = adamw_apply(p, grads, o, opt_cfg)
            return loss, grads, new_p, om

        zero_counts()
        loss_u, grads_u, new_u, om_u = train(params, opt_state, batch)
        plain_train = launch_counts()
        del grads_u
        dopt = distribute_params(opt_state, opt_state_defs(defs, opt_cfg), PARAM_RULES, mesh)
        zero_counts()
        loss_s, grads_s, new_s, om_s = sharded(train, dparams, dopt, dbatch)
        torch.cuda.synchronize()
        launches["distributed granite_3_2b train step"] = launch_counts()
        want = {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers,
                "ssd_scan": 0}
        rel_loss = _rel(_full(loss_s), loss_u)
        rel_p, equal_p, n_p = _leaf_rels(new_s, new_u)
        out["granite_train_step"] = {
            "loss": loss_u.item(), "loss_rel_err": rel_loss,
            "grad_norm": [_full(om_s["grad_norm"]).item(), om_u["grad_norm"].item()],
            "params_rel_err": rel_p, "params_bit_equal": f"{equal_p}/{n_p}",
            "launches": launches["distributed granite_3_2b train step"],
            "unsharded_launches": plain_train}
        check(rel_loss <= DIST_REL and rel_p <= DIST_REL,
              f"distributed: granite train step loss {rel_loss} / params {rel_p} rel err")
        check(launches["distributed granite_3_2b train step"] == plain_train == want,
              f"distributed: train launches {launches} vs unsharded {plain_train}, want {want}")
        del new_u, new_s, dopt, opt_state

        # the int8 compressor on that step's gradient: |deq - g| <= scale / 2
        # per element, plus the fp32 rounding of the largest value
        local = tree_map(lambda g: g.to_local(), grads_s)
        qs, scales, _ = compress_tree(local)
        worst = 0.0
        for g, q, sc in zip(tree_leaves(local), tree_leaves(qs), tree_leaves(scales)):
            g32 = g.float()
            slack = g32.abs().max().item() * 2.0 ** -23
            worst = max(worst, ((q.float() * sc - g32).abs().max().item() - slack) / sc.item())
        n = sum(g.numel() for g in tree_leaves(local))
        out["compress"] = {"leaves": len(tree_leaves(local)), "int8_bytes": n,
                           "fp32_bytes": 4 * n, "worst_err_over_scale": worst}
        check(worst <= 0.5, f"distributed: int8 error {worst} of the scale, above 1/2")
        del local, qs, grads_s, params, dparams, batch, dbatch
        release()

        # mamba2-780m: the prefill through the SSD kernel on the mesh
        cfg = get_config("mamba2_780m")
        defs = param_defs(cfg)
        params = materialize(defs, seed, "cuda")
        ids = batch_to(batch_for(cfg, b, s, 0, seed=seed), cuda)["inputs"]
        zero_counts()
        logits_u, _ = prefill_forward(params, {"inputs": ids}, cfg)
        plain_m2 = launch_counts()
        dparams = distribute_params(params, defs, PARAM_RULES, mesh)
        zero_counts()
        logits_s, _ = sharded(prefill_forward, dparams,
                              {"inputs": distribute_like(ids, ("batch", "seq"), ACT_RULES, mesh)},
                              cfg)
        torch.cuda.synchronize()
        launches["distributed mamba2_780m prefill"] = launch_counts()
        rel = _rel(_full(logits_s), logits_u)
        out["mamba2_prefill"] = {"rel_err": rel, "bit_equal": bool(torch.equal(
            _full(logits_s), logits_u)), "launches": launches["distributed mamba2_780m prefill"]}
        check(rel <= DIST_REL, f"distributed: mamba2 prefill logits rel err {rel}")
        check(launches["distributed mamba2_780m prefill"] == plain_m2
              and plain_m2["ssd_scan"] == cfg.n_layers,
              f"distributed: mamba2 launches {launches} vs unsharded {plain_m2}")
        del params, dparams, logits_u, logits_s
        release()

        # the expert-parallel MoE on one full-width layer
        out["moe"] = {}
        for arch, (mb, ms) in DIST_MOE.items():
            cfg = get_config(arch)
            mdefs = make_moe_defs(cfg)
            params = materialize(mdefs, seed, "cuda")
            x = torch.randn((mb, ms, cfg.d_model), generator=torch.Generator().manual_seed(seed)
                            ).to(cuda, cfg.cdtype)
            with torch.no_grad():
                y_ref, _ = moe_scatter(params, x, cfg)
            live = tree_map(lambda t: t.detach().requires_grad_(),
                            distribute_params(params, mdefs, PARAM_RULES, mesh))
            dx = distribute_like(x, ("batch", "seq", "d_model"), ACT_RULES, mesh)
            comm = CommDebugMode()
            with comm:
                y, aux = sharded(moe_shard_map, live, dx, cfg)
            counts = {str(k): v for k, v in comm.get_comm_counts().items()}
            grads = torch.autograd.grad((_full(y).float() ** 2).mean() + _full(aux),
                                        tree_leaves(live))
            finite = all(bool(torch.isfinite(g.to_local()).all()) for g in grads)
            rel = _rel(_full(y), y_ref)
            out["moe"][arch] = {"experts": cfg.moe.n_experts, "d_model": cfg.d_model,
                                "tokens": mb * ms, "rel_err_vs_scatter": rel,
                                "bit_equal": bool(torch.equal(_full(y), y_ref)),
                                "comm_counts": counts, "grads_finite": finite}
            check(counts.get("c10d_functional.all_to_all_single", 0) == 2
                  and counts.get("c10d_functional.all_gather_into_tensor", 0) >= 1,
                  f"distributed: {arch} expert-parallel collectives {counts}")
            check(rel <= DIST_REL, f"distributed: {arch} shard_map vs scatter rel err {rel}")
            check(finite, f"distributed: {arch} expert-parallel gradient not finite")
            del params, live, grads, y, y_ref, x, dx
            release()
    finally:
        dist.destroy_process_group()

    # two dry-run cells, on the host under a fake group of the mesh's ranks
    out["dryrun"] = []
    for arch, shape, mesh_kind in DIST_CELLS:
        cell = run_cell(arch, shape, mesh_kind, save=False)
        r = cell.roofline or {}
        out["dryrun"].append({"arch": arch, "shape": shape, "mesh": mesh_kind,
                              "status": cell.status, "seconds": cell.seconds,
                              "per_device_hbm_gb": r.get("per_device_hbm_gb"),
                              "dominant": r.get("dominant"),
                              "coll_breakdown": r.get("coll_breakdown"),
                              "error": cell.error[-300:]})
        check(cell.status == "ok", f"distributed: dry-run {arch} {shape} {mesh_kind}: "
              f"{cell.error[-300:]}")
    emit("distributed", **out)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # read at the first CUDA allocation: the models of 55-69 GB and their
    # fp32 cuts, one after another, leave the card's free memory in pieces
    # that a fixed segment of 14 GiB (a stacked expert leaf in fp32) cannot
    # use; growable segments map what is free into one range
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         alloc_conf=os.environ["PYTORCH_CUDA_ALLOC_CONF"])

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         kernels={k: {"seconds": v["seconds"], "built": v["built"],
                      "ptxas": [ln.strip() for ln in v["log"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for k, v in built.items()})

    # -- 3. kernels vs plain -------------------------------------------------
    seconds = {}
    t0 = time.perf_counter()
    flash_cases = phase_kernel_cases(args.seed)
    ssd_cases = phase_ssd_cases(args.seed)
    bwd_cases = phase_flash_bwd_cases(args.seed)
    seconds["kernels_vs_plain"] = time.perf_counter() - t0

    # -- 4. prefill + decode at full width and depth, 5. serve, per path -----
    # each path's counts are zeroed just before its run and read just after
    path_launches, resident = {}, {}
    for arch in ARCHS:
        t0 = time.perf_counter()
        path_launches[f"{arch} prefill+decode"] = phase_prefill_decode(arch, args.seed)
        if arch in SERVE_ARCHS:
            phase_serve(arch, args.seed)
        seconds[arch] = time.perf_counter() - t0
        # the next model (gemma3-27b: 54 GB) needs the card to itself
        resident[arch] = release()
        check(resident[arch] < 1.0, f"{arch}: {resident[arch]} GB still allocated after "
              "its phases")

    # -- 6. the training plane: gradients, a full train step, the supervisor
    t0 = time.perf_counter()
    phase_train_grad_check(args.seed)
    seconds["train_grad_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_launches["granite_3_2b train_step (one step)"] = phase_train_step(args.seed)
    seconds["train_step"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_launches["granite_3_2b train_supervisor"] = phase_train_supervisor(args.seed)
    seconds["train_supervisor"] = time.perf_counter() - t0

    # -- 7. the WRATH engine and the TaPS apps (fedlearn, moldesign on the card)
    t0 = time.perf_counter()
    path_launches["wrath_apps (fedlearn, moldesign, mapreduce)"] = phase_wrath_apps(args.seed)
    seconds["wrath_apps"] = time.perf_counter() - t0

    # -- 8. the WRATH engine on the virtual clock, fedlearn on the card ------
    t0 = time.perf_counter()
    path_launches["wrath_sim (fedlearn under SimHarness)"] = phase_wrath_sim(args.seed)
    seconds["wrath_sim"] = time.perf_counter() - t0

    # -- 9. the autotuner (a fresh cache), 10. the roofline of four paths ----
    t0 = time.perf_counter()
    tiles, path_launches["autotune (entry points consulting the cache)"] = phase_autotune(
        args.seed)
    seconds["autotune"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_roofline()
    seconds["roofline"] = time.perf_counter() - t0

    # -- 11. the distribution plane on a one-rank mesh, two dry-run cells --
    t0 = time.perf_counter()
    path_launches.update(phase_distributed(args.seed))
    seconds["distributed"] = time.perf_counter() - t0
    emit("timing", seconds=seconds, resident_gb_after=resident)

    # -- 12. the kernel table -----------------------------------------------
    rows = [("flash_attention", flash_cases, "granite_prefill",
             "src/repro_torch/kernels/csrc/flash_attention.cu"),
            ("flash_attention_bwd", bwd_cases, "granite_train",
             "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"),
            ("ssd_scan", ssd_cases, "mamba2_prefill", "src/repro_torch/kernels/csrc/ssd_scan.cu")]
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:82",
                # the gradient of that kernel's function; the Pallas kernel has none
                "flash_attention_bwd": "src/repro/kernels/flash_attention.py:82",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:80"}
    table = []
    for name, cases, case, source in rows:
        c = next(c for c in cases if c["case"] == case)
        by_path = {path: counts[name] for path, counts in path_launches.items()}
        err = c["max_abs_err"]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces[name], "launches": sum(by_path.values()),
                      "launches_by_path": by_path,
                      "max_abs_err": max(err.values()) if isinstance(err, dict) else err,
                      "max_scaled_err": c["max_scaled_err"], "tol": c["tol"], "ms": c["ms"],
                      "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                      "bound_by": c["bound_by"], "bound_frac": c["bound_ms"] / c["ms"],
                      "library_ms": c["library_ms"],
                      "vs_library": c.get("vs_library")})
    # the (q/k, v) head dims the flash cases ran, each the launcher takes;
    # the flash forward at MLA's head dims (q/k 192, v 128), its own readings
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    head_dims = sorted({(c["shape"][4], c["dv"]) for c in flash_cases})
    check(head_dims == sorted(HEAD_DIMS),
          f"flash cases ran head dims {head_dims}, the launcher takes {sorted(HEAD_DIMS)}")
    mla = next(c for c in flash_cases if c["case"] == "deepseek_v3_mla")
    table[0]["head_dims"] = [list(d) for d in head_dims]
    # every tile instantiation, held to the plain version and timed by the
    # autotuner (µs a launch)
    for row in table:
        row["tiles"] = [t for t in tiles if t["kernel"] == row["name"]]
    from repro_torch.kernels.flash_attention import KV_TILES
    built = sorted((d, dv, t) for (d, dv), ts in KV_TILES.items() for t in ts)
    swept = sorted((*t["head_dims"], t["kv_tile"]) for t in table[0]["tiles"])
    check(sorted(set(swept)) == built,
          f"autotune swept flash tiles {sorted(set(swept))}, the kernel is built for {built}")
    table[0]["dk192_dv128"] = {k: mla[k] for k in (
        "case", "shape", "dv", "max_abs_err", "max_scaled_err", "tol", "ms", "plain_ms",
        "bound_ms", "bound_by", "bound_frac", "library_ms", "vs_library")}
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
