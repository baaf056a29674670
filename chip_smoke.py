#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: its serving and training paths on one GPU.

    python3 chip_smoke.py [--seed N]

Runs from the root of a checkout on a machine with one NVIDIA H100 (or
another Hopper card) and the CUDA toolkit.  It builds the port's CUDA
kernels from ``src/repro_torch/kernels/csrc/``, holds each against its
plain PyTorch version (the flash and SSD backwards against autograd of
the plain forwards), then the SSD kernels at B/C groups (G > 1) and from
an initial state (``ssd_groups``: both directions against ``ssd_ref`` and
``ssd_bwd_ref``, and mamba2-780m at full width and depth with 8 groups,
its prefill against the plain path, its decode at depth 1 and its train
step's gradients at depth 2), then the kernels off the ten configs' shapes
(``shapes``: the padded bf16 route, fp16's wgmma route, the staged
flash route, the general SSD route and fp32's register-tiled route of
``kernels/*.py:route`` at small cases in bf16, fp16 and fp32, both
directions, against the plain versions, the fp16, fp32 and staged ones
with the kernels the profiler saw, the staged backward bit for bit over
two launches; the staged route at D 20 in fp16 and bf16, phi-2's (D 80,
bf16, fp16 and fp32) and phi-3-mini's (D 96) attention and Zamba2's SSD
(P 64, N 64) at full width, timed beside their bounds, the plain
versions and SDPA; granite at head dim 40 (bf16, fp16, fp32) and mamba2
at (P, N) = (32, 64), prefill, decode and a train step's gradients,
kernel path against plain path;
the flash cases also run granite's, llava's, recurrentgemma's and
deepseek-v3's attention in fp16 at full width beside bf16, both
directions, on the f16 wgmma kernels; every fp32 forward and backward,
there, in the flash cases and in the flash backward cases, is checked by
the profiler's names to run the register-tiled kernels of
``csrc/flash_attention_fwd_f32.cu`` and ``csrc/flash_attention_bwd_f32.cu``
alone (the forward also by its lse and two launches bit for bit), with
their device ms), then drives each ported model at full width (random
weights from ``--seed``) through the port's entry points at full depth, each with
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
the training plane: ``loss_fn`` gradients through the kernels against
the plain attention and SSD scan, each held to float64, for granite-3-2b,
mamba2-780m, recurrentgemma-9b, seamless-m4t-medium and deepseek-v3-671b
(full width, cut in depth); granite's ``build_train_step`` at full depth
and ``WrathTrainSupervisor`` at depth 4 through a host loss and a NaN;
then ``train_all``, a train step of each of the nine other models at
full width (cut in depth where one card does not hold the step,
``TRAIN_DEPTH``); then the paper's evaluation path through the port's WRATH engine
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
step, mamba2-780m's prefill and train step and deepseek-v3-671b's train
step (MLA's backward at q/k 192, v 128), each counted once by the port's roofline
counter (FLOPs, bytes, the kernels credited per launch) and read against
the H100's peaks with the phases' measured times (``mfu``); last
``distributed``: the distribution plane on a one-rank NCCL group and a
(1, 1) mesh (granite's prefill and train step and mamba2's prefill under
``activation_sharding``, each equal to the unsharded run; the
expert-parallel MoE of olmoe-1b-7b and deepseek-v3-671b against the
scatter dispatch; the int8 compressor on the step's gradient), then two
meta-device dry-run cells on the host; last ``train_cli``, the training
CLI (``repro_torch.launch.train``) on the card at its defaults for all
ten architectures' smoke configs; and ``examples``, the port's serving
and resilient-training examples (``examples/torch/``) on the card, in
process.  Each phase
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
TOL = {"torch.bfloat16": 2e-2, "torch.float16": 2e-2, "torch.float32": 1e-4}
# fp16, by case and direction: each gate a limit of its own, twice its
# first full reading (NVIDIA H100 80GB HBM3, 700.00 W; max |out - ref| /
# (1 + |ref|), the backward's worst of dq, dk, dv) and never looser than
# TOL's and BWD_TOL's fp16 (2e-2, 5e-2).  First readings: forward 6.5e-4 at
# the four full-width shapes, 3.1e-4 to 6.3e-4 elsewhere; backward 1.1e-3
# to 2.4e-3; granite at head dim 40, kernel path vs plain path, 3.2e-3
FP16_TOL = {
    ("granite_prefill_fp16", "forward"): 1.3e-3, ("llava_prefill_fp16", "forward"): 1.3e-3,
    ("recurrentgemma_prefill_fp16", "forward"): 1.3e-3,
    ("deepseek_v3_mla_fp16", "forward"): 1.3e-3,
    ("granite_train_fp16", "backward"): 3.5e-3, ("llava_train_fp16", "backward"): 3.7e-3,
    ("recurrentgemma_train_fp16", "backward"): 4.1e-3, ("mla_train_fp16", "backward"): 2.2e-3,
    ("small_80_80", "forward"): 6.2e-4, ("small_80_80", "backward"): 1.5e-3,
    ("small_256_256", "forward"): 8.4e-4, ("small_256_256", "backward"): 1.7e-3,
    ("small_20_20", "forward"): 4.5e-4, ("small_20_20", "backward"): 1.4e-3,
    ("small_5_3", "forward"): 4.6e-4, ("small_5_3", "backward"): 1.8e-3,
    ("small_48_48_wide", "forward"): 1.1e-3, ("small_48_48_wide", "backward"): 4.8e-3,
    ("phi2_d80_fp16", "forward"): 1.3e-3, ("phi2_d80_fp16", "backward"): 2.7e-3,
    ("granite_3_2b_shapes", "forward"): 6.5e-3,
}
# the full-width flash cases run in fp16 beside bf16 (case -> its bf16 twin):
# device ms and the kernels the profiler saw for both
FP16_TWINS = {"granite_prefill_fp16": "granite_prefill", "llava_prefill_fp16": "llava_prefill",
              "recurrentgemma_prefill_fp16": "recurrentgemma_prefill",
              "deepseek_v3_mla_fp16": "deepseek_v3_mla",
              "granite_train_fp16": "granite_train", "llava_train_fp16": "llava_train",
              "recurrentgemma_train_fp16": "recurrentgemma_train",
              "mla_train_fp16": "mla_train"}


def gate(case: str, part: str, dtype, default: float) -> float:
    """The limit of a case's forward or backward: its own in fp16, else
    the dtype's ``default``."""
    return FP16_TOL.get((case, part), default) if dtype == torch.float16 else default


def f16_kernels(names) -> bool:
    """Whether a call ran the f16 wgmma kernels alone (hopper::HalfWidths)."""
    return bool(names) and all("HalfWidths" in n for n in names)


def stage_kernels(names, dtype) -> bool:
    """Whether a staged call (route kind "stage") ran the bucket's wgmma
    kernels (hopper::Widths in bf16, hopper::HalfWidths in fp16) and the
    staging kernel flash_stage, and nothing else."""
    tag = "hopper::HalfWidths" if dtype in (torch.float16, "torch.float16") else "hopper::Widths"
    flash = [n for n in names if "flash_stage" not in n]
    return (bool(flash) and len(flash) < len(names)
            and all("flash_stage" in n or tag in n for n in names))


def f32_bwd_kernels(names) -> bool:
    """Whether an fp32 backward ran the register-tiled dQ and dK/dV kernels
    (csrc/flash_attention_bwd_f32.cu) and no other backward kernel: not the
    SIMT flash_bwd_{dq,dkdv}_f32."""
    bwd = [n for n in names if "flash_bwd" in n]
    return (any("flash_bwd_dq_tiled" in n for n in bwd)
            and any("flash_bwd_dkdv_tiled" in n for n in bwd)
            and all("_tiled" in n for n in bwd))


def f32_fwd_kernels(names) -> bool:
    """Whether an fp32 forward ran the register-tiled kernel
    (csrc/flash_attention_fwd_f32.cu) and no other forward kernel: not the
    SIMT flash_fwd_f32 of the bf16 smoke dims."""
    fwd = [n for n in names if "flash_fwd" in n]
    return bool(fwd) and all("flash_fwd_f32_tiled" in n for n in fwd)
SSD_TOL = {"torch.bfloat16": 5e-2, "torch.float16": 5e-2, "torch.float32": 2e-3}
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
# bf16, at full width (this run has one card; the port's sharding, which
# would spread the rest, is exercised on a (1, 1) mesh in the distributed
# phase): deepseek-67b's 95 layers are 135 GB, its first 40 58.7 GB;
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
BWD_TOL = {"torch.bfloat16": 5e-2, "torch.float16": 5e-2, "torch.float32": 2e-3}
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
                  "bfloat16": {"loss": 2e-2, "grad": 5e-2},
                  # fp16 (granite at head dim 40 in the shapes phase, the f16
                  # wgmma route): the loss twice its first reading (2.3e-4,
                  # NVIDIA H100 80GB HBM3, 700.00 W); the gradients at bf16's
                  # limit, which twice the reading (0.16) would pass
                  "float16": {"loss": 4.6e-4, "grad": 5e-2}}


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
    from repro_torch.kernels.flash_attention import flash_attention_cuda, ws_route
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.kernels.ref import flash_attention_lse_ref, flash_attention_ref
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
        # the train step's launch shape (four microbatches of B 1)
        ("mla_b1", 1, 1024, 1024, 128, 128, 192, 128, torch.bfloat16, True, 0),
        ("llava_prefill", 4, 1024, 1024, 64, 64, 128, 128, torch.bfloat16, True, 0),
        ("deepseek67b_prefill", 4, 1024, 1024, 64, 8, 128, 128, torch.bfloat16, True, 0),
        # fp16 beside bf16 (FP16_TWINS): granite's, llava's, recurrentgemma's
        # and deepseek-v3's MLA, on the f16 wgmma kernels
        ("granite_prefill_fp16", 4, 1024, 1024, 32, 8, 64, 64, torch.float16, True, 0),
        ("llava_prefill_fp16", 4, 1024, 1024, 64, 64, 128, 128, torch.float16, True, 0),
        ("recurrentgemma_prefill_fp16", 4, 2560, 2560, 16, 1, 256, 256, torch.float16, True,
         2048),
        ("deepseek_v3_mla_fp16", 4, 1024, 1024, 128, 128, 192, 128, torch.float16, True, 0),
        # the smoke configs' head dims, which the training CLI runs at (B 2
        # a host, S 64): D 16 (the windowed models' window of 32 too) and
        # MLA's q/k 16 + 8 over v 16, on the SIMT kernel in bf16 and the
        # register-tiled kernel's (64, 64) bucket in fp32
        ("smoke_d16", 2, 64, 64, 4, 2, 16, 16, torch.bfloat16, True, 0),
        ("smoke_d16_window32", 2, 64, 64, 4, 1, 16, 16, torch.bfloat16, True, 32),
        ("smoke_d16_fp32", 2, 64, 64, 4, 2, 16, 16, torch.float32, True, 0),
        ("smoke_mla", 2, 64, 64, 4, 4, 24, 16, torch.bfloat16, True, 0),
        ("smoke_mla_fp32", 2, 64, 64, 4, 4, 24, 16, torch.float32, True, 0),
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
        tol = gate(name, "forward", dtype, TOL[str(dtype)])
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
        if name in FP16_TWINS or name in FP16_TWINS.values():
            # fp16 beside bf16: device ms and the kernels the profiler saw
            by_kernel = kernels_device_ms(
                lambda: flash_attention(q, k, v, causal=causal, window=window), iters=10)
            row["device_ms"], row["kernels"] = sum(by_kernel.values()), sorted(by_kernel)
            row["device_bound_frac"] = bound_ms / row["device_ms"]
        if dtype == torch.float32:
            # the register-tiled fp32 kernel: device ms and the kernels the
            # profiler saw (the smoke cases' names again from a process of
            # their own, below), its lse, and two launches bit for bit
            by_kernel = kernels_device_ms(
                lambda: flash_attention(q, k, v, causal=causal, window=window), iters=10)
            row["device_ms"], row["kernels"] = sum(by_kernel.values()), sorted(by_kernel)
            row["device_bound_frac"] = bound_ms / row["device_ms"] if row["device_ms"] else None
            o1, lse1 = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                            return_lse=True)
            o2, lse2 = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                            return_lse=True)
            torch.cuda.synchronize()
            row["bit_equal"] = bool(torch.equal(o1, o2) and torch.equal(lse1, lse2)
                                    and torch.equal(o1, out))
            row["lse_max_abs_err"] = (lse1 - flash_attention_lse_ref(
                q, k, v, causal=causal, window=window)).abs().max().item()
            del o1, o2, lse1, lse2
        if ws_route(dtype, d, dv):
            row["ws"] = True
            # the MLA kernel (csrc/flash_attention_fwd_ws.cu): the kernel the
            # profiler saw, and its lse output (the backward reads it) on
            # against off
            if "kernels" not in row:
                row["kernels"] = sorted(kernels_device_ms(
                    lambda: flash_attention(q, k, v, causal=causal, window=window), iters=5))
            o_off = flash_attention_cuda(q, k, v, causal=causal, window=window)
            o_on, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                             return_lse=True)
            row["lse_output_equal"] = bool(torch.equal(o_off, o_on))
            row["lse_max_abs_err"] = (lse - flash_attention_lse_ref(
                q, k, v, causal=causal, window=window)).abs().max().item()
            del o_off, o_on, lse
        if name in FP16_TWINS:   # the bf16 row at the same shape, earlier in this run
            twin = next(r for r in results if r["case"] == FP16_TWINS[name])
            row["vs_bf16_device"] = row["device_ms"] / twin["device_ms"]
        emit("kernel_vs_plain", **row)
        check(scaled <= tol and row["finite"],
              f"flash_attention {name}: max |out - ref| / (1 + |ref|) = {scaled} > {tol}")
        if name in FP16_TWINS:
            check(f16_kernels(row["kernels"]),
                  f"flash_attention {name}: ran {row['kernels']}, not the f16 wgmma kernels")
        if dtype == torch.float32:
            check(row["lse_max_abs_err"] <= LSE_TOL and row["bit_equal"],
                  f"flash_attention {name}: max |lse - ref| = {row['lse_max_abs_err']}, two "
                  f"launches equal {row['bit_equal']}")
            if not name.startswith("smoke"):
                check(f32_fwd_kernels(row["kernels"]),
                      f"flash_attention {name}: ran {row['kernels']}, not the register-tiled "
                      "fp32 kernel alone")
        if row.get("ws"):
            check(row["kernels"] and all("flash_fwd_bf16_ws" in n for n in row["kernels"]),
                  f"flash_attention {name}: ran {row['kernels']}, not the MLA kernel")
            check(row["lse_output_equal"],
                  f"flash_attention {name}: the output changes when lse is written")
            check(row["lse_max_abs_err"] <= LSE_TOL,
                  f"flash_attention {name}: max |lse - ref| = {row['lse_max_abs_err']}")
        results.append(row)
        del q, k, v, out, ref, lib
        torch.cuda.empty_cache()
    f32_smoke_forwards_apart(cases, results, "kernels")
    return results


def phase_ssd_cases(seed: int) -> list[dict]:
    """The SSD kernel against ssd_ref at mamba2-780m's head shape (P 64,
    N 128, 48 heads), inputs drawn as tests/test_kernels.py draws them."""
    from repro_torch.kernels.ops import ssd_scan
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.roofline.cost import ssd_bound

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [  # (name, B, L, H, P, N, Q, dtype); chunk64 reuses mamba2_prefill's inputs
        ("mamba2_prefill", 4, 1024, 48, 64, 128, 128, torch.bfloat16),
        ("mamba2_prefill_l2048", 4, 2048, 48, 64, 128, 128, torch.bfloat16),
        ("ragged_l1000", 4, 1000, 48, 64, 128, 128, torch.bfloat16),
        ("chunk64", 4, 1024, 48, 64, 128, 64, torch.bfloat16),
        ("fp32", 4, 1024, 48, 64, 128, 128, torch.float32),
        # x, B and C as the model passes them: views of one conv output
        # (B, L, H P + 2 N), read in place through tensor maps
        ("model_views", 4, 1024, 48, 64, 128, 128, torch.bfloat16),
        # the smoke config's shape (8 heads of P 16, N 16, chunk 32), on the
        # SIMT kernel in both dtypes, as the training CLI runs it
        ("smoke", 2, 64, 8, 16, 16, 32, torch.bfloat16),
        ("smoke_fp32", 2, 64, 8, 16, 16, 32, torch.float32),
    ]
    results, base = [], None      # base: mamba2_prefill's inputs and output
    for name, b, l, h, p, n, q, dtype in cases:
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
        # one call: the plain scan steps one by one on the host (~0.45 s)
        row["plain_ms"] = cuda_ms(lambda: ssd_ref(x, dt, a, bm, cm), iters=1, warmup=0)
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


def phase_ssd_bwd_cases(seed: int) -> list[dict]:
    """The SSD backward kernel (through ``ops.ssd_scan``'s autograd, forward
    kernel and backward kernel) against autograd of the fp32 plain forward
    ``ssd_ref`` on the same values, each of dx, ddt, da, db, dc; two
    launches bit for bit; its time beside the plain ``ssd_bwd_ref``'s."""
    from repro_torch.kernels.ops import ssd_scan
    from repro_torch.kernels.ref import ssd_bwd_ref, ssd_ref
    from repro_torch.kernels.ssd_scan import BWD_TILES, ssd_scan_bwd_cuda
    from repro_torch.roofline.cost import ssd_bwd_bound

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    cases = [  # (name, B, L, H, P, N, forward chunk, dtype)
        ("mamba2_train", 4, 1024, 48, 64, 128, 128, torch.bfloat16),
        ("chunk64", 4, 1024, 48, 64, 128, 64, torch.bfloat16),
        ("model_views", 4, 1024, 48, 64, 128, 128, torch.bfloat16),
        ("fp32", 2, 1024, 48, 64, 128, 128, torch.float32),
        ("smoke", 2, 64, 8, 16, 16, 32, torch.bfloat16),
    ]
    names = ("dx", "ddt", "da", "db", "dc")
    results = []
    for name, b, l, h, p, n, q, dtype in cases:
        dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).to(dtype)
        a = (-torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))).to(dtype)
        if name == "model_views":
            conv = torch.randn(b, l, h * p + 2 * n, generator=gen, device="cuda").to(dtype)
            x = conv[..., :h * p].reshape(b, l, h, p)
            bm, cm = conv[..., h * p:h * p + n], conv[..., h * p + n:]
            check(not x.is_contiguous() and not bm.is_contiguous() and not cm.is_contiguous(),
                  "model_views: x, B and C must be views of the conv output")
        else:
            x = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype)
            bm = torch.randn(b, l, n, generator=gen, device="cuda").to(dtype)
            cm = torch.randn(b, l, n, generator=gen, device="cuda").to(dtype)
        dy = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype)
        inputs = (x, dt, a, bm, cm)
        leaves = [t.detach().requires_grad_() for t in inputs]
        zero_counts()
        y, _ = ssd_scan(*leaves, chunk=q)
        grads = torch.autograd.grad(y, leaves, dy)
        torch.cuda.synchronize()
        launches = launch_counts()
        ref_leaves = [t.detach().float().requires_grad_() for t in inputs]
        ref_y, _ = ssd_ref(*ref_leaves)
        ref = torch.autograd.grad(ref_y, ref_leaves, dy.float())
        del ref_y, ref_leaves
        tol = SSD_TOL[str(dtype)]
        row = {"case": name, "shape": [b, l, h, p, n], "chunk": q,
               "tile": BWD_TILES[(p, n)], "dtype": str(dtype), "tol": tol,
               "max_scaled_err": {k: scaled_err(g, r) for k, g, r in zip(names, grads, ref)},
               "max_abs_err": {k: (g.float() - r).abs().max().item()
                               for k, g, r in zip(names, grads, ref)},
               "ref_abs_max": {k: r.abs().max().item() for k, r in zip(names, ref)},
               "finite": all(bool(torch.isfinite(g.float()).all()) for g in grads),
               "launches": launches}
        # determinism: the kernel twice on the same inputs gives the same bits

        def bwd():
            return ssd_scan_bwd_cuda(x, dt, a, bm, cm, dy)

        first, again = bwd(), bwd()
        torch.cuda.synchronize()
        # the five gradients (no initial state: its gradient is None)
        row["bit_equal"] = all(bool(torch.equal(u, w)) for u, w in zip(first[:5], again[:5]))
        row["vs_autograd_bit_equal"] = all(bool(torch.equal(u, w)) for u, w in zip(first, grads))
        del first, again
        row["ms"] = cuda_ms(bwd, iters=5, warmup=1)
        row["device_ms"] = kernel_device_ms(bwd, iters=10)
        row["plain_ms"] = cuda_ms(lambda: ssd_bwd_ref(x, dt, a, bm, cm, dy), iters=2, warmup=1)
        row["library_ms"] = None   # no single PyTorch call computes the SSD scan's gradient
        bound_ms, bound_by, flops, nbytes = ssd_bwd_bound(b, l, h, p, n, str(dtype),
                                                          str(a.dtype), tile=BWD_TILES[(p, n)])
        row.update(bound_ms=bound_ms, bound_by=bound_by, bound_frac=bound_ms / row["ms"],
                   flops=flops, bytes=nbytes, tflops=flops / (row["ms"] * 1e-3) / 1e12)
        if name == "mamba2_train":
            # the train step's own launch shape (two microbatches of B 2): the
            # first two rows of the same inputs; ms from events (host-paced
            # at this size), device_ms from the profiler

            def bwd_b2():
                return ssd_scan_bwd_cuda(x[:2], dt[:2], a, bm[:2], cm[:2], dy[:2])

            b2 = {"ms": cuda_ms(bwd_b2, iters=10, warmup=2),
                  "device_ms": kernel_device_ms(bwd_b2, iters=10)}
            b2_bound, b2_by, _, _ = ssd_bwd_bound(2, l, h, p, n, str(dtype), str(a.dtype),
                                                  tile=BWD_TILES[(p, n)])
            row["b2"] = dict(b2, bound_ms=b2_bound, bound_by=b2_by,
                             bound_frac=b2_bound / b2["ms"],
                             device_bound_frac=b2_bound / b2["device_ms"])
        emit("ssd_bwd_vs_plain", **row)
        worst = max(row["max_scaled_err"].values())
        check(worst <= tol and row["finite"],
              f"ssd backward {name}: max |grad - ref| / (1 + |ref|) = {worst} > {tol}")
        check(row["bit_equal"], f"ssd backward {name}: two launches differ")
        check(launches["ssd_scan"] == 1 and launches["ssd_scan_bwd"] == 1,
              f"ssd backward {name}: autograd launched {launches}")
        results.append(row)
        del x, dt, a, bm, cm, dy, leaves, y, grads, ref
        torch.cuda.empty_cache()
    return results


# the ssd_groups phase: the SSD kernels at B/C groups (G > 1) and from an
# initial state.  Kernel cases (name, B, L, H, P, N, G, initial state:
# None, "x" (x's dtype) or "fp32", chunk, dtype): mamba2-780m's head shape
# at G 2 and G 8 (6 heads a group), G 8 at Mamba2Config's chunk 256 (the
# kernels' largest tile, 128) and over a ragged L; the SIMT route in fp32
# and at the smoke shape (16, 16)
SSD_GROUP_CASES = [
    ("g2", 4, 1024, 48, 64, 128, 2, None, 128, torch.bfloat16),
    ("g2_s0", 4, 1024, 48, 64, 128, 2, "x", 128, torch.bfloat16),
    ("g8", 4, 1024, 48, 64, 128, 8, None, 256, torch.bfloat16),
    ("g8_s0", 4, 1024, 48, 64, 128, 8, "x", 256, torch.bfloat16),
    ("g8_s0_l1000", 4, 1000, 48, 64, 128, 8, "x", 128, torch.bfloat16),
    ("g8_s0_fp32", 1, 512, 48, 64, 128, 8, "fp32", 128, torch.float32),
    ("smoke_g2_s0", 2, 64, 8, 16, 16, 2, "x", 32, torch.bfloat16),
]
# the split-scan identity: L 1024 against its first 512 steps, then the
# last 512 from their final state, handed on in fp32 (the fp32 kernel's
# state over the same first half); the SSD tolerance.  The bf16 kernel
# returns the state rounded to bf16, as the JAX function does
# (``s_final.astype(x.dtype)``), and that rounding alone moves y by
# ~2^-9 of sum_n |C_n S_n|, terms of hundreds, where y may lie near zero:
# the identity over a bf16 hand-off reads ~0.08 for the plain version too.
# So the second half from the bf16 state is held to the plain version from
# the same state at the SSD tolerance, both identity readings beside it
SPLIT_TOL = 5e-2
# da in the fp32 case: element by element against the float64 referee
# (``da_vs_float64``), at the fp32 tolerance, the plain version's reading
# beside it.  A head's da sums dt dda over every (b, step), terms of
# hundreds that cancel to totals as small as ~1, so both fp32 versions
# miss float64 by ~1e-6 of sum |terms| (each reading's ``terms_scaled``,
# tools/ssd_da_precision.py).  In bf16, da is held to the plain version
# element by element like every gradient
# the model case: mamba2-780m at full width and depth with Hugging Face's
# Mamba2Config default (and Mamba-Codestral-7B-v0.1's) 8 B/C groups;
# its train step's loss and gradients at a cut depth, as GRAD_CHECK's
# mamba2 case (cut, B, S); its decode at depth 1 in fp32 over a 120-token
# prompt (a chunk of its own) and 8 steps (128 tokens: whole chunks)
SSD_GROUPS_MODEL = {"n_groups": 8}
# its prefill runs at full depth (48 layers); the kernel path is held to
# the plain path on its first 12 layers, the cut CMP_CUT gives the other
# long comparisons (the plain scan steps one by one on the host: at 48
# layers the two comparisons took most of this phase's ~65 s)
SSD_GROUPS_CMP_CUT = {"n_layers": 12}
# its bf16 prefill logits, kernel path against the plain path (per-row
# relative L2) on the 12-layer cut: twice the 0.0392 read there (NVIDIA
# H100 80GB HBM3, 700.00 W; the same in two runs), as BF16_REL_TOL's
# limits were set (at 48 layers it read 0.241).  The plain path rounds y
# to bf16 as the kernel does but from exact fp32 products, and depth
# amplifies the difference.  fp32 holds it to FP32_REL_TOL (8.3e-6)
SSD_GROUPS_BF16_TOL = 0.08
SSD_GROUPS_TRAIN_CUT = ({"n_layers": 2}, 2, 512)
SSD_GROUPS_DECODE = (120, 8)


def _group_inputs(gen, b, l, h, p, n, g, s0_kind, dtype):
    x = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).to(dtype)
    a = (-torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))).to(dtype)
    bm, cm = (torch.randn(b, l, g, n, generator=gen, device="cuda").to(dtype) for _ in "bc")
    s0 = None
    if s0_kind:
        s0 = torch.randn(b, h, p, n, generator=gen, device="cuda")
        s0 = s0 if s0_kind == "fp32" else s0.to(dtype)
    dy = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype)
    dstate = torch.randn(b, h, p, n, generator=gen, device="cuda").to(dtype)
    return (x, dt, a, bm, cm), s0, dy, dstate


def phase_ssd_groups(seed: int, ssd_cases: list[dict],
                     ssd_bwd_cases: list[dict]) -> tuple[list[dict], dict[str, dict[str, int]]]:
    """The SSD kernels at B/C groups and from an initial state: each
    SSD_GROUP_CASES case through ``ops.ssd_scan``'s autograd (one forward
    and one backward launch) against ``ssd_ref`` and ``ssd_bwd_ref`` in
    fp32, y, the final state and all six gradients, two launches bit for
    bit, with ms, bounds and the G 1 row (``mamba2_prefill``,
    ``mamba2_train``) beside; the split-scan identity; then the model case
    (``ssd_groups_model``).  Returns the rows and the model case's launches
    by path."""
    from repro_torch.kernels.ops import ssd_scan
    from repro_torch.kernels.ref import ssd_bwd_ref, ssd_ref
    from repro_torch.kernels.ssd_scan import (BWD_TILES, bwd_head_block, kernel_chunk,
                                              ssd_scan_bwd_cuda, ssd_scan_cuda)
    from repro_torch.roofline.cost import ssd_bound, ssd_bwd_bound

    g1_fwd = next(c for c in ssd_cases if c["case"] == "mamba2_prefill")
    g1_bwd = next(c for c in ssd_bwd_cases if c["case"] == "mamba2_train")
    g1 = {"fwd_ms": g1_fwd["ms"], "fwd_bound_frac": g1_fwd["bound_frac"],
          "bwd_ms": g1_bwd["ms"], "bwd_device_ms": g1_bwd["device_ms"],
          "bwd_bound_frac": g1_bwd["bound_frac"]}
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    names = ("dx", "ddt", "da", "db", "dc", "ds0")
    rows = []
    for name, b, l, h, p, n, g, s0_kind, chunk, dtype in SSD_GROUP_CASES:
        inputs, s0, dy, dstate = _group_inputs(gen, b, l, h, p, n, g, s0_kind, dtype)
        leaves = [t.detach().requires_grad_() for t in inputs + ((s0,) if s0 is not None else ())]
        zero_counts()
        y, st = ssd_scan(*leaves[:5], chunk=chunk,
                         initial_state=leaves[5] if s0 is not None else None)
        grads = torch.autograd.grad((y, st), leaves, (dy, dstate))
        torch.cuda.synchronize()
        launches = launch_counts()
        f32 = [t.float() for t in inputs]
        s0_32 = None if s0 is None else s0.float()
        ref_y, ref_st = ssd_ref(*f32, s0_32)
        ref_g = [r for r in ssd_bwd_ref(*f32, dy.float(), dstate.float(),
                                        initial_state=s0_32) if r is not None]
        errs = {"y": scaled_err(y, ref_y), "state": scaled_err(st, ref_st)}
        errs.update({k: scaled_err(gr, r) for k, gr, r in zip(names, grads, ref_g)})
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (y, st, *grads))
        da_f64 = None
        if dtype == torch.float32:   # da against float64 (the note after SPLIT_TOL)
            da_f64 = da_vs_float64(inputs, s0, dy, dstate, grads[2], ref_g[2])
            da_f64["kernel_vs_plain_scaled"] = errs["da"]
            errs["da"] = da_f64["kernel"]["elementwise_scaled"]
        del ref_st, ref_g

        def fwd():
            return ssd_scan_cuda(*inputs, chunk=chunk, initial_state=s0)

        def bwd():
            return ssd_scan_bwd_cuda(*inputs, dy, dstate, s0)

        first, again = fwd(), fwd()
        b1, b2 = bwd(), bwd()
        torch.cuda.synchronize()
        bit_equal = (all(bool(torch.equal(u, w)) for u, w in zip(first, again))
                     and all(u is w is None or bool(torch.equal(u, w)) for u, w in zip(b1, b2))
                     and all(bool(torch.equal(u, w)) for u, w in zip(b1, grads)))
        del first, again, b1, b2
        tol = SSD_TOL[str(dtype)]
        s0_dtype = None if s0 is None else str(s0.dtype)
        q, tile = kernel_chunk(chunk, dtype, p, n), BWD_TILES[(p, n)]
        row = {"case": name, "shape": [b, l, h, p, n], "groups": g,
               "heads_a_group": h // g, "bwd_heads_a_block": bwd_head_block(h, g),
               "initial_state": s0_dtype, "chunk": chunk, "tile": q, "dtype": str(dtype),
               "max_scaled_err": errs, "da_vs_f64": da_f64,
               "tol": tol, "finite": finite, "bit_equal": bit_equal,
               "launches": launches, "ms": cuda_ms(fwd), "bwd_ms": cuda_ms(bwd, iters=5),
               "bwd_device_ms": kernel_device_ms(bwd, iters=10)}
        fb, fby, _, _ = ssd_bound(b, l, h, p, n, q, str(dtype), str(inputs[2].dtype), g=g,
                                  s0_dtype=s0_dtype)
        bb_, bby, _, _ = ssd_bwd_bound(b, l, h, p, n, str(dtype), str(inputs[2].dtype),
                                       tile=tile, g=g, s0_dtype=s0_dtype)
        row.update(bound_ms=fb, bound_by=fby, bound_frac=fb / row["ms"], bwd_bound_ms=bb_,
                   bwd_bound_by=bby, bwd_bound_frac=bb_ / row["bwd_ms"],
                   bwd_device_bound_frac=bb_ / row["bwd_device_ms"], g1=g1)
        if name == "g8":   # the split-scan identity on this case's inputs
            x, dt, a, bm, cm = inputs
            half = l // 2
            first = (x[:, :half], dt[:, :half].contiguous(), a, bm[:, :half], cm[:, :half])
            last = (x[:, half:], dt[:, half:].contiguous(), a, bm[:, half:], cm[:, half:])
            y0, s_half = ssd_scan(*first, chunk=chunk)
            # the first half's final state handed on in fp32 (the fp32
            # kernel's), and as the bf16 kernel returns it
            _, s_half32 = ssd_scan(*(t.float() for t in first), chunk=chunk)
            y1, s_end = ssd_scan(*last, chunk=chunk, initial_state=s_half32)
            y1_bf, _ = ssd_scan(*last, chunk=chunk, initial_state=s_half)
            # the plain version: from the kernel's bf16 state, and split
            # the same way from its own state rounded to bf16
            p1_bf, _ = ssd_ref(*(t.float() for t in last), s_half.float())
            p0, ps_half = ssd_ref(*(t.float() for t in first))
            p1, _ = ssd_ref(*(t.float() for t in last), ps_half.bfloat16().float())
            row["split_scan"] = {"y": scaled_err(torch.cat([y0, y1], 1), y),
                                 "state": scaled_err(s_end, st), "tol": SPLIT_TOL,
                                 "bf16_state_vs_plain": scaled_err(y1_bf, p1_bf),
                                 "bf16_state_tol": tol,
                                 "bf16_state_identity": scaled_err(torch.cat([y0, y1_bf], 1), y),
                                 "plain_bf16_state_identity": scaled_err(
                                     torch.cat([p0, p1], 1), ref_y)}
            del p1_bf, p0, ps_half, p1
            check(max(row["split_scan"]["y"], row["split_scan"]["state"]) <= SPLIT_TOL
                  and row["split_scan"]["bf16_state_vs_plain"] <= tol,
                  f"ssd_groups {name}: the split scan differs from the whole: "
                  f"{row['split_scan']}")
        del ref_y, f32
        emit("ssd_groups", **row)
        worst = max(errs.values())
        check(worst <= tol and finite, f"ssd_groups {name}: max |out - ref| / (1 + |ref|) = "
              f"{errs} > {tol}")
        check(bit_equal, f"ssd_groups {name}: two launches (or autograd's) differ")
        check(launches["ssd_scan"] == 1 and launches["ssd_scan_bwd"] == 1,
              f"ssd_groups {name}: autograd launched {launches}")
        rows.append(row)
        del inputs, s0, dy, dstate, leaves, y, st, grads
        torch.cuda.empty_cache()
    return rows, phase_ssd_groups_model(seed)


def phase_ssd_groups_model(seed: int) -> dict[str, dict[str, int]]:
    """mamba2-780m at full width with SSD_GROUPS_MODEL's 8 B/C groups,
    random weights from ``seed``: the kernel path's prefill (B 4, S 1024)
    at full depth, the config's chunk 128 and Mamba2Config's 256 (one
    tile, bit for bit); then, cut in place to SSD_GROUPS_CMP_CUT, its
    prefill logits against the plain path (``ssd_ref`` through
    ``plain_attention(ssd=...)``) in bf16 and, recast in place, in fp32,
    and decode against the forward at depth 1 in fp32; last the train
    step's loss and gradients at SSD_GROUPS_TRAIN_CUT against the plain
    path, each held to float64 (``_grad_check_init``).  Returns the
    launches by path."""
    from repro_torch.data import batch_for
    from repro_torch.distributed.step import batch_to, build_prefill_step
    from repro_torch.models import materialize, param_defs
    from repro_torch.models.spec import tree_map

    t0 = time.perf_counter()
    base = card_config("mamba2_780m")
    cfg = dataclasses.replace(base, name=f"{base.name}-g{SSD_GROUPS_MODEL['n_groups']}",
                              ssm=dataclasses.replace(base.ssm, **SSD_GROUPS_MODEL))
    torch.cuda.reset_peak_memory_stats()
    params = materialize(param_defs(cfg), seed, "cuda")
    b, s = 4, 1024
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s), dtype=np.int32)).cuda()
    prompt = {"inputs": ids}
    out = {"config": cfg.name, "layers": cfg.n_layers, "n_groups": cfg.ssm.n_groups,
           "heads": cfg.d_model * cfg.ssm.expand // cfg.ssm.head_dim, "batch": b, "prompt": s}
    parts = {"init": time.perf_counter() - t0}
    # -- the main path at full depth: counts zeroed just before, read after
    t1 = time.perf_counter()
    want = expected_launches(cfg)
    zero_counts()
    logits = build_prefill_step(cfg)(params, prompt)[0]
    torch.cuda.synchronize()
    launches = launch_counts()
    c256 = cfg.scaled(ssm=dataclasses.replace(cfg.ssm, chunk=256))
    out.update(prefill_launches=launches, chunk256_bit_equal=bool(torch.equal(
        logits, build_prefill_step(c256)(params, prompt)[0])),
        finite=bool(torch.isfinite(logits.float()).all()))
    del logits
    parts["prefill"] = time.perf_counter() - t1
    # -- the comparisons, on the cut ----------------------------------------
    params, ccfg = _cut_in_place(params, cfg, cfg.scaled(**SSD_GROUPS_CMP_CUT))
    torch.cuda.empty_cache()
    out["cmp_layers"] = ccfg.n_layers
    for compute in ("bfloat16", "float32"):
        t1 = time.perf_counter()
        c = ccfg.scaled(compute_dtype=compute)
        dtypes = _recast(params, torch.float32) if compute == "float32" else None
        logits = build_prefill_step(c)(params, prompt)[0]
        with plain_attention(ssd=_plain_ssd):
            plain = build_prefill_step(c)(params, prompt)[0]
        torch.cuda.synchronize()
        out[compute] = {"kernel_vs_plain_rel_err_max": _rel_rows(logits, plain).max().item(),
                        "finite": bool(torch.isfinite(logits.float()).all())}
        del logits, plain
        if compute == "float32":
            # decode against the forward on the first layer alone, fp32
            seg, = params["segments"]
            params1 = {**params, "segments": [tree_map(lambda t: t[:1], seg)]}
            sp, steps = SSD_GROUPS_DECODE
            r = _path_logits(params1, c.scaled(n_layers=1), ids[:, :sp + steps], sp, steps,
                             timed=False)
            out["depth1_fp32_decode_rel_err_max"] = _rel_rows(r["got"], r["ref"]).max().item()
            out["depth1_launches"] = r["launches"]
            del seg, params1, r
            _restore(params, dtypes)
        parts[compute] = time.perf_counter() - t1
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    check(release() < 1.0, "ssd_groups model: memory left allocated")
    # -- the train step at a cut depth, kernel and plain paths against float64
    cut, tb, ts = SSD_GROUPS_TRAIN_CUT
    tcfg = cfg.scaled(**cut)
    batch = batch_to(batch_for(tcfg, tb, ts, 0, seed=seed), torch.device("cuda"))
    tparams = materialize(param_defs(tcfg), seed, "cuda")
    t1 = time.perf_counter()
    train = _grad_check_init("reference", tparams, batch, tcfg, False)
    del tparams, batch
    check(release() < 1.0, "ssd_groups train: memory left allocated")
    parts["train_grad_check"] = time.perf_counter() - t1
    out.update(seconds=time.perf_counter() - t0, seconds_by_part=parts, fp32_tol=FP32_REL_TOL,
               bf16_tol=SSD_GROUPS_BF16_TOL)
    emit("ssd_groups_model", **out)
    check(out["finite"] and out["chunk256_bit_equal"],
          f"ssd_groups model: prefill not finite, or chunk 256 differs from 128: {out}")
    check(out["prefill_launches"] == want, f"ssd_groups model: prefill launched "
          f"{out['prefill_launches']}, expected {want}")
    for compute, tol in (("bfloat16", SSD_GROUPS_BF16_TOL), ("float32", FP32_REL_TOL)):
        o = out[compute]
        check(o["finite"], f"ssd_groups model {compute}: logits not finite")
        check(o["kernel_vs_plain_rel_err_max"] <= tol,
              f"ssd_groups model {compute}: prefill logits vs the plain path "
              f"{o['kernel_vs_plain_rel_err_max']} > {tol}")
    check(out["depth1_fp32_decode_rel_err_max"] <= FP32_REL_TOL,
          f"ssd_groups model: fp32 decode vs forward at depth 1 "
          f"{out['depth1_fp32_decode_rel_err_max']} > {FP32_REL_TOL}")
    return {f"{cfg.name} ssd_groups prefill": launches,
            f"{cfg.name} ssd_groups train_grad_check": train}


def phase_examples() -> dict[str, dict[str, int]]:
    """The port's examples on the card, in process at small arguments,
    their printing kept out of this script's output: ``serving.py``
    (granite's smoke config on three replicas, one killed mid-traffic;
    every request completes) and ``resilient_training.py`` (30 steps
    through a host loss, a NaN and a straggler; the loss falls, a restore
    and the NaN's recovery reported).  Returns the launches by path."""
    import importlib.util
    import io

    def example(name: str):
        spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                      ROOT / "examples" / "torch" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    runs = {"serving": ["--requests", "8", "--new-tokens", "8", "--replicas", "3"],
            "resilient_training": ["--steps", "30",
                                   "--ckpt", str(ROOT / "build" / "chip_smoke_example_ckpt")]}
    out, launches = {}, {}
    for name, argv in runs.items():
        t0 = time.perf_counter()
        zero_counts()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            res = example(name).main(argv)
        torch.cuda.synchronize()
        launches[f"examples {name}"] = launch_counts()
        out[name] = dict(res, seconds=time.perf_counter() - t0,
                         printed_lines=len(printed.getvalue().splitlines()),
                         launches=launches[f"examples {name}"])
    emit("examples", **out)
    sv, tr = out["serving"], out["resilient_training"]
    check(sv["device"].startswith("cuda") and tr["device"].startswith("cuda"),
          f"examples ran on {sv['device']} and {tr['device']}, not the card")
    check(sv["completed"] == sv["static_completed"] == sv["requests"] and not sv["failed"]
          and sv["recoveries"] >= 1, f"examples serving: {sv}")
    check(tr["last_loss"] < tr["first_loss"] and tr["restores"] >= 1
          and "NumericalDivergenceError" in tr["recoveries"], f"examples training: {tr}")
    # serving decodes token by token (no kernel: the reference has no decode
    # kernel); training runs the flash kernels both ways
    check(tr["launches"]["flash_attention"] > 0 and tr["launches"]["flash_attention_bwd"] > 0,
          f"examples training: no kernel launched ({tr['launches']})")
    return launches


# ---------------------------------------------------------------------------
# shapes: the flash and SSD kernels off the ten configs' shapes.  Each
# route (kernels/flash_attention.py:route, kernels/ssd_scan.py:route) at
# small cases in bf16, fp16 and fp32, forward and backward, against the
# plain versions; the padded bf16 route at public models' full-width
# shapes (phi-2's attention at D 80, phi-3-mini's at D 96, Zamba2's Mamba-2
# layers at (P, N) = (64, 64)), fp16's wgmma route and fp32's register-tiled
# one at phi-2's and the staged route at D 20 in fp16 and bf16, timed
# beside their bounds, the plain versions and SDPA; then granite at
# head dim 40 and mamba2 at (P, N) = (32, 64), each through prefill and
# decode and a train-step gradient, kernel path against plain path.
# ---------------------------------------------------------------------------
SHAPES_FLASH_CASES = [  # (dk, dv, dtype, causal, window) at B 2, S 130, H 4 over KV 2
    (40, 40, torch.bfloat16, True, 48), (80, 80, torch.bfloat16, True, 0),
    (96, 64, torch.bfloat16, True, 0), (8, 8, torch.bfloat16, False, 0),
    (160, 128, torch.bfloat16, True, 0), (144, 64, torch.bfloat16, False, 0),
    (200, 200, torch.bfloat16, True, 48), (20, 20, torch.bfloat16, True, 0),
    (80, 80, torch.float16, True, 0), (256, 256, torch.float16, True, 48),
    (20, 20, torch.float16, True, 0), (5, 3, torch.float16, True, 48),
    (16, 16, torch.float16, True, 0), (24, 16, torch.float16, True, 48),
    (96, 96, torch.float32, True, 0), (200, 136, torch.float32, False, 0),
    (5, 3, torch.float32, True, 0),
]
# B * H past 65535 (the old grid's limit): B 1, S 16, 65600 heads (MHA)
SHAPES_FLASH_WIDE = [(64, 64, torch.float32), (48, 48, torch.float16)]
SHAPES_SSD_CASES = [  # (P, N, dtype, G, initial state) at B 1, L 100, H 4, chunk 64
    (32, 64, torch.bfloat16, 1, False), (64, 64, torch.bfloat16, 2, True),
    (8, 16, torch.bfloat16, 1, True), (24, 40, torch.bfloat16, 1, False),
    (20, 64, torch.bfloat16, 1, False), (96, 128, torch.bfloat16, 2, True),
    (128, 256, torch.float16, 1, False), (32, 64, torch.float32, 2, True),
    (64, 128, torch.float16, 1, True),
]
SHAPES_PUBLIC_FLASH = [  # (case, B, S, H (MHA), D, dtype), causal
    ("phi2_d80", 4, 1024, 32, 80, torch.bfloat16),
    ("phi3_mini_d96", 4, 1024, 32, 96, torch.bfloat16),
    ("phi2_d80_fp16", 4, 1024, 32, 80, torch.float16),
    # phi-2's fp32 forward and backward on the register-tiled kernels
    ("phi2_d80_fp32", 4, 1024, 32, 80, torch.float32),
    # the staged route's full-width forward and backward: a head dim that
    # is no multiple of 8, in fp16 and bf16, on the (64, 64) bucket's wgmma
    # kernels at a pitch of 24
    ("d20_fp16", 4, 1024, 32, 20, torch.float16),
    ("d20_bf16", 4, 1024, 32, 20, torch.bfloat16),
]
SHAPES_PUBLIC_SSD = [  # (case, B, L, H, P, N, dtype), chunk 128
    ("zamba2_p64_n64", 4, 1024, 48, 64, 64, torch.bfloat16),
    ("zamba2_p64_n64_fp16", 1, 1024, 48, 64, 64, torch.float16),
]
# the two scaled smoke configs: (cut of the smoke config, B, S, decode
# steps; an SSD model's forward over S + steps takes whole chunks of 32)
SHAPES_MODELS = {"granite_3_2b": ({"head_dim": 40}, 2, 128, 8),
                 "mamba2_780m": ({"ssm": {"head_dim": 32, "d_state": 64}}, 2, 128, 32)}
# kernel path against plain path on those models: relative L2 of a row of
# logits, the forward's and the backward's own dtype limits (SSD_TOL)
SHAPES_MODEL_TOL = {"bfloat16": 5e-2, "float16": 5e-2, "float32": 2e-3}
# the scaled configs' compute dtypes: granite's D 40 also in fp16 (the f16
# wgmma route), with its parameters cast as the fp32 run casts them
SHAPES_MODEL_DTYPES = {"granite_3_2b": ("bfloat16", "float16", "float32"),
                       "mamba2_780m": ("bfloat16", "float32")}


def zero_route_counts() -> None:
    """Set the padded, the fp16 wgmma, the staged, the general (SSD) and
    the fp32 routes' launch counts to 0."""
    from repro_torch.kernels.ops import flash_attention, ssd_scan
    for fn in (flash_attention, ssd_scan):
        fn.pad_launches = fn.bwd_pad_launches = 0
    ssd_scan.any_launches = ssd_scan.bwd_any_launches = 0
    flash_attention.stage_launches = flash_attention.bwd_stage_launches = 0
    flash_attention.f16_launches = flash_attention.bwd_f16_launches = 0
    flash_attention.f32_launches = flash_attention.bwd_f32_launches = 0


def route_counts() -> dict[str, int]:
    """The padded, the fp16 wgmma, the staged, the general (SSD) and the
    fp32 routes' launches, per kernel row."""
    from repro_torch.kernels.ops import flash_attention, ssd_scan
    return {"flash_fwd_bf16_pad": flash_attention.pad_launches,
            "flash_fwd_f16": flash_attention.f16_launches,
            "flash_fwd_stage": flash_attention.stage_launches,
            "flash_fwd_f32": flash_attention.f32_launches,
            "flash_bwd_bf16_pad": flash_attention.bwd_pad_launches,
            "flash_bwd_f16": flash_attention.bwd_f16_launches,
            "flash_bwd_stage": flash_attention.bwd_stage_launches,
            "flash_bwd_f32": flash_attention.bwd_f32_launches,
            "ssd_fwd_bf16_pad": ssd_scan.pad_launches, "ssd_fwd_any": ssd_scan.any_launches,
            "ssd_bwd_bf16_pad": ssd_scan.bwd_pad_launches,
            "ssd_bwd_any": ssd_scan.bwd_any_launches}


def flash_small_names(cases: list) -> list[list[str]]:
    """The kernels one forward launch (with lse) and one backward launch of
    each small flash case (B, S, H, KV, DK, DV, dtype name, causal, window)
    ran, by the profiler's names, on inputs from a seed.  Run in a process
    of its own (:func:`flash_names_apart`)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for b, s, h, kv, dk, dv, dtype, causal, window in cases:
        dt = getattr(torch, dtype.removeprefix("torch."))
        q, do = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt) for d in (dk, dv))
        k, v = (torch.randn(b, s, kv, d, generator=gen, device="cuda").to(dt) for d in (dk, dv))
        kw = dict(causal=causal, window=window)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        names = set(kernels_device_ms(lambda: flash_attention_cuda(q, k, v, return_lse=True, **kw),
                                      iters=3))
        names |= set(kernels_device_ms(
            lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw), iters=3))
        out.append(sorted(names))
    return out


def flash_names_apart(cases: list) -> list[list[str]]:
    """:func:`flash_small_names` in a process of its own: late in the whole
    run the profiler in this process has returned no record at all for
    these few-microsecond windows of the port's kernels (while reading
    PyTorch's own), which a fresh process reads (PERF.md §6).  The kernels
    are built by then; the process loads them."""
    code = ("import json, sys, chip_smoke; "
            "print(json.dumps(chip_smoke.flash_small_names(json.loads(sys.argv[1]))))")
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(cases)], capture_output=True,
                          text=True, cwd=ROOT, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    check(proc.returncode == 0, f"shapes: the kernel-name process exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def f32_smoke_forwards_apart(cases: list, results: list[dict], key: str) -> None:
    """The forward kernels of the fp32 smoke cases among ``cases`` (name,
    B, S, Sk = S, H, KV, D, Dv, dtype, causal, window), read in a process
    of their own (:func:`flash_names_apart`: the profiler here may return
    no record of their few-microsecond windows), checked to be the
    register-tiled fp32 kernel alone and stored under ``key`` in each
    case's row of ``results``."""
    small = [(i, c) for i, c in enumerate(cases)
             if c[8] == torch.float32 and c[0].startswith("smoke")]
    names = flash_names_apart([(b, s, h, kv, d, dv, str(dtype), causal, window)
                               for _, (_, b, s, _, h, kv, d, dv, dtype, causal, window)
                               in small])
    for (i, (name, *_)), kernels in zip(small, names):
        check(f32_fwd_kernels(kernels), f"flash forward {name}: ran {kernels}, not the "
              "register-tiled fp32 kernel alone")
        results[i][key] = [n for n in kernels if "flash_fwd" in n]


def _flash_small(gen, b, s, h, kv, dk, dv, dtype, causal, window) -> dict:
    """One flash case through ``ops.flash_attention`` under autograd
    (forward and backward kernels of the route), against autograd of the
    plain version in fp32 on the same values."""
    from repro_torch.kernels.flash_attention import (bwd_route, flash_attention_bwd_cuda,
                                                     flash_attention_cuda, route)
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    q = torch.randn(b, s, h, dk, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, s, kv, dk, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, s, kv, dv, generator=gen, device="cuda").to(dtype)
    do = torch.randn(b, s, h, dv, generator=gen, device="cuda").to(dtype)
    kind, bwd_kind = route(dtype, dk, dv).kind, bwd_route(dtype, dk, dv).kind
    zero_counts()
    zero_route_counts()
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, window=window)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    launches = {**launch_counts(), **{n: c for n, c in route_counts().items() if c}}
    ref_leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref = flash_attention_ref(*ref_leaves, causal=causal, window=window)
    ref_grads = torch.autograd.grad(ref, ref_leaves, do.float())
    case = f"small_{dk}_{dv}" + ("_wide" if h > 1024 else "")
    row = {"case": case, "shape": [b, s, h, kv, dk], "dv": dv, "dtype": str(dtype),
           "causal": causal, "window": window, "route": kind, "bwd_route": bwd_kind,
           "tol": gate(case, "forward", dtype, TOL[str(dtype)]),
           "bwd_tol": gate(case, "backward", dtype, BWD_TOL[str(dtype)]),
           "max_scaled_err": scaled_err(out, ref),
           "bwd_max_scaled_err": {n: scaled_err(g, r) for n, g, r in
                                  zip(("dq", "dk", "dv"), grads, ref_grads)},
           "finite": bool(torch.isfinite(out.float()).all())
           and all(bool(torch.isfinite(g.float()).all()) for g in grads),
           "launches": launches}
    what = f"shapes flash {row['shape']} dv {dv} {dtype}"
    check(row["finite"], f"{what}: not finite")
    check(row["max_scaled_err"] <= row["tol"],
          f"{what}: forward {row['max_scaled_err']} > {row['tol']}")
    worst = max(row["bwd_max_scaled_err"].values())
    check(worst <= row["bwd_tol"], f"{what}: backward {row['bwd_max_scaled_err']}")
    on_route = {"pad": "flash_fwd_bf16_pad", "f16": "flash_fwd_f16",
                "stage": "flash_fwd_stage", "f32": "flash_fwd_f32"}.get(kind)
    bwd_on_route = {"pad": "flash_bwd_bf16_pad", "f16": "flash_bwd_f16",
                    "stage": "flash_bwd_stage", "f32": "flash_bwd_f32"}.get(bwd_kind)
    check(launches["flash_attention"] == 1 and launches["flash_attention_bwd"] == 1
          and (on_route is None or launches.get(on_route) == 1)
          and (bwd_on_route is None or launches.get(bwd_on_route) == 1),
          f"{what}: launched {launches} on routes {kind}, {bwd_kind}")
    if kind == "stage":   # the staged backward, two launches bit for bit
        kw = dict(causal=causal, window=window)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        first = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        row["bwd_bit_equal"] = all(torch.equal(x, y) for x, y in zip(first, again))
        check(row["bwd_bit_equal"], f"{what}: two staged backward launches differ")
    return row


def _ssd_small(gen, b, l, h, p, n, dtype, g, init) -> dict:
    """One SSD case through ``ops.ssd_scan`` under autograd, against
    autograd of ``ssd_ref`` in fp32 on the same values (every gradient,
    the initial state's among them)."""
    from repro_torch.kernels.ops import ssd_scan
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.kernels.ssd_scan import route

    x = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).to(dtype)
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))
    bm = torch.randn(b, l, g, n, generator=gen, device="cuda").to(dtype)
    cm = torch.randn(b, l, g, n, generator=gen, device="cuda").to(dtype)
    s0 = torch.randn(b, h, p, n, generator=gen, device="cuda") if init else None
    dy = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype)
    dst = torch.randn(b, h, p, n, generator=gen, device="cuda").to(dtype)
    inputs = (x, dt, a, bm, cm) + ((s0,) if init else ())
    kind = route(dtype, p, n).kind
    zero_counts()
    zero_route_counts()
    leaves = [t.detach().requires_grad_() for t in inputs]
    y, st = ssd_scan(*leaves[:5], chunk=64, initial_state=leaves[5] if init else None)
    grads = torch.autograd.grad((y, st), leaves, (dy, dst))
    torch.cuda.synchronize()
    launches = {**launch_counts(), **{k: c for k, c in route_counts().items() if c}}
    ref_leaves = [t.detach().float().requires_grad_() for t in inputs]
    ry, rst = ssd_ref(*ref_leaves[:5], ref_leaves[5] if init else None)
    ref = torch.autograd.grad((ry, rst), ref_leaves, (dy.float(), dst.float()))
    names = ("dx", "ddt", "da", "db", "dc", "ds0")
    tol = SSD_TOL[str(dtype)]
    # da sums dt dda over every step of a head: held to its own scale (as
    # ssd_groups' bf16 rows hold it to the plain version element by element,
    # these H = 4 values each gather 100 steps' terms that cancel)
    errs = {nm: scaled_err(gr, r) for nm, gr, r in zip(names, grads, ref) if nm != "da"}
    errs["da"] = ((grads[2].float() - ref[2]).abs().max() / (1 + ref[2].abs().max())).item()
    row = {"shape": [b, l, h, p, n], "groups": g, "initial_state": init, "dtype": str(dtype),
           "route": kind, "tol": tol, "y_max_scaled_err": scaled_err(y, ry),
           "state_max_scaled_err": scaled_err(st, rst), "bwd_max_scaled_err": errs,
           "finite": all(bool(torch.isfinite(t.float()).all()) for t in (y, st, *grads)),
           "launches": launches}
    what = f"shapes ssd {row['shape']} G {g} {dtype}"
    check(row["finite"], f"{what}: not finite")
    worst = max([row["y_max_scaled_err"], row["state_max_scaled_err"], *errs.values()])
    check(worst <= tol, f"{what}: {row['y_max_scaled_err']} {row['state_max_scaled_err']} {errs}")
    on_route = {"pad": "ssd_fwd_bf16_pad", "any": "ssd_fwd_any"}.get(kind)
    check(launches["ssd_scan"] == 1 and launches["ssd_scan_bwd"] == 1
          and (on_route is None or launches.get(on_route) == 1
               and launches.get(on_route.replace("fwd", "bwd")) == 1),
          f"{what}: launched {launches} on route {kind}")
    return row


def _flash_public(gen, name, b, s, h, d, dtype) -> dict:
    """A full-width flash forward and backward (MHA, causal): ms by events
    and by device, the kernels the profiler saw, the bound at the real
    dims, the plain version's and SDPA's times; held to the plain version."""
    from repro_torch.kernels.flash_attention import (bwd_route, flash_attention_bwd_cuda,
                                                     flash_attention_cuda, route)
    from repro_torch.kernels.ref import (flash_attention_bwd_ref, flash_attention_lse_ref,
                                         flash_attention_ref)
    from repro_torch.roofline.cost import attention_bound, attention_bwd_bound

    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    o, lse = flash_attention_cuda(q, k, v, causal=True, window=0, return_lse=True)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, causal=True, window=0)
    fwd = {"max_abs_err": (o.float() - ref.float()).abs().max().item(),
           "max_scaled_err": scaled_err(o, ref),
           "tol": gate(name, "forward", dtype, TOL[str(dtype)])}
    del ref
    if dtype == torch.float32:   # the fp32 forward's lse, and two launches bit for bit
        fwd["lse_max_abs_err"] = (lse - flash_attention_lse_ref(
            q, k, v, causal=True, window=0)).abs().max().item()
        again = flash_attention_cuda(q, k, v, causal=True, window=0, return_lse=True)
        torch.cuda.synchronize()
        fwd["bit_equal"] = bool(torch.equal(again[0], o) and torch.equal(again[1], lse))
        del again
    fwd["ms"] = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=True, window=0))
    by_kernel = kernels_device_ms(lambda: flash_attention_cuda(q, k, v, causal=True, window=0),
                                  iters=10)
    fwd["device_ms"], fwd["kernels"] = sum(by_kernel.values()), sorted(by_kernel)
    fwd["stage_device_ms"] = sum(ms for n, ms in by_kernel.items() if "flash_stage" in n)
    fwd["plain_ms"] = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True, window=0),
                              iters=2, warmup=1)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    fwd["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                       is_causal=True))
    bound_ms, bound_by, _, _ = attention_bound(b, s, s, h, h, d, d, str(dtype), True, 0)
    fwd.update(bound_ms=bound_ms, bound_by=bound_by, bound_frac=bound_ms / fwd["ms"],
               device_bound_frac=bound_ms / fwd["device_ms"],
               vs_library=fwd["ms"] / fwd["library_ms"])

    def bwd():
        return flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, window=0)

    grads = bwd()
    torch.cuda.synchronize()
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref_grads = torch.autograd.grad(flash_attention_ref(*leaves, causal=True, window=0), leaves,
                                    do.float())
    back = {"max_scaled_err": {n: scaled_err(g, r) for n, g, r in
                               zip(("dq", "dk", "dv"), grads, ref_grads)},
            "max_abs_err": max((g.float() - r).abs().max().item()
                               for g, r in zip(grads, ref_grads)),
            "tol": gate(name, "backward", dtype, BWD_TOL[str(dtype)])}
    del grads, ref_grads, leaves
    back["ms"] = cuda_ms(bwd, iters=10)
    by_kernel = kernels_device_ms(bwd, iters=10)
    back["device_ms"], back["kernels"] = sum(by_kernel.values()), sorted(by_kernel)
    back["kernel_device_ms"] = flash_bwd_split_ms(by_kernel)
    back["stage_device_ms"] = sum(ms for n, ms in by_kernel.items() if "flash_stage" in n)
    again = bwd()
    back["bit_equal"] = all(torch.equal(x, y) for x, y in zip(bwd(), again))
    del again
    back["plain_ms"] = cuda_ms(lambda: flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal=True, window=0), iters=2, warmup=1)
    sdpa, rerun = sdpa_backward(q, k, v, do, True, 0)
    back["library_ms"] = cuda_ms(rerun, iters=10) if sdpa is not None else None
    if sdpa is None:
        back["library_refused"] = rerun
    bound_ms, bound_by, _, _ = attention_bwd_bound(b, s, h, h, d, str(dtype), True, 0)
    back.update(bound_ms=bound_ms, bound_by=bound_by, bound_frac=bound_ms / back["ms"],
                device_bound_frac=bound_ms / back["device_ms"],
                vs_library=(back["ms"] / back["library_ms"]) if back["library_ms"] else None)
    row = {"case": name, "shape": [b, s, h, h, d], "dtype": str(dtype),
           "route": route(dtype, d, d).kind, "bucket": list(route(dtype, d, d).dims),
           "bwd_route": bwd_route(dtype, d, d).kind,
           "bwd_bucket": list(bwd_route(dtype, d, d).dims), "forward": fwd, "backward": back}
    check(fwd["max_scaled_err"] <= fwd["tol"], f"shapes {name}: forward {fwd['max_scaled_err']}")
    check(max(back["max_scaled_err"].values()) <= back["tol"],
          f"shapes {name}: backward {back['max_scaled_err']}")
    # the padded route: the bucket's kernels at hopper::Widths (the real
    # dims), and fp16's at hopper::HalfWidths; the staged route those and
    # the staging kernel, its backward bit for bit over two launches; fp32
    # the register-tiled kernels both ways
    check(back["bit_equal"], f"shapes {name}: two backward launches differ")
    if row["route"] == "stage":
        check(stage_kernels(fwd["kernels"], dtype) and stage_kernels(back["kernels"], dtype),
              f"shapes {name}: ran {fwd['kernels']} and {back['kernels']}, not the bucket's "
              "wgmma kernels and the staging kernel alone")
    tags = {"pad": ("hopper::Widths",) * 2, "f16": ("hopper::HalfWidths",) * 2,
            "f32": ("flash_fwd_f32_tiled", "_tiled"),
            "stage": ("",) * 2}[row["route"]]
    if row["route"] == "f32":
        check(f32_fwd_kernels(fwd["kernels"]) and f32_bwd_kernels(back["kernels"]),
              f"shapes {name}: ran {fwd['kernels']} and {back['kernels']}, not the "
              "register-tiled fp32 kernels alone")
        check(fwd["lse_max_abs_err"] <= LSE_TOL and fwd["bit_equal"],
              f"shapes {name}: forward lse {fwd['lse_max_abs_err']}, two launches equal "
              f"{fwd['bit_equal']}")
    for part, tag in zip((fwd, back), tags):
        check(part["kernels"] and all(tag in n for n in part["kernels"]),
              f"shapes {name}: ran {part['kernels']}, not {tag}")
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return row


def _ssd_public(gen, name, b, l, h, p, n, dtype) -> dict:
    """A full-width SSD forward and backward: ms by events and by device,
    the kernels the profiler saw, the bound at the real (P, N), the plain
    versions' times (no PyTorch call computes the scan); held to autograd
    of ``ssd_ref`` in fp32."""
    from repro_torch.kernels.ref import ssd_bwd_ref, ssd_ref
    from repro_torch.kernels.ssd_scan import (bwd_tile, route, ssd_scan_bwd_cuda,
                                              ssd_scan_cuda)
    from repro_torch.roofline.cost import ssd_bound, ssd_bwd_bound

    x = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).to(dtype)
    a = (-torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))).to(dtype)
    bm = torch.randn(b, l, n, generator=gen, device="cuda").to(dtype)
    cm = torch.randn(b, l, n, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype)
    inputs = (x, dt, a, bm, cm)
    tol = SSD_TOL[str(dtype)]

    def fwd():
        return ssd_scan_cuda(x, dt, a, bm, cm, chunk=128)

    def bwd():
        return ssd_scan_bwd_cuda(x, dt, a, bm, cm, dy)

    y, st = fwd()
    grads = bwd()
    torch.cuda.synchronize()
    leaves = [t.detach().float().requires_grad_() for t in inputs]
    ry, rst = ssd_ref(*leaves)
    ref = torch.autograd.grad(ry, leaves, dy.float())
    names = ("dx", "ddt", "da", "db", "dc")
    errs = {nm: scaled_err(g, r) for nm, g, r in zip(names, grads, ref)}
    forward = {"max_scaled_err": max(scaled_err(y, ry), scaled_err(st, rst)),
               "max_abs_err": max((y.float() - ry).abs().max().item(),
                                  (st.float() - rst).abs().max().item()), "tol": tol}
    back = {"max_scaled_err": errs, "tol": tol,
            "max_abs_err": max((g.float() - r).abs().max().item() for g, r in zip(grads, ref))}
    del y, st, grads, ry, rst, ref, leaves
    forward["ms"] = cuda_ms(fwd, iters=10)
    by_kernel = kernels_device_ms(fwd, iters=10)
    forward["device_ms"], forward["kernels"] = sum(by_kernel.values()), sorted(by_kernel)
    forward["plain_ms"] = cuda_ms(lambda: ssd_ref(*inputs), iters=1, warmup=0)
    forward["library_ms"] = None   # no single PyTorch call computes the SSD scan
    bound_ms, bound_by, _, _ = ssd_bound(b, l, h, p, n, 128, str(dtype), str(a.dtype))
    forward.update(bound_ms=bound_ms, bound_by=bound_by, bound_frac=bound_ms / forward["ms"],
                   device_bound_frac=bound_ms / forward["device_ms"])
    back["ms"] = cuda_ms(bwd, iters=5, warmup=1)
    by_kernel = kernels_device_ms(bwd, iters=5)
    back["device_ms"], back["kernels"] = sum(by_kernel.values()), sorted(by_kernel)
    back["plain_ms"] = cuda_ms(lambda: ssd_bwd_ref(x, dt, a, bm, cm, dy), iters=1, warmup=0)
    back["library_ms"] = None
    bound_ms, bound_by, _, _ = ssd_bwd_bound(b, l, h, p, n, str(dtype), str(a.dtype),
                                             tile=bwd_tile(dtype, p, n))
    back.update(bound_ms=bound_ms, bound_by=bound_by, bound_frac=bound_ms / back["ms"],
                device_bound_frac=bound_ms / back["device_ms"])
    kind = route(dtype, p, n).kind
    row = {"case": name, "shape": [b, l, h, p, n], "dtype": str(dtype), "route": kind,
           "forward": forward, "backward": back}
    check(forward["max_scaled_err"] <= tol, f"shapes {name}: forward {forward['max_scaled_err']}")
    check(max(errs.values()) <= tol, f"shapes {name}: backward {errs}")
    kernel = "ssd_fwd_bf16_pad" if kind == "pad" else "ssd_fwd_any"
    check(forward["kernels"] and all(kernel in k for k in forward["kernels"]),
          f"shapes {name}: the forward ran {forward['kernels']}, not {kernel}")
    del x, dt, a, bm, cm, dy
    torch.cuda.empty_cache()
    return row


def _shapes_model(arch: str, seed: int) -> dict[str, int]:
    """A smoke config cut off the built shapes, on the card: prefill and
    decode, kernel path against plain path in bf16 (the padded route), fp16
    where SHAPES_MODEL_DTYPES names it (granite: the f16 wgmma route) and
    fp32 (the register-tiled fp32 kernels, every forward launch of the
    kernel path on them), then a train step's loss and gradients held
    to float64 as train_grad_check holds them.  Returns the route
    launches of the run (counted from 0)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import batch_for
    from repro_torch.distributed.step import batch_to
    from repro_torch.models import materialize, param_defs
    from repro_torch.models.spec import tree_map

    cut, b, s, steps = SHAPES_MODELS[arch]
    base = get_smoke_config(arch)
    if "ssm" in cut:
        base = base.scaled(ssm=dataclasses.replace(base.ssm, **cut["ssm"]))
    else:
        base = base.scaled(**cut)
    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    ids = torch.randint(0, base.vocab_size, (b, s + steps), generator=gen, device="cuda")
    zero_route_counts()
    out = {"config": base.name, "cut": cut, "batch": b, "prompt": s, "steps": steps}
    for compute in SHAPES_MODEL_DTYPES[arch]:
        cfg = base.scaled(compute_dtype=compute)
        params = materialize(param_defs(cfg), seed, "cuda")
        if compute != "bfloat16":
            cast = getattr(torch, compute)
            params = tree_map(lambda t: t.to(cast) if t.is_floating_point() else t, params)
        f32_before = route_counts()["flash_fwd_f32"]
        k = _path_logits(params, cfg, ids, s, steps, timed=False)
        # the path's forward launches, and those of them on the fp32 kernel
        fwd_launches = launch_counts()["flash_attention"]
        f32_launches = route_counts()["flash_fwd_f32"] - f32_before
        with plain_attention():
            p = _path_logits(params, cfg, ids, s, steps, timed=False)
        want = expected_launches(cfg)
        row = {"prefill_launches": k["prefill_launches"], "plain_launches": p["prefill_launches"],
               "forward_launches": fwd_launches, "f32_forward_launches": f32_launches,
               "decode_rel_err": _rel_rows(k["got"], p["got"]).max().item(),
               "forward_rel_err": _rel_rows(k["ref"], p["ref"]).max().item(),
               "tol": gate(f"{arch}_shapes", "forward", cfg.cdtype, SHAPES_MODEL_TOL[compute]),
               "finite": bool(torch.isfinite(k["got"].float()).all())}
        out[compute] = row
        what = f"shapes {arch} {compute}"
        check(row["finite"], f"{what}: logits not finite")
        check(row["prefill_launches"] == want, f"{what}: prefill launched "
              f"{row['prefill_launches']}, expected {want}")
        check(not any(row["plain_launches"].values()), f"{what}: the plain path launched")
        check(f32_launches == (fwd_launches if compute == "float32" else 0),
              f"{what}: {f32_launches} of {fwd_launches} forward launches on the fp32 kernel")
        check(max(row["decode_rel_err"], row["forward_rel_err"]) <= row["tol"],
              f"{what}: kernel path vs plain path {row['decode_rel_err']} "
              f"{row['forward_rel_err']} > {row['tol']}")
        del params, k, p
    batch = batch_to(batch_for(base, b, s, 0, seed=seed), torch.device("cuda"))
    params = materialize(param_defs(base), seed, "cuda")
    _grad_check_init("reference", params, batch, base, False,
                     tuple(d for d in ("float32", "bfloat16", "float16")
                           if d in SHAPES_MODEL_DTYPES[arch]))
    launches = route_counts()
    out["route_launches"] = launches
    emit("shapes_model", **out)
    del params, batch
    return launches


def phase_shapes(seed: int) -> tuple[dict, dict[str, dict[str, int]]]:
    """The routes off the built shapes (see the section's head): returns
    the readings of the kernel table's route rows and the two models'
    route launches by path."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    t0 = time.perf_counter()
    cases = [(2, 130, 4, 2, *case) for case in SHAPES_FLASH_CASES]
    cases += [(1, 16, 65600, 65600, d, d, dtype, True, 0) for d, _, dtype in SHAPES_FLASH_WIDE]
    small = [_flash_small(gen, *case) for case in cases]
    # each case drove ops.flash_attention under autograd, its counts zeroed
    # just before and read just after: together a path of their own
    small_launches: dict[str, int] = {}
    for row in small:
        for name, n in row["launches"].items():
            small_launches[name] = small_launches.get(name, 0) + n
    # fp16, fp32 and the staged cases: the kernels the profiler saw, the
    # f16 wgmma kernels on the "f16" route, the bucket's wgmma kernels and
    # the staging kernel on "stage"; fp32 both ways on the register-tiled
    # kernels alone
    named = [(row, case) for row, case in zip(small, cases)
             if case[6] in (torch.float16, torch.float32) or row["route"] == "stage"]
    names = flash_names_apart([(*c[:6], str(c[6]), *c[7:]) for _, c in named])
    for (row, case), kernels in zip(named, names):
        row["kernels"] = kernels
        what = f"shapes flash {row['shape']} dv {row['dv']} {case[6]}"
        if case[6] == torch.float32:
            check(f32_fwd_kernels(kernels) and f32_bwd_kernels(kernels),
                  f"{what}: ran {kernels}, not the register-tiled fp32 kernels alone")
        elif row["route"] == "f16":
            check(f16_kernels(kernels), f"{what}: ran {kernels}")
        else:
            check(row["route"] == "stage" and stage_kernels(kernels, case[6]),
                  f"{what}: ran {kernels}, not the bucket's wgmma kernels and the staging "
                  "kernel alone")
    ssd_small = [_ssd_small(gen, 1, 100, 4, *case) for case in SHAPES_SSD_CASES]
    emit("shapes_small", flash=small, ssd=ssd_small, seconds=time.perf_counter() - t0)
    public = {c[0]: _flash_public(gen, *c) for c in SHAPES_PUBLIC_FLASH}
    public.update({c[0]: _ssd_public(gen, *c) for c in SHAPES_PUBLIC_SSD})
    for row in public.values():
        emit("shapes_public", **row)
    launches = {f"{arch} {SHAPES_MODELS[arch][0]} prefill+decode+train (shapes)":
                _shapes_model(arch, seed) for arch in SHAPES_MODELS}
    for arch_launches in launches.values():
        check(any(arch_launches.values()), f"shapes: a model launched no route kernel "
              f"({arch_launches})")
    launches["shapes small flash cases (ops.flash_attention under autograd)"] = small_launches
    return public, launches


def kernel_device_ms(fn, iters: int = 50) -> float:
    """Mean device time a call of ``fn`` spends in kernels, from
    torch.profiler (host time between launches excluded)."""
    return sum(kernels_device_ms(fn, iters).values())


def kernels_device_ms(fn, iters: int = 50) -> dict[str, float]:
    """Mean device ms a call of ``fn`` spends in each kernel, by the
    profiler's kernel name.  A window the profiler returned no record of
    is profiled again, up to three times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_kernel = {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA}
        if by_kernel:
            break
    return by_kernel


def flash_bwd_split_ms(by_kernel: dict[str, float]) -> dict[str, float]:
    """The flash backward's device ms by kernel: dQ, dK/dV and the pass
    that sums the dK/dV kernel's head shares."""
    return {part: sum(ms for name, ms in by_kernel.items() if tag in name)
            for part, tag in (("dq", "flash_bwd_dq"), ("dkdv", "flash_bwd_dkdv"),
                              ("sum_shares", "flash_bwd_sum"))}


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
            # the SSD and flash backwards' kernels (all routes), one step's share
            "ssd_bwd_ms": sum(e.self_device_time_total for e in events
                              if "ssd_bwd" in e.key) / 1e3,
            "flash_bwd_ms": sum(e.self_device_time_total for e in events
                                if "flash_bwd" in e.key) / 1e3,
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top]}


def zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from repro_torch.kernels.ops import flash_attention, ssd_scan
    flash_attention.launches = flash_attention.ws_launches = flash_attention.bwd_launches = 0
    ssd_scan.launches = ssd_scan.bwd_launches = 0


def launch_counts() -> dict[str, int]:
    """The launches that show what a path ran, per kernel."""
    from repro_torch.kernels.ops import flash_attention, ssd_scan
    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention.bwd_launches,
            "ssd_scan": ssd_scan.launches, "ssd_scan_bwd": ssd_scan.bwd_launches}


def ws_launches() -> int:
    """The forward launches that took the MLA kernel (flash_fwd_bf16_ws),
    a share of ``launch_counts()["flash_attention"]``."""
    from repro_torch.kernels.ops import flash_attention
    return flash_attention.ws_launches


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
    prefill_ws = ws_launches()
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
    out = {"prefill_launches": prefill_launches, "launches": launches, "prefill_ws": prefill_ws}
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
    return {"flash_attention": attn, "flash_attention_bwd": 0, "ssd_scan": mixers.count("ssd"),
            "ssd_scan_bwd": 0}


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
    # bf16 MLA layers (q/k 192, v 128) take the MLA kernel, every other layer another
    mla_layers = [m for m, _ in cfg.block_kinds()].count("mla")
    check(bf["prefill_ws"] == mla_layers,
          f"{arch}: the MLA kernel launched {bf['prefill_ws']} times, expected {mla_layers}")
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
    return {**bf["launches"], "flash_fwd_bf16_ws": bf["prefill_ws"]}


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
        f"{a} decode_step" for a in ROOFLINE_DECODE} | {
        f"{a} train_step" for a in ("granite_3_2b",) + ROOFLINE_TRAIN}
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
            check(launches == {"flash_attention": 1, "flash_attention_bwd": 0, "ssd_scan": 1,
                               "ssd_scan_bwd": 0},
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


def sdpa_backward(q, k, v, do, causal: bool, window: int):
    """SDPA's forward and backward on (B, S, H, D) inputs, the backward's
    yardstick: (grads in the model layout, a function that reruns the
    backward), or (None, the error) where no SDPA backend takes the shape."""
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    do_t = do.transpose(1, 2)
    try:
        out = F.scaled_dot_product_attention(*leaves, **_sdpa_kw(q.shape[1], causal, window))
        grads = torch.autograd.grad(out, leaves, do_t, retain_graph=True)
    except RuntimeError as e:   # a reading: the yardstick's refusal is reported, not hidden
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"

    def rerun():
        return torch.autograd.grad(out, leaves, do_t, retain_graph=True)

    return [g.transpose(1, 2) for g in grads], rerun


def phase_flash_bwd_cases(seed: int) -> list[dict]:
    """The flash backward kernels against autograd of the plain forward in
    fp32, on the same values; and the forward with its lse output on
    against it off."""
    from repro_torch.kernels.flash_attention import (bwd_f32_head_shares, bwd_head_shares,
                                                     flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.ref import flash_attention_lse_ref, flash_attention_ref
    from repro_torch.roofline.cost import attention_bwd_bound, attention_bwd_dq_bound

    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    cases = [  # (name, B, S, Sk, H, KV, D, Dv, dtype, causal, window)
        ("granite_train", 4, 1024, 1024, 32, 8, 64, 64, torch.bfloat16, True, 0),
        ("granite_train_s2048", 4, 2048, 2048, 32, 8, 64, 64, torch.bfloat16, True, 0),
        ("ragged_s100", 4, 100, 100, 32, 8, 64, 64, torch.bfloat16, True, 0),
        ("window256", 4, 1024, 1024, 32, 8, 64, 64, torch.bfloat16, True, 256),
        ("d128", 4, 1024, 1024, 32, 8, 128, 128, torch.bfloat16, True, 0),
        ("fp32", 4, 1024, 1024, 32, 8, 64, 64, torch.float32, True, 0),
        ("fp32_d128", 2, 512, 512, 32, 8, 128, 128, torch.float32, True, 0),
        # recurrentgemma-9b's windowed MQA layer at its training length
        # (2560 past the 2048 window, so the mask bites), deepseek-v3's MLA
        # (q/k 192, v 128), each also in fp32 at a smaller S; seamless's
        # cross-attention (256 decoder rows over 1024 frames, unmasked)
        ("recurrentgemma_train", 2, 2560, 2560, 16, 1, 256, 256, torch.bfloat16, True, 2048),
        ("recurrentgemma_train_fp32", 2, 1024, 1024, 16, 1, 256, 256, torch.float32, True, 768),
        ("mla_train", 2, 1024, 1024, 128, 128, 192, 128, torch.bfloat16, True, 0),
        ("mla_train_fp32", 1, 512, 512, 128, 128, 192, 128, torch.float32, True, 0),
        # the two-warpgroup dQ kernel's ragged edge at MLA: S 1000 leaves the
        # last 128-row block's second half partly past S, and 13 (batch,
        # head) units are not a multiple of its block order's groups of 8
        ("mla_ragged_train", 1, 1000, 1000, 13, 13, 192, 128, torch.bfloat16, True, 0),
        ("seamless_cross_train", 4, 256, 1024, 16, 16, 64, 64, torch.bfloat16, False, 0),
        # fp16 beside bf16 (FP16_TWINS), on the f16 wgmma kernels: granite's,
        # llava's (and its bf16 row), recurrentgemma's and MLA's at B 2
        ("llava_train", 4, 1024, 1024, 64, 64, 128, 128, torch.bfloat16, True, 0),
        ("granite_train_fp16", 4, 1024, 1024, 32, 8, 64, 64, torch.float16, True, 0),
        ("llava_train_fp16", 4, 1024, 1024, 64, 64, 128, 128, torch.float16, True, 0),
        ("recurrentgemma_train_fp16", 2, 2560, 2560, 16, 1, 256, 256, torch.float16, True, 2048),
        ("mla_train_fp16", 2, 1024, 1024, 128, 128, 192, 128, torch.float16, True, 0),
        # the smoke configs' head dims: the SIMT kernels in bf16, the register-tiled ones in fp32
        ("smoke_d16_train", 2, 64, 64, 4, 2, 16, 16, torch.bfloat16, True, 0),
        ("smoke_d16_cross_train", 2, 64, 80, 4, 4, 16, 16, torch.bfloat16, False, 0),
        ("smoke_d16_window32_train", 2, 64, 64, 4, 1, 16, 16, torch.bfloat16, True, 32),
        ("smoke_d16_train_fp32", 2, 64, 64, 4, 2, 16, 16, torch.float32, True, 0),
        ("smoke_mla_train", 2, 64, 64, 4, 4, 24, 16, torch.bfloat16, True, 0),
        ("smoke_mla_train_fp32", 2, 64, 64, 4, 4, 24, 16, torch.float32, True, 0),
    ]
    results = []
    for name, b, s, sk, h, kv, d, dv, dtype, causal, window in cases:
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(b, sk, kv, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, sk, kv, dv, generator=gen, device="cuda").to(dtype)
        do = torch.randn(b, s, h, dv, generator=gen, device="cuda").to(dtype)
        kw = dict(causal=causal, window=window)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        grads = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        ref_out = flash_attention_ref(*leaves, **kw)
        ref = torch.autograd.grad(ref_out, leaves, do.float(), retain_graph=True)
        lse_ref = flash_attention_lse_ref(q, k, v, **kw)
        # the yardstick: SDPA's backward on the same values, where it takes them
        lib, lib_bwd = sdpa_backward(q, k, v, do, causal, window)
        torch.cuda.synchronize()
        tol = gate(name, "backward", dtype, BWD_TOL[str(dtype)])
        names = ("dq", "dk", "dv")
        row = {"case": name, "shape": [b, s, h, kv, d], "dv": dv, "sk": sk, "dtype": str(dtype),
               "causal": causal, "window": window, "tol": tol,
               "max_scaled_err": {n: scaled_err(g, r) for n, g, r in zip(names, grads, ref)},
               "max_abs_err": {n: (g.float() - r).abs().max().item()
                               for n, g, r in zip(names, grads, ref)},
               "ref_abs_max": {n: r.abs().max().item() for n, r in zip(names, ref)},
               "library_max_scaled_err": (None if lib is None else
                                          {n: scaled_err(g, r) for n, g, r in zip(names, lib, ref)}),
               "library_refused": None if lib is not None else lib_bwd,
               "lse_max_abs_err": (lse - lse_ref).abs().max().item(), "lse_tol": LSE_TOL,
               "finite": all(bool(torch.isfinite(g.float()).all()) for g in grads)}
        if dtype == torch.float32:
            # the fp32 forward: held to the plain version, the kernel the
            # profiler saw, two launches bit for bit
            row["fwd_max_scaled_err"] = scaled_err(o, ref_out.detach())
            fwd_ms = kernels_device_ms(
                lambda: flash_attention_cuda(q, k, v, return_lse=True, **kw), iters=5)
            row["fwd_device_ms"], row["fwd_kernels"] = sum(fwd_ms.values()), sorted(fwd_ms)
            o2, lse2 = flash_attention_cuda(q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
            row["fwd_bit_equal"] = bool(torch.equal(o2, o) and torch.equal(lse2, lse))
            del o2, lse2
        # determinism: a second launch on the same inputs gives the same bits
        again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        row["bit_equal"] = all(bool(torch.equal(a, g)) for a, g in zip(again, grads))
        del again

        def bwd():
            return flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)

        row["ms"] = cuda_ms(bwd)
        row["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(ref_out, leaves, do.float(),
                                                              retain_graph=True),
                                  iters=3, warmup=1)
        # device time from the profiler: SDPA's autograd call is paced by the
        # host at these sizes, so its event time varies from call to call
        if name in FP16_TWINS or name in FP16_TWINS.values() or dtype == torch.float32:
            # fp16 beside bf16, and fp32 on its register-tiled kernels: the
            # kernels the profiler saw too
            by_kernel = kernels_device_ms(bwd)
            row["device_ms"], row["kernels"] = sum(by_kernel.values()), sorted(by_kernel)
        else:
            row["device_ms"] = kernel_device_ms(bwd)
        if dtype == torch.float32:
            # the dQ kernel, the dK/dV kernel and the head shares' sum apart,
            # the dQ kernel's own bound, the plan's shares
            row["kernel_device_ms"] = flash_bwd_split_ms(by_kernel)
            row["shares"] = bwd_f32_head_shares(b, kv, h // kv, sk, d, dv, sm_count)
            row["dq_bound_ms"], row["dq_bound_by"], _, _ = attention_bwd_dq_bound(
                b, s, h, kv, d, str(dtype), causal, window, dv=dv, sk=sk)
            row["dq_bound_frac"] = row["dq_bound_ms"] / row["kernel_device_ms"]["dq"]
        row["library_ms"] = row["library_device_ms"] = row["vs_library"] = None
        if lib is not None:
            row["library_ms"] = cuda_ms(lib_bwd)
            row["library_device_ms"] = kernel_device_ms(lib_bwd)
            row["vs_library"] = row["device_ms"] / row["library_device_ms"]
        bound_ms, bound_by, flops, nbytes = attention_bwd_bound(b, s, h, kv, d, str(dtype),
                                                                causal, window, dv=dv, sk=sk)
        row.update(bound_ms=bound_ms, bound_by=bound_by, bound_frac=bound_ms / row["ms"],
                   device_bound_frac=bound_ms / row["device_ms"],
                   flops=flops, bytes=nbytes, tflops=flops / (row["ms"] * 1e-3) / 1e12)
        if name in ("recurrentgemma_train", "mla_train", "mla_ragged_train"):
            # the two-warpgroup dQ and dK/dV kernels' shapes: device ms by
            # kernel, the dQ kernel's own bound and its name, the dK/dV
            # kernel's head shares
            by_kernel = kernels_device_ms(bwd, iters=10)
            row["kernel_device_ms"] = flash_bwd_split_ms(by_kernel)
            row["dq_kernels"] = sorted(n for n in by_kernel if "flash_bwd_dq" in n)
            row["shares"] = bwd_head_shares(b, kv, h // kv, sk, sm_count)
            row["dq_bound_ms"], row["dq_bound_by"], _, _ = attention_bwd_dq_bound(
                b, s, h, kv, d, str(dtype), causal, window, dv=dv, sk=sk)
            row["dq_bound_frac"] = row["dq_bound_ms"] / row["kernel_device_ms"]["dq"]
        if name in ("recurrentgemma_train", "mla_train"):
            # the train step's own launch shape, B 1 (four microbatches of B
            # 4): the first row of the same inputs

            def bwd_b1():
                return flash_attention_bwd_cuda(q[:1], k[:1], v[:1], o[:1], lse[:1], do[:1], **kw)

            first, again = bwd_b1(), bwd_b1()
            torch.cuda.synchronize()
            b1_bound, b1_by, _, _ = attention_bwd_bound(1, s, h, kv, d, str(dtype), causal,
                                                        window, dv=dv, sk=sk)
            b1 = {"ms": cuda_ms(bwd_b1), "shares": bwd_head_shares(1, kv, h // kv, sk, sm_count),
                  "max_scaled_err": {n: scaled_err(g, r[:1]) for n, g, r in
                                     zip(names, first, ref)},
                  "finite": all(bool(torch.isfinite(g.float()).all()) for g in first),
                  "bit_equal": all(bool(torch.equal(x, y)) for x, y in zip(first, again)),
                  "bound_ms": b1_bound, "bound_by": b1_by}
            by_kernel = kernels_device_ms(bwd_b1, iters=10)
            b1.update(device_ms=sum(by_kernel.values()),
                      kernel_device_ms=flash_bwd_split_ms(by_kernel),
                      bound_frac=b1_bound / b1["ms"])
            b1["dq_bound_ms"], b1["dq_bound_by"], _, _ = attention_bwd_dq_bound(
                1, s, h, kv, d, str(dtype), causal, window, dv=dv, sk=sk)
            b1["dq_bound_frac"] = b1["dq_bound_ms"] / b1["kernel_device_ms"]["dq"]
            row["b1"] = b1
            del first, again
        if name in FP16_TWINS:   # the bf16 row at the same shape, earlier in this run
            twin = next(r for r in results if r["case"] == FP16_TWINS[name])
            row["vs_bf16_device"] = row["device_ms"] / twin["device_ms"]
        emit("flash_bwd_vs_plain", **row)
        worst = max(row["max_scaled_err"].values())
        check(worst <= tol and row["finite"],
              f"flash backward {name}: max |grad - ref| / (1 + |ref|) = {worst} > {tol}")
        check(row["bit_equal"], f"flash backward {name}: two launches differ")
        if name in FP16_TWINS:
            check(f16_kernels(row["kernels"]),
                  f"flash backward {name}: ran {row['kernels']}, not the f16 wgmma kernels")
        if dtype == torch.float32:
            check(f32_bwd_kernels(row["kernels"]),
                  f"flash backward {name}: ran {row['kernels']}, not the register-tiled "
                  "fp32 kernels alone")
            check(row["fwd_max_scaled_err"] <= TOL[str(dtype)] and row["fwd_bit_equal"]
                  and (name.startswith("smoke") or f32_fwd_kernels(row["fwd_kernels"])),
                  f"flash forward {name}: {row['fwd_max_scaled_err']}, two launches equal "
                  f"{row['fwd_bit_equal']}, ran {row['fwd_kernels']}")
        if "dq_kernels" in row:   # bf16 at (256, 256) and (192, 128): the two-warpgroup dQ kernel
            check(row["dq_kernels"] and all("flash_bwd_dq_bf16_pair" in k
                                            for k in row["dq_kernels"]),
                  f"flash backward {name}: dQ ran {row['dq_kernels']}, not the two-warpgroup "
                  "kernel")
        if "b1" in row:
            worst = max(row["b1"]["max_scaled_err"].values())
            check(worst <= tol and row["b1"]["finite"],
                  f"flash backward {name} B 1: max |grad - ref| / (1 + |ref|) = {worst} > {tol}")
            check(row["b1"]["bit_equal"], f"flash backward {name} B 1: two launches differ")
        check(row["lse_max_abs_err"] <= LSE_TOL,
              f"flash forward lse {name}: max |lse - ref| = {row['lse_max_abs_err']}")
        results.append(row)
        del q, k, v, do, o, lse, grads, leaves, ref_out, ref, lib, lib_bwd
        torch.cuda.empty_cache()
    f32_smoke_forwards_apart(cases, results, "fwd_kernels")

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
    sk, g = k.shape[1], h // k.shape[2]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    pos, kpos = torch.arange(s, device=q.device), torch.arange(sk, device=q.device)
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= pos[:, None]
    if window:
        mask &= kpos[None, :] > pos[:, None] - window
    p = torch.softmax(scores.masked_fill(~mask, -math.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def ssd_in_dtype(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, *, chunk: int | None = None, initial_state=None):
    """The SSD scan computed in x's dtype (the float64 referee), chunk by
    chunk, differentiable by autograd: the function ``ssd_ref`` computes
    (masked before the exp).  b, c: (B, L, N) or (B, L, G, N), head h
    reading group h // (H / G); ``initial_state`` (B, H, P, N) or None.
    a: (H,), or (B, L, H), a per step: its gradient is then each step's
    term dt_k dda_k of the head's da."""
    if b.dim() == 3:
        b, c = b[:, :, None], c[:, :, None]
    bb, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    b, c = b.repeat_interleave(h // g, dim=2), c.repeat_interleave(h // g, dim=2)
    q = chunk or l
    check(l % q == 0, f"ssd_in_dtype: L {l} is not whole chunks of {q}")
    nc = l // q
    xs, bs, cs = (t.reshape(bb, nc, q, h, t.shape[-1]) for t in (x, b, c))
    dts = dt.to(x.dtype).reshape(bb, nc, q, h)
    av = a.to(x.dtype)
    if av.dim() == 3:
        av = av.reshape(bb, nc, q, h)
    cum = torch.cumsum(dts * av, dim=2)                                  # (B, nc, Q, H)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    lmat = torch.exp(torch.where(causal, cum[:, :, :, None] - cum[:, :, None], -math.inf))
    u = dts[..., None] * xs
    y = torch.einsum("bcihn,bcjhn,bcijh,bcjhp->bcihp", cs, bs, lmat, u)
    upd = torch.einsum("bcjh,bcjhp,bcjhn->bchpn", torch.exp(cum[:, :, -1:] - cum), u, bs)
    keep = torch.exp(cum[:, :, -1])
    state = x.new_zeros((bb, h, p, n)) if initial_state is None else initial_state.to(x.dtype)
    s_prev = []
    for ci in range(nc):
        s_prev.append(state)
        state = keep[:, ci, :, None, None] * state + upd[:, ci]
    y = y + torch.einsum("bcihn,bchpn,bcih->bcihp", cs, torch.stack(s_prev, dim=1),
                         torch.exp(cum))
    return y.reshape(bb, l, h, p), state


def da_vs_float64(inputs, s0, dy, dstate, kernel_da, plain_da) -> dict:
    """The SSD backward's da from the kernel and from the plain version
    against the float64 referee (``ssd_in_dtype`` under autograd, a per
    step, whose gradient gives each term dt_k dda_k of a head's sum): per
    version the max |error|, the max element-by-element scaled error
    |error| / (1 + |da|) and the max over heads of |error| / (1 + sum
    |terms|); with the smallest and largest |da| and the largest sum
    |terms|."""
    x, dt, a, bm, cm = (t.detach().double() for t in inputs)
    b, l, h, _ = x.shape
    a_steps = a.expand(b, l, h).clone().requires_grad_()
    y, st = ssd_in_dtype(x, dt, a_steps, bm, cm,
                         chunk=max(q for q in range(1, 65) if l % q == 0),
                         initial_state=None if s0 is None else s0.double())
    terms, = torch.autograd.grad((y, st), a_steps, (dy.double(), dstate.double()))
    da = terms.sum((0, 1))
    scale = terms.abs().sum((0, 1))
    out = {"min_abs_da": da.abs().min().item(), "max_abs_da": da.abs().max().item(),
           "max_sum_abs_terms": scale.max().item()}
    for name, got in (("kernel", kernel_da), ("plain", plain_da)):
        err = (got.double() - da).abs()
        out[name] = {"max_abs_err": err.max().item(),
                     "elementwise_scaled": (err / (1 + da.abs())).max().item(),
                     "terms_scaled": (err / (1 + scale)).max().item()}
    return out


def _plain_ssd(x, dt, a, b, c, *, chunk=None, initial_state=None):
    """The SSD kernel's plain version ``ssd_ref`` under autograd, as the model
    calls the kernel's wrapper (B/C in groups, an initial state)."""
    from repro_torch.kernels.ref import ssd_ref

    return ssd_ref(x, dt, a, b, c, initial_state)


@contextlib.contextmanager
def plain_attention(fn=None, ssd=None):
    """The model's attention through ``fn`` (default: autograd of the plain
    version ``flash_attention_ref``) and its SSD scan through ``ssd``
    (default: autograd of ``ssd_ref``) in place of the kernels."""
    import repro_torch.models.layers as layers
    import repro_torch.models.ssm as ssm
    from repro_torch.kernels.ref import flash_attention_ref

    kernel, ssd_kernel = layers.flash_attention, ssm.ssd_scan_kernel
    layers.flash_attention = fn or (lambda q, k, v, *, causal=True, window=0:
                                    flash_attention_ref(q, k, v, causal=causal, window=window))
    ssm.ssd_scan_kernel = ssd or _plain_ssd
    try:
        yield
    finally:
        layers.flash_attention, ssm.ssd_scan_kernel = kernel, ssd_kernel


def _leaf_paths(tree, path=""):
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _leaf_paths(val, f"{path}/{key}")
    elif isinstance(tree, list):
        for i, val in enumerate(tree):
            yield from _leaf_paths(val, f"{path}/{i}")
    else:
        yield path, tree


def train_launches(cfg, microbatches: int = 1) -> dict[str, int]:
    """Kernel launches of one remat train step: per microbatch each
    attention layer's flash forward twice (remat recomputes it) and its
    backward once, each SSD layer's scan alike; deepseek-v3's MTP block is
    not rematerialised: one forward and one backward."""
    layers = expected_launches(cfg)
    attn, ssd, mtp = layers["flash_attention"], layers["ssd_scan"], int(bool(cfg.mtp))
    return {"flash_attention": microbatches * (2 * attn + mtp),
            "flash_attention_bwd": microbatches * (attn + mtp),
            "ssd_scan": microbatches * 2 * ssd, "ssd_scan_bwd": microbatches * ssd}


# train_grad_check's cases, at full width, at the depth at which the
# float64 referee fits on the card beside the bf16 weights: (cut, B, S).
# granite and mamba2 two layers (mamba2 over 512 steps, four of its
# 128-step chunks: its plain path, ssd_ref under autograd, steps one by
# one on the host); recurrentgemma one unit (2 RG-LRU + 1
# windowed layer, 1.71 B parameters) over 2560 tokens, past its 2048
# window so the mask bites in the backward; seamless two encoder and two
# decoder layers (0.60 B); deepseek-v3 one dense MLA layer with the MTP
# block (3.12 B: 25 GB of float64 weights and 25 GB of gradients) at B 1,
# S 512, its referee's gradients held on the host (GRAD_CHECK_OFFLOAD)
# while its fp32 runs hold theirs on the card
GRAD_CHECK = {"granite_3_2b": ({"n_layers": 2}, 2, 1024),
              "mamba2_780m": ({"n_layers": 2}, 2, 512),
              "recurrentgemma_9b": ({"n_layers": 3}, 1, 2560),
              "seamless_m4t_medium": ({"n_layers": 2, "encoder_layers": 2}, 2, 1024),
              "deepseek_v3_671b": ({"n_layers": 1, "first_k_dense": 1}, 1, 512)}
GRAD_CHECK_OFFLOAD = ("deepseek_v3_671b",)


def phase_train_grad_check(seed: int) -> dict[str, dict[str, int]]:
    """For each GRAD_CHECK case at full width: loss_fn and every parameter
    gradient with attention and the SSD scan on the kernels (both
    directions) and through their plain versions, in fp32 and in bf16
    compute, each held to the same loss_fn in float64 (GRAD_CHECK_TOL says
    how), at the reference's init and at a well-conditioned one.  Returns
    each case's kernel launches of one bf16 run."""
    from repro_torch.configs import get_config
    from repro_torch.data import batch_for
    from repro_torch.distributed.step import batch_to
    from repro_torch.models import materialize, param_defs

    launches = {}
    for arch, (cut, b, s) in GRAD_CHECK.items():
        torch.cuda.reset_peak_memory_stats()
        base = get_config(arch).scaled(**cut)
        batch = batch_to(batch_for(base, b, s, 0, seed=seed), torch.device("cuda"))
        params = materialize(param_defs(base), seed, "cuda")
        _grad_check_init("reference", params, batch, base, arch in GRAD_CHECK_OFFLOAD)
        # (L, d_in, d_out) leaves drawn at 1 / sqrt(L): rescaled to 1 / sqrt(d_in)
        params = _fan_in_per_layer(params, base)
        launches[f"{arch} train_grad_check"] = _grad_check_init(
            "fan_in_per_layer", params, batch, base, arch in GRAD_CHECK_OFFLOAD)
        del params, batch
        check(release() < 1.0, f"train_grad_check {arch}: memory left allocated")
    return launches


def _grad_check_init(init: str, params_bf, batch, base, offload: bool,
                     dtypes: tuple[str, ...] = ("float32", "bfloat16")) -> dict[str, int]:
    from repro_torch.distributed.step import loss_and_grads
    from repro_torch.models.spec import tree_map

    def rel_l2(a, r) -> float:
        return ((a.double() - r.double()).norm() / r.double().norm()).item()

    def errors(g_k, g_p, g64) -> tuple[dict, dict, dict]:
        """Each leaf's relative L2 error, kernel and plain path against the
        referee and against each other; a referee leaf on the host is moved
        to the card once."""
        err_k, err_p, k_vs_p = {}, {}, {}
        for (path, k), (_, p), (_, r) in zip(_leaf_paths(g_k), _leaf_paths(g_p),
                                             _leaf_paths(g64)):
            r = r.to(k.device)
            err_k[path], err_p[path], k_vs_p[path] = rel_l2(k, r), rel_l2(p, r), rel_l2(k, p)
        return err_k, err_p, k_vs_p

    def loss_err(a, r) -> float:
        return abs(a.item() - r.item()) / (1 + abs(r.item()))

    key = "embeds" if base.input_kind == "embeds" else "inputs"
    b, s = batch[key].shape[:2]
    t0 = time.perf_counter()
    with plain_attention(attention_in_dtype, ssd_in_dtype):
        params64 = tree_map(lambda t: t.double(), params_bf)
        loss64, _, g64 = loss_and_grads(params64, batch, base.scaled(compute_dtype="float64"))
        del params64
    if offload:   # the referee's gradients on the host, compared leaf by leaf on the card
        g64 = tree_map(lambda t: t.cpu(), g64)
        torch.cuda.empty_cache()
    kernel_launches, f32_launches = {}, {}
    for compute in dtypes:
        cfg = base.scaled(compute_dtype=compute)
        params = params_bf if compute == "bfloat16" else tree_map(
            lambda t: t.to(getattr(torch, compute)), params_bf)
        before = route_counts()
        zero_counts()
        loss_k, _, g_k = loss_and_grads(params, batch, cfg)
        torch.cuda.synchronize()
        kernel_launches = launch_counts()
        # the run's launches on the routes (counted on from the caller's)
        routes = {n: c - before[n] for n, c in route_counts().items() if c != before[n]}
        if compute == "float32":
            f32_launches = {n: routes.get(n, 0) for n in ("flash_fwd_f32", "flash_bwd_f32")}
        with plain_attention():
            zero_counts()
            loss_p, _, g_p = loss_and_grads(params, batch, cfg)
            torch.cuda.synchronize()
            plain_launches = launch_counts()
        err_k, err_p, k_vs_p = errors(g_k, g_p, g64)
        tol = GRAD_CHECK_TOL[compute]
        limit = {leaf: max(tol["grad"], 2 * err_p[leaf]) for leaf in err_k}
        worst = max(err_k, key=lambda leaf: err_k[leaf] / limit[leaf])
        lk, lp = loss_err(loss_k, loss64), loss_err(loss_p, loss64)
        loss_limit = max(tol["loss"], 2 * lp)
        finite = bool(torch.isfinite(loss_k)) and all(
            bool(torch.isfinite(g).all()) for _, g in _leaf_paths(g_k))
        want = train_launches(cfg)
        what = f"train_grad_check {cfg.name} {init} {compute}"
        emit("train_grad_check", config=cfg.name, init=init, layers=cfg.n_layers,
             encoder_layers=cfg.encoder_layers, batch=b, seq=s, compute=compute, remat=True,
             referee_on_host=offload, loss_kernel=loss_k.item(),
             loss_plain=loss_p.item(), loss_f64=loss64.item(), loss_err_kernel=lk,
             loss_err_plain=lp, loss_limit=loss_limit, worst_leaf=worst,
             worst_leaf_err_kernel=err_k[worst], worst_leaf_err_plain=err_p[worst],
             worst_leaf_limit=limit[worst], rel_l2_kernel_vs_f64=err_k,
             rel_l2_plain_vs_f64=err_p, rel_l2_kernel_vs_plain=k_vs_p, tol=tol, finite=finite,
             kernel_launches=kernel_launches, plain_launches=plain_launches,
             route_launches=routes, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             seconds=time.perf_counter() - t0)
        check(finite, f"{what}: a loss or gradient is not finite")
        check(kernel_launches == want, f"{what}: kernel launches {kernel_launches}, "
              f"expected {want}")
        check(not any(plain_launches.values()), f"{what}: the plain run launched "
              f"{plain_launches}")
        if compute == "float32":   # fp32 on the register-tiled kernels, both directions
            check(f32_launches == {"flash_fwd_f32": kernel_launches["flash_attention"],
                                   "flash_bwd_f32": kernel_launches["flash_attention_bwd"]},
                  f"{what}: {f32_launches} of {kernel_launches} on the fp32 kernels")
        check(lk <= loss_limit, f"{what}: loss {loss_k.item()} is {lk} from the float64 "
              f"loss {loss64.item()}, limit {loss_limit}")
        check(err_k[worst] <= limit[worst], f"{what}: gradient {worst} is {err_k[worst]} from "
              f"float64 (the plain path {err_p[worst]}), limit {limit[worst]}")
        del params, g_k, g_p
    del g64
    # the last run's kernel launches, and the fp32 run's on the fp32 kernels
    return {**kernel_launches, **f32_launches}


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
    want = train_launches(cfg)
    # the counter's peak of what the step allocates, beside the allocator's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, cost = count_step(step, params, opt_state, batch)
    peaks = {"counted_gb": cost.peak_bytes / 1e9,
             "allocator_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
    ROOFLINE_RUNS["granite_3_2b train_step"] = dict(
        cfg=cfg, cost=cost, ms=ms, kind="train",
        batch=b, seq=s, tokens=b * s, expected=want, peak_gb=peak_gb,
        per_launch=train_per_launch(cfg, b, s))
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


# train_all: the nine architectures other than granite (whose full-depth
# step is train_step's), each at full width and cut in depth only, to the
# deepest whole unit of its layer pattern whose step peaks under
# MAX_PEAK_GB.  The step's peak is its optimizer update: AdamW builds the
# new weights and moments while the old are held, beside the accumulated
# gradient, so a parameter costs 2 (2 + 8) + 4 = 24 bytes with the
# reference's fp32 moments and accumulation (granite: 2.53 B, 61.2 GB
# measured) and 2 (2 + 4) + 2 = 14 with its bf16 ones; the largest leaf
# adds ~8 bytes a parameter of fp32 temporaries (a first full run on an
# H100 ran out of memory in that update with minitron at 16 layers, 3.33
# B: 80 GB reckoned).  From the port's param_defs, with activations of a
# few GB under remat: minitron-4b 6 of 32 layers (2.23 B, 54 GB + 6 GB
# for its 0.79 B embedding); olmoe-1b-7b 5 of 16 (2.30 B, 55 + 5 GB);
# recurrentgemma-9b 6 of 38, two units of 2 RG-LRU + 1 windowed (2.36 B,
# 57 + 8 GB); llava-next-34b 5 of 60 (3.71 B at 14 bytes, 52 + 12 GB);
# deepseek-67b 3 of 95 (3.75 B, 53 + 13 GB); deepseek-v3-671b 2 of its 3
# dense layers with the MTP block (3.71 B, 52 + 15 GB).  gemma3-27b: one
# whole 5:1 unit is 3.89 B, 93 GB, so no whole unit fits; it trains its
# first 2 (windowed) layers (2.23 B, 54 + 11 GB), and its global layer's
# attention (D 128, no window) trains in olmoe's, llava's and
# deepseek-67b's steps.  No deepseek-v3 MoE layer trains on one card: one
# is 11.3 B parameters.  mamba2-780m (0.78 B, 20.6 GB measured) and
# seamless-m4t-medium (0.98 B) run whole
TRAIN_ARCHS = ("mamba2_780m", "minitron_4b", "olmoe_1b_7b", "seamless_m4t_medium",
               "recurrentgemma_9b", "gemma3_27b", "llava_next_34b", "deepseek_67b",
               "deepseek_v3_671b")
TRAIN_DEPTH = {"minitron_4b": {"n_layers": 6}, "olmoe_1b_7b": {"n_layers": 5},
               "recurrentgemma_9b": {"n_layers": 6}, "gemma3_27b": {"n_layers": 2},
               "llava_next_34b": {"n_layers": 5}, "deepseek_67b": {"n_layers": 3},
               "deepseek_v3_671b": {"n_layers": 2, "first_k_dense": 2}}
# B 4, S 1024; the windowed models 2560, past their windows (as PROMPT)
TRAIN_BATCH = 4
TRAIN_SEQ = {"recurrentgemma_9b": 2560, "gemma3_27b": 2560}
# the train steps the roofline phase also reads: the SSD backward's and the
# MLA backward's (q/k 192, v 128) credits, beside granite's
ROOFLINE_TRAIN = ("mamba2_780m", "deepseek_v3_671b")


def train_per_launch(cfg, mb_batch: int, s: int) -> dict[str, float]:
    """The FLOPs roofline/cost.py credits each kernel launch of a bf16 train
    step of ``cfg`` with, at a microbatch of ``mb_batch`` sequences."""
    from repro_torch.kernels.ssd_scan import BWD_TILES, kernel_chunk
    from repro_torch.roofline.cost import (attention_bound, attention_bwd_bound, ssd_bound,
                                           ssd_bwd_bound)

    bf = "torch.bfloat16"
    if cfg.ssm:
        h, p, n = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim, cfg.ssm.d_state
        q = kernel_chunk(min(cfg.ssm.chunk, s), torch.bfloat16, p, n)
        return {"ssd_scan": ssd_bound(mb_batch, s, h, p, n, q, bf, bf)[2],
                "ssd_scan_bwd": ssd_bwd_bound(mb_batch, s, h, p, n, bf, bf,
                                              tile=BWD_TILES[(p, n)])[2]}
    if cfg.mla:
        d, dv, kv = cfg.mla.qk_head_dim, cfg.mla.v_head_dim, cfg.n_heads
    else:
        d = dv = cfg.resolved_head_dim
        kv = cfg.n_kv_heads
    return {"flash_attention": attention_bound(mb_batch, s, s, cfg.n_heads, kv, d, dv, bf, True,
                                               0)[2],
            "flash_attention_bwd": attention_bwd_bound(mb_batch, s, cfg.n_heads, kv, d, bf, True,
                                                       0, dv=dv)[2]}


def phase_train_all(seed: int) -> dict[str, dict[str, int]]:
    """Each TRAIN_ARCHS model through build_train_step at full width, cut to
    TRAIN_DEPTH: bf16, remat, the reference's step tuning
    (``launch/dryrun.py:TRAIN_TUNING``: microbatches, accumulation and
    moment dtypes; the microbatches capped at the batch of 4); one warm-up
    step, then three timed steps on one batch.  Returns each model's
    launches of one step."""
    from repro_torch.configs import get_config
    from repro_torch.data import batch_for
    from repro_torch.distributed.step import batch_to, build_train_step
    from repro_torch.launch.dryrun import step_tuning
    from repro_torch.models import materialize, param_defs
    from repro_torch.optim import init_opt_state
    from repro_torch.roofline import count_step

    out = {}
    for arch in TRAIN_ARCHS:
        t_arch = time.perf_counter()
        cfg = get_config(arch).scaled(**TRAIN_DEPTH.get(arch, {}))
        step_cfg, opt_cfg = step_tuning(cfg)
        step_cfg = dataclasses.replace(step_cfg, microbatches=min(step_cfg.microbatches,
                                                                  TRAIN_BATCH))
        # the default 100 warm-up steps keep lr ~0
        opt_cfg = dataclasses.replace(opt_cfg, lr=1e-3, warmup_steps=1)
        b, s = TRAIN_BATCH, TRAIN_SEQ.get(arch, 1024)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = materialize(param_defs(cfg), seed, "cuda")
        opt_state = init_opt_state(params, opt_cfg)
        step = build_train_step(cfg, opt_cfg, step_cfg)
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
                          "grad_norm": m["grad_norm"].item(), "launches": launch_counts(),
                          "ws_launches": ws_launches()})
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prof = device_profile(lambda: step(params, opt_state, batch))
        ms = statistics.median(x["ms"] for x in steps)
        want = train_launches(cfg, step_cfg.microbatches)
        if arch in ROOFLINE_TRAIN:   # counted once, read in the roofline phase
            cost = count_step(step, params, opt_state, batch)[1]
            ROOFLINE_RUNS[f"{arch} train_step"] = dict(
                cfg=cfg, cost=cost, ms=ms, kind="train", batch=b, seq=s, tokens=b * s,
                expected=want, peak_gb=peak_gb,
                per_launch=train_per_launch(cfg, b // step_cfg.microbatches, s))
        emit("train_all", config=cfg.name, layers=cfg.n_layers,
             encoder_layers=cfg.encoder_layers, cut=TRAIN_DEPTH.get(arch),
             params_b=sum(t.numel() for _, t in _leaf_paths(params)) / 1e9, batch=b, seq=s,
             remat=True, dtype="bfloat16", microbatches=step_cfg.microbatches,
             accum_dtype=step_cfg.accum_dtype, moment_dtype=opt_cfg.moment_dtype,
             warmup_step_ms=warmup_ms, step_ms=ms, tokens_per_s=b * s / ms * 1e3, steps=steps,
             peak_mem_gb=peak_gb, expected_launches=want, device_profile=prof,
             phase_s=time.perf_counter() - t_arch)
        what = f"train_all {cfg.name}"
        check(all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"]) for x in steps),
              f"{what}: a loss or grad_norm is not finite")
        check(steps[2]["loss"] < steps[0]["loss"],
              f"{what}: loss did not fall: {[x['loss'] for x in steps]}")
        check(all(x["launches"] == want for x in steps),
              f"{what}: launches {[x['launches'] for x in steps]}, expected {want} a step")
        check(peak_gb <= MAX_PEAK_GB, f"{what}: peak {peak_gb} GB over {MAX_PEAK_GB}")
        if cfg.mla is not None:   # bf16 at q/k 192, v 128: the MLA kernel's forwards
            check(all(x["ws_launches"] > 0 for x in steps),
                  f"{what}: the MLA kernel launched {[x['ws_launches'] for x in steps]}")
        out[f"{arch} train_all (one step)"] = {**steps[-1]["launches"],
                                               "flash_fwd_bf16_ws": steps[-1]["ws_launches"]}
        del params, opt_state, batch, step, m
        check(release() < 1.0, f"{what}: memory left allocated")
    return out


@contextlib.contextmanager
def cli_reports():
    """The report of each ``WrathTrainSupervisor.run`` the training CLI
    makes, in order: its JSON carries only the first and last losses."""
    import repro_torch.launch.train as cli

    reports, base = [], cli.WrathTrainSupervisor

    class Recording(base):
        def run(self, *args, **kwargs):
            reports.append(super().run(*args, **kwargs))
            return reports[-1]

    cli.WrathTrainSupervisor = Recording
    try:
        yield reports
    finally:
        cli.WrathTrainSupervisor = base


def phase_train_cli() -> dict[str, dict[str, int]]:
    """The training CLI (``python -m repro_torch.launch.train``) on the
    card at its defaults, in process through ``main(argv)``: each
    architecture's smoke config, 8 steps through a host loss at step 3,
    each from a fresh checkpoint directory.  Gates: 8 steps, finite
    losses, the recoveries the CPU test pins, launches of each kernel the
    architecture uses and no other.  Returns each run's launches."""
    import io

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import main

    out, faults = {}, []
    ckpt = ROOT / "build" / "chip_smoke_cli_ckpt"
    for arch in ARCHS:
        name = arch.replace("_", "-")
        shutil.rmtree(ckpt, ignore_errors=True)
        zero_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), cli_reports() as reports:
            main(["--arch", name, "--steps", "8", "--inject", "host_down:3:host01", "--json",
                  "--ckpt-dir", str(ckpt)])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
        rep = json.loads(buf.getvalue())
        mixers = {m for m, _ in get_smoke_config(arch).block_kinds()}
        uses = []
        if mixers & {"attn", "swa", "mla"}:
            uses += ["flash_attention", "flash_attention_bwd"]
        if "ssd" in mixers:
            uses += ["ssd_scan", "ssd_scan_bwd"]
        # a reading, not a gate: each step draws a new batch, and a smoke
        # model's loss moves from batch to batch by about as much as it
        # falls in 8 steps at the CLI's defaults.  seamless-m4t-medium's,
        # from the card's weight draw, read 5.995 -> 6.017 as means of the
        # first and last three steps; from the CPU's draw 6.011 -> 5.984 on
        # the card and 6.047 -> 6.005 on the CPU (NVIDIA H100 80GB HBM3,
        # 700.00 W).  The loss falls as a gate in train_all, on one batch
        losses = reports[0].losses
        first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
        emit("train_cli", arch=name, steps=rep["steps"], loss_first=rep["loss_first"],
             loss_last=rep["loss_last"], losses=losses, loss_first3=first, loss_last3=last,
             restores=rep["restores"], recoveries=rep["recoveries"],
             denylisted=rep["denylisted"], wall_s=wall_s, launches=launches,
             kernels_used=uses)
        what = f"train_cli {name}"
        faults += [f"{what}: {fault}" for ok, fault in (
            (rep["steps"] == 8, f"{rep['steps']} steps completed, expected 8"),
            (all(math.isfinite(x) for x in losses), f"losses {losses}"),
            # tests/test_torch_train.py::test_train_cli_on_cpu pins these for the same arguments
            (rep["restores"] == 0 and rep["recoveries"] == [],
             f"restores {rep['restores']}, recoveries {rep['recoveries']}"),
            (all(launches[k] > 0 for k in uses)
             and not any(v for k, v in launches.items() if k not in uses),
             f"launches {launches}, expected launches of {uses} only")) if not ok]
        out[f"{arch} train_cli"] = launches
    shutil.rmtree(ckpt, ignore_errors=True)
    check(not faults, "; ".join(faults))
    return out


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
                "ssd_scan": 0, "ssd_scan_bwd": 0}
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
    ssd_bwd_cases = phase_ssd_bwd_cases(args.seed)
    seconds["kernels_vs_plain"] = time.perf_counter() - t0
    # B/C groups and an initial state: the kernels, then mamba2 at G 8;
    # the model case's counts are zeroed just before each run, read after
    path_launches = {}
    t0 = time.perf_counter()
    group_cases, group_launches = phase_ssd_groups(args.seed, ssd_cases, ssd_bwd_cases)
    path_launches.update(group_launches)
    seconds["ssd_groups"] = time.perf_counter() - t0
    # every route off the ten configs' shapes: small cases, public models'
    # full-width shapes, two scaled configs (their counts zeroed just before)
    t0 = time.perf_counter()
    shape_rows, shape_launches = phase_shapes(args.seed)
    path_launches.update(shape_launches)
    seconds["shapes"] = time.perf_counter() - t0

    # -- 4. prefill + decode at full width and depth, 5. serve, per path -----
    # each path's counts are zeroed just before its run and read just after
    resident = {}
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
    path_launches.update(phase_train_grad_check(args.seed))
    seconds["train_grad_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_launches["granite_3_2b train_step (one step)"] = phase_train_step(args.seed)
    seconds["train_step"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_launches["granite_3_2b train_supervisor"] = phase_train_supervisor(args.seed)
    seconds["train_supervisor"] = time.perf_counter() - t0
    # the nine other architectures' train steps (the training CLI comes last)
    t0 = time.perf_counter()
    path_launches.update(phase_train_all(args.seed))
    seconds["train_all"] = time.perf_counter() - t0

    # -- 7. the WRATH engine and the TaPS apps (fedlearn, moldesign on the card)
    t0 = time.perf_counter()
    path_launches["wrath_apps (fedlearn, moldesign, mapreduce)"] = phase_wrath_apps(args.seed)
    seconds["wrath_apps"] = time.perf_counter() - t0

    # -- 8. the WRATH engine on the virtual clock, fedlearn on the card ------
    t0 = time.perf_counter()
    path_launches["wrath_sim (fedlearn under SimHarness)"] = phase_wrath_sim(args.seed)
    seconds["wrath_sim"] = time.perf_counter() - t0

    # -- 9. the autotuner (a fresh cache), 10. the roofline of six paths -----
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

    # -- 12. the training CLI on the card, every architecture ---------------
    t0 = time.perf_counter()
    path_launches.update(phase_train_cli())
    seconds["train_cli"] = time.perf_counter() - t0

    # -- 13. the port's examples on the card (serving, resilient training) --
    t0 = time.perf_counter()
    path_launches.update(phase_examples())
    seconds["examples"] = time.perf_counter() - t0
    emit("timing", seconds=seconds, resident_gb_after=resident)

    # -- 14. the kernel table -----------------------------------------------
    rows = [("flash_attention", flash_cases, "granite_prefill",
             "src/repro_torch/kernels/csrc/flash_attention.cu"),
            ("flash_attention_bwd", bwd_cases, "granite_train",
             "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"),
            ("ssd_scan", ssd_cases, "mamba2_prefill", "src/repro_torch/kernels/csrc/ssd_scan.cu"),
            ("ssd_scan_bwd", ssd_bwd_cases, "mamba2_train",
             "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu")]
    # a gradient replaces the gradient of the Pallas kernel's function,
    # which the Pallas kernel does not have
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:82",
                "flash_attention_bwd": "src/repro/kernels/flash_attention.py:82",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:80",
                "ssd_scan_bwd": "src/repro/kernels/ssd_scan.py:80"}
    table = []
    for name, cases, case, source in rows:
        c = next(c for c in cases if c["case"] == case)
        by_path = {path: counts.get(name, 0) for path, counts in path_launches.items()}
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
    # the MLA forward kernel (bf16 at q/k 192, v 128) has a row of its own:
    # its launches are a share of flash_attention's
    by_path = {path: counts.get("flash_fwd_bf16_ws", 0) for path, counts in path_launches.items()}
    mla_rows = {c["case"]: {k: c[k] for k in ("ms", "bound_ms", "bound_frac", "library_ms",
                                               "vs_library", "max_scaled_err", "kernels")}
                for c in flash_cases if c.get("ws")}
    table.append({"name": "flash_fwd_bf16_ws", "route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/flash_attention_fwd_ws.cu",
                  "replaces": replaces["flash_attention"], "launches": sum(by_path.values()),
                  "launches_by_path": {p: n for p, n in by_path.items() if n},
                  "max_abs_err": mla["max_abs_err"], "max_scaled_err": mla["max_scaled_err"],
                  "tol": mla["tol"], "ms": mla["ms"], "plain_ms": mla["plain_ms"],
                  "bound_ms": mla["bound_ms"], "bound_by": mla["bound_by"],
                  "bound_frac": mla["bound_frac"], "library_ms": mla["library_ms"],
                  "vs_library": mla["vs_library"], "cases": mla_rows})
    check(table[-1]["launches"] > 0, "the MLA forward kernel ran on no main path")
    # the backward's head dims, each the launcher takes, with its D 256
    # (recurrentgemma-9b) and (192, 128) (deepseek-v3's MLA) readings
    from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS
    bwd_dims = sorted({(c["shape"][4], c["dv"]) for c in bwd_cases})
    check(bwd_dims == sorted(BWD_HEAD_DIMS),
          f"flash backward cases ran head dims {bwd_dims}, the launcher takes "
          f"{sorted(BWD_HEAD_DIMS)}")
    table[1]["head_dims"] = [list(d) for d in bwd_dims]
    for key, case in (("d256", "recurrentgemma_train"), ("dk192_dv128", "mla_train")):
        c = next(c for c in bwd_cases if c["case"] == case)
        table[1][key] = {k: c[k] for k in (
            "case", "shape", "dv", "window", "max_abs_err", "max_scaled_err", "tol", "ms",
            "device_ms", "kernel_device_ms", "dq_bound_ms", "dq_bound_by", "dq_bound_frac",
            "shares", "b1", "plain_ms", "bound_ms", "bound_by", "bound_frac", "library_ms",
            "library_device_ms", "vs_library", "library_refused")}
    # the SSD rows at B/C groups and from an initial state, the G 1 row beside
    for row, key in ((table[2], ""), (table[3], "bwd_")):
        row["groups"] = {c["case"]: {k.removeprefix(key): c[k] for k in (
            f"{key}ms", f"{key}bound_ms", f"{key}bound_by", f"{key}bound_frac")}
            | {"max_scaled_err": c["max_scaled_err"], "groups": c["groups"],
               "initial_state": c["initial_state"]}
            for c in group_cases}
        row["groups_g1"] = group_cases[0]["g1"]
    # the padded, the fp16 wgmma, the staged, the general (SSD) and the
    # fp32 routes (kernels/*.py:route), each with its readings at a public
    # model's full-width shape (the staged rows beside the bf16 twin, with
    # the staging kernel's share of the device ms)
    csrc = "src/repro_torch/kernels/csrc/"
    f16_names = {"forward": set(), "backward": set()}
    for part, rows_ in (("forward", flash_cases), ("backward", bwd_cases)):
        for c in rows_:
            f16_names[part].update(n for n in c.get("kernels", ()) if "HalfWidths" in n)
    for c in shape_rows.values():
        for part in f16_names:
            f16_names[part].update(n for n in c[part].get("kernels", ()) if "HalfWidths" in n)
    f16_names = {part: sorted(names) for part, names in f16_names.items()}
    for name, source, case, part, also in (
            ("flash_fwd_bf16_pad", "flash_attention_pad.cu", "phi2_d80", "forward",
             "phi3_mini_d96"),
            ("flash_bwd_bf16_pad", "flash_attention_bwd_pad.cu", "phi2_d80", "backward",
             "phi3_mini_d96"),
            ("flash_fwd_f16", "flash_attention_f16.cu", "phi2_d80_fp16", "forward", "phi2_d80"),
            ("flash_bwd_f16", "flash_attention_bwd_f16.cu", "phi2_d80_fp16", "backward",
             "phi2_d80"),
            ("flash_fwd_stage", "flash_attention_stage.cu", "d20_fp16", "forward",
             "d20_bf16"),
            ("flash_fwd_f32", "flash_attention_fwd_f32.cu", "phi2_d80_fp32", "forward", None),
            ("flash_bwd_stage", "flash_attention_stage.cu", "d20_fp16", "backward",
             "d20_bf16"),
            ("flash_bwd_f32", "flash_attention_bwd_f32.cu", "phi2_d80_fp32", "backward", None),
            ("ssd_fwd_bf16_pad", "ssd_scan_pad.cu", "zamba2_p64_n64", "forward", None),
            ("ssd_bwd_bf16_pad", "ssd_scan_bwd_pad.cu", "zamba2_p64_n64", "backward", None),
            ("ssd_fwd_any", "ssd_scan_any.cu", "zamba2_p64_n64_fp16", "forward", None),
            ("ssd_bwd_any", "ssd_scan_any.cu", "zamba2_p64_n64_fp16", "backward", None)):
        c = shape_rows[case][part]
        by_path = {path: counts.get(name, 0) for path, counts in path_launches.items()}
        err = c["max_scaled_err"]
        row = {"name": name, "route": "cuda", "source": csrc + source,
               "replaces": replaces["flash_attention" if "flash" in name else "ssd_scan"],
               "launches": sum(by_path.values()),
               "launches_by_path": {p: k for p, k in by_path.items() if k},
               "case": case, "shape": shape_rows[case]["shape"],
               "dtype": shape_rows[case]["dtype"], "max_abs_err": c["max_abs_err"],
               "max_scaled_err": max(err.values()) if isinstance(err, dict) else err,
               "tol": c["tol"], "ms": c["ms"], "device_ms": c["device_ms"],
               "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
               "bound_by": c["bound_by"], "bound_frac": c["bound_frac"],
               "library_ms": c["library_ms"], "vs_library": c.get("vs_library")}
        if also:
            row[also] = {k: shape_rows[also][part][k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "bound_frac",
                "library_ms", "vs_library", "max_scaled_err")}
        if "_stage" in name:   # the bucket's kernels and the staging kernel's device ms
            row["kernels"] = c["kernels"]
            row["stage_device_ms"] = c["stage_device_ms"]
            row[also]["stage_device_ms"] = shape_rows[also][part]["stage_device_ms"]
        if name.endswith("_f16"):   # the fp16 instantiations the run's fp16 rows launched
            row["instantiations"] = f16_names[part]
        if name == "flash_fwd_f32":   # the kernel, and every fp32 forward case's readings
            row["kernels"] = c["kernels"]
            row["cases"] = {x["case"]: {k: x.get(k) for k in (
                "shape", "dv", "sk", "window", "ms", "device_ms", "bound_ms", "bound_frac",
                "device_bound_frac", "library_ms", "vs_library", "max_scaled_err",
                "lse_max_abs_err", "kernels")}
                for x in flash_cases if x["dtype"] == "torch.float32"}
        if name == "flash_bwd_f32":   # the kernels, and every fp32 backward case's readings
            row["kernels"] = c["kernels"]
            row["kernel_device_ms"] = c["kernel_device_ms"]
            row["cases"] = {x["case"]: {k: x.get(k) for k in (
                "shape", "dv", "window", "ms", "device_ms", "kernel_device_ms", "shares",
                "bound_ms", "bound_frac", "device_bound_frac", "dq_bound_ms", "dq_bound_frac",
                "library_ms", "library_device_ms", "vs_library", "max_scaled_err", "kernels")}
                for x in bwd_cases if x["dtype"] == "torch.float32"}
        table.append(row)
        check(row["launches"] > 0, f"the {name} route ran on no main path")
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
