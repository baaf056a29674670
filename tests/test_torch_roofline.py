"""The port's roofline plane (``repro_torch.roofline``) against the JAX
package's (``repro.roofline``): the same parameter counts and model FLOPs
for all ten configs, the same report on the same raw numbers, and the
eager counter's FLOPs, bytes, collectives and kernel credits."""
from __future__ import annotations

import math

import pytest
import torch
import torch.distributed as dist

import repro.roofline.analysis as jax_analysis
from repro.configs import get_config as jax_config
from repro.models import param_defs as jax_param_defs
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import mesh
from repro_torch.models import materialize, param_defs
from repro_torch.roofline import (RooflineReport, active_param_count, analyze, count_step,
                                  counting, mfu, model_flops)
from repro_torch.roofline.cost import (attention_bound, attention_bwd_bound, kernel_cost,
                                       ssd_bound, ssd_bwd_bound, visible_pairs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_match_reference(arch):
    """Full-size configs: total and active parameters (routed experts at
    top_k / E) and 6·N·D / 2·N·D, for train and serve."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    defs, jdefs = param_defs(cfg), jax_param_defs(jcfg)
    assert active_param_count(cfg, defs) == jax_analysis.active_param_count(jcfg, jdefs)
    for kind, tokens in (("train", 4 * 1024), ("serve", 4 * 1024), ("serve", 4)):
        assert model_flops(cfg, defs, kind=kind, tokens=tokens) == jax_analysis.model_flops(
            jcfg, jdefs, kind=kind, tokens=tokens)


def test_granite_train_step_model_flops():
    """granite-3-2b: 2.534e9 parameters (tied embedding included); a B 4,
    S 1024 train step is 6 N D = 6.23e13 FLOPs, 63 ms at the bf16 peak."""
    cfg = get_config("granite_3_2b")
    total, active = active_param_count(cfg, param_defs(cfg))
    assert total == active == 2533531648
    mf = model_flops(cfg, param_defs(cfg), kind="train", tokens=4096)
    assert mf == pytest.approx(6.2266e13, rel=1e-4)
    assert mfu(mf, 0.544) == pytest.approx(mf / (989e12 * 0.544))


RAW = [  # hlo_flops, hlo_bytes, coll_bytes, attn_score_bytes, chips
    (6.2e13, 2.1e11, 0.0, 3.0e9, 1),       # compute-bound (a train step)
    (2.6e10, 5.1e9, 0.0, 0.0, 1),          # memory-bound (a decode step)
    (1.0e12, 1.0e9, 4.0e11, 1.0e8, 4),     # collective-bound
    (0.0, 0.0, 0.0, 0.0, 1),               # nothing counted
]


@pytest.mark.parametrize("raw", RAW)
def test_report_row_equals_reference_on_h100_constants(raw, monkeypatch):
    """The reference's RooflineReport with its TPU constants replaced by
    the port's H100 ones gives the port's row() on the same numbers."""
    monkeypatch.setattr(jax_analysis, "PEAK_FLOPS_BF16", mesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jax_analysis, "HBM_BW", mesh.HBM_BW)
    monkeypatch.setattr(jax_analysis, "ICI_BW_PER_LINK", mesh.NVLINK_BW_PER_DIRECTION)
    flops, nbytes, coll, score, chips = raw
    kw = dict(arch="granite-3-2b", shape="b4_s1024", mesh="single", chips=chips,
              hlo_flops=flops, hlo_bytes=nbytes, coll_bytes=coll,
              coll_breakdown={"all-gather": int(coll)}, model_flops=0.7 * flops,
              per_device_hbm_bytes=13.1e9, hlo_bytes_raw=nbytes, attn_score_bytes=score,
              xla_reported_flops=flops, xla_reported_bytes=nbytes)
    ours, ref = RooflineReport(**kw), jax_analysis.RooflineReport(**kw)
    assert ours.row() == ref.row()
    assert ours.dominant == ref.dominant and ours.useful_ratio == ref.useful_ratio


def _linear_stack(widths, batch=32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    ws = [torch.randn(a, b, generator=gen) for a, b in zip(widths, widths[1:])]
    x = torch.randn(batch, widths[0], generator=gen)

    def run():
        h = x
        for w in ws:
            h = h @ w
        return h
    return run, ws


def test_counter_counts_2mnk_on_a_linear_stack():
    """FLOPs of a stack of products are 2 m n k each, as FlopCounterMode
    counts them; bytes are each product's inputs and output."""
    from torch.utils.flop_counter import FlopCounterMode

    widths, m = (64, 128, 32, 96), 32
    run, _ = _linear_stack(widths, m)
    _, cost = count_step(run)
    want = sum(2 * m * k * n for k, n in zip(widths, widths[1:]))
    with FlopCounterMode(display=False) as fc:
        run()
    assert cost.flops == cost.aten_flops == want == fc.get_total_flops()
    want_bytes = sum(4 * (m * k + k * n + m * n) for k, n in zip(widths, widths[1:]))
    assert cost.bytes == want_bytes
    assert cost.coll_total == 0 and not cost.kernel_launches


@pytest.mark.parametrize("n", [1, 3, 8])
def test_counter_counts_an_n_layer_loop_n_times(n):
    """A loop over n identical layers counts n times one layer (the eager
    counterpart of the reference's while-loop trip multiplication)."""
    gen = torch.Generator().manual_seed(1)
    w = torch.randn(64, 64, generator=gen)
    x = torch.randn(16, 64, generator=gen)

    def layers(k):
        h = x
        for _ in range(k):
            h = torch.tanh(h @ w) + h
        return h
    _, one = count_step(layers, 1)
    _, many = count_step(layers, n)
    assert many.flops == n * one.flops and many.bytes == n * one.bytes


def test_counter_views_and_allocations_move_no_bytes():
    x = torch.randn(8, 16)
    _, cost = count_step(lambda: (x.view(16, 8).t().unsqueeze(0)[:, 2:], torch.empty(1 << 20)))
    assert cost.bytes == 0 and cost.flops == 0


def test_counter_counts_an_all_gather_with_its_bytes():
    """One all-gather under a 2-rank fake process group: counted once by
    CommDebugMode, its bytes the operand a rank sends."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        t = torch.randn(4, 8)
        out = torch.empty(8, 8)
        _, cost = count_step(lambda: dist.all_gather_into_tensor(out, t))
        _, reduced = count_step(lambda: dist.all_reduce(t))
    finally:
        dist.destroy_process_group()
    assert dict(cost.coll) == {"all-gather": 4 * 8 * 4}
    assert sum(cost.coll_counts.values()) == 1
    assert "allgather" in next(iter(cost.coll_counts))
    assert dict(reduced.coll) == {"all-reduce": 2 * 4 * 8 * 4}   # twice, as the reference


def test_counter_marks_score_dominated_products():
    """A product whose output or left operand is >= 75% of its bytes
    (attention scores or probabilities in the blockwise mirror) adds that
    tensor to attn_score_bytes; a decode step's large K / V cache, the
    right operand, does not."""
    q, k = torch.randn(2, 256, 8), torch.randn(2, 256, 8)
    _, cost = count_step(lambda: q @ k.transpose(1, 2))
    assert cost.attn_score_bytes == 2 * 256 * 256 * 4
    p = torch.softmax(torch.randn(2, 256, 256), -1)
    _, pv = count_step(lambda: p @ k)
    assert pv.attn_score_bytes == 2 * 256 * 256 * 4
    _, decode = count_step(lambda: q[:, :1] @ k.transpose(1, 2))
    assert decode.attn_score_bytes == 0
    _, flat = count_step(lambda: torch.randn(64, 64) @ torch.randn(64, 64))
    assert flat.attn_score_bytes == 0


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_formulas_equal_the_bound_functions(dtype):
    """A launch is credited with the FLOPs and bytes of the bound functions
    chip_smoke.py reports beside each kernel."""
    q, k, v = _meta(4, 1024, 32, 64, dtype=dtype), _meta(4, 1024, 8, 64, dtype=dtype), \
        _meta(4, 1024, 8, 64, dtype=dtype)
    name = str(dtype)
    assert kernel_cost("flash_attention", q=q, k=k, v=v, causal=True, window=0) == \
        attention_bound(4, 1024, 1024, 32, 8, 64, 64, name, True, 0)[2:]
    assert kernel_cost("flash_attention_bwd", q=q, k=k, v=v, causal=True, window=0) == \
        attention_bwd_bound(4, 1024, 32, 8, 64, name, True, 0)[2:]
    x, bm = _meta(4, 1024, 48, 64, dtype=dtype), _meta(4, 1024, 128, dtype=dtype)
    a = _meta(48, dtype=torch.float32)
    assert kernel_cost("ssd_scan", x=x, a=a, b=bm, chunk=128) == \
        ssd_bound(4, 1024, 48, 64, 128, 128, name, "torch.float32")[2:]
    assert kernel_cost("ssd_scan_bwd", x=x, a=a, b=bm) == \
        ssd_bwd_bound(4, 1024, 48, 64, 128, name, "torch.float32", tile=64)[2:]
    # MLA (q/k 192, v 128) and cross-attention (Sk != S) through the backward
    q, k, v = _meta(2, 1024, 16, 192, dtype=dtype), _meta(2, 1024, 16, 192, dtype=dtype), \
        _meta(2, 1024, 16, 128, dtype=dtype)
    assert kernel_cost("flash_attention_bwd", q=q, k=k, v=v, causal=True, window=0) == \
        attention_bwd_bound(2, 1024, 16, 16, 192, name, True, 0, dv=128)[2:]
    q, kv = _meta(2, 256, 16, 64, dtype=dtype), _meta(2, 1000, 16, 64, dtype=dtype)
    assert kernel_cost("flash_attention_bwd", q=q, k=kv, v=kv, causal=False, window=0) == \
        attention_bwd_bound(2, 256, 16, 16, 64, name, False, 0, sk=1000)[2:]


def test_backward_bounds_count_their_products_and_bytes():
    """The attention gradient: five products, three over q/k's dim (q k,
    dS k, dS^T q) and two over v's (dO v, P^T dO), on the visible pairs; q,
    o, dO, k, v and the gradients once each, and lse.  The SSD gradient at a
    64-step tile: C B^T on the causal pairs once per batch, per head 2 P + 2
    N MACs a pair, 2 P N a step, 3 P N a step past the first tile."""
    pairs = visible_pairs(1024, 1024, True, 0)
    _, by, flops, nbytes = attention_bwd_bound(2, 1024, 128, 128, 192, "torch.bfloat16", True,
                                               0, dv=128)
    assert by == "operations" and flops == 2.0 * 2 * 128 * (3 * 192 + 2 * 128) * pairs
    assert nbytes == 2 * (2 * 2 * 1024 * 128 * 320 + 2 * 2 * 1024 * 128 * 320) + 4 * 2 * 128 * 1024
    # at dv == d the formula is the former one: 10 d FLOPs a pair
    assert attention_bwd_bound(4, 1024, 32, 8, 64, "torch.bfloat16", True, 0)[2] == \
        2.0 * 4 * 32 * 5 * 64 * pairs
    _, by, flops, nbytes = ssd_bwd_bound(4, 1024, 48, 64, 128, "torch.bfloat16",
                                         "torch.bfloat16")
    tile_pairs = 16 * 64 * 65 // 2
    assert flops == 2.0 * 4 * (tile_pairs * 128 + 48 * (tile_pairs * (2 * 64 + 2 * 128)
                                                        + (2 * 1024 + 3 * 960) * 64 * 128))
    assert nbytes == 2 * (3 * 4 * 1024 * 48 * 64 + 2 * 4 * 1024 * 48 + 4 * 4 * 1024 * 128) \
        + 2 * 2 * 48
    assert by == "bytes"


@pytest.mark.parametrize("s,sk,causal,window", [
    (1024, 1024, True, 0), (1000, 1000, True, 0), (1024, 1024, True, 256), (100, 100, True, 0),
    (1024, 1024, False, 0), (256, 1024, False, 0), (256, 1000, False, 0),
    (2560, 2560, True, 2048), (2560, 2560, True, 1024), (300, 100, True, 0)])
def test_visible_pairs_equal_the_loop(s, sk, causal, window):
    """The vectorised pair count equals chip_smoke.py's former loop over
    queries on the kernel cases' shapes (integers: exactly)."""
    pairs = 0
    for q in range(s):
        lo = max(0, q - window + 1) if window else 0
        hi = min(q + 1, sk) if causal else sk
        pairs += max(hi - lo, 0)
    assert visible_pairs(s, sk, causal, window) == pairs


def test_bound_functions_keep_their_numbers():
    """granite's prefill attention: 524800 visible pairs, 17.2 GFLOP and
    42 MB, 0.0174 ms at 989 TFLOP/s (PERF.md §6's bound)."""
    assert visible_pairs(1024, 1024, True, 0) == 1024 * 1025 // 2
    assert visible_pairs(1024, 1024, True, 256) == sum(min(q + 1, 256) for q in range(1024))
    assert visible_pairs(256, 1000, False, 0) == 256 * 1000
    ms, by, flops, nbytes = attention_bound(4, 1024, 1024, 32, 8, 64, 64, "torch.bfloat16",
                                            True, 0)
    assert flops == 2.0 * 4 * 32 * 128 * 524800 and by == "operations"
    assert nbytes == 2 * (4 * 1024 * 32 * 128 + 4 * 1024 * 8 * 128)
    assert ms == pytest.approx(flops / 989e12 * 1e3)
    ms, by, flops, nbytes = ssd_bound(4, 1024, 48, 64, 128, 128, "torch.bfloat16",
                                      "torch.bfloat16")
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert flops == pytest.approx(7.73e9, rel=1e-3)


def test_counting_credits_each_launch_through_the_hook():
    """While a count runs, ops.launch_hook credits a launch with its
    formula; it is None again after the count."""
    q, k = _meta(2, 256, 8, 64), _meta(2, 256, 2, 64)
    with counting() as cost:
        for _ in range(3):
            ops.launch_hook("flash_attention", q=q, k=k, v=k, causal=True, window=0)
        with pytest.raises(RuntimeError, match="already running"):
            with counting():
                pass
    assert ops.launch_hook is None
    flops, nbytes = kernel_cost("flash_attention", q=q, k=k, v=k, causal=True, window=0)
    assert dict(cost.kernel_launches) == {"flash_attention": 3}
    assert cost.flops == 3 * flops and cost.bytes == 3 * nbytes and cost.aten_flops == 0


def test_counted_smoke_paths_are_read_against_the_roofline():
    """granite's smoke config on the CPU: the train step counts more FLOPs
    than 6 N D (remat recomputes the forward), the prefill about 2 N D,
    a decode step is memory-bound; one card has no collective term."""
    from repro_torch.data import batch_for
    from repro_torch.distributed.step import batch_to, build_prefill_step, build_train_step
    from repro_torch.optim import OptConfig, init_opt_state

    cfg = get_smoke_config("granite_3_2b")
    defs = param_defs(cfg)
    params = materialize(defs, 0, "cpu")
    b, s = 2, 64
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=1)
    step = build_train_step(cfg, opt_cfg)
    batch = batch_to(batch_for(cfg, b, s, 0, seed=0), torch.device("cpu"))
    _, train = count_step(step, params, init_opt_state(params, opt_cfg), batch)
    rep = analyze(arch=cfg.name, shape=f"b{b}_s{s}", mesh_name="single", chips=1, cost=train,
                  cfg=cfg, defs=defs, kind="train", tokens=b * s)
    assert 0 < rep.useful_ratio <= 1 and rep.collective_s == 0
    assert rep.row()["dominant"] in ("compute", "memory")
    ids = batch["inputs"] if "inputs" in batch else batch["tokens"]
    _, pre = count_step(build_prefill_step(cfg), params, {"inputs": ids[:, :s]})
    pre_rep = analyze(arch=cfg.name, shape="prefill", mesh_name="single", chips=1, cost=pre,
                      cfg=cfg, defs=defs, kind="serve", tokens=b * s)
    # the prefill applies the tied head to the last position only
    head = 2.0 * cfg.vocab_size * cfg.d_model * b * (s - 1)
    assert pre_rep.model_flops - head <= pre_rep.hlo_flops
    assert math.isfinite(pre_rep.roofline_fraction) and pre_rep.roofline_fraction > 0
