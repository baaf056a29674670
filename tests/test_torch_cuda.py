"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip without an NVIDIA GPU (and ``nvcc``), as on a
CPU-only machine.  Run them on a card with
``python -m pytest -m cuda tests/test_torch_cuda.py``.  This file imports
no jax, so it runs where only PyTorch is installed.
"""
from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
from repro_torch.kernels.ops import flash_attention, ssd_scan
from repro_torch.kernels.ref import (flash_attention_lse_ref, flash_attention_ref, ssd_bwd_ref,
                                     ssd_ref)
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,window,s,d", [
    (torch.bfloat16, True, 0, 1024, 64), (torch.bfloat16, True, 0, 1000, 64),
    (torch.bfloat16, True, 256, 1024, 64), (torch.bfloat16, False, 0, 1024, 64),
    (torch.float32, True, 0, 1000, 64),
    # the other head dim (two TMA boxes a row), one partial q tile, a longer prompt
    (torch.bfloat16, True, 0, 1024, 128), (torch.bfloat16, True, 0, 100, 64),
    (torch.bfloat16, True, 0, 2048, 64)])
def test_cuda_kernel_matches_plain_version(dtype, causal, window, s, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, s, h, d, generator=gen, device="cuda").to(dtype)
               for h in (32, 8, 8))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,window,s,b,h,kv", [
    # recurrentgemma-9b's local attention: MQA, window 2048, a ragged tile
    (torch.bfloat16, True, 2048, 2560, 2, 16, 1), (torch.float32, True, 2048, 2560, 1, 16, 1),
    (torch.bfloat16, True, 0, 1000, 2, 16, 1), (torch.float32, True, 100, 300, 2, 16, 1),
    (torch.bfloat16, False, 0, 300, 2, 8, 2), (torch.float32, False, 0, 100, 2, 8, 2),
    (torch.bfloat16, True, 0, 40, 2, 16, 1), (torch.bfloat16, True, 64, 200, 2, 16, 4)])
def test_cuda_kernel_d256_matches_plain_version(dtype, causal, window, s, b, h, kv):
    """D 256: the bf16 kernel's 64-key tiles and the fp32 register-tiled
    kernel, against the plain version at the repo's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(b, s, n, 256, generator=gen, device="cuda").to(dtype)
               for n in (h, kv, kv))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s", [(torch.bfloat16, 2560), (torch.bfloat16, 1000),
                                     (torch.float32, 1100)])
def test_cuda_window_at_gemma3_gqa(dtype, s):
    """gemma3-27b's local layers: D 128, 32 q heads over 16 kv heads,
    window 1024, prompts past the window (2560 = 2.5 windows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(1, s, n, 128, generator=gen, device="cuda").to(dtype)
               for n in (32, 16, 16))
    got = flash_attention(q, k, v, causal=True, window=1024)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=True, window=1024)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s,sk,d", [
    (torch.bfloat16, 256, 1024, 64), (torch.bfloat16, 256, 1000, 64),
    (torch.bfloat16, 264, 1024, 64), (torch.bfloat16, 1024, 300, 128),
    (torch.float32, 100, 333, 64)])
def test_cuda_cross_attention_sk_ne_s(dtype, s, sk, d):
    """Non-causal attention of S queries over Sk != S keys (an enc-dec
    decoder's cross-attention): ragged key tiles are masked, no tile order
    of the causal path applies."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(2, s, 16, d, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(2, sk, 16, d, generator=gen, device="cuda").to(dtype) for _ in "kv")
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=False)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _scaled_err(got, want):
    return ((got.float() - want.float()).abs() / (1 + want.float().abs())).max().item()


def _bwd_inputs(dtype, b, s, h, kv, d, seed=3):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, n, d, generator=gen, device="cuda").to(dtype)
                   for n in (h, kv, kv, h))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,window,s,d,b,h", [
    (torch.bfloat16, True, 0, 1024, 64, 2, 32), (torch.bfloat16, True, 0, 100, 64, 2, 32),
    (torch.bfloat16, True, 256, 1024, 64, 2, 32), (torch.bfloat16, False, 0, 1000, 64, 2, 32),
    (torch.bfloat16, True, 0, 1000, 128, 2, 32), (torch.float32, True, 0, 1000, 64, 2, 32),
    (torch.float32, True, 24, 200, 128, 2, 32),
    # the edges of the bf16 tiling: S shorter than one 64-row tile, a GQA
    # group of one (H = KV = 8), non-causal D 128 with a ragged S, a window
    # that crosses tiles, B * H = 256 blocks of heads
    (torch.bfloat16, True, 0, 40, 64, 2, 32), (torch.bfloat16, True, 0, 1024, 64, 2, 8),
    (torch.bfloat16, False, 0, 1000, 128, 2, 32), (torch.bfloat16, True, 200, 1000, 64, 2, 32),
    (torch.bfloat16, True, 0, 256, 64, 8, 32)])
def test_cuda_flash_backward_matches_autograd_of_plain_version(dtype, causal, window, s, d,
                                                               b, h):
    """The backward kernels against autograd of ``flash_attention_ref`` in
    fp32 on the same values: bf16 5e-2, fp32 2e-3 (max |out - ref| /
    (1 + |ref|), the forward's bf16 P and dS roundings and the bf16 O in
    Delta)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    q, k, v, do = _bwd_inputs(dtype, b, s, h, 8, d)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True)
    dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = flash_attention_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(ref, leaves, do.float())
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-3
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == w.shape
        assert _scaled_err(got, w) <= tol, (name, _scaled_err(got, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,s,window", [(torch.bfloat16, 64, 1000, 0),
                                              (torch.bfloat16, 128, 1024, 0),
                                              (torch.bfloat16, 64, 1000, 200),
                                              (torch.float32, 64, 300, 0)])
def test_cuda_flash_backward_is_deterministic(dtype, d, s, window):
    """Two launches on the same inputs give bit-equal dq, dk and dv: each
    gradient is summed in one block, in a fixed order, with no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    q, k, v, do = _bwd_inputs(dtype, 2, s, 32, 8, d, seed=6)
    o, lse = flash_attention_cuda(q, k, v, causal=True, window=window, return_lse=True)
    first = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, window=window)
    second = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, window=window)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,s", [(torch.bfloat16, 64, 1024), (torch.bfloat16, 128, 100),
                                       (torch.float32, 64, 300)])
def test_cuda_flash_forward_lse(dtype, d, s):
    """With the lse buffer the forward writes the same output, bit for bit,
    and each row's logsumexp to 1e-3 of the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(2, s, h, d, generator=gen, device="cuda").to(dtype)
               for h in (32, 8, 8))
    o, lse = flash_attention_cuda(q, k, v, causal=True, window=0, return_lse=True)
    o_plain = flash_attention_cuda(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, o_plain, rtol=0, atol=0)
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, v, causal=True),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_cuda_flash_autograd_counts_both_directions():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(2, 256, h, 64, generator=gen, device="cuda")
               .to(torch.bfloat16).requires_grad_() for h in (8, 2, 2))
    fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
    out = flash_attention(q, k, v, causal=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.bwd_launches) == (fwd + 1, bwd + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,l,chunk,a_fp32", [
    (torch.bfloat16, 1024, 128, False), (torch.bfloat16, 1000, 128, False),
    (torch.bfloat16, 1024, 64, True), (torch.bfloat16, 300, 32, False),
    (torch.float32, 1000, 128, True), (torch.bfloat16, 2048, 128, False)])
def test_cuda_ssd_kernel_matches_plain_version(dtype, l, chunk, a_fp32):
    """mamba2-780m's head shape (P 64, N 128), inputs drawn as
    tests/test_kernels.py draws them; its tolerances (bf16 5e-2, fp32 2e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h = 2, 8
    x = torch.randn(b, l, h, 64, generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).to(dtype)
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))
    a = a if a_fp32 else a.to(dtype)
    bm, cm = (torch.randn(b, l, 128, generator=gen, device="cuda").to(dtype) for _ in "bc")
    before = ssd_scan.launches
    y, state = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == state.dtype == dtype
    want_y, want_state = ssd_ref(x, dt, a, bm, cm)
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(state.float(), want_state.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("l", [300, 1024, 1000])
def test_cuda_ssd_kernel_reads_strided_views(l):
    """x, B and C as the model passes them: views of one conv output
    (B, L, H*P + 2N), read in place by the kernel (through tensor maps in
    bf16), bit for bit as from contiguous copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, p, n = 2, 8, 64, 128
    conv = torch.randn(b, l, h * p + 2 * n, generator=gen, device="cuda").to(torch.bfloat16)
    x = conv[..., :h * p].reshape(b, l, h, p)
    bm, cm = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    assert not x.is_contiguous() and not bm.is_contiguous()
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).to(torch.bfloat16)
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))
    y, state = ssd_scan(x, dt, a, bm, cm, chunk=128)
    want_y, want_state = ssd_scan(x.contiguous(), dt, a, bm.contiguous(), cm.contiguous(),
                                  chunk=128)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(state, want_state, rtol=0, atol=0)
    ref_y, ref_state = ssd_ref(x, dt, a, bm, cm)
    torch.testing.assert_close(y.float(), ref_y.float(), rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(state.float(), ref_state.float(), rtol=5e-2, atol=5e-2)


@pytest.mark.cuda
def test_cuda_ssd_kernel_chunk64_matches_chunk128():
    """The two bf16 tilings compute one function: y and the final state at
    chunk 64 against chunk 128 to chip_smoke.py's 1e-2 (both carry fp32
    and differ in the order of their sums and the final roundings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, l, h = 2, 1000, 8
    x = torch.randn(b, l, h, 64, generator=gen, device="cuda").to(torch.bfloat16)
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).to(torch.bfloat16)
    a = (-torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))).to(torch.bfloat16)
    bm, cm = (torch.randn(b, l, 128, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in "bc")
    y64, s64 = ssd_scan(x, dt, a, bm, cm, chunk=64)
    y128, s128 = ssd_scan(x, dt, a, bm, cm, chunk=128)
    torch.testing.assert_close(y64.float(), y128.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(s64.float(), s128.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [0.05, 1.25])
def test_cuda_moe_scatter_is_bit_stable(capacity_factor):
    """The MoE scatter dispatch on the card (PyTorch ops, no kernel of its
    own): two calls give the same bits, dropped assignments included (they
    all land in the buffer's spare row), and the result matches the same
    call on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    from repro_torch.models.spec import materialize, tree_map

    cfg = get_smoke_config("olmoe_1b_7b").scaled(compute_dtype="float32")
    cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
    params = tree_map(lambda t: t.float(), materialize(moe.make_moe_defs(cfg), 0, "cpu"))
    x = torch.randn(4, 64, cfg.d_model, generator=torch.Generator().manual_seed(5))
    want, _ = moe.moe_scatter(params, x, cfg)
    on_card = tree_map(lambda t: t.cuda(), params)
    y1, _ = moe.moe_scatter(on_card, x.cuda(), cfg)
    y2, _ = moe.moe_scatter(on_card, x.cuda(), cfg)
    assert torch.equal(y1, y2)
    torch.testing.assert_close(y1.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,s,b,h", [
    # deepseek-v3's MLA prefill (q/k dim 192, v dim 128, MHA), ragged tiles
    # and one partial q tile, in both dtypes
    (torch.bfloat16, True, 1024, 2, 16), (torch.bfloat16, True, 1000, 2, 16),
    (torch.bfloat16, True, 100, 2, 16), (torch.bfloat16, False, 300, 2, 8),
    (torch.float32, True, 1000, 1, 16), (torch.float32, True, 130, 2, 8)])
def test_cuda_kernel_dk192_dv128_matches_plain_version(dtype, causal, s, b, h):
    """MLA's head dims: the bf16 kernel with v's own tensor map and an
    m64n128k16 P V product, the fp32 register-tiled kernel, against
    the plain version at the repo's tolerances; the output is v's width."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k = (torch.randn(b, s, h, 192, generator=gen, device="cuda").to(dtype) for _ in "qk")
    v = torch.randn(b, s, h, 128, generator=gen, device="cuda").to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and got.shape == (b, s, h, 128)
    want = flash_attention_ref(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, window=0, return_lse=True)
    torch.testing.assert_close(o, got, rtol=0, atol=0)
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, v, causal=causal),
                               rtol=1e-3, atol=1e-3)


# the MLA forward kernel (flash_fwd_bf16_ws, bf16 at q/k 192, v 128): B 1
# and 2; S 64 (a block's second warpgroup all past S), 100 (one partial
# block) and 1000 (a ragged last tile); 13 (batch, head) units, not a
# multiple of its block order's groups of 8; GQA (8 q heads over KV 2) with
# windows that cross its tiles; no mask
WS_FWD_CASES = [(1, 64, 13, 13, True, 0), (2, 100, 13, 13, True, 0),
                (1, 1000, 13, 13, True, 0), (2, 1000, 8, 2, True, 300),
                (2, 100, 8, 2, True, 40), (2, 64, 8, 2, True, 0), (1, 300, 13, 13, False, 0)]
# the forward's row logsumexp against the plain version's, as chip_smoke.py
LSE_TOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,causal,window", WS_FWD_CASES)
def test_cuda_mla_forward_kernel_matches_plain_version(b, s, h, kv, causal, window):
    """The MLA forward kernel against the plain version at the bf16 limit;
    with the lse buffer its output is the same bit for bit and each row's
    logsumexp within LSE_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k = (torch.randn(b, s, n, 192, generator=gen, device="cuda").bfloat16() for n in (h, kv))
    v = torch.randn(b, s, kv, 128, generator=gen, device="cuda").bfloat16()
    kw = dict(causal=causal, window=window)
    before, ws_before = flash_attention.launches, flash_attention.ws_launches
    got = flash_attention(q, k, v, kv_tile=128, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.ws_launches == ws_before + 1 and got.shape == (b, s, h, 128)
    want = flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, got, rtol=0, atol=0)
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, v, **kw), rtol=LSE_TOL,
                               atol=LSE_TOL)


@pytest.mark.cuda
def test_cuda_mla_forward_on_two_streams():
    """The MLA kernel's blocks take items from a pair of counters that each
    launch sets back to 0, one pair a stream: launches in a row on the
    current stream and on another stream give the same output bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k = (torch.randn(2, 1000, 16, 192, generator=gen, device="cuda").bfloat16() for _ in "qk")
    v = torch.randn(2, 1000, 16, 128, generator=gen, device="cuda").bfloat16()
    want = flash_attention_cuda(q, k, v, causal=True, window=0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = [flash_attention_cuda(q, k, v, causal=True, window=0) for _ in range(2)]
    again = flash_attention_cuda(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    for got in (*on_side, again):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_mla_decode_matches_cpu():
    """The absorbed MLA decode (PyTorch ops, no kernel) on the card from a
    prefilled latent cache: each step's output and cache against the same
    call on the CPU, in fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers
    from repro_torch.models.spec import materialize, tree_map

    cfg = get_smoke_config("deepseek_v3_671b").scaled(compute_dtype="float32")
    params = tree_map(lambda t: t.float(), materialize(layers.make_mla_defs(cfg), 3, "cpu"))
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, 24, cfg.d_model, generator=gen)
    _, c = layers.mla_train(params, x[:, :16], cfg, return_cache=True)
    cpu = {name: torch.zeros(2, 24, c[name].shape[-1]) for name in c}
    for name in c:
        cpu[name][:, :16] = c[name]
    cpu["len"] = torch.tensor(16, dtype=torch.int32)
    card = tree_map(lambda t: t.cuda(), cpu)
    on_card = tree_map(lambda t: t.cuda(), params)
    for t in range(16, 24):
        want, cpu = layers.mla_decode(params, x[:, t:t + 1], cpu, cfg)
        got, card = layers.mla_decode(on_card, x[:, t:t + 1].cuda(), card, cfg)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        for name in ("ckv", "k_rope"):
            torch.testing.assert_close(card[name].cpu(), cpu[name], rtol=1e-4, atol=1e-4)
        assert int(card["len"]) == int(cpu["len"]) == t + 1


@pytest.mark.cuda
def test_cuda_tensor_hashes_equal_to_its_host_copy():
    """The task store keys a CUDA tensor by value, as its host copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.checkpoint.task_store import hash_value

    t = torch.randn(64, 32, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    for x in (t, t[3:9].T, t.to(torch.bfloat16)):
        assert hash_value(x) == hash_value(x.cpu())
        assert hash_value(x) == hash_value(x.clone())
    assert hash_value(t) != hash_value(t.to(torch.bfloat16).cpu())


@pytest.mark.cuda
def test_cuda_fedlearn_client_update_matches_cpu():
    """fedlearn's local SGD on the card equals its CPU run at 1e-5 (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.apps import fedlearn

    params = fedlearn.init_params(seed=2)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = fedlearn.client_update.fn(params, 1, 1024, 3, device="cuda")
        loss = fedlearn.evaluate.fn(got, device="cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    want = fedlearn.client_update.fn(params, 1, 1024, 3, device="cpu")
    for k in want:
        torch.testing.assert_close(torch.from_numpy(got[k]), torch.from_numpy(want[k]),
                                   rtol=1e-5, atol=1e-5)
    assert loss == pytest.approx(fedlearn.evaluate.fn(want, device="cpu"), rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv,kv_tile", [(64, 64, 64), (64, 64, 128), (128, 128, 64),
                                          (128, 128, 128), (192, 128, 128), (256, 256, 64)])
@pytest.mark.parametrize("causal,window,s", [(True, 0, 1024), (True, 0, 1000), (True, 256, 700),
                                             (False, 0, 300)])
def test_cuda_every_kv_tile_matches_plain_version(d, dv, kv_tile, causal, window, s):
    """Each (head dims, kv tile) instantiation of the bf16 forward, against
    the plain version at the bf16 limit: full and ragged tiles, a window,
    no mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(9)
    h, kv = (16, 4) if d != 256 else (8, 1)
    q = torch.randn(2, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(2, s, kv, d, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(2, s, kv, dv, generator=gen, device="cuda").to(torch.bfloat16)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window, kv_tile=kv_tile)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_cuda_kernels_refuse_a_tile_they_are_not_built_for():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    q = torch.zeros(1, 64, 4, 256, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="built for"):
        flash_attention_cuda(q, q, q, causal=True, window=0, kv_tile=128)
    with pytest.raises(ValueError, match="one tile"):
        flash_attention_cuda(q.float(), q.float(), q.float(), causal=True, window=0, kv_tile=64)


@pytest.mark.cuda
def test_cuda_entry_points_launch_the_persisted_winner(tmp_path, monkeypatch):
    """A sweep on the card persists its winner; ops.flash_attention and
    ops.ssd_scan with no tile named launch it (bit for bit the launcher at
    that tile), and the launch counts move by one each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.kernels import autotune
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    gen = torch.Generator(device="cuda").manual_seed(10)
    q = torch.randn(2, 512, 16, 128, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(2, 512, 4, 128, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    res = autotune.autotune_flash_attention(q, k, v, causal=True, repeats=2)
    assert {r["blocks"]["kv_tile"] for r in res.sweep} == {64, 128}
    assert all(r["agrees"] for r in res.sweep) and res.default_us > 0
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    assert torch.equal(got, flash_attention_cuda(q, k, v, causal=True, window=0,
                                                 kv_tile=res.blocks["kv_tile"]))
    x = torch.randn(1, 512, 4, 64, generator=gen, device="cuda").to(torch.bfloat16)
    dt = F.softplus(torch.randn(1, 512, 4, generator=gen, device="cuda")).to(torch.bfloat16)
    a = -torch.rand(4, generator=gen, device="cuda").to(torch.bfloat16)
    bm, cm = (torch.randn(1, 512, 128, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    sres = autotune.autotune_ssd_scan(x, dt, a, bm, cm, repeats=2)
    before = ssd_scan.launches
    y, st = ssd_scan(x, dt, a, bm, cm)
    assert ssd_scan.launches == before + 1
    want_y, want_st = ssd_scan_cuda(x, dt, a, bm, cm, chunk=sres.blocks["chunk"])
    assert torch.equal(y, want_y) and torch.equal(st, want_st)


@pytest.mark.cuda
def test_cuda_roofline_counter_credits_each_launch():
    """On the card the kernels launch through ctypes, which dispatch does
    not see: the counter credits each launch (forward and backward) with
    its formula, and the launch counts are the wrappers' own."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.roofline import count_step
    from repro_torch.roofline.cost import attention_bound, attention_bwd_bound

    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn(2, 256, h, 64, generator=gen, device="cuda").to(torch.bfloat16)
               .requires_grad_() for h in (8, 2, 2))
    before = (flash_attention.launches, flash_attention.bwd_launches)
    _, cost = count_step(lambda: flash_attention(q, k, v).float().sum().backward())
    assert (flash_attention.launches, flash_attention.bwd_launches) == (before[0] + 1,
                                                                        before[1] + 1)
    assert dict(cost.kernel_launches) == {"flash_attention": 1, "flash_attention_bwd": 1}
    assert cost.kernel_flops["flash_attention"] == attention_bound(
        2, 256, 256, 8, 2, 64, 64, "torch.bfloat16", True, 0)[2]
    assert cost.kernel_flops["flash_attention_bwd"] == attention_bwd_bound(
        2, 256, 8, 2, 64, "torch.bfloat16", True, 0)[2]


def _scaled(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs() / (1 + want.float().abs())).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,dv,h,kv,causal,window,s,sk", [
    (256, 256, 16, 1, True, 100, 300, 300), (256, 256, 16, 1, True, 0, 130, 130),
    (192, 128, 8, 8, True, 0, 300, 300), (192, 128, 8, 8, True, 0, 100, 100),
    (16, 16, 4, 2, True, 32, 64, 64), (24, 16, 4, 4, True, 0, 64, 64),
    (64, 64, 16, 16, False, 0, 256, 1000)])
def test_cuda_flash_backward_every_head_dim_matches_plain(dtype, d, dv, h, kv, causal, window,
                                                          s, sk):
    """The backward at D 256 (two warpgroups a dK/dV block in bf16), MLA's
    (192, 128), the smoke dims on the SIMT kernels, and cross-attention with
    Sk != S, against autograd of the plain forward in fp32; through
    autograd it counts one backward launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(21)
    q = torch.randn(2, s, h, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(2, sk, kv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(2, sk, kv, dv, generator=gen, device="cuda").to(dtype)
    do = torch.randn(2, s, h, dv, generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*leaves, **kw), leaves, do.float())
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-3
    for g, w in zip(got, want):
        assert g.dtype == dtype and _scaled(g, w) <= tol
    before = flash_attention.bwd_launches
    ag = [t.clone().requires_grad_() for t in (q, k, v)]
    through = torch.autograd.grad(flash_attention(*ag, **kw), ag, do)
    assert flash_attention.bwd_launches == before + 1
    for g, w in zip(through, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# the two-warpgroup dK/dV kernel, (B, S, H, KV, D, Dv, window), causal: the
# shapes choose the head shares (kernels/flash_attention.py:bwd_head_shares
# on the card's 132 SMs): recurrentgemma-9b's MQA at the train step's B 1
# (7 shares of 16 heads), a GQA group of 5 over 4 shares, a ragged S
# shorter than two tiles (a share a head), MLA at one share and, at (192,
# 128), a group of 8 over 3 shares; windows that cross tiles
SPLIT_BWD_CASES = [(1, 2560, 16, 1, 256, 256, 2048), (1, 1280, 20, 4, 256, 256, 300),
                   (1, 100, 4, 1, 256, 256, 0), (2, 1000, 8, 8, 192, 128, 0),
                   (1, 2880, 16, 2, 192, 128, 500), (1, 100, 6, 2, 192, 128, 40)]
# the two-warpgroup dQ kernel's 128-row blocks (SPLIT_BWD_CASES hold D 256
# at S 2560 with its window and at S 100 too): 13 (batch, head) units,
# not a multiple of its block order's groups of 8; S 64, where the second
# warpgroup's rows all lie past S; a window of 100 that crosses a block's
# two halves, so that they see different kv tiles
DQ_PAIR_CASES = [(1, 1000, 13, 13, 192, 128, 0), (2, 64, 8, 8, 192, 128, 0),
                 (1, 200, 8, 8, 192, 128, 100), (2, 64, 4, 1, 256, 256, 0),
                 (1, 200, 4, 1, 256, 256, 100)]


def _split_bwd_inputs(b, s, h, kv, d, dv, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k = (torch.randn(b, s, n, d, generator=gen, device="cuda").bfloat16() for n in (h, kv))
    v, do = (torch.randn(b, s, n, dv, generator=gen, device="cuda").bfloat16() for n in (kv, h))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,d,dv,window", SPLIT_BWD_CASES + DQ_PAIR_CASES)
def test_cuda_flash_backward_split_matches_autograd(b, s, h, kv, d, dv, window):
    """The two-warpgroup dK/dV kernel (S^T and dP^T once a block, P^T and
    dS^T through shared memory, head shares summed by a pass of their own)
    and the two-warpgroup dQ kernel (128 q rows a block) against autograd
    of the plain forward in fp32: 5e-2 (max |out - ref| / (1 + |ref|))."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    q, k, v, do = _split_bwd_inputs(b, s, h, kv, d, dv, seed=31)
    kw = dict(causal=True, window=window)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*leaves, **kw), leaves, do.float())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.isfinite(g.float()).all(), name
        assert _scaled(g, w) <= 5e-2, (name, _scaled(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,d,dv,window", SPLIT_BWD_CASES + DQ_PAIR_CASES)
def test_cuda_flash_backward_split_is_deterministic(b, s, h, kv, d, dv, window):
    """Two launches give bit-equal dq, dk and dv: the head shares are
    summed in their order, with no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    q, k, v, do = _split_bwd_inputs(b, s, h, kv, d, dv, seed=32)
    kw = dict(causal=True, window=window)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    first = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    second = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


# the fp32 backward's register-tiled kernels (csrc/flash_attention_bwd_f32.cu),
# (B, S, Sk, H, KV, D, Dv, causal, window): every bucket at its own dims and
# inside it (D 40, phi-2's 80, (200, 136)), the smoke dims, head dims that
# are not multiples of 4 (4-byte copies), MHA, GQA and one kv head, ragged
# S 100 and 130, windows, Sk != S; recurrentgemma-9b's one kv head at B 2,
# S 1024, window 768 and a GQA group of 4 at D 128, which split each kv
# tile's q heads into head shares on the card's 132 SMs
F32_BWD_CASES = [
    (2, 100, 100, 4, 4, 16, 16, True, 0), (2, 130, 130, 4, 2, 24, 16, True, 48),
    (2, 130, 130, 4, 1, 40, 40, True, 0), (2, 100, 100, 4, 2, 64, 64, True, 0),
    (2, 130, 130, 4, 4, 80, 80, True, 48), (2, 100, 100, 4, 1, 128, 128, True, 0),
    (2, 130, 130, 4, 4, 192, 128, True, 0), (2, 130, 130, 4, 1, 256, 256, True, 48),
    (1, 100, 100, 4, 2, 5, 3, True, 0), (1, 130, 130, 4, 2, 70, 36, False, 0),
    (1, 130, 130, 4, 2, 200, 136, True, 0), (2, 64, 200, 4, 4, 64, 64, False, 0),
    (2, 1024, 1024, 16, 1, 256, 256, True, 768), (2, 512, 512, 32, 8, 128, 128, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,sk,h,kv,d,dv,causal,window", F32_BWD_CASES)
def test_cuda_flash_backward_f32_matches_autograd(b, s, sk, h, kv, d, dv, causal, window):
    """The fp32 dQ and dK/dV kernels (and the head shares' sum) against
    autograd of the plain forward in fp32, 2e-3 (max |out - ref| / (1 +
    |ref|)), the profiler's kernels the register-tiled ones alone; through
    autograd one backward launch on the "f32" route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import bwd_route

    assert bwd_route(torch.float32, d, dv).kind == "f32"
    gen = torch.Generator(device="cuda").manual_seed(41)
    q, do = (torch.randn(b, s, h, n, generator=gen, device="cuda") for n in (d, dv))
    k, v = (torch.randn(b, sk, kv, n, generator=gen, device="cuda") for n in (d, dv))
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    assert any("flash_bwd_dq_tiled" in n for n in names), names
    assert any("flash_bwd_dkdv_tiled" in n for n in names), names
    assert not any("flash_bwd_dq_f32" in n or "flash_bwd_dkdv_f32" in n for n in names), names
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*leaves, **kw), leaves, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.isfinite(g).all(), name
        assert _scaled(g, w) <= 2e-3, (name, _scaled(g, w))
    before = (flash_attention.bwd_launches, flash_attention.bwd_f32_launches)
    ag = [t.clone().requires_grad_() for t in (q, k, v)]
    through = torch.autograd.grad(flash_attention(*ag, **kw), ag, do)
    assert (flash_attention.bwd_launches, flash_attention.bwd_f32_launches) == (
        before[0] + 1, before[1] + 1)
    for g, w in zip(through, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# the fp32 forward's register-tiled kernel (csrc/flash_attention_fwd_f32.cu)
# at the backward's cases, and Sk < S under a window, whose last rows see no
# key
F32_FWD_CASES = F32_BWD_CASES + [(1, 200, 40, 4, 2, 64, 64, True, 16),
                                 (1, 300, 70, 4, 1, 80, 80, True, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,sk,h,kv,d,dv,causal,window", F32_FWD_CASES)
def test_cuda_flash_forward_f32_matches_plain(b, s, sk, h, kv, d, dv, causal, window):
    """The fp32 forward kernel against the plain version at 1e-4 (max |out
    - ref| / (1 + |ref|)) and its lse at 1e-4 on the rows that see a key,
    against its tiled mirror on every row at 1e-5; the profiler's kernel the
    register-tiled one alone, two launches bit for bit, and through
    ``ops.flash_attention`` one launch on the "f32" route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import fwd_f32_tiles, route
    from repro_torch.kernels.ref import flash_attention_fwd_tiled_ref

    assert route(torch.float32, d, dv).kind == "f32"
    gen = torch.Generator(device="cuda").manual_seed(43)
    q = torch.randn(b, s, h, d, generator=gen, device="cuda")
    k, v = (torch.randn(b, sk, kv, n, generator=gen, device="cuda") for n in (d, dv))
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    names = set()
    for _ in range(3):   # the profiler may return no record of a few-microsecond window
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                flash_attention_cuda(q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        if names:
            break
    assert names and all("flash_fwd_f32_tiled" in n for n in names), names
    seen = torch.isfinite(lse)                                  # (B, H, S)
    want_lse = flash_attention_lse_ref(q, k, v, **kw)
    assert torch.equal(seen, torch.isfinite(want_lse))
    assert _scaled(lse[seen], want_lse[seen]) <= 1e-4
    rows = seen.transpose(1, 2)
    assert _scaled(o[rows], flash_attention_ref(q, k, v, **kw)[rows]) <= 1e-4
    t = fwd_f32_tiles(d, dv)
    mo, mlse = flash_attention_fwd_tiled_ref(q, k, v, rows=t.rows, stream_rows=t.stream_rows,
                                             widths=t.dims, **kw)
    assert _scaled(o, mo) <= 1e-5 and torch.equal(torch.isinf(lse), torch.isinf(mlse))
    again = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)
    before = (flash_attention.launches, flash_attention.f32_launches)
    through = flash_attention(q, k, v, **kw)
    assert (flash_attention.launches, flash_attention.f32_launches) == (before[0] + 1,
                                                                        before[1] + 1)
    assert torch.equal(through, o)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,sk,h,kv,d,dv,causal,window", F32_BWD_CASES)
def test_cuda_flash_backward_f32_is_deterministic(b, s, sk, h, kv, d, dv, causal, window):
    """Two launches of the fp32 backward give bit-equal dq, dk and dv: no
    atomics, the head shares summed in their order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(42)
    q, do = (torch.randn(b, s, h, n, generator=gen, device="cuda") for n in (d, dv))
    k, v = (torch.randn(b, sk, kv, n, generator=gen, device="cuda") for n in (d, dv))
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    first = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    second = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p,n,b,l,h,chunk,views", [(64, 128, 2, 1000, 8, 128, False),
                                                   (64, 128, 2, 300, 8, 64, True),
                                                   (64, 128, 1, 1000, 13, 128, False),
                                                   (64, 128, 1, 300, 20, 64, True),
                                                   (16, 16, 2, 64, 8, 32, False),
                                                   (16, 16, 2, 100, 4, 32, True)])
def test_cuda_ssd_backward_matches_plain(dtype, p, n, b, l, h, chunk, views):
    """The SSD backward kernels against their plain version ``ssd_bwd_ref``,
    with a gradient of the final state; x, B and C as views where named; B
    1, and head counts the tensor-core route's head group (12) does not
    divide (8, 13, 20: a short last group); through ``ops.ssd_scan``'s
    autograd it counts one backward launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(22)
    if views:
        conv = torch.randn(b, l, h * p + 2 * n, generator=gen, device="cuda").to(dtype)
        x = conv[..., :h * p].reshape(b, l, h, p)
        bm, cm = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    else:
        x = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype)
        bm, cm = (torch.randn(b, l, n, generator=gen, device="cuda").to(dtype) for _ in "bc")
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).to(dtype)
    a = (-torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))).to(dtype)
    dy = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype)
    dstate = torch.randn(b, h, p, n, generator=gen, device="cuda").to(dtype)
    got = ssd_scan_bwd_cuda(x, dt, a, bm, cm, dy, dstate)
    want = ssd_bwd_ref(x, dt, a, bm, cm, dy, dstate)
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-3
    assert got[5] is None and want[5] is None      # no initial state, no gradient of it
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == w.dtype and g.shape == w.shape and _scaled(g, w) <= tol
    before = ssd_scan.bwd_launches
    leaves = [t.detach().requires_grad_() for t in (x, dt, a, bm, cm)]
    y, state = ssd_scan(*leaves, chunk=chunk)
    through = torch.autograd.grad((y, state), leaves, (dy, dstate))
    assert ssd_scan.bwd_launches == before + 1
    for g, w in zip(through, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# B/C groups (G > 1) and an initial state: (dtype, P, N, B, L, H, G, chunk,
# initial state: None, "x" (x's dtype) or "fp32", B/C as conv views).  The
# wgmma + TMA route (bf16 at (64, 128)) at mamba2's G 8 on 48 heads (6 a
# group: the backward's blocks hold 6 heads), 8 heads in 2 and 4 groups, 40
# in 2 (blocks of 12 and 8 heads a group), G 1 from a state, a ragged L,
# the chunk 256 of Mamba2Config (the kernel's largest tile); the SIMT route
# in fp32 and at the smoke shape (16, 16)
SSD_GROUP_CASES = [
    (torch.bfloat16, 64, 128, 1, 1024, 48, 8, 128, "x", True),
    (torch.bfloat16, 64, 128, 2, 1000, 8, 2, 128, "x", False),
    (torch.bfloat16, 64, 128, 2, 300, 8, 4, 64, None, True),
    (torch.bfloat16, 64, 128, 1, 512, 40, 2, 256, "fp32", False),
    (torch.bfloat16, 64, 128, 2, 100, 4, 1, 128, "x", False),
    (torch.float32, 64, 128, 1, 300, 8, 2, 128, "x", False),
    (torch.bfloat16, 16, 16, 2, 100, 8, 2, 32, "x", True),
    (torch.float32, 16, 16, 2, 64, 8, 4, 32, "fp32", False),
]


def _group_inputs(dtype, p, n, b, l, h, g, s0, views, seed=31):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if views:   # the model's split of its conv output (B, L, H P + 2 G N)
        conv = torch.randn(b, l, h * p + 2 * g * n, generator=gen, device="cuda").to(dtype)
        x = conv[..., :h * p].reshape(b, l, h, p)
        bm = conv[..., h * p:h * p + g * n].reshape(b, l, g, n)
        cm = conv[..., h * p + g * n:].reshape(b, l, g, n)
    else:
        x = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype)
        bm, cm = (torch.randn(b, l, g, n, generator=gen, device="cuda").to(dtype) for _ in "bc")
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda")).to(dtype)
    a = (-torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))).to(dtype)
    init = None
    if s0 is not None:
        init = torch.randn(b, h, p, n, generator=gen, device="cuda")
        init = init if s0 == "fp32" else init.to(dtype)
    dy = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype)
    dstate = torch.randn(b, h, p, n, generator=gen, device="cuda").to(dtype)
    return (x, dt, a, bm, cm), init, dy, dstate


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,p,n,b,l,h,g,chunk,s0,views", SSD_GROUP_CASES)
def test_cuda_ssd_groups_forward_matches_plain(dtype, p, n, b, l, h, g, chunk, s0, views):
    """The forward kernels at G B/C groups and from an initial state
    against ``ssd_ref`` (bf16 5e-2, fp32 2e-3): one launch, no mirror."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    inputs, init, _, _ = _group_inputs(dtype, p, n, b, l, h, g, s0, views)
    before = ssd_scan.launches
    y, state = ssd_scan(*inputs, chunk=chunk, initial_state=init)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want_y, want_state = ssd_ref(*inputs, init)
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-3
    assert y.dtype == state.dtype == dtype
    assert _scaled(y, want_y) <= tol and _scaled(state, want_state) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,p,n,b,l,h,g,chunk,s0,views", SSD_GROUP_CASES)
def test_cuda_ssd_groups_backward_matches_plain(dtype, p, n, b, l, h, g, chunk, s0, views):
    """The backward kernels at G groups and from an initial state against
    ``ssd_bwd_ref``: dx, ddt, da, db, dc and the initial state's gradient,
    two launches bit for bit, and through ``ops.ssd_scan``'s autograd one
    forward and one backward launch giving the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    inputs, init, dy, dstate = _group_inputs(dtype, p, n, b, l, h, g, s0, views)
    got = ssd_scan_bwd_cuda(*inputs, dy, dstate, init)
    again = ssd_scan_bwd_cuda(*inputs, dy, dstate, init)
    want = ssd_bwd_ref(*inputs, dy, dstate, initial_state=init)
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-3
    assert (got[5] is None) == (init is None)
    for k, (u, v, w) in enumerate(zip(got, again, want)):
        if w is None:
            continue
        assert u.dtype == w.dtype and u.shape == w.shape, k
        assert _scaled(u, w) <= tol, (k, _scaled(u, w))
        assert torch.equal(u, v), k
    leaves = [t.detach().requires_grad_() for t in inputs]
    if init is not None:
        leaves.append(init.detach().requires_grad_())
    counts = (ssd_scan.launches, ssd_scan.bwd_launches)
    y, state = ssd_scan(*leaves[:5], chunk=chunk,
                        initial_state=leaves[5] if init is not None else None)
    through = torch.autograd.grad((y, state), leaves, (dy, dstate))
    assert (ssd_scan.launches, ssd_scan.bwd_launches) == (counts[0] + 1, counts[1] + 1)
    for u, w in zip(through, got):
        torch.testing.assert_close(u, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,g", [(torch.bfloat16, 8), (torch.float32, 2)])
def test_cuda_ssd_split_scan_identity(dtype, g):
    """The scan of L steps equals the scan of its first half followed by
    the second half from that half's final state (kept in fp32), to the
    SSD tolerance: the initial state enters where the carried one would."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    (x, dt, a, bm, cm), _, _, _ = _group_inputs(dtype, 64, 128, 2, 1024, 16, g, None, False)
    y, state = ssd_scan(x, dt, a, bm, cm, chunk=128)
    half = 512
    dt0, dt1 = dt[:, :half].contiguous(), dt[:, half:].contiguous()   # read packed
    y0, s_half = ssd_scan(x[:, :half], dt0, a, bm[:, :half], cm[:, :half], chunk=128)
    ref_half = ssd_ref(x[:, :half], dt0, a, bm[:, :half], cm[:, :half])[1]
    y1, s_end = ssd_scan(x[:, half:], dt1, a, bm[:, half:], cm[:, half:], chunk=128,
                         initial_state=s_half)
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-3
    assert _scaled(s_half, ref_half) <= tol
    assert _scaled(torch.cat([y0, y1], 1), y) <= tol and _scaled(s_end, state) <= tol


# the staged route (bf16 and fp16 at head dims that are not multiples of 8):
# (B, S, Sk, H, KV, D, Dv, causal, window, dtype) over MHA, GQA and MQA,
# causal, windowed and unmasked, ragged S, Sk != S (Sk < S under a window:
# the last rows see no key), and every bucket: (20, 20), (5, 3), (12, 20)
# and (72, 36) stage into (64, 64) and (128, 128), (130, 100) into (192,
# 128), (250, 250) into (256, 256); (20, 64) and (64, 20) stage one side
STAGED_CASES = [
    (2, 130, 130, 4, 4, 20, 20, True, 0, torch.bfloat16),
    (2, 130, 130, 4, 2, 20, 20, True, 48, torch.float16),
    (1, 100, 100, 4, 1, 5, 3, True, 0, torch.float16),
    (1, 130, 130, 4, 2, 12, 20, False, 0, torch.bfloat16),
    (1, 130, 130, 4, 2, 72, 36, True, 0, torch.float16),
    (1, 130, 130, 4, 2, 130, 100, True, 0, torch.bfloat16),
    (1, 130, 130, 4, 4, 130, 100, True, 48, torch.float16),
    (1, 100, 100, 4, 1, 250, 250, True, 0, torch.bfloat16),
    (2, 64, 200, 4, 4, 20, 20, False, 0, torch.float16),
    (1, 130, 70, 4, 2, 20, 20, True, 16, torch.bfloat16),
    (1, 1000, 1000, 8, 2, 20, 20, True, 0, torch.float16),
    (1, 130, 130, 4, 2, 20, 64, True, 48, torch.float16),
    (1, 130, 130, 4, 2, 64, 20, False, 0, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,sk,h,kv,d,dv,causal,window,dtype", STAGED_CASES)
def test_cuda_flash_staged_matches_plain(b, s, sk, h, kv, d, dv, causal, window, dtype):
    """The staged route: forward and backward on the bucket's wgmma kernels
    (the profiler's names carry hopper::Widths in bf16, hopper::HalfWidths
    in fp16; the staging kernel flash_stage beside them, nothing else)
    against the staged mirror ``flash_attention_staged_ref`` in fp32 and
    autograd of it (2e-2, 5e-2), rows with no visible key zero; the
    backward bit-equal over two launches; through ``ops.flash_attention``
    under autograd one launch each way on the staged counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import route, ws_route
    from repro_torch.kernels.ref import flash_attention_staged_ref

    r = route(dtype, d, dv)
    assert r.kind == "stage"
    gen = torch.Generator(device="cuda").manual_seed(d + dv + s)
    q, do = (torch.randn(b, s, h, n, generator=gen, device="cuda").to(dtype) for n in (d, dv))
    k, v = (torch.randn(b, sk, kv, n, generator=gen, device="cuda").to(dtype) for n in (d, dv))
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    grads = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert o.shape == (b, s, h, dv) and o.is_contiguous()
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = flash_attention_staged_ref(*leaves, widths=r.dims, **kw)
    want_grads = torch.autograd.grad(want, leaves, do.float())
    assert _scaled(o, want) <= 2e-2
    for g, w, t in zip(grads, want_grads, (q, k, v)):
        assert g.shape == t.shape and g.dtype == dtype and g.is_contiguous()
        assert _scaled(g, w) <= 5e-2
    seen = torch.isfinite(flash_attention_lse_ref(q, k, v, **kw))
    assert _scaled(lse[seen], flash_attention_lse_ref(q, k, v, **kw)[seen]) <= 1e-3
    assert not o.transpose(1, 2)[~seen].any()   # rows with no visible key: zeros
    names = set()
    for _ in range(3):   # the profiler may return no record of a few-microsecond window
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            o2, lse2 = flash_attention_cuda(q, k, v, return_lse=True, **kw)
            flash_attention_bwd_cuda(q, k, v, o2, lse2, do, **kw)
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        if names:
            break
    tag = "hopper::HalfWidths" if dtype == torch.float16 else "hopper::Widths"
    flash = [n for n in names if "flash_stage" not in n]
    assert flash and all(tag in n for n in flash), names
    assert any("flash_stage" in n for n in names), names
    assert any("flash_bwd" in n for n in flash) and any("flash_fwd" in n for n in flash)
    before = (flash_attention.stage_launches, flash_attention.bwd_stage_launches,
              flash_attention.ws_launches)
    ag = [t.clone().requires_grad_() for t in (q, k, v)]
    through = torch.autograd.grad(flash_attention(*ag, **kw), ag, do)
    assert (flash_attention.stage_launches, flash_attention.bwd_stage_launches) == (
        before[0] + 1, before[1] + 1)
    assert flash_attention.ws_launches == before[2] + ws_route(dtype, d, dv)
    for u, w in zip(through, grads):
        torch.testing.assert_close(u, w, rtol=0, atol=0)
