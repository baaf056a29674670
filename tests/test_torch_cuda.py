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

from repro_torch.kernels.ops import flash_attention, ssd_scan
from repro_torch.kernels.ref import flash_attention_ref, ssd_ref


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
@pytest.mark.parametrize("dtype,l,chunk,a_fp32", [
    (torch.bfloat16, 1024, 128, False), (torch.bfloat16, 1000, 128, False),
    (torch.bfloat16, 1024, 64, True), (torch.bfloat16, 300, 32, False),
    (torch.float32, 1000, 128, True)])
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
def test_cuda_ssd_kernel_reads_strided_views():
    """x, B and C as the model passes them: views of one conv output
    (B, L, H*P + 2N), read in place by the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, l, h, p, n = 2, 300, 8, 64, 128
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
