"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip without an NVIDIA GPU (and ``nvcc``), as on a
CPU-only machine.  Run them on a card with
``python -m pytest -m cuda tests/test_torch_cuda.py``.  This file imports
no jax, so it runs where only PyTorch is installed.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.ops import flash_attention
from repro_torch.kernels.ref import flash_attention_ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,window,s", [
    (torch.bfloat16, True, 0, 1024), (torch.bfloat16, True, 0, 1000),
    (torch.bfloat16, True, 256, 1024), (torch.bfloat16, False, 0, 1024),
    (torch.float32, True, 0, 1000)])
def test_cuda_kernel_matches_plain_version(dtype, causal, window, s):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, s, h, 64, generator=gen, device="cuda").to(dtype)
               for h in (32, 8, 8))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
