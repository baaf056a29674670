"""The flash-attention gradient of the port against the JAX package.

On CPU tensors ``FlashAttention.apply`` runs the kernel's plain forward
and ``flash_attention_bwd_ref`` (the backward kernel's formulas in fp32):
both are held against ``jax.grad`` of ``repro.models.layers.blockwise_mha``
(the function the JAX package trains through) and against torch autograd
of ``flash_attention_ref``, on the same numpy inputs.  The CUDA kernels
are held against the same plain versions on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import blockwise_mha as jax_blockwise_mha
from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
from repro_torch.kernels.ops import FlashAttention, flash_attention
from repro_torch.kernels.ref import (flash_attention_bwd_ref, flash_attention_lse_ref,
                                     flash_attention_ref)
from repro_torch.models.layers import blockwise_mha

# fp32: the same function computed in another order; bf16 inputs: the JAX
# side rounds its probabilities to bf16 before p v, the plain version not
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(s, d, seed=11, b=2, h=4, kv=2, dv=None):
    dv = d if dv is None else dv
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, dv), (b, s, h, dv))]


def _scaled_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.float().numpy() - want) / (1 + np.abs(want))))


def _jax_grads(arrays, dtype, causal, window):
    q, k, v, do = (jnp.asarray(a).astype(dtype) for a in arrays)

    def f(q, k, v):
        out = jax_blockwise_mha(q, k, v, causal=causal, window=window)
        return jnp.sum(out.astype(jnp.float32) * do.astype(jnp.float32))

    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


def _torch_grads(arrays, dtype, causal, window):
    q, k, v, do = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = FlashAttention.apply(*leaves, causal, window)
    return torch.autograd.grad(out, leaves, do)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("s", [64, 100])
@pytest.mark.parametrize("d", [16, 64, 256, 192])
def test_flash_backward_matches_jax_grad_fp32(d, s, window):
    """The plain backward at every head dim the kernels take: D 16 (the
    smoke configs), 64, 256 (recurrentgemma-9b) and MLA's q/k 192 over v
    128, causal and windowed."""
    arrays = _inputs(s, d, dv=128 if d == 192 else d)
    want = _jax_grads(arrays, "float32", True, window)
    got = _torch_grads(arrays, "float32", True, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _scaled_err(g, w) <= TOL["float32"], (name, _scaled_err(g, w))


@pytest.mark.parametrize("s,window", [(64, 0), (100, 24)])
def test_flash_backward_matches_jax_grad_bf16(s, window):
    arrays = _inputs(s, 64, seed=12)
    want = _jax_grads(arrays, "bfloat16", True, window)
    got = _torch_grads(arrays, "bfloat16", True, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        assert _scaled_err(g, w) <= TOL["bfloat16"], (name, _scaled_err(g, w))


@pytest.mark.parametrize("causal,window,s", [(True, 0, 64), (True, 24, 100), (False, 0, 37),
                                             (False, 16, 50)])
def test_flash_backward_ref_matches_torch_autograd(causal, window, s):
    """The backward formulas (P from lse, Delta, dS, the GQA sum) against
    autograd through the plain forward."""
    arrays = _inputs(s, 16, seed=13)
    q, k, v, do = (torch.from_numpy(a).double() for a in arrays)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*leaves, causal=causal, window=window),
                               leaves, do)
    o = flash_attention_ref(q, k, v, causal=causal, window=window)
    lse = flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    got = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=1e-5, atol=1e-5)


def test_lse_ref_is_logsumexp_of_visible_scores():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(40, 16, seed=14, b=1, h=2, kv=1))
    lse = flash_attention_lse_ref(q, k, v, causal=True, window=8)
    assert lse.shape == (1, 2, 40) and lse.dtype == torch.float32
    scores = torch.einsum("qd,kd->qk", q[0, :, 1], k[0, :, 0]) / 4.0
    row = 30                                   # keys 23..30 are visible
    torch.testing.assert_close(lse[0, 1, row], torch.logsumexp(scores[row, 23:31], 0))


def test_row_with_no_visible_key_gets_minus_inf_and_zero_grads():
    """S > Sk with a window: rows past the last visible key see nothing."""
    rng = np.random.default_rng(15)
    q = torch.from_numpy(rng.standard_normal((1, 20, 2, 16), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 8, 1, 16), dtype=np.float32))
            for _ in "kv")
    lse = flash_attention_lse_ref(q, k, v, causal=True, window=4)
    assert torch.isinf(lse[0, :, 15:]).all() and torch.isfinite(lse[0, :, :11]).all()
    o = torch.zeros_like(q)
    do = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32))
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=4)
    assert torch.isfinite(dq).all() and (dq[:, 15:] == 0).all()
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


def test_dispatch_takes_the_function_only_for_autograd():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(32, 16, seed=16))
    plain = flash_attention(q, k, v, causal=True)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_()
    out = flash_attention(qg, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert flash_attention(qg, k, v, causal=True).grad_fn is None
    torch.testing.assert_close(out.detach(), plain)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24)])
def test_model_attention_differentiates_on_cpu_like_jax(causal, window):
    """The model's blockwise_mha (the mirror loop on the CPU) under
    autograd, against jax.grad of the reference's, fp32."""
    arrays = _inputs(128, 16, seed=17)
    want = _jax_grads(arrays, "float32", causal, window)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(blockwise_mha(*leaves, causal=causal, window=window), leaves, do)
    for g, w in zip(got, want):
        assert _scaled_err(g, w) <= TOL["float32"]


def test_backward_launcher_refuses_cpu_tensors():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(64, 64, seed=18))
    lse = torch.zeros((2, 4, 64))
    with pytest.raises(ValueError, match="is on cpu"):
        flash_attention_bwd_cuda(q, k, v, q, lse, do, causal=True, window=0)
