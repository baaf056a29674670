"""The port's flash attention against the Pallas kernel (interpret mode)
and the JAX oracle, on the cases of tests/test_kernels.py.

On CPU tensors ``repro_torch.kernels.ops.flash_attention`` runs the
kernel's plain version and launches nothing; the CUDA kernel itself is
held against the same plain version on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ops import flash_attention
from repro_torch.kernels.ref import attention_ref, flash_attention_ref

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _qkv(b, s, h, kv, d, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), dtype=np.float32),
            rng.standard_normal((b, s, kv, d), dtype=np.float32),
            rng.standard_normal((b, s, kv, d), dtype=np.float32))


def _both(arrays, dtype: str):
    """The same inputs as jax arrays and torch tensors of ``dtype``."""
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, th


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


CASES = [  # (b, s, h, kv, d, causal, window, q_block, kv_block)
    pytest.param(1, 128, 2, 2, 64, True, 0, None, None, id="causal-s128"),
    pytest.param(1, 256, 2, 2, 128, True, 0, None, None, id="causal-s256-d128"),
    pytest.param(2, 256, 2, 1, 64, True, 32, None, None, id="window32"),
    pytest.param(2, 256, 2, 1, 64, True, 64, None, None, id="window64"),
    pytest.param(2, 128, 8, 2, 64, True, 0, None, None, id="gqa"),
    pytest.param(1, 128, 2, 2, 64, False, 0, None, None, id="noncausal"),
    pytest.param(1, 130, 2, 2, 64, True, 0, 128, 128, id="ragged-s130"),
    pytest.param(1, 200, 2, 2, 64, False, 0, 128, 128, id="ragged-noncausal"),
    pytest.param(2, 160, 4, 2, 64, True, 64, 128, 128, id="ragged-gqa-window"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d,causal,window,q_block,kv_block", CASES)
def test_flash_attention_matches_pallas_interpret(b, s, h, kv, d, causal, window,
                                                  q_block, kv_block, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, s, h, kv, d), dtype)
    want = jax_flash(jq, jk, jv, causal=causal, window=window, q_block=q_block,
                     kv_block=kv_block, interpret=True)
    before = flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert flash_attention.launches == before          # CPU: the plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0)])
def test_attention_ref_matches_jax_oracle(causal, window):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((3, 96, 32), dtype=np.float32) for _ in range(3))
    want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=causal, window=window)
    _close(got, want, 1e-5)


def test_flash_matches_model_layer_path():
    """The kernel's function is the model's blockwise_mha (the JAX path)."""
    from repro.models.layers import blockwise_mha
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 256, 4, 2, 64), "float32")
    _close(flash_attention(tq, tk, tv, causal=True), blockwise_mha(jq, jk, jv, causal=True),
           1e-4)


def test_no_silent_fallback_off_cpu():
    q = torch.empty(1, 64, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention(q, q, q)
    # the launcher itself refuses anything that is not on a CUDA device
    cpu = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="not cuda|is on cpu"):
        flash_attention_cuda(cpu, cpu, cpu, causal=True, window=0)


@pytest.mark.parametrize("shape_q,shape_kv,dtype,match", [
    ((1, 64, 6, 64), (1, 64, 4, 64), torch.float32, "do not group"),
    ((1, 64, 2, 48), (1, 64, 2, 48), torch.float32, "head dim"),
    ((1, 64, 2, 64), (1, 64, 2, 64), torch.float16, "bf16 or fp32"),
    ((1, 64, 2, 64), (1, 32, 3, 64), torch.float32, "do not group"),
])
def test_launcher_rejects_what_the_kernel_does_not_take(shape_q, shape_kv, dtype, match):
    q = torch.zeros(shape_q, dtype=dtype)
    kv = torch.zeros(shape_kv, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        flash_attention_cuda(q, kv, kv, causal=True, window=0)


def test_build_is_keyed_by_sources():
    names = [p.name for p in build.sources()]
    assert "flash_attention.cu" in names
    d = build.build_dir()
    assert d.parent == build.BUILD_ROOT and d.parent.parent.name == "build"
    assert d == build.build_dir()                       # deterministic
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
