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
from repro_torch.kernels.flash_attention import (BLOCK_Q, BWD_BOX_ROWS, HEAD_DIMS, KV_TILES,
                                                 default_kv_tile, flash_attention_bwd_cuda,
                                                 flash_attention_cuda, layout_array, tma_layout)
from repro_torch.kernels.ops import flash_attention
from repro_torch.kernels.ref import attention_ref, flash_attention_ref

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the bf16 forward's default kv tiles: D 64 and 128 (and MLA's 192 / 128), and D 256
BLOCK_KV, BLOCK_KV_D256 = default_kv_tile(64, 64), default_kv_tile(256, 256)


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
    # recurrentgemma-9b's layout: D 256, MQA (one kv head), a window, a ragged S
    pytest.param(2, 160, 4, 1, 256, True, 48, 128, 128, id="d256-mqa-window-ragged"),
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


def test_no_silent_fallback_off_cpu(monkeypatch):
    """Off the CPU the plain version never runs: a meta tensor (the
    dry-run's abstract evaluation) gets an uninitialised output of the
    kernel's shape and counts no launch."""
    from repro_torch.kernels import ops

    def plain(*a, **k):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(ops, "flash_attention_ref", plain)
    q, kv = torch.empty(1, 64, 4, 64, device="meta"), torch.empty(1, 64, 2, 64, device="meta")
    launches = flash_attention.launches
    out = flash_attention(q, kv, kv)
    assert out.device.type == "meta" and tuple(out.shape) == (1, 64, 4, 64)
    assert flash_attention.launches == launches
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


@pytest.mark.parametrize("dk,dv,match", [
    (128, 64, "head dims"),          # v narrower, but not a pair the kernel has
    (192, 192, "head dims"),
    (192, 128, "is on cpu"),         # MLA's pair passes the shape check
    (192, 96, "head dims"),
])
def test_launcher_takes_v_narrower_only_for_listed_pairs(dk, dv, match):
    q, k = torch.zeros(1, 64, 2, dk), torch.zeros(1, 64, 2, dk)
    v = torch.zeros(1, 64, 2, dv)
    with pytest.raises(ValueError, match=match):
        flash_attention_cuda(q, k, v, causal=True, window=0)


def _contiguous(shape):
    return torch.empty(shape, device="meta").stride()


@pytest.mark.parametrize("shape,rows,want", [
    # granite-3-2b's prefill q (B 4, S 1024, 32 heads, D 64) and k / v (8 kv heads)
    ((4, 1024, 32, 64), BLOCK_Q,
     ((64, 32, 1024, 4), (128, 4096, 4 * 1024 * 1024), (64, 1, 128, 1))),
    ((4, 1024, 8, 64), BLOCK_KV,
     ((64, 8, 1024, 4), (128, 1024, 1024 * 1024), (64, 1, 128, 1))),
    # D 128 is two 64-column boxes a row; a ragged S moves only its dim and the batch stride
    ((2, 100, 4, 128), BLOCK_Q, ((128, 4, 100, 2), (256, 1024, 102400), (64, 1, 128, 1))),
    # recurrentgemma-9b's prefill at D 256 (four boxes a row): q (16 heads) and
    # its one kv head in boxes of 64 rows
    ((4, 2560, 16, 256), BLOCK_Q,
     ((256, 16, 2560, 4), (512, 8192, 2560 * 8192), (64, 1, 128, 1))),
    ((4, 2560, 1, 256), BLOCK_KV_D256,
     ((256, 1, 2560, 4), (512, 512, 2560 * 512), (64, 1, 64, 1))),
])
def test_tma_layout_of_model_tensors(shape, rows, want):
    """dims innermost first (D, heads, S, B), byte strides of dims 1-3, box."""
    lay = tma_layout(shape, _contiguous(shape), 2, rows)
    assert (lay.dims, lay.strides, lay.box) == want
    assert lay.flat() == want[0] + want[1] + want[2]


@pytest.mark.parametrize("shape,stride,match", [
    # heads 66 elements (132 bytes) apart: a padded view TMA cannot address
    ((1, 64, 2, 64), (64 * 132, 132, 66, 1), "not a multiple of 16"),
    ((1, 64, 2, 72), (64 * 144, 144, 72, 1), "not a multiple of 64"),
    ((1, 64, 2, 64), (1, 128, 64, 64 * 128), "stride 8192, not 1"),
])
def test_tma_layout_refuses_what_tma_does_not_take(shape, stride, match):
    with pytest.raises(ValueError, match=match):
        tma_layout(shape, stride, 2, BLOCK_Q)


@pytest.mark.parametrize("q_rows,kv_rows", [(BLOCK_Q, BLOCK_KV), (BWD_BOX_ROWS, BWD_BOX_ROWS)],
                         ids=["forward", "backward"])
def test_layout_array_is_cached_by_shapes_and_strides(q_rows, kv_rows):
    """Each launcher's C array of TMA layouts is built once for a shape and
    stride pair, rebuilt for another, and holds tma_layout's values."""
    def arr(q_shape, k_shape, q_stride=None):
        return layout_array(q_shape, q_stride or _contiguous(q_shape), k_shape,
                            _contiguous(k_shape), q_rows, kv_rows)

    q_shape, k_shape = (4, 1024, 32, 64), (4, 1024, 8, 64)
    first = arr(q_shape, k_shape)
    assert arr(q_shape, k_shape) is first
    # q's layout, then k's, then v's (k's when v has no shape of its own)
    want = (tma_layout(q_shape, _contiguous(q_shape), 2, q_rows).flat()
            + 2 * tma_layout(k_shape, _contiguous(k_shape), 2, kv_rows).flat())
    assert list(first) == list(want)
    # another length, and the same shape stored (S, H, B, D): new arrays
    ragged = arr((2, 100, 32, 64), (2, 100, 8, 64))
    assert ragged is not first and list(ragged)[2] == 100
    strided = arr(q_shape, k_shape, q_stride=(64, 32 * 64 * 4, 64 * 4, 1))
    assert strided is not first and list(strided)[4:7] == [2 * 64 * 4, 2 * 32 * 64 * 4, 128]
    assert arr(q_shape, k_shape) is first


def test_build_is_keyed_by_sources():
    names = [p.name for p in build.sources()]
    assert "flash_attention.cu" in names
    d = build.build_dir()
    assert d.parent == build.BUILD_ROOT and d.parent.parent.name == "build"
    assert d == build.build_dir()                       # deterministic
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_kv_tile_rows_by_head_dim():
    """D 256 takes 64-row K/V boxes (two stages fit an SM); D 64 and 128
    default to 128, and so does MLA's q/k dim 192 (with v dim 128); each
    of those three is also built with 64-row tiles for the autotuner."""
    assert HEAD_DIMS == {(64, 64), (128, 128), (256, 256), (192, 128)}
    assert set(KV_TILES) == HEAD_DIMS
    assert [default_kv_tile(d, dv) for d, dv in ((64, 64), (128, 128), (256, 256), (192, 128))
            ] == [BLOCK_KV, BLOCK_KV, BLOCK_KV_D256, BLOCK_KV]
    assert BLOCK_KV_D256 == 64 and BLOCK_KV == 128
    assert all(set(KV_TILES[dims]) == {128, 64} for dims in ((64, 64), (128, 128), (192, 128)))
    assert KV_TILES[(256, 256)] == (64,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_refuses_dv_ne_d_naming_roadmap(dtype):
    """MLA's (192, 128): the backward launcher refuses v narrower than q
    before any other check, naming where it waits."""
    q, k = torch.zeros(1, 64, 4, 192, dtype=dtype), torch.zeros(1, 64, 4, 192, dtype=dtype)
    v, o = torch.zeros(1, 64, 4, 128, dtype=dtype), torch.zeros(1, 64, 4, 128, dtype=dtype)
    with pytest.raises(NotImplementedError, match=r"dv 128 != d 192.*ROADMAP.md, Queue 2 item 1"):
        flash_attention_bwd_cuda(q, k, v, o, torch.zeros(1, 4, 64), o, causal=True, window=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_refuses_d256_naming_roadmap(dtype):
    """The backward launcher refuses D 256 before any other check (here on
    CPU tensors), naming where it waits; it does not take a plain version."""
    q = torch.zeros(1, 64, 4, 256, dtype=dtype)
    kv = torch.zeros(1, 64, 1, 256, dtype=dtype)
    lse = torch.zeros(1, 4, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 2 item 1"):
        flash_attention_bwd_cuda(q, kv, kv, q, lse, q, causal=True, window=0)
