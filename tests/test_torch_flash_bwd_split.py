"""The flash backward's two-warpgroup dK/dV kernel, as far as the CPU can
hold it: its head-share decomposition and the plan that chooses it.

At (256, 256) and (192, 128) in bf16 the dK/dV kernel may split each kv
tile's q heads into head shares over blocks, write each share's dK and
dV in fp32 and sum the shares in their order
(``csrc/flash_attention_bwd.cu``).  ``flash_attention_bwd_ref`` with
``shares`` states that sum; here it is held against ``jax.grad`` of
``repro.models.layers.blockwise_mha`` on the same numpy inputs, and the
plan (``bwd_head_shares``) at the models' training shapes.  The kernel
itself is held to the plain versions on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import blockwise_mha as jax_blockwise_mha
from repro_torch.kernels.flash_attention import (BWD_BOX_ROWS, BWD_SPLIT_WAVES,
                                                 bwd_head_shares, bwd_partial_numel)
from repro_torch.kernels.ref import (flash_attention_bwd_ref, flash_attention_lse_ref,
                                     flash_attention_ref)

# fp32: the same function summed in another order
TOL = 1e-4
H100_SMS = 132


def _inputs(b, s, h, kv, d, dv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, dv), (b, s, h, dv))]


def _jax_grads(arrays, window):
    q, k, v, do = (jnp.asarray(a) for a in arrays)

    def f(q, k, v):
        return jnp.sum(jax_blockwise_mha(q, k, v, causal=True, window=window) * do)

    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


def _scaled_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.float().numpy() - want) / (1 + np.abs(want))))


@pytest.mark.parametrize("shares", [1, 2, 3])
@pytest.mark.parametrize("kv,h", [(1, 6), (2, 8)])
@pytest.mark.parametrize("s,window", [(100, 24), (64, 0)])
@pytest.mark.parametrize("d,dv", [(32, 32), (48, 32)])
def test_head_shares_match_jax_grad(d, dv, s, window, kv, h, shares):
    """dK and dV summed over 1, 2 or 3 head shares (3 does not divide the
    GQA group of 4), MQA and GQA, with a window over a ragged S and
    without, q/k wider than v as in MLA: the gradient of the JAX
    package's attention to fp32's 1e-4."""
    arrays = _inputs(1, s, h, kv, d, dv, seed=41 + shares)
    want = _jax_grads(arrays, window)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    kw = dict(causal=True, window=window)
    o = flash_attention_ref(q, k, v, **kw)
    lse = flash_attention_lse_ref(q, k, v, **kw)
    got = flash_attention_bwd_ref(q, k, v, o, lse, do, shares=shares, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _scaled_err(g, w) <= TOL, (name, _scaled_err(g, w))


def test_head_shares_add_in_share_order():
    """Three shares of a group of 4 (heads 0, 1, 2-3): dK and dV are the
    shares' sums added in order, and equal one share's sum to fp32
    rounding."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 40, 4, 1, 16, 16, seed=45))
    o = flash_attention_ref(q, k, v)
    lse = flash_attention_lse_ref(q, k, v)
    per_head = [flash_attention_bwd_ref(q[:, :, i:i + 1], k, v, o[:, :, i:i + 1],
                                        lse[:, i:i + 1], do[:, :, i:i + 1]) for i in range(4)]
    _, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do, shares=3)
    want_dv = per_head[0][2] + per_head[1][2] + (per_head[2][2] + per_head[3][2])
    torch.testing.assert_close(dv, want_dv, rtol=1e-6, atol=1e-6)
    _, dk1, dv1 = flash_attention_bwd_ref(q, k, v, o, lse, do)
    torch.testing.assert_close(dk, dk1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dv, dv1, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b", [1, 2])
def test_plan_keeps_one_share_where_blocks_fill_the_card(b):
    """deepseek-v3's MLA (128 kv heads, a group of one, S 1024) at B 2 and
    at the train step's B 1: thousands of blocks, no split, no scratch."""
    assert bwd_head_shares(b, 128, 1, 1024, H100_SMS) == 1
    assert bwd_partial_numel(1, b, 1024, 128, 192, 128) == 0
    # a group the plan could split, with blocks enough for two waves
    assert bwd_head_shares(b, 8, 4, 4096, H100_SMS) == 1


@pytest.mark.parametrize("b,shares", [(1, 7), (2, 4)])
def test_plan_fills_the_card_at_d256(b, shares):
    """recurrentgemma-9b's MQA layer (16 heads over one kv head, S 2560) at
    B 1, the train step's launch shape, and B 2: 40 and 80 kv tiles split
    into head shares until two waves of 132 blocks are launched, never more
    shares than heads; the fp32 partials that implies."""
    tiles = b * 1 * -(-2560 // BWD_BOX_ROWS)
    n = bwd_head_shares(b, 1, 16, 2560, H100_SMS)
    assert n == shares and 1 < n <= 16
    assert tiles * n >= BWD_SPLIT_WAVES * H100_SMS > tiles * (n - 1)
    assert tiles * n >= H100_SMS
    numel = bwd_partial_numel(n, b, 2560, 1, 256, 256)
    assert numel == n * b * 2560 * 512
    assert 4 * numel < 64e6   # B 1: 36.7 MB, B 2: 41.9 MB of fp32 scratch


def test_plan_takes_one_share_a_head_at_most():
    """A short sequence with few kv tiles: as many shares as heads."""
    assert bwd_head_shares(1, 1, 6, 100, H100_SMS) == 6
    assert bwd_head_shares(1, 2, 3, 256, H100_SMS) == 3
    assert bwd_head_shares(1, 4, 1, 64, H100_SMS) == 1
    # the GQA group of 5 over 4 shares that the card's tests launch
    assert bwd_head_shares(1, 4, 5, 1280, H100_SMS) == 4
