"""The flash backward's two-warpgroup dQ kernel, as far as the CPU can hold
it: the gradient it computes, the scratch it writes, its tiles and its
bound.

At (192, 128) and (256, 256) in bf16 the dQ kernel runs blocks of 128 q
rows, two warpgroups of 64 over one ring of K/V stages
(``csrc/flash_attention_bwd.cu``: ``flash_bwd_dq_bf16_pair``).  Its
formulas are ``flash_attention_bwd_ref``'s, held here against
``jax.grad`` of ``repro.models.layers.blockwise_mha`` at sequence lengths
that leave a block's second half empty (S 64) or partial (S 100, 200),
with and without a window that crosses the two halves.  The block writes
Delta and the base-2 lse of all its 128 rows into a scratch that
``bwd_scratch_rows`` pads; ``bwd_dq_tiles`` states its tiles and shared
bytes, and the C source's route must name the same head dims.  The kernel
itself is held to the plain versions on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import blockwise_mha as jax_blockwise_mha
from repro_torch.kernels.flash_attention import (BUCKETS, BWD_BOX_ROWS, HEAD_DIMS, SIMT_HEAD_DIMS,
                                                 SPLIT_HEAD_DIMS, bwd_dq_tiles, bwd_scratch_rows)
from repro_torch.kernels.ref import (flash_attention_bwd_ref, flash_attention_lse_ref,
                                     flash_attention_ref)
from repro_torch.roofline.cost import attention_bwd_dq_bound, visible_pairs

# fp32: the same function summed in another order
TOL = 1e-4
# shared memory one block can use on the H100
SMEM_BYTES = 232448
TMA_HEAD_DIMS = sorted(HEAD_DIMS - SIMT_HEAD_DIMS)
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"


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


@pytest.mark.parametrize("window", [0, 80])
@pytest.mark.parametrize("s", [64, 100, 200])
@pytest.mark.parametrize("d,dv,h,kv", [(192, 128, 2, 2), (256, 256, 2, 1)])
def test_dq_formulas_match_jax_grad(d, dv, h, kv, s, window):
    """dQ, dK and dV of the backward's formulas against the gradient of the
    JAX package's attention, at fp32's 1e-4: MLA's (192, 128) and D 256
    (MQA), S 64 (a 128-row block's second half empty), 100 and 200 (partly
    past S), causal, with a window of 80 that crosses a block's halves and
    without."""
    arrays = _inputs(1, s, h, kv, d, dv, seed=s + window + d)
    want = _jax_grads(arrays, window)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    kw = dict(causal=True, window=window)
    o = flash_attention_ref(q, k, v, **kw)
    lse = flash_attention_lse_ref(q, k, v, **kw)
    got = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _scaled_err(g, w) <= TOL, (name, _scaled_err(g, w))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,dv", sorted(HEAD_DIMS))
@pytest.mark.parametrize("s", [64, 100, 1000, 2560])
def test_scratch_holds_every_row_a_dq_block_writes(s, d, dv, dtype):
    """The launcher's Delta / lse scratch, ``bwd_scratch_rows`` rows a
    (batch, head): every dQ block stores all its rows (0 past S), so the
    rows of the last block end inside it; the dK/dV kernel bulk-loads whole
    64-row tiles of it.  128-row blocks on the two-warpgroup route only."""
    pad = bwd_scratch_rows(s, dtype, d, dv)
    pair = dtype == torch.bfloat16 and (d, dv) in SPLIT_HEAD_DIMS
    rows = 2 * BWD_BOX_ROWS if pair else BWD_BOX_ROWS
    if dtype == torch.bfloat16 and (d, dv) not in SIMT_HEAD_DIMS:
        assert bwd_dq_tiles(d, dv).rows == rows
    last_row = -(-s // rows) * rows - 1        # the last block's last row
    assert s <= pad and last_row < pad and pad % rows == 0 and pad % BWD_BOX_ROWS == 0
    last_tile = (s - 1) // BWD_BOX_ROWS * BWD_BOX_ROWS   # the dK/dV kernel's last q tile
    assert last_tile + BWD_BOX_ROWS <= pad
    assert pad - s < rows                      # no more than one block's padding


@pytest.mark.parametrize("d,dv", TMA_HEAD_DIMS)
def test_dq_tiles_fit_shared_memory(d, dv):
    """Each bf16 dQ configuration's shared bytes (its Q and dO rows, its
    K/V stages, 1024 for alignment, the mbarriers) fit the 232,448 a block
    can use; the two-warpgroup kernel's are 205,880 at (192, 128) (three
    64-row stages) and 230,456 at D 256 (three 32-row stages)."""
    t = bwd_dq_tiles(d, dv)
    assert t.smem_bytes <= SMEM_BYTES
    # a padded call's dims take their bucket's tiles: these pairs are buckets
    assert (d, dv) in BUCKETS and bwd_dq_tiles(d - 8, dv - 8) == t
    tiles = (t.rows + t.stages * t.kv_rows) * (d + dv) * 2   # bf16 Q, dO and K/V stages
    assert t.smem_bytes == 1024 + tiles + 8 * (1 + 2 * t.stages)
    if (d, dv) in SPLIT_HEAD_DIMS:
        assert (t.rows, t.stages) == (128, 3)
        assert t.smem_bytes == {(192, 128): 205880, (256, 256): 230456}[(d, dv)]
    else:
        assert (t.rows, t.kv_rows, t.stages) == (64, 64, 2)


def test_csrc_routes_the_same_head_dims():
    """The C entry's two-warpgroup route (``split``, which also sets the
    scratch's padding it accepts) names the head dims ``SPLIT_HEAD_DIMS``
    does, and ``PairSmem`` the stages and kv rows of ``bwd_dq_tiles``: the
    launcher pads the scratch by them."""
    # the entry is in the source, the kernels' shared memory in its header
    src = CSRC.read_text() + CSRC.with_suffix(".cuh").read_text()
    body = re.search(r"const bool split = is_bf16 && (.*?);", src, re.S).group(1)
    pairs = {(int(a), int(b)) for a, b in re.findall(r"DK == (\d+) && DV == (\d+)", body)}
    assert pairs == set(SPLIT_HEAD_DIMS)
    assert "const int pad_rows = split ? 2 * ROWS : ROWS;" in src
    smem = re.search(r"struct PairSmem \{(.*?)\};", src, re.S).group(1)
    assert re.search(r"KR = DK == 256 \? 32 : ROWS;", smem)
    assert re.search(r"STAGES = 3;", smem)
    for d, dv in SPLIT_HEAD_DIMS:
        assert bwd_dq_tiles(d, dv).kv_rows == (32 if d == 256 else BWD_BOX_ROWS)


def test_dq_bound_counts_its_products_and_bytes():
    """The dQ kernel's bound at deepseek-v3's MLA training shape (B 2, S
    1024, 128 heads, q/k 192, v 128, causal), counted by hand: S, dP and dQ
    over the 524,800 visible pairs, 2 (2 * 192 + 128) FLOPs a pair and
    head; q, k, v, o, dO, lse read once, dQ, Delta and lse2 written once.
    Bytes bound it: 0.151 ms at 3.35 TB/s."""
    pairs = 1024 * 1025 // 2
    assert visible_pairs(1024, 1024, True, 0) == pairs
    ms, by, flops, nbytes = attention_bwd_dq_bound(2, 1024, 128, 128, 192, "torch.bfloat16",
                                                   True, 0, dv=128)
    assert flops == 2.0 * 2 * 128 * (2 * 192 + 128) * pairs == 137573171200.0
    rows = 2 * 1024 * 128                     # (b, s, head)
    q = k = dq = rows * 192 * 2
    v = o = do = rows * 128 * 2
    assert nbytes == q + k + v + o + do + dq + 3 * rows * 4 == 506462208.0
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    # D 256 (recurrentgemma-9b, window 2048, MQA): the tensor cores bound it
    ms, by, flops, _ = attention_bwd_dq_bound(2, 2560, 16, 1, 256, "torch.bfloat16", True, 2048)
    assert by == "operations" and flops == 2.0 * 2 * 16 * 768 * visible_pairs(2560, 2560, True,
                                                                               2048)
