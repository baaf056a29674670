"""The flash forward's MLA kernel, as far as the CPU can hold it: the
function it computes, its block order, its tiles and its route.

bf16 attention at q/k head dim 192 and v head dim 128 (deepseek-v3's
multi-head latent attention) runs ``flash_fwd_bf16_ws``
(``csrc/flash_attention_fwd_ws.cu``): a persistent grid whose blocks take
items of 128 q rows in the launch order, (batch, head) units in groups of
ORDER_UNITS, q tile by q tile, heaviest first; a producer warpgroup and
two consumer warpgroups over a ring of K/V stages.
Its function is ``flash_attention_ref``'s, held here with its row
logsumexp against the JAX package's ``blockwise_mha`` (the Pallas
``flash_attention_bh`` takes one head dim only) on the same numpy inputs.
A Python mirror of the block order, the shared-memory layout and the
route are read against the C source.  The kernel itself is held to the
plain versions on the card by tests/test_torch_cuda.py and
``chip_smoke.py``.
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import blockwise_mha as jax_blockwise_mha
from repro_torch.kernels.flash_attention import (BLOCK_Q, HEAD_DIMS, KV_TILES, WS_HEAD_DIMS,
                                                 tma_route, ws_route)
from repro_torch.kernels.ref import flash_attention_lse_ref, flash_attention_ref

# fp32: the same function summed in another order
TOL = 1e-4
# shared memory one block can use on the H100, and its L2
SMEM_BYTES = 232448
L2_BYTES = 50 * 2 ** 20
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/flash_attention_fwd_ws.cu"


def _order_units() -> int:
    return int(re.search(r"constexpr int ORDER_UNITS = (\d+);", CSRC.read_text()).group(1))


def block_order(b: int, h: int, s: int, causal: bool) -> list[tuple[int, int, int]]:
    """(batch, head, q tile) of each item of a launch, in the order the
    blocks take them, as the kernel's ``item_at`` maps an item index."""
    units, tiles, group = b * h, -(-s // BLOCK_Q), _order_units()
    out = []
    for x in range(units * tiles):
        grp, within = divmod(x, group * tiles)
        width = min(group, units - grp * group)
        unit = grp * group + within % width
        qt = tiles - 1 - within // width if causal else within // width
        out.append((unit // h, unit % h, qt))
    return out


@pytest.mark.parametrize("b,h,s,causal", [(4, 128, 1024, True), (1, 13, 1000, True),
                                          (2, 8, 100, False), (1, 3, 64, True),
                                          (1, 128, 1024, True)])
def test_block_order_covers_each_tile_once_heaviest_first(b, h, s, causal):
    """Each (batch, head, q tile) once; within a group of ORDER_UNITS units
    the causal q tiles run from the last (the most kv tiles) down; and any
    132 items in a row, the blocks' items in flight, read the K/V of a few
    heads: at MLA's B 4 at most four groups, 20 MB of K/V, inside the 50 MB
    L2."""
    order = block_order(b, h, s, causal)
    tiles, group = -(-s // BLOCK_Q), _order_units()
    assert group == 8
    assert sorted(order) == [(i, j, t) for i in range(b) for j in range(h) for t in range(tiles)]
    for start in range(0, len(order), group * tiles):
        qts = [t for _, _, t in order[start:start + group * tiles]]
        assert qts == sorted(qts, reverse=causal)
    kv_bytes = s * (192 + 128) * 2            # one head's K and V
    for start in range(max(1, len(order) - 131)):
        heads = {(i, j) for i, j, _ in order[start:start + 132]}
        assert len(heads) <= 4 * group
        assert len(heads) * kv_bytes <= L2_BYTES / 2


def test_tiles_fit_shared_memory_and_match_the_source():
    """The kernel's shared memory at the kv tile it is built for (exactly
    ``KV_TILES[(192, 128)]``), laid out as the C source lays it out: Q of
    128 rows (48 KB), two K/V stages of 128 rows (80 KB each), 1024 bytes
    for alignment, sixteen mbarriers (each warpgroup's Q full and empty,
    two item slots full and empty, K and V full and empty a stage) and the
    two item slots, within the 232,448 bytes a block can use; the C
    source's constants and its entry's tile check say the same."""
    src = CSRC.read_text()
    (wn,) = KV_TILES[(192, 128)]
    assert wn == int(re.search(r"constexpr int WN = (\d+);", src).group(1)) == 128
    assert "kv_tile != WN" in src
    stages = int(re.search(r"constexpr int STAGES = (\d+);", src).group(1))
    assert stages == 2
    assert "1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES) + 8 * (8 + 4 * STAGES) + 8;" in src
    nbytes = 1024 + BLOCK_Q * 192 * 2 + stages * wn * (192 + 128) * 2 + 8 * (8 + 4 * stages) + 8
    assert nbytes == 214152 <= SMEM_BYTES


def test_csrc_routes_the_same_head_dims():
    """The C entry takes the head dims ``WS_HEAD_DIMS`` names and refuses
    others; ``ws_route`` sends bf16 there alone, by dtype and head dims,
    and every other pair keeps its route."""
    src = CSRC.read_text()
    body = re.search(r"const bool routed = (.*?);", src, re.S).group(1)
    pairs = {(int(a), int(b)) for a, b in re.findall(r"dk == (\d+) && dv == (\d+)", body)}
    assert pairs == set(WS_HEAD_DIMS) == {(192, 128)}
    for d, dv in HEAD_DIMS:
        assert ws_route(torch.bfloat16, d, dv) == ((d, dv) in WS_HEAD_DIMS)
        assert not ws_route(torch.float32, d, dv)
        if ws_route(torch.bfloat16, d, dv):
            assert tma_route(torch.bfloat16, d, dv)


def _jax_lse(q, k, causal: bool, window: int) -> np.ndarray:
    """Each row's logsumexp of the scaled visible scores, (B, H, S), masked
    as ``repro.models.layers.mha`` masks them."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qh = jnp.asarray(q).reshape(b, s, kvh, h // kvh, d)
    scores = jnp.einsum("bqkgd,bskd->bkgqs", qh, jnp.asarray(k)) / math.sqrt(d)
    qpos, kpos = jnp.arange(s)[:, None], jnp.arange(s)[None, :]
    mask = jnp.ones((s, s), dtype=bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    lse = jax.nn.logsumexp(jnp.where(mask, scores, -jnp.inf), axis=-1)
    return np.asarray(lse.reshape(b, h, s))


@pytest.mark.parametrize("h,kv,window", [(13, 13, 0), (8, 2, 40)])
@pytest.mark.parametrize("s", [64, 100, 200])
def test_plain_version_and_lse_match_blockwise_mha(s, h, kv, window):
    """The port's plain forward and its row logsumexp at (192, 128)
    against the JAX package's blockwise_mha (and a jnp logsumexp under its
    mask) in fp32 at 1e-4: S 64, 100 and 200 (a 128-row block's second
    half empty, partial), 13 heads (not a multiple of the block order's
    groups), GQA over 2 kv heads with a window of 40."""
    rng = np.random.default_rng(s + h + window)
    q = rng.standard_normal((1, s, h, 192), dtype=np.float32)
    k = rng.standard_normal((1, s, kv, 192), dtype=np.float32)
    v = rng.standard_normal((1, s, kv, 128), dtype=np.float32)
    want = np.asarray(jax_blockwise_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=True, window=window))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_attention_ref(tq, tk, tv, causal=True, window=window)
    assert got.shape == (1, s, h, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    lse = flash_attention_lse_ref(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, True, window), rtol=TOL, atol=TOL)
