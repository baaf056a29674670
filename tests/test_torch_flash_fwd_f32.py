"""The fp32 flash forward's register-tiled kernel, as far as the CPU can
hold it: its decomposition, its tiles, its route and its entry.

fp32 at every head-dim pair up to 256 takes one kernel of
``csrc/flash_attention_fwd_f32.cu`` (route kind "f32",
``kernels/flash_attention.py:route``, which the backward shares): blocks of
q rows over the kv tiles they see, streamed in stages, an online softmax in
base 2, templated on a bucket of widths with the columns past the real dims
zero.  ``kernels/ref.py:flash_attention_fwd_tiled_ref`` mirrors that
decomposition; here it is held against the JAX package's Pallas kernel
``flash_attention_bh`` in interpret mode and against
``repro.models.layers.blockwise_mha`` on the same numpy inputs at fp32's
1e-4, its lse against a logsumexp of the JAX scores.  ``fwd_f32_tiles``
states the tiles and their shared bytes, which the C source must state
alike.  The kernel itself is held to the plain versions on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import math
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bh as jax_flash_bh
from repro.models.layers import blockwise_mha as jax_blockwise_mha
from repro_torch.kernels import flash_attention as flash_launcher
from repro_torch.kernels.flash_attention import (F32_BUCKETS, F32_FWD_TILES, bwd_route,
                                                 f32_bucket, fwd_f32_tiles, route)
from repro_torch.kernels.ref import (flash_attention_fwd_tiled_ref, flash_attention_lse_ref,
                                     flash_attention_ref)

# fp32: the same function summed in another order
TOL = 1e-4
# shared memory one block can use on the H100
SMEM_BYTES = 232448
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
HEAD_DIMS = [(16, 16), (24, 16), (40, 40), (64, 64), (80, 80), (128, 128), (192, 128),
             (256, 256)]
# (H, KV, S, window): MHA, GQA and one kv head; causal throughout, a window,
# ragged S 100 and 130
LAYOUTS = [(4, 4, 100, 0), (4, 2, 130, 48), (4, 1, 130, 0)]


def _inputs(b, s, h, kv, d, dv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, dv))]


def _pallas(q, k, v, window):
    """The Pallas kernel in interpret mode on (B, S, H, D) inputs: heads
    folded, GQA expanded, v zero-padded to q's width where it is narrower
    (the kernel takes one head dim) and the output cut back to v's."""
    b, s, h, d = q.shape
    kv, dv = k.shape[2], v.shape[3]
    k, v = (np.repeat(t, h // kv, axis=2) for t in (k, v))
    v = np.pad(v, ((0, 0), (0, 0), (0, 0), (0, d - dv)))

    def fold(t):
        return jnp.asarray(t.transpose(0, 2, 1, 3).reshape(b * h, s, d))

    out = jax_flash_bh(fold(q), fold(k), fold(v), causal=True, window=window, interpret=True)
    return np.asarray(out).reshape(b, h, s, d).transpose(0, 2, 1, 3)[..., :dv]


def _jax_lse(q, k, window):
    """Each row's logsumexp of the scaled visible scores, in JAX: (B, H, S)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    kj = jnp.repeat(jnp.asarray(k), h // kv, axis=2)
    scores = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kj) / math.sqrt(d)
    pos = jnp.arange(s)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    return jax.nn.logsumexp(jnp.where(mask, scores, -jnp.inf), axis=-1)


def _scaled_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.float().numpy() - want) / (1 + np.abs(want))))


def _tiled(q, k, v, causal=True, window=0):
    """The mirror at the kernel's own tiles."""
    t = fwd_f32_tiles(q.shape[3], v.shape[3])
    return flash_attention_fwd_tiled_ref(q, k, v, causal=causal, window=window, rows=t.rows,
                                         stream_rows=t.stream_rows, widths=t.dims)


@pytest.mark.parametrize("h,kv,s,window", LAYOUTS)
@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_tiled_decomposition_matches_jax(d, dv, h, kv, s, window):
    """o of the fp32 kernel's decomposition (its bucket's zero-padded
    columns, q blocks and kv tiles, the base-2 online softmax) against the
    Pallas kernel in interpret mode and the JAX package's attention, and
    its lse against the JAX scores' logsumexp, at fp32's 1e-4."""
    q, k, v = _inputs(2, s, h, kv, d, dv, seed=d + 7 * dv + s + window + kv)
    o, lse = _tiled(*(torch.from_numpy(a) for a in (q, k, v)), window=window)
    assert o.shape == (2, s, h, dv) and o.dtype == torch.float32
    assert lse.shape == (2, h, s) and lse.dtype == torch.float32
    assert _scaled_err(o, _pallas(q, k, v, window)) <= TOL
    want = jax_blockwise_mha(*(jnp.asarray(a) for a in (q, k, v)), causal=True, window=window)
    assert _scaled_err(o, want) <= TOL
    assert _scaled_err(lse, _jax_lse(q, k, window)) <= TOL


@pytest.mark.parametrize("d,dv", [(64, 64), (80, 80), (5, 3)])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 16)])
def test_tiled_decomposition_off_the_causal_square(d, dv, causal, window):
    """Sk != S (cross-attention over more keys, fewer keys than queries),
    unmasked and windowed: the mirror against the plain version and its
    lse at 1e-4."""
    for s, sk in ((64, 200), (130, 70)):
        q, _, _ = _inputs(1, s, 4, 2, d, dv, seed=s + sk)
        _, k, v = _inputs(1, sk, 4, 2, d, dv, seed=s * sk)
        q, k, v = (torch.from_numpy(a) for a in (q, k, v))
        o, lse = _tiled(q, k, v, causal=causal, window=window)
        vis = torch.isfinite(lse)   # rows with a visible key
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        assert _scaled_err(o[vis.transpose(1, 2)], want[vis.transpose(1, 2)]) <= TOL
        want_lse = flash_attention_lse_ref(q, k, v, causal=causal, window=window)
        assert torch.equal(vis, torch.isfinite(want_lse))
        assert _scaled_err(lse[vis], want_lse[vis]) <= TOL


def test_rows_with_no_visible_key():
    """Sk < S under a causal window: rows past Sk + window - 1 see no key.
    Their lse is -inf; a block that visits kv tiles weighs each slot of
    them 1 (zero rows past Sk), a block that visits none writes zeros."""
    s, sk, window = 200, 40, 16
    q, _, _ = _inputs(1, s, 2, 1, 64, 64, seed=5)
    _, k, v = _inputs(1, sk, 2, 1, 64, 64, seed=6)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    t = fwd_f32_tiles(64, 64)
    o, lse = _tiled(q, k, v, window=window)
    dead = torch.arange(s) >= sk + window - 1
    assert torch.isinf(lse[..., dead]).all() and torch.isfinite(lse[..., ~dead]).all()
    for q0 in range(0, s, t.rows):
        rows = torch.arange(q0, min(s, q0 + t.rows))
        lo, hi = max(0, q0 - window + 1), min(sk, q0 + t.rows)
        for r in rows[dead[rows]]:
            if hi <= lo:   # no tile: zeros
                assert not o[0, r].any()
                continue
            k0, k1 = lo // t.stream_rows * t.stream_rows, -(-hi // t.stream_rows) * t.stream_rows
            want = v[0, k0:min(k1, sk), 0].sum(0) / (k1 - k0)
            torch.testing.assert_close(o[0, r, 0], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bucket", F32_BUCKETS)
def test_f32_fwd_tiles_fit_shared_memory(bucket):
    """Each bucket's tiles fit the 232,448 bytes a block can use: Q of 128
    rows (64 at D 256), two or three stages of K and V, the score tile (two
    partial sums where a stage is 32 rows), each row's alpha and l; rows
    padded by 4 floats, the score rows by 8; the score and output grids
    divide the tiles."""
    t = fwd_f32_tiles(*bucket)
    rows, stream = F32_FWD_TILES[bucket]
    assert t.dims == bucket and (t.rows, t.stream_rows) == (rows, stream)
    assert rows == (64 if bucket == (256, 256) else 128)

    def nbytes(n):
        bk, bv = bucket
        return 4 * (rows * (bk + 4) + n * stream * (bk + bv + 8) + t.dsplit * rows * (stream + 8)
                    + 2 * rows)

    assert t.smem_bytes == nbytes(t.stages) <= SMEM_BYTES
    assert t.stages == (3 if nbytes(3) <= SMEM_BYTES else 2)
    assert t.dsplit == (2 if stream == 32 else 1)
    # 256 threads: DSPLIT groups of 8 x 4 score micro-tiles (4 x 4 at D
    # 256), a warp 4 rows by 8 columns
    group = 256 // t.dsplit
    tac = stream // 4
    assert tac % 8 == 0 and group % tac == 0 and (group // tac) % 4 == 0
    assert rows * stream // group == (16 if bucket == (256, 256) else 32)
    # the output tile: 4 columns a chunk, 8 or 16 chunk-threads a row
    tbc = 8 if bucket[1] % 64 else 16
    assert bucket[1] % (4 * tbc) == 0 and rows % (256 // tbc) == 0
    # the softmax: 4 threads a row, whole float4s each
    assert 256 % rows == 0 and stream % (4 * (256 // rows)) == 0


def test_csrc_states_the_same_tiles():
    """The C source's bucket table, pads, threads and shared-byte formula
    (the pad and threads in the header the fp32 kernels share) are the
    launcher's."""
    src = (CSRC / "flash_attention_fwd_f32.cu").read_text()
    assert '#include "flash_attention_f32.cuh"' in src
    src += (CSRC / "flash_attention_f32.cuh").read_text()
    table = re.search(r"constexpr int BUCKETS\[5\]\[4\] = \{(.*?)\};", src, re.S).group(1)
    rows = [tuple(int(x) for x in m)
            for m in re.findall(r"\{(\d+), (\d+), (\d+), (\d+)\}", table)]
    assert [r[:2] for r in rows] == list(F32_BUCKETS)
    assert {r[:2]: r[2:] for r in rows} == F32_FWD_TILES
    for line in ("constexpr int THREADS = 256;", "constexpr int PAD = 4;",
                 "constexpr int SPAD = 8;", "DSPLIT = RS == 32 ? 2 : 1;",
                 "return 4 * (RR * LK + stages * STAGE + SCORES + 2 * RR);",
                 "STAGES = bytes(3) <= BLOCK_SMEM ? 3 : 2;", "SCORES = DSPLIT * RR * LP;",
                 "LK = DKB + PAD, LV = DVB + PAD, LP = RS + SPAD;",
                 "constexpr size_t BLOCK_SMEM = 232448;",
                 "__launch_bounds__(THREADS, 1) flash_fwd_f32_tiled"):
        assert line in src, line
    assert (flash_launcher.F32_PAD, flash_launcher.F32_SCORE_PAD) == (4, 8)
    assert flash_launcher.SMEM_BYTES == SMEM_BYTES


@pytest.mark.parametrize("dk,dv", HEAD_DIMS + [(1, 1), (5, 3), (8, 8), (20, 20), (96, 64),
                                               (97, 97), (128, 64), (144, 64), (160, 128),
                                               (193, 128), (200, 136), (72, 256), (256, 1)])
def test_fp32_takes_the_f32_route(dk, dv):
    """fp32 at every pair: kind "f32", its bucket the first of F32_BUCKETS
    that holds both dims, by dtype and dims alone; the backward's route is
    the forward's in every dtype."""
    r = route(torch.float32, dk, dv)
    assert r.kind == "f32" and r.dims == f32_bucket(dk, dv) == fwd_f32_tiles(dk, dv).dims
    earlier = F32_BUCKETS[:F32_BUCKETS.index(r.dims)]
    assert not any(dk <= sk and dv <= sv for sk, sv in earlier)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        assert bwd_route(dtype, dk, dv) == route(dtype, dk, dv)
    assert f32_bucket(80, 80) == (96, 96) and f32_bucket(40, 40) == (64, 64)


@pytest.fixture
def recorded(monkeypatch):
    """Fake libraries: every C entry records (entry, argtypes, args) and
    returns ``state.ret``; the launcher's CUDA checks are skipped."""
    from repro_torch.kernels import build

    state = types.SimpleNamespace(calls=[], ret=0)

    class Entry:
        argtypes = restype = None

        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            state.calls.append((self.name, self.argtypes, args))
            return state.ret

    class Lib:
        def __getattr__(self, entry):
            fn = Entry(entry)
            setattr(self, entry, fn)
            return fn

    libs = {}
    monkeypatch.setattr(build, "library", lambda name: libs.setdefault(name, Lib()))
    monkeypatch.setattr(flash_launcher, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return state


def _fwd(b, s, h, kv, d, dv, **kw):
    q = torch.zeros(b, s, h, d)
    k, v = torch.zeros(b, s, kv, d), torch.zeros(b, s, kv, dv)
    return flash_launcher.flash_attention_cuda(q, k, v, causal=True, window=0, **kw)


@pytest.mark.parametrize("b,s,h,kv,d,dv", [(1, 70, 4, 2, 64, 64), (1, 70, 4, 2, 80, 80),
                                           (2, 100, 4, 1, 256, 256), (1, 70, 4, 4, 192, 128),
                                           (1, 70, 4, 2, 5, 3), (1, 70, 4, 2, 16, 16),
                                           (1, 70, 4, 2, 24, 16)])
@pytest.mark.parametrize("lse", [False, True])
def test_fp32_forward_calls_its_entry_with_every_argument(recorded, b, s, h, kv, d, dv, lse):
    """fp32 at a built pair, inside a bucket, at the smoke dims or at dims
    not a multiple of 4: one call of ``flash_attention_fwd_f32`` with as
    many arguments as its argtypes, the real dims, dtype code 0 and the lse
    buffer where one is asked for."""
    out = _fwd(b, s, h, kv, d, dv, return_lse=lse)
    o = out[0] if lse else out
    assert o.shape == (b, s, h, dv)
    if lse:
        assert out[1].shape == (b, h, s) and out[1].dtype == torch.float32
    [(entry, argtypes, args)] = recorded.calls
    assert entry == "flash_attention_fwd_f32" and len(args) == len(argtypes) == 16
    assert args[4:14] == (b, s, s, h, kv, d, dv, 1, 0, 0)
    assert (args[15] is None) == (not lse)


@pytest.mark.parametrize("code", [-1, 1, 700])
def test_a_failed_fp32_forward_raises_without_another_route(recorded, code):
    """The fp32 entry failing raises; no other entry is called."""
    recorded.ret = code
    with pytest.raises(RuntimeError, match="flash_attention"):
        _fwd(1, 70, 4, 2, 80, 80)
    assert [c[0] for c in recorded.calls] == ["flash_attention_fwd_f32"]


def test_fp32_forward_takes_one_tile(recorded):
    """The fp32 kernel has one tile: a named kv tile is refused, as on every
    SIMT route, and nothing is launched."""
    with pytest.raises(ValueError, match="one tile"):
        _fwd(1, 70, 4, 2, 64, 64, kv_tile=64)
    assert recorded.calls == []


def test_old_fp32_forward_instantiations_are_gone():
    """No fp32 forward kernel is left in the SIMT sources: the SIMT kernel
    of flash_attention.cu is instantiated for the bf16 smoke dims alone,
    the four-threads-a-row kernel is gone, its C entry refuses dtype code
    0, and no flash source builds a general SIMT kernel or fp32 outside the
    register-tiled sources."""
    fa = (CSRC / "flash_attention.cu").read_text()
    assert "flash_fwd_f32_wide" not in fa and "launch_f32" not in fa
    assert "if (dtype != 1) return (int)cudaErrorInvalidValue;" in fa
    assert re.findall(r"flash_fwd_f32<DK, DV, (\w+)>", fa) == ["__nv_bfloat16"]
    for src in sorted(CSRC.glob("flash_attention*.c*")):   # no general SIMT kernel is left
        text = src.read_text()
        assert "_any" not in text and "launch_fwd<float>" not in text, src.name
    cuh = (CSRC / "flash_attention_fwd.cuh").read_text()
    assert "PARTS" not in cuh and "TN_WIDE" not in cuh


def test_ops_counts_the_fp32_forward():
    """``flash_attention.f32_launches`` exists beside the backward's count
    and the forward's route counter names it."""
    from repro_torch.kernels import ops

    assert ops.flash_attention.f32_launches >= 0 and ops.flash_attention.bwd_f32_launches >= 0
    before = ops.flash_attention.f32_launches
    ops._count_route(ops.flash_attention, "", route(torch.float32, 80, 80).kind)
    assert ops.flash_attention.f32_launches == before + 1
    ops.flash_attention.f32_launches = before
