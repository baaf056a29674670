"""The fp32 flash backward's register-tiled kernels, as far as the CPU can
hold them: their decomposition, their tiles, their route and their entry.

fp32 at every head-dim pair up to 256 takes two kernels of
``csrc/flash_attention_bwd_f32.cu`` (route kind "f32",
``kernels/flash_attention.py:bwd_route``): a dQ kernel over blocks of q
rows and a dK/dV kernel over blocks of kv rows, each streaming the other
side's rows in tiles, templated on a bucket of widths with the columns past
the real dims zero, and where few kv tiles would leave SMs idle each kv
tile's q heads cut into head shares whose fp32 partials are summed in
order.  ``kernels/ref.py:flash_attention_bwd_tiled_ref`` mirrors that
decomposition; here it is held against ``jax.grad`` of
``repro.models.layers.blockwise_mha`` on the same numpy inputs at fp32's
1e-4.  ``bwd_f32_tiles`` states the tiles and their shared bytes, which
the C source must state alike.  The kernels themselves are held to the
plain versions on the card by tests/test_torch_cuda.py and
``chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import blockwise_mha as jax_blockwise_mha
from repro_torch.kernels import flash_attention as flash_launcher
from repro_torch.kernels.flash_attention import (F32_BUCKETS, F32_SPLIT_WAVES,
                                                 F32_TILE_ROWS,
                                                 bwd_f32_head_shares, bwd_f32_tiles,
                                                 bwd_head_shares, bwd_route,
                                                 bwd_scratch_rows, f32_bucket, route)
from repro_torch.kernels.ref import (flash_attention_bwd_ref, flash_attention_bwd_tiled_ref,
                                     flash_attention_lse_ref, flash_attention_ref)

# fp32: the same function summed in another order
TOL = 1e-4
# shared memory one block can use on the H100, and its SMs
SMEM_BYTES = 232448
H100_SMS = 132
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
HEAD_DIMS = [(16, 16), (24, 16), (40, 40), (64, 64), (80, 80), (128, 128), (192, 128),
             (256, 256)]
# (H, KV, S, window): MHA, GQA and one kv head; causal throughout, a window,
# ragged S 100 and 130
LAYOUTS = [(4, 4, 100, 0), (4, 2, 130, 48), (4, 1, 130, 0)]


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


def _tiled(q, k, v, do, window, shares=None):
    """The mirror at the kernels' own tiles and the plan's head shares."""
    kw = dict(causal=True, window=window)
    o = flash_attention_ref(q, k, v, **kw)
    lse = flash_attention_lse_ref(q, k, v, **kw)
    b, s, h, d = q.shape
    kv, dv = k.shape[2], v.shape[3]
    t = bwd_f32_tiles(d, dv)
    if shares is None:
        shares = bwd_f32_head_shares(b, kv, h // kv, k.shape[1], d, dv, H100_SMS)
    return flash_attention_bwd_tiled_ref(q, k, v, o, lse, do, rows=t.rows,
                                         stream_rows=t.stream_rows, widths=t.dims,
                                         shares=shares, **kw), (o, lse, shares)


@pytest.mark.parametrize("h,kv,s,window", LAYOUTS)
@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_tiled_decomposition_matches_jax_grad(d, dv, h, kv, s, window):
    """dQ, dK and dV of the fp32 kernels' decomposition (their bucket's
    zero-padded columns, q and kv tiles, the plan's head shares) against
    the gradient of the JAX package's attention at fp32's 1e-4."""
    arrays = _inputs(2, s, h, kv, d, dv, seed=d + 7 * dv + s + window + kv)
    want = _jax_grads(arrays, window)
    got, _ = _tiled(*(torch.from_numpy(a) for a in arrays), window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _scaled_err(g, w) <= TOL, (name, _scaled_err(g, w))


@pytest.mark.parametrize("d,dv", [(64, 64), (80, 80), (256, 256), (5, 3)])
def test_head_shares_only_change_the_order_of_a_sum(d, dv):
    """One kv head over 4 q heads in 1, 2, 3 and 4 head shares: the same
    gradients as the backward's formulas to fp32 rounding; dQ does not
    depend on the shares at all."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 70, 4, 1, d, dv, seed=3))
    (dq1, dk1, dv1), (o, lse, _) = _tiled(q, k, v, do, 0, shares=1)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do)
    for g, w in zip((dq1, dk1, dv1), want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    for n in (2, 3, 4):
        (dq, dk, dv_), _ = _tiled(q, k, v, do, 0, shares=n)
        assert torch.equal(dq, dq1)
        torch.testing.assert_close(dk, dk1, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dv_, dv1, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bucket", F32_BUCKETS)
def test_f32_tiles_fit_shared_memory(bucket):
    """Each bucket's two kernels fit the 232,448 bytes a block can use:
    resident rows of both operands, two or three stages of streamed rows
    with their lse and Delta rows, P^T and
    dS^T (P and dS; two partial sums each where a stage is 32 rows), rows
    padded by 4 floats; their rows divide into the micro-tiles of the
    scores (4 columns a thread)."""
    t = bwd_f32_tiles(*bucket)
    assert t.dims == bucket and (t.rows, t.stream_rows) == F32_TILE_ROWS[bucket]
    assert t.dkdv_smem_bytes <= SMEM_BYTES and t.dq_smem_bytes <= SMEM_BYTES
    assert t.rows % 16 == 0 and t.stream_rows % 16 == 0
    assert 128 * 4 % t.stream_rows == 0   # 128 threads a score tile, 4 columns each
    width = sum(bucket) + 8
    scores = 2 * (2 if t.stream_rows == 32 else 1) * t.rows * (t.stream_rows + 4)

    def nbytes(n):
        return (4 * ((t.rows + n * t.stream_rows) * width + scores + 2 * n * t.stream_rows),
                4 * ((t.rows + n * t.stream_rows) * width + scores + 2 * t.rows))

    assert (t.dkdv_smem_bytes, t.dq_smem_bytes) == nbytes(t.stages)
    # a third stage where both kernels fit it: D 64 and D 128
    assert t.stages == (3 if max(nbytes(3)) <= SMEM_BYTES else 2)
    assert (t.stages == 3) == (bucket in {(64, 64), (128, 128)})
    # D 256: 32-row tiles on both sides (dK and dV of 64 rows would be 128 KB)
    assert (t.rows == 32) == (bucket == (256, 256))


def test_csrc_states_the_same_tiles():
    """The C source's bucket table, pad, threads and shared-byte formulas
    (the pad and threads in the header the fp32 kernels share) are the
    launcher's: the launcher plans the head shares at its rows."""
    src = (CSRC / "flash_attention_bwd_f32.cu").read_text()
    assert '#include "flash_attention_f32.cuh"' in src
    src += (CSRC / "flash_attention_f32.cuh").read_text()
    table = re.search(r"constexpr int BUCKETS\[5\]\[4\] = \{(.*?)\};", src, re.S).group(1)
    rows = [tuple(int(x) for x in m) for m in re.findall(r"\{(\d+), (\d+), (\d+), (\d+)\}",
                                                          table)]
    assert [r[:2] for r in rows] == list(F32_BUCKETS)
    assert {r[:2]: r[2:] for r in rows} == F32_TILE_ROWS
    assert "constexpr int THREADS = 256;" in src and "constexpr int PAD = 4;" in src
    assert flash_launcher.F32_PAD == 4
    assert "DSPLIT = RS == 32 ? 2 : 1;" in src
    assert "SCORES = 2 * DSPLIT * RR * LP;" in src
    assert "return 4 * (RES + stages * STAGE + SCORES + stages * 2 * RS);" in src
    assert "return 4 * (RES + stages * STAGE + SCORES + 2 * RR);" in src
    assert ("STAGES = dkdv_bytes(3) <= 232448 && dq_bytes(3) <= 232448 ? 3 : 2;"
            in src)
    assert flash_launcher.SMEM_BYTES == SMEM_BYTES


def test_old_fp32_backward_instantiations_are_gone():
    """No fp32 backward kernel is left in the SIMT sources: the C entries
    there refuse dtype code 0, and only the bf16 smoke dims instantiate the
    one-warp-a-row kernels.  No flash source builds a general SIMT kernel,
    and none builds fp32 outside the register-tiled sources."""
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()
    assert "if (dtype != 1) return (int)cudaErrorInvalidValue;" in bwd
    assert not re.search(r"launch_simt<\d+, \d+, float>", bwd)
    assert "launch_simt_either" not in bwd
    for src in sorted(CSRC.glob("flash_attention*.c*")):
        text = src.read_text()
        assert "_any" not in text, src.name
        if "f32" not in src.name:
            assert not re.search(r"<float>|, float>", text), src.name


@pytest.mark.parametrize("dk,dv", HEAD_DIMS + [(1, 1), (5, 3), (8, 8), (20, 20), (96, 64),
                                               (97, 97), (128, 64), (144, 64), (160, 128),
                                               (193, 128), (200, 136), (72, 256), (256, 1)])
def test_fp32_backward_takes_the_f32_route(dk, dv):
    """fp32 backward: kind "f32" at every pair, its bucket the first of
    F32_BUCKETS that holds both dims; the fp32 forward's route is the same,
    and every bf16 and fp16 route, both directions, is what ``route``
    says."""
    r = bwd_route(torch.float32, dk, dv)
    assert r.kind == "f32" and r.dims == f32_bucket(dk, dv)
    bk, bv = r.dims
    assert dk <= bk and dv <= bv
    earlier = F32_BUCKETS[:F32_BUCKETS.index(r.dims)]
    assert not any(dk <= sk and dv <= sv for sk, sv in earlier)
    assert route(torch.float32, dk, dv) == r
    for dtype in (torch.bfloat16, torch.float16):
        assert bwd_route(dtype, dk, dv) == route(dtype, dk, dv)
    assert bwd_scratch_rows(100, torch.float32, dk, dv) == 128
    assert f32_bucket(80, 80) == (96, 96) and f32_bucket(192, 128) == (192, 128)


@pytest.mark.parametrize("case,b,s,h,kv,d,dv,shares", [
    ("fp32", 4, 1024, 32, 8, 64, 64, 1), ("fp32_d128", 2, 512, 32, 8, 128, 128, 2),
    ("recurrentgemma_train_fp32", 2, 1024, 16, 1, 256, 256, 4),
    ("mla_train_fp32", 1, 512, 128, 128, 192, 128, 1),
    ("phi2_d80_fp32", 4, 1024, 32, 32, 80, 80, 1)])
def test_head_share_plan_at_the_fp32_cases(case, b, s, h, kv, d, dv, shares):
    """chip_smoke.py's fp32 backward cases on the card's 132 SMs: the plan
    splits D 128's 128 and recurrentgemma's 64 kv tiles (one block an SM)
    until one wave is launched, in shares of equal heads (a divisor of the
    group: 2 of 4, 4 of 16), and keeps one share where blocks fill the
    card."""
    rows = bwd_f32_tiles(d, dv).rows
    group = h // kv
    assert bwd_f32_head_shares(b, kv, group, s, d, dv, H100_SMS) == shares
    assert group % shares == 0
    need = bwd_head_shares(b, kv, group, s, H100_SMS, rows, F32_SPLIT_WAVES)
    assert need <= shares and not any(group % n == 0 for n in range(need, shares))
    tiles = b * kv * -(-s // rows)
    assert shares == 1 or tiles * shares >= F32_SPLIT_WAVES * H100_SMS


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
    monkeypatch.setattr(flash_launcher, "_sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return state


def _bwd(b, s, h, kv, d, dv):
    q, do = (torch.zeros(b, s, h, n) for n in (d, dv))
    k, v = (torch.zeros(b, s, kv, n) for n in (d, dv))
    return flash_launcher.flash_attention_bwd_cuda(q, k, v, torch.zeros_like(do),
                                                   torch.zeros(b, h, s), do, causal=True,
                                                   window=0)


@pytest.mark.parametrize("b,s,h,kv,d,dv", [(1, 70, 4, 2, 64, 64), (1, 70, 4, 2, 80, 80),
                                           (2, 100, 4, 1, 256, 256), (1, 70, 4, 4, 192, 128),
                                           (1, 70, 4, 2, 5, 3), (1, 70, 4, 2, 16, 16)])
def test_fp32_backward_calls_its_entry_with_every_argument(recorded, b, s, h, kv, d, dv):
    """fp32 at a built pair, inside a bucket, at the smoke dims or at dims
    not a multiple of 4: one call of ``flash_attention_bwd_f32`` with as
    many arguments as its argtypes, dtype code 0, the real dims, the plan's
    head shares with a partial buffer where they are more than one, and
    the scratch's padded rows."""
    dq, dk, dv_ = _bwd(b, s, h, kv, d, dv)
    assert (dq.shape, dk.shape, dv_.shape) == ((b, s, h, d), (b, s, kv, d), (b, s, kv, dv))
    [(entry, argtypes, args)] = recorded.calls
    assert entry == "flash_attention_bwd_f32" and len(args) == len(argtypes) == 24
    assert args[10:20] == (b, s, s, h, kv, d, dv, 1, 0, 0)
    shares = bwd_f32_head_shares(b, kv, h // kv, s, d, dv, H100_SMS)
    assert args[22:] == (shares, bwd_scratch_rows(s, torch.float32, d, dv))
    assert (args[21] is None) == (shares == 1)


@pytest.mark.parametrize("code", [-1, 1, 700])
def test_a_failed_fp32_backward_raises_without_another_route(recorded, code):
    """The fp32 entry failing raises; no other entry is called."""
    recorded.ret = code
    with pytest.raises(RuntimeError, match="flash_attention_bwd"):
        _bwd(1, 70, 4, 2, 80, 80)
    assert [c[0] for c in recorded.calls] == ["flash_attention_bwd_f32"]


def test_the_fp32_forward_keeps_its_entries(recorded):
    """The fp32 forward at a built pair and off it: both on the register-
    tiled forward's entry (route kind "f32", dtype code 0), with the lse
    buffer where it is asked for; neither the SIMT nor the general entry."""
    q, k, v = torch.zeros(1, 70, 4, 64), torch.zeros(1, 70, 2, 64), torch.zeros(1, 70, 2, 64)
    flash_launcher.flash_attention_cuda(q, k, v, causal=True, window=0, return_lse=True)
    q, k, v = torch.zeros(1, 70, 4, 80), torch.zeros(1, 70, 2, 80), torch.zeros(1, 70, 2, 80)
    flash_launcher.flash_attention_cuda(q, k, v, causal=True, window=0)
    (f, _, fa), (a, _, aa) = recorded.calls
    assert (f, a) == ("flash_attention_fwd_f32", "flash_attention_fwd_f32")
    assert fa[9:11] == (64, 64) and aa[9:11] == (80, 80)
    assert fa[13] == 0 and aa[13] == 0
    assert fa[-1] is not None and aa[-1] is None
