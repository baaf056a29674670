"""The staged flash route, as far as the CPU can hold it: its function, its
route and its launches.

bf16 and fp16 at head dims that are not multiples of 8 take route kind
"stage" (``kernels/flash_attention.py:route``): Q, K and V (in the backward
also O and dO) are copied into buffers whose rows are each head dim
rounded up to a multiple of 8, the columns past it zero, by one launch of
``csrc/flash_attention_stage.cu``; the bucket's wgmma + TMA entries (the
padded bf16 ones, the fp16 ones, ``flash_attention_fwd_ws`` in the (192,
128) bucket) run at those pitches with the real q/k dim for the scale; and
the outputs are copied back at the real dims.
``kernels/ref.py:flash_attention_staged_ref`` mirrors that function
(zero-padded to the pitch and the bucket, the real scale, a row with no
visible key zero, cut back); here it is held against the JAX package's
Pallas kernel ``flash_attention_bh`` in interpret mode and against
``repro.models.layers.blockwise_mha`` on the same numpy inputs at fp32's
1e-4, its gradient against ``jax.grad`` of ``blockwise_mha``.  Through a
fake library that copies as the staging kernel does, the entries'
arguments: the pitched buffers, their layouts, the scale's head dim, the
bucket, the outputs, and a failed launch.  The kernels themselves are held
to the mirror on the card by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bh as jax_flash_bh
from repro.models.layers import blockwise_mha as jax_blockwise_mha
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as flash_launcher
from repro_torch.kernels.flash_attention import (BUCKETS, KV_TILES, TC_KINDS, bucket,
                                                 bwd_scratch_rows, kv_tiles, pitch, route,
                                                 tma_route, ws_route)
from repro_torch.kernels.ref import flash_attention_ref, flash_attention_staged_ref

# fp32: the same function summed in another order
TOL = 1e-4
# (q/k, v) head dims that are not multiples of 8, one or more in each bucket:
# (64, 64) (D 20, (5, 3), (12, 20): v wider than q/k), (128, 128) ((72,
# 36)), (192, 128) ((130, 100) at pitches (136, 104)), (256, 256) ((250,
# 250) at pitch 256)
HEAD_DIMS = [(20, 20), (5, 3), (12, 20), (72, 36), (130, 100), (250, 250)]
# (H, KV, S, causal, window): MHA causal, GQA under a window, MQA over a
# ragged S, GQA unmasked
LAYOUTS = [(4, 4, 100, True, 0), (4, 2, 130, True, 48), (4, 1, 130, True, 0),
           (4, 2, 70, False, 0)]


def _inputs(b, s, sk, h, kv, d, dv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, h, d), (b, sk, kv, d), (b, sk, kv, dv), (b, s, h, dv))]


def _pallas(q, k, v, causal, window):
    """The Pallas kernel in interpret mode on (B, S, H, D) inputs: heads
    folded, GQA expanded, v zero-padded to q's width (the kernel takes one
    head dim, v no wider than q) and the output cut back to v's."""
    b, s, h, d = q.shape
    kv, dv = k.shape[2], v.shape[3]
    k, v = (np.repeat(t, h // kv, axis=2) for t in (k, v))
    v = np.pad(v, ((0, 0), (0, 0), (0, 0), (0, d - dv)))

    def fold(t):
        return jnp.asarray(t.transpose(0, 2, 1, 3).reshape(b * h, t.shape[1], d))

    out = jax_flash_bh(fold(q), fold(k), fold(v), causal=causal, window=window, interpret=True)
    return np.asarray(out).reshape(b, h, s, d).transpose(0, 2, 1, 3)[..., :dv]


def _scaled_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.detach().float().numpy() - want) / (1 + np.abs(want))))


def _staged(q, k, v, **kw):
    """The mirror at the route's bucket."""
    return flash_attention_staged_ref(q, k, v, widths=route(torch.bfloat16, q.shape[3],
                                                             v.shape[3]).dims, **kw)


# -- the function ---------------------------------------------------------------


@pytest.mark.parametrize("h,kv,s,causal,window", LAYOUTS)
@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_staged_mirror_matches_jax(d, dv, h, kv, s, causal, window):
    """o of the staged function (zero columns to the pitch and the bucket,
    the real q/k dim's scale, cut back) against the Pallas kernel in
    interpret mode (where v is no wider than q and k) and the JAX package's
    attention, at fp32's 1e-4."""
    q, k, v, _ = _inputs(2, s, s, h, kv, d, dv, seed=d + 7 * dv + s + window + kv)
    o = _staged(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal, window=window)
    assert o.shape == (2, s, h, dv) and o.dtype == torch.float32
    want = jax_blockwise_mha(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                             window=window)
    assert _scaled_err(o, want) <= TOL
    if dv <= d:
        assert _scaled_err(o, _pallas(q, k, v, causal, window)) <= TOL


@pytest.mark.parametrize("h,kv,s,causal,window", LAYOUTS)
@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_staged_mirror_gradient_matches_jax_grad(d, dv, h, kv, s, causal, window):
    """dq, dk, dv by autograd of the staged function against ``jax.grad`` of
    the JAX package's attention on the same inputs, at fp32's 1e-4: the
    zero columns add nothing to any gradient, and the columns cut away
    carry none."""
    arrays = _inputs(1, s, s, h, kv, d, dv, seed=3 * d + dv + s + kv)
    q, k, v, do = (jnp.asarray(a) for a in arrays)

    def f(q, k, v):
        return jnp.sum(jax_blockwise_mha(q, k, v, causal=causal, window=window) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays[:3]]
    got = torch.autograd.grad(_staged(*leaves, causal=causal, window=window), leaves,
                              torch.from_numpy(arrays[3]))
    for g, w, leaf in zip(got, want, leaves):
        assert g.shape == leaf.shape
        assert _scaled_err(g, w) <= TOL


@pytest.mark.parametrize("d,dv", [(20, 20), (5, 3), (130, 100)])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 16)])
def test_staged_mirror_off_the_causal_square(d, dv, causal, window):
    """Sk != S (cross-attention over more keys, fewer keys than queries),
    unmasked and windowed: the mirror and its gradient against the plain
    version on the rows that see a key, at 1e-4."""
    for s, sk in ((64, 200), (130, 70)):
        q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, s, sk, 4, 2, d, dv, seed=s + sk))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = _staged(*leaves, causal=causal, window=window)
        plain = [t.clone().requires_grad_() for t in (q, k, v)]
        want = flash_attention_ref(*plain, causal=causal, window=window)
        pos = torch.arange(s)[:, None] - torch.arange(sk)[None, :]
        vis = torch.ones(s, sk, dtype=torch.bool)
        if causal:
            vis &= pos >= 0
        if window:
            vis &= pos < window
        rows = vis.any(1)
        assert _scaled_err(o[:, rows], want[:, rows].detach()) <= TOL
        mask = rows[None, :, None, None].float()   # the gradient of the rows that see a key
        got = torch.autograd.grad(o, leaves, do * mask)
        ref = torch.autograd.grad(want, plain, do * mask)
        for g, r in zip(got, ref):
            assert _scaled_err(g, r) <= TOL


def test_rows_with_no_visible_key():
    """Sk < S under a causal window: rows past Sk + window - 1 see no key.
    The staged route writes zeros there and passes no gradient through
    them, as the wgmma kernels do; the plain version (as the Pallas kernel)
    weighs every key alike there."""
    s, sk, window = 200, 40, 16
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, s, sk, 4, 2, 20, 12, seed=5))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = _staged(*leaves, causal=True, window=window)
    dead = torch.arange(s) >= sk + window - 1
    assert dead.any() and not o[:, dead].any()
    plain = flash_attention_ref(q, k, v, causal=True, window=window)
    mean = v.repeat_interleave(2, dim=2).mean(1, keepdim=True)       # (1, 1, H, Dv)
    assert torch.allclose(plain[:, dead], mean.expand_as(plain[:, dead]), atol=1e-5)
    dq, _, _ = torch.autograd.grad(o, leaves, do)
    assert torch.isfinite(dq).all() and not dq[:, dead].any()


# -- the route ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_every_head_dim_routes_to_the_wgmma_kernels(dtype):
    """dk, dv over 1..256: no flash call routes to a general kernel.  Head
    dims that are not multiples of 8 stage, on the bucket of their pitches
    (``bucket(pitch(dk), pitch(dv))``); fp16 at multiples of 8 (the smoke
    dims among them) takes "f16"; bf16 keeps "tma" at the built pairs,
    "simt" at the smoke dims and "pad" elsewhere.  Every one but bf16's
    smoke dims is a tensor-core route with its bucket's kv tiles and
    scratch rows; (192, 128) is the MLA kernel's."""
    kinds = set()
    for dk in range(1, 257):
        for dv in range(1, 257):
            r = route(dtype, dk, dv)
            kinds.add(r.kind)
            if dk % 8 or dv % 8:
                assert r == ("stage", bucket(pitch(dk), pitch(dv)))
            elif dtype == torch.float16:
                assert r == ("f16", bucket(dk, dv))
            elif (dk, dv) in BUCKETS:
                assert r == ("tma", (dk, dv))
            elif (dk, dv) in {(16, 16), (24, 16)}:
                assert r == ("simt", (dk, dv))
                continue
            else:
                assert r == ("pad", bucket(dk, dv))
            assert r.dims in BUCKETS and dk <= r.dims[0] and dv <= r.dims[1]
            assert r.kind in TC_KINDS and tma_route(dtype, dk, dv)
            assert ws_route(dtype, dk, dv) == (r.dims == (192, 128))
            assert kv_tiles(dk, dv) == KV_TILES[r.dims]
    assert "any" not in kinds and "stage" in kinds


@pytest.mark.parametrize("dk,dv,pitches,dims", [
    (20, 20, (24, 24), (64, 64)), (5, 3, (8, 8), (64, 64)), (12, 20, (16, 24), (64, 64)),
    (72, 36, (72, 40), (128, 128)), (130, 100, (136, 104), (192, 128)),
    (250, 250, (256, 256), (256, 256)), (100, 130, (104, 136), (256, 256)),
    (63, 64, (64, 64), (64, 64)), (190, 128, (192, 128), (192, 128))])
def test_pitches_and_buckets(dk, dv, pitches, dims):
    """The pitch is each head dim rounded up to a multiple of 8, the bucket
    the smallest built pair that holds both pitches; the backward's Delta /
    lse scratch is padded to the bucket's dQ block."""
    assert (pitch(dk), pitch(dv)) == pitches
    for dtype in (torch.bfloat16, torch.float16):
        assert route(dtype, dk, dv) == ("stage", dims)
        assert bwd_scratch_rows(1000, dtype, dk, dv) == bwd_scratch_rows(1000, dtype, *dims)
    assert bwd_scratch_rows(1000, torch.bfloat16, 130, 100) == 1024   # 128-row dQ blocks


@pytest.mark.parametrize("dims", [(0, 8), (8, 0), (257, 8), (8, 300)])
def test_no_route_past_the_limits(dims):
    with pytest.raises(ValueError, match="no route"):
        route(torch.bfloat16, *dims)


# -- the launches, through a fake library -----------------------------------------


class _Lib:
    """A loaded library whose every C entry records (entry, argtypes, args)
    and returns ``state.ret`` (or ``state.fail[entry]``).  Its staging entry
    copies as csrc/flash_attention_stage.cu does, on the host memory the
    CPU tensors' pointers name; each attention entry also records the
    pitched q, k and v (and dO) it was given, read at the call."""

    def __init__(self, state):
        self.state = state

    def __getattr__(self, entry):
        state = self.state

        class Entry:
            argtypes = restype = None

            def __call__(self, *args):
                state.calls.append((entry, self.argtypes, args))
                ret = state.fail.get(entry, 0)
                if ret:
                    return ret
                if entry == "flash_attention_stage":
                    _copy_rows(list(args[0]), args[1])
                else:
                    state.seen.append(_read_inputs(entry, args))
                return 0

        fn = Entry()
        setattr(self, entry, fn)
        return fn


def _copy_rows(jobs, n):
    """csrc/flash_attention_stage.cu's copies on host memory: each row of
    dst gets src's first min(ws, wd) 2-byte elements and zeros past ws."""
    for i in range(n):
        src, dst, rows, ws, wd = jobs[5 * i:5 * i + 5]
        a = np.ctypeslib.as_array((ctypes.c_uint16 * (rows * ws)).from_address(src))
        out = np.ctypeslib.as_array((ctypes.c_uint16 * (rows * wd)).from_address(dst))
        out = out.reshape(rows, wd)
        out[:] = 0
        w = min(ws, wd)
        out[:, :w] = a.reshape(rows, ws)[:, :w]


# where each entry takes its TMA layouts
_LAYOUT_AT = {"flash_attention_fwd_pad": 16, "flash_attention_fwd_f16": 17,
              "flash_attention_fwd_ws": 14, "flash_attention_fwd_ws_f16": 15,
              "flash_attention_bwd_pad": 22, "flash_attention_bwd_f16": 23}


def _read_inputs(entry, args):
    """The 2-byte buffers an attention entry was given, as (pointer, uint16
    rows of the layout's width, the layout's 11 values): q, k, v (and dO in
    the backward, whose layouts are q's, k's, v's and dO's)."""
    vals = list(args[_LAYOUT_AT[entry]])
    ptrs = (args[0], args[1], args[2], args[4]) if "bwd" in entry else args[:3]
    out = []
    for j, ptr in enumerate(ptrs):
        d, hh, s, b = vals[11 * j:11 * j + 4]
        n = d * hh * s * b
        rows = np.ctypeslib.as_array((ctypes.c_uint16 * n).from_address(ptr)).reshape(-1, d)
        out.append((ptr, rows.copy(), vals[11 * j:11 * j + 11]))
    return out


@pytest.fixture
def fake(monkeypatch):
    state = types.SimpleNamespace(calls=[], seen=[], fail={})
    libs = {}
    monkeypatch.setattr(build, "library", lambda name: libs.setdefault(name, _Lib(state)))
    monkeypatch.setattr(flash_launcher, "_check", lambda *a: None)
    monkeypatch.setattr(flash_launcher, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return state


def _tensors(b, s, h, kv, dk, dv, dtype, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)
            for shape in ((b, s, h, dk), (b, s, kv, dk), (b, s, kv, dv), (b, s, h, dv))]


# where each entry takes its head dims (dk, dv and, but on the MLA kernel, the
# bucket) and, last, the scale's head dim
_DIMS_AT = {"flash_attention_fwd_pad": 9, "flash_attention_fwd_f16": 9,
            "flash_attention_fwd_ws": 9, "flash_attention_fwd_ws_f16": 9,
            "flash_attention_bwd_pad": 15, "flash_attention_bwd_f16": 15}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dk,dv", [(20, 20), (5, 3), (12, 20), (72, 36), (130, 100),
                                   (250, 250), (64, 20), (20, 64)])
def test_staged_launches_pass_pitched_buffers(fake, dk, dv, dtype):
    """Forward with lse and backward at B 1, S 70, H 4 over KV 2: a staging
    launch, the bucket's entry, a staging launch, each way, where a tensor
    of that side has a head dim that is not a multiple of 8.  The staging
    copies those tensors (the others go to the entry as they are); the
    entry gets contiguous, 16-byte
    aligned buffers at the pitches whose columns past the real dims are
    zero and whose others are the inputs', layouts at the pitches with
    byte strides that are multiples of 16, the pitches and the bucket as
    its dims, the real q/k dim for the scale; the outputs come back
    contiguous at the real dims, copied from the entry's pitched ones
    where those are wider."""
    q, k, v, do = _tensors(1, 70, 4, 2, dk, dv, dtype)
    r = route(dtype, dk, dv)
    pk, pv = pitch(dk), pitch(dv)
    o, lse = flash_launcher.flash_attention_cuda(q, k, v, causal=True, window=0,
                                                 return_lse=True)
    grads = flash_launcher.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True,
                                                    window=0)
    suffix = "_pad" if dtype == torch.bfloat16 else "_f16"
    fwd = ("flash_attention_fwd_ws" + ("" if dtype == torch.bfloat16 else "_f16")
           if r.dims == (192, 128) else "flash_attention_fwd" + suffix)
    stage, out_v = "flash_attention_stage", dv % 8 != 0
    names = [c[0] for c in fake.calls]
    assert names == [stage, fwd, *[stage] * out_v, stage, "flash_attention_bwd" + suffix,
                     stage]
    assert o.shape == (1, 70, 4, dv) and o.is_contiguous() and o.dtype == dtype
    for g, t in zip(grads, (q, k, v)):
        assert g.shape == t.shape and g.is_contiguous() and g.dtype == dtype
    for _, argtypes, args in fake.calls:
        assert len(args) == len(argtypes)
    calls = [c[2] for c in fake.calls]
    sa0, fa, ba, sa3 = calls[0], calls[1], calls[-2], calls[-1]
    sa1 = calls[2] if out_v else (None, 0)
    sa2 = calls[-3]

    def jobs(args):   # the staging jobs: (src, dst, rows, ws, wd)
        return [list(args[0])[5 * i:5 * i + 5] for i in range(args[1])]

    def staged(ts):   # the tensors of ``ts`` whose head dim is no multiple of 8
        return [t for t in ts if t.shape[-1] % 8]

    jobs_in, jobs_bwd, out_f, out_b = jobs(sa0), jobs(sa2), jobs(sa1), jobs(sa3)
    assert [j[0] for j in jobs_in] == [t.data_ptr() for t in staged((q, k, v))]
    assert [j[2:] for j in jobs_in] == [[t.numel() // t.shape[-1], t.shape[-1],
                                        pitch(t.shape[-1])] for t in staged((q, k, v))]
    assert [j[0] for j in jobs_bwd] == [t.data_ptr() for t in staged((q, k, v, o, do))]
    assert [j[3:] for j in jobs_bwd] == [[t.shape[-1], pitch(t.shape[-1])]
                                         for t in staged((q, k, v, o, do))]
    assert [j[1:] for j in out_f] == [[o.data_ptr(), 280, pv, dv]] * out_v
    assert [j[1] for j in out_b] == [g.data_ptr() for g in staged(grads)]
    assert [j[3:] for j in out_b] == [[pitch(g.shape[-1]), g.shape[-1]] for g in staged(grads)]
    # the entries: the staged buffers (or the inputs), their dims, the bucket and the scale
    dst = iter(j[1] for j in jobs_in)
    assert tuple(fa[:3]) == tuple(next(dst) if t.shape[-1] % 8 else t.data_ptr()
                                  for t in (q, k, v))
    assert fa[3] == (out_f[0][0] if out_v else o.data_ptr())
    dst = iter(j[1] for j in jobs_bwd)
    assert tuple(ba[:5]) == tuple(next(dst) if t.shape[-1] % 8 else t.data_ptr()
                                  for t in (q, k, v, o, do))
    src = iter(j[0] for j in out_b)
    assert tuple(ba[6:9]) == tuple(next(src) if g.shape[-1] % 8 else g.data_ptr()
                                   for g in grads)
    at = _DIMS_AT[fwd]
    assert fa[at:at + 2] == (pk, pv) and fa[-1] == dk
    if "ws" not in fwd:
        assert fa[at + 2:at + 4] == r.dims
    at = _DIMS_AT["flash_attention_bwd" + suffix]
    assert ba[at:at + 4] == (pk, pv, *r.dims) and ba[-1] == dk
    for seen, real in zip(fake.seen, ((q, k, v), (q, k, v, do))):
        for (ptr, buf, lay), t in zip(seen, real):
            assert ptr % 16 == 0
            d = t.shape[-1]
            assert lay[0] == pitch(d) and all(st % 16 == 0 for st in lay[4:7])
            assert lay[4] == 2 * pitch(d)        # contiguous rows at the pitch
            want = t.reshape(-1, d).view(torch.int16).numpy().view(np.uint16)
            assert np.array_equal(buf[:, :d], want) and not buf[:, d:].any()


@pytest.mark.parametrize("failing", ["flash_attention_stage", "flash_attention_fwd_f16",
                                     "flash_attention_bwd_f16"])
@pytest.mark.parametrize("code", [-1, 1, 700])
def test_a_failed_staged_launch_raises_without_another_entry(fake, failing, code):
    """A staging launch or an entry that fails (a tensor map not encoded, a
    CUDA error) raises; nothing after it is launched and no other entry is
    called."""
    fake.fail[failing] = code
    q, k, v, do = _tensors(1, 70, 4, 2, 20, 20, torch.float16)
    stage_fails = failing == "flash_attention_stage"
    if failing != "flash_attention_bwd_f16":
        with pytest.raises(RuntimeError, match="flash_attention"):
            flash_launcher.flash_attention_cuda(q, k, v, causal=True, window=0)
        assert [c[0] for c in fake.calls] == (["flash_attention_stage"] if stage_fails else
                                              ["flash_attention_stage", failing])
        fake.calls.clear()
    if failing != "flash_attention_fwd_f16":
        with pytest.raises(RuntimeError, match="flash_attention_bwd|staging"):
            flash_launcher.flash_attention_bwd_cuda(q, k, v, torch.zeros_like(do),
                                                    torch.zeros(1, 4, 70), do, causal=True,
                                                    window=0)
        assert [c[0] for c in fake.calls] == (["flash_attention_stage"] if stage_fails else
                                              ["flash_attention_stage", failing])


def test_fp16_staged_takes_the_default_tile_bf16_every_tile(fake):
    """The kv tile rule is the dtype's: bf16 staged takes its bucket's
    KV_TILES, fp16 the default alone; another tile raises before a launch."""
    q, k, v, _ = _tensors(1, 70, 4, 2, 20, 20, torch.float16)
    for tile in KV_TILES[(64, 64)][1:] + (32, 256):
        with pytest.raises(ValueError, match="kv tile"):
            flash_launcher.flash_attention_cuda(q, k, v, causal=True, window=0, kv_tile=tile)
    assert fake.calls == []
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    for tile in KV_TILES[(64, 64)]:
        flash_launcher.flash_attention_cuda(qb, kb, vb, causal=True, window=0, kv_tile=tile)
    tiles = [c[2][-2] for c in fake.calls if c[0] == "flash_attention_fwd_pad"]
    assert tiles == list(KV_TILES[(64, 64)])
    with pytest.raises(ValueError, match="kv tile"):
        flash_launcher.flash_attention_cuda(qb, kb, vb, causal=True, window=0, kv_tile=32)


def test_ops_counts_the_staged_route():
    """``stage_launches`` / ``bwd_stage_launches`` replace the general
    route's counters; the route counter names them."""
    from repro_torch.kernels import ops

    f = ops.flash_attention
    assert f.stage_launches >= 0 and f.bwd_stage_launches >= 0
    assert not hasattr(f, "any_launches") and not hasattr(f, "bwd_any_launches")
    before = (f.stage_launches, f.bwd_stage_launches)
    ops._count_route(f, "", route(torch.float16, 20, 20).kind)
    ops._count_route(f, "bwd_", route(torch.bfloat16, 5, 3).kind)
    assert (f.stage_launches, f.bwd_stage_launches) == (before[0] + 1, before[1] + 1)
    f.stage_launches, f.bwd_stage_launches = before
