"""The port's Mamba-2 SSD path against ``repro`` on the same inputs.

Inputs are drawn with numpy from a seed and handed to both packages;
JAX materializes the weights and ``repro_torch.bridge`` carries them
across.  Smoke size, fp32 unless stated: the block pieces, the chunked
scan and the model (forward, prefill, 16 decode steps) match at 2e-3,
the tolerance of tests/test_models.py.  ``ops.ssd_scan`` on CPU tensors
runs the kernel's plain version (``ref.ssd_ref``) and is held against
the Pallas kernel in interpret mode on tests/test_kernels.py's cases
(fp32 2e-3, bf16 5e-2).  The CUDA kernel itself is held against the
same plain version on the card by tests/test_torch_cuda.py and
``chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as JM
import repro.models.ssm as JSSM
import repro_torch.models.model as TM
import repro_torch.models.ssm as TSSM
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ssd_scan as jax_ssd_kernel
from repro.kernels.ref import ssd_ref as jax_ssd_ref
from repro.models import spec as JS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ALIASES, get_config, get_smoke_config
from repro_torch.kernels import build
from repro_torch.kernels import ops
from repro_torch.kernels.ops import SsdScan, ssd_scan
from repro_torch.kernels.ref import ssd_bwd_ref, ssd_ref
from repro_torch.kernels.flash_attention import tma_layout
from repro_torch.kernels import ssd_scan as ssd_launcher
from repro_torch.kernels.ssd_scan import (BWD_HEAD_GROUP, BWD_TILES, Y_ROWS, _layout_array,
                                          bwd_scratch, kernel_chunk, ssd_scan_bwd_cuda,
                                          ssd_scan_cuda, tma_layouts)
from repro_torch.models import spec as TS

ARCH = "mamba2_780m"
TOL = {"float32": 2e-3, "bfloat16": 5e-2}


def _close(got, want, tol=2e-3):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _ssd_inputs(b, l, h, p, n, g=None, seed=7):
    """Inputs drawn as tests/test_kernels.py draws them: dt = softplus(randn),
    a = -exp(0.3 randn), b, c = randn; ``g`` adds the group axis."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((b, l, h))).astype(np.float32)
    a = (-np.exp(0.3 * rng.standard_normal(h))).astype(np.float32)
    shape = (b, l, n) if g is None else (b, l, g, n)
    bm = rng.standard_normal(shape, dtype=np.float32)
    cm = rng.standard_normal(shape, dtype=np.float32)
    return x, dt, a, bm, cm


def _jx(arrays, dtype="float32"):
    return [jnp.asarray(x).astype(dtype) for x in arrays]


def _th(arrays, dtype="float32"):
    return [torch.from_numpy(np.asarray(x)).to(getattr(torch, dtype)) for x in arrays]


def _fp32_np(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)
                                             if jnp.issubdtype(x.dtype, jnp.floating) else x),
                        tree)


def _def_rows(defs, is_def, dtype_name):
    rows = []

    def walk(path, node):
        if is_def(node):
            rows.append((path, tuple(node.shape), tuple(node.axes), node.init, node.scale,
                         dtype_name(node.dtype)))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(path + (k,), v)
        else:
            for i, v in enumerate(node):
                walk(path + (i,), v)
    walk((), defs)
    return sorted(rows)


def _jrows(defs):
    return _def_rows(defs, JS.is_def, lambda d: jnp.dtype(d).name)


def _trows(defs):
    return _def_rows(defs, TS.is_def, lambda d: str(d).removeprefix("torch."))


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="float32")
    jp = jax.tree.map(jnp.asarray, _fp32_np(JS.materialize(JM.param_defs(jc),
                                                           jax.random.PRNGKey(42))))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ids = np.random.default_rng(0).integers(0, jc.vocab_size, size=(2, 64)).astype(np.int32)
    return jc, tc, jp, tp, ids


# -- configs and parameter trees ---------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference(smoke):
    jc = jax_smoke(ARCH) if smoke else jax_config(ARCH)
    tc = get_smoke_config(ARCH) if smoke else get_config("mamba2-780m")
    assert ARCH in ALIASES.values()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.scan_segments() == jc.scan_segments() == [((("ssd", "none"),), jc.n_layers)]


@pytest.mark.parametrize("smoke", [False, True])
def test_dims_param_and_cache_defs_equal_reference(smoke):
    jc = jax_smoke(ARCH) if smoke else jax_config(ARCH)
    tc = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    assert TSSM.ssm_dims(tc) == JSSM.ssm_dims(jc)
    assert _trows(TSSM.make_ssd_defs(tc)) == _jrows(JSSM.make_ssd_defs(jc))
    assert _trows(TM.param_defs(tc)) == _jrows(JM.param_defs(jc))
    assert _trows(TM.cache_defs(tc, 3, 40)) == _jrows(JM.cache_defs(jc, 3, 40))
    assert TS.param_count(TM.param_defs(tc)) == JS.param_count(JM.param_defs(jc))
    assert TS.param_bytes(TM.param_defs(tc)) == JS.param_bytes(JM.param_defs(jc))


# -- block pieces ------------------------------------------------------------


def test_segsum_matches_reference():
    a = np.random.default_rng(1).standard_normal((3, 2, 16)).astype(np.float32)
    want = np.asarray(JSSM._segsum(jnp.asarray(a)))
    got = TSSM._segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 12), dtype=np.float32)
    w = rng.standard_normal((4, 12), dtype=np.float32)
    bias = rng.standard_normal(12, dtype=np.float32)
    state = rng.standard_normal((2, 3, 12), dtype=np.float32) if with_state else None
    jy, js = JSSM._causal_conv(*_jx([x, w, bias]),
                               state=None if state is None else jnp.asarray(state))
    ty, ts = TSSM._causal_conv(*_th([x, w, bias]),
                               state=None if state is None else torch.from_numpy(state))
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("g,with_init", [(1, False), (1, True), (2, True)])
def test_mirror_ssd_scan_matches_reference(g, with_init):
    b, l, h, p, n = 2, 64, 4, 8, 16
    arrays = list(_ssd_inputs(b, l, h, p, n, g=g))
    init = (np.random.default_rng(3).standard_normal((b, h, p, n)).astype(np.float32)
            if with_init else None)
    jy, js = JSSM.ssd_scan(*_jx(arrays), chunk=16,
                           initial_state=None if init is None else jnp.asarray(init))
    ty, ts = TSSM.ssd_scan(*_th(arrays), chunk=16,
                           initial_state=None if init is None else torch.from_numpy(init))
    _close(ty, jy)
    _close(ts, js)


def test_model_scan_keeps_the_divisibility_assert():
    arrays = _th(_ssd_inputs(1, 40, 2, 8, 16, g=1))
    with pytest.raises(AssertionError, match="not divisible"):
        TSSM.ssd_scan(*arrays, chunk=16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_ref_matches_reference_oracle(dtype):
    arrays = _ssd_inputs(2, 48, 3, 8, 16)
    jy, js = jax_ssd_ref(*_jx(arrays, dtype))
    ty, ts = ssd_ref(*_th(arrays, dtype))
    assert ty.dtype == ts.dtype == getattr(torch, dtype)
    _close(ty, jy, TOL[dtype])
    _close(ts, js, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,chunk", [(128, 32), (256, 128), (100, 64), (130, 32)])
def test_ops_ssd_scan_matches_pallas_interpret(l, chunk, dtype):
    x, dt, a, bm, cm = _ssd_inputs(2, l, 2, 16, 32)
    jx = _jx([x, dt, bm, cm], dtype)
    tx = _th([x, dt, bm, cm], dtype)
    want_y, want_s = jax_ssd_kernel(jx[0], jx[1], jnp.asarray(a), jx[2], jx[3],
                                    chunk=chunk, interpret=True)
    before = ssd_scan.launches
    got_y, got_s = ssd_scan(tx[0], tx[1], torch.from_numpy(a), tx[2], tx[3], chunk=chunk)
    assert ssd_scan.launches == before              # CPU: the plain version
    assert got_y.dtype == got_s.dtype == tx[0].dtype and got_y.shape == tx[0].shape
    _close(got_y, want_y, TOL[dtype])
    _close(got_s, want_s, TOL[dtype])


def test_kernel_function_is_the_model_scan():
    """The kernel's plain version computes the model's chunked scan (G=1)."""
    arrays = _ssd_inputs(1, 128, 2, 8, 16, g=1)
    jy, js = JSSM.ssd_scan(*_jx(arrays), chunk=32)
    ty, ts = ssd_scan(*_th(arrays), chunk=32)
    _close(ty, jy)
    _close(ts, js)


def _grad_case(b, l, h, p, n, seed=11):
    """SSD inputs, and random cotangents of y and of the final state."""
    arrays = _ssd_inputs(b, l, h, p, n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    dy = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dstate = rng.standard_normal((b, h, p, n), dtype=np.float32)
    return arrays, dy, dstate


def _jax_ssd_grads(arrays, dy, dstate, chunk):
    """jax.grad of the reference's chunked ssd_scan (G = 1) through <y, dy>
    + <final state, dstate>: (dx, ddt, da, db, dc)."""
    def f(x, dt, a, bm, cm):
        y, state = JSSM.ssd_scan(x, dt, a, bm[:, :, None], cm[:, :, None], chunk=chunk)
        return jnp.sum(y * dy) + jnp.sum(state * dstate)

    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(*_jx(arrays))


@pytest.mark.parametrize("h", [2, 4])
@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_bwd_ref_matches_jax_grad(chunk, h):
    """The backward kernel's plain version (its formulas, not autograd)
    against jax.grad of the reference's scan, each of the five gradients."""
    arrays, dy, dstate = _grad_case(2, 64, h, 16, 16)
    want = _jax_ssd_grads(arrays, dy, dstate, chunk)
    got = ssd_bwd_ref(*_th(arrays), torch.from_numpy(dy), torch.from_numpy(dstate), chunk=chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w, 1e-4)


@pytest.mark.parametrize("h", [2, 4])
@pytest.mark.parametrize("chunk", [16, 32])
def test_mirror_ssd_scan_autograd_matches_jax_grad(chunk, h):
    """The model's CPU scan (the reference's chunked op, mirrored) under
    autograd, against jax.grad of the reference's."""
    arrays, dy, dstate = _grad_case(2, 64, h, 16, 16)
    want = _jax_ssd_grads(arrays, dy, dstate, chunk)
    leaves = [t.requires_grad_() for t in _th(arrays)]
    x, dt, a, bm, cm = leaves
    y, state = TSSM.ssd_scan(x, dt, a, bm[:, :, None], cm[:, :, None], chunk=chunk)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum()
                              + (state * torch.from_numpy(dstate)).sum(), leaves)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_ssd_scan_autograd_dispatch(monkeypatch):
    """``ops.ssd_scan`` takes ``SsdScan`` only under autograd.  On the CPU
    it runs the plain versions (``ssd_ref``, ``ssd_bwd_ref``) and launches
    nothing; on meta tensors the backward returns gradients of the inputs'
    shapes and credits ``ssd_scan_bwd`` to the launch hook, launching
    nothing either."""
    arrays, dy, _ = _grad_case(1, 64, 2, 16, 16, seed=5)
    plain = ssd_scan(*_th(arrays), chunk=32)
    assert plain[0].grad_fn is None
    leaves = [t.requires_grad_() for t in _th(arrays)]
    counts = (ssd_scan.launches, ssd_scan.bwd_launches)
    y, _ = ssd_scan(*leaves, chunk=32)
    assert type(y.grad_fn).__name__ == f"{SsdScan.__name__}Backward"
    torch.testing.assert_close(y.detach(), plain[0])
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    want = ssd_bwd_ref(*_th(arrays), torch.from_numpy(dy))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)
    assert (ssd_scan.launches, ssd_scan.bwd_launches) == counts

    credited = []
    monkeypatch.setattr(ops, "launch_hook", lambda name, **kw: credited.append(name))
    meta = [torch.empty(t.shape, device="meta", requires_grad=True) for t in _th(arrays)]
    y, state = ssd_scan(*meta, chunk=32)
    grads = torch.autograd.grad(y, meta, torch.empty(y.shape, device="meta"))
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape) for t in meta]
    assert all(g.device.type == "meta" for g in grads)
    assert credited == ["ssd_scan", "ssd_scan_bwd"]
    assert (ssd_scan.launches, ssd_scan.bwd_launches) == counts


def test_ssd_backward_launcher_takes_the_kernels_shapes():
    """The backward launcher's tile by (P, N) and the tensor-core route's
    head group, and on CPU tensors it passes the shape checks and refuses
    the device, never a plain version."""
    assert BWD_TILES == {(64, 128): 64, (16, 16): 32}
    # the wgmma kernels' (P, N) is the padded route's bucket
    assert set(BWD_TILES) - ssd_launcher.SIMT_SHAPES == {ssd_launcher.BUCKET}
    assert BWD_HEAD_GROUP == 12
    assert Y_ROWS == BWD_TILES[(64, 128)]   # the tensor-core route reads dy by y's layout
    for p, n in BWD_TILES:
        x, dt, a, bm, cm = _th(_ssd_inputs(1, 64, 2, p, n))
        with pytest.raises(ValueError, match="is on cpu"):
            ssd_scan_bwd_cuda(x, dt, a, bm, cm, torch.zeros_like(x))
    x, dt, a, bm, cm = _th(_ssd_inputs(1, 64, 2, 32, 16))   # the general route
    with pytest.raises(ValueError, match="is on cpu"):
        ssd_scan_bwd_cuda(x, dt, a, bm, cm, torch.zeros_like(x))
    x, dt, a, bm, cm = _th(_ssd_inputs(1, 64, 2, 136, 16))
    with pytest.raises(ValueError, match=r"\(P, N\)"):
        ssd_scan_bwd_cuda(x, dt, a, bm, cm, torch.zeros_like(x))


def _fake_launch(monkeypatch):
    """The backward launcher with its device checks, libraries and stream
    replaced: each library call is recorded as (route, args) and succeeds,
    so the launcher's route and scratch can be read on the CPU."""
    calls = []
    monkeypatch.setattr(ssd_launcher, "_check", lambda *args: None)
    monkeypatch.setattr(ssd_launcher, "_bwd_tc_fn",
                        lambda: lambda *args: calls.append(("wgmma", args)) or 0)
    monkeypatch.setattr(ssd_launcher, "_bwd_fn",
                        lambda: lambda *args: calls.append(("simt", args)) or 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("p,n,dtype,a_dtype,route", [
    (64, 128, torch.bfloat16, torch.bfloat16, "wgmma"),
    (64, 128, torch.bfloat16, torch.float32, "wgmma"),
    (64, 128, torch.float32, torch.float32, "simt"),
    (16, 16, torch.bfloat16, torch.bfloat16, "simt"),
    (16, 16, torch.float32, torch.float32, "simt"),
])
def test_ssd_backward_launcher_routes(monkeypatch, p, n, dtype, a_dtype, route):
    """bf16 at (64, 128) takes the tensor-core kernels (one call of
    ``ssd_scan_bwd_tc``, head group ``BWD_HEAD_GROUP``); fp32 and the smoke
    shape take the SIMT kernel.  Either way the gradients come back in
    the inputs' shapes and dtypes."""
    calls = _fake_launch(monkeypatch)
    b, l, h = 2, 100, 13
    x, dt, _, bm, cm = (t.to(dtype) for t in _th(_ssd_inputs(b, l, h, p, n)))
    a = torch.full((h,), -0.5, dtype=a_dtype)
    grads = ssd_scan_bwd_cuda(x, dt, a, bm, cm, torch.zeros_like(x))
    assert [c[0] for c in calls] == [route]
    for g, t in zip(grads, (x, dt, a, bm, cm)):
        assert g.shape == t.shape and g.dtype == t.dtype
    args = calls[0][1]
    if route == "wgmma":   # B, L, H, the head group, a's dtype
        assert args[15:20] == (b, l, h, BWD_HEAD_GROUP, int(a_dtype == torch.bfloat16))
        assert len(args[20]) == 44   # x, b, c and dy's tensor maps
    else:                  # B, L, H, P, N, the tile
        assert args[13:19] == (b, l, h, p, n, BWD_TILES[(p, n)])


@pytest.mark.parametrize("b,l,h,hg", [(4, 1024, 48, 12), (2, 1024, 48, 12), (1, 1000, 13, 12),
                                      (2, 300, 5, 4), (1, 50, 3, 3)])
def test_ssd_backward_scratch(monkeypatch, b, l, h, hg):
    """The tensor-core route's scratch: per-step vectors and two 32 KB state
    blobs a (b h, chunk) (bf16 hi and lo parts of S and dS, the bytes of
    fp32), da per (b, chunk, h), and dB and dC per head group, (B, L,
    ceil(H / HG), N), where the last group holds the heads left over; the
    launcher passes these tensors and that group size to the kernels."""
    nc, ng = -(-l // 64), -(-h // hg)
    sc = bwd_scratch(b, l, h, hg)
    assert sc == {"vec": ((b * h, nc, 3, 64), torch.float32),
                  "states": ((2, b * h, nc, 2, 64, 128), torch.bfloat16),
                  "da_part": ((b, nc, h), torch.float32),
                  "db_part": ((b, l, ng, 128), torch.float32),
                  "dc_part": ((b, l, ng, 128), torch.float32)}
    assert 2 * 64 * 128 * 2 == 32768        # one blob: hi and lo of a 64 x 128 state
    last = h - (ng - 1) * hg
    assert 1 <= last <= hg and (last < hg) == (h % hg != 0)
    calls = _fake_launch(monkeypatch)
    monkeypatch.setattr(ssd_launcher, "BWD_HEAD_GROUP", hg)
    x, dt, a, bm, cm = (t.bfloat16() for t in _th(_ssd_inputs(b, min(l, 64), h, 64, 128)))
    ssd_scan_bwd_cuda(x, dt, a, bm, cm, torch.zeros_like(x))
    assert calls[0][1][18] == hg


def _decomposed_bwd(x, dt, a, bm, cm, dy, dstate, q, hg, cols):
    """The tensor-core route's decomposition in float64 plain torch: each
    chunk's cumsum (prep); the states entering and the gradients leaving
    each chunk, recursed per slice of ``cols`` state columns on its own
    (states); then per (b, chunk, group of ``hg`` heads) C B^T once and each
    head's gradients, dB and dC summed over the group's heads and da per
    (b, chunk, h) (chunks); last the launcher's ordered sums."""
    bb, l, h, p = x.shape
    n = bm.shape[-1]
    nc, ng = -(-l // q), -(-h // hg)
    pad = nc * q - l

    def chunked(t):
        t = torch.cat([t, t.new_zeros((bb, pad) + t.shape[2:])], 1) if pad else t
        return t.reshape((bb, nc, q) + t.shape[2:])

    xs, dts, bs, cs, dys = (chunked(t.double()) for t in (x, dt, bm, cm, dy))
    a = a.double()
    cum = torch.cumsum(dts * a, 2)                                   # (B, nc, Q, H)
    ein, wout, keep = cum.exp(), (cum[:, :, -1:] - cum).exp(), cum[:, :, -1].exp()
    st = torch.zeros(bb, nc, h, p, n, dtype=torch.float64)
    ds = torch.zeros_like(st)
    for n0 in range(0, n, cols):
        sl = slice(n0, n0 + cols)
        s = torch.zeros(bb, h, p, cols, dtype=torch.float64)
        for c in range(nc - 1):
            s = keep[:, c, :, None, None] * s + torch.einsum(
                "bjh,bjhp,bjn->bhpn", wout[:, c] * dts[:, c], xs[:, c], bs[:, c, :, sl])
            st[:, c + 1, ..., sl] = s
        d = dstate.double()[..., sl].clone()
        ds[:, nc - 1, ..., sl] = d
        for c in range(nc - 1, 0, -1):
            d = keep[:, c, :, None, None] * d + torch.einsum(
                "bihp,bih,bin->bhpn", dys[:, c], ein[:, c], cs[:, c, :, sl])
            ds[:, c - 1, ..., sl] = d
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    dx, ddt = torch.zeros_like(xs), torch.zeros_like(dts)
    db_part = torch.zeros(bb, nc, q, ng, n, dtype=torch.float64)
    dc_part = torch.zeros_like(db_part)
    da_part = torch.zeros(bb, nc, h, dtype=torch.float64)
    for bi in range(bb):
        for c in range(nc):
            B, C = bs[bi, c], cs[bi, c]
            g = C @ B.T                                              # once for the group
            for gi in range(ng):
                for hh in range(gi * hg, min(h, (gi + 1) * hg)):
                    cu, d, xh, dyh = cum[bi, c, :, hh], dts[bi, c, :, hh], xs[bi, c, :, hh], dys[bi, c, :, hh]
                    seg = (cu[:, None] - cu[None, :]).masked_fill(~causal, -torch.inf).exp()
                    w, dyu = g * seg, (dyh @ xh.T) * d[None, :]
                    v, qm = seg * dyu, g * seg * dyu
                    S, dS = st[bi, c, hh], ds[bi, c, hh]
                    wo = wout[bi, c, :, hh]
                    du = w.T @ dyh + wo[:, None] * (B @ dS.T)
                    carried = ein[bi, c, :, hh, None] * (dyh @ S)
                    xds = xh @ dS
                    dc_part[bi, c, :, gi] += v @ B + carried
                    db_part[bi, c, :, gi] += v.T @ C + (wo * d)[:, None] * xds
                    tdot = wo * d * (B * xds).sum(-1)
                    dcs = qm.sum(1) - qm.sum(0) + (C * carried).sum(-1) - tdot
                    dcs[-1] += tdot.sum() + keep[bi, c, hh] * (dS * S).sum()
                    dda = dcs.flip(0).cumsum(0).flip(0)
                    dx[bi, c, :, hh] = d[:, None] * du
                    ddt[bi, c, :, hh] = (xh * du).sum(-1) + a[hh] * dda
                    da_part[bi, c, hh] = (d * dda).sum()

    def unchunk(t):
        return t.reshape((bb, nc * q) + t.shape[3:])[:, :l]

    return (unchunk(dx), unchunk(ddt), da_part.sum((0, 1)), unchunk(db_part).sum(2),
            unchunk(dc_part).sum(2))


@pytest.mark.parametrize("l,h,hg,q,cols", [(64, 4, 3, 16, 8), (80, 5, 2, 32, 16),
                                           (96, 3, 3, 32, 8)])
def test_decomposed_ssd_backward_matches_jax_grad(l, h, hg, q, cols):
    """The tensor-core route's decomposition (chunk-parallel state passes per
    column slice, per-group dB and dC shares, da per chunk, the ordered
    sums), as plain torch in float64, against jax.grad of the reference's
    chunked ssd_scan (chunk 16) on the same fp32 inputs, to 1e-4 as
    ``ssd_bwd_ref`` is held: a short last head group, a ragged last chunk."""
    arrays, dy, dstate = _grad_case(2, l, h, 16, 16)
    want = _jax_ssd_grads(arrays, dy, dstate, 16)
    got = _decomposed_bwd(*_th(arrays), torch.from_numpy(dy), torch.from_numpy(dstate),
                          q, hg, cols)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, 1e-4)


def test_no_silent_fallback_off_cpu(monkeypatch):
    """Off the CPU the plain version never runs: meta tensors (the dry-run)
    get uninitialised outputs of the kernel's shapes and count no launch."""
    from repro_torch.kernels import ops

    def plain(*a, **k):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(ops, "ssd_ref", plain)
    x = torch.empty(1, 64, 2, 64, device="meta")
    dt = torch.empty(1, 64, 2, device="meta")
    bc = torch.empty(1, 64, 128, device="meta")
    launches = ssd_scan.launches
    y, state = ssd_scan(x, dt, torch.empty(2, device="meta"), bc, bc)
    assert tuple(y.shape) == (1, 64, 2, 64) and tuple(state.shape) == (1, 2, 64, 128)
    assert y.device.type == "meta" and ssd_scan.launches == launches
    cpu = [torch.zeros(t.shape) for t in (x, dt, bc)]
    with pytest.raises(ValueError, match="is on cpu"):
        ssd_scan_cuda(cpu[0], cpu[1], torch.zeros(2), cpu[2], cpu[2], chunk=128)
    # B/C groups and an initial state on meta tensors: the kernel's shapes,
    # no plain version; on the launcher, a group count that does not
    # divide the heads is refused
    g2 = torch.empty(1, 64, 2, 128, device="meta")
    s0 = torch.empty(1, 2, 64, 128, device="meta")
    y, state = ssd_scan(x, dt, torch.empty(2, device="meta"), g2, g2, initial_state=s0)
    assert tuple(y.shape) == (1, 64, 2, 64) and tuple(state.shape) == (1, 2, 64, 128)
    assert ssd_scan.launches == launches
    g3 = torch.zeros(1, 64, 3, 128)
    with pytest.raises(ValueError, match="3 B/C groups do not divide 2 heads"):
        ssd_scan_cuda(cpu[0], cpu[1], torch.zeros(2), g3, g3, chunk=128)


@pytest.mark.parametrize("p,n,dtype,a_dtype,chunk,match", [
    # (P, N) and fp16 off the old menu pass the shape checks and refuse the device
    (32, 128, torch.float32, torch.float32, 128, "is on cpu"),
    (64, 64, torch.float32, torch.float32, 128, "is on cpu"),
    (64, 128, torch.float16, torch.float16, 128, "is on cpu"),
    (136, 128, torch.float32, torch.float32, 128, r"past the limit: .* P <= 128"),
    (64, 264, torch.bfloat16, torch.bfloat16, 128, r"past the limit: .* N <= 256"),
    (64, 128, torch.float32, torch.bfloat16, 128, "x's dtype or fp32"),
    (64, 128, torch.float32, torch.float32, 0, "chunk 0"),
    (64, 128, torch.float32, torch.float32, 128, "row of x .* must be contiguous"),
])
def test_launcher_rejects_what_the_kernel_does_not_take(p, n, dtype, a_dtype, chunk, match):
    x = torch.zeros(1, 64, 2, p, dtype=dtype)
    if match.startswith("row of x"):            # heads not packed within a step
        x = torch.zeros(1, 64, p, 2, dtype=dtype).transpose(2, 3)
    dt = torch.zeros(1, 64, 2, dtype=dtype)
    bc = torch.zeros(1, 64, n, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        ssd_scan_cuda(x, dt, torch.zeros(2, dtype=a_dtype), bc, bc, chunk=chunk)


def test_kernel_tiles_and_build(tmp_path, monkeypatch):
    # the bf16 kernel's warpgroups take 64 chunk rows each; fp32 keeps its tiles
    chunks = (1, 32, 33, 64, 100, 128)
    assert [kernel_chunk(c) for c in chunks] == [64, 64, 64, 64, 128, 128]
    assert [kernel_chunk(c, torch.bfloat16) for c in chunks] == [64, 64, 64, 64, 128, 128]
    assert [kernel_chunk(c, torch.float32) for c in chunks] == [32, 32, 64, 64, 128, 128]
    assert {"flash_attention.cu", "ssd_scan.cu"} <= {p.name for p in build.sources()}
    # the shared header is no library of its own, but it is hashed with the
    # sources: an edit to it rebuilds both (checked on a copy of csrc/)
    assert "hopper.cuh" not in {p.name for p in build.sources()}
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    orig = build.build_dir()
    (tmp_path / "hopper.cuh").write_bytes((tmp_path / "hopper.cuh").read_bytes() + b"\n")
    assert build.build_dir() != orig


def _conv_views(b, l, h, p, n, width=None):
    """x, B and C as the model splits its conv output (B, L, H P + 2 N)."""
    conv = torch.empty(b, l, width or h * p + 2 * n, dtype=torch.bfloat16, device="meta")
    return (conv[..., :h * p].reshape(b, l, h, p), conv[..., h * p:h * p + n],
            conv[..., h * p + n:h * p + 2 * n])


@pytest.mark.parametrize("views,rows", [(True, 128), (False, 128), (True, 64), (False, 64)])
def test_ssd_tma_layouts(views, rows):
    """mamba2-780m's prefill (B 4, L 1024, H 48, P 64, N 128): x, B and C
    as views of one (4, 1024, 3328) bf16 conv output, or contiguous."""
    b, l, h, p, n = 4, 1024, 48, 64, 128
    if views:
        x, bm, cm = _conv_views(b, l, h, p, n)
        offsets, row = (0, 6144, 6400), 6656         # 3328 bf16 a step
    else:
        x, bm, cm = (torch.empty(s, dtype=torch.bfloat16, device="meta")
                     for s in ((b, l, h, p), (b, l, n), (b, l, n)))
        offsets = (0, 0, 0)
    got = tma_layouts(x, bm, cm, rows)
    assert got.offsets == offsets
    box = (64, 1, rows, 1)
    x_row = row if views else h * p * 2
    bc_row = row if views else n * 2
    assert got.layouts[0] == ((p, h, l, b), (p * 2, x_row, x_row * l), box)
    for lay in got.layouts[1:]:
        assert lay == ((n, 1, l, b), (n * 2, bc_row, bc_row * l), box)
    assert len(got.flat()) == 33 and got.flat()[:11] == got.layouts[0].flat()
    # what the launcher hands the kernel: these, then y's, contiguous, in
    # boxes of one warpgroup's rows; cached by shape, strides and offsets
    y_layout = tma_layout((b, l, h, p), torch.empty(b, l, h, p, device="meta").stride(), 2,
                          Y_ROWS)
    assert y_layout.strides == (p * 2, h * p * 2, l * h * p * 2)
    arr = _layout_array(x, bm, cm, rows)
    assert tuple(arr) == got.flat() + y_layout.flat()
    assert _layout_array(x, bm, cm, rows) is arr


@pytest.mark.parametrize("width,cut,match", [
    (3329, 0, "byte stride 6658 .* not a multiple of 16"),   # odd row: 6658 bytes a step
    (3328 + 4, 2, "starts 6148 bytes"),                        # B two elements off the 16-byte grid
])
def test_ssd_tma_layouts_refuse_what_tma_cannot_address(width, cut, match):
    conv = torch.empty(2, 64, width, dtype=torch.bfloat16, device="meta")
    x = conv[..., :3072].reshape(2, 64, 48, 64)
    bm, cm = conv[..., 3072 + cut:3200 + cut], conv[..., 3200 + cut:3328 + cut]
    with pytest.raises(ValueError, match=match):
        tma_layouts(x, bm, cm, 128)


# -- blocks with bridged weights ----------------------------------------------


def _layer0(tree):
    return jax.tree.map(lambda t: t[0], tree)


def test_ssd_block_train_matches(setup):
    jc, tc, jp, tp, _ = setup
    x = np.random.default_rng(4).standard_normal((2, 64, jc.d_model)).astype(np.float32)
    jparams = _layer0(jp["segments"][0]["0"]["ssd"])
    tparams = TS.tree_map(lambda t: t[0], tp["segments"][0]["0"]["ssd"])
    jy, jst = JSSM.ssd_block_train(jparams, jnp.asarray(x), jc, return_state=True)
    ty, tst = TSSM.ssd_block_train(tparams, torch.from_numpy(x), tc, return_state=True)
    _close(ty, jy)
    _close(tst["conv"], jst["conv"])
    _close(tst["state"], jst["state"])
    _close(TSSM.ssd_block_train(tparams, torch.from_numpy(x), tc), jy)


def test_ssd_block_decode_matches(setup):
    jc, tc, jp, tp, _ = setup
    rng = np.random.default_rng(5)
    dims = JSSM.ssm_dims(jc)
    s = jc.ssm
    conv = rng.standard_normal((2, s.conv_width - 1, dims["conv_dim"])).astype(np.float32)
    state = rng.standard_normal((2, dims["n_heads"], s.head_dim, s.d_state)).astype(np.float32)
    x = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    jparams = _layer0(jp["segments"][0]["0"]["ssd"])
    tparams = TS.tree_map(lambda t: t[0], tp["segments"][0]["0"]["ssd"])
    jy, jc_ = JSSM.ssd_block_decode(jparams, jnp.asarray(x),
                                    {"conv": jnp.asarray(conv), "state": jnp.asarray(state)}, jc)
    # the port updates its cache in place: give it copies of the arrays
    ty, tc_ = TSSM.ssd_block_decode(tparams, torch.from_numpy(x),
                                    {"conv": torch.from_numpy(conv.copy()),
                                     "state": torch.from_numpy(state.copy())}, tc)
    _close(ty, jy)
    _close(tc_["conv"], jc_["conv"])
    _close(tc_["state"], jc_["state"])


# -- the model ---------------------------------------------------------------


def test_forward_train_logits_match(setup):
    jc, tc, jp, tp, ids = setup
    jh, _, _ = JM.forward_train(jp, {"inputs": jnp.asarray(ids)}, jc, remat=False)
    th, _, _ = TM.forward_train(tp, {"inputs": torch.from_numpy(ids)}, tc)
    _close(th, jh)
    _close(TM._logits(tp, th, tc), JM._logits(jp, jh, jc))


def test_prefill_logits_and_cache_match(setup):
    jc, tc, jp, tp, ids = setup
    jl, jcache = JM.prefill_forward(jp, {"inputs": jnp.asarray(ids)}, jc, remat=False)
    tl, tcache = TM.prefill_forward(tp, {"inputs": torch.from_numpy(ids)}, tc)
    _close(tl, jl)
    for name in ("conv", "state"):
        got = tcache["segments"][0]["0"]["ssd"][name]
        want = jcache["segments"][0]["0"]["ssd"][name]
        assert tuple(got.shape) == want.shape
        _close(got, want)


def test_decode_steps_match(setup):
    """16 steps on a cache JAX materialized (bf16 leaves): the port widens
    the SSD leaves to fp32 as the reference's step does."""
    jc, tc, jp, tp, ids = setup
    b, s = ids.shape[0], 16
    jcache = JS.materialize(JM.cache_defs(jc, b, s), jax.random.PRNGKey(0))
    tcache = params_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    step = jax.jit(lambda p, c, x: JM.decode_step(p, c, {"inputs": x}, jc))
    for t in range(s):
        jl, jcache = step(jp, jcache, jnp.asarray(ids[:, t:t + 1]))
        tl, tcache = TM.decode_step(tp, tcache, {"inputs": torch.from_numpy(ids[:, t:t + 1])},
                                    tc)
        _close(tl, jl)
    for name in ("conv", "state"):
        got = tcache["segments"][0]["0"]["ssd"][name]
        want = jcache["segments"][0]["0"]["ssd"][name]
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        _close(got, want)


def test_decode_matches_train_forward():
    """The port's own test_decode_matches_train_forward[mamba2_780m]."""
    tc = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="float32")
    fp32 = lambda tree: TS.tree_map(  # noqa: E731
        lambda x: x.float() if x.is_floating_point() else x, tree)
    params = fp32(TS.materialize(TM.param_defs(tc), 42, "cpu"))
    ids = torch.randint(0, tc.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
    h, _, _ = TM.forward_train(params, {"inputs": ids}, tc)
    train_logits = TM._logits(params, h, tc)
    cache = fp32(TS.materialize(TM.cache_defs(tc, 2, 16), 0, "cpu"))
    dec = []
    for t in range(16):
        logits, cache = TM.decode_step(params, cache, {"inputs": ids[:, t:t + 1]}, tc)
        dec.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(dec, dim=1), train_logits, rtol=2e-3, atol=2e-3)
