"""The SSD scan with B/C groups (G > 1) and an initial state, against the
JAX package on the same inputs.

Inputs are drawn with numpy from a seed and handed to both packages.
The kernels' plain versions (``kernels.ref.ssd_ref``, ``ssd_bwd_ref``)
are held against the JAX package's chunked ``repro.models.ssm.ssd_scan``
and its ``jax.vjp`` at G 1, 2 and 4, with and without an initial state:
y and the final state at fp32 2e-3, bf16 5e-2, and the six gradients
(dx, ddt, da, db, dc and the initial state's) at 1e-4, the tolerances of
tests/test_torch_ssm.py (da, a sum over every step, at 1e-3).  ``ops.ssd_scan`` under autograd on the CPU, the
port's SSD block and a two-layer ``n_groups=2`` model with weights
bridged from the JAX package, the launcher's pure-Python pieces (tensor
maps at G 8, the backward's head blocks, the chunk tile, the meta path's
shapes, the launch arguments), the roofline's counts, and the scan on a
four-rank gloo mesh, where B and C are sharded with the heads or each
rank takes its heads' groups.  The kernels themselves are held against
the same plain versions on the card by tests/test_torch_cuda.py and
``chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import re
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
from repro.configs import get_smoke_config as jax_smoke
from repro.models import spec as JS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.step import loss_and_grads
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as launcher
from repro_torch.kernels.ops import ssd_scan
from repro_torch.kernels.ref import ssd_bwd_ref, ssd_ref
from repro_torch.models import spec as TS
from repro_torch.roofline.cost import kernel_cost, ssd_bound, ssd_bwd_bound
from torch_gloo import run_group

ARCH = "mamba2_780m"
TOL = {"float32": 2e-3, "bfloat16": 5e-2}
GRAD_TOL = 1e-4
# da sums dt dda over every (b, step) of a head, against a total that
# cancels to a few percent of its terms: fp32 sums in another order than
# JAX's differ there by up to ~4e-4 of it
DA_TOL = 1e-3


def _close(got, want, tol=2e-3):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _case(b, l, h, p, n, g, init, seed=5):
    """x, dt, a, b, c with G groups (as tests/test_kernels.py draws them),
    an initial state or None, and cotangents of y and the final state."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((b, l, h))).astype(np.float32)
    a = (-np.exp(0.3 * rng.standard_normal(h))).astype(np.float32)
    bm = rng.standard_normal((b, l, g, n), dtype=np.float32)
    cm = rng.standard_normal((b, l, g, n), dtype=np.float32)
    s0 = rng.standard_normal((b, h, p, n), dtype=np.float32) if init else None
    dy = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dstate = rng.standard_normal((b, h, p, n), dtype=np.float32)
    return (x, dt, a, bm, cm), s0, dy, dstate


def _th(arrays, dtype="float32"):
    return [torch.from_numpy(np.asarray(x)).to(getattr(torch, dtype)) for x in arrays]


def _jx(arrays, dtype="float32"):
    return [jnp.asarray(x).astype(dtype) for x in arrays]


# -- the plain versions against the JAX function --------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,init", [(1, False), (1, True), (2, False), (2, True), (4, False),
                                    (4, True)])
def test_ssd_ref_matches_jax_scan(g, init, dtype):
    """bf16: the port's bf16 inputs against the JAX function in fp32 on
    the same (rounded) values, as the plain version computes in fp32."""
    arrays, s0, _, _ = _case(2, 64, 4, 8, 16, g, init)
    rounded = [t.float().numpy() for t in _th(arrays, dtype)]
    jy, js = JSSM.ssd_scan(*_jx(rounded), chunk=16,
                           initial_state=None if s0 is None else jnp.asarray(s0))
    ty, ts = ssd_ref(*_th(arrays, dtype), None if s0 is None else torch.from_numpy(s0))
    assert ty.dtype == ts.dtype == getattr(torch, dtype)
    _close(ty, jy, TOL[dtype])
    _close(ts, js, TOL[dtype])


@pytest.mark.parametrize("l,chunk", [(50, 10), (45, 45)])
def test_ssd_ref_ragged_length(l, chunk):
    """A length that is no multiple of 16 or 64 (the JAX function at a
    chunk that divides it; the plain recurrence needs none), G 2 and an
    initial state, and (B, L, N) taken as one group."""
    arrays, s0, _, _ = _case(1, l, 4, 8, 16, 2, True, seed=9)
    jy, js = JSSM.ssd_scan(*_jx(arrays), chunk=chunk, initial_state=jnp.asarray(s0))
    ty, ts = ssd_ref(*_th(arrays), torch.from_numpy(s0))
    _close(ty, jy)
    _close(ts, js)
    one, _, _, _ = _case(1, l, 4, 8, 16, 1, False, seed=9)
    x, dt, a, bm, cm = _th(one)
    y3, s3 = ssd_ref(x, dt, a, bm[:, :, 0], cm[:, :, 0])
    y4, s4 = ssd_ref(x, dt, a, bm, cm)
    torch.testing.assert_close(y3, y4, rtol=0, atol=0)
    torch.testing.assert_close(s3, s4, rtol=0, atol=0)


def _jax_vjp(arrays, s0, dy, dstate, chunk):
    """jax.vjp of the JAX package's chunked scan at cotangents (dy,
    dstate): the gradients of x, dt, a, b, c and, where given, s0."""
    args = _jx(arrays) + ([] if s0 is None else [jnp.asarray(s0)])

    def f(x, dt, a, bm, cm, *init):
        return JSSM.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                             initial_state=init[0] if init else None)

    _, vjp = jax.vjp(f, *args)
    return vjp((jnp.asarray(dy), jnp.asarray(dstate)))


@pytest.mark.parametrize("g,init", [(1, False), (1, True), (2, False), (2, True), (4, False),
                                    (4, True)])
@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_bwd_ref_matches_jax_vjp(g, init, chunk):
    """The backward kernels' formulas against jax.vjp, each gradient,
    the initial state's among them (None where none was given)."""
    arrays, s0, dy, dstate = _case(2, 64, 4, 16, 16, g, init, seed=11)
    want = _jax_vjp(arrays, s0, dy, dstate, 16)
    got = ssd_bwd_ref(*_th(arrays), torch.from_numpy(dy), torch.from_numpy(dstate),
                      chunk=chunk, initial_state=None if s0 is None else torch.from_numpy(s0))
    assert len(got) == 6 and (got[5] is None) == (s0 is None)
    for k, (gr, w) in enumerate(zip([t for t in got if t is not None], want)):
        assert tuple(gr.shape) == w.shape and gr.dtype == torch.float32
        _close(gr, w, DA_TOL if k == 2 else GRAD_TOL)


def test_ssd_bwd_ref_ragged_length():
    """L 50 cut into 16-step chunks (the last one padded with dt = 0
    identities) against jax.vjp of one 50-step chunk, G 2 from an initial
    state."""
    arrays, s0, dy, dstate = _case(1, 50, 4, 16, 16, 2, True, seed=13)
    want = _jax_vjp(arrays, s0, dy, dstate, 50)
    got = ssd_bwd_ref(*_th(arrays), torch.from_numpy(dy), torch.from_numpy(dstate),
                      chunk=16, initial_state=torch.from_numpy(s0))
    for k, (gr, w) in enumerate(zip(got, want)):
        _close(gr, w, DA_TOL if k == 2 else GRAD_TOL)


def test_ops_ssd_scan_autograd_matches_jax_grad():
    """``ops.ssd_scan`` on the CPU under autograd (``SsdScan``: the plain
    forward and ``ssd_bwd_ref``), G 2 from an initial state, against
    jax.grad of <y, dy> + <final state, dstate>; nothing launches."""
    arrays, s0, dy, dstate = _case(2, 64, 4, 16, 16, 2, True, seed=17)

    def jloss(x, dt, a, bm, cm, init):
        y, st = JSSM.ssd_scan(x, dt, a, bm, cm, chunk=16, initial_state=init)
        return jnp.sum(y * dy) + jnp.sum(st * dstate)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*_jx(arrays), jnp.asarray(s0))
    leaves = [t.requires_grad_() for t in _th(arrays + (s0,))]
    counts = (ssd_scan.launches, ssd_scan.bwd_launches)
    y, st = ssd_scan(*leaves[:5], chunk=16, initial_state=leaves[5])
    assert type(y.grad_fn).__name__ == "SsdScanBackward"
    loss = (y * torch.from_numpy(dy)).sum() + (st * torch.from_numpy(dstate)).sum()
    got = torch.autograd.grad(loss, leaves)
    for k, (gr, w) in enumerate(zip(got, want)):
        _close(gr, w, DA_TOL if k == 2 else GRAD_TOL)
    assert (ssd_scan.launches, ssd_scan.bwd_launches) == counts


# -- the model at n_groups = 2, weights bridged from the JAX package -------------


def _grouped_cfgs(n_layers=2):
    jc = jax_smoke(ARCH)
    tc = get_smoke_config(ARCH)
    jc = dataclasses.replace(jc, compute_dtype="float32", n_layers=n_layers,
                             ssm=dataclasses.replace(jc.ssm, n_groups=2))
    tc = dataclasses.replace(tc, compute_dtype="float32", n_layers=n_layers,
                             ssm=dataclasses.replace(tc.ssm, n_groups=2))
    return jc, tc


@pytest.fixture(scope="module")
def grouped():
    jc, tc = _grouped_cfgs()
    jp = jax.tree.map(lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating)
                      else x, JS.materialize(JM.param_defs(jc), jax.random.PRNGKey(7)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    ids = rng.integers(0, jc.vocab_size, size=(2, 64)).astype(np.int32)
    targets = rng.integers(0, jc.vocab_size, size=(2, 64)).astype(np.int32)
    return jc, tc, jp, tp, ids, targets


def test_grouped_in_proj_is_wider_and_bridged(grouped):
    """An n_groups = 2 model's in_proj is 2 (G - 1) N columns wider than
    the shipped one's, in both packages, and crosses the bridge whole."""
    jc, tc, jp, tp, _, _ = grouped
    one = TSSM.ssm_dims(get_smoke_config(ARCH))
    two = TSSM.ssm_dims(tc)
    assert two == JSSM.ssm_dims(jc)
    assert two["d_in_proj"] - one["d_in_proj"] == 2 * (2 - 1) * tc.ssm.d_state
    jw = np.asarray(jp["segments"][0]["0"]["ssd"]["in_proj"])
    tw = tp["segments"][0]["0"]["ssd"]["in_proj"]
    assert tuple(tw.shape) == jw.shape and jw.shape[-1] == two["d_in_proj"]
    np.testing.assert_array_equal(tw.numpy(), jw)


def test_grouped_ssd_block_train_matches(grouped):
    jc, tc, jp, tp, _, _ = grouped
    x = np.random.default_rng(4).standard_normal((2, 64, jc.d_model)).astype(np.float32)
    jparams = jax.tree.map(lambda t: t[0], jp["segments"][0]["0"]["ssd"])
    tparams = TS.tree_map(lambda t: t[0], tp["segments"][0]["0"]["ssd"])
    jy, jst = JSSM.ssd_block_train(jparams, jnp.asarray(x), jc, return_state=True)
    ty, tst = TSSM.ssd_block_train(tparams, torch.from_numpy(x), tc, return_state=True)
    _close(ty, jy)
    _close(tst["state"], jst["state"])
    _close(tst["conv"], jst["conv"])


def test_grouped_model_forward_and_gradient_match(grouped):
    """Two layers at n_groups = 2: the logits, the loss and every
    parameter's gradient (max |got - want| / (1 + |want|), the model
    tolerance of tests/test_torch_train.py)."""
    jc, tc, jp, tp, ids, targets = grouped
    jh, _, _ = JM.forward_train(jp, {"inputs": jnp.asarray(ids)}, jc, remat=False)
    th, _, _ = TM.forward_train(tp, {"inputs": torch.from_numpy(ids)}, tc)
    _close(TM._logits(tp, th, tc), JM._logits(jp, jh, jc))

    def jloss(p):
        return JM.loss_fn(p, {"inputs": jnp.asarray(ids), "targets": jnp.asarray(targets)},
                          jc, remat=False)

    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tl, _, tg = loss_and_grads(tp, {"inputs": torch.from_numpy(ids),
                                    "targets": torch.from_numpy(targets)}, tc, remat=False)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    tleaves = TS.tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    worst = 0.0
    for j, t in zip(jleaves, tleaves):
        j = np.asarray(j, np.float32)
        worst = max(worst, float(np.max(np.abs(t.float().numpy() - j) / (1 + np.abs(j)))))
    assert worst <= 2e-3


# -- the launcher's pure-Python pieces ------------------------------------------


def _conv_views(b, l, h, p, n, g, device="meta"):
    """x, B and C as mamba2's block splits its conv output (B, L, H P + 2 G N)."""
    conv = torch.empty(b, l, h * p + 2 * g * n, dtype=torch.bfloat16, device=device)
    return (conv[..., :h * p].reshape(b, l, h, p),
            conv[..., h * p:h * p + g * n].reshape(b, l, g, n),
            conv[..., h * p + g * n:].reshape(b, l, g, n))


@pytest.mark.parametrize("views", [True, False])
def test_tma_layouts_at_eight_groups(views):
    """mamba2-780m's prefill at G 8: B and C as (B, L, 8, N) tensor maps,
    their groups N apart, each group's row one 256-byte box."""
    b, l, h, p, n, g = 4, 1024, 48, 64, 128, 8
    if views:
        x, bm, cm = _conv_views(b, l, h, p, n, g)
        row, offsets = 2 * (h * p + 2 * g * n), (0, 2 * h * p, 2 * (h * p + g * n))
    else:
        x = torch.empty(b, l, h, p, dtype=torch.bfloat16, device="meta")
        bm, cm = (torch.empty(b, l, g, n, dtype=torch.bfloat16, device="meta") for _ in "bc")
        row, offsets = 2 * g * n, (0, 0, 0)
    got = launcher.tma_layouts(x, bm, cm, 128)
    assert got.offsets == offsets
    for lay in got.layouts[1:]:
        assert lay == ((n, g, l, b), (2 * n, row, row * l), (64, 1, 128, 1))
    arr = launcher._layout_array(x, bm, cm, 128)
    assert tuple(arr)[11:33] == got.flat()[11:33]
    # one group is the (B, L, N) layout the kernels took before groups
    one = launcher.tma_layouts(x, bm[:, :, 0], cm[:, :, 0], 128)
    assert one.layouts[1] == ((n, 1, l, b), (2 * n, row, row * l), (64, 1, 128, 1))
    assert launcher._layout_array(x, bm, cm, 128) is arr
    assert launcher._layout_array(x, bm[:, :, :1], cm[:, :, :1], 128) is not arr


def _kernel_blocks(h, g, hg):
    """The backward chunks kernel's blocks of a (b, chunk), as
    csrc/ssd_scan_bwd.cu computes them: (group, first head, heads)."""
    hpg = h // g
    ng = g * -(-hpg // hg)
    bpg = ng // g
    out = []
    for gi in range(ng):
        grp = gi // bpg
        h0 = grp * hpg + (gi % bpg) * hg
        out.append((grp, h0, min(hg, (grp + 1) * hpg - h0)))
    return out


@pytest.mark.parametrize("h,g", [(48, 1), (48, 2), (48, 8), (48, 48), (40, 2), (13, 1),
                                 (20, 4), (8, 2)])
def test_backward_head_blocks_never_straddle_a_group(h, g):
    hg = launcher.bwd_head_block(h, g)
    assert hg == min(launcher.BWD_HEAD_GROUP, h // g)
    blocks = _kernel_blocks(h, g, hg)
    heads = [hh for _, h0, nh in blocks for hh in range(h0, h0 + nh)]
    assert heads == list(range(h))                       # each head once, in order
    assert all(grp == h0 // (h // g) == (h0 + nh - 1) // (h // g) for grp, h0, nh in blocks)
    sc = launcher.bwd_scratch(2, 1024, h, hg, g)
    assert sc["db_part"][0] == (2, 1024, len(blocks), 128) == sc["dc_part"][0]


def test_backward_head_block_at_mamba2():
    assert launcher.bwd_head_block(48) == 12               # G 1, as before groups
    assert launcher.bwd_head_block(48, 8) == 6             # Mamba2Config's 8 groups


def test_kernel_chunk_maps_256_to_the_largest_tile():
    """Mamba2Config's chunk 256 runs the largest tile of either route;
    the function does not depend on the chunk."""
    assert launcher.kernel_chunk(256, torch.bfloat16) == 128
    assert launcher.kernel_chunk(256, torch.float32) == 128
    assert launcher.kernel_chunk(256, torch.bfloat16, 16, 16) == 128
    assert launcher.kernel_chunk(1024, torch.bfloat16) == 128
    with pytest.raises(ValueError, match="chunk 0"):
        launcher.kernel_chunk(0)


def test_group_sum_is_per_group_in_order():
    part = torch.randn(2, 5, 8 * 3, 16)
    like = torch.empty(2, 5, 8, 16, dtype=torch.bfloat16)
    got = launcher._group_sum(part, like)
    want = torch.stack([part[:, :, 3 * k:3 * k + 3].sum(2) for k in range(8)], 2)
    assert got.dtype == torch.bfloat16 and got.shape == like.shape
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)
    flat = torch.empty(2, 5, 16)                           # (B, L, N): one group
    torch.testing.assert_close(launcher._group_sum(part, flat), part.sum(2))


def test_meta_path_shapes_at_eight_groups_with_a_state(monkeypatch):
    """The dry-run's abstract evaluation at mamba2's G 8 from an initial
    state: the kernel's output shapes, the gradients' (the state's among
    them), and the launch hook credited with B/C's groups and the state."""
    credited = []
    monkeypatch.setattr(ops, "launch_hook", lambda name, **kw: credited.append((name, kw)))
    b, l, h, p, n, g = 4, 1024, 48, 64, 128, 8
    x, bm, cm = _conv_views(b, l, h, p, n, g)
    dt = torch.empty(b, l, h, device="meta")
    a = torch.empty(h, device="meta")
    s0 = torch.empty(b, h, p, n, device="meta", requires_grad=True)
    leaves = [t.requires_grad_() for t in (x, dt, a, bm, cm)]
    y, st = ssd_scan(*leaves, chunk=256, initial_state=s0)
    assert tuple(y.shape) == (b, l, h, p) and tuple(st.shape) == (b, h, p, n)
    grads = torch.autograd.grad(y, leaves + [s0], torch.empty(y.shape, device="meta"))
    assert [tuple(t.shape) for t in grads] == [tuple(t.shape) for t in leaves + [s0]]
    assert [c[0] for c in credited] == ["ssd_scan", "ssd_scan_bwd"]
    fwd = credited[0][1]
    assert fwd["chunk"] == 128 and fwd["b"].shape[2] == g and fwd["initial_state"] is s0
    flops, nbytes = kernel_cost("ssd_scan", **fwd)
    assert (flops, nbytes) == ssd_bound(b, l, h, p, n, 128, "torch.bfloat16", "torch.float32",
                                        g=g, s0_dtype="torch.float32")[2:]
    flops, nbytes = kernel_cost("ssd_scan_bwd", **credited[1][1])
    assert (flops, nbytes) == ssd_bwd_bound(b, l, h, p, n, "torch.bfloat16", "torch.float32",
                                            g=g, s0_dtype="torch.float32")[2:]


def test_bounds_count_groups_and_the_state():
    """B and C's bytes and C B^T's FLOPs scale with G; an initial state
    adds its bytes (and its gradient's) and the first chunk's carried
    products."""
    args = (4, 1024, 48, 64, 128, 128, "torch.bfloat16", "torch.bfloat16")
    _, _, f1, b1 = ssd_bound(*args)
    _, _, f8, b8 = ssd_bound(*args, g=8)
    assert b8 - b1 == 2 * (2 * 4 * 1024 * 7 * 128)
    assert f8 - f1 == 2.0 * 4 * 7 * 128 * sum(q * (q + 1) // 2 for q in [128] * 8)
    _, _, fs, bs = ssd_bound(*args, s0_dtype="torch.float32")
    assert bs - b1 == 4 * 4 * 48 * 64 * 128
    assert fs - f1 == 2.0 * 4 * 48 * 128 * 64 * 128
    bargs = (4, 1024, 48, 64, 128, "torch.bfloat16", "torch.bfloat16")
    _, _, fb1, bb1 = ssd_bwd_bound(*bargs)
    _, _, _, bbs = ssd_bwd_bound(*bargs, g=8, s0_dtype="torch.bfloat16")
    assert bbs - bb1 == 2 * (4 * 4 * 1024 * 7 * 128) + 2 * 2 * 4 * 48 * 64 * 128
    # the backward from a state: the first tile's two carried products
    # (dy S into dC, dy^T C into dS), not its state's recompute, which is
    # given; at G 1 and no state, per head 2 P N a step and P N on each
    # tile after the first (64 steps a tile at (64, 128))
    _, _, fbs, _ = ssd_bwd_bound(*bargs, s0_dtype="torch.bfloat16")
    assert fbs - fb1 == 2.0 * 4 * 48 * (2 * 64) * 64 * 128
    pairs = 16 * 64 * 65 // 2
    assert fb1 == 2.0 * 4 * (pairs * 128 + 48 * (pairs * (2 * 64 + 2 * 128)
                                                  + (2 * 1024 + 3 * (1024 - 64)) * 64 * 128))
    _, _, f1t, _ = ssd_bwd_bound(1, 64, 1, 64, 128, "torch.float32", "torch.float32")
    _, _, f1s, _ = ssd_bwd_bound(1, 64, 1, 64, 128, "torch.float32", "torch.float32",
                                 s0_dtype="torch.float32")
    assert f1s - f1t == 2.0 * 2 * 64 * 64 * 128


def _repo_module(name: str, path: str):
    """A script of the repository (``chip_smoke.py``, ``tools/*.py``) as a module."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent.parent / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("g,with_s0", [(1, False), (2, True)])
def test_da_referee_gives_each_term_of_da(g, with_s0):
    """chip_smoke.py's float64 referee for da: with a per step its gradient
    is each step's term of da, which sum to the gradient with a per head;
    the fp32 plain version lies within the fp32 tolerance of it element by
    element and within 1e-5 of sum |terms|."""
    cs = _repo_module("chip_smoke_for_test", "chip_smoke.py")
    rng = np.random.default_rng(11)
    b, l, h, p, n = 2, 64, 4, 8, 8
    x = torch.from_numpy(rng.standard_normal((b, l, h, p), dtype=np.float32))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((b, l, h), dtype=np.float32)))
    a = -torch.exp(0.3 * torch.from_numpy(rng.standard_normal(h, dtype=np.float32)))
    bm, cm = (torch.from_numpy(rng.standard_normal((b, l, g, n), dtype=np.float32))
              for _ in "bc")
    s0 = (torch.from_numpy(rng.standard_normal((b, h, p, n), dtype=np.float32))
          if with_s0 else None)
    dy = torch.from_numpy(rng.standard_normal((b, l, h, p), dtype=np.float32))
    dstate = torch.from_numpy(rng.standard_normal((b, h, p, n), dtype=np.float32))
    plain = ssd_bwd_ref(x, dt, a, bm, cm, dy, dstate, initial_state=s0)[2]
    got = cs.da_vs_float64((x, dt, a, bm, cm), s0, dy, dstate, plain, plain)
    assert got["kernel"] == got["plain"]
    assert got["plain"]["elementwise_scaled"] < 2e-3
    assert got["plain"]["terms_scaled"] < 1e-5
    leaves = [t.double().requires_grad_() for t in (x, dt, a, bm, cm)]
    y, st = cs.ssd_in_dtype(*leaves, chunk=16,
                            initial_state=None if s0 is None else s0.double())
    da, = torch.autograd.grad((y, st), leaves[2], (dy.double(), dstate.double()))
    err = (plain.double() - da).abs().max().item()
    assert err == pytest.approx(got["plain"]["max_abs_err"], rel=1e-9, abs=1e-12)


def test_host_ab_loads_another_checkout_beside_this_one(tmp_path):
    """tools/ssd_host_ab.py's copy of a checkout's package: every import
    renamed, so it loads beside ``repro_torch``, its kernels building under
    its own build/."""
    import sys

    tool = _repo_module("ssd_host_ab_for_test", "tools/ssd_host_ab.py")
    dest = tool.other_package(tool.ROOT / "src", tmp_path / "src")
    for f in (dest / "repro_torch_other").rglob("*.py"):
        assert not re.search(r"\brepro_torch\b", f.read_text()), f
    sys.path.insert(0, str(dest))
    try:
        import importlib

        other = importlib.import_module("repro_torch_other.kernels.ssd_scan")
        assert other.build.BUILD_ROOT == tmp_path / "build" / "repro_torch_kernels"
        assert other.kernel_chunk(256) == launcher.kernel_chunk(256) == 128
        assert other.ssd_scan_bwd_cuda is not launcher.ssd_scan_bwd_cuda
    finally:
        sys.path.remove(str(dest))
        for name in [m for m in sys.modules if m.startswith("repro_torch_other")]:
            del sys.modules[name]


def _fake_libraries(monkeypatch):
    """The launchers with device checks, libraries and stream replaced:
    each library call is recorded as (route, args) and succeeds."""
    calls = []
    monkeypatch.setattr(launcher, "_check", lambda *args: None)
    for name, route in (("_fn", "fwd"), ("_bwd_tc_fn", "wgmma"), ("_bwd_fn", "simt")):
        monkeypatch.setattr(launcher, name,
                            lambda route=route: lambda *args: calls.append((route, args)) or 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("s0_dtype", [None, torch.bfloat16, torch.float32])
def test_launch_arguments_carry_groups_and_the_state(monkeypatch, s0_dtype):
    """The forward passes the state's pointer, whether it is fp32 and G
    last; the backward its heads a block (6 at G 8), the state, its
    gradient's fp32 buffer, the dtype flag and G, and returns the state's
    gradient in its dtype and dB, dC per group."""
    calls = _fake_libraries(monkeypatch)
    b, l, h, p, n, g = 1, 128, 48, 64, 128, 8
    x = torch.zeros(b, l, h, p, dtype=torch.bfloat16)
    dt = torch.zeros(b, l, h, dtype=torch.bfloat16)
    a = torch.zeros(h)
    bm, cm = (torch.zeros(b, l, g, n, dtype=torch.bfloat16) for _ in "bc")
    s0 = None if s0_dtype is None else torch.zeros(b, h, p, n, dtype=s0_dtype)
    launcher.ssd_scan_cuda(x, dt, a, bm, cm, chunk=256, initial_state=s0)
    route, args = calls[-1]
    assert route == "fwd" and args[12] == 128                     # the chunk tile
    assert args[-3:] == (None if s0 is None else s0.data_ptr(),
                         int(s0_dtype == torch.float32), g)
    grads = launcher.ssd_scan_bwd_cuda(x, dt, a, bm, cm, torch.zeros_like(x), None, s0)
    route, args = calls[-1]
    assert route == "wgmma" and args[18] == 6                     # heads a block
    assert args[-4] == (None if s0 is None else s0.data_ptr())
    assert (args[-3] is None) == (s0 is None)
    assert args[-2:] == (int(s0_dtype == torch.float32), g)
    for gr, t in zip(grads, (x, dt, a, bm, cm, s0)):
        assert (gr is None) == (t is None)
        if t is not None:
            assert gr.shape == t.shape and gr.dtype == t.dtype
    x32, dt32, b32, c32 = (t.float() for t in (x, dt, bm, cm))
    launcher.ssd_scan_bwd_cuda(x32, dt32, a, b32, c32, torch.zeros_like(x32), None, s0)
    route, args = calls[-1]
    assert route == "simt" and args[-1] == g


def test_launcher_refuses_what_the_kernels_do_not_take():
    x = torch.zeros(1, 64, 4, 64)
    dt = torch.zeros(1, 64, 4)
    bc3 = torch.zeros(1, 64, 3, 128)
    with pytest.raises(ValueError, match="3 B/C groups do not divide 4 heads"):
        launcher.ssd_scan_cuda(x, dt, torch.zeros(4), bc3, bc3, chunk=128)
    spread = torch.zeros(1, 64, 2, 256)[..., :128]               # groups not N apart
    with pytest.raises(ValueError, match=r"\(G, N\) row"):
        launcher.ssd_scan_cuda(x, dt, torch.zeros(4), spread, spread, chunk=128)
    bc = torch.zeros(1, 64, 2, 128)
    with pytest.raises(ValueError, match="initial_state"):
        launcher.ssd_scan_cuda(x, dt, torch.zeros(4), bc, bc, chunk=128,
                               initial_state=torch.zeros(1, 4, 64, 64))


# -- the scan on a mesh ----------------------------------------------------------

MESH_BODY = """
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.kernels.ops import ssd_scan
mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
result = {}
for g, arrays in payload.items():
    x, dt, a, bm, cm, s0 = (torch.from_numpy(t) for t in arrays)
    rep = [Replicate(), Replicate()]
    args = [distribute_tensor(x, mesh, [Shard(0), Shard(2)])]
    args += [distribute_tensor(t, mesh, rep) for t in (dt, a, bm, cm)]
    y, st = ssd_scan(*args, chunk=16, initial_state=distribute_tensor(s0, mesh, rep))
    result[g] = (y.full_tensor().numpy(), st.full_tensor().numpy())
"""


def test_ssd_scan_on_a_four_rank_mesh():
    """12 heads over four ranks (3 a rank) in G 2 (one group a rank's
    heads share), 3 and 6 (groups the ranks' heads straddle: one a head)
    and 12 (B and C sharded with the heads), from an initial state, each
    against ``ssd_ref`` on the whole tensors."""
    payload = {}
    for g in (2, 3, 6, 12):
        arrays, s0, _, _ = _case(2, 32, 12, 8, 16, g, True, seed=g)
        payload[g] = tuple(np.ascontiguousarray(t) for t in arrays + (s0,))
    got = run_group(4, MESH_BODY, payload)
    for g, arrays in payload.items():
        want_y, want_s = ssd_ref(*_th(arrays[:5]), torch.from_numpy(arrays[5]))
        _close(torch.from_numpy(got[g][0]), want_y.numpy(), 1e-5)
        _close(torch.from_numpy(got[g][1]), want_s.numpy(), 1e-5)
