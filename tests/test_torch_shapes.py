"""The port's flash attention and SSD scan at every head dim, (P, N) and
dtype the JAX functions take, not only the ten configs' shapes.

On CPU tensors ``repro_torch.kernels.ops`` runs the kernels' plain versions
(``kernels/ref.py``), held here to the JAX package on the same numpy
inputs from a seed: the flash forward to ``repro.kernels.flash_attention``
(the Pallas kernel in interpret mode) and to ``blockwise_mha`` where v is
narrower than q and k, its gradient to ``jax.grad`` of ``blockwise_mha``,
the SSD forward to ``ssd_scan_kernel(interpret=True)`` and its gradient to
``jax.grad`` of ``repro.models.ssm.ssd_scan``; the routes (``route``: the
padded wgmma route in bf16 at head dims that are multiples of 8, the same
kernels on copies at a pitch of a multiple of 8 for the rest of flash, the
general SIMT route for the rest of the SSD), the tensor maps at real dims and the
limits' refusals; and two models off the configs' shapes end to end,
through the weight bridge.  Tolerances are tests/test_kernels.py's: fp32
1e-4 (SSD 2e-3), bf16 and fp16 2e-2 (SSD 5e-2).

The tests marked ``cuda`` hold each route's kernels to the plain versions
on a card and skip without one; they import no JAX (the JAX package is
imported on first use by the CPU tests), so the file runs on the card's
machine, which has none.
"""
from __future__ import annotations

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as flash_launcher
from repro_torch.kernels import ssd_scan as ssd_launcher
from repro_torch.kernels.flash_attention import (BLOCK_Q, BOX_COLS, BUCKETS, KV_TILES,
                                                 MAX_HEAD_DIM, bucket, bwd_dq_tiles,
                                                 bwd_scratch_rows, route, tma_layout)
from repro_torch.kernels.ops import flash_attention, ssd_scan
from repro_torch.kernels.ref import flash_attention_ref, ssd_bwd_ref, ssd_ref

DTYPES = ("float32", "bfloat16", "float16")
TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}
SSD_TOL = {"float32": 2e-3, "bfloat16": 5e-2, "float16": 5e-2}
# gradients: fp32 the same function in another order; bf16 inputs: the JAX
# side rounds its probabilities to bf16 before p v, the plain version not
# (tests/test_torch_flash_bwd.py's limits); fp16 alike with 10 mantissa
# bits (4.9e-4 to 7.7e-4 read at these cases)
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2, "float16": 2e-3}
FLASH_DIMS = (8, 20, 40, 48, 72, 80, 96, 112, 160, 200)
SSD_SHAPES = ((8, 16), (16, 32), (24, 40), (32, 64), (64, 64), (128, 256))


@functools.cache
def _ref() -> types.SimpleNamespace:
    """The JAX package's functions, imported on first use: the card's
    machine has no JAX, and this file's card tests need none."""
    import jax
    import jax.numpy as jnp

    import repro.models.model as JM
    import repro.models.ssm as JSSM
    from repro.configs import get_smoke_config as jax_smoke
    from repro.kernels import flash_attention as jflash
    from repro.kernels.ssd_scan import ssd_scan_kernel
    from repro.models import spec as JS
    from repro.models.layers import blockwise_mha
    return types.SimpleNamespace(jax=jax, jnp=jnp, JM=JM, JSSM=JSSM, jax_smoke=jax_smoke,
                                 flash=jflash, ssd_kernel=ssd_scan_kernel, JS=JS,
                                 blockwise_mha=blockwise_mha)


def _scaled_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.float().numpy() - want) / (1 + np.abs(want))))


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _qkv(b, s, h, kv, dk, dv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, h, dk), (b, s, kv, dk), (b, s, kv, dv), (b, s, h, dv))]


def _th(arrays, dtype: str, device="cpu"):
    return [torch.from_numpy(np.asarray(a)).to(device=device, dtype=getattr(torch, dtype))
            for a in arrays]


# -- flash attention against the JAX package ----------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", FLASH_DIMS)
def test_flash_forward_matches_pallas_interpret(d, dtype):
    """Every head dim the JAX kernel takes, in three dtypes: GQA (4 q heads
    over 2 kv heads), causal with a window of 48, a ragged S of 130."""
    r = _ref()
    q, k, v, _ = _qkv(1, 130, 4, 2, d, d, seed=d)
    want = r.flash(*(r.jnp.asarray(a).astype(dtype) for a in (q, k, v)), causal=True,
                   window=48, interpret=True)
    before = flash_attention.launches
    got = flash_attention(*_th((q, k, v), dtype), causal=True, window=48)
    assert flash_attention.launches == before          # CPU: the plain version
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (1, 130, 4, d)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dk,dv", [(96, 64), (128, 64)])
def test_flash_v_narrower_matches_blockwise_mha(dk, dv, dtype):
    """v narrower than q and k (the JAX kernel takes one head dim; the
    model's blockwise_mha takes two), GQA, causal, S 100."""
    r = _ref()
    q, k, v, _ = _qkv(2, 100, 4, 2, dk, dv, seed=dk + dv)
    want = r.blockwise_mha(*(r.jnp.asarray(a).astype(dtype) for a in (q, k, v)), causal=True)
    got = flash_attention(*_th((q, k, v), dtype), causal=True)
    assert tuple(got.shape) == (2, 100, 4, dv)
    _close(got, want, TOL[dtype])


def _jax_flash_grads(arrays, dtype, window):
    r = _ref()
    q, k, v, do = (r.jnp.asarray(a).astype(dtype) for a in arrays)

    def f(q, k, v):
        out = r.blockwise_mha(q, k, v, causal=True, window=window)
        return r.jnp.sum(out.astype(r.jnp.float32) * do.astype(r.jnp.float32))

    return r.jax.grad(f, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("dk,dv", [(40, 40), (80, 80), (96, 64)])
def test_flash_gradients_match_jax_grad(dk, dv, dtype):
    """``ops.flash_attention`` under autograd on the CPU (the plain forward
    and ``flash_attention_bwd_ref``) against jax.grad of blockwise_mha:
    GQA, causal, a window of 24, S 100."""
    arrays = _qkv(2, 100, 4, 2, dk, dv, seed=3 * dk + dv)
    want = _jax_flash_grads(arrays, dtype, 24)
    leaves = [t.requires_grad_() for t in _th(arrays[:3], dtype)]
    out = flash_attention(*leaves, causal=True, window=24)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, _th(arrays[3:], dtype)[0])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert tuple(g.shape) == w.shape and g.dtype == getattr(torch, dtype)
        assert _scaled_err(g, w) <= GRAD_TOL[dtype], (name, _scaled_err(g, w))


# -- the SSD scan against the JAX package --------------------------------------


def _ssd_case(b, l, h, p, n, g=None, init=False, seed=5):
    """x, dt, a, b, c as tests/test_kernels.py draws them (``g``: B/C as
    (B, L, G, N)), an initial state or None, and the cotangents of y and
    the final state."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((b, l, h))).astype(np.float32)
    a = (-np.exp(0.3 * rng.standard_normal(h))).astype(np.float32)
    shape = (b, l, n) if g is None else (b, l, g, n)
    bm = rng.standard_normal(shape, dtype=np.float32)
    cm = rng.standard_normal(shape, dtype=np.float32)
    s0 = rng.standard_normal((b, h, p, n), dtype=np.float32) if init else None
    dy = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dstate = rng.standard_normal((b, h, p, n), dtype=np.float32)
    return (x, dt, a, bm, cm), s0, dy, dstate


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,n", SSD_SHAPES)
def test_ssd_forward_matches_pallas_interpret(p, n, dtype):
    """Every (P, N) up to (128, 256), in three dtypes: L 100 (no multiple
    of the chunk), chunk 32, a in fp32 as the models keep it."""
    r = _ref()
    (x, dt, a, bm, cm), _, _, _ = _ssd_case(1, 100, 2, p, n, seed=p + n)
    jx = [r.jnp.asarray(t).astype(dtype) for t in (x, dt)]
    jb = [r.jnp.asarray(t).astype(dtype) for t in (bm, cm)]
    wy, ws = r.ssd_kernel(jx[0], jx[1], r.jnp.asarray(a), *jb, chunk=32, interpret=True)
    tx, tdt, tb, tc = _th((x, dt, bm, cm), dtype)
    before = ssd_scan.launches
    y, st = ssd_scan(tx, tdt, torch.from_numpy(a), tb, tc, chunk=32)
    assert ssd_scan.launches == before
    assert y.dtype == st.dtype == getattr(torch, dtype) and tuple(st.shape) == (1, 2, p, n)
    _close(y, wy, SSD_TOL[dtype])
    _close(st, ws, SSD_TOL[dtype])


@pytest.mark.parametrize("p,n", [(24, 40), (32, 64), (128, 256)])
def test_ssd_gradients_match_jax_grad(p, n):
    """``ops.ssd_scan`` under autograd on the CPU (``SsdScan``: ``ssd_ref``
    and ``ssd_bwd_ref``) at G 2 from an initial state, against jax.grad of
    <y, dy> + <final state, dstate> through repro.models.ssm.ssd_scan; da
    at 1e-3 (it sums over every step, as tests/test_torch_ssd_groups.py
    says), the rest at 1e-4."""
    r = _ref()
    arrays, s0, dy, dstate = _ssd_case(1, 64, 4, p, n, g=2, init=True, seed=p * n)

    def jloss(x, dt, a, bm, cm, init):
        y, st = r.JSSM.ssd_scan(x, dt, a, bm, cm, chunk=16, initial_state=init)
        return r.jnp.sum(y * dy) + r.jnp.sum(st * dstate)

    want = r.jax.grad(jloss, argnums=tuple(range(6)))(
        *(r.jnp.asarray(t) for t in arrays), r.jnp.asarray(s0))
    leaves = [t.requires_grad_() for t in _th(arrays + (s0,), "float32")]
    y, st = ssd_scan(*leaves[:5], chunk=32, initial_state=leaves[5])
    loss = (y * torch.from_numpy(dy)).sum() + (st * torch.from_numpy(dstate)).sum()
    got = torch.autograd.grad(loss, leaves)
    for k, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-3 if k == 2 else 1e-4)


# -- the launchers' pure-Python pieces ------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("dk,dv", [(64, 64), (128, 128), (192, 128), (256, 256), (16, 16),
                                   (24, 16), (8, 8), (40, 40), (80, 80), (96, 64), (128, 64),
                                   (160, 128), (144, 64), (200, 200), (20, 20), (72, 260 - 4),
                                   (1, 1)])
def test_flash_route_and_bucket(dk, dv, dtype):
    """bf16 at a built pair: its own kernels; fp32 at every pair: the
    register-tiled kernels of its bucket in F32_BUCKETS ("f32"); the smoke
    dims in bf16: their SIMT instantiations; bf16 at head dims that are
    multiples of 8: the smallest built pair that holds them (D 80 and 96
    take (128, 128)); fp16 at every pair that is a multiple of 8 (the smoke
    dims among them): the same kernels in fp16 ("f16", the bucket's); the
    rest, in both dtypes: those kernels on copies whose pitch is each head
    dim rounded up to a multiple of 8 ("stage", the pitches' bucket).  The
    tiles and the scratch follow the bucket."""
    r = route(dtype, dk, dv)
    assert r is route(dtype, dk, dv)                 # cached
    built = (dk, dv) in BUCKETS
    smoke = (dk, dv) in {(16, 16), (24, 16)}
    padded = dk % 8 == 0 and dv % 8 == 0 and dk <= 256 and dv <= 256
    if dtype == torch.float32:
        assert r == ("f32", flash_launcher.f32_bucket(dk, dv))
        assert not flash_launcher.tma_route(dtype, dk, dv)
    elif dtype == torch.bfloat16 and built:
        assert r == ("tma", (dk, dv))
    elif smoke and dtype == torch.bfloat16:
        assert r == ("simt", (dk, dv))
    elif padded:
        assert r.kind == ("pad" if dtype == torch.bfloat16 else "f16")
        assert r.dims == bucket(dk, dv)
        if not smoke:
            assert r.dims == route(torch.bfloat16, dk, dv).dims
        bk, bv = r.dims
        assert dk <= bk and dv <= bv
        smaller = [bd for bd in BUCKETS if bd[0] * bd[1] < bk * bv]
        assert not any(dk <= sk and dv <= sv for sk, sv in smaller)   # the smallest
        assert r.dims in KV_TILES and flash_launcher.kv_tiles(dk, dv) == KV_TILES[r.dims]
        assert bwd_dq_tiles(dk, dv) == bwd_dq_tiles(*r.dims)
        assert bwd_scratch_rows(100, dtype, dk, dv) == bwd_scratch_rows(100, dtype, *r.dims)
        assert flash_launcher.ws_route(dtype, dk, dv) == (r.dims == (192, 128))
    else:
        pk, pv = flash_launcher.pitch(dk), flash_launcher.pitch(dv)
        assert (pk % 8, pv % 8) == (0, 0) and 0 <= pk - dk < 8 and 0 <= pv - dv < 8
        assert r == ("stage", bucket(pk, pv)) and r.dims in BUCKETS
        assert flash_launcher.tma_route(dtype, dk, dv)
        assert flash_launcher.ws_route(dtype, dk, dv) == (r.dims == (192, 128))
        assert bwd_scratch_rows(100, dtype, dk, dv) == bwd_scratch_rows(100, dtype, *r.dims)
    assert bucket(80, 80) == bucket(96, 64) == (128, 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("p,n", [(64, 128), (16, 16), (64, 64), (32, 64), (8, 16), (24, 40),
                                 (16, 32), (20, 64), (96, 128), (64, 256), (128, 256), (1, 1)])
def test_ssd_route_and_tiles(p, n, dtype):
    """bf16 at (64, 128): its own kernels; fp32 there and (16, 16) in bf16
    or fp32: their SIMT instantiations; bf16 at P and N multiples of 8 up
    to (64, 128): those kernels, padded; the rest: the general SIMT
    kernels, chunk 32.  Any requested chunk maps to a tile the route has."""
    r = ssd_launcher.route(dtype, p, n)
    if dtype == torch.bfloat16 and (p, n) == (64, 128):
        assert r == ("tma", (64, 128))
    elif (p, n) == (16, 16) and dtype != torch.float16 or (
            dtype == torch.float32 and (p, n) == (64, 128)):
        assert r == ("simt", (p, n))
    elif dtype == torch.bfloat16 and p % 8 == 0 and n % 8 == 0 and p <= 64 and n <= 128:
        assert r == ("pad", (64, 128))
        assert ssd_launcher.bwd_tile(dtype, p, n) == ssd_launcher.BWD_TILES[(64, 128)]
    else:
        assert r == ("any", (p, n))
        assert ssd_launcher.chunk_tiles(dtype, p, n) == (ssd_launcher.ANY_CHUNK,)
        assert ssd_launcher.bwd_tile(dtype, p, n) == ssd_launcher.ANY_CHUNK
    tiles = ssd_launcher.chunk_tiles(dtype, p, n)
    for chunk in (1, 32, 100, 256):
        assert ssd_launcher.kernel_chunk(chunk, dtype, p, n) in tiles


def _contiguous(shape):
    return torch.empty(shape, device="meta").stride()


@pytest.mark.parametrize("d", [40, 80, 96])
def test_tma_layout_at_real_head_dims(d):
    """phi-2's D 80, phi-3-mini's D 96 and D 40: the real D in ``dims``,
    64-column boxes, so TMA zero-fills the last box's columns past D."""
    shape = (4, 1024, 32, d)
    lay = tma_layout(shape, _contiguous(shape), 2, BLOCK_Q)
    assert lay.dims == (d, 32, 1024, 4)
    assert lay.strides == (2 * d, 2 * 32 * d, 2 * 1024 * 32 * d)
    assert lay.box == (BOX_COLS, 1, BLOCK_Q, 1)
    assert -(-d // BOX_COLS) * BOX_COLS - d == {40: 24, 80: 48, 96: 32}[d]   # zero-filled


def test_ssd_tma_layouts_at_real_dims():
    """Zamba2's (64, 64) on the padded route: x at P 64, b and c at N 64
    (one 64-column box each, N 128's second box wholly zero-filled)."""
    x = torch.empty(2, 256, 48, 64, dtype=torch.bfloat16, device="meta")
    bc = torch.empty(2, 256, 64, dtype=torch.bfloat16, device="meta")
    tm = ssd_launcher.tma_layouts(x, bc, bc, 64)
    assert tm.layouts[0].dims == (64, 48, 256, 2)
    assert tm.layouts[1].dims == tm.layouts[2].dims == (64, 1, 256, 2)
    assert tm.layouts[1].strides == (128, 128, 256 * 128)


@pytest.mark.parametrize("dq,dkv,match", [
    ((1, 16, 2, 264), (1, 16, 2, 264), "past the limit"),
    ((1, 16, 2, 64), (1, 16, 2, 64, 264), "past the limit"),
])
def test_flash_refuses_past_the_limits(dq, dkv, match):
    q = torch.zeros(dq, dtype=torch.bfloat16)
    k = torch.zeros(dkv[:4], dtype=torch.bfloat16)
    v = torch.zeros(dkv[:3] + (dkv[-1],), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match) as err:
        flash_launcher.flash_attention_cuda(q, k, v, causal=True, window=0)
    assert str(MAX_HEAD_DIM) in str(err.value)


@pytest.mark.parametrize("p,n,limit", [(136, 64, "P <= 128"), (64, 264, "N <= 256")])
def test_ssd_refuses_past_the_limits(p, n, limit):
    (x, dt, a, bm, cm), _, _, _ = _ssd_case(1, 16, 2, p, n)
    with pytest.raises(ValueError, match=limit):
        ssd_launcher.ssd_scan_cuda(*_th((x, dt, a, bm, cm), "float32"), chunk=32)


# -- two models off the configs' shapes, end to end -----------------------------


def _fp32_np(tree):
    r = _ref()
    return r.jax.tree.map(lambda x: np.asarray(x.astype(r.jnp.float32)
                                               if r.jnp.issubdtype(x.dtype, r.jnp.floating)
                                               else x), tree)


def _granite_d40(cfg):
    return cfg.scaled(head_dim=40)


def _mamba2_p32_n64(cfg):
    return cfg.scaled(ssm=dataclasses.replace(cfg.ssm, head_dim=32, d_state=64))


MODELS = {"granite_3_2b": _granite_d40, "mamba2_780m": _mamba2_p32_n64}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    from repro_torch.bridge import params_from_numpy

    r = _ref()
    arch, cut = request.param, MODELS[request.param]
    jc = cut(dataclasses.replace(r.jax_smoke(arch), compute_dtype="float32"))
    tc = cut(dataclasses.replace(get_smoke_config(arch), compute_dtype="float32"))
    jp = r.jax.tree.map(r.jnp.asarray, _fp32_np(r.JS.materialize(r.JM.param_defs(jc),
                                                                 r.jax.random.PRNGKey(42))))
    tp = params_from_numpy(r.jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jc.vocab_size, size=(2, 64)).astype(np.int32)
    targets = rng.integers(0, jc.vocab_size, size=(2, 64)).astype(np.int32)
    return arch, jc, tc, jp, tp, ids, targets


def test_scaled_configs_are_off_the_built_shapes(model):
    """granite at head dim 40 (the padded route in bf16) and mamba2 at (P,
    N) = (32, 64) (likewise): shapes the ten configs do not have."""
    arch, jc, tc, *_ = model
    if arch == "granite_3_2b":
        assert tc.head_dim == jc.head_dim == 40
        assert route(torch.bfloat16, 40, 40) == ("pad", (64, 64))
    else:
        assert (tc.ssm.head_dim, tc.ssm.d_state) == (jc.ssm.head_dim, jc.ssm.d_state) == (32, 64)
        assert ssd_launcher.route(torch.bfloat16, 32, 64) == ("pad", (64, 128))


def test_scaled_forward_and_prefill_match(model):
    import repro_torch.models.model as TM

    r = _ref()
    _, jc, tc, jp, tp, ids, _ = model
    jh, _, _ = r.JM.forward_train(jp, {"inputs": r.jnp.asarray(ids)}, jc, remat=False)
    th, _, _ = TM.forward_train(tp, {"inputs": torch.from_numpy(ids)}, tc)
    _close(TM._logits(tp, th, tc), r.JM._logits(jp, jh, jc), 2e-3)
    jl, _ = r.JM.prefill_forward(jp, {"inputs": r.jnp.asarray(ids)}, jc, remat=False)
    tl, _ = TM.prefill_forward(tp, {"inputs": torch.from_numpy(ids)}, tc)
    _close(tl, jl, 2e-3)


def test_scaled_decode_steps_match(model):
    """Four decode steps from the same cache (drawn by the JAX package,
    crossed by the bridge, widened to fp32), logits at 2e-3."""
    import repro_torch.models.model as TM
    from repro_torch.bridge import params_from_numpy

    r = _ref()
    _, jc, tc, jp, tp, ids, _ = model
    b = ids.shape[0]
    jcache = r.jax.tree.map(r.jnp.asarray, _fp32_np(
        r.JS.materialize(r.JM.cache_defs(jc, b, 16), r.jax.random.PRNGKey(0))))
    tcache = params_from_numpy(r.jax.tree.map(np.asarray, jcache), "cpu")
    for t in range(4):
        x = ids[:, t:t + 1]
        jl, jcache = r.JM.decode_step(jp, jcache, {"inputs": r.jnp.asarray(x)}, jc)
        tl, tcache = TM.decode_step(tp, tcache, {"inputs": torch.from_numpy(x)}, tc)
        _close(tl, jl, 2e-3)


def test_scaled_loss_gradient_matches(model):
    """The loss and every parameter's gradient (max |got - want| / (1 +
    |want|) <= 2e-3, the model tolerance of tests/test_torch_train.py)."""
    from repro_torch.distributed.step import loss_and_grads
    from repro_torch.models import spec as TS

    r = _ref()
    _, jc, tc, jp, tp, ids, targets = model

    def jloss(p):
        return r.JM.loss_fn(p, {"inputs": r.jnp.asarray(ids), "targets": r.jnp.asarray(targets)},
                            jc, remat=False)

    (jl, _), jg = r.jax.value_and_grad(jloss, has_aux=True)(jp)
    tl, _, tg = loss_and_grads(tp, {"inputs": torch.from_numpy(ids),
                                    "targets": torch.from_numpy(targets)}, tc, remat=False)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jleaves, tleaves = r.jax.tree.leaves(jg), TS.tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    worst = max(_scaled_err(t, j) for j, t in zip(jleaves, tleaves))
    assert worst <= 2e-3


# -- on a card: each route's kernels against the plain versions -----------------


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


FLASH_CARD_CASES = [  # (dk, dv, dtype): the padded route in bf16, fp16's wgmma route at
    # dims that are multiples of 8, the staged one else
    (40, 40, "bfloat16"), (80, 80, "bfloat16"), (96, 64, "bfloat16"), (160, 128, "bfloat16"),
    (144, 64, "bfloat16"), (200, 200, "bfloat16"), (20, 20, "bfloat16"), (80, 80, "float16"),
    (256, 256, "float16"), (48, 48, "float32"), (200, 136, "float32"), (5, 3, "float32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dk,dv,dtype", FLASH_CARD_CASES)
def test_cuda_flash_routes_match_plain(dk, dv, dtype):
    """Forward (and its lse) and backward at S 130 over Sk 130, GQA 4 / 2,
    causal with a window of 48: the kernel the route names, against the
    plain version and autograd of it in fp32 on the same inputs; one launch
    each way, on the route's counter."""
    dev = _card()
    arrays = _qkv(2, 130, 4, 2, dk, dv, seed=dk * dv)
    q, k, v, do = _th(arrays, dtype, dev)
    kind = route(q.dtype, dk, dv).kind
    counts = (flash_attention.launches, getattr(flash_attention, f"{kind}_launches", 0),
              flash_attention.bwd_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=True, window=48)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert flash_attention.launches == counts[0] + 1
    assert flash_attention.bwd_launches == counts[2] + 1
    if kind in ("pad", "f16", "stage"):
        assert getattr(flash_attention, f"{kind}_launches") == counts[1] + 1
    ref_leaves = [t.float().clone().requires_grad_() for t in (q, k, v)]
    ref = flash_attention_ref(*ref_leaves, causal=True, window=48)
    ref_grads = torch.autograd.grad(ref, ref_leaves, do.float())
    tol = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}[dtype]
    assert _scaled_err(out.detach().cpu(), ref.detach().cpu().numpy()) <= tol
    bwd_tol = {"float32": 1e-3, "bfloat16": 5e-2, "float16": 5e-2}[dtype]
    for g, w in zip(grads, ref_grads):
        assert g.dtype == q.dtype
        assert _scaled_err(g.cpu(), w.cpu().numpy()) <= bwd_tol


SSD_CARD_CASES = [  # (p, n, dtype, groups, init)
    (32, 64, "bfloat16", 1, False), (64, 64, "bfloat16", 2, True), (8, 16, "bfloat16", 1, True),
    (24, 40, "bfloat16", 1, False), (20, 64, "bfloat16", 1, False),
    (96, 128, "bfloat16", 2, True), (128, 256, "float16", 1, False),
    (32, 64, "float32", 2, True), (64, 128, "float16", 1, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,dtype,g,init", SSD_CARD_CASES)
def test_cuda_ssd_routes_match_plain(p, n, dtype, g, init):
    """Forward and backward at L 100 (chunk 64), H 4: the kernels the route
    names against ``ssd_ref`` and ``ssd_bwd_ref`` in fp32 on the same
    inputs, within the SSD limits (5e-2, fp32 2e-3)."""
    dev = _card()
    arrays, s0, dy, dstate = _ssd_case(1, 100, 4, p, n, g=g, init=init, seed=p + n)
    x, dt, bm, cm = _th((arrays[0], arrays[1], arrays[3], arrays[4]), dtype, dev)
    a = torch.from_numpy(arrays[2]).to(dev)
    s0t = None if s0 is None else torch.from_numpy(s0).to(dev)
    dyt, dst = _th((dy, dstate), dtype, dev)
    kind = ssd_launcher.route(x.dtype, p, n).kind
    y, st = ssd_launcher.ssd_scan_cuda(x, dt, a, bm, cm, chunk=64, initial_state=s0t)
    grads = ssd_launcher.ssd_scan_bwd_cuda(x, dt, a, bm, cm, dyt, dst, s0t)
    torch.cuda.synchronize()
    assert kind in ("pad", "any")
    f = [t.float().cpu() for t in (x, dt, a, bm, cm)]
    s0f = None if s0 is None else s0t.cpu()
    wy, ws = ssd_ref(*f, s0f)
    want = ssd_bwd_ref(*f, dyt.float().cpu(), dst.float().cpu(), chunk=64, initial_state=s0f)
    tol = 2e-3 if dtype == "float32" else 5e-2
    assert _scaled_err(y.cpu(), wy.numpy()) <= tol
    assert _scaled_err(st.cpu(), ws.numpy()) <= tol
    for k, (gr, w) in enumerate(zip(grads, want)):
        if w is None:
            assert gr is None
            continue
        err = _scaled_err(gr.cpu(), w.numpy())
        # da sums over every step of a head: held to its scale, as the card
        # phases hold it (chip_smoke.py)
        if k == 2:
            err = float((gr.cpu().float() - w).abs().max() / (1 + w.abs().max()))
        assert err <= tol, (k, err)


# -- the C entries' argument lists, on the CPU ----------------------------------


class _FakeLibrary:
    """A loaded library whose every C entry records its calls and returns 0."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, entry):
        calls = self.calls

        class Entry:
            argtypes = restype = None

            def __call__(self, *args):
                calls.append((entry, self.argtypes, args))
                return 0

        fn = Entry()
        setattr(self, entry, fn)
        return fn


@pytest.fixture
def fake_libraries(monkeypatch):
    """Every launcher's libraries, device checks and stream replaced, so a
    launch on CPU tensors records (entry, argtypes, args)."""
    import contextlib

    from repro_torch.kernels import build

    calls = []
    libs = {}
    monkeypatch.setattr(build, "library", lambda name: libs.setdefault(name,
                                                                       _FakeLibrary(calls)))
    monkeypatch.setattr(flash_launcher, "_check", lambda *a: None)
    monkeypatch.setattr(flash_launcher, "_sm_count", lambda index: 132)
    monkeypatch.setattr(ssd_launcher, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("dk,dv", [(64, 64), (80, 80), (96, 64), (160, 128), (200, 200),
                                   (20, 20), (16, 16)])
def test_flash_launches_pass_every_argument(fake_libraries, dk, dv, dtype):
    """Each route's C entry gets as many arguments as its argtypes name
    (ctypes drops no extra and pads no missing one), forward with and
    without lse and backward (on the backward's own route: fp32 takes the
    register-tiled entry); the padded route passes the bucket, the staged
    one the padded or fp16 entry between its staging launches."""
    q, k, v, do = _th(_qkv(1, 70, 4, 2, dk, dv, seed=1), str(dtype).removeprefix("torch."))
    o, lse = flash_launcher.flash_attention_cuda(q, k, v, causal=True, window=0,
                                                 return_lse=True)
    flash_launcher.flash_attention_cuda(q, k, v, causal=False, window=16)
    flash_launcher.flash_attention_bwd_cuda(q, k, v, o, torch.zeros(1, 4, 70), do,
                                            causal=True, window=0)
    r = route(dtype, dk, dv)
    stages = [c for c in fake_libraries if c[0] == "flash_attention_stage"]
    assert len(stages) == (6 if r.kind == "stage" else 0)
    assert len(fake_libraries) == 3 + len(stages)
    for entry, argtypes, args in fake_libraries:
        assert len(args) == len(argtypes), entry
        if entry == "flash_attention_stage":
            continue
        if entry.startswith("flash_attention_fwd_ws"):   # the (192, 128) bucket's forward
            assert r.dims == (192, 128) and args[9:11] == (dk, dv)
            assert entry.endswith("_f16") == (dtype == torch.float16)
            continue
        kind = flash_launcher.bwd_route(dtype, dk, dv).kind if "bwd" in entry else r.kind
        if kind == "stage":
            kind = "pad" if dtype == torch.bfloat16 else "f16"
        assert entry.endswith({"pad": "_pad", "f16": "_f16", "f32": "_f32"}.get(kind, ""))
        if entry.endswith(("_pad", "_f16")):
            assert tuple(args[17:19] if "bwd" in entry else args[11:13]) == r.dims


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("p,n", [(64, 128), (32, 64), (24, 40), (128, 256), (16, 16)])
def test_ssd_launches_pass_every_argument(fake_libraries, p, n, dtype):
    """The SSD entries alike, at G 2 from an initial state."""
    arrays, s0, dy, dstate = _ssd_case(1, 70, 4, p, n, g=2, init=True)
    name = str(dtype).removeprefix("torch.")
    x, dt, bm, cm, dyt, dst = _th((arrays[0], arrays[1], arrays[3], arrays[4], dy, dstate), name)
    a, s0t = torch.from_numpy(arrays[2]), torch.from_numpy(s0)
    ssd_launcher.ssd_scan_cuda(x, dt, a, bm, cm, chunk=64, initial_state=s0t)
    grads = ssd_launcher.ssd_scan_bwd_cuda(x, dt, a, bm, cm, dyt, dst, s0t)
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape) for t in (x, dt, a, bm, cm, s0t)]
    kind = ssd_launcher.route(dtype, p, n).kind
    assert len(fake_libraries) == 2
    for entry, argtypes, args in fake_libraries:
        assert len(args) == len(argtypes), entry
        assert entry.endswith({"pad": "_pad", "any": "_any", "tma": "_tc"}.get(kind, "")) or (
            kind == "tma" and entry == "ssd_scan_fwd")
