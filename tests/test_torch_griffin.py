"""The port's RG-LRU block (``repro_torch.models.griffin``) against
``repro.models.griffin`` on the same inputs.

Inputs are drawn with numpy from a seed and handed to both packages;
JAX materializes the weights and ``repro_torch.bridge`` carries them
across.  Smoke size (recurrentgemma-9b's smoke config), fp32: the core
with and without a carried state, the block's train path with its
returned state, and the decode step match at 1e-5.  The log-depth scan
is also held to the step-by-step recurrence, as tests/test_models.py's
``test_rglru_scan_matches_loop`` holds the reference's.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.griffin as JG
import repro_torch.models.griffin as TG
from repro.configs import get_smoke_config as jax_smoke
from repro.models import spec as JS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config

ARCH = "recurrentgemma_9b"
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="float32")
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      JS.materialize(JG.make_rglru_defs(jc), jax.random.PRNGKey(5)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_rglru_defs_keep_the_gate_leaves_fp32():
    """b_a, b_x and lam stay fp32 in a bf16 model, as the reference's."""
    defs = TG.make_rglru_defs(get_smoke_config(ARCH))
    jdefs = JG.make_rglru_defs(jax_smoke(ARCH))
    for name, d in defs.items():
        want = jdefs[name]
        assert (d.shape, d.axes, d.init, d.scale) == (want.shape, want.axes, want.init,
                                                     want.scale), name
        assert str(d.dtype).removeprefix("torch.") == jnp.dtype(want.dtype).name, name
    assert {n for n, d in defs.items() if d.dtype == torch.float32} == {"b_a", "b_x", "lam"}
    assert TG.rglru_dims(get_smoke_config(ARCH)) == JG.rglru_dims(jax_smoke(ARCH))


@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
@pytest.mark.parametrize("length", [1, 32, 45])
def test_rglru_core_matches_reference(setup, with_h0, length):
    _, _, jp, tp = setup
    x = _x((2, length, 64), seed=length)
    h0 = _x((2, 64), seed=99) if with_h0 else None
    jy, jh = JG._rglru_core(jp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    ty, th = TG._rglru_core(tp, torch.from_numpy(x), None if h0 is None else torch.from_numpy(h0))
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)


def test_rglru_scan_matches_loop(setup):
    """The log-depth scan against the step-by-step recurrence (the port's
    test_rglru_scan_matches_loop)."""
    _, _, _, tp = setup
    b, l, w = 2, 32, 64
    x = torch.from_numpy(_x((b, l, w), seed=1))
    y, h_last = TG._rglru_core(tp, x)
    r = torch.sigmoid(x @ tp["w_a"] + tp["b_a"])
    i = torch.sigmoid(x @ tp["w_x"] + tp["b_x"])
    log_a = -8.0 * torch.nn.functional.softplus(tp["lam"])[None, None] * r
    a = torch.exp(log_a).double()
    gated = (torch.sqrt(torch.clamp(1 - torch.exp(2 * log_a), min=1e-6)) * i * x).double()
    h = torch.zeros((b, w), dtype=torch.float64)
    ys = []
    for t in range(l):
        h = a[:, t] * h + gated[:, t]
        ys.append(h.clone())
    ref = torch.stack(ys, dim=1)
    torch.testing.assert_close(y.double(), ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h_last.double(), ref[:, -1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("length", [1, 7, 64, 100])
def test_linear_scan_is_the_recurrence(length):
    """_linear_scan at lengths that are and are not powers of two (one
    pass, a partial last pass, exact powers)."""
    rng = np.random.default_rng(length)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, length, 5))).double()
    b = torch.from_numpy(rng.standard_normal((3, length, 5)))
    h, ref = torch.zeros(3, 5, dtype=torch.float64), []
    for t in range(length):
        h = a[:, t] * h + b[:, t]
        ref.append(h)
    a_in, b_in = a.clone(), b.clone()
    got = TG._linear_scan(a, b)
    torch.testing.assert_close(got, torch.stack(ref, dim=1), rtol=1e-12, atol=1e-12)
    assert torch.equal(a, a_in) and torch.equal(b, b_in)     # inputs untouched


def test_rglru_block_train_matches_reference(setup):
    jc, tc, jp, tp = setup
    x = _x((2, 24, 64), seed=3)
    jout, jstate = JG.rglru_block_train(jp, jnp.asarray(x), jc, return_state=True)
    tout, tstate = TG.rglru_block_train(tp, torch.from_numpy(x), tc, return_state=True)
    _close(tout, jout)
    assert set(tstate) == {"conv", "h"}
    for name in ("conv", "h"):
        assert tuple(tstate[name].shape) == tuple(jstate[name].shape)
        _close(tstate[name], jstate[name])
    _close(TG.rglru_block_train(tp, torch.from_numpy(x), tc), jout)


def test_rglru_block_decode_matches_reference(setup):
    """Eight decode steps from a carried state, the cache updated in
    place where its dtype holds the step's result."""
    jc, tc, jp, tp = setup
    conv, h = _x((2, 3, 64), seed=11), _x((2, 64), seed=12)
    jcache = {"conv": jnp.asarray(conv), "h": jnp.asarray(h)}
    tcache = {"conv": torch.from_numpy(conv.copy()), "h": torch.from_numpy(h.copy())}
    leaves = dict(tcache)
    for t in range(8):
        x = _x((2, 1, 64), seed=20 + t)
        jy, jcache = JG.rglru_block_decode(jp, jnp.asarray(x), jcache, jc)
        ty, tcache = TG.rglru_block_decode(tp, torch.from_numpy(x), tcache, tc)
        _close(ty, jy)
        for name in ("conv", "h"):
            _close(tcache[name], jcache[name])
            assert tcache[name] is leaves[name]          # in place


def test_rglru_block_decode_widens_a_bf16_cache(setup):
    """fp32 activations over a bf16 cache: the reference's step promotes
    the state, so the port returns new fp32 leaves and leaves the cache."""
    jc, tc, jp, tp = setup
    conv, h = _x((2, 3, 64), seed=13), _x((2, 64), seed=14)
    x = _x((2, 1, 64), seed=15)
    jcache = {"conv": jnp.asarray(conv).astype(jnp.bfloat16),
              "h": jnp.asarray(h).astype(jnp.bfloat16)}
    tcache = {"conv": torch.from_numpy(conv).to(torch.bfloat16),
              "h": torch.from_numpy(h).to(torch.bfloat16)}
    before = {k: v.clone() for k, v in tcache.items()}
    jy, jnew = JG.rglru_block_decode(jp, jnp.asarray(x), jcache, jc)
    ty, tnew = TG.rglru_block_decode(tp, torch.from_numpy(x), tcache, tc)
    _close(ty, jy)
    for name in ("conv", "h"):
        assert tnew[name].dtype == torch.float32 and jnew[name].dtype == jnp.float32
        _close(tnew[name], jnew[name])
        assert torch.equal(tcache[name], before[name])


def test_prefill_state_continues_into_decode(setup):
    """The train path's returned state, fed to decode, gives the outputs
    the train path gives over the longer sequence."""
    _, tc, _, tp = setup
    x = torch.from_numpy(_x((2, 20, 64), seed=4))
    full = TG.rglru_block_train(tp, x, tc)
    _, state = TG.rglru_block_train(tp, x[:, :12], tc, return_state=True)
    outs = []
    for t in range(12, 20):
        y, state = TG.rglru_block_decode(tp, x[:, t:t + 1], state, tc)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, dim=1), full[:, 12:], rtol=1e-5, atol=1e-5)
