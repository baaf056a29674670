"""The port's MoE FFN (``repro_torch.models.moe``) against ``repro.models.moe``.

olmoe-1b-7b's smoke config in fp32: JAX materializes the weights and
``repro_torch.bridge.params_from_numpy`` carries them across; the same
numpy activations go into both.  Tolerance 1e-4, the reference's own
``test_moe_scatter_matches_gshard``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as JMoE
import repro_torch.models.moe as TMoE
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import spec as JS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import spec as TS

ARCH = "olmoe_1b_7b"
TOL = 1e-4


def _configs(capacity_factor=None, dispatch=None):
    jc = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="float32")
    changes = {k: v for k, v in (("capacity_factor", capacity_factor), ("dispatch", dispatch))
               if v is not None}
    if changes:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **changes))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **changes))
    return jc, tc


@pytest.fixture(scope="module")
def weights():
    jc, _ = _configs()
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      JS.materialize(JMoE.make_moe_defs(jc), jax.random.PRNGKey(7)))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(d, s=16, seed=0):
    return np.random.default_rng(seed).standard_normal((2, s, d)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _rows(defs, is_def, dtype_name):
    return sorted((path, tuple(d.shape), tuple(d.axes), d.init, d.scale, dtype_name(d.dtype))
                  for path, d in _walk(defs, is_def))


def _walk(node, is_def, path=()):
    if is_def(node):
        yield path, node
    else:
        for k, v in node.items():
            yield from _walk(v, is_def, path + (k,))


@pytest.mark.parametrize("smoke", [True, False])
def test_make_moe_defs_equal_reference(smoke):
    jcfg = jax_smoke(ARCH) if smoke else jax_config(ARCH)
    tcfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    trows = _rows(TMoE.make_moe_defs(tcfg), TS.is_def, lambda d: str(d).removeprefix("torch."))
    jrows = _rows(JMoE.make_moe_defs(jcfg), JS.is_def, lambda d: jnp.dtype(d).name)
    assert trows == jrows
    router = TMoE.make_moe_defs(tcfg)["router"]
    assert router.dtype == torch.float32          # fp32 under bf16 parameters


def test_route_matches_reference(weights):
    jp, tp = weights
    jc, tc = _configs()
    xf = _x(jc.d_model).reshape(-1, jc.d_model)
    jw, jidx, jaux = JMoE._route(jp, jnp.asarray(xf), jc.moe)
    tw, tidx, taux = TMoE._route(tp, torch.from_numpy(xf), tc.moe)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw, jw)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("t", [1, 4, 32, 4128, 4096])
def test_capacity_matches_reference(t):
    for cf in (0.05, 1.25, 4.0, 8.0):
        jc, tc = _configs(capacity_factor=cf)
        assert TMoE._capacity(tc.moe, t) == JMoE._capacity(jc.moe, t)
    full = get_config(ARCH).moe
    # at the full config a 4-sequence prefill of 1032 tokens keeps 648 slots
    # per expert, a 4-token decode step 8
    assert TMoE._capacity(full, 4128) == 648 and TMoE._capacity(full, 4) == 8


@pytest.mark.parametrize("n", [6, 64, 100, 4096 * 8])
def test_positions_hierarchical_match_reference(n):
    e = np.random.default_rng(n).integers(0, 8, size=n).astype(np.int32)
    want = np.asarray(JMoE._positions_hierarchical(jnp.asarray(e), 8))
    got = TMoE._positions_hierarchical(torch.from_numpy(e).long(), 8)
    assert np.array_equal(got.numpy(), want)
    oh = np.eye(8, dtype=np.int64)[e]
    assert np.array_equal(got.numpy(), ((np.cumsum(oh, 0) - oh) * oh).sum(1))


@pytest.mark.parametrize("fn", ["moe_gshard", "moe_scatter"])
def test_dispatch_matches_reference(weights, fn):
    """The shipped capacity factor 1.25: 32 tokens, capacity 16."""
    jp, tp = weights
    jc, tc = _configs()
    x = _x(jc.d_model)
    jy, jaux = getattr(JMoE, fn)(jp, jnp.asarray(x), jc)
    ty, taux = getattr(TMoE, fn)(tp, torch.from_numpy(x), tc)
    _close(ty, jy)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("fn", ["moe_gshard", "moe_scatter"])
def test_shared_experts_match_reference(fn):
    """One shared expert beside the routed ones (deepseek-v3's layout; olmoe
    has none): its SwiGLU is added to every token's output."""
    jc, tc = _configs(capacity_factor=4.0)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, n_shared=1))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, n_shared=1))
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      JS.materialize(JMoE.make_moe_defs(jc), jax.random.PRNGKey(9)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert set(tp) == {"router", "experts", "shared"}
    x = _x(jc.d_model, seed=4)
    jy, _ = getattr(JMoE, fn)(jp, jnp.asarray(x), jc)
    ty, _ = getattr(TMoE, fn)(tp, torch.from_numpy(x), tc)
    _close(ty, jy)


def test_capacity_drop_keeps_the_reference_set(weights):
    """capacity_factor 0.05 (the reference's test_moe_capacity_drops_tokens):
    most assignments are dropped; the same ones are kept and the outputs
    agree."""
    jp, tp = weights
    jc, tc = _configs(capacity_factor=0.05)
    x = _x(jc.d_model, s=64, seed=1)
    t = x.shape[0] * x.shape[1]
    _, jidx, _ = JMoE._route(jp, jnp.asarray(x.reshape(t, -1)), jc.moe)
    _, tidx, _ = TMoE._route(tp, torch.from_numpy(x.reshape(t, -1)), tc.moe)
    cap = TMoE._capacity(tc.moe, t)
    jkeep = np.asarray(JMoE._positions_hierarchical(jidx.reshape(-1), jc.moe.n_experts)) < cap
    tkeep = TMoE._positions_hierarchical(tidx.reshape(-1), tc.moe.n_experts) < cap
    assert np.array_equal(tkeep.numpy(), jkeep) and 0 < jkeep.sum() < jkeep.size // 2
    jy, jaux = JMoE.moe_scatter(jp, jnp.asarray(x), jc)
    ty, taux = TMoE.moe_scatter(tp, torch.from_numpy(x), tc)
    assert torch.isfinite(ty).all() and float(taux) > 0
    _close(ty, jy)
    # a token whose every assignment was dropped gets zeros
    dropped_all = ~tkeep.reshape(t, -1).any(1)
    assert dropped_all.any() and not ty.reshape(t, -1)[dropped_all].any()


def test_scatter_matches_gshard():
    """The port's own test_moe_scatter_matches_gshard: capacity factor 4."""
    _, tc = _configs(capacity_factor=4.0)
    tp = TS.tree_map(lambda t: t.float(), TS.materialize(TMoE.make_moe_defs(tc), 3, "cpu"))
    x = torch.from_numpy(_x(tc.d_model, seed=2))
    y1, a1 = TMoE.moe_gshard(tp, x, tc)
    y2, a2 = TMoE.moe_scatter(tp, x, tc)
    torch.testing.assert_close(y1, y2, rtol=TOL, atol=TOL)
    assert float(a1) == float(a2)


def test_shard_map_without_process_group_is_scatter(weights, monkeypatch):
    _, tp = weights
    _, tc = _configs(dispatch="shard_map")
    x = torch.from_numpy(_x(tc.d_model))
    y, aux = TMoE.moe_ffn(tp, x, tc)
    ys, auxs = TMoE.moe_scatter(tp, x, tc)
    assert torch.equal(y, ys) and torch.equal(aux, auxs)
    # a process group of more than one rank must not run every expert on
    # each rank silently
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a, **k: 2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        TMoE.moe_ffn(tp, x, tc)


def test_bf16_activations_route_in_fp32(weights):
    """bf16 activations on fp32 weights: the router computes in fp32 and the
    combine weights come back in the activations' dtype, as the reference's."""
    jp, tp = weights
    jc, tc = _configs()
    x = _x(jc.d_model).reshape(-1, jc.d_model)
    xb = torch.from_numpy(x).bfloat16()
    jw, jidx, _ = JMoE._route(jp, jnp.asarray(x).astype(jnp.bfloat16), jc.moe)
    tw, tidx, _ = TMoE._route(tp, xb, tc.moe)
    assert tw.dtype == torch.bfloat16 and np.array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw, jw.astype(jnp.float32), tol=1e-2)
