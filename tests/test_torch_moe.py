"""The port's MoE FFN (``repro_torch.models.moe``) against ``repro.models.moe``.

olmoe-1b-7b's smoke config in fp32: JAX materializes the weights and
``repro_torch.bridge.params_from_numpy`` carries them across; the same
numpy activations go into both.  Tolerance 1e-4, the reference's own
``test_moe_scatter_matches_gshard``; the expert-parallel dispatch runs on
two- and four-rank gloo groups and is held at 2e-4, as the reference's
``tests/test_moe_shardmap.py``.
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
from torch_gloo import run_group

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
    """Without a mesh context the expert-parallel dispatch is the scatter
    dispatch, as the reference's is, also under a process group of more
    than one rank: the choice follows the context, not the group's size."""
    _, tp = weights
    _, tc = _configs(dispatch="shard_map")
    x = torch.from_numpy(_x(tc.d_model))
    y, aux = TMoE.moe_ffn(tp, x, tc)
    ys, auxs = TMoE.moe_scatter(tp, x, tc)
    assert torch.equal(y, ys) and torch.equal(aux, auxs)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a, **k: 2)
    y2, aux2 = TMoE.moe_ffn(tp, x, tc)
    assert torch.equal(y2, ys) and torch.equal(aux2, auxs)


SHARD_MAP = """
import dataclasses
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import ACT_RULES, PARAM_RULES, activation_sharding, distribute_params
from repro_torch.distributed.sharding import distribute_like
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as TMoE
from repro_torch.models.spec import tree_leaves, tree_map

cfg = get_smoke_config("olmoe_1b_7b")
cfg = dataclasses.replace(cfg, compute_dtype="float32", moe=dataclasses.replace(
    cfg.moe, capacity_factor=8.0, dispatch="shard_map"))
mesh = make_mesh(payload["mesh"], ("data", "model"), device_type="cpu")
whole = tree_map(torch.from_numpy, payload["params"])
params = tree_map(lambda t: t.detach().requires_grad_(),
                  distribute_params(whole, TMoE.make_moe_defs(cfg), PARAM_RULES, mesh))
x = distribute_like(torch.from_numpy(payload["x"]), ("batch", "seq", "d_model"), ACT_RULES,
                    mesh).requires_grad_()
r = torch.from_numpy(payload["r"])
comm = CommDebugMode()
with comm, activation_sharding(mesh, ACT_RULES):
    y, aux = TMoE.moe_ffn(params, x, cfg)
    loss = (y.full_tensor() * r).sum()
leaves = tree_leaves(params) + [x]
grads = torch.autograd.grad(loss, leaves)
result = {"y": y.full_tensor().detach().numpy(), "aux": float(aux.full_tensor()),
          "grads": [g.full_tensor().numpy() for g in grads],
          "comm": {str(k): v for k, v in comm.get_comm_counts().items()}}
# fallbacks: a decode step (one token a sequence) under the mesh, and no
# mesh context under this multi-rank group, both run the scatter dispatch
xd = torch.from_numpy(payload["x"][:2, :1])
with torch.no_grad():
    want = TMoE.moe_scatter(whole, xd, cfg)[0]
    with activation_sharding(mesh, ACT_RULES):
        got = TMoE.moe_ffn(params, distribute_like(xd, ("batch", "seq", "d_model"), ACT_RULES,
                                                   mesh), cfg)[0].full_tensor()
    result["decode_fallback"] = float((got - want).abs().max())
    plain = TMoE.moe_ffn(whole, torch.from_numpy(payload["x"]), cfg)[0]
    result["no_context"] = bool(torch.equal(
        plain, TMoE.moe_scatter(whole, torch.from_numpy(payload["x"]), cfg)[0]))
"""


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["model2", "data2_model2"])
def test_shard_map_matches_gshard_on_gloo_ranks(weights, mesh):
    """The expert-parallel dispatch over a gloo group (2 ranks: model 2; 4
    ranks: data 2 x model 2) equals JAX's moe_gshard at capacity 8.0 on the
    same numpy inputs at 2e-4, its gradients (params and tokens) equal the
    port's autograd of moe_gshard, it runs two all_to_alls and the
    all_gathers, and its fallbacks are the scatter dispatch."""
    jp, tp = weights
    jc, tc = _configs(capacity_factor=8.0)
    x = np.random.default_rng(1).standard_normal((4, 16, jc.d_model)).astype(np.float32)
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    y_ref, _ = JMoE.moe_gshard(jp, jnp.asarray(x), jc)
    live = TS.tree_map(lambda t: t.detach().requires_grad_(), tp)
    xt = torch.from_numpy(x).requires_grad_()
    y_port, _ = TMoE.moe_gshard(live, xt, tc)
    g_ref = torch.autograd.grad((y_port * torch.from_numpy(r)).sum(),
                                TS.tree_leaves(live) + [xt])
    got = run_group(mesh[0] * mesh[1], SHARD_MAP,
                    {"mesh": mesh, "params": jax.tree.map(np.asarray, jp), "x": x, "r": r})
    np.testing.assert_allclose(got["y"], np.asarray(y_ref), rtol=2e-4, atol=2e-4)
    for g, want in zip(got["grads"], g_ref):
        np.testing.assert_allclose(g, want.numpy(), rtol=2e-4, atol=2e-4)
    assert np.isfinite(got["aux"])
    assert got["comm"]["c10d_functional.all_to_all_single"] == 2
    assert got["comm"]["c10d_functional.all_gather_into_tensor"] >= 2   # y and aux
    assert got["decode_fallback"] <= 1e-5
    assert got["no_context"]


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
