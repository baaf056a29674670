"""The port's distribution plane (``repro_torch.distributed.sharding``)
against ``repro.distributed.sharding``.

* ``spec_for``: the reference's six rule cases, and for all ten
  architectures the port's parameter and cache specs equal the
  reference's ``defs_pspecs`` leaf by leaf on the reference's shape-only
  meshes (single, multi, and elastic after losing 4 hosts).
* ``placements_for`` on a ``fake`` process group's DeviceMesh.
* Numeric parity on a four-rank ``gloo`` group, mesh (2, 2) ``("data",
  "model")``, smoke configs in fp32: granite-3-2b's sharded prefill
  logits, loss, gradients and a decode step over a sequence-sharded cache
  equal JAX's at 1e-4; mamba2-780m's prefill and decode step at 2e-3.
* granite-3-2b's full config on the meta device under a 256-rank ``fake``
  group: the forward runs sharded, with the FSDP weight all-gathers.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

import repro.models.model as JM
import repro_torch.models.model as TM
from repro.configs import get_smoke_config as jax_smoke
from repro.distributed import sharding as JSh
from repro.models import spec as JS
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.distributed import sharding as TSh
from repro_torch.launch.mesh import elastic_mesh_shape
from repro_torch.models import spec as TS
from torch_gloo import run_group


class FakeMesh:
    """Shape-only mesh stand-in for rule testing (the reference's)."""

    def __init__(self, sizes: dict[str, int]):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), dtype=object)


SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}


def _jp(spec: TSh.PartitionSpec) -> JP:
    return JP(*spec)


@pytest.mark.parametrize("sizes,shape,axes,rules,want", [
    (SINGLE, (4096, 8192), ("d_model", "d_ff"), "PARAM_RULES", JP("data", "model")),
    (SINGLE, (10, 8192), ("d_model", "d_ff"), "PARAM_RULES", JP(None, "model")),
    (SINGLE, (256, 256), ("heads", "d_ff"), "PARAM_RULES", JP("model")),
    (MULTI, (4096, 8192), ("d_model", "d_ff"), "PARAM_RULES", JP(("pod", "data"), "model")),
    (MULTI, (17, 8192), ("d_model", "d_ff"), "PARAM_RULES", JP(None, "model")),
    (SINGLE, (1, 524288, 16, 128), ("batch", "seq", "kv_heads", None), "CACHE_RULES",
     JP(None, "model")),
], ids=["basic_param", "divisibility_fallback", "no_axis_reuse", "multi_pod_fsdp",
        "pod_fallback_when_odd", "cache_seq_over_model"])
def test_spec_for_rule_cases(sizes, shape, axes, rules, want):
    """The reference's six cases (tests/test_distributed.py), on both."""
    mesh = FakeMesh(sizes)
    got = TSh.spec_for(shape, axes, getattr(TSh, rules), mesh)
    assert _jp(got) == want
    assert JSh.spec_for(shape, axes, getattr(JSh, rules), mesh) == want


def test_rule_tables_equal_the_reference():
    for name in ("PARAM_RULES", "ACT_RULES", "CACHE_RULES"):
        assert getattr(TSh, name).rules == getattr(JSh, name).rules, name


def _meshes():
    shape, axes = elastic_mesh_shape(4)
    return {"single": FakeMesh(SINGLE), "multi": FakeMesh(MULTI),
            "elastic4": FakeMesh(dict(zip(axes, shape)))}


def _by_path(tree, is_leaf, prefix=()) -> dict:
    """{path: leaf} of a tree of dicts and lists (the key order of JAX's
    leaves is sorted, the port's is insertion order: compare by path)."""
    if is_leaf(tree):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: dict = {}
    for k, v in items:
        out.update(_by_path(v, is_leaf, prefix + (k,)))
    return out


def _local_bytes(defs: dict, specs: dict, sizes: dict, itemsize) -> int:
    total = 0
    for path, d in defs.items():
        n = math.prod(d.shape)
        for part in tuple(specs[path]):
            for a in ((part,) if isinstance(part, str) else part or ()):
                n //= sizes[a]
        total += n * itemsize(d.dtype)
    return total


@pytest.mark.parametrize("mesh_name", ["single", "multi", "elastic4"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_equal_the_reference(arch, mesh_name):
    """The port's spec_for over its own param_defs (PARAM_RULES) and
    cache_defs (CACHE_RULES) equals the reference's defs_pspecs leaf by
    leaf, and so do the per-device parameter bytes derived from them."""
    from repro.configs import get_config as jax_config

    mesh = _meshes()[mesh_name]
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    jc, tc = jax_config(arch), get_config(arch)
    for defs_fn, rules, args in (("param_defs", "PARAM_RULES", ()),
                                 ("cache_defs", "CACHE_RULES", (128, 32768))):
        jdefs = getattr(JM, defs_fn)(jc, *args)
        tdefs = getattr(TM, defs_fn)(tc, *args)
        jspecs = _by_path(JSh.defs_pspecs(jdefs, getattr(JSh, rules), mesh),
                          lambda x: isinstance(x, JP))
        tspecs = _by_path(TSh.defs_pspecs(tdefs, getattr(TSh, rules), mesh),
                          lambda x: isinstance(x, TSh.PartitionSpec))
        assert {k: _jp(v) for k, v in tspecs.items()} == jspecs, (defs_fn, arch)
        assert (_local_bytes(_by_path(tdefs, TS.is_def), tspecs, sizes, lambda t: t.itemsize)
                == _local_bytes(_by_path(jdefs, JS.is_def), jspecs, sizes,
                                lambda t: jnp.dtype(t).itemsize))


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(world: int):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_placements_for_on_a_device_mesh(fake_group):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_production_mesh

    fake_group(512)
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    spec = TSh.spec_for((4096, 8192), ("d_model", "d_ff"), TSh.PARAM_RULES, mesh)
    assert spec == TSh.PartitionSpec(("pod", "data"), "model")
    assert TSh.placements_for(spec, 2, mesh) == [Shard(0), Shard(0), Shard(1)]
    assert TSh.placements_for(TSh.PartitionSpec(None, "model"), 2, mesh) == [
        Replicate(), Replicate(), Shard(1)]
    assert TSh.placements_for(TSh.PartitionSpec(), 0, mesh) == [Replicate()] * 3
    t = TSh.distribute_defs({"w": TS.pdef((4096, "d_model"), (8192, "d_ff"))},
                            TSh.PARAM_RULES, mesh)["w"]
    assert tuple(t.shape) == (4096, 8192) and tuple(t.to_local().shape) == (128, 512)
    assert t.to_local().device.type == "meta"


GRANITE_PARITY = """
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import (ACT_RULES, CACHE_RULES, PARAM_RULES, activation_sharding,
                                     distribute_params)
from repro_torch.distributed.sharding import distribute_like
from repro_torch.launch.mesh import make_mesh
from repro_torch.bridge import params_from_numpy
import repro_torch.models.model as TM
from repro_torch.distributed.step import loss_and_grads
from repro_torch.models.spec import tree_map
import dataclasses
cfg = dataclasses.replace(get_smoke_config("granite_3_2b"), compute_dtype="float32")
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
params = distribute_params(params_from_numpy(payload["params"], "cpu"), TM.param_defs(cfg),
                           PARAM_RULES, mesh)
batch = {k: distribute_like(torch.from_numpy(v), ("batch", "seq"), ACT_RULES, mesh)
         for k, v in payload["batch"].items()}
# the reference's prefill cache, laid out by CACHE_RULES: batch over data,
# the sequence over model
cache = distribute_params(params_from_numpy(payload["cache"], "cpu"),
                          TM.cache_defs(cfg, 4, 16), CACHE_RULES, mesh)
nxt = distribute_like(torch.from_numpy(payload["next"]), ("batch", "seq"), ACT_RULES, mesh)
with activation_sharding(mesh, ACT_RULES):
    logits, _ = TM.prefill_forward(params, {"inputs": batch["inputs"]}, cfg)
    loss, _, grads = loss_and_grads(params, batch, cfg)
    step_logits, cache = TM.decode_step(params, cache, {"inputs": nxt}, cfg)
    layouts = {"wq": params["segments"][0]["0"]["attn"]["wq"].placements,
               "logits": logits.placements}
# mamba2: the SSD scan on each rank's (batch, heads) shard, then a decode
# step over the reference's cache laid out by CACHE_RULES
m2 = dataclasses.replace(get_smoke_config("mamba2_780m"), compute_dtype="float32")
m2_params = distribute_params(params_from_numpy(payload["m2_params"], "cpu"),
                              TM.param_defs(m2), PARAM_RULES, mesh)
m2_cache = distribute_params(params_from_numpy(payload["m2_cache"], "cpu"),
                             TM.cache_defs(m2, 4, 16), CACHE_RULES, mesh)
with activation_sharding(mesh, ACT_RULES):
    m2_logits, _ = TM.prefill_forward(m2_params, {"inputs": batch["inputs"]}, m2)
    m2_step, _ = TM.decode_step(m2_params, m2_cache, {"inputs": nxt}, m2)
k = cache["segments"][0]["0"]["attn"]["k"]
result = {"m2_logits": m2_logits.full_tensor().numpy(),
          "m2_step": m2_step.full_tensor().numpy(),"logits": logits.full_tensor().numpy(), "loss": float(loss.full_tensor()),
          "step_logits": step_logits.full_tensor().numpy(),
          "k": k.full_tensor().numpy(), "k_layout": [p.dim if p.is_shard() else None
                                                     for p in k.placements],
          "grads": tree_map(lambda g: g.full_tensor().float().numpy(), grads),
          "layouts": {k: [p.dim if p.is_shard() else None for p in v]
                      for k, v in layouts.items()}}
"""


def test_sharded_granite_matches_jax_on_four_gloo_ranks():
    """Prefill logits, the loss and its gradients, and a decode step over a
    sequence-sharded cache, of granite-3-2b's smoke config sharded over a
    (2, 2) data × model mesh of four gloo ranks, equal JAX's unsharded
    prefill_forward, loss_fn (and its grad) and decode_step at 1e-4; so do
    mamba2-780m's prefill and decode step, at 2e-3."""
    jc = dataclasses.replace(jax_smoke("granite_3_2b"), compute_dtype="float32")
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      JS.materialize(JM.param_defs(jc), jax.random.PRNGKey(42)))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, jc.vocab_size, size=(4, 16)).astype(np.int32)
             for k in ("inputs", "targets")}
    want_logits, jcache = JM.prefill_forward(jp, {"inputs": jnp.asarray(batch["inputs"])}, jc)
    want_loss, _ = JM.loss_fn(jp, jax.tree.map(jnp.asarray, batch), jc)
    nxt = rng.integers(0, jc.vocab_size, size=(4, 1)).astype(np.int32)
    want_step, want_cache = JM.decode_step(jp, jcache, {"inputs": jnp.asarray(nxt)}, jc)
    mc = dataclasses.replace(jax_smoke("mamba2_780m"), compute_dtype="float32")
    mp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      JS.materialize(JM.param_defs(mc), jax.random.PRNGKey(7)))
    want_m2, m2_cache = JM.prefill_forward(mp, {"inputs": jnp.asarray(batch["inputs"])}, mc)
    want_m2_step, _ = JM.decode_step(mp, m2_cache, {"inputs": jnp.asarray(nxt)}, mc)
    got = run_group(4, GRANITE_PARITY, {"params": jax.tree.map(np.asarray, jp),
                                        "batch": batch, "next": nxt,
                                        "cache": jax.tree.map(np.asarray, jcache),
                                        "m2_params": jax.tree.map(np.asarray, mp),
                                        "m2_cache": jax.tree.map(np.asarray, m2_cache)})
    np.testing.assert_allclose(got["logits"], np.asarray(want_logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["loss"], float(want_loss), rtol=1e-4, atol=1e-4)
    # one decode step over the sequence-sharded cache: the ring write lands
    # in the rank that holds the slot, the softmax combines over ranks
    np.testing.assert_allclose(got["step_logits"], np.asarray(want_step), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["k"], np.asarray(want_cache["segments"][0]["0"]["attn"]["k"]),
                               rtol=1e-4, atol=1e-4)
    # mamba2's prefill through the SSD scan on (batch, heads) shards, and
    # its decode step, at the SSD parity tests' fp32 tolerance
    np.testing.assert_allclose(got["m2_logits"], np.asarray(want_m2), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got["m2_step"], np.asarray(want_m2_step), rtol=2e-3, atol=2e-3)
    # the stacked (layers, batch, seq, kv, hd) cache: batch over data, seq over model
    assert got["k_layout"] == [1, 2]
    # the gradient through the FSDP gathers, the vocab-sharded embedding
    # and the sharded attention, leaf by leaf, at the unsharded gradient
    # parity's measure and limit (tests/test_torch_train.py)
    want_grads = jax.grad(lambda p: JM.loss_fn(p, jax.tree.map(jnp.asarray, batch), jc)[0])(jp)
    leaf = lambda x: isinstance(x, np.ndarray)  # noqa: E731
    want = _by_path(jax.tree.map(np.asarray, want_grads), leaf)
    got_grads = _by_path(got["grads"], leaf)
    assert got_grads.keys() == want.keys()
    for path, g in got_grads.items():
        err = np.max(np.abs(g - want[path]) / (1 + np.abs(want[path])))
        assert err <= 2e-3, (path, err)
    # the stacked wq (layers, d_model, heads): d_model over data (FSDP),
    # heads over model; the logits' batch over data
    assert got["layouts"]["wq"] == [1, 2]
    assert got["layouts"]["logits"][0] == 0


def test_full_granite_forward_on_meta_under_a_256_rank_mesh(fake_group):
    """granite-3-2b's full config runs its prefill on the meta device over
    the (16, 16) production mesh: wk's 512 columns (8 kv heads) are laid
    out for the head view before it, the constants meet the DTensors as
    replicated ones, and every weight is all-gathered over ``data`` at its
    use (seven FSDP gathers a layer), not turned into partial sums."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.mesh import make_production_mesh

    fake_group(256)
    mesh = make_production_mesh(device_type="cpu")
    cfg = get_config("granite_3_2b")
    params = TSh.distribute_defs(TM.param_defs(cfg), TSh.PARAM_RULES, mesh)
    inputs = TSh.distribute_defs({"i": TS.pdef((32, "batch"), (512, "seq"),
                                               dtype=torch.int32)},
                                 TSh.ACT_RULES, mesh)["i"]
    comm = CommDebugMode()
    with comm, TSh.activation_sharding(mesh, TSh.ACT_RULES):
        logits, cache = TM.prefill_forward(params, {"inputs": inputs}, cfg)
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    assert tuple(logits.shape) == (32, 1, cfg.vocab_size)
    assert counts.get("c10d_functional.all_gather_into_tensor", 0) >= 7 * cfg.n_layers
    assert "c10d_functional.reduce_scatter_tensor" not in counts
    k = cache["segments"][0]["0"]["attn"]["k"]
    assert tuple(k.shape) == (cfg.n_layers, 32, 512, cfg.n_kv_heads, cfg.resolved_head_dim)


def test_constrain_is_the_identity_without_a_context():
    from repro_torch.models.layers import constrain, current_mesh

    x = torch.randn(2, 3, 4)
    assert constrain(x, ("batch", "seq", "d_model")) is x
    assert current_mesh() is None
