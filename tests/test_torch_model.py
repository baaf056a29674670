"""The port's decoder-only attention models against ``repro.models`` with
the same weights: granite-3-2b, minitron-4b (head padding, D 128) and
olmoe-1b-7b (MoE FFNs).

JAX materializes the weights; ``repro_torch.bridge.params_from_numpy``
carries them across.  Smoke size, fp32: logits, prefill caches and a
16-step decode match at 2e-3, the tolerance of tests/test_models.py.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as JM
import repro_torch.models.model as TM
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import spec as JS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ALIASES, get_config, get_smoke_config
from repro_torch.models import spec as TS

ARCH = "granite_3_2b"            # the base of the architecture-free tests
ARCHS = ("granite_3_2b", "minitron_4b", "olmoe_1b_7b")


def _fp32_np(tree):
    """JAX tree -> numpy tree, floating leaves in fp32."""
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)
                                             if jnp.issubdtype(x.dtype, jnp.floating) else x),
                        tree)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def setup(arch):
    jc = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    jp = jax.tree.map(jnp.asarray, _fp32_np(JS.materialize(JM.param_defs(jc),
                                                           jax.random.PRNGKey(42))))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ids = np.random.default_rng(0).integers(0, jc.vocab_size, size=(2, 16)).astype(np.int32)
    return jc, tc, jp, tp, ids


def _close(got, want, tol=2e-3):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


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
    return rows


def _jrows(defs):
    return _def_rows(defs, JS.is_def, lambda d: jnp.dtype(d).name)


def _trows(defs):
    return _def_rows(defs, TS.is_def, lambda d: str(d).removeprefix("torch."))


@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference(arch, smoke):
    jc = jax_smoke(arch) if smoke else jax_config(arch)
    tc = get_smoke_config(arch) if smoke else get_config(arch.replace("_", "-"))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.scan_segments() == jc.scan_segments()
    assert tc.block_kinds() == jc.block_kinds()
    assert tc.cdtype == torch.bfloat16


@pytest.mark.parametrize("smoke", [False, True])
def test_param_and_cache_defs_equal_reference(arch, smoke):
    jc = jax_smoke(arch) if smoke else jax_config(arch)
    tc = get_smoke_config(arch) if smoke else get_config(arch)
    # the same leaves by name (jax.tree.map sorts dict keys, so order differs)
    assert sorted(_trows(TM.param_defs(tc))) == sorted(_jrows(JM.param_defs(jc)))
    assert sorted(_trows(TM.cache_defs(tc, 3, 40))) == sorted(_jrows(JM.cache_defs(jc, 3, 40)))
    assert TS.param_count(TM.param_defs(tc)) == JS.param_count(JM.param_defs(jc))
    assert TS.param_bytes(TM.param_defs(tc)) == JS.param_bytes(JM.param_defs(jc))
    assert TS.logical_axes(TM.param_defs(tc))["embed"] == ("vocab", "d_model")


def test_materialize_seeded_per_leaf():
    tc = get_smoke_config(ARCH)
    defs = TM.param_defs(tc)
    a, b = TS.materialize(defs, 0, "cpu"), TS.materialize(defs, 0, "cpu")
    c = TS.materialize(defs, 1, "cpu")
    la, lb, lc = TS.tree_leaves(a), TS.tree_leaves(b), TS.tree_leaves(c)
    for d, x, y, z in zip(TS.tree_leaves(defs, TS.is_def), la, lb, lc):
        assert tuple(x.shape) == d.shape and x.dtype == d.dtype
        assert torch.equal(x, y)
        if d.init == "zeros":
            assert not x.any()
        else:
            assert not torch.equal(x, z)
    w1 = a["segments"][0]["0"]["ffn"]["w1"].float()
    assert abs(w1.std().item() - 1 / np.sqrt(w1.shape[0])) < 0.05   # fan_in = shape[0]
    meta = TS.abstract(defs)
    assert meta["embed"].device.type == "meta" and meta["embed"].dtype == torch.bfloat16


def test_bridge_carries_bf16_bit_for_bit():
    x = jax.random.normal(jax.random.PRNGKey(0), (5, 7)).astype(jnp.bfloat16)
    tree = params_from_numpy({"a": [np.asarray(x)], "n": np.asarray(jnp.int32(3))}, "cpu")
    t = tree["a"][0]
    assert t.dtype == torch.bfloat16 and tree["n"].dtype == torch.int32
    assert np.array_equal(t.view(torch.int16).numpy(), np.asarray(x).view(np.int16))
    assert params_from_numpy({"a": np.asarray(x)}, "cpu", torch.float32)["a"].dtype \
        == torch.float32


def test_forward_train_logits_match(setup):
    jc, tc, jp, tp, ids = setup
    jh, _, jaux = JM.forward_train(jp, {"inputs": jnp.asarray(ids)}, jc, remat=False)
    th, enc, aux = TM.forward_train(tp, {"inputs": torch.from_numpy(ids)}, tc)
    assert enc is None and (float(aux) == 0.0) == (tc.moe is None)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    _close(th, jh)
    _close(TM._logits(tp, th, tc), JM._logits(jp, jh, jc))


def test_fp32_activations_on_bf16_weights_promote_like_jax(setup):
    """A float32 config on the default bf16 weights: products promote to
    fp32 as JAX's do, so both frameworks give the same logits."""
    jc, tc, _, _, ids = setup
    jp = JS.materialize(JM.param_defs(jc), jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["segments"][0]["0"]["attn"]["wq"].dtype == torch.bfloat16
    jl, _ = JM.prefill_forward(jp, {"inputs": jnp.asarray(ids)}, jc, remat=False)
    tl, _ = TM.prefill_forward(tp, {"inputs": torch.from_numpy(ids)}, tc)
    assert tl.dtype == torch.float32
    _close(tl, jl)


def test_prefill_logits_and_cache_match(setup):
    jc, tc, jp, tp, ids = setup
    jl, jcache = JM.prefill_forward(jp, {"inputs": jnp.asarray(ids)}, jc, remat=False)
    tl, tcache = TM.prefill_forward(tp, {"inputs": torch.from_numpy(ids)}, tc)
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tcache["segments"][0]["0"]["attn"][name],
               jcache["segments"][0]["0"]["attn"][name])
    assert tcache["segments"][0]["0"]["attn"]["len"].tolist() == \
        np.asarray(jcache["segments"][0]["0"]["attn"]["len"]).tolist()


def test_decode_steps_match(setup):
    jc, tc, jp, tp, ids = setup
    b, s = ids.shape
    jcache = JS.materialize(JM.cache_defs(jc, b, s), jax.random.PRNGKey(0))
    tcache = params_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    step = jax.jit(lambda p, c, x: JM.decode_step(p, c, {"inputs": x}, jc))
    for t in range(s):
        jl, jcache = step(jp, jcache, jnp.asarray(ids[:, t:t + 1]))
        tl, tcache = TM.decode_step(tp, tcache, {"inputs": torch.from_numpy(ids[:, t:t + 1])},
                                    tc)
        _close(tl, jl)
    _close(tcache["segments"][0]["0"]["attn"]["k"], jcache["segments"][0]["0"]["attn"]["k"])


def test_decode_matches_train_forward(arch):
    """The port's own test_decode_matches_train_forward[<arch>].  An MoE
    model runs at capacity factor n_experts / top_k, where capacity equals
    the token count and nothing is dropped: at the shipped 1.25 the
    forward's 32 tokens drop assignments a decode step's 2 keep, so the two
    compute different functions (tests/test_models.py leaves olmoe out)."""
    tc = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    if tc.moe:
        tc = tc.scaled(moe=dataclasses.replace(
            tc.moe, capacity_factor=tc.moe.n_experts / tc.moe.top_k))
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


@pytest.mark.parametrize("name", ["gemma3_27b", "recurrentgemma_9b", "llava_next_34b"])
def test_unported_architectures_say_where_they_wait(name):
    assert name not in ALIASES.values()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_config(name)


@pytest.mark.parametrize("pattern,item", [((("swa", "dense"),), 4), ((("rglru", "dense"),), 4),
                                          ((("mla", "dense"),), 4)])
def test_unported_mixers_say_where_they_wait(pattern, item):
    from repro_torch.models.config import MLACfg, RGLRUCfg
    cfg = get_smoke_config(ARCH).scaled(pattern=pattern, rglru=RGLRUCfg(), mla=MLACfg())
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        TM.param_defs(cfg)
