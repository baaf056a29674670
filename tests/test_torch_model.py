"""The port's decoder-only attention models against ``repro.models`` with
the same weights: granite-3-2b, minitron-4b (head padding, D 128),
olmoe-1b-7b (MoE FFNs), gemma3-27b (5 sliding-window : 1 global layers),
recurrentgemma-9b (2 RG-LRU : 1 sliding-window layers, MQA),
llava-next-34b (embedding inputs, head padding), deepseek-67b (dense GQA)
and deepseek-v3-671b (MLA with absorbed decode, a dense layer before the
MoE layers with a shared expert, multi-token prediction).

JAX materializes the weights; ``repro_torch.bridge.params_from_numpy``
carries them across.  Smoke size, fp32: logits, prefill caches and a
16-step decode match at 2e-3, the tolerance of tests/test_models.py.
Prompts longer than the smoke window (32) check the ring-buffer cache:
the prefill's rolled buffers equal the reference's, and decode from
them reproduces the forward.
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
ARCHS = ("granite_3_2b", "minitron_4b", "olmoe_1b_7b", "gemma3_27b", "recurrentgemma_9b",
         "llava_next_34b", "deepseek_67b", "deepseek_v3_671b")
WINDOWED = ("gemma3_27b", "recurrentgemma_9b")


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
    ids = _tokens(jc, np.random.default_rng(0), 2, 16)
    return jc, tc, jp, tp, ids


def _tokens(cfg, rng, b, s):
    """A model's input sequence: token ids, or for an ``embeds`` model
    (llava) embeddings at the embedding table's scale, drawn from ``rng``."""
    if cfg.input_kind == "embeds":
        return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _feed(cfg, x):
    """The batch entry of an input sequence (numpy, jax or torch)."""
    return {"embeds" if cfg.input_kind == "embeds" else "inputs": x}


def _close(got, want, tol=2e-3):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _leaves(tree, path=()):
    """{path: leaf} of a tree of dicts and lists (dict keys sorted)."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _leaves(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _leaves(t, path + (i,)).items()}
    return {path: tree}


def _close_trees(got, want, tol=2e-3, bf16_tol=None):
    """Every leaf of the torch tree ``got`` against the same path of the
    JAX tree ``want``: equal paths, shapes and (integer leaves) values;
    ``bf16_tol``, if given, for leaves stored in bf16 (a value one
    rounding apart in fp32 may round to neighbouring bf16 values)."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for path in g:
        assert tuple(g[path].shape) == tuple(w[path].shape), path
        if g[path].is_floating_point():
            bf16 = g[path].dtype == torch.bfloat16 and bf16_tol is not None
            _close(g[path], w[path], bf16_tol if bf16 else tol)
        else:
            assert g[path].tolist() == np.asarray(w[path]).tolist(), path


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


def test_materialize_draws_large_leaves_in_slices(monkeypatch):
    """A leaf over DRAW_WHOLE elements is drawn slice by slice over its
    leading axes (no fp32 copy of the whole): the same shape, dtype, scale
    and seed-determinism as a leaf drawn whole; a leaf under it is drawn
    as before, bit for bit."""
    defs = {"big": TS.pdef((3, None), (4, None), (50, None)),
            "small": TS.pdef((8, None), (8, None))}
    before = TS.materialize(defs, 5, "cpu")
    monkeypatch.setattr(TS, "DRAW_WHOLE", 100)
    monkeypatch.setattr(TS, "DRAW_SLICE", 60)           # slices of (50,): 12 draws
    a, b = TS.materialize(defs, 5, "cpu"), TS.materialize(defs, 5, "cpu")
    assert torch.equal(a["small"], before["small"])
    assert a["big"].shape == (3, 4, 50) and a["big"].dtype == torch.bfloat16
    assert torch.equal(a["big"], b["big"]) and not torch.equal(a["big"], before["big"])
    assert abs(a["big"].float().std().item() - 1 / np.sqrt(3)) < 0.1   # fan_in = shape[0]
    assert len({tuple(r.tolist()) for r in a["big"].float().reshape(12, 50)}) == 12


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
    jh, _, jaux = JM.forward_train(jp, _feed(jc, jnp.asarray(ids)), jc, remat=False)
    th, enc, aux = TM.forward_train(tp, _feed(tc, torch.from_numpy(ids)), tc)
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
    assert tp["embed"].dtype == torch.bfloat16
    jl, _ = JM.prefill_forward(jp, _feed(jc, jnp.asarray(ids)), jc, remat=False)
    tl, _ = TM.prefill_forward(tp, _feed(tc, torch.from_numpy(ids)), tc)
    assert tl.dtype == torch.float32
    _close(tl, jl)


def test_prefill_logits_and_cache_match(setup):
    jc, tc, jp, tp, ids = setup
    jl, jcache = JM.prefill_forward(jp, _feed(jc, jnp.asarray(ids)), jc, remat=False)
    tl, tcache = TM.prefill_forward(tp, _feed(tc, torch.from_numpy(ids)), tc)
    _close(tl, jl)
    _close_trees(tcache, jcache)


def _bf16_ordinal(x):
    """Each float32 value of ``x`` (a bf16 value widened) as its place in
    the ordered bf16 values: neighbours differ by one."""
    bits = (np.ascontiguousarray(x, np.float32).view(np.uint32) >> 16).astype(np.int64)
    return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)


def _first_segment(cache):
    """The float leaves of a cache's first scan segment, as fp32 numpy."""
    return {p: np.asarray(v.float() if torch.is_tensor(v) else v, np.float32)
            for p, v in _leaves(cache["segments"][0]["0"]).items()
            if (v.is_floating_point() if torch.is_tensor(v)
                else jnp.issubdtype(v.dtype, jnp.floating))}


def test_decode_steps_match(setup):
    jc, tc, jp, tp, ids = setup
    b, s = ids.shape[:2]
    jcache = JS.materialize(JM.cache_defs(jc, b, s), jax.random.PRNGKey(0))
    tcache = params_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    step = jax.jit(lambda p, c, x: JM.decode_step(p, c, _feed(jc, x), jc))
    widen_j = lambda c: jax.tree.map(  # noqa: E731
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x, c)
    widen_t = lambda c: TS.tree_map(  # noqa: E731  (a copy: the step writes in place)
        lambda x: x.to(torch.float32 if x.is_floating_point() else x.dtype, copy=True), c)
    # the first segment's values as each step computes them, before a bf16
    # store rounds them: each step also runs on an fp32 copy of its cache
    raw_j, raw_t = _first_segment(jcache), _first_segment(tcache)
    for t in range(s):
        x = ids[:, t:t + 1]
        for raw, before, after in (
                (raw_j, _first_segment(jcache), step(jp, widen_j(jcache), jnp.asarray(x))[1]),
                (raw_t, _first_segment(tcache),
                 TM.decode_step(tp, widen_t(tcache), _feed(tc, torch.from_numpy(x)), tc)[1])):
            after = _first_segment(after)
            for path in raw:
                raw[path] = np.where(after[path] != before[path], after[path], raw[path])
        jl, jcache = step(jp, jcache, jnp.asarray(x))
        tl, tcache = TM.decode_step(tp, tcache, _feed(tc, torch.from_numpy(x)), tc)
        _close(tl, jl)
    # the first segment's keys (or recurrent state, or MLA latents) at
    # 2e-3, as computed and as stored.  A leaf stored in bf16 holds a value
    # rounded once, so where the two computed values lie on either side of
    # a bf16 rounding boundary they round to neighbouring bf16 values:
    # allowed at few elements, by exactly one bf16 ulp, and only where the
    # reference's computed value is within 2e-3 of the boundary
    first_t, first_j = _first_segment(tcache), _first_segment(jcache)
    attention = "k" in tcache["segments"][0]["0"].get("attn", {})
    for path, got in first_t.items():
        if attention and path[-1] == "v":
            continue                       # an attention layer: its keys
        _close(torch.from_numpy(raw_t[path]), raw_j[path])
        want = first_j[path]
        apart = np.abs(got - want) > 2e-3 + 2e-3 * np.abs(want)
        if not apart.any():
            continue
        assert _leaves(tcache["segments"][0]["0"])[path].dtype == torch.bfloat16, path
        boundary = (got + want)[apart] / 2
        assert (np.abs(_bf16_ordinal(got[apart]) - _bf16_ordinal(want[apart])) == 1).all(), path
        assert (np.abs(raw_j[path][apart] - boundary)
                <= 2e-3 + 2e-3 * np.abs(boundary)).all(), path
        assert apart.sum() <= max(1, got.size // 1000), (path, int(apart.sum()))
    # every layer's cache at the repo's bf16 tolerance where it holds bf16
    # (these caches are drawn bf16)
    _close_trees(tcache, jcache, bf16_tol=2e-2)


def test_decode_matches_train_forward(arch):
    """The port's own test_decode_matches_train_forward[<arch>].  An MoE
    model runs at capacity factor n_experts / top_k, where capacity equals
    the token count and nothing is dropped: at the shipped 1.25 the
    forward's 32 tokens drop assignments a decode step's 2 keep, so the two
    compute different functions (tests/test_models.py leaves olmoe out).
    An ``embeds`` model (llava) decodes its embeddings, as
    tests/test_models.py feeds them; deepseek-v3's absorbed MLA decode
    sums in another order than the prefill's materialised K/V."""
    tc = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    if tc.moe:
        tc = tc.scaled(moe=dataclasses.replace(
            tc.moe, capacity_factor=tc.moe.n_experts / tc.moe.top_k))
    fp32 = lambda tree: TS.tree_map(  # noqa: E731
        lambda x: x.float() if x.is_floating_point() else x, tree)
    params = fp32(TS.materialize(TM.param_defs(tc), 42, "cpu"))
    ids = torch.from_numpy(_tokens(tc, np.random.default_rng(0), 2, 16))
    h, _, _ = TM.forward_train(params, _feed(tc, ids), tc)
    train_logits = TM._logits(params, h, tc)
    cache = fp32(TS.materialize(TM.cache_defs(tc, 2, 16), 0, "cpu"))
    dec = []
    for t in range(16):
        logits, cache = TM.decode_step(params, cache, _feed(tc, ids[:, t:t + 1]), tc)
        dec.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(dec, dim=1), train_logits, rtol=2e-3, atol=2e-3)


def test_every_reference_architecture_is_ported():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    assert sorted(ALIASES.values()) == sorted(JAX_ARCH_IDS)
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("no_such_model")


def test_deepseek_v3_first_3_dense():
    """tests/test_models.py's case, and the scan segments it gives: three
    dense MLA layers, then 58 MoE ones; at the card's cut of 5 layers, 3
    and 2."""
    cfg = get_config("deepseek_v3_671b")
    kinds = cfg.block_kinds()
    assert all(f == "dense" for _, f in kinds[:3])
    assert all(f == "moe" for _, f in kinds[3:])
    assert cfg.scan_segments() == [((("mla", "dense"),), 3), ((("mla", "moe"),), 58)]
    assert cfg.scaled(n_layers=5).scan_segments() == [((("mla", "dense"),), 3),
                                                      ((("mla", "moe"),), 2)]


def test_mla_absorbed_decode_equivalence_is_covered():
    """As tests/test_models.py: the equivalence is
    test_decode_matches_train_forward[deepseek_v3_671b]; here the MLA cache
    is the compressed latent and the roped key, not per-head K/V."""
    cfg = get_smoke_config("deepseek_v3_671b")
    cd = TM.cache_defs(cfg, batch=2, seq_len=16)
    seg0 = cd["segments"][0]["0"]
    assert sorted(seg0["attn"]) == ["ckv", "k_rope", "len"]
    assert seg0["attn"]["ckv"].shape == (1, 2, 16, cfg.mla.kv_lora_rank)
    assert seg0["attn"]["k_rope"].shape == (1, 2, 16, cfg.mla.qk_rope_head_dim)


def test_gemma3_pattern_is_5_local_1_global():
    cfg = get_config("gemma3_27b")
    kinds = cfg.block_kinds()
    for i, (mixer, _) in enumerate(kinds):
        assert mixer == ("attn" if i % 6 == 5 else "swa")
    # 10 units of (5 swa + 1 attn), then the 2 swa layers left over
    assert cfg.scan_segments() == [(cfg.pattern, 10), ((("swa", "dense"),), 2)]


def test_recurrentgemma_segments_are_2_recurrent_1_local():
    cfg = get_config("recurrentgemma_9b")
    assert cfg.scan_segments() == [(cfg.pattern, 12), ((("rglru", "dense"),), 2)]
    assert [m for m, _ in cfg.block_kinds()].count("swa") == 12


def _fp32_model(arch, seed=42):
    tc = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    params = TS.tree_map(lambda x: x.float() if x.is_floating_point() else x,
                         TS.materialize(TM.param_defs(tc), seed, "cpu"))
    return tc, params


def test_swa_ring_buffer_decode_matches_train():
    """Window cache smaller than the sequence: the ring buffer must still
    match (tests/test_models.py's case, in the port alone)."""
    tc, params = _fp32_model("gemma3_27b")
    assert tc.window == 32
    b, s = 1, 48                                  # s > window
    ids = torch.randint(0, tc.vocab_size, (b, s), generator=torch.Generator().manual_seed(1))
    h, _, _ = TM.forward_train(params, {"inputs": ids}, tc)
    train_logits = TM._logits(params, h, tc)
    cache = TS.tree_map(lambda x: x.float() if x.is_floating_point() else x,
                        TS.materialize(TM.cache_defs(tc, b, s), 0, "cpu"))
    assert cache["segments"][0]["0"]["attn"]["k"].shape[2] == 32      # the window
    assert cache["segments"][0]["5"]["attn"]["k"].shape[2] == 48      # a global layer
    dec = []
    for t in range(s):
        logits, cache = TM.decode_step(params, cache, {"inputs": ids[:, t:t + 1]}, tc)
        dec.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(dec, dim=1), train_logits, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("wide", WINDOWED)
def test_prefill_past_the_window_rolls_like_reference(wide):
    """A prompt of 48 tokens over a window of 32 (48 % 32 = 16): every
    cache leaf, the rolled sliding-window buffers among them, equals the
    JAX prefill's; so do the last-token logits."""
    jc = dataclasses.replace(jax_smoke(wide), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(wide), compute_dtype="float32")
    jp = jax.tree.map(jnp.asarray, _fp32_np(JS.materialize(JM.param_defs(jc),
                                                           jax.random.PRNGKey(7))))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ids = np.random.default_rng(2).integers(0, jc.vocab_size, size=(2, 48)).astype(np.int32)
    jl, jcache = JM.prefill_forward(jp, {"inputs": jnp.asarray(ids)}, jc, remat=False)
    tl, tcache = TM.prefill_forward(tp, {"inputs": torch.from_numpy(ids)}, tc)
    _close(tl, jl)
    _close_trees(tcache, jcache)
    swa = [e["attn"] for seg in tcache["segments"] for e in seg.values()
           if "attn" in e and e["attn"]["k"].shape[2] == tc.window]
    assert swa and all(int(e["len"].max()) == 48 for e in swa)


@pytest.mark.parametrize("wide", WINDOWED)
def test_decode_after_wrapped_prefill_matches_forward(wide):
    """Prefill 40 tokens (the ring buffer wrapped: 40 % 32 = 8), then
    decode 8 more from that cache: the logits equal the forward's."""
    tc, params = _fp32_model(wide, seed=3)
    b, s, steps = 2, 40, 8
    ids = torch.randint(0, tc.vocab_size, (b, s + steps), generator=torch.Generator().manual_seed(4))
    h, _, _ = TM.forward_train(params, {"inputs": ids}, tc)
    want = TM._logits(params, h[:, s - 1:], tc)
    logits, pcache = TM.prefill_forward(params, {"inputs": ids[:, :s]}, tc)
    # a global layer's cache is the prompt's length: copy it into a longer
    # one; the window-wide buffers and the recurrent state are the decode cache
    cache = TS.tree_map(lambda x: x.float() if x.is_floating_point() else x,
                        TS.materialize(TM.cache_defs(tc, b, s + steps), 0, "cpu"))
    for dst, src in zip(cache["segments"], pcache["segments"]):
        for u in dst:
            for name, leaf in _leaves(src[u]).items():
                node = dst[u]
                for key in name[:-1]:
                    node = node[key]
                node[name[-1]][:, :, :leaf.shape[2]].copy_(leaf) if leaf.dim() >= 3 \
                    else node[name[-1]].copy_(leaf)
    got = [logits[:, 0]]
    for t in range(steps):
        lg, cache = TM.decode_step(params, cache, {"inputs": ids[:, s + t:s + t + 1]}, tc)
        got.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(got, dim=1), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("wide", WINDOWED + ("deepseek_v3_671b",))
def test_bridge_carries_the_new_trees(wide):
    """bridge.params_from_numpy is a generic tree map: the default (bf16)
    JAX trees of the windowed models (the RG-LRU's fp32 gate leaves among
    them) and of deepseek-v3 (MLA with its fp32 norms, the shared expert,
    the MTP block) cross with every name, shape, dtype and bit kept."""
    jc = jax_smoke(wide)
    jp = JS.materialize(JM.param_defs(jc), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    g, w = _leaves(tp), _leaves(jp)
    assert g.keys() == w.keys()
    for path in g:
        want = np.asarray(w[path])
        assert str(g[path].dtype).removeprefix("torch.") == want.dtype.name, path
        bits = g[path].view(torch.int16) if g[path].dtype == torch.bfloat16 else g[path]
        assert np.array_equal(bits.numpy(), want.view(np.int16) if want.dtype.name == "bfloat16"
                              else want), path
    fp32 = {p[-1] for p in g if g[p].dtype == torch.float32}
    assert ({"b_a", "b_x", "lam"} <= fp32) == (wide == "recurrentgemma_9b")
    assert ({"q_norm", "kv_norm"} <= fp32) == (wide == "deepseek_v3_671b")
    assert any(p[0] == "mtp" for p in g) == (wide == "deepseek_v3_671b")
