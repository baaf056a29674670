"""The port's encoder-decoder backbone (seamless-m4t-medium) against
``repro.models.model`` with the same weights.

Smoke size, fp32, tolerance 2e-3 (tests/test_models.py): the encoder's
output, the forward's logits, the prefill's logits and cache (self- and
cross-attention entries), ``prefill_cross_memory`` and 16 decode steps.
Each runs with the encoder as long as the decoder (16 frames) and longer
(24 frames), so the cross-attention has Sk != S on the CPU as it has on
the card.
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
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import spec as TS

ARCH = "seamless_m4t_medium"
B, S = 2, 16


def _close(got, want, tol=2e-3):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def weights():
    jc = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="float32")
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      JS.materialize(JM.param_defs(jc), jax.random.PRNGKey(11)))
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module", params=[16, 24], ids=lambda n: f"enc{n}")
def setup(request, weights):
    """The weights and one batch: decoder ids (B, 16), encoder frames
    (B, enc_len, d), as numpy, JAX and torch batches."""
    rng = np.random.default_rng(request.param)
    ids = rng.integers(0, weights[0].vocab_size, size=(B, S)).astype(np.int32)
    enc = (rng.standard_normal((B, request.param, weights[0].d_model)) * 0.5).astype(np.float32)
    jbatch = {"inputs": jnp.asarray(ids), "enc_embeds": jnp.asarray(enc)}
    tbatch = {"inputs": torch.from_numpy(ids), "enc_embeds": torch.from_numpy(enc)}
    return (*weights, jbatch, tbatch)


def _fp32_cache(jc):
    """A zero decode cache with fp32 floating leaves, as tests/test_models.py
    decodes (the defs' bf16 would round each memory value once more)."""
    cache = JS.materialize(JM.cache_defs(jc, B, S), jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: x.astype(jnp.float32)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x, cache)


def _rows(defs, is_def, dtype_name, path=()):
    if is_def(defs):
        return [(path, tuple(defs.shape), tuple(defs.axes), defs.init, defs.scale,
                 dtype_name(defs.dtype))]
    items = defs.items() if isinstance(defs, dict) else enumerate(defs)
    return [r for k, v in items for r in _rows(v, is_def, dtype_name, path + (k,))]


@pytest.mark.parametrize("smoke", [False, True])
def test_config_and_defs_equal_reference(smoke):
    jc = jax_smoke(ARCH) if smoke else jax_config(ARCH)
    tc = get_smoke_config(ARCH) if smoke else get_config("seamless-m4t-medium")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc) and tc.encoder_layers
    trows = lambda d: sorted(_rows(d, TS.is_def, lambda t: str(t).removeprefix("torch.")))  # noqa: E731
    jrows = lambda d: sorted(_rows(d, JS.is_def, lambda t: jnp.dtype(t).name))  # noqa: E731
    assert trows(TM.param_defs(tc)) == jrows(JM.param_defs(jc))
    assert trows(TM.cache_defs(tc, 3, 40)) == jrows(JM.cache_defs(jc, 3, 40))
    assert TS.param_count(TM.param_defs(tc)) == JS.param_count(JM.param_defs(jc))
    assert "encoder" in TM.param_defs(tc)
    assert "cross" in TM.cache_defs(tc, 1, 8)["segments"][0]["0"]


def test_encoder_output_matches(setup):
    jc, tc, jp, tp, jbatch, tbatch = setup
    want = JM._encoder_forward(jp, jbatch, jc, remat=False)
    got = TM._encoder_forward(tp, tbatch, tc)
    assert got.shape == tuple(want.shape)
    _close(got, want)


def test_forward_train_logits_match(setup):
    jc, tc, jp, tp, jbatch, tbatch = setup
    jh, jenc, _ = JM.forward_train(jp, jbatch, jc, remat=False)
    th, tenc, aux = TM.forward_train(tp, tbatch, tc)
    assert float(aux) == 0.0
    _close(tenc, jenc)
    _close(th, jh)
    _close(TM._logits(tp, th, tc), JM._logits(jp, jh, jc))


def test_prefill_logits_and_cache_match(setup):
    jc, tc, jp, tp, jbatch, tbatch = setup
    jl, jcache = JM.prefill_forward(jp, jbatch, jc, remat=False)
    tl, tcache = TM.prefill_forward(tp, tbatch, tc)
    _close(tl, jl)
    jentry, tentry = jcache["segments"][0]["0"], tcache["segments"][0]["0"]
    assert set(tentry) == set(jentry) == {"attn", "cross"}
    for kind in ("attn", "cross"):
        for name in ("k", "v"):
            assert tentry[kind][name].shape == jentry[kind][name].shape
            _close(tentry[kind][name], jentry[kind][name])
    assert tentry["attn"]["len"].tolist() == np.asarray(jentry["attn"]["len"]).tolist()


def test_prefill_cross_memory_matches(setup):
    jc, tc, jp, tp, jbatch, tbatch = setup
    enc_len = tbatch["enc_embeds"].shape[1]
    jenc = JM._encoder_forward(jp, jbatch, jc, remat=False)
    jcache = _fp32_cache(jc)
    tcache = params_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    jmem = JM.prefill_cross_memory(jp, jcache, jenc, jc)
    tmem = TM.prefill_cross_memory(tp, tcache, TM._encoder_forward(tp, tbatch, tc), tc)
    _, pcache = TM.prefill_forward(tp, tbatch, tc)
    for name in ("k", "v"):
        got = tmem["segments"][0]["0"]["cross"][name]
        assert got.shape == (tc.n_layers, B, enc_len, tc.n_kv_heads, tc.resolved_head_dim)
        _close(got, jmem["segments"][0]["0"]["cross"][name])
        # the same memory the prefill captures
        _close(got, pcache["segments"][0]["0"]["cross"][name].numpy(), tol=1e-5)
    # the self-attention cache passes through untouched
    assert tmem["segments"][0]["0"]["attn"]["k"] is tcache["segments"][0]["0"]["attn"]["k"]


def _filled_caches(setup):
    jc, tc, jp, tp, jbatch, tbatch = setup
    jcache = _fp32_cache(jc)
    tcache = params_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    jenc = JM._encoder_forward(jp, jbatch, jc, remat=False)
    jcache = JM.prefill_cross_memory(jp, jcache, jenc, jc)
    tcache = TM.prefill_cross_memory(tp, tcache, TM._encoder_forward(tp, tbatch, tc), tc)
    return jcache, tcache


def test_decode_steps_match(setup):
    jc, tc, jp, tp, jbatch, tbatch = setup
    jcache, tcache = _filled_caches(setup)
    ids = np.array(jbatch["inputs"])
    step = jax.jit(lambda p, c, x: JM.decode_step(p, c, {"inputs": x}, jc))
    for t in range(S):
        jl, jcache = step(jp, jcache, jnp.asarray(ids[:, t:t + 1]))
        tl, tcache = TM.decode_step(tp, tcache, {"inputs": torch.from_numpy(ids[:, t:t + 1])}, tc)
        _close(tl, jl)
    _close(tcache["segments"][0]["0"]["attn"]["k"], jcache["segments"][0]["0"]["attn"]["k"])


def test_decode_matches_train_forward(setup):
    """The port's own test_decode_matches_train_forward[seamless_m4t_medium]:
    decode against the cross memory reproduces the full-sequence forward."""
    _, tc, _, tp, _, tbatch = setup
    h, _, _ = TM.forward_train(tp, tbatch, tc)
    train_logits = TM._logits(tp, h, tc)
    _, cache = _filled_caches(setup)
    dec = []
    for t in range(S):
        logits, cache = TM.decode_step(tp, cache, {"inputs": tbatch["inputs"][:, t:t + 1]}, tc)
        dec.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(dec, dim=1), train_logits, rtol=2e-3, atol=2e-3)


def test_decode_with_explicit_cross_memory(setup):
    """``batch["cross_memory"]`` takes the place of every layer's cached
    memory, as in the reference; a zero memory adds nothing (softmax of
    equal scores over zero values), which is what a serve replica whose
    cache was never filled decodes against."""
    jc, tc, jp, tp, jbatch, tbatch = setup
    jcache, tcache = _filled_caches(setup)
    mem = {k: v[0] for k, v in tcache["segments"][0]["0"]["cross"].items()}   # layer 0's
    jmem = {k: v[0] for k, v in jcache["segments"][0]["0"]["cross"].items()}
    x = np.array(jbatch["inputs"])[:, :1]
    jl, _ = JM.decode_step(jp, jcache, {"inputs": jnp.asarray(x), "cross_memory": jmem}, jc)
    tl, _ = TM.decode_step(tp, tcache, {"inputs": torch.from_numpy(x), "cross_memory": mem}, tc)
    _close(tl, jl)
    zero = TS.materialize(TM.cache_defs(tc, B, S), 0, "cpu")
    zl, _ = TM.decode_step(tp, zero, {"inputs": torch.from_numpy(x)}, tc)
    nl, _ = TM.decode_step(tp, TS.materialize(TM.cache_defs(tc, B, S), 0, "cpu"),
                           {"inputs": torch.from_numpy(x),
                            "cross_memory": TS.tree_map(torch.zeros_like, mem)}, tc)
    torch.testing.assert_close(zl, nl)
