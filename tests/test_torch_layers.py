"""The port's dense layers against ``repro.models.layers`` on the same
numpy inputs (fp32; tolerances 1e-5 to 1e-4 from fp32 summation order)."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as J
import repro_torch.models.layers as T
from repro.configs import get_smoke_config as jax_smoke
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as torch_smoke


def _rng(seed=0):
    return np.random.default_rng(seed)


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor)
                                          else got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _cfgs(**over):
    jc = dataclasses.replace(jax_smoke("granite_3_2b"), compute_dtype="float32", **over)
    tc = dataclasses.replace(torch_smoke("granite_3_2b"), compute_dtype="float32", **over)
    return jc, tc


def _attn_params(rng, cfg):
    d, hd, h, kv = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    s = 1 / np.sqrt(d)
    return {"wq": _n(rng, d, h * hd, scale=s), "wk": _n(rng, d, kv * hd, scale=s),
            "wv": _n(rng, d, kv * hd, scale=s), "wo": _n(rng, h * hd, d, scale=s)}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 64)])
def test_rms_norm(shape):
    rng = _rng(1)
    x, w = _n(rng, *shape), _n(rng, shape[-1], scale=0.1)
    _close(T.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           J.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), 1e-5)


def test_rms_norm_bf16_casts_like_the_reference():
    rng = _rng(2)
    x, w = _n(rng, 4, 64), _n(rng, 64, scale=0.1)
    got = T.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w))
    want = J.rms_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w))
    assert got.dtype == torch.bfloat16
    _close(got, want.astype(jnp.float32), 1e-2)


@pytest.mark.parametrize("x_shape,pos_shape", [((2, 7, 3, 16), (7,)),
                                               ((2, 7, 3, 16), (2, 7)),
                                               ((2, 7, 16), (7,))])
def test_apply_rope(x_shape, pos_shape):
    rng = _rng(3)
    x = _n(rng, *x_shape)
    pos = rng.integers(0, 500, size=pos_shape).astype(np.int32)
    _close(T.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
           J.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), 1e-4)


def test_swiglu():
    rng = _rng(4)
    p = {"w1": _n(rng, 32, 48, scale=0.2), "w3": _n(rng, 32, 48, scale=0.2),
         "w2": _n(rng, 48, 32, scale=0.2)}
    x = _n(rng, 2, 5, 32)
    _close(T.swiglu(params_from_numpy(p, "cpu"), torch.from_numpy(x)),
           J.swiglu(_j(p), jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (True, 16, 0), (False, 0, 0), (True, 0, 8), (False, 12, 8)])
def test_mha(causal, window, q_offset):
    rng = _rng(5)
    q, k, v = _n(rng, 2, 24, 4, 16), _n(rng, 2, 32, 2, 16), _n(rng, 2, 32, 2, 16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _close(T.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw),
           J.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw), 1e-5)


@pytest.mark.parametrize("s,window", [(256, 0), (256, 32), (256, 200), (96, 0)])
def test_blockwise_mha(s, window):
    rng = _rng(6)
    q, k, v = _n(rng, 2, s, 4, 16), _n(rng, 2, s, 2, 16), _n(rng, 2, s, 2, 16)
    _close(T.blockwise_mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           causal=True, window=window),
           J.blockwise_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=window), 1e-5)


def test_pad_heads():
    jc, tc = _cfgs(head_pad=8)
    rng = _rng(7)
    q, k, v = _n(rng, 1, 5, 4, 16), _n(rng, 1, 5, 2, 16), _n(rng, 1, 5, 2, 16)
    got = T._pad_heads(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tc)
    want = J._pad_heads(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc)
    assert got[3] == want[3] == 4
    for g, w in zip(got[:3], want[:3]):
        assert tuple(g.shape) == w.shape
        _close(g, w, 0)


@pytest.mark.parametrize("head_pad", [0, 8])
def test_attention_train_with_kv(head_pad):
    jc, tc = _cfgs(head_pad=head_pad)
    rng = _rng(8)
    p = _attn_params(rng, jc)
    x = _n(rng, 2, 12, jc.d_model)
    got, got_kv = T.attention_train(params_from_numpy(p, "cpu"), torch.from_numpy(x), tc,
                                    return_kv=True)
    want, want_kv = J.attention_train(_j(p), jnp.asarray(x), jc, return_kv=True)
    _close(got, want, 1e-4)
    for name in ("k", "v"):
        _close(got_kv[name], want_kv[name], 1e-5)


def test_attention_decode_ring_buffer():
    """Steps past the buffer wrap onto slot len % Smax, as the reference."""
    jc, tc = _cfgs()
    rng = _rng(9)
    p = _attn_params(rng, jc)
    b, smax, kv, hd = 2, 6, jc.n_kv_heads, jc.resolved_head_dim
    jcache = {"k": jnp.zeros((b, smax, kv, hd)), "v": jnp.zeros((b, smax, kv, hd)),
              "len": jnp.asarray(0, jnp.int32)}
    tcache = params_from_numpy({k: np.asarray(v) for k, v in jcache.items()}, "cpu")
    tp = params_from_numpy(p, "cpu")
    for step in range(9):
        x = _n(rng, b, 1, jc.d_model)
        want, jcache = J.attention_decode(_j(p), jnp.asarray(x), jcache, jc)
        got, tcache = T.attention_decode(tp, torch.from_numpy(x), tcache, tc)
        _close(got, want, 1e-4)
        _close(tcache["k"], jcache["k"], 1e-5)
        assert int(tcache["len"]) == int(jcache["len"]) == step + 1
