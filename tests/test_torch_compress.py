"""The port's int8 error-feedback compressor (``repro_torch.optim.compress``)
against ``repro.optim.compress``: the reference's hypothesis property on
the port, and both packages on the same numpy inputs (q equal, scale and
the carried error at fp32 rounding), leaf by leaf and as trees."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st

from repro.optim import compress as J
from repro_torch.optim import compress_int8, compress_tree, decompress_int8, decompress_tree


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 1000))
def test_int8_compression_error_feedback(seed):
    """The reference's property (tests/test_distributed.py) on the port."""
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(64).astype(np.float32)) * 0.1
    q, scale, err = compress_int8(g)
    deq = decompress_int8(q, scale)
    # quantization error bounded by scale/2 per element
    assert float((deq - g).abs().max()) <= float(scale) * 0.5 + 1e-9
    # with error feedback the long-run average is unbiased: feeding the same
    # gradient with carried error converges to the true value
    acc = torch.zeros_like(g)
    e = None
    for _ in range(32):
        q, s, e = compress_int8(g, e)
        acc = acc + decompress_int8(q, s)
    np.testing.assert_allclose((acc / 32).numpy(), g.numpy(), atol=float(s) * 0.6)


def _close_fp32(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_err", [False, True], ids=["no_err", "err"])
def test_compress_int8_matches_jax(with_err, dtype):
    rng = np.random.default_rng(5)
    g = rng.standard_normal((32, 48)).astype(np.float32) * 0.05
    # halves land on .5 after scaling: round half to even in both
    g[0, :4] = np.array([0.5, 1.5, 2.5, -2.5], np.float32) * (np.abs(g).max() / 127.0)
    err = rng.standard_normal(g.shape).astype(np.float32) * 1e-3 if with_err else None
    jg = jnp.asarray(g).astype(dtype)
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    jq, js, je = J.compress_int8(jg, None if err is None else jnp.asarray(err))
    tq, ts, te = compress_int8(tg, None if err is None else torch.from_numpy(err))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and te.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    _close_fp32(ts, js)
    _close_fp32(te, je)
    _close_fp32(decompress_int8(tq, ts), J.decompress_int8(jq, js))


def test_compress_tree_matches_jax():
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((8, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32),
                  rng.standard_normal((2, 3)).astype(np.float32) * 10]}
    errs = jax.tree.map(lambda x: (x * 1e-3).astype(np.float32), tree)
    jq, js, je = J.compress_tree(jax.tree.map(jnp.asarray, tree),
                                 jax.tree.map(jnp.asarray, errs))
    to_t = lambda t: jax.tree.map(torch.from_numpy, t)  # noqa: E731
    tq, ts, te = compress_tree(to_t(tree), to_t(errs))
    for got, want in ((tq["a"], jq["a"]), (tq["b"][0], jq["b"][0]), (tq["b"][1], jq["b"][1])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in ((ts, js), (te, je), (decompress_tree(tq, ts), J.decompress_tree(jq, js))):
        _close_fp32(got["a"], want["a"])
        _close_fp32(got["b"][0], want["b"][0])
        _close_fp32(got["b"][1], want["b"][1])
    # without an error tree every leaf starts from none
    q0, _, _ = compress_tree(to_t(tree))
    np.testing.assert_array_equal(q0["a"].numpy(), np.asarray(J.compress_tree(
        jax.tree.map(jnp.asarray, tree))[0]["a"]))
