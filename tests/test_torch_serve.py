"""The port's serving plane: tests/test_serve.py on the torch backend,
token-stream parity with ``JaxDecodeBackend`` on the same fp32 weights
(all ten architectures, seamless-m4t-medium on the reference's zero cross
memory), a continuous run and the launcher."""
from __future__ import annotations

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.serve import JaxDecodeBackend
from repro.serve import Request as JaxRequest
from repro.serve import WrathServeDriver as JaxDriver
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.serve import Request, TorchDecodeBackend, WrathServeDriver


def _reqs(cfg, n, new_tokens=6, cls=Request, prompt_len=5):
    rng = np.random.default_rng(1)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=prompt_len).tolist(),
                max_new_tokens=new_tokens) for i in range(n)]


def _driver(n_replicas, **kw):
    cfg = get_smoke_config("granite_3_2b")
    backend = TorchDecodeBackend(cfg, max_batch=4, device="cpu")
    return WrathServeDriver(cfg, n_replicas=n_replicas, max_batch=4, decode=backend, **kw)


@pytest.fixture(scope="module")
def driver():
    return _driver(3)


def test_serve_clean(driver):
    reqs = _reqs(driver.cfg, 6)
    rep = driver.serve(reqs)
    assert rep.completed == 6 and rep.failed == 0
    assert all(len(r.generated) == 6 for r in reqs)
    assert rep.tokens_generated == 36


def test_serve_replica_failover():
    driver = _driver(3)
    reqs = _reqs(driver.cfg, 4)
    rep = driver.serve(reqs, kill_replica_at=("replica0", 4))
    assert rep.completed == 4 and rep.failed == 0
    assert rep.recoveries and rep.recoveries[0]["action"] in ("retry", "restart_retry")
    assert "replica0" in rep.denylisted
    assert all(len(r.generated) == r.max_new_tokens for r in reqs)


def test_serve_all_replicas_dead_fails_gracefully():
    driver = _driver(1)
    reqs = _reqs(driver.cfg, 2)
    rep = driver.serve(reqs, kill_replica_at=("replica0", 2))
    assert rep.failed == 2
    assert rep.completed == 0


def _fp32_pair(max_len=64, arch="granite_3_2b"):
    """A JaxDecodeBackend and a TorchDecodeBackend on the same fp32 weights."""
    jc = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    jb = JaxDecodeBackend(jc, max_batch=4, max_len=max_len)
    jb.params = jax.tree.map(lambda x: x.astype(jnp.float32)
                             if jnp.issubdtype(x.dtype, jnp.floating) else x, jb.params)
    tb = TorchDecodeBackend(tc, max_batch=4, max_len=max_len, device="cpu")
    tb.params = params_from_numpy(jax.tree.map(np.asarray, jb.params), "cpu")
    return jc, tc, jb, tb


@pytest.mark.parametrize("arch", ["granite_3_2b", "mamba2_780m", "minitron_4b", "olmoe_1b_7b",
                                  "seamless_m4t_medium", "recurrentgemma_9b", "gemma3_27b",
                                  "llava_next_34b", "deepseek_67b", "deepseek_v3_671b"])
def test_token_streams_match_jax_backend(arch):
    """A full static serve() with a replica kill gives the same tokens on
    both backends (fresh replicas, the same fp32 weights).  The reference's
    backend never fills an enc-dec model's cross memory (its replica cache
    is the zero ``cache_defs``), so seamless decodes against zeros on both.
    The serve plane sends token ids, so llava (an ``embeds`` model) decodes
    them through its embedding table on both."""
    jc, tc, jb, tb = _fp32_pair(arch=arch)
    jreqs = _reqs(jc, 6, new_tokens=8, cls=JaxRequest)
    treqs = _reqs(tc, 6, new_tokens=8)
    jrep = JaxDriver(jc, n_replicas=2, max_batch=4, decode=jb).serve(
        jreqs, kill_replica_at=("replica0", 3))
    trep = WrathServeDriver(tc, n_replicas=2, max_batch=4, decode=tb).serve(
        treqs, kill_replica_at=("replica0", 3))
    assert trep.completed == jrep.completed == 6
    assert trep.recoveries == jrep.recoveries
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]


def test_decode_logits_match_jax_backend():
    jc, tc, jb, tb = _fp32_pair(max_len=16)

    class Replica:
        name, healthy = "r", True

    jb.start_replica(Replica)
    tb.start_replica(Replica)
    rng = np.random.default_rng(2)
    for _ in range(5):
        toks = rng.integers(0, jc.vocab_size, size=(4, 1)).astype(np.int32)
        jl, jb._caches["r"] = jb._decode(jb.params, jb._caches["r"],
                                          {"inputs": jnp.asarray(toks)})
        tl, tb._caches["r"] = tb._decode(tb.params, tb._caches["r"],
                                          {"inputs": torch.from_numpy(toks)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3, atol=2e-3)


def test_serve_continuous_clean():
    with _driver(2) as driver:
        reqs = _reqs(driver.cfg, 6)
        rep = driver.serve_continuous(reqs, horizon=60.0)
    assert rep.completed == 6 and rep.failed == 0 and rep.rejected == 0
    assert all(len(r.generated) == 6 for r in reqs)
    assert rep.decode_steps > 0 and rep.p99_s >= rep.p50_s > 0


@pytest.mark.parametrize("argv", [
    ["--device", "cpu", "--kill", "replica0:5", "--requests", "4"],
    ["--arch", "mamba2-780m", "--device", "cpu", "--kill", "replica0:5", "--requests", "4"],
    ["--arch", "olmoe-1b-7b", "--device", "cpu", "--kill", "replica0:5", "--requests", "4"],
    ["--arch", "minitron-4b", "--device", "cpu", "--kill", "replica0:5", "--requests", "4"],
    ["--arch", "recurrentgemma-9b", "--device", "cpu", "--kill", "replica0:5", "--requests", "4"],
    ["--arch", "gemma3-27b", "--device", "cpu", "--kill", "replica0:5", "--requests", "4"],
    ["--arch", "deepseek-v3-671b", "--device", "cpu", "--kill", "replica0:5", "--requests", "4"],
    ["--decode", "sim", "--continuous", "--kill", "replica1:3", "--requests", "12"]])
def test_launcher(argv, monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", *argv, "--json"])
    serve.main()
    out = json.loads(capsys.readouterr().out)
    assert out["failed"] == 0 and out["completed"] == out["tokens"] // 8
    assert out["denylisted"] and out["recoveries"]
