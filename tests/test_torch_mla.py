"""deepseek-v3's multi-head latent attention (MLA) and multi-token
prediction (MTP) in the port against ``repro.models`` on the same numpy
inputs (fp32): ``mla_train`` with its cache, the absorbed ``mla_decode``
(also past a wrapped slot), ``loss_fn`` with the MTP loss and its
gradients, and the flash kernel's plain versions at q/k dim 192 with v
dim 128 against the reference's ``blockwise_mha``; the TMA layout of v
where it is narrower than q and k.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as J
import repro.models.model as JM
import repro_torch.models.layers as T
import repro_torch.models.model as TM
from repro.configs import get_smoke_config as jax_smoke
from repro.models import spec as JS
from repro_torch.models import spec as TS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed.step import loss_and_grads
from repro_torch.kernels.flash_attention import BLOCK_Q, default_kv_tile, layout_array, tma_layout
from repro_torch.kernels.ops import flash_attention
from repro_torch.kernels.ref import flash_attention_lse_ref, flash_attention_ref

ARCH = "deepseek_v3_671b"


def _cfgs():
    jc = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="float32")
    return jc, tc


def _mla_params(rng, cfg):
    """An MLA block's weights at 1 / sqrt(fan-in), its norms near 0."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)

    return {"wq_a": w(d, m.q_lora_rank),
            "q_norm": (0.1 * rng.standard_normal(m.q_lora_rank)).astype(np.float32),
            "wq_b": w(m.q_lora_rank, h * m.qk_head_dim),
            "wkv_a": w(d, m.kv_lora_rank),
            "kv_norm": (0.1 * rng.standard_normal(m.kv_lora_rank)).astype(np.float32),
            "wkv_b": w(m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)),
            "wk_rope": w(d, m.qk_rope_head_dim),
            "wo": w(h * m.v_head_dim, d)}


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_mla_defs_match_reference():
    jc, tc = _cfgs()
    jd, td = J.make_mla_defs(jc), T.make_mla_defs(tc)
    assert sorted(jd) == sorted(td)
    for name in jd:
        assert jd[name].shape == td[name].shape and jd[name].axes == td[name].axes, name
        assert jnp.dtype(jd[name].dtype).name == str(td[name].dtype).removeprefix("torch.")
    assert td["q_norm"].dtype == td["kv_norm"].dtype == torch.float32


@pytest.mark.parametrize("s", [16, 128])   # 128: the blockwise loop over 64-row q blocks
def test_mla_train_with_cache_matches(s):
    jc, tc = _cfgs()
    rng = np.random.default_rng(s)
    p = _mla_params(rng, jc)
    x = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    jout, jcache = J.mla_train({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jc,
                               return_cache=True)
    tout, tcache = T.mla_train(params_from_numpy(p, "cpu"), torch.from_numpy(x), tc,
                               return_cache=True)
    _close(tout, jout, 1e-5)
    assert sorted(tcache) == ["ckv", "k_rope"]
    for name in tcache:
        assert tuple(tcache[name].shape) == jcache[name].shape
        _close(tcache[name], jcache[name], 1e-5)
    np.testing.assert_allclose(np.asarray(J.mla_train(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jc)), jout, rtol=0, atol=0)


@pytest.mark.parametrize("start,smax", [(5, 12), (13, 12)])   # (13, 12): the ring wrapped
def test_mla_decode_matches(start, smax):
    """Four absorbed decode steps from a random latent cache holding
    ``start`` tokens: output, ckv, k_rope and len, against the reference."""
    jc, tc = _cfgs()
    m = jc.mla
    rng = np.random.default_rng(start)
    p = _mla_params(rng, jc)
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, params_from_numpy(p, "cpu")
    ckv = rng.standard_normal((2, smax, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((2, smax, m.qk_rope_head_dim)).astype(np.float32)
    jcache = {"ckv": jnp.asarray(ckv), "k_rope": jnp.asarray(kr),
              "len": jnp.asarray(start, jnp.int32)}
    tcache = {"ckv": torch.from_numpy(ckv.copy()), "k_rope": torch.from_numpy(kr.copy()),
              "len": torch.tensor(start, dtype=torch.int32)}
    for _ in range(4):
        x = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
        jout, jcache = J.mla_decode(jp, jnp.asarray(x), jcache, jc)
        tout, tcache = T.mla_decode(tp, torch.from_numpy(x), tcache, tc)
        assert tout.shape == (2, 1, jc.d_model)
        _close(tout, jout, 1e-5)
        for name in ("ckv", "k_rope"):
            _close(tcache[name], jcache[name], 1e-5)
        assert int(tcache["len"]) == int(jcache["len"])


def test_mla_decode_continues_the_prefill():
    """Prefill 12 tokens through ``mla_train``, decode 4 more from its
    latent cache: the absorbed decode's outputs equal the materialised
    forward's over all 16 (the port alone; the two sum in other orders)."""
    _, tc = _cfgs()
    rng = np.random.default_rng(9)
    tp = params_from_numpy(_mla_params(rng, tc), "cpu")
    x = torch.from_numpy(rng.standard_normal((2, 16, tc.d_model)).astype(np.float32))
    want = T.mla_train(tp, x, tc)
    _, c = T.mla_train(tp, x[:, :12], tc, return_cache=True)
    cache = {name: torch.zeros((2, 16, c[name].shape[-1])) for name in c}
    for name in c:
        cache[name][:, :12] = c[name]
    cache["len"] = torch.tensor(12, dtype=torch.int32)
    for t in range(12, 16):
        out, cache = T.mla_decode(tp, x[:, t:t + 1], cache, tc)
        _close(out[:, 0], want[:, t].numpy(), 1e-5)


def test_loss_fn_with_mtp_matches():
    """deepseek-v3's loss_fn (remat, the CE in chunks of 16): the CE, the
    MoE aux loss, the MTP loss and their sum, and every gradient (the MTP
    block's among them), at tests/test_models.py's 2e-3."""
    remat, ce_chunk = True, 16
    jc, tc = _cfgs()
    assert jc.mtp and tc.mtp
    # the same fp32 weights on both sides, drawn by the port (drawing them
    # leaf by leaf in JAX compiles a sampler per shape: ~15 s on the CPU)
    tp = TS.tree_map(lambda t: t.float() if t.is_floating_point() else t,
                     TS.materialize(TM.param_defs(tc), 11, "cpu"))
    jp = TS.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    assert jax.tree.structure(jp) == jax.tree.structure(JM.param_defs(jc), is_leaf=JS.is_def)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, jc.vocab_size, size=(2, 32)).astype(np.int32)
    targets = rng.integers(0, jc.vocab_size, size=(2, 32)).astype(np.int32)
    targets[1, 20:] = -1

    def jloss(p):
        return JM.loss_fn(p, {"inputs": jnp.asarray(ids), "targets": jnp.asarray(targets)},
                          jc, remat=remat, ce_chunk=ce_chunk)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tl, tm, tg = loss_and_grads(tp, {"inputs": torch.from_numpy(ids),
                                     "targets": torch.from_numpy(targets)},
                                tc, remat=remat, ce_chunk=ce_chunk)
    assert set(tm) == {"ce_loss", "aux_loss", "mtp_loss"}
    for got, want in ((tl, jl), *((tm[k], jm[k]) for k in tm)):
        np.testing.assert_allclose(float(got), float(want), rtol=2e-3, atol=2e-3)
    assert float(tm["mtp_loss"]) > 0 and float(tm["aux_loss"]) > 0
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jg))
    worst = 0.0
    for path, j in flat_j.items():
        node = tg
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        want = np.asarray(j, np.float32)
        worst = max(worst, float(np.max(np.abs(node.numpy() - want) / (1 + np.abs(want)))))
    assert len(flat_j) == len(jax.tree.leaves(jp))
    assert worst <= 2e-3
    assert float(np.abs(np.asarray(jg["mtp"]["proj"])).max()) > 0


@pytest.mark.parametrize("s,causal", [(100, True), (200, True), (96, False)])
def test_plain_flash_matches_blockwise_mha_at_192_128(s, causal):
    """The flash kernel's plain versions at deepseek-v3's head dims (q/k
    192, v 128; causal, ragged S) against the reference's blockwise_mha,
    the function the Pallas kernel has no dv != d path for."""
    cfg = get_config(ARCH)
    assert cfg.mla.qk_head_dim == 192 and cfg.mla.v_head_dim == 128
    rng = np.random.default_rng(s)
    q = rng.standard_normal((2, s, 4, 192)).astype(np.float32)
    k = rng.standard_normal((2, s, 4, 192)).astype(np.float32)
    v = rng.standard_normal((2, s, 4, 128)).astype(np.float32)
    want = J.blockwise_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=causal)
    assert flash_attention.launches == before and got.shape == (2, s, 4, 128)
    _close(got, want, 1e-4)
    _close(flash_attention_ref(tq, tk, tv, causal=causal), want, 1e-4)
    _close(T.blockwise_mha(tq, tk, tv, causal=causal), want, 1e-4)
    lse = flash_attention_lse_ref(tq, tk, tv, causal=causal)
    assert lse.shape == (2, 4, s) and bool(torch.isfinite(lse).all())


def test_layout_array_takes_v_narrower_than_k():
    """A bf16 launch's 33 layout values: q's, k's and v's own (v at 128
    columns, two boxes a row, beside q's and k's 192, three)."""
    def contiguous(shape):
        return torch.empty(shape, device="meta").stride()

    q, k, v = (4, 1024, 128, 192), (4, 1024, 128, 192), (4, 1024, 128, 128)
    BLOCK_KV = default_kv_tile(192, 128)
    arr = layout_array(q, contiguous(q), k, contiguous(k), BLOCK_Q, BLOCK_KV, v, contiguous(v))
    want = (tma_layout(q, contiguous(q), 2, BLOCK_Q).flat()
            + tma_layout(k, contiguous(k), 2, BLOCK_KV).flat()
            + tma_layout(v, contiguous(v), 2, BLOCK_KV).flat())
    assert list(arr) == list(want) and len(arr) == 33
    assert list(arr)[22:33] == [128, 128, 1024, 4, 256, 256 * 128, 256 * 128 * 1024,
                                64, 1, BLOCK_KV, 1]
    # without v's own, v's layout is k's (the backward's launches)
    same = layout_array(q, contiguous(q), k, contiguous(k), BLOCK_Q, BLOCK_KV)
    assert list(same)[22:] == list(same)[11:22] and same is not arr
