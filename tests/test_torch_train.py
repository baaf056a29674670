"""The port's training step against the JAX package on the same inputs.

``loss_fn`` (value and every gradient) and ``build_train_step`` on the
smoke configs of granite-3-2b, minitron-4b, olmoe-1b-7b,
recurrentgemma-9b (the RG-LRU scan and windowed attention under
autograd), mamba2-780m (the SSD scan under autograd), gemma3-27b,
llava-next-34b (fed embeddings) and deepseek-67b; ``loss_fn`` also on
seamless-m4t-medium's; ``adamw_apply``, ``lr_at`` and ``batch_for``, with
fp32 compute; JAX materializes the weights and
``repro_torch.bridge.params_from_numpy`` carries them across.  Also the
CPU training CLI on all ten architectures.
"""
from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as JM
import repro_torch.models.model as TM
from repro.configs import get_smoke_config as jax_smoke
from repro.data import SyntheticTokens as JaxTokens
from repro.data import batch_for as jax_batch_for
from repro.distributed.step import StepConfig as JaxStepConfig
from repro.distributed.step import build_train_step as jax_build_train_step
from repro.models import spec as JS
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import adamw_apply as jax_adamw_apply
from repro.optim import init_opt_state as jax_init_opt_state
from repro.optim import lr_at as jax_lr_at
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticTokens, batch_for
from repro_torch.distributed.step import StepConfig, build_train_step, loss_and_grads
from repro_torch.models.spec import tree_leaves
from repro_torch.optim import OptConfig, adamw_apply, init_opt_state, lr_at, opt_state_defs

ARCH = "granite_3_2b"            # the base of the architecture-free tests
ARCHS = ("granite_3_2b", "minitron_4b", "olmoe_1b_7b", "recurrentgemma_9b", "mamba2_780m",
         "gemma3_27b", "llava_next_34b", "deepseek_67b")
TOL = 2e-3          # tests/test_models.py's fp32 model tolerance
# gemma3-27b's smoke init makes its attention nearly one-hot: elementwise,
# the two packages' fp32 gradients of the first layer's norm read 3e-3
# apart.  Its gradients are held as each leaf's relative L2 error, as the
# encoder-decoder's are (test_loss_fn_matches_encoder_decoder)
REL_L2_ARCHS = ("gemma3_27b",)
# build_train_step's parity: an Adam step's first move is lr * sign(g), so
# where the gradients agree only as relative L2, elements whose gradient is
# rounding noise move either way (0.27% of gemma3's smoke parameters)
STEP_ARCHS = tuple(a for a in ARCHS if a not in REL_L2_ARCHS)


def _scaled_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.float().numpy() - want) / (1 + np.abs(want))))


def _pairs(jtree, ttree, path=""):
    """(path, jax leaf, torch leaf) over matching trees."""
    if isinstance(ttree, dict):
        for k in ttree:
            yield from _pairs(jtree[k], ttree[k], f"{path}/{k}")
    elif isinstance(ttree, list):
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            yield from _pairs(a, b, f"{path}/{i}")
    else:
        yield path, jtree, ttree


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jc = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      JS.materialize(JM.param_defs(jc), jax.random.PRNGKey(3)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    if jc.input_kind == "embeds":          # llava: embeddings at the table's scale
        ids = rng.standard_normal((2, 64, jc.d_model)).astype(np.float32)
    else:
        ids = rng.integers(0, jc.vocab_size, size=(2, 64)).astype(np.int32)
    targets = rng.integers(0, jc.vocab_size, size=(2, 64)).astype(np.int32)
    targets[0, :7] = -1                    # masked positions
    targets[1, 40:] = -1
    return jc, tc, jp, tp, ids, targets


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return _setup(request.param)


def _key(cfg) -> str:
    """The batch entry a model's input sequence goes in."""
    return "embeds" if cfg.input_kind == "embeds" else "inputs"


def _rel_l2(t: torch.Tensor, j) -> float:
    j = np.asarray(j, np.float32)
    return float(np.linalg.norm(t.float().numpy() - j) / max(np.linalg.norm(j), 1e-30))


@pytest.mark.parametrize("remat,ce_chunk", [(False, 512), (True, 512), (True, 16), (False, 16)])
def test_loss_fn_value_and_grads_match(setup, remat, ce_chunk):
    """ce_chunk 16 at S 64 runs the chunked CE (checkpointed under remat)."""
    jc, tc, jp, tp, ids, targets = setup

    def jloss(p):
        return JM.loss_fn(p, {_key(jc): jnp.asarray(ids), "targets": jnp.asarray(targets)},
                          jc, remat=remat, ce_chunk=ce_chunk)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tl, tm, tg = loss_and_grads(tp, {_key(tc): torch.from_numpy(ids),
                                     "targets": torch.from_numpy(targets)},
                                tc, remat=remat, ce_chunk=ce_chunk)
    assert tl.dtype == torch.float32 and tl.dim() == 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce_loss"]), float(jm["ce_loss"]), rtol=1e-5)
    # olmoe: the MoE load-balancing loss summed over layers; else 0
    np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]), rtol=1e-5)
    assert (float(tm["aux_loss"]) == 0.0) == (tc.moe is None)
    measure = _rel_l2 if tc.name.replace("-", "_") in REL_L2_ARCHS else _scaled_err
    errs = {path: measure(t, j) for path, j, t in _pairs(jg, tg)}
    assert len(errs) == len(tree_leaves(tp))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])


def test_loss_fn_matches_encoder_decoder():
    """seamless-m4t-medium's loss_fn: loss, ce_loss, aux_loss (0) and every
    gradient, on a batch_for batch (it carries the encoder frames).
    Gradients are held as each leaf's relative L2 error: at this init the
    encoder's attention is nearly one-hot, and both frameworks' fp32
    gradients of its norms lie ~0.035 (max abs, of values ~9) from a
    float64 computation, 0.0055 from each other, so single elements carry
    amplified rounding."""
    arch = "seamless_m4t_medium"
    jc = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      JS.materialize(JM.param_defs(jc), jax.random.PRNGKey(5)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = jax_batch_for(jc, 2, 32, 0, seed=2)
    assert ("enc_embeds" in batch) == bool(jc.encoder_layers)

    def jloss(p):
        return JM.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, jc, ce_chunk=16)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tl, tm, tg = loss_and_grads(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tc,
                                ce_chunk=16)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce_loss"]), float(jm["ce_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]), rtol=1e-5,
                               atol=1e-12)
    assert float(tm["aux_loss"]) == 0.0
    errs = {path: float(np.linalg.norm(t.numpy() - np.asarray(j)) / np.linalg.norm(np.asarray(j)))
            for path, j, t in _pairs(jg, tg)}
    assert len(errs) == len(tree_leaves(tp))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])


def test_loss_fn_leaves_params_untouched_and_forward_is_grad_free(setup):
    _, tc, _, tp, ids, targets = setup
    batch = {_key(tc): torch.from_numpy(ids), "targets": torch.from_numpy(targets)}
    loss, metrics = TM.loss_fn(tp, batch, tc)
    assert loss.grad_fn is None and not any(t.requires_grad for t in tree_leaves(tp))
    h, enc, aux = TM.forward_train(tp, batch, tc, remat=True)
    assert h.grad_fn is None and enc is None and (float(aux) == 0.0) == (tc.moe is None)
    assert set(metrics) == {"ce_loss", "aux_loss"}


def test_batch_for_encoder_frames_are_byte_identical():
    cfg, jcfg = get_smoke_config("seamless_m4t_medium"), jax_smoke("seamless_m4t_medium")
    for step in (0, 5):
        want = jax_batch_for(jcfg, 4, 24, step, seed=1)
        got = batch_for(cfg, 4, 24, step, seed=1)
        assert set(got) == set(want) == {"inputs", "targets", "enc_embeds"}
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def _opt_trees(seed=5):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 8), "stack": (2, 4, 5), "norm": (8,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: rng.standard_normal(s).astype(np.float32) * 3 for k, s in shapes.items()}
    return params, grads


@pytest.mark.parametrize("moment_dtype,clip_norm", [("float32", 1.0), ("bfloat16", 0.5),
                                                    ("float32", 0.0)])
def test_adamw_apply_matches(moment_dtype, clip_norm):
    """Two updates from the same params and grads; clip_norm 1.0 and 0.5
    are active (the grads' norm is ~25), 0.0 turns clipping off."""
    p_np, g_np = _opt_trees()
    jcfg = JaxOptConfig(lr=1e-2, warmup_steps=1, total_steps=10, moment_dtype=moment_dtype,
                        clip_norm=clip_norm)
    tcfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10, moment_dtype=moment_dtype,
                     clip_norm=clip_norm)
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16 if k == "w" else jnp.float32)
          for k, v in p_np.items()}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    js, ts = jax_init_opt_state(jp, jcfg), init_opt_state(tp, tcfg)
    jg = {k: jnp.asarray(v) for k, v in g_np.items()}
    tg = {k: torch.from_numpy(v) for k, v in g_np.items()}
    before = {k: v.clone() for k, v in tp.items()}
    for _ in range(2):
        jp, js, jm = jax_adamw_apply(jp, jg, js, jcfg)
        tp_new, ts, tm = adamw_apply(tp, tg, ts, tcfg)
        assert all(torch.equal(tp[k], before[k]) for k in tp)    # functional
        tp, before = tp_new, {k: v.clone() for k, v in tp_new.items()}
    assert int(ts["count"]) == int(js["count"]) == 2 and ts["count"].dtype == torch.int32
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    for k in p_np:
        assert tp[k].dtype == getattr(torch, str(jp[k].dtype))
        assert ts["m"][k].dtype == getattr(torch, moment_dtype)
        tol = 1e-2 if moment_dtype == "bfloat16" or k == "w" else 1e-6
        for got, want in ((tp[k], jp[k]), (ts["m"][k], js["m"][k]), (ts["v"][k], js["v"][k])):
            assert _scaled_err(got, want.astype(jnp.float32)) <= tol, k


def test_lr_at_matches():
    cfg_kw = dict(lr=3e-4, warmup_steps=10, total_steps=50, min_lr_ratio=0.1)
    for step in (0, 5, 10, 30, 50, 60):
        want = float(jax_lr_at(jnp.asarray(step, jnp.int32), JaxOptConfig(**cfg_kw)))
        got = lr_at(torch.tensor(step, dtype=torch.int32), OptConfig(**cfg_kw))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)


def test_opt_state_defs_mirror_params():
    tc = get_smoke_config(ARCH)
    defs = opt_state_defs(TM.param_defs(tc), OptConfig(moment_dtype="bfloat16"))
    assert defs["count"].shape == () and defs["count"].dtype == torch.int32
    m_leaves = tree_leaves(defs["m"], lambda d: hasattr(d, "shape"))
    assert all(d.dtype == torch.bfloat16 and d.init == "zeros" for d in m_leaves)


@pytest.mark.parametrize("seed", [0, 3])
def test_batch_for_is_byte_identical(seed):
    cfg = get_smoke_config(ARCH)
    jcfg = jax_smoke(ARCH)
    for step in (0, 1, 17):
        want = jax_batch_for(jcfg, 4, 24, step, seed=seed)
        got = batch_for(cfg, 4, 24, step, seed=seed)
        assert set(got) == set(want) == {"inputs", "targets"}
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    assert np.array_equal(SyntheticTokens(50, 2, 8, seed=seed).batch_at(2)["inputs"],
                          JaxTokens(50, 2, 8, seed=seed).batch_at(2)["inputs"])


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_build_train_step_matches(arch, microbatches):
    """One step from the same weights and batch.  The loss, metrics and
    Adam moments are linear in the gradients and match tightly; a
    parameter moves by lr * sign(g) on this first step, so an element
    whose gradient is ~0 may move the other way: those are held to 2 lr
    and must be rare."""
    jc, tc, jp, tp, _, _ = _setup(arch)
    lr = 1e-2
    jopt = JaxOptConfig(lr=lr, warmup_steps=1, total_steps=10)
    topt = OptConfig(lr=lr, warmup_steps=1, total_steps=10)
    batch = jax_batch_for(jc, 4, 32, 0, seed=1)
    jstep = jax.jit(jax_build_train_step(jc, jopt, JaxStepConfig(microbatches=microbatches)))
    jp2, js2, jm = jstep(jp, jax_init_opt_state(jp, jopt),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = build_train_step(tc, topt, StepConfig(microbatches=microbatches))
    tp2, ts2, tm = tstep(tp, init_opt_state(tp, topt), batch)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    for name, jtree, ttree in (("m", js2["m"], ts2["m"]), ("v", js2["v"], ts2["v"])):
        for path, j, t in _pairs(jtree, ttree):
            assert _scaled_err(t, j) <= 1e-4, (name, path)
    moved = flipped = 0
    for path, j, t in _pairs(jp2, tp2):
        diff = np.abs(t.numpy() - np.asarray(j))
        assert diff.max() <= 2 * lr * 1.01, path
        flipped += int((diff > 1e-5).sum())
        moved += diff.size
    assert flipped <= 1e-3 * moved


@pytest.fixture
def one_thread():
    """torch on one thread, as the CLI's subprocess ran it (smoke size:
    threads only contend); restored after the test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-780m", "minitron-4b", "olmoe-1b-7b",
                                  "seamless-m4t-medium", "recurrentgemma-9b", "gemma3-27b",
                                  "llava-next-34b", "deepseek-67b", "deepseek-v3-671b"])
def test_train_cli_on_cpu(tmp_path, capsys, one_thread, arch):
    """The training CLI on every architecture's smoke config, in process
    through ``main(argv)``: 8 steps through a host loss at step 3, the loss
    falling, and no recovery or restore (the lost host's shards move on
    without one), as chip_smoke.py's ``train_cli`` phase pins on the card."""
    from repro_torch.launch.train import main

    main(["--arch", arch, "--device", "cpu", "--steps", "8", "--inject", "host_down:3:host01",
          "--json", "--ckpt-dir", str(tmp_path / "ck")])
    rep = json.loads(capsys.readouterr().out)
    assert rep["arch"] == arch and rep["steps"] == 8
    assert np.isfinite(rep["loss_first"]) and np.isfinite(rep["loss_last"])
    assert rep["loss_last"] < rep["loss_first"]
    assert rep["recoveries"] == [] and rep["restores"] == 0


def test_train_cli_refuses_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.launch.train import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--steps", "1", "--ckpt-dir", str(tmp_path / "ck")])
