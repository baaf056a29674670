"""fp16 flash attention on the wgmma + TMA kernels (the "f16" route).

fp16 runs the kernels bf16 runs on tensor cores at every head-dim pair
that is a multiple of 8 (the built pairs, the smoke dims and the dims
inside a built pair), their padded form in f16 wgmma with f16 tensor maps
(``csrc/flash_attention_f16.cu``, ``csrc/flash_attention_bwd_f16.cu``,
``flash_attention_fwd_ws_f16``); at other dims it runs the same entries
on copies at a pitch of a multiple of 8 (the staged route, "stage",
tests/test_torch_flash_staged.py).  On the CPU, with every launcher's
library replaced by a fake that records its calls, these tests hold the C
entries' arguments: fp16 passes its dtype code (2) to the tensor-core
entries, bf16 passes what it passed before fp16 came and the scale's head
dim after it, a kv tile fp16 is not built for is refused, and a failed
fp16 launch raises without trying another route.  The tests
marked ``cuda`` hold the fp16 kernels to the plain versions on a card
(and the backward to itself over two launches) and skip without one.  The
file imports no JAX.
"""
from __future__ import annotations

import contextlib
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as flash_launcher
from repro_torch.kernels.flash_attention import KV_TILES, route
from repro_torch.kernels.ops import flash_attention
from repro_torch.kernels.ref import flash_attention_ref

FP16 = 2   # the launcher's dtype code of fp16 (_DTYPES)


def _qkv(b, s, h, kv, dk, dv, dtype, seed=1, device="cpu"):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device=device,
                                                                               dtype=dtype)
            for shape in ((b, s, h, dk), (b, s, kv, dk), (b, s, kv, dv), (b, s, h, dv))]


class _Entry:
    argtypes = restype = None

    def __init__(self, name, calls, ret):
        self.name, self.calls, self.ret = name, calls, ret

    def __call__(self, *args):
        self.calls.append((self.name, self.argtypes, args))
        return self.ret


@pytest.fixture
def recorded(monkeypatch):
    """Every flash library replaced by one whose entries record (entry,
    argtypes, args) and return ``recorded.ret`` (0), with the device checks
    and the stream stubbed, so launches run on CPU tensors."""
    calls = []
    state = types.SimpleNamespace(calls=calls, ret=0)

    class Lib:
        def __getattr__(self, entry):
            fn = _Entry(entry, calls, state.ret)
            setattr(self, entry, fn)
            return fn

    libs = {}
    monkeypatch.setattr(build, "library", lambda name: libs.setdefault(name, Lib()))
    monkeypatch.setattr(flash_launcher, "_check", lambda *a: None)
    monkeypatch.setattr(flash_launcher, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return state


def _run(dk, dv, dtype, **kw):
    """Forward with lse, then backward, at B 1, S 70, H 4 over KV 2, causal."""
    q, k, v, do = _qkv(1, 70, 4, 2, dk, dv, dtype)
    o, lse = flash_launcher.flash_attention_cuda(q, k, v, causal=True, window=0,
                                                 return_lse=True, **kw)
    flash_launcher.flash_attention_bwd_cuda(q, k, v, o, torch.zeros(1, 4, 70), do,
                                            causal=True, window=0)
    return q, k, v


# where each tensor-core entry takes the launcher's dtype code
_DTYPE_AT = {"flash_attention_fwd_f16": 15, "flash_attention_fwd_ws_f16": 13,
             "flash_attention_bwd_f16": 21, "flash_attention_fwd": 13,
             "flash_attention_bwd": 19}


@pytest.mark.parametrize("dk,dv", [(64, 64), (128, 128), (192, 128), (256, 256), (80, 80),
                                   (96, 96), (40, 40), (160, 128), (144, 64)])
def test_fp16_passes_its_dtype_code_to_the_wgmma_entries(recorded, dk, dv):
    """fp16 at a built pair or at dims that are multiples of 8 inside one:
    the fp16 entries, each given dtype code 2, the bucket and (forward) the
    bucket's default kv tile."""
    _run(dk, dv, torch.float16)
    r = route(torch.float16, dk, dv)
    assert r.kind == "f16"
    ws = r.dims == (192, 128)
    names = [c[0] for c in recorded.calls]
    assert names == ["flash_attention_fwd_ws_f16" if ws else "flash_attention_fwd_f16",
                     "flash_attention_bwd_f16"]
    for entry, argtypes, args in recorded.calls:
        assert len(args) == len(argtypes), entry
        assert args[_DTYPE_AT[entry]] == FP16, entry
        assert args[-1] == dk   # the scale's head dim
        if entry == "flash_attention_fwd_f16":
            assert args[9:13] == (dk, dv, *r.dims)
            assert args[-2] == KV_TILES[r.dims][0]
        elif entry == "flash_attention_fwd_ws_f16":
            assert args[9:11] == (dk, dv) and args[17] == KV_TILES[r.dims][0]
        else:
            assert args[15:19] == (dk, dv, *r.dims)


@pytest.mark.parametrize("dk,dv", [(20, 20), (5, 3), (16, 16), (24, 16), (72, 36)])
def test_fp16_off_the_wgmma_dims_keeps_the_general_kernels(recorded, dk, dv):
    """fp16 at the smoke configs' dims: the f16 entries at the (64, 64)
    bucket; at dims that are not multiples of 8: the same entries on the
    staged route, between the staging launches, at the pitches with the
    real q/k dim for the scale; dtype code 2 throughout."""
    _run(dk, dv, torch.float16)
    r = route(torch.float16, dk, dv)
    staged = dk % 8 != 0 or dv % 8 != 0
    assert r.kind == ("stage" if staged else "f16")
    assert r.dims == ((128, 128) if (dk, dv) == (72, 36) else (64, 64))
    stage = ["flash_attention_stage"] if staged else []
    assert [c[0] for c in recorded.calls] == [*stage, "flash_attention_fwd_f16", *stage, *stage,
                                              "flash_attention_bwd_f16", *stage]
    fwd, bwd = (c[2] for c in recorded.calls if c[0] != "flash_attention_stage")
    assert fwd[15] == FP16 and bwd[21] == FP16
    pk, pv = -(-dk // 8) * 8, -(-dv // 8) * 8
    assert fwd[9:13] == (pk, pv, *r.dims) and fwd[-1] == dk
    assert bwd[15:19] == (pk, pv, *r.dims) and bwd[-1] == dk


def test_bf16_passes_the_arguments_it_passed_before(recorded):
    """bf16 at a built pair and at a padded pair: the same entries, argument
    counts and values as before fp16 came (dtype code 1 where an entry takes
    one, none on the padded entries), the padded entries with the scale's
    head dim last."""
    q, k, v = _run(64, 64, torch.bfloat16)
    q2, k2, v2 = _run(80, 80, torch.bfloat16)
    (f, ft, fa), (b, bt, ba), (fp, fpt, fpa), (bp, bpt, bpa) = recorded.calls
    assert (f, b, fp, bp) == ("flash_attention_fwd", "flash_attention_bwd",
                              "flash_attention_fwd_pad", "flash_attention_bwd_pad")
    assert (len(ft), len(bt), len(fpt), len(bpt)) == (18, 25, 20, 27)
    assert fa[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert fa[4:15] == (1, 70, 70, 4, 2, 64, 64, 1, 0, 1, 0) and fa[17] == 128
    assert ba[10:20] == (1, 70, 70, 4, 2, 64, 64, 1, 0, 1) and ba[23:] == (1, 128)
    assert fpa[:3] == (q2.data_ptr(), k2.data_ptr(), v2.data_ptr())
    assert fpa[4:16] == (1, 70, 70, 4, 2, 80, 80, 128, 128, 1, 0, 0) and fpa[18:] == (128, 80)
    assert bpa[10:22] == (1, 70, 70, 4, 2, 80, 80, 128, 128, 1, 0, 0)
    assert bpa[24:] == (1, 128, 80)


@pytest.mark.parametrize("dk,dv", [(64, 64), (128, 128), (80, 80), (192, 128), (256, 256)])
def test_fp16_refuses_a_kv_tile_it_is_not_built_for(recorded, dk, dv):
    """fp16 on wgmma is built at the bucket's default kv tile alone: None
    or that tile launch, any other tile raises before a launch."""
    bucket = route(torch.float16, dk, dv).dims
    q, k, v, _ = _qkv(1, 70, 4, 2, dk, dv, torch.float16)
    flash_launcher.flash_attention_cuda(q, k, v, causal=True, window=0,
                                        kv_tile=KV_TILES[bucket][0])
    assert len(recorded.calls) == 1
    for tile in {16, 32, 64, 128, 256} - {KV_TILES[bucket][0]}:
        with pytest.raises(ValueError, match="kv tile"):
            flash_launcher.flash_attention_cuda(q, k, v, causal=True, window=0, kv_tile=tile)
    assert len(recorded.calls) == 1
    # bf16 keeps every tile its bucket is built for
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    for tile in KV_TILES[bucket]:
        flash_launcher.flash_attention_cuda(qb, kb, vb, causal=True, window=0, kv_tile=tile)
    assert len(recorded.calls) == 1 + len(KV_TILES[bucket])


@pytest.mark.parametrize("code", [-1, -2, 1, 700])
@pytest.mark.parametrize("dk,dv", [(64, 64), (192, 128)])
def test_a_failed_fp16_launch_raises_without_another_route(recorded, dk, dv, code):
    """An fp16 entry that fails (a tensor map not encoded, a CUDA error)
    raises; no other entry is called."""
    recorded.ret = code
    q, k, v, do = _qkv(1, 70, 4, 2, dk, dv, torch.float16)
    with pytest.raises(RuntimeError, match="flash_attention"):
        flash_launcher.flash_attention_cuda(q, k, v, causal=True, window=0)
    with pytest.raises(RuntimeError, match="flash_attention_bwd"):
        flash_launcher.flash_attention_bwd_cuda(q, k, v, torch.zeros_like(do),
                                                torch.zeros(1, 4, 70), do, causal=True,
                                                window=0)
    assert [c[0].endswith("_f16") for c in recorded.calls] == [True, True]


# -- on a card ------------------------------------------------------------------


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got.float() - want.float()).abs() / (1 + want.float().abs())).max())


def _kernel_names(fn) -> list[str]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


@pytest.mark.cuda
@pytest.mark.parametrize("dk,dv", [(64, 64), (128, 128), (192, 128), (256, 256), (80, 80),
                                   (96, 96), (144, 64)])
def test_cuda_fp16_runs_the_wgmma_kernels(dk, dv):
    """fp16 forward and backward at S 130 over Sk 130, GQA 4 / 2, causal with
    a window of 48: the f16 wgmma kernels (hopper::HalfWidths, never the
    general ones), within fp16's limits of the plain version and autograd
    of it in fp32 (2e-2, 5e-2), the backward bit-equal over two launches."""
    dev = _card()
    q, k, v, do = _qkv(2, 130, 4, 2, dk, dv, torch.float16, seed=dk + dv, device=dev)
    kw = dict(causal=True, window=48)
    before = (flash_attention.f16_launches, flash_attention.bwd_f16_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (flash_attention.f16_launches, flash_attention.bwd_f16_launches) == (
        before[0] + 1, before[1] + 1)
    o, lse = flash_launcher.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    names = _kernel_names(lambda: flash_launcher.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                                          **kw))
    names += _kernel_names(lambda: flash_launcher.flash_attention_cuda(q, k, v, **kw))
    assert names and all("HalfWidths" in n and "_any<" not in n for n in names), names
    first = flash_launcher.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    again = flash_launcher.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    ref_leaves = [t.float().clone().requires_grad_() for t in (q, k, v)]
    ref = flash_attention_ref(*ref_leaves, **kw)
    ref_grads = torch.autograd.grad(ref, ref_leaves, do.float())
    assert out.dtype == torch.float16 and _scaled_err(out, ref) <= 2e-2
    for g, w in zip(grads, ref_grads):
        assert g.dtype == torch.float16 and _scaled_err(g, w) <= 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dk,dv", [(20, 20), (5, 3), (16, 16)])
def test_cuda_fp16_off_the_wgmma_dims_runs_the_general_kernels(dk, dv):
    """fp16 at dims that are not multiples of 8 (the staged route) and at
    the smoke dims (the f16 route): the f16 wgmma kernels of the (64, 64)
    bucket (hopper::HalfWidths; staged, the staging kernel beside them),
    one launch each way on the route's counters, within fp16's limits of
    the plain version."""
    dev = _card()
    q, k, v, do = _qkv(2, 130, 4, 2, dk, dv, torch.float16, seed=dk + dv, device=dev)
    kw = dict(causal=True, window=0)
    kind = route(torch.float16, dk, dv).kind
    assert kind == ("f16" if (dk, dv) == (16, 16) else "stage")
    before = (getattr(flash_attention, f"{kind}_launches"),
              getattr(flash_attention, f"bwd_{kind}_launches"))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (getattr(flash_attention, f"{kind}_launches"),
            getattr(flash_attention, f"bwd_{kind}_launches")) == (before[0] + 1, before[1] + 1)
    o, lse = flash_launcher.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    names = _kernel_names(lambda: flash_launcher.flash_attention_cuda(q, k, v, **kw))
    names += _kernel_names(lambda: flash_launcher.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                                           **kw))
    flash = [n for n in names if "flash_stage" not in n]
    assert flash and all("HalfWidths" in n for n in flash), names
    assert (kind == "stage") == (len(flash) < len(names)), names
    ref_leaves = [t.float().clone().requires_grad_() for t in (q, k, v)]
    ref = flash_attention_ref(*ref_leaves, **kw)
    ref_grads = torch.autograd.grad(ref, ref_leaves, do.float())
    assert _scaled_err(out, ref) <= 2e-2
    for g, w in zip(grads, ref_grads):
        assert _scaled_err(g, w) <= 5e-2
