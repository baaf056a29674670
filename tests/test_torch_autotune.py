"""The port's autotune plane (``repro_torch.kernels.autotune``): the
reference's cache semantics (round trip, corruption, device-signature
scoping), the Hopper tile grids, and the sweep, persistence and
consultation paths.  Sweeps time the kernel on the card only, so here they
run through an injected ``runner`` (output, µs), and a sweep on CPU
tensors raises."""
from __future__ import annotations

import functools
import json
import shutil

import pytest
import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.autotune import (
    DEFAULT_SSD_CHUNK,
    AutotuneCache,
    TuneResult,
    autotune_flash_attention,
    autotune_ssd_scan,
    device_signature,
    flash_tile_candidates,
    ssd_chunk_candidates,
    tuned_flash_tile,
    tuned_ssd_chunk,
)
from repro_torch.kernels.ops import flash_attention
from repro_torch.kernels.ref import flash_attention_ref, ssd_ref


def _result(blocks, us=10.0, default_us=20.0):
    return TuneResult(blocks=blocks, us=us, default_us=default_us, sweep=[])


def _flash_args(b=1, s=64, h=4, kv=2, d=64, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(3)
    return tuple(torch.randn(b, s, n, d, generator=gen).to(dtype) for n in (h, kv, kv))


def _ssd_args(b=1, l=64, h=2, p=64, n=128):
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(b, l, h, p, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(b, l, h, generator=gen))
    a = -torch.exp(0.3 * torch.randn(h, generator=gen))
    return x, dt, a, torch.randn(b, l, n, generator=gen), torch.randn(b, l, n, generator=gen)


def _runner(times, out_of, calls=None):
    """A stand-in for launching and timing: (out_of(blocks), times[tile])."""
    def run(blocks):
        if calls is not None:
            calls.append(dict(blocks))
        return out_of(blocks), times[next(iter(blocks.values()))]
    return run


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    return tmp_path


# ------------------------------------------------------------ cache ----
def test_cache_roundtrip_and_reopen(tmp_path):
    c = AutotuneCache(tmp_path)
    assert c.lookup("flash_attention", "k1") is None
    c.store("flash_attention", "k1", _result({"kv_tile": 64}))
    assert c.lookup("flash_attention", "k1") == {"kv_tile": 64}
    # a second instance on the same directory sees the persisted entry
    c2 = AutotuneCache(tmp_path)
    assert c2.lookup("flash_attention", "k1") == {"kv_tile": 64}
    # kernels do not share a namespace
    assert c2.lookup("ssd_scan", "k1") is None


def test_cache_corrupt_file_ignored_and_recovered(tmp_path):
    c = AutotuneCache(tmp_path)
    c.store("ssd_scan", "k", _result({"chunk": 64}))
    c.path.write_text("{ not json")
    c2 = AutotuneCache(tmp_path)
    assert len(c2) == 0 and c2.lookup("ssd_scan", "k") is None
    # the next store overwrites the corrupt file atomically
    c2.store("ssd_scan", "k", _result({"chunk": 128}))
    assert AutotuneCache(tmp_path).lookup("ssd_scan", "k") == {"chunk": 128}


def test_cache_corrupt_entry_dropped_individually(tmp_path):
    c = AutotuneCache(tmp_path)
    c.store("flash_attention", "good", _result({"kv_tile": 128}))
    data = json.loads(c.path.read_text())
    data["entries"]["flash_attention|bad"] = {"blocks": "not-a-dict"}
    data["entries"]["flash_attention|bad2"] = ["wrong-shape"]
    data["entries"]["flash_attention|bad3"] = {"blocks": {"kv_tile": "64"}}
    c.path.write_text(json.dumps(data))
    c2 = AutotuneCache(tmp_path)
    assert c2.lookup("flash_attention", "good") is not None
    for bad in ("bad", "bad2", "bad3"):
        assert c2.lookup("flash_attention", bad) is None


def test_foreign_device_cache_ignored(tmp_path):
    """A cache written under another device signature is never consulted:
    tile winners are measurements on specific hardware, not facts."""
    foreign = AutotuneCache(tmp_path, signature="tpu:TPU v5e:256")
    foreign.store("flash_attention", "k", _result({"kv_tile": 64}))
    local = AutotuneCache(tmp_path)          # this machine's signature
    assert local.lookup("flash_attention", "k") is None
    # even a byte-identical copy dropped onto the local path is rejected
    # by the signature recorded inside the file
    shutil.copy(foreign.path, local.path)
    relocated = AutotuneCache(tmp_path)
    assert len(relocated) == 0
    assert relocated.lookup("flash_attention", "k") is None


def test_device_signature_shape():
    sig = device_signature()
    platform, kind, count = sig.split(":", 2)
    assert platform in ("cuda", "cpu") and kind and int(count) >= 1
    if not torch.cuda.is_available():
        assert platform == "cpu"


def test_candidate_grids():
    """The tiles the Hopper kernels are built for, not VMEM-sized powers of
    two: the flash forward's kv tile (64 alone at D 256, 128 alone for
    MLA's kernel at (192, 128)), the SSD chunk."""
    for dims in ((64, 64), (128, 128)):
        assert flash_tile_candidates(*dims) == [128, 64]
    assert flash_tile_candidates(256, 256) == [64]
    assert flash_tile_candidates(192, 128) == [128]
    assert ssd_chunk_candidates(torch.bfloat16) == [64, 128]
    assert ssd_chunk_candidates(torch.float32) == [32, 64, 128]
    assert DEFAULT_SSD_CHUNK in ssd_chunk_candidates(torch.bfloat16)


def test_cache_env_names_are_the_ports(tmp_path, monkeypatch):
    """The port reads REPRO_TORCH_AUTOTUNE_CACHE, never the JAX package's
    REPRO_AUTOTUNE_CACHE, and follows the variable when it changes."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "a"))
    assert autotune.default_cache().directory == tmp_path / "a"
    assert autotune.default_cache() is autotune.default_cache()
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "b"))
    assert autotune.default_cache().directory == tmp_path / "b"
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    assert str(autotune.default_cache().directory).endswith(".cache/repro_torch_autotune")


# ------------------------------------------------- sweep + persistence ----
def test_autotune_flash_persists_winner(cache_dir):
    q, k, v = _flash_args()
    ref = flash_attention_ref(q, k, v, causal=True, window=0)
    res = autotune_flash_attention(q, k, v, runner=_runner({128: 9.0, 64: 6.0}, lambda _: ref))
    assert res.blocks == {"kv_tile": 64}
    assert res.us == 6.0 and res.default_us == 9.0 and len(res.sweep) == 2
    assert res.speedup == pytest.approx(1.5)
    # the consultation path now resolves to the persisted winner
    assert tuned_flash_tile(q, k, v, causal=True, window=0) == 64
    # another shape, mask or dtype is another key
    assert tuned_flash_tile(q, k, v, causal=False, window=0) == 128
    assert tuned_flash_tile(q[:, :32], k[:, :32], v[:, :32], causal=True, window=0) == 128


def test_autotune_ssd_persists_winner(cache_dir):
    x, dt, a, bm, cm = _ssd_args()
    ref = ssd_ref(x, dt, a, bm, cm)
    res = autotune_ssd_scan(x, dt, a, bm, cm,
                            runner=_runner({64: 50.0, 128: 80.0}, lambda _: ref),
                            candidates=[64, 128])
    assert res.blocks == {"chunk": 64}
    assert tuned_ssd_chunk(x, dt, a, bm, cm) == 64


def test_transparent_miss_falls_back_to_defaults(cache_dir):
    q, k, v = _flash_args()
    assert tuned_flash_tile(q, k, v, causal=True, window=0) == 128
    q2, k2, v2 = _flash_args(d=256)
    assert tuned_flash_tile(q2, k2, v2, causal=True, window=0) == 64
    # fp32 has one tile: the launcher's own
    assert tuned_flash_tile(*_flash_args(dtype=torch.float32), causal=True, window=0) is None
    assert tuned_ssd_chunk(*_ssd_args()) == DEFAULT_SSD_CHUNK


def test_transparent_consultation_preserves_numerics(cache_dir):
    """A persisted tile changes which kernel instantiation a CUDA call
    launches, never the function: on CPU tensors ops.flash_attention runs
    the plain version whatever the cache or the caller names."""
    q, k, v = _flash_args(s=96)
    ref = flash_attention_ref(q, k, v, causal=True, window=0)
    autotune_flash_attention(q, k, v, runner=_runner({128: 2.0, 64: 1.0}, lambda _: ref))
    assert tuned_flash_tile(q, k, v, causal=True, window=0) == 64
    tuned = flash_attention(q, k, v)
    explicit = flash_attention(q, k, v, kv_tile=128)
    assert torch.equal(tuned, explicit) and torch.equal(tuned, ref)


def test_autotune_on_miss_env_gate(cache_dir, monkeypatch):
    """REPRO_TORCH_AUTOTUNE=1: a cache miss sweeps on the spot and persists."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    x, dt, a, bm, cm = _ssd_args()
    ref = ssd_ref(x, dt, a, bm, cm)
    calls = []
    monkeypatch.setattr(autotune, "autotune_ssd_scan", functools.partial(
        autotune.autotune_ssd_scan, runner=_runner({32: 5.0, 64: 3.0, 128: 4.0}, lambda _: ref,
                                                   calls)))
    assert tuned_ssd_chunk(x, dt, a, bm, cm) == 64
    assert len(AutotuneCache(cache_dir)) == 1 and calls[0] == {"chunk": 128}
    # the next call is a hit: no sweep
    assert tuned_ssd_chunk(x, dt, a, bm, cm) == 64 and len(calls) == 3


def test_sweep_checks_default_when_not_in_grid(cache_dir):
    q, k, v = _flash_args()
    ref = flash_attention_ref(q, k, v, causal=True, window=0)
    calls = []
    res = autotune_flash_attention(q, k, v, candidates=[64],
                                   runner=_runner({128: 5.0, 64: 4.0}, lambda _: ref, calls))
    # the default was measured out of the grid, first, for the before/after row
    assert calls[0] == {"kv_tile": 128} and res.default_us == 5.0
    assert [row["blocks"] for row in res.sweep] == [{"kv_tile": 64}]
    assert res.speedup == pytest.approx(res.default_us / res.us)


def test_sweep_rejects_a_candidate_that_disagrees_with_the_default(cache_dir):
    """A faster tile whose output is off the default tile's cannot win."""
    q, k, v = _flash_args()
    ref = flash_attention_ref(q, k, v, causal=True, window=0)
    res = autotune_flash_attention(q, k, v, runner=_runner(
        {128: 5.0, 64: 1.0}, lambda blocks: ref if blocks["kv_tile"] == 128 else ref + 1))
    assert res.blocks == {"kv_tile": 128} and res.us == 5.0
    bad = next(row for row in res.sweep if row["blocks"] == {"kv_tile": 64})
    assert not bad["agrees"] and bad["vs_default"] > autotune.AGREE_TOL[
        "flash_attention"][torch.bfloat16]


@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan"])
def test_sweep_on_cpu_tensors_raises(kernel, cache_dir):
    """Without a runner a sweep times the kernel on the card: CPU tensors
    raise instead of timing the plain version."""
    with pytest.raises(ValueError, match="on the card"):
        if kernel == "flash_attention":
            autotune_flash_attention(*_flash_args())
        else:
            autotune_ssd_scan(*_ssd_args())
    assert len(AutotuneCache(cache_dir)) == 0


def test_flash_sweep_refuses_fp32(cache_dir):
    with pytest.raises(ValueError, match="one tile"):
        autotune_flash_attention(*_flash_args(dtype=torch.float32),
                                 runner=_runner({128: 1.0}, lambda _: None))


# ---------------------------------------------- stale tiles and the memo ----
def _plant(cache_dir, kernel, key, blocks):
    """A cache file as an earlier build would have left it."""
    c = AutotuneCache(cache_dir)
    c.store(kernel, key, _result(blocks))


@pytest.mark.parametrize("planted", [{"kv_tile": 32}, {"kv_tile": 256}, {"chunk": 64}, {}])
def test_cached_flash_tile_the_kernel_is_not_built_for_is_a_miss(cache_dir, planted):
    """A tile no longer in KV_TILES (or an entry of the wrong kernel's shape)
    resolves to the default tile instead of reaching the launcher, which
    would refuse it; the next sweep overwrites the entry."""
    q, k, v = _flash_args()
    _plant(cache_dir, "flash_attention",
           autotune.flash_key(1, 64, 64, 4, 2, 64, 64, torch.bfloat16, causal=True, window=0),
           planted)
    assert tuned_flash_tile(q, k, v, causal=True, window=0) == 128
    ref = flash_attention_ref(q, k, v, causal=True, window=0)
    autotune_flash_attention(q, k, v, runner=_runner({128: 9.0, 64: 6.0}, lambda _: ref))
    assert tuned_flash_tile(q, k, v, causal=True, window=0) == 64


@pytest.mark.parametrize("planted", [{"chunk": 256}, {"chunk": 0}, {"kv_tile": 64}])
def test_cached_ssd_chunk_the_kernel_is_not_built_for_is_a_miss(cache_dir, planted):
    x, dt, a, bm, cm = _ssd_args()
    _plant(cache_dir, "ssd_scan", autotune.ssd_key(1, 64, 2, 64, 128, x.dtype), planted)
    assert tuned_ssd_chunk(x, dt, a, bm, cm) == DEFAULT_SSD_CHUNK


def test_cached_stale_tile_with_tune_on_miss_sweeps(cache_dir, monkeypatch):
    """Under REPRO_TORCH_AUTOTUNE=1 a stale tile is a miss like any other."""
    q, k, v = _flash_args()
    _plant(cache_dir, "flash_attention",
           autotune.flash_key(1, 64, 64, 4, 2, 64, 64, torch.bfloat16, causal=True, window=0),
           {"kv_tile": 32})
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    ref = flash_attention_ref(q, k, v, causal=True, window=0)
    monkeypatch.setattr(autotune, "autotune_flash_attention", functools.partial(
        autotune.autotune_flash_attention, runner=_runner({128: 3.0, 64: 2.0}, lambda _: ref)))
    assert tuned_flash_tile(q, k, v, causal=True, window=0) == 64
    assert AutotuneCache(cache_dir).lookup("flash_attention", autotune.flash_key(
        1, 64, 64, 4, 2, 64, 64, torch.bfloat16, causal=True, window=0)) == {"kv_tile": 64}


def test_repeated_lookup_is_one_dict_lookup(cache_dir, monkeypatch):
    """The first call of a shape resolves its tile; later calls read the
    cache instance's memo without building a key or reading the entries."""
    q, k, v = _flash_args()
    x, dt, a, bm, cm = _ssd_args()
    assert tuned_flash_tile(q, k, v, causal=True, window=0) == 128
    assert tuned_ssd_chunk(x, dt, a, bm, cm) == DEFAULT_SSD_CHUNK

    def no_lookup(*args, **kw):
        raise AssertionError("the memo should have answered")
    monkeypatch.setattr(autotune.AutotuneCache, "lookup", no_lookup)
    monkeypatch.setattr(autotune, "flash_key", no_lookup)
    for _ in range(3):
        assert tuned_flash_tile(q, k, v, causal=True, window=0) == 128
        assert tuned_ssd_chunk(x, dt, a, bm, cm) == DEFAULT_SSD_CHUNK
    # another shape or mask is resolved afresh
    with pytest.raises(AssertionError, match="memo"):
        tuned_flash_tile(q, k, v, causal=False, window=0)


def test_memo_follows_a_store_and_the_cache_directory(cache_dir, tmp_path, monkeypatch):
    """A new winner clears the memo, and another cache directory is
    another instance with its own."""
    q, k, v = _flash_args()
    ref = flash_attention_ref(q, k, v, causal=True, window=0)
    assert tuned_flash_tile(q, k, v, causal=True, window=0) == 128
    assert len(autotune.default_cache().memo) == 1
    autotune_flash_attention(q, k, v, runner=_runner({128: 9.0, 64: 6.0}, lambda _: ref))
    assert autotune.default_cache().memo == {}
    assert tuned_flash_tile(q, k, v, causal=True, window=0) == 64
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "elsewhere"))
    assert tuned_flash_tile(q, k, v, causal=True, window=0) == 128
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(cache_dir))
    assert tuned_flash_tile(q, k, v, causal=True, window=0) == 64


def test_unbuilt_head_dims_leave_the_refusal_to_the_launcher(cache_dir):
    """No kv tile for head dims on a SIMT route (bf16 at the smoke dims D
    16), which has one; D 96 runs its bucket's (128, 128) kernel and takes
    that kernel's default tile, and D 20 (not a multiple of 8, staged onto
    the (64, 64) bucket's kernel) that bucket's."""
    assert tuned_flash_tile(*_flash_args(d=16), causal=True, window=0) is None
    assert (tuned_flash_tile(*_flash_args(d=96), causal=True, window=0)
            == flash_tile_candidates(128, 128)[0])
    assert (tuned_flash_tile(*_flash_args(d=20), causal=True, window=0)
            == flash_tile_candidates(64, 64)[0])


# ------------------------------------- parity with repro.kernels.autotune ----
# The port keeps the reference's cache format, load rules and file name, so
# the same directory reads the same under both packages, and each reads the
# other's file.  The deliberate differences are named below:
#   * flash_key: the reference keys (BH, S, D) arrays, the port (B, S, H, D)
#     tensors with GQA's kv heads and v's own head dim;
#   * device_signature: ``cuda:<name>:<count>`` against jax's
#     ``platform:device_kind:count``;
#   * _sweep: the port measures the default first and keeps it unless a
#     candidate is faster *and* agrees with its output, so the default wins
#     a tie and an out-of-grid default can still win; the reference takes the
#     first fastest candidate of the grid and never checks outputs.
SIG = "cuda:NVIDIA H100 80GB HBM3:1"


@pytest.fixture(scope="module")
def ref_autotune():
    from repro.kernels import autotune as ref
    return ref


def _good_file(entries):
    return json.dumps({"device_signature": SIG, "entries": entries})


CORPUS = {
    "missing": None,
    "not_json": "{ not json",
    "empty": "",
    "list": "[1, 2]",
    "foreign_signature": json.dumps({"device_signature": "tpu:TPU v5 lite:1", "entries": {
        "ssd_scan|k": {"blocks": {"chunk": 64}}}}),
    "entries_not_a_dict": json.dumps({"device_signature": SIG, "entries": [1]}),
    "no_entries": json.dumps({"device_signature": SIG}),
    "mixed_entries": _good_file({
        "flash_attention|good": {"blocks": {"kv_tile": 64}, "us": 1.0},
        "ssd_scan|good": {"blocks": {"chunk": 128}},
        "flash_attention|not_a_dict": {"blocks": "kv_tile"},
        "flash_attention|list": ["kv_tile", 64],
        "flash_attention|str_value": {"blocks": {"kv_tile": "64"}},
        "flash_attention|float_value": {"blocks": {"kv_tile": 64.0}},
        "flash_attention|no_blocks": {"us": 3.0},
        "flash_attention|empty_blocks": {"blocks": {}},
        "flash_attention|bool_value": {"blocks": {"kv_tile": True}},
    }),
}


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_cache_load_rules_match_reference(name, tmp_path, ref_autotune):
    """Every file of the corpus opens to the same entries under both
    packages (same signature, same directory, same file name)."""
    port = AutotuneCache(tmp_path, signature=SIG)
    if CORPUS[name] is not None:
        port.path.write_text(CORPUS[name])
    port = AutotuneCache(tmp_path, signature=SIG)
    ref = ref_autotune.AutotuneCache(tmp_path, signature=SIG)
    assert port.path == ref.path
    assert port._entries == ref._entries and len(port) == len(ref)
    for key in port._entries:
        kernel, shape = key.split("|", 1)
        assert port.lookup(kernel, shape) == ref.lookup(kernel, shape)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_file(writer, tmp_path, ref_autotune):
    entries = [("flash_attention", "k1", {"kv_tile": 64}), ("ssd_scan", "k2", {"chunk": 128})]
    pkg = autotune if writer == "port" else ref_autotune
    w = pkg.AutotuneCache(tmp_path, signature=SIG)
    for kernel, key, blocks in entries:
        w.store(kernel, key, pkg.TuneResult(blocks=blocks, us=3.0, default_us=4.5, sweep=[]))
    other = ref_autotune if writer == "port" else autotune
    r = other.AutotuneCache(tmp_path, signature=SIG)
    assert len(r) == len(entries)
    for kernel, key, blocks in entries:
        assert r.lookup(kernel, key) == blocks
        assert r._entries[f"{kernel}|{key}"]["speedup"] == 1.5
    # and under another signature neither reads it
    assert len(other.AutotuneCache(tmp_path, signature="cpu:x86_64:8")) == 0


@pytest.mark.parametrize("shape", [(1, 1024, 48, 64, 128), (4, 2048, 24, 64, 128),
                                   (2, 96, 2, 64, 16)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_key_matches_reference(shape, dtype, ref_autotune):
    import numpy as np
    import jax.numpy as jnp

    ref_dtype = np.dtype(getattr(jnp, dtype))
    assert autotune.ssd_key(*shape, getattr(torch, dtype)) == ref_autotune.ssd_key(
        *shape, ref_dtype)


def _both_sweeps(ref_autotune, monkeypatch, times, grid, default):
    """The port's and the reference's _sweep over one timing table
    ({tile: µs}); every candidate's output agrees."""
    monkeypatch.setattr(ref_autotune, "_time_us", lambda fn, repeats: fn())
    name = next(iter(default))
    out = torch.zeros(3)
    port = autotune._sweep(lambda blocks: (out, times[blocks[name]]),
                           [{name: t} for t in grid], default, tol=1e-2)
    ref = ref_autotune._sweep(lambda blocks: times[blocks[name]],
                              [{name: t} for t in grid], default, repeats=1)
    return port, ref


_TIMING_SEEDS = range(6)


@pytest.mark.parametrize("seed", _TIMING_SEEDS)
@pytest.mark.parametrize("grid,default", [
    ((128, 64), {"kv_tile": 128}),          # flash bf16 at D 64, 128
    ((64,), {"kv_tile": 64}),               # flash bf16 at D 256
    ((64, 128), {"chunk": 128}),            # SSD bf16
    ((32, 64, 128), {"chunk": 128}),        # SSD fp32
], ids=["flash", "flash_d256", "ssd_bf16", "ssd_f32"])
def test_sweep_winner_matches_reference(seed, grid, default, ref_autotune, monkeypatch):
    """On one timing table of distinct times, with the default in the grid
    and every candidate agreeing, both sweeps pick the same tile and report
    the same times."""
    import numpy as np

    rng = np.random.default_rng(seed)
    times = dict(zip(grid, (float(t) for t in rng.permutation(len(grid)) * 7.0 + 3.0)))
    port, ref = _both_sweeps(ref_autotune, monkeypatch, times, grid, default)
    assert port.blocks == ref.blocks
    assert (port.us, port.default_us, port.speedup) == (ref.us, ref.default_us, ref.speedup)
    assert [(r["blocks"], r["us"]) for r in port.sweep] == [(r["blocks"], r["us"])
                                                            for r in ref.sweep]


def test_sweep_named_exception_default_wins_a_tie(ref_autotune, monkeypatch):
    """Deliberate difference: on a tie the port keeps the default tile; the
    reference takes the first candidate of the grid."""
    port, ref = _both_sweeps(ref_autotune, monkeypatch, {64: 5.0, 128: 5.0}, (64, 128),
                             {"chunk": 128})
    assert port.blocks == {"chunk": 128} and ref.blocks == {"chunk": 64}
    assert port.us == ref.us == 5.0


def test_sweep_named_exception_out_of_grid_default_can_win(ref_autotune, monkeypatch):
    """Deliberate difference: the port measures the default first and keeps
    it when no candidate is faster, in the grid or not; the reference picks
    the grid's best even when the default it measures after is faster."""
    port, ref = _both_sweeps(ref_autotune, monkeypatch, {64: 6.0, 128: 4.0}, (64,),
                             {"kv_tile": 128})
    assert port.blocks == {"kv_tile": 128} and port.us == 4.0
    assert ref.blocks == {"kv_tile": 64} and ref.us == 6.0
    assert port.default_us == ref.default_us == 4.0


def test_sweep_named_exception_disagreeing_candidate(ref_autotune, monkeypatch):
    """Deliberate difference: the port refuses a faster tile whose output
    is off the default's; the reference does not compare outputs."""
    monkeypatch.setattr(ref_autotune, "_time_us", lambda fn, repeats: fn())
    times = {128: 5.0, 64: 2.0}
    port = autotune._sweep(
        lambda blocks: (torch.full((3,), float(blocks["kv_tile"] == 64)), times[blocks["kv_tile"]]),
        [{"kv_tile": 128}, {"kv_tile": 64}], {"kv_tile": 128}, tol=1e-2)
    ref = ref_autotune._sweep(lambda blocks: times[blocks["kv_tile"]],
                              [{"kv_tile": 128}, {"kv_tile": 64}], {"kv_tile": 128}, repeats=1)
    assert port.blocks == {"kv_tile": 128} and ref.blocks == {"kv_tile": 64}
