"""Tile autotuning for the port's Hopper kernels, with a persistent cache
(the port of ``repro.kernels.autotune``).

The kernels ship fixed default tiles, but the best tile depends on the
input shape, dtype and the device, and the right answer does not change
between runs on the same hardware.  So: measure once, key the verdict by
a *device signature*, and consult the cache on every later call.

* :func:`device_signature` — ``cuda:<device name>:<device count>``, or
  ``cpu:<machine>:<cores>`` without a card.  A cache written on one device
  kind is **ignored** on another: winners are measurements, not portable
  facts.
* :class:`AutotuneCache` — one JSON file per device signature under
  ``$REPRO_TORCH_AUTOTUNE_CACHE`` (default ``~/.cache/repro_torch_autotune``;
  the JAX package's ``REPRO_AUTOTUNE_CACHE`` and its directory are never
  read).  Writes are atomic (tmp + ``os.replace``); a corrupt or
  foreign-device file is ignored at open and overwritten on the next flush.
* :func:`autotune_flash_attention` / :func:`autotune_ssd_scan` — sweep the
  tiles the kernels are built for (the flash forward's kv tile,
  ``kernels/flash_attention.py:KV_TILES``; the SSD kernel's chunk tile,
  ``kernels/ssd_scan.py:CHUNKS``) on the *real* kernel and tensors on the
  card, best of ``repeats`` CUDA-event timings, and persist the winner.
  Each candidate's output is held against the default tile's before it
  may win; the default is always measured, in the grid or not.  A sweep
  runs on CUDA tensors only and raises on anything else, so a timed plain
  version never passes for a kernel's time (tests inject a ``runner``).
* :func:`tuned_flash_tile` / :func:`tuned_ssd_chunk` — the consultation
  path: ``kernels.ops.flash_attention`` and ``ssd_scan`` on CUDA with no
  tile named resolve it here (cache hit → the winner, miss → the default
  tile; set ``REPRO_TORCH_AUTOTUNE=1`` to tune on a miss instead).  A
  cached tile the kernel is no longer built for is a miss.  The answer is
  kept per shape in the cache instance (:attr:`AutotuneCache.memo`, cleared
  by every store), so a repeated call costs one dict lookup; the
  tune-on-miss switch is read at a shape's first call.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import threading
import time
from pathlib import Path
from typing import Any, Callable, Iterable, Sequence

import torch

from repro_torch.kernels.flash_attention import (default_kv_tile, flash_attention_cuda, kv_tiles,
                                                 tma_route)
from repro_torch.kernels.ssd_scan import chunk_tiles, ssd_scan_cuda

__all__ = [
    "AutotuneCache", "TuneResult", "device_signature", "default_cache",
    "autotune_flash_attention", "autotune_ssd_scan",
    "tuned_flash_tile", "tuned_ssd_chunk",
    "flash_tile_candidates", "ssd_chunk_candidates",
]

_ENV_CACHE_DIR = "REPRO_TORCH_AUTOTUNE_CACHE"
_ENV_AUTOTUNE = "REPRO_TORCH_AUTOTUNE"
_DEFAULT_DIR = "~/.cache/repro_torch_autotune"

#: the default tile the autotuner has to beat (the flash forward's depends
#: on the head dims: ``default_kv_tile``)
DEFAULT_SSD_CHUNK = 128
#: a candidate's output against the default tile's, max |a - b| / (1 + |b|):
#: the tile changes the order of the sums, not the function (flash as the
#: kernel is held to its plain version; SSD as chip_smoke.py's CHUNK_TOL)
AGREE_TOL = {"flash_attention": {torch.bfloat16: 2e-2, torch.float32: 1e-4},
             "ssd_scan": {torch.bfloat16: 1e-2, torch.float16: 1e-2, torch.float32: 1e-5}}
#: launches timed between one pair of CUDA events
_ITERS = 10


def device_signature() -> str:
    """``cuda:<name>:<count>`` of the card PyTorch sees, else
    ``cpu:<machine>:<cores>``."""
    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name(0)}:{torch.cuda.device_count()}"
    return f"cpu:{platform.machine() or 'unknown'}:{os.cpu_count() or 1}"


# --------------------------------------------------------------------------
# persistent cache
# --------------------------------------------------------------------------
@dataclasses.dataclass
class TuneResult:
    """One sweep's verdict: the winning tile and the evidence."""
    blocks: dict[str, int]
    us: float                      # best-of-N for the winner
    default_us: float              # same measurement for the default tile
    sweep: list[dict[str, Any]]    # every candidate: {blocks, us, agrees}

    @property
    def speedup(self) -> float:
        return self.default_us / self.us if self.us else 0.0


class AutotuneCache:
    """On-disk map ``(kernel, shape-key) -> winning tile``, scoped to one
    device signature.

    One JSON per signature (filename = short sha of the signature) holding
    ``{"device_signature": ..., "entries": {...}}``.  ``load`` ignores
    files whose recorded signature differs from the current one (a cache
    directory copied from another host is never consulted) and files it
    cannot parse (a truncated copy).
    """

    def __init__(self, directory: str | os.PathLike | None = None, *,
                 signature: str | None = None):
        if directory is None:
            directory = os.environ.get(_ENV_CACHE_DIR, _DEFAULT_DIR)
        self.directory = Path(directory).expanduser()
        self.signature = signature or device_signature()
        digest = hashlib.sha256(self.signature.encode()).hexdigest()[:16]
        self.path = self.directory / f"autotune-{digest}.json"
        self._lock = threading.Lock()
        self._entries: dict[str, dict[str, Any]] = self._load()
        #: the consultation path's resolved tiles by call shape; a store
        #: clears it, so a new winner is seen at the next call
        self.memo: dict[tuple, int | None] = {}

    def _load(self) -> dict[str, dict[str, Any]]:
        try:
            data = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return {}
        if not isinstance(data, dict):
            return {}
        if data.get("device_signature") != self.signature:
            # measurements from other hardware are not verdicts
            return {}
        entries = data.get("entries")
        if not isinstance(entries, dict):
            return {}
        # drop individually corrupt entries instead of trusting them
        good = {}
        for key, ent in entries.items():
            if (isinstance(ent, dict) and isinstance(ent.get("blocks"), dict)
                    and all(isinstance(v, int) for v in ent["blocks"].values())):
                good[key] = ent
        return good

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, kernel: str, key: str) -> dict[str, int] | None:
        """Winning tile for ``key``, or None on a miss."""
        ent = self._entries.get(f"{kernel}|{key}")
        return dict(ent["blocks"]) if ent else None

    def store(self, kernel: str, key: str, result: TuneResult) -> None:
        with self._lock:
            self._entries[f"{kernel}|{key}"] = {
                "blocks": dict(result.blocks),
                "us": round(result.us, 2),
                "default_us": round(result.default_us, 2),
                "speedup": round(result.speedup, 3),
                "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            }
            self.memo.clear()
            self._flush_locked()

    def _flush_locked(self) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        payload = json.dumps(
            {"device_signature": self.signature, "entries": self._entries},
            indent=1, sort_keys=True)
        tmp = self.path.with_name(self.path.name + f".tmp-{os.getpid()}")
        tmp.write_text(payload)
        os.replace(tmp, self.path)


_default_cache: AutotuneCache | None = None
_default_dir: str | None = None
_default_cache_lock = threading.Lock()


def default_cache() -> AutotuneCache:
    """Process-wide cache instance (re-created if the env dir changes —
    tests and ``chip_smoke.py`` repoint ``REPRO_TORCH_AUTOTUNE_CACHE`` at
    temporary directories).  Read on every kernel call that names no tile:
    one environment lookup and a string compare on a hit."""
    global _default_cache, _default_dir
    want = os.environ.get(_ENV_CACHE_DIR, _DEFAULT_DIR)
    if _default_cache is not None and _default_dir == want:
        return _default_cache
    with _default_cache_lock:
        if _default_cache is None or _default_dir != want:
            _default_cache, _default_dir = AutotuneCache(want), want
        return _default_cache


# --------------------------------------------------------------------------
# shape keys and candidate grids
# --------------------------------------------------------------------------
def _dtype_name(x: Any) -> str:
    """``bfloat16``, as the reference's keys spell a dtype."""
    return str(getattr(x, "dtype", x)).removeprefix("torch.")


def flash_key(b: int, s: int, sk: int, h: int, kv: int, dk: int, dv: int, dtype: Any, *,
              causal: bool, window: int) -> str:
    return (f"b{b}_s{s}_sk{sk}_h{h}_kv{kv}_d{dk}_dv{dv}_{_dtype_name(dtype)}"
            f"_c{int(causal)}_w{window}")


def ssd_key(bb: int, l: int, h: int, p: int, n: int, dtype: Any, g: int = 1) -> str:
    """The reference's key; a call with G > 1 B/C groups adds ``_g{G}``."""
    key = f"b{bb}_l{l}_h{h}_p{p}_n{n}_{_dtype_name(dtype)}"
    return key if g == 1 else f"{key}_g{g}"


def _ssd_groups(b: torch.Tensor) -> int:
    return b.shape[2] if b.dim() == 4 else 1


def flash_tile_candidates(dk: int, dv: int) -> list[int]:
    """The kv tiles the bf16 flash forward is built for at these head dims
    (rows of K and V a pipeline stage holds): their bucket's."""
    return list(kv_tiles(dk, dv))


def ssd_chunk_candidates(dtype: torch.dtype = torch.bfloat16, p: int = 64,
                         n: int = 128) -> list[int]:
    """The chunk tiles the SSD kernel of ``dtype`` and (P, N) is built for."""
    return list(chunk_tiles(dtype, p, n))


# --------------------------------------------------------------------------
# measurement
# --------------------------------------------------------------------------
def _require_cuda(what: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{what}: a sweep times the kernel on the card; a tensor is on "
                             f"{t.device}")


def _time_us(fn: Callable[[], Any], repeats: int) -> float:
    """Best of ``repeats`` CUDA-event timings, each over ``_ITERS`` launches,
    in µs a launch (a first call outside the timing warms up)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(_ITERS):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3 / _ITERS)
    return best


def _timed_runner(launch: Callable[[dict[str, int]], Any], repeats: int):
    def run(blocks: dict[str, int]):
        out = launch(blocks)
        torch.cuda.synchronize()
        return out, _time_us(lambda: launch(blocks), repeats)
    return run


def _scaled_diff(a: Any, b: Any) -> float:
    """max |a - b| / (1 + |b|) over a tensor or a tuple of them."""
    if isinstance(a, (tuple, list)):
        return max(_scaled_diff(x, y) for x, y in zip(a, b))
    a, b = a.float(), b.float()
    return ((a - b).abs() / (1 + b.abs())).max().item()


def _sweep(run: Callable[[dict[str, int]], tuple[Any, float]],
           candidates: Iterable[dict[str, int]], default_blocks: dict[str, int],
           tol: float) -> TuneResult:
    """``run(blocks) -> (output, µs)``.  The default is measured first,
    whether or not it is in the grid; a candidate whose output is more than
    ``tol`` from the default's cannot win."""
    ref, default_us = run(default_blocks)
    sweep: list[dict[str, Any]] = []
    best_blocks, best_us = dict(default_blocks), default_us
    for blocks in candidates:
        if blocks == default_blocks:
            us, diff = default_us, 0.0
        else:
            out, us = run(blocks)
            diff = _scaled_diff(out, ref)
        agrees = diff <= tol
        sweep.append({"blocks": dict(blocks), "us": round(us, 2),
                      "vs_default": diff, "agrees": agrees})
        if agrees and us < best_us:
            best_blocks, best_us = dict(blocks), us
    return TuneResult(blocks=best_blocks, us=best_us, default_us=default_us, sweep=sweep)


def autotune_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             cache: AutotuneCache | None = None,
                             candidates: Sequence[int] | None = None,
                             repeats: int = 5,
                             runner: Callable[[dict[str, int]], tuple[Any, float]] | None = None
                             ) -> TuneResult:
    """Sweep the kv tile of the bf16 flash forward on (B, S, H, D) CUDA
    tensors; persist the winner.  ``runner(blocks) -> (output, µs)`` stands
    in for launching and timing (tests)."""
    b, s, h, dk = q.shape
    sk, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype != torch.bfloat16:
        raise ValueError(f"autotune_flash_attention: the {q.dtype} kernel has one tile")
    if runner is None:
        _require_cuda("autotune_flash_attention", q, k, v)
        runner = _timed_runner(lambda blocks: flash_attention_cuda(
            q, k, v, causal=causal, window=window, kv_tile=blocks["kv_tile"]), repeats)
    tiles = candidates or flash_tile_candidates(dk, dv)
    result = _sweep(runner, [{"kv_tile": t} for t in tiles],
                    {"kv_tile": default_kv_tile(dk, dv)}, AGREE_TOL["flash_attention"][q.dtype])
    cache = cache or default_cache()
    cache.store("flash_attention",
                flash_key(b, s, sk, h, kv, dk, dv, q.dtype, causal=causal, window=window),
                result)
    return result


def autotune_ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, *, cache: AutotuneCache | None = None,
                      candidates: Sequence[int] | None = None, repeats: int = 5,
                      runner: Callable[[dict[str, int]], tuple[Any, float]] | None = None
                      ) -> TuneResult:
    """Sweep the SSD kernel's chunk tile on model-layout CUDA tensors (b, c
    (B, L, N) or (B, L, G, N)); persist the winner.  ``runner`` as for
    flash."""
    bb, l, h, p = x.shape
    n = b.shape[-1]
    if runner is None:
        _require_cuda("autotune_ssd_scan", x, dt, a, b, c)
        runner = _timed_runner(lambda blocks: ssd_scan_cuda(x, dt, a, b, c,
                                                            chunk=blocks["chunk"]), repeats)
    chunks = candidates or ssd_chunk_candidates(x.dtype, p, n)
    result = _sweep(runner, [{"chunk": ch} for ch in chunks], {"chunk": DEFAULT_SSD_CHUNK},
                    AGREE_TOL["ssd_scan"][x.dtype])
    cache = cache or default_cache()
    cache.store("ssd_scan", ssd_key(bb, l, h, p, n, x.dtype, _ssd_groups(b)), result)
    return result


# --------------------------------------------------------------------------
# consultation (the ops.py entry points call these on CUDA when the
# caller names no tile)
# --------------------------------------------------------------------------
def _tune_on_miss() -> bool:
    return os.environ.get(_ENV_AUTOTUNE, "") == "1"


def tuned_flash_tile(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                     window: int) -> int | None:
    """The kv tile for a (B, S, H, D) flash call: cache hit on a tile the
    kernel is built for → the winner; miss → the default tile (or a fresh
    sweep under ``REPRO_TORCH_AUTOTUNE=1``).  None for fp32, whose kernel
    has one tile, and for head dims with no kernel (the launcher says so)."""
    if q.dtype != torch.bfloat16:
        return None
    cache = default_cache()
    shape = ("flash_attention", q.shape, k.shape, v.shape, causal, window)
    if shape in cache.memo:
        return cache.memo[shape]
    b, s, h, dk = q.shape
    sk, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    if not tma_route(q.dtype, dk, dv):
        tile = None
    else:
        key = flash_key(b, s, sk, h, kv, dk, dv, q.dtype, causal=causal, window=window)
        hit = cache.lookup("flash_attention", key) or {}
        tile = hit.get("kv_tile")
        if tile not in flash_tile_candidates(dk, dv):
            tile = (autotune_flash_attention(q, k, v, causal=causal, window=window,
                                             cache=cache).blocks["kv_tile"]
                    if _tune_on_miss() else default_kv_tile(dk, dv))
    cache.memo[shape] = tile
    return tile


def tuned_ssd_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> int:
    """The chunk tile for a model-layout SSD call (same contract as
    :func:`tuned_flash_tile`)."""
    cache = default_cache()
    shape = ("ssd_scan", x.shape, b.shape, x.dtype)
    if shape in cache.memo:
        return cache.memo[shape]
    bb, l, h, p = x.shape
    n = b.shape[-1]
    hit = cache.lookup("ssd_scan", ssd_key(bb, l, h, p, n, x.dtype, _ssd_groups(b))) or {}
    chunk = hit.get("chunk")
    if chunk not in chunk_tiles(x.dtype, p, n):
        chunk = (autotune_ssd_scan(x, dt, a, b, c, cache=cache).blocks["chunk"]
                 if _tune_on_miss() else DEFAULT_SSD_CHUNK)
    cache.memo[shape] = chunk
    return chunk
