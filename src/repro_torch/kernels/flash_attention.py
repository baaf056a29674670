"""Launcher of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention.py`` (``_kernel`` and
``flash_attention_bh``).  The Pallas kernel took heads folded to
(BH, S, D) with GQA expanded by the caller and padded S to its blocks;
this kernel reads the model layout (B, S, H, D) in place, maps q head h
to kv head h // (H / KV), and masks the ragged edge itself, so the
launcher makes no copy.  v may be narrower than q and k (multi-head
latent attention: q/k dim 192, v dim 128); the output has v's width.
The bf16 kernel loads its tiles by TMA: this module computes the tensor
maps' layouts (:func:`tma_layout`) and the C side encodes them.  The
source's header says what bounds the kernel on the H100 and what its
design does about it.  bf16 at q/k 192, v 128 (deepseek-v3's MLA) takes
a kernel of its own, ``csrc/flash_attention_fwd_ws.cu`` (:func:`ws_route`).

:func:`flash_attention_bwd_cuda` launches the gradient's two kernels
(``csrc/flash_attention_bwd.cu``) from the forward's output and per-row
logsumexp, at every head-dim pair the forward takes.  At (256, 256) and
(192, 128) in bf16 the dQ kernel takes 128 q rows a block (its Delta /
lse scratch padded to them, :func:`bwd_scratch_rows`), and the dK/dV
kernel may split each kv tile's q heads into shares over blocks
(:func:`bwd_head_shares`, from the shapes and the card's SM count), and a
third kernel then sums the shares' fp32 partials in a fixed order.  bf16
at the models' head dims goes to the wgmma + TMA kernels, the smoke
configs' head dims (16, 16) and (24, 16) in bf16 to SIMT kernels.  fp32
takes a route of its own in both directions (:func:`route`, kind "f32";
:func:`bwd_route` is :func:`route`): register-tiled kernels on the CUDA
cores at every head-dim pair up to 256, templated on the buckets
``F32_BUCKETS`` with the real dims at run time, the forward
``csrc/flash_attention_fwd_f32.cu`` (tiles :func:`fwd_f32_tiles`) and
the backward's two kernels ``csrc/flash_attention_bwd_f32.cu`` (tiles
:func:`bwd_f32_tiles`), with head shares and their fixed-order sum where
few kv tiles would leave SMs idle.

Every other head-dim pair up to 256 in bf16, and fp16, take one of three
more routes (:func:`route`), all on the wgmma + TMA kernels of the
smallest built pair that holds the dims (its bucket, ``BUCKETS``): bf16
at head dims that are multiples of 8 with tensor maps at the real dims
(TMA zero-fills the last box's columns past them;
``csrc/flash_attention_pad.cu``, ``csrc/flash_attention_bwd_pad.cu``,
and ``flash_fwd_bf16_ws`` in the (192, 128) bucket); fp16 at every
head-dim pair that is a multiple of 8 (the built pairs, the smoke dims
and the rest) takes the same kernels in f16 wgmma with f16 tensor maps,
the forward's padded form at the bucket's default kv tile and the
backward's at a built pair's own widths or padded
(``csrc/flash_attention_f16.cu``, ``csrc/flash_attention_bwd_f16.cu``,
``flash_attention_fwd_ws_f16`` in ``csrc/flash_attention_fwd_ws.cu``);
and bf16 and fp16 at head dims that are not multiples of 8 are staged
(kind "stage"): TMA needs 16-byte row strides and the kernels store
aligned pairs, so their rows are copied into buffers whose pitch is each
head dim rounded up to a multiple of 8, the columns past it zero
(``csrc/flash_attention_stage.cu``, one launch for every tensor of a
direction); the padded or fp16 entries run at those pitches with the
real q/k dim's scale, and the outputs are copied back at the real dims.
Zero columns leave every score, O, dQ, dK and dV as they are.  The C
entries take the dtype as a code (``_DTYPES``: 0 fp32, 1 bf16, 2 fp16)
and refuse one they are not built for.  The route follows from dtype and head dims alone, never
from a failure of another route.  The public entry is
:func:`repro_torch.kernels.ops.flash_attention` (with
:class:`repro_torch.kernels.ops.FlashAttention` for autograd), which
counts the launches; this module only checks and launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.bfloat16: 1, torch.float32: 0, torch.float16: 2}
# the largest q/k and v head dim any route takes
MAX_HEAD_DIM = 256
# the (q/k head dim, v head dim) pairs with instantiations of their own
# (every other pair takes a bucket's kernels, see route):
# the models' (bf16 on wgmma + TMA) and the smoke configs' (bf16 on SIMT:
# 16 or 24 columns are not whole TMA boxes); fp32 takes F32_BUCKETS
SIMT_HEAD_DIMS = frozenset({(16, 16), (24, 16)})
HEAD_DIMS = frozenset({(64, 64), (128, 128), (256, 256), (192, 128)}) | SIMT_HEAD_DIMS
BWD_HEAD_DIMS = HEAD_DIMS
# the built pairs a padded bf16 call runs on (its bucket: the first that
# holds both head dims), smallest first
BUCKETS = ((64, 64), (128, 128), (192, 128), (256, 256))
# the head dims whose bf16 forward is csrc/flash_attention_fwd_ws.cu's
# kernel (flash_fwd_bf16_ws): 128 q rows a block, one block an SM
WS_HEAD_DIMS = frozenset({(192, 128)})
# the bf16 kernels' tiles: q rows per block (WM in the sources), and by
# head dims the kv tiles they are built for (WN, rows of K and V a pipeline
# stage holds), the default first.  At q/k dim 256 a 128-key stage does
# not fit beside Q in 227 KB, so only 64 rows are built there; the MLA
# kernel (192, 128) is built for 128 rows (64 read slower, PERF.md §6)
BLOCK_Q = 128
KV_TILES = {(64, 64): (128, 64), (128, 128): (128, 64), (192, 128): (128,),
            (256, 256): (64,)}
# the bf16 backward's tiles (ROWS in csrc/flash_attention_bwd.cu): TMA
# boxes of 64 rows of q, dO, k and v; its lse / Delta scratch pads S to them
BWD_BOX_ROWS = 64
# columns of one TMA box: 128 bytes of bf16, the span of the 128-byte swizzle
BOX_COLS = 64
# the bf16 head dims whose backward kernels are two warpgroups a block, one
# block an SM (csrc/flash_attention_bwd.cu): the dK/dV kernel over one
# 64-row kv tile (flash_bwd_dkdv_bf16_split), which below BWD_SPLIT_WAVES
# waves of such blocks splits each kv tile's (head, q tile) items into head
# shares over blocks, and the dQ kernel over 128 q rows of one head
# (flash_bwd_dq_bf16_pair); every other route's dQ block has BWD_BOX_ROWS q
# rows
SPLIT_HEAD_DIMS = frozenset({(256, 256), (192, 128)})
BWD_SPLIT_WAVES = 2
# the fp32 kernels' buckets of widths, smallest first (BUCKETS in
# csrc/flash_attention_fwd_f32.cu and csrc/flash_attention_bwd_f32.cu): a
# call takes the first that holds its head dims, with the real dims at run
# time; by bucket the backward's rows a block keeps (kv rows of dK/dV, q
# rows of dQ) and the rows a stage streams, and the forward's q rows a
# block keeps and kv rows a stage streams
F32_BUCKETS = ((64, 64), (96, 96), (128, 128), (192, 128), (256, 256))
F32_TILE_ROWS = {(64, 64): (64, 64), (96, 96): (64, 64), (128, 128): (64, 32),
                 (192, 128): (64, 32), (256, 256): (32, 32)}
F32_FWD_TILES = {(64, 64): (128, 64), (96, 96): (128, 64), (128, 128): (128, 32),
                 (192, 128): (128, 32), (256, 256): (64, 32)}
# the floats that pad each of the fp32 kernels' shared rows (the forward's
# score rows by F32_SCORE_PAD); the shared memory a block can use on the
# H100
F32_PAD = 4
F32_SCORE_PAD = 8
SMEM_BYTES = 232448
# the fp32 dK/dV kernel splits a kv tile's q heads until one wave is launched
F32_SPLIT_WAVES = 1


class DqTiles(NamedTuple):
    """A bf16 dQ kernel's tiles: q rows a block, kv rows a K/V stage,
    stages, and the shared bytes they take (with 1024 for alignment and the
    mbarriers), as csrc/flash_attention_bwd.cu's DqSmem and PairSmem lay
    them out."""
    rows: int
    kv_rows: int
    stages: int
    smem_bytes: int


def bwd_dq_tiles(dk: int, dv: int) -> DqTiles:
    """The wgmma dQ kernel's tiles (bf16 or fp16) at head dims (dk, dv),
    those of their bucket: on the two-warpgroup route each warpgroup's Q and dO (64 rows)
    stay, and three stages of K and V stream, 32 kv rows a stage at D 256
    (where 128 q rows of Q and dO take 128 KB), else 64; on the
    one-warpgroup route 64 q rows and two 64-row stages."""
    dk, dv = bucket(dk, dv)
    if (dk, dv) in SPLIT_HEAD_DIMS:
        rows, kv_rows, stages = 2 * BWD_BOX_ROWS, 32 if dk == 256 else BWD_BOX_ROWS, 3
    else:
        rows, kv_rows, stages = BWD_BOX_ROWS, BWD_BOX_ROWS, 2
    nbytes = 1024 + 2 * (rows + stages * kv_rows) * (dk + dv) + 8 * (1 + 2 * stages)
    return DqTiles(rows, kv_rows, stages, nbytes)


class F32Tiles(NamedTuple):
    """The fp32 backward's tiles at a bucket: ``dims`` the bucket, ``rows``
    a block keeps (kv rows of the dK/dV kernel, q rows of the dQ kernel),
    ``stream_rows`` a stage brings of the other side, ``stages`` (three
    where both kernels fit them, else two), and the shared bytes of each
    kernel as csrc/flash_attention_bwd_f32.cu's ``Tiles`` lays them out
    (rows padded by F32_PAD floats)."""
    dims: tuple[int, int]
    rows: int
    stream_rows: int
    stages: int
    dkdv_smem_bytes: int
    dq_smem_bytes: int


def f32_bucket(dk: int, dv: int) -> tuple[int, int]:
    """The fp32 kernels' bucket at head dims (dk, dv): the first of
    F32_BUCKETS that holds both (phi-2's D 80 takes (96, 96))."""
    return next((bk, bv) for bk, bv in F32_BUCKETS if dk <= bk and dv <= bv)


class F32FwdTiles(NamedTuple):
    """The fp32 forward's tiles at a bucket: ``dims`` the bucket, ``rows``
    of Q a block keeps, ``stream_rows`` of K and V a stage brings,
    ``stages`` (three where they fit, else two), ``dsplit`` the score
    tile's partial sums over the head dim (two where a stage is 32 rows),
    and the shared bytes as csrc/flash_attention_fwd_f32.cu's ``Tiles``
    lays them out (one block an SM)."""
    dims: tuple[int, int]
    rows: int
    stream_rows: int
    stages: int
    dsplit: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def fwd_f32_tiles(dk: int, dv: int) -> F32FwdTiles:
    """The fp32 forward's tiles at head dims (dk, dv), those of their
    bucket: Q of ``rows`` rows stays, ``stages`` stages of ``stream_rows``
    rows of K and V stream (rows padded by F32_PAD floats); the score tile,
    rows x stream_rows padded by F32_SCORE_PAD, ``dsplit`` partial sums,
    then P; each row's alpha and l."""
    bk, bv = f32_bucket(dk, dv)
    rows, stream = F32_FWD_TILES[(bk, bv)]
    dsplit = 2 if stream == 32 else 1

    def nbytes(stages: int) -> int:
        return 4 * (rows * (bk + F32_PAD) + stages * stream * (bk + bv + 2 * F32_PAD)
                    + dsplit * rows * (stream + F32_SCORE_PAD) + 2 * rows)

    stages = 3 if nbytes(3) <= SMEM_BYTES else 2
    return F32FwdTiles((bk, bv), rows, stream, stages, dsplit, nbytes(stages))


@functools.lru_cache(maxsize=None)
def bwd_f32_tiles(dk: int, dv: int) -> F32Tiles:
    """The fp32 backward's tiles at head dims (dk, dv), those of their
    bucket: K and V (dK/dV) or Q and dO (dQ) of ``rows`` rows stay,
    ``stages`` stages of ``stream_rows`` rows of the other two stream; the
    score tiles S^T and dP^T (S and dP in dQ), rows x stream_rows, are two
    partial sums each where a stage is 32 rows (each half of the threads
    cut in two over the head dim), then P^T and dS^T; with each stage's
    base-2 lse and Delta (dK/dV) or the block's (dQ)."""
    bk, bv = f32_bucket(dk, dv)
    rows, stream = F32_TILE_ROWS[(bk, bv)]
    width = bk + bv + 2 * F32_PAD                  # a row of both operands
    res, stage, lp = rows * width, stream * width, stream + F32_PAD
    dsplit = 2 if stream == 32 else 1              # partial sums a score tile
    scores = 2 * dsplit * rows * lp

    def nbytes(stages: int) -> tuple[int, int]:
        return (4 * (res + stages * stage + scores + stages * 2 * stream),
                4 * (res + stages * stage + scores + 2 * rows))

    stages = 3 if max(nbytes(3)) <= SMEM_BYTES else 2
    return F32Tiles((bk, bv), rows, stream, stages, *nbytes(stages))


def bwd_scratch_rows(s: int, dtype: torch.dtype, dk: int, dv: int) -> int:
    """Rows a (batch, head) of the backward's Delta / lse scratch holds: S
    rounded up to the dQ block's q rows, since a block stores its every row
    (0 past S); the dK/dV kernel reads whole 64-row tiles of it."""
    rows = bwd_dq_tiles(dk, dv).rows if tma_route(dtype, dk, dv) else BWD_BOX_ROWS
    return -(-s // rows) * rows


class Route(NamedTuple):
    """How a call runs: ``kind`` "tma" (bf16 at a built pair), "pad" (bf16
    at head dims that are multiples of 8 inside a built pair, on its
    kernels), "f16" (fp16 at head dims that are multiples of 8: the same
    kernels in fp16), "stage" (bf16 and fp16 at head dims that are not
    multiples of 8: "pad" or "f16" on copies at a pitch of a multiple of
    8), "f32" (fp32 at every pair: the register-tiled kernels, forward and
    backward) or "simt" (the smoke configs' head dims in bf16); ``dims``
    the instantiation's head dims: the bucket on "tma", "pad", "f16",
    "stage" and "f32", the real dims on "simt"."""
    kind: str
    dims: tuple[int, int]


@functools.lru_cache(maxsize=None)
def bucket(dk: int, dv: int) -> tuple[int, int]:
    """The smallest built pair that holds head dims (dk, dv) (phi-2's D 80
    takes (128, 128)); (dk, dv) itself where none does."""
    return next(((bk, bv) for bk, bv in BUCKETS if dk <= bk and dv <= bv), (dk, dv))


def pitch(d: int) -> int:
    """The staged route's row pitch for head dim ``d``: d rounded up to a
    multiple of 8 (16 bytes of bf16 or fp16)."""
    return -(-d // 8) * 8


@functools.lru_cache(maxsize=None)
def route(dtype: torch.dtype, dk: int, dv: int) -> Route:
    """The route of a call, by dtype and head dims alone (cached: the
    launchers ask at every call).  Raises for head dims past
    MAX_HEAD_DIM or a dtype no kernel takes."""
    if not (1 <= dk <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM) or dtype not in _DTYPES:
        raise ValueError(f"flash_attention: no route for head dims ({dk}, {dv}) in {dtype}")
    if dtype == torch.float32:
        return Route("f32", f32_bucket(dk, dv))
    if dtype == torch.bfloat16 and (dk, dv) in BUCKETS:
        return Route("tma", (dk, dv))
    if (dk, dv) in SIMT_HEAD_DIMS and dtype == torch.bfloat16:
        return Route("simt", (dk, dv))
    dims = bucket(pitch(dk), pitch(dv))
    if dk % 8 or dv % 8:
        return Route("stage", dims)
    return Route("pad" if dtype == torch.bfloat16 else "f16", dims)


def bwd_route(dtype: torch.dtype, dk: int, dv: int) -> Route:
    """The backward's route: the forward's, for every dtype and head dims
    (fp32 at every pair on the register-tiled kernels, kind "f32",
    ``dims`` its bucket in F32_BUCKETS)."""
    return route(dtype, dk, dv)


class TmaLayout(NamedTuple):
    """A (B, S, heads, D) tensor as a 4-D TMA tensor map: ``dims``
    innermost first (D, heads, S, B), ``strides`` in bytes of dims 1-3,
    and the ``box`` one load brings (BOX_COLS, 1, rows, 1)."""
    dims: tuple[int, int, int, int]
    strides: tuple[int, int, int]
    box: tuple[int, int, int, int]

    def flat(self) -> tuple[int, ...]:
        return self.dims + self.strides + self.box


def tma_layout(shape: tuple[int, int, int, int], stride: tuple[int, int, int, int],
               elem_bytes: int, rows: int) -> TmaLayout:
    """The tensor-map layout of a (B, S, heads, D) tensor with element
    strides ``stride`` whose boxes are ``rows`` sequence positions by
    BOX_COLS columns of one head.  ``dims`` carry the real D: where D is not
    whole boxes, TMA zero-fills the last box's columns past it.  Raises
    where TMA would refuse it: a D that is not contiguous, or a byte stride
    that is not a multiple of 16 below 2**40 (in bf16 a contiguous D that
    is not a multiple of 8)."""
    b, s, h, d = shape
    if stride[3] != 1:
        raise ValueError(f"tma_layout: head dim stride {stride[3]}, not 1")
    strides = (stride[2] * elem_bytes, stride[1] * elem_bytes, stride[0] * elem_bytes)
    for st in strides:
        if st % 16 or not 0 < st < 1 << 40:
            raise ValueError(f"tma_layout: byte stride {st} of a {tuple(shape)} tensor is "
                             "not a multiple of 16 below 2**40")
    return TmaLayout((d, h, s, b), strides, (BOX_COLS, 1, rows, 1))


_LAYOUTS: dict[tuple, ctypes.Array] = {}


def _cached_layouts(key: tuple, parts) -> ctypes.Array:
    """The flat TMA layouts of ``parts``, (shape, stride, box rows) of bf16
    or fp16 tensors, as a C array, cached by ``key`` (at most 256 entries): building
    the layouts takes tens of microseconds of host time, next to a kernel of
    ~0.05 ms."""
    arr = _LAYOUTS.get(key)
    if arr is None:
        flat = sum((tma_layout(tuple(shape), tuple(stride), 2, rows).flat()
                    for shape, stride, rows in parts), ())
        if len(_LAYOUTS) >= 256:
            _LAYOUTS.clear()
        arr = _LAYOUTS[key] = (ctypes.c_longlong * len(flat))(*flat)
    return arr


def layout_array(q_shape, q_stride, k_shape, k_stride, q_rows: int, kv_rows: int,
                 v_shape=None, v_stride=None) -> ctypes.Array:
    """The 33 layout values a wgmma launch takes (q's with boxes of
    ``q_rows`` rows, then k's and v's with boxes of ``kv_rows``; v's are
    k's unless ``v_shape`` and ``v_stride`` are given), as a C array."""
    if v_shape is None:
        v_shape, v_stride = k_shape, k_stride
    parts = tuple((tuple(shape), tuple(stride), rows) for shape, stride, rows in (
        (q_shape, q_stride, q_rows), (k_shape, k_stride, kv_rows), (v_shape, v_stride, kv_rows)))
    return _cached_layouts(parts, parts)


def ws_layout_array(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                    kv_rows: int) -> ctypes.Array:
    """The 44 layout values the MLA forward kernel takes: q's and o's with
    boxes of 64 rows (a consumer warpgroup's), k's and v's with boxes of
    ``kv_rows``, as a C array."""
    parts = tuple((tuple(t.shape), t.stride(), rows)
                  for t, rows in ((q, 64), (k, kv_rows), (v, kv_rows), (o, 64)))
    return _cached_layouts(parts, parts)


def bwd_layout_array(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     do: torch.Tensor) -> ctypes.Array:
    """The 44 layout values a wgmma backward launch takes: q's, k's, v's and
    dO's, each with boxes of BWD_BOX_ROWS rows, as a C array."""
    parts = tuple((tuple(t.shape), t.stride(), BWD_BOX_ROWS) for t in (q, k, v, do))
    return _cached_layouts(parts, parts)


def bwd_head_shares(b: int, kv: int, group: int, sk: int, sm_count: int,
                    rows: int = BWD_BOX_ROWS, waves: int = BWD_SPLIT_WAVES) -> int:
    """The head shares a dK/dV kernel of one block an SM splits each kv
    tile's items into (the two-warpgroup bf16 kernel's kv tiles are 64
    rows, the fp32 kernel's ``bwd_f32_tiles(dk, dv).rows``): its B * KV *
    ceil(Sk / rows) blocks take one SM each, so where they fill fewer than
    ``waves`` waves of ``sm_count`` blocks, each kv tile's ``group`` q
    heads are cut into as many shares as fill them, at most one a head.
    1 (no split, no partial sums) otherwise."""
    blocks = b * kv * -(-sk // rows)
    return max(1, min(group, -(-waves * sm_count // blocks)))


def bwd_f32_head_shares(b: int, kv: int, group: int, sk: int, dk: int, dv: int,
                        sm_count: int) -> int:
    """The fp32 dK/dV kernel's head shares: as many as fill one wave of
    ``sm_count`` blocks (F32_SPLIT_WAVES; :func:`bwd_head_shares` at its
    kv rows, ``bwd_f32_tiles``), rounded up to a divisor of the group, so
    that every share holds as many heads.  Its blocks hold K and V in
    shared memory and write their partials whole, so fewer, longer blocks
    read faster than two waves of shorter ones (D 128's group of 4: 2
    shares 0.633 ms, 4 shares 0.661, PERF.md §6)."""
    need = bwd_head_shares(b, kv, group, sk, sm_count, bwd_f32_tiles(dk, dv).rows,
                           F32_SPLIT_WAVES)
    return next(n for n in range(need, group + 1) if group % n == 0)


def bwd_partial_numel(shares: int, b: int, sk: int, kv: int, dk: int, dv: int) -> int:
    """fp32 elements of the head shares' partial dK and dV, (shares, B, Sk,
    KV, DK + DV); none without a split."""
    return 0 if shares == 1 else shares * b * sk * kv * (dk + dv)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fn():
    fn = build.library("flash_attention").flash_attention_fwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int])
        fn.restype = ctypes.c_int
    return fn


def _ws_fn():
    fn = build.library("flash_attention_fwd_ws").flash_attention_fwd_ws
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int])
        fn.restype = ctypes.c_int
    return fn


_SCHED: dict[tuple[int, int], torch.Tensor] = {}


def _sched_counters(device: torch.device, stream: int) -> torch.Tensor:
    """The MLA kernel's two item counters for launches on ``stream``: zeros
    made once, which every launch sets back to 0 as it ends.  Launches on
    one stream run one after another, so each finds them at 0; another
    stream has its own pair."""
    key = (device.index, stream)
    counters = _SCHED.get(key)
    if counters is None:
        counters = _SCHED[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return counters


def _pad_fn():
    fn = build.library("flash_attention_pad").flash_attention_fwd_pad
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 2)
        fn.restype = ctypes.c_int
    return fn


def _fwd_f32_fn():
    fn = build.library("flash_attention_fwd_f32").flash_attention_fwd_f32
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def _bwd_pad_fn():
    fn = build.library("flash_attention_bwd_pad").flash_attention_bwd_pad
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 3)
        fn.restype = ctypes.c_int
    return fn


def _bwd_f32_fn():
    fn = build.library("flash_attention_bwd_f32").flash_attention_bwd_f32
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 2)
        fn.restype = ctypes.c_int
    return fn


def _f16_fn():
    fn = build.library("flash_attention_f16").flash_attention_fwd_f16
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 2)
        fn.restype = ctypes.c_int
    return fn


def _ws_f16_fn():
    fn = build.library("flash_attention_fwd_ws").flash_attention_fwd_ws_f16
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int])
        fn.restype = ctypes.c_int
    return fn


def _bwd_f16_fn():
    fn = build.library("flash_attention_bwd_f16").flash_attention_bwd_f16
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 3)
        fn.restype = ctypes.c_int
    return fn


def _stage_fn():
    fn = build.library("flash_attention_stage").flash_attention_stage
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _restage(tensors, widths, stream: int) -> list[torch.Tensor]:
    """``tensors`` (contiguous, 2-byte elements) at the head dims
    ``widths``: each whose own head dim differs copied row by row, cut or
    zero-padded past its own, by one launch of the staging kernel
    (csrc/flash_attention_stage.cu) for all of them; the others as they
    are (contiguous and 16-byte aligned, which ``_check`` asks of every
    input)."""
    out = [t if t.shape[-1] == w else t.new_empty(t.shape[:-1] + (w,))
           for t, w in zip(tensors, widths)]
    flat = []
    for src, dst in zip(tensors, out):
        if dst is not src:
            flat += [src.data_ptr(), dst.data_ptr(), src.numel() // src.shape[-1],
                     src.shape[-1], dst.shape[-1]]
    if flat:
        err = _stage_fn()((ctypes.c_longlong * len(flat))(*flat), len(flat) // 5, stream)
        if err:
            raise RuntimeError(f"flash_attention: staging copy failed with CUDA error {err}")
    return out


def _bwd_fn():
    fn = build.library("flash_attention_bwd").flash_attention_bwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 2)
        fn.restype = ctypes.c_int
    return fn


TC_KINDS = ("tma", "pad", "f16", "stage")   # the routes on the wgmma + TMA kernels


def tma_route(dtype: torch.dtype, dk: int, dv: int) -> bool:
    """Whether a call takes the wgmma + TMA kernels (bf16 and fp16 at every
    head-dim pair but the bf16 smoke dims) rather than the SIMT ones: by
    dtype and head dims alone."""
    return route(dtype, dk, dv).kind in TC_KINDS


def ws_route(dtype: torch.dtype, dk: int, dv: int) -> bool:
    """Whether a forward call takes ``flash_fwd_bf16_ws``
    (csrc/flash_attention_fwd_ws.cu, in bf16 or fp16): bf16 or fp16 at
    WS_HEAD_DIMS or padded or staged inside them, by dtype and head dims
    alone."""
    r = route(dtype, dk, dv)
    return r.kind in TC_KINDS and r.dims in WS_HEAD_DIMS


def kv_tiles(dk: int, dv: int) -> tuple[int, ...]:
    """The bf16 forward's kv tiles at head dims (dk, dv): their bucket's."""
    return KV_TILES[bucket(dk, dv)]


def default_kv_tile(dk: int, dv: int) -> int:
    """The bf16 forward's kv tile at head dims (dk, dv) when none is named."""
    return kv_tiles(dk, dv)[0]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, H, D)")
    b, s, h, d = q.shape
    bk, sk, kvh, dk = k.shape
    if v.shape[:3] != k.shape[:3] or bk != b or dk != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: {h} q heads do not group over {kvh} kv heads")
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= v.shape[-1] <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: head dims (q/k {d}, v {v.shape[-1]}) past the "
                         f"limit: the kernels take 1 <= D, Dv <= {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "the kernels take bf16, fp16 or fp32, all alike")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, not {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and 16-byte aligned")
    if s == 0 or sk == 0 or b * h == 0:
        raise ValueError("flash_attention: empty batch, heads or sequence")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool, window: int, return_lse: bool = False,
                         kv_tile: int | None = None):
    """q: (B, S, H, D); k: (B, Sk, KV, D); v: (B, Sk, KV, Dv) on one CUDA
    device -> o (B, S, H, Dv), and with ``return_lse`` also each row's
    logsumexp (B, H, S) in fp32.  1 <= D, Dv <= MAX_HEAD_DIM; bf16, fp16
    or fp32 (:func:`route` picks the kernel: bf16 and fp16 the wgmma + TMA
    kernels of the dims' bucket, on copies at a pitch of a multiple of 8
    where a head dim is not one, but bf16 at the smoke head dims SIMT;
    fp32 the register-tiled kernel).  ``kv_tile`` picks the bf16 wgmma
    kernel's kv tile among its bucket's ``KV_TILES`` (None: the default);
    fp16 on wgmma is built at the default tile alone, and the fp32 and
    SIMT kernels have one tile: both take None or that tile only, else
    ValueError."""
    _check(q, k, v)
    b, s, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    r = route(q.dtype, d, dv)
    tile = 0
    if r.kind in TC_KINDS:
        built = KV_TILES[r.dims] if q.dtype == torch.bfloat16 else KV_TILES[r.dims][:1]
        tile = built[0] if kv_tile is None else kv_tile
        if tile not in built:
            raise ValueError(f"flash_attention: kv tile {tile} at head dims ({d}, {dv}) in "
                             f"{q.dtype}; the kernel is built for {built}")
    elif kv_tile is not None:
        raise ValueError(f"flash_attention: the {q.dtype} kernel at head dims ({d}, {dv}) has "
                         f"one tile; kv_tile {kv_tile} was named")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kind, scale_dk, real_dv = r.kind, d, dv
    with torch.cuda.device(q.device):
        if kind == "stage":   # pitched copies on the padded or fp16 route: d, dv their pitches
            q, k, v = _restage((q, k, v), (pitch(d), pitch(d), pitch(dv)), stream)
            kind = "pad" if q.dtype == torch.bfloat16 else "f16"
            d, dv = q.shape[3], v.shape[3]
        o = q.new_empty((b, s, h, dv))
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
        lse_ptr = None if lse is None else lse.data_ptr()
        if tile and r.dims in WS_HEAD_DIMS and kind == "f16":   # the MLA kernel in fp16
            err = _ws_f16_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               b, s, sk, h, kvh, d, dv, int(causal), int(window),
                               _DTYPES[q.dtype], stream, ws_layout_array(q, k, v, o, tile),
                               lse_ptr, tile, _sched_counters(q.device, stream).data_ptr(),
                               scale_dk)
        elif tile and r.dims in WS_HEAD_DIMS:   # the MLA kernel: TMA layouts of q, k, v and o
            err = _ws_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                           b, s, sk, h, kvh, d, dv, int(causal), int(window), stream,
                           ws_layout_array(q, k, v, o, tile), lse_ptr, tile,
                           _sched_counters(q.device, stream).data_ptr(), scale_dk)
        elif kind == "f16":   # the bucket's kernel in fp16, TMA layouts at the real dims
            layout = layout_array(q.shape, q.stride(), k.shape, k.stride(), BLOCK_Q, tile,
                                  v.shape, v.stride())
            err = _f16_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            b, s, sk, h, kvh, d, dv, *r.dims, int(causal), int(window),
                            _DTYPES[q.dtype], stream, layout, lse_ptr, tile, scale_dk)
        elif kind == "f32":   # the register-tiled kernel of the bucket
            err = _fwd_f32_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                b, s, sk, h, kvh, d, dv, int(causal), int(window),
                                _DTYPES[q.dtype], stream, lse_ptr)
        elif kind == "pad":   # the bucket's kernel, TMA layouts at the real dims
            layout = layout_array(q.shape, q.stride(), k.shape, k.stride(), BLOCK_Q, tile,
                                  v.shape, v.stride())
            err = _pad_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            b, s, sk, h, kvh, d, dv, *r.dims, int(causal), int(window),
                            stream, layout, lse_ptr, tile, scale_dk)
        else:
            layout = None
            if tile:   # the TMA layouts of q, k and v
                layout = layout_array(q.shape, q.stride(), k.shape, k.stride(), BLOCK_Q, tile,
                                      v.shape, v.stride())
            err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        b, s, sk, h, kvh, d, dv, int(causal), int(window), _DTYPES[q.dtype],
                        stream, layout, lse_ptr, tile)
        if not err and r.kind == "stage":   # O back at v's real head dim
            (o,) = _restage((o,), (real_dv,), stream)
    if err < 0:
        raise RuntimeError(f"flash_attention: TMA tensor map not encoded (code {err})")
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    return (o, lse) if return_lse else o


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool, window: int
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`flash_attention_cuda`: q (B, S, H, D), o, do
    (B, S, H, Dv), k (B, Sk, KV, D), v (B, Sk, KV, Dv), lse (B, H, S) fp32
    from the forward -> (dq, dk, dv) in the inputs' dtype, dk and dv summed
    over each kv head's q heads.  Head dims and dtypes as the forward's,
    on the route :func:`bwd_route` names (fp32: the register-tiled
    kernels; bf16 and fp16: the forward's route, staged as the forward is:
    q, k, v, o and dO copied at the pitch in one launch, dq, dk and dv back
    at the real dims in another)."""
    _check(q, k, v)
    do = do.contiguous()
    b, s, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("o", o), ("do", do)):
        if t.shape != (b, s, h, dv) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, not ({b}, {s}, {h}, {dv}) {q.dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must be contiguous and 16-byte "
                             "aligned")
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse is {tuple(lse.shape)} {lse.dtype} on "
                         f"{lse.device}; expected contiguous ({b}, {h}, {s}) float32 on "
                         f"{q.device}")
    r = bwd_route(q.dtype, d, dv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kind, scale_dk, real = r.kind, d, (d, d, dv)
    if kind == "stage":   # pitched copies on the padded or fp16 route: d, dv their pitches
        with torch.cuda.device(q.device):
            q, k, v, o, do = _restage((q, k, v, o, do), [pitch(n) for n in (d, d, dv, dv, dv)],
                                      stream)
        kind = "pad" if q.dtype == torch.bfloat16 else "f16"
        d, dv = q.shape[3], v.shape[3]
    layout, shares, part = None, 1, None
    if r.kind in TC_KINDS:   # the TMA layouts of q, k, v and dO
        layout = bwd_layout_array(q, k, v, do)
        if r.dims in SPLIT_HEAD_DIMS:
            shares = bwd_head_shares(b, kvh, h // kvh, sk, _sm_count(q.device.index))
    elif r.kind == "f32":
        shares = bwd_f32_head_shares(b, kvh, h // kvh, sk, d, dv, _sm_count(q.device.index))
    dq, dk, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # Delta and lse in base 2 for the dK/dV kernel, written by the dQ kernel
    s_pad = bwd_scratch_rows(s, q.dtype, *r.dims)
    scratch = torch.empty(2 * b * h * s_pad, dtype=torch.float32, device=q.device)
    if shares > 1:   # the head shares' partial dK and dV, summed by a pass of their own
        dims = (d, dv) if r.kind == "f32" else r.dims   # fp32 partials at the real dims
        part = torch.empty(bwd_partial_numel(shares, b, sk, kvh, *dims), dtype=torch.float32,
                           device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv_.data_ptr(), scratch.data_ptr())
    with torch.cuda.device(q.device):
        if kind == "f32":
            err = _bwd_f32_fn()(*ptrs, b, s, sk, h, kvh, d, dv, int(causal), int(window),
                                _DTYPES[q.dtype], stream,
                                None if part is None else part.data_ptr(), shares, s_pad)
        elif kind == "pad":   # the bucket's kernels, TMA layouts at the real dims
            err = _bwd_pad_fn()(*ptrs, b, s, sk, h, kvh, d, dv, *r.dims, int(causal),
                                int(window), stream, layout,
                                None if part is None else part.data_ptr(), shares, s_pad,
                                scale_dk)
        elif kind == "f16":   # the same in fp16
            err = _bwd_f16_fn()(*ptrs, b, s, sk, h, kvh, d, dv, *r.dims, int(causal),
                                int(window), _DTYPES[q.dtype], stream, layout,
                                None if part is None else part.data_ptr(), shares, s_pad,
                                scale_dk)
        else:
            err = _bwd_fn()(*ptrs, b, s, sk, h, kvh, d, dv, int(causal), int(window),
                            _DTYPES[q.dtype], stream, layout,
                            None if part is None else part.data_ptr(), shares, s_pad)
        if not err and r.kind == "stage":   # the gradients back at the real head dims
            dq, dk, dv_ = _restage((dq, dk, dv_), real, stream)
    if err < 0:
        raise RuntimeError(f"flash_attention_bwd: TMA tensor map not encoded (code {err})")
    if err:
        raise RuntimeError(f"flash_attention_bwd: kernel launch failed with CUDA error {err}")
    return dq, dk, dv_
