"""Launcher of the Hopper SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

Replaces ``src/repro/kernels/ssd_scan.py`` (``_kernel`` and
``ssd_scan_kernel``).  The Pallas kernel padded L up to a multiple of
the chunk with copies; this kernel reads the model layout in place (x, b
and c through their batch and step strides, so the model's views of its
conv output need no copy) and treats steps past L as dt = 0 identities
itself, so the launcher makes no copy.  The bf16 kernel loads x, b and c
and stores y by TMA: this module computes the tensor maps' layouts
(:func:`tma_layouts`) and the C side encodes them.  The source's header
says what bounds the kernel on the H100 and what its design does about
it.

(P, N) is mamba2's (64, 128), bf16 on the wgmma kernel and fp32 on the
SIMT one, or the smoke config's (16, 16), the SIMT kernel in either dtype.
Every other (P, N) up to (128, 256) and fp16 take one of two more routes
(:func:`route`): bf16 with P and N multiples of 8 up to (64, 128) takes
the wgmma kernels built for (64, 128) with tensor maps at the real dims
(``csrc/ssd_scan_pad.cu``, ``csrc/ssd_scan_bwd_pad.cu``), everything else
the general SIMT kernels (``csrc/ssd_scan_any.cu``).  The route follows
from dtype and shape alone.  b and c are
(B, L, G, N) with G dividing H (head h reads group h // (H / G)), or (B,
L, N) for G = 1; an optional initial state (B, H, P, N) in x's dtype or
fp32 starts the scan.  A call with G > 1 or an initial state runs the
kernels' ``X`` instantiations, which read both; G = 1 with no state runs
instantiations that read neither, their code and ptxas lines those of
kernels without either (the ``X`` backward run at G = 1 takes ~1.3% more
device time on an H100, ``tools/flash_ab.py``).

:func:`ssd_scan_bwd_cuda` launches the gradient's kernels
(``csrc/ssd_scan_bwd.cu``) at the same shapes: for bf16 at (64, 128) the
three tensor-core kernels (chunk-parallel; dB and dC come per block of
:func:`bwd_head_block` heads, which never straddles a B/C group,
:func:`bwd_scratch` gives their scratch), else the SIMT kernel (per-head
shares); it sums the shares of da, db and dc over each group, and returns
the initial state's gradient where one was given.

The public entry is :func:`repro_torch.kernels.ops.ssd_scan` (with
:class:`repro_torch.kernels.ops.SsdScan` for autograd), which counts the
launches; this module only checks and launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import TmaLayout, tma_layout

_DTYPES = {torch.bfloat16: 1, torch.float32: 0, torch.float16: 2}
# the largest P and N any route takes
MAX_P, MAX_N = 128, 256
# the (P, N) pairs with instantiations of their own: mamba2-780m's, and
# its smoke config's on the SIMT kernel in either dtype (16-column rows are
# not whole TMA boxes); the wgmma kernels' (P, N), which a padded call runs on
SIMT_SHAPES = frozenset({(16, 16)})
SHAPES = frozenset({(64, 128)}) | SIMT_SHAPES
BUCKET = (64, 128)
# the kernels' chunk tiles: the bf16 wgmma kernel's warpgroups take 64 rows
# each; the SIMT kernel (fp32, and the smoke shape in bf16) takes 32 too;
# the general kernels (ANY_CHUNK) 32 alone
CHUNKS = {torch.bfloat16: (64, 128), torch.float32: (32, 64, 128)}
ANY_CHUNK = 32
# the backward kernel's own tile by (P, N): the function does not depend on
# the chunk (csrc/ssd_scan_bwd.cu says why it is 64 at mamba2's shape)
BWD_TILES = {(64, 128): 64, (16, 16): 32}
# heads a block of the tensor-core backward takes (one B/C tile, their dB
# and dC summed in registers), at most: see bwd_head_block
BWD_HEAD_GROUP = 12
Y_ROWS = 64                # rows of y one warpgroup stores by TMA


class Route(NamedTuple):
    """How a call runs: ``kind`` "tma" (bf16 at (64, 128)), "pad" (bf16 at
    P and N multiples of 8 up to (64, 128), on its kernels), "simt" (fp32
    at (64, 128), and (16, 16) in bf16 and fp32) or "any" (the general SIMT
    kernels); ``dims`` the instantiation's (P, N): BUCKET on "tma" and
    "pad", the real (P, N) otherwise."""
    kind: str
    dims: tuple[int, int]


@functools.lru_cache(maxsize=None)
def route(dtype: torch.dtype, p: int, n: int) -> Route:
    """The route of a call, by dtype and (P, N) alone (cached)."""
    if dtype == torch.bfloat16 and (p, n) == BUCKET:
        return Route("tma", BUCKET)
    if ((p, n) in SIMT_SHAPES and dtype in (torch.bfloat16, torch.float32)
            or dtype == torch.float32 and (p, n) == BUCKET):
        return Route("simt", (p, n))
    if (dtype == torch.bfloat16 and p % 8 == 0 and n % 8 == 0 and p <= BUCKET[0]
            and n <= BUCKET[1]):
        return Route("pad", BUCKET)
    return Route("any", (p, n))


class SsdTma(NamedTuple):
    """The bf16 kernel's tensor maps: ``offsets``, the bytes from the
    start of each tensor's storage to its first element (x, b, c), and
    ``layouts``, x as (B, L, H, P) and b and c as (B, L, G, N)."""
    offsets: tuple[int, int, int]
    layouts: tuple[TmaLayout, TmaLayout, TmaLayout]

    def flat(self) -> tuple[int, ...]:
        return sum((lay.flat() for lay in self.layouts), ())


def groups(b: torch.Tensor) -> int:
    """B/C's group count: b is (B, L, G, N), or (B, L, N) for one group."""
    return b.shape[2] if b.dim() == 4 else 1


def tma_layouts(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, rows: int) -> SsdTma:
    """The TMA layouts of x (B, L, H, P), b and c (B, L, G, N) or (B, L,
    N) with boxes of ``rows`` steps, read in place through their strides
    (the model passes views of one conv output).  A group's N row is
    contiguous and the groups of a step lie N apart (one 256-byte TMA box
    each at N 128, bf16).  Raises ValueError where TMA cannot address a
    tensor: a start or a byte stride that is not a multiple of 16, or a
    row that is not contiguous."""
    offsets = []
    for name, t in (("x", x), ("b", b), ("c", c)):
        off = t.storage_offset() * t.element_size()
        if off % 16:
            raise ValueError(f"ssd_scan: {name} starts {off} bytes into its storage; TMA "
                             "needs a multiple of 16")
        offsets.append(off)
    es = x.element_size()
    bb, l, _, _ = x.shape
    n = b.shape[-1]
    lays = [tma_layout(tuple(x.shape), x.stride(), es, rows)]
    for t in (b, c):
        lays.append(tma_layout((bb, l, groups(t), n), (t.stride(0), t.stride(1), n, t.stride(-1)),
                               es, rows))
    return SsdTma(tuple(offsets), tuple(lays))


def _fn():
    fn = build.library("ssd_scan").ssd_scan_fwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 6
                      + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)
        fn.restype = ctypes.c_int
    return fn


def tma_route(dtype: torch.dtype, p: int = 64, n: int = 128) -> bool:
    """Whether a call takes the wgmma + TMA kernels (bf16 at mamba2's (P,
    N), or padded inside it) rather than SIMT ones: by dtype and shape
    alone."""
    return route(dtype, p, n).kind in ("tma", "pad")


def chunk_tiles(dtype: torch.dtype, p: int = 64, n: int = 128) -> tuple[int, ...]:
    """The chunk tiles the kernel of ``dtype`` and (P, N) is built for."""
    kind = route(dtype, p, n).kind
    if kind == "any":
        return (ANY_CHUNK,)
    return CHUNKS[torch.bfloat16] if kind in ("tma", "pad") else CHUNKS[torch.float32]


def bwd_tile(dtype: torch.dtype, p: int, n: int) -> int:
    """The backward kernels' chunk at ``dtype`` and (P, N): BWD_TILES by the
    route's dims, ANY_CHUNK on the general kernels."""
    r = route(dtype, p, n)
    return ANY_CHUNK if r.kind == "any" else BWD_TILES[r.dims]


def kernel_chunk(chunk: int, dtype: torch.dtype = torch.bfloat16, p: int = 64,
                 n: int = 128) -> int:
    """The tile of the kernel ``dtype`` and (P, N) take for a requested
    chunk: the smallest of its CHUNKS that holds it, and the largest for a
    chunk above them all (256, Mamba2Config's default).  The function does
    not depend on the chunk: steps past L are exact identities and the
    state carries across tiles, so any tile computes it (``min(128, L)``
    for a short L)."""
    tiles = chunk_tiles(dtype, p, n)
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk {chunk} is not a positive step count")
    return next((q for q in tiles if chunk <= q), tiles[-1])


_LAYOUTS: dict[tuple, ctypes.Array] = {}


def _layout_array(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, q: int) -> ctypes.Array:
    """The 44 layout values the bf16 kernel takes (x, b and c, then the
    contiguous y of x's shape), as a C array.  Cached by shape (the group
    count among it), strides and storage offsets (at most 256 entries):
    building the layouts takes tens of microseconds of host time, next to
    a kernel of ~0.1 ms."""
    key = (tuple(x.shape), x.stride(), tuple(b.shape), b.stride(), c.stride(),
           x.storage_offset(), b.storage_offset(), c.storage_offset(), q)
    arr = _LAYOUTS.get(key)
    if arr is None:
        bb, l, h, p = x.shape
        flat = (tma_layouts(x, b, c, q).flat()
                + tma_layout((bb, l, h, p), (l * h * p, h * p, p, 1), 2, Y_ROWS).flat())
        if len(_LAYOUTS) >= 256:
            _LAYOUTS.clear()
        arr = _LAYOUTS[key] = (ctypes.c_longlong * len(flat))(*flat)
    return arr


def _check(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, initial_state: torch.Tensor | None = None) -> None:
    """Raise on what the kernels do not take."""
    if (x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() not in (3, 4)
            or c.dim() != b.dim()):
        raise ValueError("ssd_scan: x must be (B, L, H, P), dt (B, L, H), a (H,), "
                         "b and c (B, L, G, N) or (B, L, N)")
    bb, l, h, p = x.shape
    g, n = groups(b), b.shape[-1]
    if (tuple(dt.shape) != (bb, l, h) or tuple(a.shape) != (h,)
            or tuple(b.shape[:2]) != (bb, l) or c.shape != b.shape):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"a {tuple(a.shape)} b {tuple(b.shape)} c {tuple(c.shape)} "
                         "do not match")
    if g == 0 or h % g:
        raise ValueError(f"ssd_scan: {g} B/C groups do not divide {h} heads")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N):
        raise ValueError(f"ssd_scan: (P, N) = ({p}, {n}) past the limit: the kernels take "
                         f"P <= {MAX_P} and N <= {MAX_N}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, b, c)):
        raise TypeError(f"ssd_scan: dtypes x {x.dtype} dt {dt.dtype} b {b.dtype} "
                        f"c {c.dtype}; the kernels take bf16, fp16 or fp32, all alike")
    if a.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"ssd_scan: a is {a.dtype}; the kernel takes x's dtype or fp32")
    # x, b and c may be strided views (the model's split of its conv
    # output); their rows must be contiguous.  dt and a are read packed.
    if (x.stride(3) != 1 or (h > 1 and x.stride(2) != p)
            or b.stride(-1) != 1 or c.stride(-1) != 1):
        raise ValueError("ssd_scan: each (H, P) row of x and each N row of b and c "
                         "must be contiguous")
    if g > 1 and (b.stride(2) != n or c.stride(2) != n):
        raise ValueError("ssd_scan: each step's (G, N) row of b and c must be contiguous")
    if not dt.is_contiguous() or not a.is_contiguous():
        raise ValueError("ssd_scan: dt and a must be contiguous")
    named = (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c))
    if initial_state is not None:
        named += (("initial_state", initial_state),)
        if (tuple(initial_state.shape) != (bb, h, p, n)
                or initial_state.dtype not in (x.dtype, torch.float32)
                or not initial_state.is_contiguous()):
            raise ValueError(f"ssd_scan: initial_state is {tuple(initial_state.shape)} "
                             f"{initial_state.dtype}; the kernel takes a contiguous "
                             f"({bb}, {h}, {p}, {n}) in x's dtype or fp32")
    for name, t in named:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, not {x.device}")
    if bb == 0 or l == 0 or h == 0:
        raise ValueError("ssd_scan: empty batch, sequence or heads")


def _state_args(initial_state: torch.Tensor | None) -> tuple:
    """The initial state's pointer (None: zero) and whether it is fp32."""
    if initial_state is None:
        return None, 0
    return initial_state.data_ptr(), int(initial_state.dtype == torch.float32)


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, *, chunk: int,
                  initial_state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, N) or (B,
    L, N); ``initial_state`` (B, H, P, N) in x's dtype or fp32, or None
    (zero), on one CUDA device -> (y (B, L, H, P), final state (B, H, P,
    N)), both in x's dtype and contiguous.  x, b and c are read through
    their strides."""
    q = kernel_chunk(chunk, x.dtype, x.shape[-1], b.shape[-1])
    _check(x, dt, a, b, c, initial_state)
    bb, l, h, p = x.shape
    g, n = groups(b), b.shape[-1]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    state = torch.empty((bb, h, p, n), dtype=x.dtype, device=x.device)
    r = route(x.dtype, p, n)
    layout = None
    if r.kind in ("tma", "pad"):
        if any(t.data_ptr() % 16 for t in (x, b, c)):
            raise ValueError("ssd_scan: x, b and c must start 16-byte aligned for TMA")
        layout = _layout_array(x, b, c, q)
    ptrs = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), state.data_ptr())
    strides = (x.stride(0), x.stride(1), b.stride(0), b.stride(1), c.stride(0), c.stride(1))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if r.kind == "any":
            err = _any_fn()(*ptrs, bb, l, h, p, n, _DTYPES[x.dtype],
                            int(a.dtype == torch.float32), *strides, stream,
                            *_state_args(initial_state), g)
        elif r.kind == "pad":   # mamba2's kernel, TMA layouts at the real (P, N)
            err = _pad_fn()(*ptrs, bb, l, h, p, n, q, int(a.dtype == torch.bfloat16), stream,
                            layout, *_state_args(initial_state), g)
        else:
            err = _fn()(*ptrs, bb, l, h, p, n, q, _DTYPES[x.dtype], _DTYPES[a.dtype], *strides,
                        stream, layout, *_state_args(initial_state), g)
    if err < 0:
        raise RuntimeError(f"ssd_scan: TMA tensor map not encoded (code {err})")
    if err:
        raise RuntimeError(f"ssd_scan: kernel launch failed with CUDA error {err}")
    return y, state


def _pad_fn():
    fn = build.library("ssd_scan_pad").ssd_scan_fwd_pad
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 2)
        fn.restype = ctypes.c_int
    return fn


def _any_fn():
    fn = build.library("ssd_scan_any").ssd_scan_fwd_any
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2)
        fn.restype = ctypes.c_int
    return fn


def _bwd_pad_fn():
    fn = build.library("ssd_scan_bwd_pad").ssd_scan_bwd_pad
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 4)
        fn.restype = ctypes.c_int
    return fn


def _bwd_any_fn():
    fn = build.library("ssd_scan_any").ssd_scan_bwd_any
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = build.library("ssd_scan_bwd").ssd_scan_bwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 6
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)
        fn.restype = ctypes.c_int
    return fn


def _bwd_tc_fn():
    fn = build.library("ssd_scan_bwd").ssd_scan_bwd_tc
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 2)
        fn.restype = ctypes.c_int
    return fn


def bwd_head_block(h: int, g: int = 1) -> int:
    """Heads a block of the tensor-core backward takes: ``BWD_HEAD_GROUP``,
    or a B/C group's H / G heads where those are fewer.  Each group's heads
    are cut into blocks of this many, the group's last block short where
    it does not divide them, so that no block straddles two groups (a block
    shares one C B^T tile among its heads): 12 at G 1 on mamba2's 48 heads,
    6 at G 8."""
    return min(BWD_HEAD_GROUP, h // g)


def bwd_scratch(b: int, l: int, h: int, head_group: int, g: int = 1
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """The tensor-core backward's scratch and shares at mamba2's (64, 128),
    (shape, dtype) by name: each (b h, chunk)'s per-step vectors (the
    cumsum as a float pair, dt), the states entering and the gradients
    leaving each chunk (S, then dS: bf16 hi and lo parts, 32 KB a (b h,
    chunk) each), da per (b, chunk, h), and dB and dC per block of
    ``head_group`` heads, group by group: (B, L, G blocks a group, N)."""
    p, n = 64, 128
    q = BWD_TILES[(p, n)]
    nc, ng = -(-l // q), g * -(-(h // g) // head_group)
    f32 = torch.float32
    return {"vec": ((b * h, nc, 3, q), f32), "states": ((2, b * h, nc, 2, p, n), torch.bfloat16),
            "da_part": ((b, nc, h), f32), "db_part": ((b, l, ng, n), f32),
            "dc_part": ((b, l, ng, n), f32)}


def _group_sum(part: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B, L, G k, N) fp32 shares, k a group, summed in order over each
    group's k into ``like``'s shape and dtype: (B, L, G, N) or (B, L, N)."""
    if like.dim() == 3:
        return part.sum(2).to(like.dtype)
    bb, l, k, n = part.shape
    g = like.shape[2]
    return part.view(bb, l, g, k // g, n).sum(3).to(like.dtype)


def ssd_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, dy: torch.Tensor, dstate: torch.Tensor | None = None,
                      initial_state: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor | None, ...]:
    """The gradient of :func:`ssd_scan_cuda` on its inputs: dy (B, L, H, P)
    the gradient of y, ``dstate`` (B, H, P, N) that of the final state
    (None: zero), ``initial_state`` the forward's (None: zero) -> (dx, ddt,
    da, db, dc, d initial_state) in the dtypes of x, dt, a, b, c and the
    initial state, the last None where none was given.  x, b and c are
    read through their strides, as the forward reads them.  The kernels
    write db and dc per block of :func:`bwd_head_block` heads (the
    tensor-core route) or per head (SIMT), and da per (b, chunk, h) or per
    (b, h), in fp32; they are summed here over each B/C group's shares, in
    one ordered sum each."""
    _check(x, dt, a, b, c, initial_state)
    bb, l, h, p = x.shape
    g, n = groups(b), b.shape[-1]
    r = route(x.dtype, p, n)
    tile = bwd_tile(x.dtype, p, n)
    dy = dy.contiguous()
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_scan_bwd: dy is {tuple(dy.shape)} {dy.dtype} on {dy.device}, "
                         f"not like x {tuple(x.shape)} {x.dtype} on {x.device}")
    if dstate is not None:
        dstate = dstate.contiguous()
        if (dstate.shape != (bb, h, p, n) or dstate.dtype != x.dtype
                or dstate.device != x.device):
            raise ValueError(f"ssd_scan_bwd: dstate is {tuple(dstate.shape)} {dstate.dtype} "
                             f"on {dstate.device}, not ({bb}, {h}, {p}, {n}) {x.dtype}")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ddt = torch.empty((bb, l, h), dtype=dt.dtype, device=x.device)
    ds0 = None if initial_state is None else torch.empty((bb, h, p, n), **f32)
    s0_ptr, s0_f32 = _state_args(initial_state)
    # the kernels' last four arguments: s0, its gradient's fp32 buffer, s0's dtype, G
    state_args = (s0_ptr, None if ds0 is None else ds0.data_ptr(), s0_f32, g)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if r.kind in ("tma", "pad"):
        hg = bwd_head_block(h, g)
        if any(t.data_ptr() % 16 for t in (x, b, c, dy)):
            raise ValueError("ssd_scan_bwd: x, b, c and dy must start 16-byte aligned for TMA")
        sc = {k: torch.empty(shape, dtype=dtype, device=x.device)
              for k, (shape, dtype) in bwd_scratch(bb, l, h, hg, g).items()}
        # x, b and c with boxes of the tile's rows, then dy as the forward's
        # y: contiguous, x's shape, Y_ROWS rows a box
        layout = _layout_array(x, b, c, tile)
        ptrs = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                dy.data_ptr(), None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
                ddt.data_ptr(), sc["vec"].data_ptr(), sc["states"][0].data_ptr(),
                sc["states"][1].data_ptr(), sc["da_part"].data_ptr(), sc["db_part"].data_ptr(),
                sc["dc_part"].data_ptr())
        with torch.cuda.device(x.device):
            if r.kind == "pad":   # mamba2's kernels, TMA layouts at the real (P, N)
                err = _bwd_pad_fn()(*ptrs, bb, l, h, hg, _DTYPES[a.dtype], layout, stream,
                                    *state_args, p, n)
            else:
                err = _bwd_tc_fn()(*ptrs, bb, l, h, hg, _DTYPES[a.dtype], layout, stream,
                                   *state_args)
        if err < 0:
            raise RuntimeError(f"ssd_scan_bwd: TMA tensor map {('x', 'b', 'c', 'dy')[-err // 10 - 1]}"
                               f" not encoded (code {err % 10 - 10}; layouts {list(layout)})")
        if err:
            raise RuntimeError(f"ssd_scan_bwd: kernel launch failed with CUDA error {err}")
        da_part, db_part, dc_part = sc["da_part"].sum((0, 1)), sc["db_part"], sc["dc_part"]
        if r.kind == "pad":   # the shares are at N 128, zero past the real N
            db_part, dc_part = db_part[..., :n], dc_part[..., :n]
    elif r.kind == "any":
        da_part = torch.empty((bb, h), **f32)
        db_part = torch.empty((bb, l, h, n), **f32)
        dc_part = torch.empty((bb, l, h, n), **f32)
        states = torch.empty((bb * h, -(-l // tile), p, n), **f32)
        dstates = torch.empty((bb * h, p, n), **f32)
        with torch.cuda.device(x.device):
            err = _bwd_any_fn()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                                c.data_ptr(), dy.data_ptr(),
                                None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
                                ddt.data_ptr(), da_part.data_ptr(), db_part.data_ptr(),
                                dc_part.data_ptr(), states.data_ptr(), dstates.data_ptr(),
                                bb, l, h, p, n, _DTYPES[x.dtype], int(a.dtype == torch.float32),
                                x.stride(0), x.stride(1), b.stride(0), b.stride(1),
                                c.stride(0), c.stride(1), stream, *state_args)
        if err:
            raise RuntimeError(f"ssd_scan_bwd: kernel launch failed with CUDA error {err}")
        da_part = da_part.sum(0)
    else:
        da_part = torch.empty((bb, h), **f32)
        db_part = torch.empty((bb, l, h, n), **f32)
        dc_part = torch.empty((bb, l, h, n), **f32)
        states = torch.empty((bb * h, -(-l // tile), p, n), **f32)
        with torch.cuda.device(x.device):
            err = _bwd_fn()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                            c.data_ptr(), dy.data_ptr(),
                            None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
                            ddt.data_ptr(), da_part.data_ptr(), db_part.data_ptr(),
                            dc_part.data_ptr(), states.data_ptr(), bb, l, h, p, n, tile,
                            _DTYPES[x.dtype], _DTYPES[a.dtype], x.stride(0), x.stride(1),
                            b.stride(0), b.stride(1), c.stride(0), c.stride(1), stream,
                            *state_args)
        if err:
            raise RuntimeError(f"ssd_scan_bwd: kernel launch failed with CUDA error {err}")
        da_part = da_part.sum(0)
    return (dx, ddt, da_part.to(a.dtype), _group_sum(db_part, b), _group_sum(dc_part, c),
            None if ds0 is None else ds0.to(initial_state.dtype))
