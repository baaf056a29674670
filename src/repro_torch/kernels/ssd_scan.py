"""Launcher of the Hopper SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

Replaces ``src/repro/kernels/ssd_scan.py`` (``_kernel`` and
``ssd_scan_kernel``).  The Pallas kernel padded L up to a multiple of
the chunk with copies; this kernel reads the model layout in place (x, b
and c through their batch and step strides, so the model's views of its
conv output need no copy) and treats steps past L as dt = 0 identities
itself, so the launcher makes no copy.  The source's header says what bounds the kernel on the H100
and what its design does about it.

The public entry is :func:`repro_torch.kernels.ops.ssd_scan`, which
counts the launches; this module only checks and launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.bfloat16: 1, torch.float32: 0}
HEAD_DIMS = (64,)          # P
STATE_DIMS = (128,)        # N
CHUNKS = (32, 64, 128)     # the kernel's chunk tiles


def _fn():
    fn = build.library("ssd_scan").ssd_scan_fwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 6
                      + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def kernel_chunk(chunk: int) -> int:
    """The kernel's tile for a requested chunk: the smallest of CHUNKS that
    holds it.  Steps past L are exact identities, so a larger tile
    computes the same function (``min(128, L)`` for a short L)."""
    for q in CHUNKS:
        if 0 < chunk <= q:
            return q
    raise ValueError(f"ssd_scan: chunk {chunk} is not in 1..{CHUNKS[-1]}")


def _check(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 3 or c.dim() != 3:
        raise ValueError("ssd_scan: x must be (B, L, H, P), dt (B, L, H), a (H,), "
                         "b and c (B, L, N)")
    bb, l, h, p = x.shape
    n = b.shape[-1]
    if (tuple(dt.shape) != (bb, l, h) or tuple(a.shape) != (h,)
            or tuple(b.shape) != (bb, l, n) or c.shape != b.shape):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"a {tuple(a.shape)} b {tuple(b.shape)} c {tuple(c.shape)} "
                         "do not match")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"ssd_scan: (P, N) = ({p}, {n}); the kernel takes P in "
                         f"{HEAD_DIMS} and N in {STATE_DIMS}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, b, c)):
        raise TypeError(f"ssd_scan: dtypes x {x.dtype} dt {dt.dtype} b {b.dtype} "
                        f"c {c.dtype}; the kernel takes bf16 or fp32, all alike")
    if a.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"ssd_scan: a is {a.dtype}; the kernel takes x's dtype or fp32")
    # x, b and c may be strided views (the model's split of its conv
    # output); their rows must be contiguous.  dt and a are read packed.
    if (x.stride(3) != 1 or (h > 1 and x.stride(2) != p)
            or b.stride(2) != 1 or c.stride(2) != 1):
        raise ValueError("ssd_scan: each (H, P) row of x and each N row of b and c "
                         "must be contiguous")
    if not dt.is_contiguous() or not a.is_contiguous():
        raise ValueError("ssd_scan: dt and a must be contiguous")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, not {x.device}")
    if bb == 0 or l == 0 or h == 0:
        raise ValueError("ssd_scan: empty batch, sequence or heads")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, *, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, N) on one CUDA
    device -> (y (B, L, H, P), final state (B, H, P, N)), both in x's dtype
    and contiguous.  x, b and c are read through their strides."""
    q = kernel_chunk(chunk)
    _check(x, dt, a, b, c)
    bb, l, h, p = x.shape
    n = b.shape[-1]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    state = torch.empty((bb, h, p, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                    y.data_ptr(), state.data_ptr(), bb, l, h, p, n, q, _DTYPES[x.dtype],
                    _DTYPES[a.dtype], x.stride(0), x.stride(1), b.stride(0), b.stride(1),
                    c.stride(0), c.stride(1), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan: kernel launch failed with CUDA error {err}")
    return y, state
