"""Public wrappers around the port's kernels.

``flash_attention`` takes model-layout tensors (B, S, H, D) with GQA
(kv heads ≤ q heads); ``ssd_scan`` takes the SSD scan's inputs with one
B/C group.  On a CUDA tensor each launches its Hopper kernel
(``kernels/csrc/``) or raises; on a CPU tensor it runs the kernel's
plain version (``kernels.ref``).  Neither falls back from the kernel to
the plain version.

Attention differentiates through :class:`FlashAttention`: its forward
launches the flash kernel with each row's logsumexp, its backward the
gradient's kernels (``csrc/flash_attention_bwd.cu``); on the CPU the
plain forward and ``flash_attention_bwd_ref``.  ``flash_attention``
takes that path only when autograd needs it (grad enabled and an input
requiring grad); prefill and decode make the direct call.  The SSD
scan has no backward yet.

Tiles: on CUDA, a call that names no tile asks the autotune cache
(``kernels.autotune``) for this device and shape; a miss keeps the
default tile.  The model's SSD call passes its config's chunk and so
does not consult the cache, as in the reference.

Each launch adds one to its wrapper's count and, while a roofline count
runs (``roofline.cost.counting``), calls :data:`launch_hook` with the
kernel's name and inputs.

Under a mesh (DTensor inputs) each wrapper lays its inputs out over batch
and heads, with sequence and head dim replicated, and runs on each rank's
shard through DTensor's ``local_map``; the shard then takes the route of
its device.  A GQA attention whose kv heads do not divide over the ranks
that shard q's heads takes the MHA layout (kv expanded to q's heads)
first.  On a ``meta`` tensor (the dry-run's abstract evaluation) a
wrapper returns uninitialised outputs of the kernel's shapes, and
gradients of its inputs' shapes in the backward, and calls
:data:`launch_hook` with the shard's shapes, so a count credits the work
the card's kernel would do; it counts no launch.  Any other device raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.autotune import DEFAULT_SSD_CHUNK, tuned_flash_tile, tuned_ssd_chunk
from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
from repro_torch.kernels.ref import (
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
    ssd_ref,
)
from repro_torch.kernels.ssd_scan import kernel_chunk, ssd_scan_cuda

#: ``launch_hook(name, **inputs)`` at each kernel launch while a roofline
#: count runs, else None: one global lookup a launch.  A module global, not
#: a ContextVar: the flash backward launches on autograd's device thread,
#: which does not see the caller's context.
launch_hook = None


def _no_kernel(name: str, device: torch.device) -> ValueError:
    return ValueError(f"{name}: no kernel for device {device}")


def _is_dtensor(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _bh_layout(t: torch.Tensor) -> list:
    """Placements of a (B, S, H, ...) DTensor with only its batch (dim 0)
    and heads (dim 2) shardings kept."""
    from torch.distributed.tensor import Replicate

    return [p if p.is_shard() and p.dim in (0, 2) else Replicate() for p in t.placements]


def _to(t: torch.Tensor, placements: list) -> torch.Tensor:
    return t if list(t.placements) == placements else t.redistribute(t.device_mesh, placements)


def _flash_on_mesh(q, k, v, causal: bool, window: int, kv_tile: int | None):
    from torch.distributed.tensor.experimental import local_map

    pl = _bh_layout(q)
    mesh = q.device_mesh
    head_ranks = math.prod(mesh.size(i) for i, p in enumerate(pl) if p.is_shard(2))
    b, sk, kvh = k.shape[:3]
    if kvh % head_ranks:                          # MHA layout: kv expanded to q's heads
        g = q.shape[2] // kvh
        k, v = (t[:, :, :, None].expand(b, sk, kvh, g, t.shape[3]).reshape(
            b, sk, kvh * g, t.shape[3]) for t in (k, v))

    def local(q_, k_, v_):
        return flash_attention(q_, k_, v_, causal=causal, window=window, kv_tile=kv_tile)

    return local_map(local, out_placements=pl, in_placements=(pl, pl, pl),
                     device_mesh=mesh)(_to(q, pl), _to(k, pl), _to(v, pl))


def _flash_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                window: int) -> torch.Tensor:
    if launch_hook is not None:
        launch_hook("flash_attention", q=q, k=k, v=v, causal=causal, window=window)
    return q.new_empty(q.shape[:3] + v.shape[3:])


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: ``FlashAttention.apply(q, k, v,
    causal, window)``.  Saves q, k, v, o and the rows' logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, kv_tile: int | None = None):
        if q.device.type == "cuda":
            if kv_tile is None:
                kv_tile = tuned_flash_tile(q, k, v, causal=causal, window=window)
            o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                          return_lse=True, kv_tile=kv_tile)
            flash_attention.launches += 1
            if launch_hook is not None:
                launch_hook("flash_attention", q=q, k=k, v=v, causal=causal, window=window)
        elif q.device.type == "meta":
            o = _flash_meta(q, k, v, causal, window)
            b, s, h = q.shape[:3]
            lse = q.new_empty((b, h, s), dtype=torch.float32)
        elif q.device.type == "cpu":
            o = flash_attention_ref(q, k, v, causal=causal, window=window)
            lse = flash_attention_lse_ref(q, k, v, causal=causal, window=window)
        else:
            raise _no_kernel("flash_attention", q.device)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, window=ctx.window)
        if q.device.type == "cuda":
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
            flash_attention.bwd_launches += 1
            if launch_hook is not None:
                launch_hook("flash_attention_bwd", q=q, k=k, v=v, **kw)
        elif q.device.type == "meta":
            if launch_hook is not None:
                launch_hook("flash_attention_bwd", q=q, k=k, v=v, **kw)
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        else:
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_tile: int | None = None) -> torch.Tensor:
    """q: (B, S, H, D); k: (B, Sk, KV, D); v: (B, Sk, KV, Dv) -> (B, S, H, Dv).

    ``kv_tile``: the bf16 kernel's kv tile (``flash_attention.KV_TILES``);
    None asks the autotune cache.  ``flash_attention.launches`` counts
    forward kernel launches and ``flash_attention.bwd_launches`` backward
    ones (CUDA only)."""
    if _is_dtensor(q):
        return _flash_on_mesh(q, k, v, causal, window, kv_tile)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, kv_tile)
    if q.device.type == "cuda":
        if kv_tile is None:
            kv_tile = tuned_flash_tile(q, k, v, causal=causal, window=window)
        out = flash_attention_cuda(q, k, v, causal=causal, window=window, kv_tile=kv_tile)
        flash_attention.launches += 1
        if launch_hook is not None:
            launch_hook("flash_attention", q=q, k=k, v=v, causal=causal, window=window)
        return out
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type == "meta":
        return _flash_meta(q, k, v, causal, window)
    raise _no_kernel("flash_attention", q.device)


flash_attention.launches = 0
flash_attention.bwd_launches = 0


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, N) or
    (B, L, 1, N) -> (y (B, L, H, P), final state (B, H, P, N)).  Any L.
    ``chunk``: the kernel's chunk tile; None asks the autotune cache.

    ``ssd_scan.launches`` counts kernel launches (CUDA only)."""
    if b.dim() == 4:                        # (B, L, G, N) with G == 1
        if b.shape[2] != 1 or c.shape[2] != 1:
            raise ValueError(f"ssd_scan: {b.shape[2]} B/C groups; the kernel takes one")
        b, c = b[:, :, 0], c[:, :, 0]
    if _is_dtensor(x):
        return _ssd_on_mesh(x, dt, a, b, c, chunk)
    if x.device.type == "cuda":
        if chunk is None:
            chunk = tuned_ssd_chunk(x, dt, a, b, c)
        out = ssd_scan_cuda(x, dt, a, b, c, chunk=chunk)
        ssd_scan.launches += 1
        if launch_hook is not None:
            launch_hook("ssd_scan", x=x, a=a, b=b, chunk=kernel_chunk(chunk, x.dtype))
        return out
    if x.device.type == "cpu":
        return ssd_ref(x, dt, a, b, c)
    if x.device.type == "meta":
        if launch_hook is not None:
            launch_hook("ssd_scan", x=x, a=a, b=b,
                        chunk=kernel_chunk(chunk or DEFAULT_SSD_CHUNK, x.dtype))
        bb, _, h, p = x.shape
        return torch.empty_like(x), x.new_empty((bb, h, p, b.shape[-1]))
    raise _no_kernel("ssd_scan", x.device)


def _ssd_on_mesh(x, dt, a, b, c, chunk: int | None):
    """:func:`ssd_scan` on each rank's (batch, heads) shard: x and dt keep
    their batch and heads shardings, a its heads', b and c their batch's;
    the state (B, H, P, N) comes out sharded as x's batch and heads."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    pl = _bh_layout(x)
    a_pl = [Shard(0) if p.is_shard(2) else Replicate() for p in pl]
    bc_pl = [p if p.is_shard(0) else Replicate() for p in pl]
    state_pl = [Shard(1) if p.is_shard(2) else p for p in pl]

    def local(x_, dt_, a_, b_, c_):
        return ssd_scan(x_, dt_, a_, b_, c_, chunk=chunk)

    return local_map(local, out_placements=(pl, state_pl),
                     in_placements=(pl, pl, a_pl, bc_pl, bc_pl), device_mesh=x.device_mesh)(
        _to(x, pl), _to(dt, pl), _to(a, a_pl), _to(b, bc_pl), _to(c, bc_pl))


ssd_scan.launches = 0
