"""Public wrappers around the port's kernels.

``flash_attention`` takes model-layout tensors (B, S, H, D) with GQA
(kv heads ≤ q heads); ``ssd_scan`` takes the SSD scan's inputs with any
number of B/C groups that divides the heads, and an optional initial
state.  On a CUDA tensor each launches its Hopper kernel
(``kernels/csrc/``) or raises; on a CPU tensor it runs the kernel's
plain version (``kernels.ref``).  Neither falls back from the kernel to
the plain version.

Attention differentiates through :class:`FlashAttention`: its forward
launches the flash kernel (in fp32 ``csrc/flash_attention_fwd_f32.cu``)
with each row's logsumexp, its backward the gradient's kernels
(``csrc/flash_attention_bwd.cu``; in fp32
``csrc/flash_attention_bwd_f32.cu``); on the CPU the plain forward and
``flash_attention_bwd_ref``.  ``flash_attention`` takes that path only
when autograd needs it (grad enabled and an input requiring grad);
prefill and decode make the direct call.  The SSD scan
differentiates alike through :class:`SsdScan`: its backward launches
``csrc/ssd_scan_bwd.cu``; on the CPU the plain ``ssd_ref`` and
``ssd_bwd_ref``.

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
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda, flash_attention_cuda,
                                                 ws_route)
from repro_torch.kernels.flash_attention import bwd_route as flash_bwd_route
from repro_torch.kernels.flash_attention import route as flash_route
from repro_torch.kernels.ref import (
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
    ssd_bwd_ref,
    ssd_ref,
)
from repro_torch.kernels.ssd_scan import kernel_chunk, ssd_scan_bwd_cuda, ssd_scan_cuda
from repro_torch.kernels.ssd_scan import route as ssd_route

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


def _count_route(fn, prefix: str, kind: str) -> None:
    """One launch on the padded, the fp16 wgmma, the staged (flash), the
    general (SSD) or the fp32 route, by the route's kind."""
    if kind in ("pad", "f16", "stage", "any", "f32"):
        name = f"{prefix}{kind}_launches"
        setattr(fn, name, getattr(fn, name) + 1)


def _count_forward(q: torch.Tensor, v: torch.Tensor) -> None:
    """One forward launch; one more of the MLA kernel where it took it, and
    of the padded, the fp16 wgmma, the staged or the fp32 route where it
    took one."""
    flash_attention.launches += 1
    if ws_route(q.dtype, q.shape[3], v.shape[3]):
        flash_attention.ws_launches += 1
    _count_route(flash_attention, "", flash_route(q.dtype, q.shape[3], v.shape[3]).kind)


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
            _count_forward(q, v)
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
            _count_route(flash_attention, "bwd_",
                         flash_bwd_route(q.dtype, q.shape[3], v.shape[3]).kind)
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
    forward kernel launches, ``flash_attention.ws_launches`` those of them
    that took the MLA kernel (``flash_fwd_bf16_ws``, bf16 or fp16), and
    ``flash_attention.bwd_launches`` backward ones (CUDA only);
    ``pad_launches`` / ``bwd_pad_launches``, ``f16_launches`` /
    ``bwd_f16_launches`` and ``stage_launches`` / ``bwd_stage_launches``
    those that took the padded bf16, the fp16 wgmma and the staged route
    (``kernels.flash_attention.route``), ``f32_launches`` /
    ``bwd_f32_launches`` the forward and backward launches on the fp32
    register-tiled kernels (route kind "f32")."""
    if _is_dtensor(q):
        return _flash_on_mesh(q, k, v, causal, window, kv_tile)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, kv_tile)
    if q.device.type == "cuda":
        if kv_tile is None:
            kv_tile = tuned_flash_tile(q, k, v, causal=causal, window=window)
        out = flash_attention_cuda(q, k, v, causal=causal, window=window, kv_tile=kv_tile)
        _count_forward(q, v)
        if launch_hook is not None:
            launch_hook("flash_attention", q=q, k=k, v=v, causal=causal, window=window)
        return out
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type == "meta":
        return _flash_meta(q, k, v, causal, window)
    raise _no_kernel("flash_attention", q.device)


flash_attention.launches = 0
flash_attention.ws_launches = 0
flash_attention.bwd_launches = 0
flash_attention.pad_launches = flash_attention.bwd_pad_launches = 0
flash_attention.f16_launches = flash_attention.bwd_f16_launches = 0
flash_attention.stage_launches = flash_attention.bwd_stage_launches = 0
flash_attention.f32_launches = flash_attention.bwd_f32_launches = 0


def _ssd_hook(name: str, x, a, b, initial_state, **kw) -> None:
    """Credit a launch to the roofline counter: B/C's group count is in
    ``b``'s shape, an initial state's bytes in ``initial_state``."""
    if launch_hook is not None:
        launch_hook(name, x=x, a=a, b=b, initial_state=initial_state, **kw)


def _ssd_launch(x, dt, a, b, c, chunk: int | None, initial_state=None):
    """The SSD forward on CUDA: the kernel, counted and hooked."""
    if chunk is None:
        chunk = tuned_ssd_chunk(x, dt, a, b, c)
    out = ssd_scan_cuda(x, dt, a, b, c, chunk=chunk, initial_state=initial_state)
    ssd_scan.launches += 1
    _count_route(ssd_scan, "", ssd_route(x.dtype, x.shape[3], b.shape[-1]).kind)
    _ssd_hook("ssd_scan", x, a, b, initial_state,
              chunk=kernel_chunk(chunk, x.dtype, x.shape[3], b.shape[-1]))
    return out


def _ssd_meta(x, a, b, chunk: int | None, initial_state=None):
    _ssd_hook("ssd_scan", x, a, b, initial_state, chunk=kernel_chunk(
        chunk or DEFAULT_SSD_CHUNK, x.dtype, x.shape[3], b.shape[-1]))
    bb, _, h, p = x.shape
    return torch.empty_like(x), x.new_empty((bb, h, p, b.shape[-1]))


class SsdScan(torch.autograd.Function):
    """The SSD scan with its gradient: ``SsdScan.apply(x, dt, a, b, c,
    chunk, initial_state)`` -> (y, final state).  Saves the inputs; the
    backward recomputes the states it needs (``csrc/ssd_scan_bwd.cu``) and
    gives the initial state's gradient where one was passed."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk: int | None = None, initial_state=None):
        if x.device.type == "cuda":
            y, state = _ssd_launch(x, dt, a, b, c, chunk, initial_state)
        elif x.device.type == "meta":
            y, state = _ssd_meta(x, a, b, chunk, initial_state)
        elif x.device.type == "cpu":
            y, state = ssd_ref(x, dt, a, b, c, initial_state)
        else:
            raise _no_kernel("ssd_scan", x.device)
        ctx.save_for_backward(x, dt, a, b, c, initial_state)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, b, c, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        if x.device.type == "cuda":
            grads = ssd_scan_bwd_cuda(x, dt, a, b, c, dy, dstate, s0)
            ssd_scan.bwd_launches += 1
            _count_route(ssd_scan, "bwd_", ssd_route(x.dtype, x.shape[3], b.shape[-1]).kind)
            _ssd_hook("ssd_scan_bwd", x, a, b, s0)
        elif x.device.type == "meta":
            _ssd_hook("ssd_scan_bwd", x, a, b, s0)
            grads = tuple(None if t is None else torch.empty_like(t)
                          for t in (x, dt, a, b, c, s0))
        else:
            grads = ssd_bwd_ref(x, dt, a, b, c, dy, dstate, initial_state=s0)
        *grads, ds0 = grads
        return (*grads, None, ds0)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int | None = None,
             initial_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, N) with G
    dividing H (head h reads group h // (H / G)), or (B, L, N) for G = 1;
    ``initial_state`` (B, H, P, N) or None (zero) -> (y (B, L, H, P),
    final state (B, H, P, N)).  Any L.  ``chunk``: the kernel's chunk
    tile; None asks the autotune cache.

    ``ssd_scan.launches`` counts forward kernel launches and
    ``ssd_scan.bwd_launches`` backward ones (CUDA only); ``pad_launches``
    / ``bwd_pad_launches`` and ``any_launches`` / ``bwd_any_launches``
    those that took the padded and the general route
    (``kernels.ssd_scan.route``)."""
    if _is_dtensor(x):
        return _ssd_on_mesh(x, dt, a, b, c, chunk, initial_state)
    leaves = (x, dt, a, b, c) + (() if initial_state is None else (initial_state,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return SsdScan.apply(x, dt, a, b, c, chunk, initial_state)
    if x.device.type == "cuda":
        return _ssd_launch(x, dt, a, b, c, chunk, initial_state)
    if x.device.type == "cpu":
        return ssd_ref(x, dt, a, b, c, initial_state)
    if x.device.type == "meta":
        return _ssd_meta(x, a, b, chunk, initial_state)
    raise _no_kernel("ssd_scan", x.device)


def _head_offset(mesh, pl: list, h: int) -> int:
    """The first head of this rank's shard of H heads sharded as ``pl``
    (a tensor dim sharded over several mesh dims is cut over them in mesh
    order, the first outermost)."""
    idx, ranks = 0, 1
    for i, p in enumerate(pl):
        if p.is_shard(2):
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
            ranks *= mesh.size(i)
    return idx * (h // ranks)


def _ssd_on_mesh(x, dt, a, b, c, chunk: int | None, initial_state=None):
    """:func:`ssd_scan` on each rank's (batch, heads) shard: x and dt keep
    their batch and heads shardings, a its heads', the initial and final
    states (B, H, P, N) x's batch and heads.  B and C keep their batch's;
    their G groups are sharded with the heads where the heads' ranks
    divide G, else replicated and each rank takes its heads' groups: the
    one group they share, or one per head where they straddle groups."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    pl = _bh_layout(x)
    mesh = x.device_mesh
    h = x.shape[2]
    head_ranks = math.prod(mesh.size(i) for i, p in enumerate(pl) if p.is_shard(2))
    g = b.shape[2] if b.dim() == 4 else 1
    a_pl = [Shard(0) if p.is_shard(2) else Replicate() for p in pl]
    state_pl = [Shard(1) if p.is_shard(2) else p for p in pl]
    pick = None
    if b.dim() == 4 and g % head_ranks == 0:
        bc_pl = pl                                # groups sharded with the heads
    else:
        bc_pl = [p if p.is_shard(0) else Replicate() for p in pl]
        if g > 1:
            hpg, hl = h // g, h // head_ranks

            def pick(t):                          # this rank's heads' groups
                h0 = _head_offset(mesh, pl, h)
                if hpg % hl == 0:
                    return t[:, :, h0 // hpg:h0 // hpg + 1]
                idx = torch.arange(h0, h0 + hl, device=t.device) // hpg
                return t.index_select(2, idx)

    def local(x_, dt_, a_, b_, c_, *s0):
        if pick is not None:
            b_, c_ = pick(b_), pick(c_)
        return ssd_scan(x_, dt_, a_, b_, c_, chunk=chunk, initial_state=s0[0] if s0 else None)

    args = [_to(x, pl), _to(dt, pl), _to(a, a_pl), _to(b, bc_pl), _to(c, bc_pl)]
    in_pl = [pl, pl, a_pl, bc_pl, bc_pl]
    if initial_state is not None:
        args.append(_to(initial_state, state_pl))
        in_pl.append(state_pl)
    return local_map(local, out_placements=(pl, state_pl), in_placements=tuple(in_pl),
                     device_mesh=mesh)(*args)


ssd_scan.launches = 0
ssd_scan.bwd_launches = 0
ssd_scan.pad_launches = ssd_scan.bwd_pad_launches = 0
ssd_scan.any_launches = ssd_scan.bwd_any_launches = 0
