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
"""
from __future__ import annotations

import torch

from repro_torch.kernels.autotune import tuned_flash_tile, tuned_ssd_chunk
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
    raise _no_kernel("ssd_scan", x.device)


ssd_scan.launches = 0
