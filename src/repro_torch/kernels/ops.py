"""Public wrappers around the port's kernels.

``flash_attention`` takes model-layout tensors (B, S, H, D) with GQA
(kv heads ≤ q heads).  On a CUDA tensor it launches the Hopper kernel
(``kernels/csrc/flash_attention.cu``) or raises; on a CPU tensor it runs
the kernel's plain version (``kernels.ref``).  It never falls back from
the kernel to the plain version.  No autotune in this slice: the
kernel's tiles are fixed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, KV, D) -> (B, S, H, D).

    ``flash_attention.launches`` counts kernel launches (CUDA only)."""
    if q.device.type == "cuda":
        out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        flash_attention.launches += 1
        return out
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


flash_attention.launches = 0
