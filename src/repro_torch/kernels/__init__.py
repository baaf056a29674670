"""Hand-written Hopper kernels for the port's compute hot spots.

``ops.flash_attention`` (``csrc/flash_attention.cu``) replaces the
Pallas TPU kernel ``repro.kernels.flash_attention``, with its gradient
in ``csrc/flash_attention_bwd.cu`` (``ops.FlashAttention``), and
``ops.ssd_scan`` (``csrc/ssd_scan.cu``) replaces
``repro.kernels.ssd_scan``; each kernel keeps its plain PyTorch version
in ``ref.py``.

Tiles are autotuned per input shape and persisted per device signature
(``kernels.autotune``); a CUDA call that names no tile gets the cached
winner, or the default tile on a miss.
"""
from repro_torch.kernels.autotune import (
    AutotuneCache,
    autotune_flash_attention,
    autotune_ssd_scan,
    device_signature,
    tuned_flash_tile,
    tuned_ssd_chunk,
)

__all__ = ["AutotuneCache", "autotune_flash_attention", "autotune_ssd_scan",
           "device_signature", "tuned_flash_tile", "tuned_ssd_chunk"]
