"""Hand-written Hopper kernels for the port's compute hot spots.

``ops.flash_attention`` (``csrc/flash_attention.cu``) replaces the
Pallas TPU kernel ``repro.kernels.flash_attention``, with its gradient
in ``csrc/flash_attention_bwd.cu`` (``ops.FlashAttention``), and
``ops.ssd_scan`` (``csrc/ssd_scan.cu``) replaces
``repro.kernels.ssd_scan``; each kernel keeps its plain PyTorch version
in ``ref.py``.
"""
