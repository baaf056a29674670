"""Hand-written Hopper kernels for the port's compute hot spots.

``ops.flash_attention`` (``csrc/flash_attention.cu``) replaces the
Pallas TPU kernel ``repro.kernels.flash_attention``; each kernel keeps
its plain PyTorch version in ``ref.py``.  The Mamba-2 SSD scan kernel is
still to be ported (ROADMAP.md, 'Next slices' item 3).
"""
