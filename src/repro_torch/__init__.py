"""PyTorch/CUDA port of the WRATH reproduction (the JAX package ``repro``
is the reference it is held against).

The port imports ``torch``, numpy and the standard library, never
``jax`` nor anything under ``repro``: what it needs of the JAX package's
framework-free modules it keeps as its own copies.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
