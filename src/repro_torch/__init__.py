"""STRETCH's VSN stream pipeline in PyTorch, with hand-written CUDA kernels.

The port of the JAX package ``repro`` (held against it file for file: each
module's docstring names its reference).  It imports ``torch`` and never
``jax`` or ``repro``.  Entry points run on the CUDA device unless the caller
passes ``device="cpu"``; there the kernels' plain PyTorch versions run.
"""
