"""PyTorch/CUDA port of the push-memory Halide compiler (see README.md).

The JAX package ``repro`` stays the reference; this package imports
``torch`` and nothing of ``repro`` or ``jax``.
"""
