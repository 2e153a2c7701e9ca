"""PyTorch/CUDA port of the serving stack in ``repro``.

The JAX package is the reference; this package imports nothing of it and
keeps its own copies of the framework-free layers it needs.  Entry points
run on the card unless the caller passes ``device="cpu"``.
"""
