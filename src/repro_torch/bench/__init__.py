"""Benchmarks of the port: twins of the JAX package's ``benchmarks/``
(``fig2_fidelity``: the simulator against the real engine)."""
