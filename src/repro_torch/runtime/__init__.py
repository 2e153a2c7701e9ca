"""Backend-agnostic serving runtime copied from the JAX package: scheduler,
prefix cache, router, instances and the cluster driver."""
