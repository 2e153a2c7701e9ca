"""Runtime event schema (copied from the JAX package)."""
