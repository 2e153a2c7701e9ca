"""ArchConfig -> ModelSpec bridge (copied from the JAX package)."""
from repro_torch.profiler.arch_spec import model_spec_from_arch

__all__ = ["model_spec_from_arch"]
