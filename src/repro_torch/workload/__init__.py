"""Synthetic workloads (copied from the JAX package)."""
from repro_torch.workload.sharegpt import Request, ShareGPTConfig, generate

__all__ = ["Request", "ShareGPTConfig", "generate"]
