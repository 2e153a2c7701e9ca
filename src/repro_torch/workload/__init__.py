"""Synthetic workloads (copied from the JAX package)."""
from repro_torch.workload.sharegpt import Request, ShareGPTConfig, generate
from repro_torch.workload.tenants import (TenantSpec, TenantWorkloadCfg,
                                          apportion, generate_tenants,
                                          workload_bytes)

__all__ = ["Request", "ShareGPTConfig", "generate", "TenantSpec",
           "TenantWorkloadCfg", "apportion", "generate_tenants",
           "workload_bytes"]
