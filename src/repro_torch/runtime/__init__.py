"""Backend-agnostic serving runtime copied from the JAX package: scheduler,
prefix cache, router, instances, the cluster driver and the SLO
autoscaler."""
import repro_torch.core  # noqa: F401  (initialize the substrate package
# first: repro_torch.core exports Cluster, whose import chain loads runtime
# modules, so entering the runtime package cold must let core finish first)
from repro_torch.runtime.autoscale import AutoscaleCfg, SLOAutoscaler

__all__ = ["AutoscaleCfg", "SLOAutoscaler"]
