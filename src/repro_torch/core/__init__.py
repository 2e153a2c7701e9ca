"""The simulator's discrete-event substrate, copied from the JAX package
(config, events, requests, memory, metrics, network, traces, expert
accounting, the perf model) and its entry points ``Cluster``/``simulate``.
"""
from repro_torch.core.cluster import Cluster, simulate
from repro_torch.core.config import (CPU_HOST, H100, PIM_DEVICE, RTX3090,
                                     TPU_V5E, TPU_V6E, ClusterCfg,
                                     HardwareSpec, InstanceCfg, MoECfg,
                                     ModelSpec, NetworkCfg, ParallelismCfg,
                                     PrefixCacheCfg, RouterCfg, SchedulerCfg,
                                     SpecCfg, TenantClass)
from repro_torch.core.metrics import aggregate
from repro_torch.core.request import SimRequest
from repro_torch.core.trace import Trace, TraceRegistry

__all__ = [
    "Cluster", "simulate", "ClusterCfg", "HardwareSpec", "InstanceCfg",
    "MoECfg", "ModelSpec", "NetworkCfg", "ParallelismCfg", "PrefixCacheCfg",
    "RouterCfg", "SchedulerCfg", "SpecCfg", "TenantClass", "aggregate",
    "SimRequest", "Trace",
    "TraceRegistry", "RTX3090", "TPU_V5E", "TPU_V6E", "PIM_DEVICE",
    "CPU_HOST", "H100",
]
