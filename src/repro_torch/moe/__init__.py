"""Trace-driven MoE expert routing: one artifact, two engines.

``repro_torch.moe`` owns the portable representation of "which experts did each
token hit" (the MoE analogue of ``repro_torch.hw``'s "how fast is this device"):

* :class:`ExpertRoutingTrace` — versioned JSON artifact: per-MoE-layer
  top-k assignment table over bucketed token positions.  Recorded from
  real ``TorchBackend`` runs or synthesized by the parameterized skew
  generators in ``repro_torch.workload.expert_skew``.
* :class:`ExpertLoadTracker` — the uniform expert-load metrics accounting
  (per-expert counts, imbalance factor, hot-expert timeline) both
  execution backends report through ``metrics()["expert_load"]``.
* :class:`RoutingRegistry` / :func:`resolve_routing` — name resolution for
  ``MoECfg.routing_trace``, mirroring ``InstanceCfg.hw_name``.

Copied from ``repro/moe/``.  The real-engine side lives in
``repro_torch.moe.hooks`` (injectable routing hooks: forced assignment /
logit bias / recording tap) and ``repro_torch.moe.record`` (record a trace
from an engine run); this package imports neither, nor torch.
"""
from repro_torch.moe.registry import (RoutingRegistry, default_routing_registry,
                                get_routing, load_routing, register_routing,
                                resolve_routing)
from repro_torch.moe.trace import (READABLE_SCHEMAS, SCHEMA_VERSION,
                             ExpertLoadTracker, ExpertRoutingTrace,
                             moe_layer_count)

__all__ = [
    "ExpertRoutingTrace", "ExpertLoadTracker", "moe_layer_count",
    "SCHEMA_VERSION", "READABLE_SCHEMAS",
    "RoutingRegistry", "default_routing_registry", "register_routing",
    "get_routing", "load_routing", "resolve_routing",
]
