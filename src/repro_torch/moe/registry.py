"""Named expert-routing traces: how cluster configs reference an artifact.

``MoECfg.routing_trace`` names a trace; both backends resolve that name
here at instance-build time (``resolve_routing``), exactly like
``InstanceCfg.hw_name`` resolves through ``repro_torch.hw``.  Registering once
(``register_routing``/``load_routing``) makes the artifact available to
every cluster config in the process.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

from repro_torch.moe.trace import READABLE_SCHEMAS, ExpertRoutingTrace


class RoutingRegistry:
    """Name -> ``ExpertRoutingTrace`` (no synthetic fallback: skew is an
    explicit experiment input, never something to guess silently)."""

    def __init__(self):
        self._traces: Dict[str, ExpertRoutingTrace] = {}

    def register(self, name: str,
                 trace: ExpertRoutingTrace) -> ExpertRoutingTrace:
        trace.validate()
        self._traces[name] = trace
        return trace

    def names(self) -> List[str]:
        return sorted(self._traces)

    def get(self, name: str) -> ExpertRoutingTrace:
        if name not in self._traces:
            raise KeyError(
                f"no expert-routing trace registered as {name!r}; loaded: "
                f"{self.names() or '(none)'} — record one with "
                f"repro_torch.moe.record.record_routing (the JAX package's "
                f"`profiler record-routing`) or synthesize one with "
                f"repro_torch.workload.expert_skew")
        return self._traces[name]

    def load_file(self, path: str,
                  name: Optional[str] = None) -> ExpertRoutingTrace:
        trace = ExpertRoutingTrace.load(path)
        key = name or os.path.splitext(os.path.basename(path))[0]
        return self.register(key, trace)

    def load_dir(self, path: str) -> List[str]:
        """Load every routing artifact in ``path`` (registered under the
        file stem).  JSON files with a foreign or missing ``schema`` key
        (e.g. ``hwtrace`` artifacts sharing ``traces/``) are skipped."""
        import json
        import warnings
        names = []
        for fn in sorted(os.listdir(path)):
            if not fn.endswith(".json"):
                continue
            fp = os.path.join(path, fn)
            with open(fp) as f:
                try:
                    doc = json.load(f)
                except ValueError:
                    continue
            schema = doc.get("schema", "") if isinstance(doc, dict) else ""
            if not schema.startswith("moetrace/"):
                continue
            if schema not in READABLE_SCHEMAS:
                warnings.warn(
                    f"{fp}: unreadable routing schema {schema!r} — skipped")
                continue
            name = os.path.splitext(fn)[0]
            names.append(name)
            self.load_file(fp, name=name)
        return names


#: Process-wide default registry (``MoECfg.routing_trace`` resolves here
#: when no explicit registry is passed).
default_routing_registry = RoutingRegistry()


def register_routing(name: str,
                     trace: ExpertRoutingTrace) -> ExpertRoutingTrace:
    return default_routing_registry.register(name, trace)


def get_routing(name: str) -> ExpertRoutingTrace:
    return default_routing_registry.get(name)


def load_routing(path: str, name: Optional[str] = None):
    """Load a routing-trace file or directory into the default registry."""
    if os.path.isdir(path):
        return default_routing_registry.load_dir(path)
    return default_routing_registry.load_file(path, name=name)


def resolve_routing(icfg, registry: Optional[RoutingRegistry] = None
                    ) -> Optional[ExpertRoutingTrace]:
    """The trace named by ``icfg.moe.routing_trace`` (None when unset),
    checked structurally compatible with the instance's model."""
    name = getattr(icfg.moe, "routing_trace", None)
    if not name:
        return None
    reg = registry or default_routing_registry
    return reg.get(name).check_model(icfg.model)
