"""Named acceptance traces: how cluster configs reference an artifact.

``SpecCfg.acceptance_trace`` names a trace; both backends resolve that
name here at instance-build time (``resolve_acceptance``), exactly like
``MoECfg.routing_trace`` resolves through ``repro_torch.moe`` and
``InstanceCfg.hw_name`` through ``repro_torch.hw``.  Registering once
(``register_acceptance``/``load_acceptance``) makes the artifact
available to every cluster config in the process.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

from repro_torch.spec.trace import READABLE_SCHEMAS, AcceptanceTrace


class AcceptanceRegistry:
    """Name -> ``AcceptanceTrace`` (no synthetic fallback: acceptance
    dynamics are an explicit experiment input, never guessed silently)."""

    def __init__(self):
        self._traces: Dict[str, AcceptanceTrace] = {}

    def register(self, name: str,
                 trace: AcceptanceTrace) -> AcceptanceTrace:
        trace.validate()
        self._traces[name] = trace
        return trace

    def names(self) -> List[str]:
        return sorted(self._traces)

    def get(self, name: str) -> AcceptanceTrace:
        if name not in self._traces:
            raise KeyError(
                f"no acceptance trace registered as {name!r}; loaded: "
                f"{self.names() or '(none)'} — record one with `python -m "
                f"repro_torch.profiler record-acceptance --arch <arch>` or "
                f"synthesize one with repro_torch.workload.acceptance")
        return self._traces[name]

    def load_file(self, path: str,
                  name: Optional[str] = None) -> AcceptanceTrace:
        trace = AcceptanceTrace.load(path)
        key = name or os.path.splitext(os.path.basename(path))[0]
        return self.register(key, trace)

    def load_dir(self, path: str) -> List[str]:
        """Load every acceptance artifact in ``path`` (registered under
        the file stem).  JSON files with a foreign or missing ``schema``
        key (e.g. ``hwtrace``/``moetrace`` artifacts sharing ``traces/``)
        are skipped."""
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
            if not schema.startswith("spectrace/"):
                continue
            if schema not in READABLE_SCHEMAS:
                warnings.warn(
                    f"{fp}: unreadable acceptance schema {schema!r} — "
                    f"skipped")
                continue
            name = os.path.splitext(fn)[0]
            names.append(name)
            self.load_file(fp, name=name)
        return names


#: Process-wide default registry (``SpecCfg.acceptance_trace`` resolves
#: here when no explicit registry is passed).
default_acceptance_registry = AcceptanceRegistry()


def register_acceptance(name: str,
                        trace: AcceptanceTrace) -> AcceptanceTrace:
    return default_acceptance_registry.register(name, trace)


def get_acceptance(name: str) -> AcceptanceTrace:
    return default_acceptance_registry.get(name)


def load_acceptance(path: str, name: Optional[str] = None):
    """Load an acceptance-trace file or directory into the default
    registry."""
    if os.path.isdir(path):
        return default_acceptance_registry.load_dir(path)
    return default_acceptance_registry.load_file(path, name=name)


def resolve_acceptance(icfg, registry: Optional[AcceptanceRegistry] = None
                       ) -> Optional[AcceptanceTrace]:
    """The trace named by ``icfg.spec.acceptance_trace`` (None when
    unset), checked structurally compatible with the configured draft
    length."""
    spec = getattr(icfg, "spec", None)
    name = getattr(spec, "acceptance_trace", None)
    if not name:
        return None
    reg = registry or default_acceptance_registry
    return reg.get(name).check_k(spec.k)
