"""Hardware registry: device name -> ``HardwareTrace`` -> ``PerfModel``.

The registry is how a simulated cluster mixes accelerators: every
``InstanceCfg`` may name its hardware (``hw_name="tpu-v6e"``) and the
``ServingRuntime`` resolves that name here at instance-build time.
Resolution order:

1. a registered/loaded measured trace for the device whose ``model``
   matches the instance's model AND that carries a grid at the instance's
   tensor-parallel degree (trace latencies are (model, hardware, tp)
   specific — a table measured for another model or parallelism does not
   transfer);
2. otherwise a synthetic trace generated from the device's
   ``HardwareSpec`` (the spec embedded in a model-mismatched trace, or the
   named spec registry) — the paper's instant analytical integration.

Loaded traces double as spec carriers: when a trace embeds a
``HardwareSpec``, the runtime swaps it into the instance config so the
memory model and off-grid analytical fallback price with the same device
the trace was captured on.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from repro_torch.core.config import ModelSpec
from repro_torch.hw.specs import get_hw, known_hw
from repro_torch.hw.synthetic import synthetic_trace
from repro_torch.hw.trace import HardwareTrace


class HardwareRegistry:
    """Named ``HardwareTrace`` artifacts plus synthetic fallback."""

    def __init__(self):
        self._traces: Dict[str, HardwareTrace] = {}
        # synthetic traces are derived per (device, model, tp) and cached
        self._synth: Dict[Tuple[str, str, int], HardwareTrace] = {}

    # ---- population ----
    def register(self, hwt: HardwareTrace) -> HardwareTrace:
        hwt.validate()
        self._traces[hwt.device] = hwt
        return hwt

    def load_file(self, path: str) -> HardwareTrace:
        return self.register(HardwareTrace.load(path))

    def load_dir(self, path: str) -> List[str]:
        """Load every hardware-trace artifact in ``path``; returns the
        device names registered.  JSON files that are not artifacts at all
        (no ``schema`` key — e.g. raw operator ``Trace`` dumps from the
        ``ops`` subcommand, which share the default ``traces/`` directory)
        are skipped with a warning; a *versioned* artifact this build
        cannot read still raises."""
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
                    warnings.warn(f"{fp}: not JSON — skipped")
                    continue
            if not isinstance(doc, dict) or "schema" not in doc:
                warnings.warn(
                    f"{fp}: not a HardwareTrace artifact (no 'schema' "
                    f"key) — skipped")
                continue
            schema = str(doc["schema"])
            if schema.startswith(("moetrace/", "spectrace/")):
                # expert-routing / acceptance artifacts share traces/ by
                # design (profile --experts/--spec emits them next to the
                # hw trace): silently not ours, exactly as their own
                # registries silently skip hwtrace files
                continue
            if not schema.startswith("hwtrace/"):
                warnings.warn(
                    f"{fp}: not a HardwareTrace artifact (schema "
                    f"{schema!r}) — skipped")
                continue
            names.append(self.load_file(fp).device)
        return names

    # ---- lookup ----
    def names(self) -> List[str]:
        return sorted(self._traces)

    def get(self, device: str) -> HardwareTrace:
        if device not in self._traces:
            raise KeyError(
                f"no hardware trace registered for {device!r}; loaded: "
                f"{self.names() or '(none)'} — profile one with "
                f"`python -m repro_torch.profiler profile --device {device} "
                f"--out traces/{device}.json` or use a known spec name "
                f"({known_hw()})")
        return self._traces[device]

    def resolve(self, device: str, model: ModelSpec,
                tp: int = 1) -> HardwareTrace:
        """The trace that prices ``model`` on ``device`` at tensor-parallel
        degree ``tp`` (see module doc).  A registered trace must match the
        model AND carry a grid profiled at ``tp`` (multi-grid artifacts
        hold one grid per swept degree) — trace latencies embed the
        parallelism they were captured at; anything else gets a synthetic
        grid at the right tp."""
        tp = max(tp, 1)
        hwt = self._traces.get(device)
        if hwt is not None and hwt.model in ("*", model.name):
            view = hwt.at_tp(tp)
            if view is not None:
                return view
        key = (device, model.name, tp)
        if key not in self._synth:
            spec = hwt.spec if (hwt is not None and hwt.spec) else None
            if spec is None:
                try:
                    spec = get_hw(device)
                except KeyError:
                    raise KeyError(
                        f"cannot resolve hardware {device!r} for model "
                        f"{model.name!r}: no matching trace loaded "
                        f"(have {self.names() or '(none)'}) and no spec "
                        f"named {device!r} ({known_hw()})") from None
            self._synth[key] = synthetic_trace(spec, model, tp=tp,
                                               device=device)
        return self._synth[key]


#: Process-wide default registry; ``ServingRuntime`` uses it when no
#: explicit registry is passed, so ``load_traces("traces/")`` once makes
#: every profiled device available to every cluster config by ``hw_name``.
default_registry = HardwareRegistry()


def register_trace(hwt: HardwareTrace) -> HardwareTrace:
    return default_registry.register(hwt)


def load_traces(path: str) -> List[str]:
    """Load a trace file or directory into the default registry."""
    if os.path.isdir(path):
        return default_registry.load_dir(path)
    return [default_registry.load_file(path).device]
