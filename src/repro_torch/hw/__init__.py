"""Hardware-trace pipeline: profiler artifacts -> registry -> perf models.

``repro_torch.hw`` owns the portable representation of "how fast is this device"
(see ``docs/adding-hardware.md``):

* :class:`HardwareTrace` — versioned JSON artifact: op -> latency table
  over (tokens, context) buckets, interconnect params, optional device spec.
* :class:`HardwareRegistry` / :data:`default_registry` — device name ->
  trace resolution used by ``ServingRuntime`` for ``InstanceCfg.hw_name``,
  with synthetic (analytical-roofline) fallback for never-measured devices.
* :func:`synthetic_trace` — the analytical model as a trace generator.
* ``specs`` — named ``HardwareSpec`` registry (rtx3090, h100, tpu-v5e/v6e,
  pim, cpu-host, cpu-engine, plus ``register_hw`` for new devices).

A copy of ``repro/hw/`` with the ``h100`` preset added; the artifact
schema is the same, so an artifact written by either package loads in
the other.  The package imports no torch: the pure simulator prices
heterogeneous clusters without importing the real-engine stack.
"""
from repro_torch.hw.registry import (HardwareRegistry, default_registry,
                               load_traces, register_trace)
from repro_torch.hw.specs import get_hw, known_hw, measured_cpu_spec, register_hw
from repro_torch.hw.synthetic import add_synthetic_points, synthetic_trace
from repro_torch.hw.trace import (READABLE_SCHEMAS, SCHEMA_VERSION, HardwareTrace,
                            InterconnectSpec)

__all__ = [
    "HardwareTrace", "InterconnectSpec", "SCHEMA_VERSION",
    "READABLE_SCHEMAS",
    "HardwareRegistry", "default_registry", "register_trace", "load_traces",
    "synthetic_trace", "add_synthetic_points",
    "get_hw", "register_hw", "known_hw", "measured_cpu_spec",
]
