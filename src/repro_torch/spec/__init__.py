"""Trace-driven speculative decoding: one artifact, two engines.

``repro_torch.spec`` owns the portable representation of "how many draft tokens
does the target accept per step" (the spec-decode analogue of
``repro_torch.moe``'s "which experts did each token hit"):

* :class:`AcceptanceTrace` — versioned JSON artifact (``spectrace/1``):
  per-position-bucket acceptance-length distributions with a
  deterministic per-position realization both backends share.  Recorded
  from real draft/target runs (``repro_torch.spec.record``) or synthesized from
  a target acceptance rate (``repro_torch.workload.acceptance``).
* :class:`SpecDecodeTracker` — the uniform spec-decode metrics accounting
  (acceptance rate, mean accepted length, wasted draft tokens, per-step
  timeline) both execution backends report through
  ``metrics()["spec_decode"]``.
* :class:`AcceptanceRegistry` / :func:`resolve_acceptance` — name
  resolution for ``SpecCfg.acceptance_trace``, mirroring
  ``MoECfg.routing_trace``.
* :func:`draft_model_spec` — a scaled-down ``ModelSpec`` for pricing the
  draft model when a sim config does not name one explicitly.

A copy of ``repro/spec/__init__.py``.  The real-engine side lives in
``repro_torch.serve.engine`` (the draft engine + batched verification) and
``repro_torch.runtime.backends.torch_engine`` (the spec-step
orchestration).
"""
from __future__ import annotations

import dataclasses

from repro_torch.spec.record import AcceptanceRecorder, record_acceptance
from repro_torch.spec.registry import (AcceptanceRegistry,
                                 default_acceptance_registry,
                                 get_acceptance, load_acceptance,
                                 register_acceptance, resolve_acceptance)
from repro_torch.spec.trace import (READABLE_SCHEMAS, SCHEMA_VERSION,
                              AcceptanceTrace, SpecDecodeTracker)


def draft_model_spec(model, scale: float = 0.25):
    """A scaled-down ``ModelSpec`` standing in for the draft model in sim
    pricing when ``SpecCfg.draft`` is unset: layer count and widths shrink
    by ``scale`` (weight bytes roughly by ``scale**3``), vocab is shared
    (token ids must line up with the target's)."""
    if not 0 < scale <= 1:
        raise ValueError(f"draft scale must be in (0, 1], got {scale}")

    def dim(n, lo=1):
        return max(int(round(n * scale)), lo)

    return dataclasses.replace(
        model,
        name=f"{model.name}-draft{scale:g}",
        n_layers=dim(model.n_layers),
        d_model=dim(model.d_model, 8),
        d_ff=dim(model.d_ff, 8),
        n_heads=dim(model.n_heads),
        n_kv_heads=min(dim(model.n_kv_heads), dim(model.n_heads)),
        moe_experts=0, moe_top_k=0, moe_d_expert=0,
        param_bytes=0.0)


__all__ = [
    "AcceptanceTrace", "SpecDecodeTracker", "SCHEMA_VERSION",
    "READABLE_SCHEMAS", "AcceptanceRecorder", "record_acceptance",
    "AcceptanceRegistry", "default_acceptance_registry",
    "register_acceptance", "get_acceptance", "load_acceptance",
    "resolve_acceptance", "draft_model_spec",
]
