"""Global request router (paper §II-B): lives outside the instances,
dispatches on arrival by pluggable policy.

Registered policies (``RouterCfg(policy=<name>)``):

* ``round_robin``    — cycle through live candidates.
* ``least_loaded``   — minimize ``RuntimeInstance.load()`` (queue depth +
  memory pressure).
* ``prefix_aware``   — longest prefix-cache match wins (with a load guard);
  falls back to least-loaded.
* ``kv_residency``   — prefix match discounted by where the matched blocks
  actually live: device-resident tokens count full, host/SSD tokens are
  docked the prefill-equivalent cost of restoring them, so a slow-tier hit
  never beats recomputing on an idle sibling.

All cache probes go through the read-only ``RadixPrefixCache.peek`` —
routing candidates are *inspected*, never *accounted*: hit/miss counters
and eviction recency move only when the chosen instance's ``submit`` runs
the real ``match``.
* ``hardware_aware`` — throughput-weighted least-loaded for heterogeneous
  clusters: queue depth is divided by each instance's measured (or
  trace-estimated) tokens/s, so faster accelerators receive proportionally
  more work (see ``docs/serving-techniques.md``).

Custom policies subclass :class:`RoutingPolicy` and register with
:func:`register_policy`; the name is then valid in any ``RouterCfg``.

Backend-agnostic: candidates are ``RuntimeInstance`` objects, so one policy
registry serves both the simulator and the real JAX engine — the paper's
"flexible interface for request routing".
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Type

from repro_torch.core.config import RouterCfg
from repro_torch.core.request import SimRequest
from repro_torch.obs.events import ROUTE

if TYPE_CHECKING:   # instances are duck-typed: .alive/.cfg/.cache/.load()
    from repro_torch.runtime.instance import RuntimeInstance as Instance
else:
    Instance = object


class RoutingPolicy:
    """One routing decision: pick the instance that serves ``req``.

    ``candidates`` are the live instances able to take the request (role
    and model-affinity filtered).  Policies may inspect ``inst.load()``,
    ``inst.throughput_estimate()``, ``inst.cache`` (prefix match) and
    ``inst.cfg`` — the same signals on both execution backends.
    """
    name = "base"
    #: outcome label of the last ``choose`` call — policies with a
    #: fallback path overwrite it per decision ("prefix" vs "fallback");
    #: ``None`` makes the router count the decision under the policy name
    last_decision = None

    def choose(self, req: SimRequest, candidates: List["Instance"],
               now: float) -> "Instance":
        raise NotImplementedError

    def scores(self, req: SimRequest, candidates: List["Instance"],
               now: float):
        """Per-candidate score map for observability (higher/lower need
        not be comparable across policies — the event payload documents
        intent, not a total order).  Read-only: probes must not bump any
        counters.  ``None`` means the policy has no meaningful score
        (e.g. round-robin).  Only called when event tracing is enabled."""
        return None


class RoundRobin(RoutingPolicy):
    name = "round_robin"

    def __init__(self):
        self._i = 0

    def choose(self, req, candidates, now):
        inst = candidates[self._i % len(candidates)]
        self._i += 1
        return inst


class LeastLoaded(RoutingPolicy):
    name = "least_loaded"

    def choose(self, req, candidates, now):
        return min(candidates, key=lambda i: i.load())

    def scores(self, req, candidates, now):
        return {i.name: i.load() for i in candidates}


class PrefixAware(RoutingPolicy):
    """Route to the instance whose prefix cache matches longest; fall back
    to least-loaded when no instance has a meaningful match."""
    name = "prefix_aware"

    def choose(self, req, candidates, now):
        best, best_tokens = None, 0
        for inst in candidates:
            if inst.cache is None:
                continue
            # read-only probe: a routing scan must not bump hit/miss
            # counters or LRU recency on instances that lose the vote
            m = inst.cache.peek(req.prompt_tokens)
            if m.tokens > best_tokens:
                best, best_tokens = inst, m.tokens
        if best is not None and best_tokens >= 32 and \
                best.load() < 4 * min(c.load() for c in candidates) + 8:
            self.last_decision = "prefix"
            return best
        self.last_decision = "fallback"
        return min(candidates, key=lambda i: i.load())

    def scores(self, req, candidates, now):
        return {i.name: (float(i.cache.peek(req.prompt_tokens).tokens)
                         if i.cache is not None else 0.0)
                for i in candidates}


class KvResidency(RoutingPolicy):
    """Residency-aware prefix routing: a match is worth its *device*
    tokens plus lower-tier tokens discounted by what restoring them
    costs.  The discount converts the tier-fetch time (``MemoryModel.
    transfer_time`` over the matched host/SSD bytes) into prefill-token
    equivalents via the instance's prefill throughput estimate — so a
    3 GB/s SSD hit on a busy instance loses to plain recompute on an
    idle one, while an HBM-resident match still wins outright.  Probes
    are read-only (``peek``); the same load guard as ``prefix_aware``
    keeps a hot cache from starving the rest of the fleet."""
    name = "kv_residency"

    @staticmethod
    def _effective_tokens(inst, req) -> float:
        if inst.cache is None:
            return 0.0
        m = inst.cache.peek(req.prompt_tokens)
        if m.tokens <= 0:
            return 0.0
        kb = inst.mem.kv_bytes_per_token
        restore_s = 0.0
        if m.host_tokens:
            restore_s += inst.mem.transfer_time(
                m.host_tokens * kb, "host", "device")
        if m.ssd_tokens:
            restore_s += inst.mem.transfer_time(
                m.ssd_tokens * kb, "ssd", "device")
        return m.tokens - restore_s * inst.throughput_estimate("prefill")

    def choose(self, req, candidates, now):
        best, best_eff = None, 0.0
        for inst in candidates:
            eff = self._effective_tokens(inst, req)
            if eff > best_eff:
                best, best_eff = inst, eff
        if best is not None and best_eff >= 32 and \
                best.load() < 4 * min(c.load() for c in candidates) + 8:
            self.last_decision = "residency"
            return best
        self.last_decision = "fallback"
        return min(candidates, key=lambda i: i.load())

    def scores(self, req, candidates, now):
        return {i.name: self._effective_tokens(i, req) for i in candidates}


class HardwareAware(RoutingPolicy):
    """Throughput-weighted least-loaded for mixed-accelerator clusters.

    Each candidate's queue depth is normalized by its tokens/s estimate
    (observed once the instance has run enough iterations, otherwise the
    backend's trace-priced hint), so a TPU-class instance that decodes 5x
    faster than a GPU-class sibling absorbs ~5x the queue before the router
    prefers the slower device.

    The estimate is phase-aware: a prefill-role instance (P/D
    disaggregation) is rated by its *prefill* throughput — arrival routing
    only ever hands it prefill work — instead of the blended
    prefill+decode reference batch.  Decode-side placement uses the decode
    estimate symmetrically (``ServingRuntime._handoff``).
    """
    name = "hardware_aware"

    @staticmethod
    def _score(inst) -> float:
        phase = "prefill" if inst.cfg.role == "prefill" else None
        return (inst.load() + 1.0) / max(
            inst.throughput_estimate(phase), 1e-9)

    def choose(self, req, candidates, now):
        return min(candidates, key=self._score)

    def scores(self, req, candidates, now):
        return {i.name: self._score(i) for i in candidates}


_POLICIES: Dict[str, Type[RoutingPolicy]] = {
    p.name: p for p in (RoundRobin, LeastLoaded, PrefixAware,
                        KvResidency, HardwareAware)}


def register_policy(cls: Type[RoutingPolicy]):
    """Make a ``RoutingPolicy`` subclass available (by its ``name``) to
    every ``RouterCfg`` on both backends; returns the class (decorator)."""
    _POLICIES[cls.name] = cls
    return cls


class GlobalRouter:
    """Cluster-level dispatcher: filters live candidates (role and model
    affinity), then delegates the choice to the configured policy."""

    def __init__(self, cfg: RouterCfg, instances: List["Instance"]):
        self.cfg = cfg
        self.instances = instances
        if cfg.policy not in _POLICIES:
            raise ValueError(
                f"unknown routing policy {cfg.policy!r}; registered: "
                f"{sorted(_POLICIES)}")
        self.policy = _POLICIES[cfg.policy]()
        self.dispatched = 0
        # per-outcome decision counts (always on: one dict bump per
        # arrival) — surfaced as metrics()["routing"]
        self.decision_counts: Dict[str, int] = {}
        # event recorder (None = tracing disabled)
        self.obs = None

    def candidates_for(self, req: SimRequest) -> List["Instance"]:
        cands = [i for i in self.instances if i.alive
                 and i.cfg.role in ("unified", "prefill")]
        if self.cfg.model_affinity:
            matching = [i for i in cands if i.cfg.model.name == req.model
                        or req.model == "default"]
            if matching:
                cands = matching
        if not cands:
            raise RuntimeError("no live instance can serve request "
                               f"{req.req_id} (model {req.model})")
        return cands

    def dispatch(self, req: SimRequest, now: float) -> "Instance":
        policy = self.policy
        policy.last_decision = None
        cands = self.candidates_for(req)
        inst = policy.choose(req, cands, now)
        label = policy.last_decision or policy.name
        self.decision_counts[label] = self.decision_counts.get(label, 0) + 1
        self.dispatched += 1
        obs = self.obs
        if obs is not None:
            obs.emit(now, ROUTE, req=req.req_id, tenant=req.tenant,
                     payload={"policy": policy.name, "chosen": inst.name,
                              "decision": label,
                              "scores": policy.scores(req, cands, now)})
        inst.submit(req)
        return inst

    def stats(self) -> dict:
        return {"policy": self.cfg.policy,
                "dispatched": self.dispatched,
                "decisions": dict(self.decision_counts)}
