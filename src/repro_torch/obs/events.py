"""Typed runtime events: the one schema both backends emit.

Every load-bearing runtime action is recorded as an :class:`Event`
carrying ``(t_sim, kind, instance, request, tenant, phase, dur,
payload)``.  ``t`` is always *simulated* seconds (the shared event
queue's clock); when the recorder was built with ``wall_clock=True``
(the real-engine driver) each event additionally carries ``wall`` —
wall-clock seconds since the recorder was created — so sim-vs-real
timelines are directly comparable on either axis.  ``EventRecorder.
trace_ns`` places a ``wall`` stamp on a ``torch.profiler`` trace's clock.
An ``iter`` of the real engine also carries ``host``: the iteration's
blocking host-device waits by kind (``{"h2d", "d2h", "sync"}``,
``obs.spans.Waits``).  Like ``wall`` it is measured, not decided, so
``key()`` leaves it out.

Kinds (the ``payload`` column lists the load-bearing keys):

========== ============================================================
kind       meaning / payload
========== ============================================================
arrival    request entered the cluster (lane ``""``)
route      routing decision: ``policy, chosen, decision, scores``
           (per-candidate scores — residency discounts, throughput
           hints — from ``RoutingPolicy.scores``)
admit      scheduler admitted the request into the running set
iter       one engine iteration (span: ``dur`` seconds ending at ``t``);
           ``items`` is the scheduling decision tuple, plus the gauges
           ``kv_used`` / ``running`` / ``waiting``
preempt    request evicted (``reason``: memory | failure | drain)
finish     request completed (``tokens`` emitted)
kv_restore prefix-cache hit restored lower-tier KV: ``tokens, seconds,
           host_tokens, ssd_tokens``
kv_tier    cache tier move settled: ``src, dst, bytes, residency``
pd_export  prefill side handed KV off: ``target, bytes, arrive_t``
pd_admit   decode side admitted the transferred request (``parked``)
spec_step  speculative decode step: ``accepted, proposed``
scale      fleet change: ``action``: scale_out | scale_in |
           rebalance_pd | revive
fail       instance failure (``orphans``)
autoscale  autoscaler tick: ``verdict, pool, attainment, queue_depth``
========== ============================================================

This module is dependency-free on purpose: the runtime imports it at
module level without layering cycles, and consumers (export,
attribution) treat events as plain data.
"""
from __future__ import annotations

from typing import Optional

ARRIVAL = "arrival"
ROUTE = "route"
ADMIT = "admit"
ITER = "iter"
PREEMPT = "preempt"
FINISH = "finish"
KV_RESTORE = "kv_restore"
KV_TIER = "kv_tier"
PD_EXPORT = "pd_export"
PD_ADMIT = "pd_admit"
SPEC_STEP = "spec_step"
SCALE = "scale"
FAIL = "fail"
AUTOSCALE = "autoscale"

#: kinds that are request-scoped (drive the per-request waterfall)
REQUEST_KINDS = (ARRIVAL, ROUTE, ADMIT, PREEMPT, FINISH, KV_RESTORE,
                 PD_EXPORT, PD_ADMIT, SPEC_STEP)


def _jsonable(v):
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


class Event:
    """One recorded action.  ``key()`` is the canonical identity the
    fast==exact parity suite compares — everything except the emission
    sequence number (interleaving across instances differs between
    bulked and stepped execution), the wall-clock stamp (which is
    real time, never reproducible) and the host's wait counts."""

    __slots__ = ("t", "kind", "inst", "req", "tenant", "phase", "dur",
                 "wall", "host", "seq", "payload")

    def __init__(self, t: float, kind: str, inst: Optional[str] = None,
                 req: Optional[int] = None, tenant: Optional[str] = None,
                 phase: Optional[str] = None, dur: float = 0.0,
                 wall: Optional[float] = None, seq: int = 0,
                 payload: Optional[dict] = None,
                 host: Optional[dict] = None):
        self.t = t
        self.kind = kind
        self.inst = inst
        self.req = req
        self.tenant = tenant
        self.phase = phase
        self.dur = dur
        self.wall = wall
        self.host = host
        self.seq = seq
        self.payload = payload

    def key(self) -> tuple:
        return (self.t, self.kind, self.inst, self.req, self.tenant,
                self.phase, self.dur, self.payload)

    def to_dict(self) -> dict:
        d = {"t": self.t, "kind": self.kind}
        for f in ("inst", "req", "tenant", "phase", "wall", "host"):
            v = getattr(self, f)
            if v is not None:
                d[f] = v
        if self.payload is not None:
            # canonical JSON form (tuples -> lists) so a save/load
            # round-trip reproduces to_dict() exactly
            d["payload"] = _jsonable(self.payload)
        if self.dur:
            d["dur"] = self.dur
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Event":
        return cls(t=d["t"], kind=d["kind"], inst=d.get("inst"),
                   req=d.get("req"), tenant=d.get("tenant"),
                   phase=d.get("phase"), dur=d.get("dur", 0.0),
                   wall=d.get("wall"), payload=d.get("payload"),
                   host=d.get("host"))

    def __repr__(self):
        return (f"Event(t={self.t:.6f}, {self.kind!r}, inst={self.inst!r},"
                f" req={self.req!r})")
