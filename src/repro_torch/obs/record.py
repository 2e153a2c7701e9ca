"""Event recorder: the in-memory sink the runtime emits into.

The runtime holds ``obs = None`` when tracing is disabled — every call
site is guarded with ``if obs is not None`` so the disabled path costs
one attribute load per *action*, never per token.  When enabled, the
recorder is a flat append-only list of :class:`~repro_torch.obs.events.Event`
plus derived views:

- ``lanes()`` / ``streams()`` — per-instance event streams.  Streams
  are the canonical parity surface: decode fast-forward synthesizes
  per-step events in the same order as exact stepping *within each
  lane*, while the global interleaving across instances may differ
  (bulked vs stepped execution visits instants in a different order).
- ``series(interval)`` — simulated-time-series gauges sampled on a
  fixed sim-time cadence.  Sampling is *derived* from the event log,
  never scheduled on the event queue — scheduling sampler events would
  perturb ``sim_events`` and fast-forward barriers.  A grid point's
  value is the state after all events with ``t <= grid_t``, which makes
  the sampling order-independent and therefore fast-forward-exact.
- ``save()/load()`` — raw JSON event log (one dict per event), the
  input format for ``python -m repro_torch.obs export``.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

from repro_torch.obs.events import ARRIVAL, FINISH, ITER, Event


class EventRecorder:
    """Append-only event sink.

    ``wall_clock=True`` (real-engine driver) stamps each event with
    wall-clock seconds since the recorder was created, alongside the
    simulated timestamp.  ``epoch_ns`` is the ``torch.profiler`` clock's
    reading (Unix nanoseconds) at that zero, so ``trace_ns`` puts a stamp
    on a profiler trace.
    """

    def __init__(self, wall_clock: bool = False):
        self.wall_clock = bool(wall_clock)
        self.events: List[Event] = []
        self._zero()
        self._seq = 0

    def _zero(self) -> None:
        self._t0 = time.perf_counter()
        self.epoch_ns = time.time_ns()

    def trace_ns(self, wall: float) -> int:
        """A ``wall`` stamp on the profiler's clock, in nanoseconds."""
        return self.epoch_ns + round(wall * 1e9)

    # -- emission ----------------------------------------------------------
    def emit(self, t: float, kind: str, inst: Optional[str] = None,
             req: Optional[int] = None, tenant: Optional[str] = None,
             phase: Optional[str] = None, dur: float = 0.0,
             payload: Optional[dict] = None,
             host: Optional[dict] = None) -> None:
        wall = (time.perf_counter() - self._t0) if self.wall_clock else None
        self._seq += 1
        self.events.append(Event(t, kind, inst=inst, req=req, tenant=tenant,
                                 phase=phase, dur=dur, wall=wall,
                                 seq=self._seq, payload=payload, host=host))

    def clear(self) -> None:
        self.events = []
        self._seq = 0
        self._zero()

    # -- views -------------------------------------------------------------
    def sorted_events(self) -> List[Event]:
        """Events in global sim-time order; within-lane emission order is
        preserved for equal timestamps (``seq`` is monotone per lane)."""
        return sorted(self.events, key=lambda e: (e.t, e.seq))

    def lanes(self) -> Dict[str, List[Event]]:
        """Per-instance event streams in emission order.  Cluster-level
        events (arrival, route, scale, autoscale) land in lane ``""``."""
        out: Dict[str, List[Event]] = {}
        for ev in self.events:
            out.setdefault(ev.inst or "", []).append(ev)
        return out

    def streams(self) -> Dict[str, List[tuple]]:
        """Canonical per-lane identity: what fast==exact parity compares.
        Drops the sequence number and wall stamp (see ``Event.key``)."""
        return {lane: [ev.key() for ev in evs]
                for lane, evs in self.lanes().items()}

    def series(self, interval: float) -> dict:
        """Sample gauges on a fixed simulated-time cadence.

        Returns ``{"interval", "t", "instances": {name: {"kv_used",
        "running", "queue_depth"}}, "tenants": {tenant: inflight}}``
        where every gauge list is aligned with the ``t`` grid.
        """
        if interval <= 0:
            raise ValueError("interval must be > 0")
        evs = self.sorted_events()
        t_end = evs[-1].t if evs else 0.0
        n_pts = int(t_end / interval) + 1
        grid = [i * interval for i in range(n_pts)]

        inst_tracks: Dict[str, Dict[str, List[float]]] = {}
        tenant_tracks: Dict[str, List[int]] = {}
        inst_state: Dict[str, Dict[str, float]] = {}
        tenant_state: Dict[str, int] = {}

        i = 0
        for gi, gt in enumerate(grid):
            while i < len(evs) and evs[i].t <= gt:
                ev = evs[i]
                i += 1
                if ev.kind == ITER and ev.inst is not None:
                    p = ev.payload or {}
                    inst_state[ev.inst] = {
                        "kv_used": p.get("kv_used", 0),
                        "running": p.get("running", 0),
                        "queue_depth": p.get("waiting", 0),
                    }
                elif ev.kind == ARRIVAL and ev.tenant is not None:
                    tenant_state[ev.tenant] = tenant_state.get(ev.tenant, 0) + 1
                elif ev.kind == FINISH and ev.tenant is not None:
                    tenant_state[ev.tenant] = tenant_state.get(ev.tenant, 0) - 1
            for name, st in inst_state.items():
                tr = inst_tracks.get(name)
                if tr is None:
                    # zero-fill grid points before this lane's first event
                    tr = inst_tracks[name] = {"kv_used": [0] * gi,
                                              "running": [0] * gi,
                                              "queue_depth": [0] * gi}
                for k, v in st.items():
                    tr[k].append(v)
            for tenant, v in tenant_state.items():
                tr = tenant_tracks.get(tenant)
                if tr is None:
                    tr = tenant_tracks[tenant] = [0] * gi
                tr.append(v)
        return {"interval": interval, "t": grid,
                "instances": inst_tracks, "tenants": tenant_tracks}

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"schema": "repro_torch.obs/1",
                       "wall_clock": self.wall_clock,
                       "epoch_ns": self.epoch_ns,
                       "events": [ev.to_dict() for ev in self.events]}, f)

    @classmethod
    def load(cls, path: str) -> "EventRecorder":
        with open(path) as f:
            d = json.load(f)
        rec = cls(wall_clock=d.get("wall_clock", False))
        if "epoch_ns" in d:
            rec.epoch_ns = int(d["epoch_ns"])
        for i, evd in enumerate(d.get("events", [])):
            ev = Event.from_dict(evd)
            ev.seq = i + 1
            rec.events.append(ev)
        rec._seq = len(rec.events)
        return rec
