"""Network model: intra-instance collectives + inter-instance transfers.

Intra-instance (TP all-reduce, EP all-to-all) is bandwidth-modeled from the
device link bandwidth with ring/all-to-all factors. Inter-instance transfers
(P/D KV moves, global prefix cache) go through shared ``Link`` objects that
serialize: concurrent transfers queue, which is how network contention shows
up in multi-instance simulations (paper §III-C attributes multi-instance
error to exactly this effect).

Link parameters are derived per device pair, not cluster-globally: every
instance whose hardware was resolved through the trace registry registers
its device's interconnect parameters (``register_endpoint``), and a link
between two registered endpoints gets ``min`` of their egress bandwidths
and the ``max`` of their latencies — a GPU-class NIC talking to a TPU-class
DCN port moves at the NIC's rate.  ``override_link`` pins explicit values
for one pair (e.g. a measured cross-rack route); the ``NetworkCfg`` numbers
only price links with an unregistered endpoint.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.config import NetworkCfg


def allreduce_time(nbytes: float, n: int, link_bw: float) -> float:
    if n <= 1:
        return 0.0
    return 2.0 * nbytes * (n - 1) / n / link_bw


def allgather_time(nbytes: float, n: int, link_bw: float) -> float:
    if n <= 1:
        return 0.0
    return nbytes * (n - 1) / n / link_bw


def alltoall_time(nbytes: float, n: int, link_bw: float) -> float:
    if n <= 1:
        return 0.0
    return nbytes * (n - 1) / n / link_bw


class Link:
    """A serialized shared link: transfers occupy it back-to-back."""

    def __init__(self, bw: float, latency: float = 10e-6):
        self.bw = bw
        self.latency = latency
        self.busy_until = 0.0
        self.bytes_moved = 0.0

    def transfer(self, now: float, nbytes: float) -> float:
        """Returns completion time, accounting for queueing."""
        start = max(now, self.busy_until)
        done = start + self.latency + nbytes / self.bw
        self.busy_until = done
        self.bytes_moved += nbytes
        return done


class NetworkModel:
    """Per-device-pair links (see module docstring).

    Endpoint interconnects are duck-typed: anything with
    ``inter_instance_bw`` / ``inter_instance_latency_s`` attributes
    (``repro_torch.hw.InterconnectSpec`` in practice — kept duck-typed so
    ``repro_torch.core`` stays below ``repro_torch.hw`` in the layering).
    """

    def __init__(self, cfg: NetworkCfg):
        self.cfg = cfg
        self._links: Dict[tuple, Link] = {}
        self._endpoints: Dict[str, object] = {}
        self._overrides: Dict[tuple, Tuple[Optional[float],
                                           Optional[float]]] = {}

    # ---- topology ----
    def register_endpoint(self, name: str, interconnect) -> None:
        """Attach a device ``InterconnectSpec`` to instance ``name``.
        Existing links touching it immediately re-derive their parameters
        (in place, preserving queue state and traffic counters), so late
        registration — e.g. elastic scale-out — takes effect for all
        subsequent transfers."""
        self._endpoints[name] = interconnect
        for key in self._links:
            if name in key:
                self._reprice(key)

    def override_link(self, a: str, b: str, bw: Optional[float] = None,
                      latency: Optional[float] = None) -> None:
        """Pin explicit parameters for one instance pair (unset fields
        keep the derived value) — the escape hatch for measured routes.
        Applies immediately, also to a link that already carried traffic
        (queue state and byte counters are preserved)."""
        key = (min(a, b), max(a, b))
        self._overrides[key] = (bw, latency)
        if key in self._links:
            self._reprice(key)

    def _reprice(self, key: tuple) -> None:
        link = self._links[key]
        link.bw, link.latency = self.link_params(*key)

    def link_params(self, a: str, b: str) -> Tuple[float, float]:
        """(bandwidth, latency) the link between ``a`` and ``b`` uses:
        min-bw / max-latency over the two endpoints' device interconnects,
        ``NetworkCfg`` defaults when either endpoint is unregistered, and
        explicit overrides on top."""
        ia, ib = self._endpoints.get(a), self._endpoints.get(b)
        if ia is not None and ib is not None:
            bw = min(ia.inter_instance_bw, ib.inter_instance_bw)
            lat = max(ia.inter_instance_latency_s,
                      ib.inter_instance_latency_s)
        else:
            bw = self.cfg.inter_instance_bw
            lat = self.cfg.inter_instance_latency
        o_bw, o_lat = self._overrides.get((min(a, b), max(a, b)),
                                          (None, None))
        return (o_bw if o_bw is not None else bw,
                o_lat if o_lat is not None else lat)

    # ---- transfers ----
    def link(self, a: str, b: str) -> Link:
        key = (min(a, b), max(a, b))
        if key not in self._links:
            bw, lat = self.link_params(a, b)
            self._links[key] = Link(bw, lat)
        return self._links[key]

    def kv_transfer_done(self, now: float, src: str, dst: str,
                         nbytes: float) -> float:
        return self.link(src, dst).transfer(now, nbytes)

    def stats(self) -> dict:
        return {f"{a}<->{b}": l.bytes_moved
                for (a, b), l in self._links.items()}

    def link_stats(self) -> dict:
        """Per-link parameters + traffic (asymmetric-bandwidth audits)."""
        return {f"{a}<->{b}": {"bw": l.bw, "latency_s": l.latency,
                               "bytes": l.bytes_moved}
                for (a, b), l in self._links.items()}
