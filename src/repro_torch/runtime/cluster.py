"""Unified serving driver: router + instances + network + P/D wiring +
failure injection + elastic scaling, parameterized by execution backend.

``ServingRuntime`` owns the serving semantics once; the backend factory
decides whether instances are priced (``SimBackend``) or really executed
(``JaxBackend``).  ``repro_torch.core.Cluster`` and ``repro_torch.serve.ServeDriver``
are thin wrappers choosing a factory.

Every instance — whether built at construction time or added later via
``add_instance`` — goes through one ``_build_instance`` path, so elastic
scale-out instances join the shared global prefix cache and get P/D handoff
wiring exactly like their siblings (previously they silently got neither).
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence

from repro_torch.core.config import ClusterCfg, InstanceCfg
from repro_torch.core.engine import EventQueue
from repro_torch.core.metrics import (aggregate, merge_expert_load,
                                merge_kv_tiers, merge_spec_decode,
                                tenant_rollup)
from repro_torch.core.network import NetworkModel
from repro_torch.core.request import QUEUED, SimRequest
from repro_torch.core.trace import Trace, TraceRegistry
from repro_torch.obs.events import ARRIVAL, FAIL, PD_EXPORT, PREEMPT, SCALE
from repro_torch.runtime.backend import ExecutionBackend
from repro_torch.runtime.instance import RuntimeInstance
from repro_torch.runtime.prefix_cache import RadixPrefixCache
from repro_torch.runtime.router import GlobalRouter

if TYPE_CHECKING:
    from repro_torch.hw.registry import HardwareRegistry

BackendFactory = Callable[[InstanceCfg, Optional[Trace]], ExecutionBackend]


class ServingRuntime:
    """The one cluster driver (both backends): arrivals -> router ->
    instances -> completion, plus P/D KV handoff over the network model,
    failure injection, and elastic scale-out.

    ``backend_factory(icfg, trace)`` decides the execution substrate per
    instance; ``traces`` feeds explicit ``InstanceCfg.trace_name`` lookups
    and ``hw`` resolves ``InstanceCfg.hw_name`` through the hardware-trace
    registry (``repro_torch.hw``), defaulting to the process-wide registry.
    """

    def __init__(self, cfg: ClusterCfg, backend_factory: BackendFactory,
                 traces: Optional[TraceRegistry] = None,
                 hw: Optional["HardwareRegistry"] = None,
                 recorder=None):
        self.cfg = cfg
        self.backend_factory = backend_factory
        # event recorder (repro_torch.obs.EventRecorder) — None disables tracing
        # entirely: instances/router/backends keep obs=None and every
        # emission site short-circuits on one attribute load
        self.obs = recorder
        self.queue = EventQueue()
        self.network = NetworkModel(cfg.network)
        self.traces = traces or TraceRegistry()
        # hardware-by-name resolution (InstanceCfg.hw_name): measured
        # HardwareTrace artifacts when loaded, synthetic otherwise.
        # Imported lazily: repro_torch.hw sits above repro_torch.core in the layering,
        # so a cold `import repro_torch.hw` must not re-enter this module.
        if hw is None:
            from repro_torch.hw.registry import default_registry as hw
        self.hw = hw
        self.instances: Dict[str, RuntimeInstance] = {}
        # instances removed by elastic scale-in: kept for metrics (their
        # stats stay visible with a "retired" marker) but out of routing
        self.retired: Dict[str, RuntimeInstance] = {}
        self._shared_cache: Optional[RadixPrefixCache] = None
        # live P/D pool membership — starts from the config map, mutable
        # at runtime via rebalance_pd (the cfg dataclass stays frozen)
        self.pd_map: Dict[str, tuple] = {
            k: tuple(v) for k, v in (cfg.pd_map or {}).items()}
        for icfg in cfg.instances:
            self._build_instance(icfg)
        self._refresh_skippable()
        self.router = GlobalRouter(
            cfg.router, list(self.instances.values()))
        self.router.obs = recorder
        self.finished: List[SimRequest] = []
        self._all_requests: List[SimRequest] = []
        self.autoscaler = None

    def _refresh_skippable(self):
        """Mark iteration events skippable when instances are isolated:
        no P/D wiring (a prefill completion triggers cross-instance KV
        traffic) and no shared prefix cache (a sibling's iteration can
        move shared radix/memory state).  Skippable events don't gate the
        decode fast-forward horizon (``EventQueue.next_barrier_time``)."""
        iso = not self.pd_map and self._shared_cache is None
        for inst in self.instances.values():
            inst.iter_skippable = iso

    # ---- instance construction (init-time AND elastic scale-out) ----
    def _build_instance(self, icfg: InstanceCfg) -> RuntimeInstance:
        trace = (self.traces.get(icfg.trace_name)
                 if icfg.trace_name else None)
        if trace is None and icfg.hw_name:
            hwt = self.hw.resolve(icfg.hw_name, icfg.model,
                                  tp=icfg.parallelism.tp)
            if hwt.spec is not None:
                # the trace carries the device spec: memory model and
                # off-grid analytical fallback price the same hardware
                icfg = dataclasses.replace(icfg, hw=hwt.spec)
            # cached shared view: identical instances share one
            # interpolation index + memo (fleet-scale fast path)
            trace = hwt.shared_trace()
            # the trace also carries the device's interconnect parameters:
            # links between two trace-resolved instances derive bandwidth/
            # latency from the endpoint pair (min-bw rule), so mixed
            # accelerator clusters see per-pair, not cluster-global, links
            self.network.register_endpoint(icfg.name, hwt.interconnect)
        if icfg.hw is None:
            raise ValueError(
                f"instance {icfg.name!r} has no hardware spec: set "
                f"InstanceCfg.hw, or use an hw_name whose trace embeds a "
                f"spec (this one resolved to a spec-less trace)"
                if icfg.hw_name else
                f"instance {icfg.name!r} has no hardware spec: set "
                f"InstanceCfg.hw or an InstanceCfg.hw_name")
        backend = self.backend_factory(icfg, trace)
        cache: Optional[RadixPrefixCache] = None
        if icfg.prefix_cache.enabled:
            if icfg.prefix_cache.scope == "global":
                # global scope: all instances share one radix tree
                if self._shared_cache is None:
                    self._shared_cache = RadixPrefixCache(
                        icfg.prefix_cache, backend.memory,
                        name="global.cache")
                cache = self._shared_cache
            else:
                cache = RadixPrefixCache(icfg.prefix_cache, backend.memory,
                                         name=f"{icfg.name}.cache")
        inst = RuntimeInstance(icfg, self.queue, backend, cache=cache)
        if self.obs is not None:
            inst.attach_obs(self.obs)
        inst.on_request_done = self._on_done
        if self.pd_map.get(icfg.name):
            inst.on_prefill_done = self._handoff
        self.instances[icfg.name] = inst
        return inst

    # ---- P/D disaggregation ----
    def _handoff(self, req: SimRequest, src: RuntimeInstance):
        """Prefill finished on a prefill-role instance: move the KV to the
        least-loaded live decode target and admit there when it lands."""
        names = self.pd_map.get(src.name, ())
        targets = [self.instances[n] for n in names
                   if n in self.instances and self.instances[n].alive]
        if not targets:
            # no live decode target: the request is dropped, but the
            # prefill-side backend state (e.g. the engine slot) must not leak
            src.backend.release(req)
            return
        # decode-throughput-weighted: a faster decode device absorbs
        # proportionally more handoffs (phase-aware counterpart of the
        # hardware_aware arrival policy; identical to least-loaded when
        # the targets are homogeneous)
        tgt = min(targets, key=lambda i: (i.load() + 1.0)
                  / max(i.throughput_estimate("decode"), 1e-9))
        req.decode_instance = tgt.name
        handoff = src.backend.export_kv(req)
        kv_bytes = handoff.nbytes
        if self.cfg.network.kv_transfer_policy == "layerwise_overlap":
            # transfer overlapped with the last prefill layers: only the
            # final layer's KV lands on the critical path
            kv_bytes = kv_bytes / max(src.cfg.model.n_layers, 1)
        done_t = self.network.kv_transfer_done(
            self.queue.now, src.name, tgt.name, kv_bytes)
        obs = self.obs
        if obs is not None:
            obs.emit(self.queue.now, PD_EXPORT, inst=src.name,
                     req=req.req_id, tenant=req.tenant,
                     payload={"target": tgt.name, "bytes": float(kv_bytes),
                              "arrive_t": done_t})
        self.queue.schedule_at(
            done_t, lambda: tgt.admit_decode(req, handoff),
            tag=f"kv:{src.name}->{tgt.name}")

    # ---- lifecycle ----
    def _on_done(self, req: SimRequest, inst: RuntimeInstance):
        self.finished.append(req)

    def submit_workload(self, requests: Sequence):
        for r in requests:
            sim = SimRequest(req_id=r.req_id, arrival=r.arrival,
                             prompt_tokens=list(r.prompt_tokens),
                             output_len=r.output_len, model=r.model,
                             # tenant class identity rides the request end
                             # to end (router -> scheduler -> backends);
                             # getattr keeps bare request objects working
                             tenant=getattr(r, "tenant", "default"),
                             priority=getattr(r, "priority", 0),
                             weight=getattr(r, "weight", 1.0),
                             slo_ttft_ms=getattr(r, "slo_ttft_ms", 2000.0),
                             slo_tpot_ms=getattr(r, "slo_tpot_ms", 200.0))
            self._all_requests.append(sim)
            self.queue.schedule_at(
                r.arrival, lambda s=sim: self._arrive(s), tag="arrival")

    def _arrive(self, req: SimRequest):
        obs = self.obs
        if obs is not None:
            obs.emit(self.queue.now, ARRIVAL, req=req.req_id,
                     tenant=req.tenant,
                     payload={"prompt": req.prompt_len,
                              "output": req.output_len})
        self.router.dispatch(req, self.queue.now)

    # ---- failures / elastic scaling ----
    def inject_failure(self, t: float, instance: str,
                       recover_after: Optional[float] = None):
        def fail():
            inst = self.instances[instance]
            orphans = inst.fail()
            obs = self.obs
            if obs is not None:
                obs.emit(self.queue.now, FAIL, inst=instance,
                         payload={"orphans": len(orphans)})
                for req in orphans:
                    obs.emit(self.queue.now, PREEMPT, inst=instance,
                             req=req.req_id, tenant=req.tenant,
                             payload={"reason": "failure"})
            for req in orphans:
                req.state = QUEUED
                req.cached_prefix = 0
                self.router.dispatch(req, self.queue.now)
        self.queue.schedule_at(t, fail, tag=f"fail:{instance}")
        if recover_after is not None:
            def revive():
                self.instances[instance].revive()
                obs = self.obs
                if obs is not None:
                    obs.emit(self.queue.now, SCALE, inst=instance,
                             payload={"action": "revive"})
            self.queue.schedule_at(t + recover_after, revive,
                                   tag=f"revive:{instance}")

    def add_instance(self, t: float, icfg: InstanceCfg):
        """Elastic scale-out at simulated time t (same wiring as init)."""
        def add():
            inst = self._build_instance(icfg)
            self.router.instances.append(inst)
            obs = self.obs
            if obs is not None:
                obs.emit(self.queue.now, SCALE, inst=icfg.name,
                         payload={"action": "scale_out"})
            # a scale-out instance can flip isolation (e.g. first global-
            # scope cache user): re-derive for the whole fleet.  Events
            # already in the heap keep their old flag; that is safe —
            # a new shared cache is bound to this instance's memory, and
            # only events scheduled after this barrier can touch it.
            self._refresh_skippable()
        self.queue.schedule_at(t, add, tag=f"scale:{icfg.name}")

    def remove_instance(self, t: float, name: str):
        """Elastic scale-in at simulated time t: drain the instance and
        preempt-and-requeue its in-flight work to the surviving fleet.
        An explicit event, hence a decode fast-forward barrier by
        construction — the fast path can never bulk decode iterations
        across the removal.  The caller must leave at least one live
        instance able to serve the orphans (the autoscaler's
        ``min_instances`` guard)."""
        self.queue.schedule_at(t, lambda: self._remove_instance(name),
                               tag=f"scalein:{name}")

    def _remove_instance(self, name: str):
        inst = self.instances.pop(name, None)
        if inst is None:
            return
        orphans = inst.drain()
        if inst in self.router.instances:
            self.router.instances.remove(inst)
        obs = self.obs
        if obs is not None:
            obs.emit(self.queue.now, SCALE, inst=name,
                     payload={"action": "scale_in", "orphans": len(orphans)})
            for req in orphans:
                obs.emit(self.queue.now, PREEMPT, inst=name, req=req.req_id,
                         tenant=req.tenant, payload={"reason": "drain"})
        self.retired[name] = inst
        # late P/D KV transfers already in flight toward this instance
        # restart from prefill elsewhere instead of parking forever
        inst.on_dead_arrival = self._redispatch
        self._refresh_skippable()
        for req in orphans:
            req.state = QUEUED
            req.cached_prefix = 0
            self.router.dispatch(req, self.queue.now)

    def _redispatch(self, req: SimRequest):
        """Full restart of a request whose instance disappeared under it
        (scale-in racing a P/D KV transfer): progress and KV are gone."""
        req.state = QUEUED
        req.cached_prefix = 0
        req.prefill_done_tokens = 0
        req.generated = 0
        req.n_restarts += 1
        self.router.dispatch(req, self.queue.now)

    def rebalance_pd(self, t: float, pd_map: Dict[str, Sequence[str]]):
        """Replace the P/D pool membership at simulated time t (explicit
        event => fast-forward barrier).  Prefill instances named in the
        new map get handoff wiring; ones no longer named lose it.  KV
        transfers already scheduled keep their original target."""
        def apply():
            self.pd_map = {k: tuple(v) for k, v in pd_map.items()}
            for name, inst in self.instances.items():
                inst.on_prefill_done = (self._handoff
                                        if self.pd_map.get(name) else None)
            self._refresh_skippable()
            obs = self.obs
            if obs is not None:
                obs.emit(self.queue.now, SCALE,
                         payload={"action": "rebalance_pd"})
        self.queue.schedule_at(t, apply, tag="rebalance_pd")

    def attach_autoscaler(self, scaler):
        """Wire an SLO-aware autoscaling policy (``repro_torch.runtime.
        autoscale.SLOAutoscaler``) to this runtime: the policy evaluates
        on its cadence via explicit queue events and acts through
        ``add_instance`` / ``remove_instance`` / ``rebalance_pd``, so
        every scaling action is a fast-forward barrier.  Attach before
        ``run``; returns the scaler."""
        self.autoscaler = scaler
        scaler.attach(self)
        return scaler

    # ---- run ----
    def warmup(self):
        for inst in self.instances.values():
            inst.backend.warmup()

    def run(self, until: Optional[float] = None) -> Dict:
        t0 = time.time()
        self.queue.run(until=until)
        wall = time.time() - t0
        m = self.metrics()
        m["sim_wall_s"] = wall
        return m

    def metrics(self) -> Dict:
        m = aggregate(self._all_requests)
        m["sim_events"] = self.queue.n_processed
        m["instances"] = {n: i.stats() for n, i in self.instances.items()}
        # scale-in keeps retired instances visible for accounting (marked,
        # live instances win the name on a reuse collision)
        for name, inst in self.retired.items():
            if name not in m["instances"]:
                m["instances"][name] = {**inst.stats(), "retired": True}
        # per-tenant SLO/goodput rollup — same requests both backends see,
        # so the tenant table is parity-assertable like everything else
        tenants = tenant_rollup(self._all_requests)
        if tenants:
            m["tenants"] = tenants
        if self.autoscaler is not None:
            m["autoscale"] = self.autoscaler.metrics()
        m["network_bytes"] = self.network.stats()
        m["network_links"] = self.network.link_stats()
        # trace-driven MoE: cluster-level expert-load rollup (per-instance
        # detail stays under instances[<name>]["expert_load"]) — reported
        # identically by both backends, pinned by the parity suite
        loads = [s["expert_load"] for s in m["instances"].values()
                 if "expert_load" in s]
        if loads:
            m["expert_load"] = merge_expert_load(loads)
        # trace-driven speculative decoding: same rollup shape (per-
        # instance detail stays under instances[<name>]["spec_decode"])
        specs = [s["spec_decode"] for s in m["instances"].values()
                 if "spec_decode" in s]
        if specs:
            m["spec_decode"] = merge_spec_decode(specs)
        # KV-tier rollup: residency/traffic across the fleet's distinct
        # caches (merge dedupes a shared global-scope cache by name)
        tiers = [s["kv_tiers"] for s in m["instances"].values()
                 if "kv_tiers" in s]
        if tiers:
            m["kv_tiers"] = merge_kv_tiers(tiers)
        # routing introspection is always on (cheap per-arrival counters);
        # the latency-attribution rollup needs the event log, so it only
        # appears when a recorder is attached — keeping tracing-disabled
        # metrics byte-identical to pre-tracing builds
        m["routing"] = self.router.stats()
        if self.obs is not None:
            from repro_torch.obs.attribution import attribution
            m["attribution"] = attribution(self._all_requests, self.obs)
        return m
