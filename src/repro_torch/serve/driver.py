"""Multi-instance real-engine driver: real compute, virtual time.

The port of ``repro/serve/driver.py``: N ``ServingEngine`` instances
become runtime instances with ``TorchBackend`` execution on the copied
``ServingRuntime``, so routing, scheduling and virtual time are the same
code the JAX driver runs and a difference between the two drivers is a
difference in the engine.  A ``pd_map`` may pair engines of different
tensor-parallel degrees: the tp = 1 engine of such a pair runs replicated
on every rank and must be built with its replica handle
(``ServingEngine(replicas=group)``), and each backend learns its P/D
targets' tp, so a prefill group gathers every KV head for a decode engine
of another tp.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.config import (ENGINE_HW, H100, ClusterCfg,
                                     HardwareSpec, InstanceCfg, MoECfg,
                                     NetworkCfg, ParallelismCfg,
                                     PrefixCacheCfg, RouterCfg, SchedulerCfg,
                                     SpecCfg, engine_scheduler_cfg)
from repro_torch.core.request import SimRequest
from repro_torch.profiler import model_spec_from_arch
from repro_torch.runtime.backends.torch_engine import TorchBackend
from repro_torch.runtime.cluster import ServingRuntime
from repro_torch.serve.engine import ServingEngine
from repro_torch.workload.sharegpt import Request


def device_hw(device: torch.device) -> HardwareSpec:
    """The hardware spec of the runtime's block ledger for an engine on
    ``device``: ``ENGINE_HW`` on the CPU (the JAX driver's), and on a card
    the ``h100`` preset with the card's own memory size (the real backend
    reads only the memory size; a simulated twin prices with the rest)."""
    if device.type != "cuda":
        return ENGINE_HW
    props = torch.cuda.get_device_properties(device)
    return dataclasses.replace(H100, hbm_capacity=float(props.total_memory))


def engine_instance_cfg(engine: ServingEngine,
                        scheduler: Optional[SchedulerCfg] = None,
                        trace_name: Optional[str] = None,
                        moe: Optional[MoECfg] = None,
                        spec: Optional[SpecCfg] = None,
                        hw: Optional[HardwareSpec] = None,
                        prefix_cache: Optional[PrefixCacheCfg] = None
                        ) -> InstanceCfg:
    """Runtime InstanceCfg mirroring a live ``ServingEngine``.

    ``moe`` lets the simulated twin of a MoE engine name the same
    ``routing_trace`` the engine replays, and ``spec`` the same
    ``acceptance_trace`` a speculating engine replays, so the two report
    comparable ``expert_load`` / ``spec_decode``.  A speculating engine
    always mirrors its draft length into the scheduler (``decode_tokens =
    k + 1``) so the KV ledger reserves the verification window.
    ``prefix_cache`` overrides the ``PrefixCacheCfg`` derived from the
    engine's store (e.g. tier capacities shrunk so both backends walk the
    same spill chain).  A tensor-parallel engine's degree becomes the
    instance's ``parallelism.tp`` and device count, as in the JAX
    driver, so a simulated twin prices tp = k."""
    model = model_spec_from_arch(engine.cfg)
    scheduler = scheduler or engine_scheduler_cfg(engine.max_batch)
    if scheduler.max_batch_size > engine.max_batch:
        # the engine's slot count is a physical limit; an oversized batch
        # would crash slot allocation mid-run
        scheduler = dataclasses.replace(scheduler,
                                        max_batch_size=engine.max_batch)
    if spec is None and engine.spec is not None:
        spec = SpecCfg(enabled=True, k=engine.spec.k,
                       draft=model_spec_from_arch(engine.spec.draft))
    if engine.spec is not None:
        scheduler = dataclasses.replace(scheduler,
                                        decode_tokens=engine.spec.k + 1)
    if prefix_cache is None:
        prefix_cache = PrefixCacheCfg(
            enabled=engine.radix is not None,
            block_tokens=engine.radix.block if engine.radix else 16,
            capacity_fraction=0.5)
    return InstanceCfg(
        name=engine.name,
        hw=hw if hw is not None else device_hw(engine.device),
        model=model, n_devices=engine.tp, role=engine.role,
        parallelism=ParallelismCfg(tp=engine.tp), scheduler=scheduler,
        prefix_cache=prefix_cache,
        moe=moe if moe is not None else MoECfg(),
        spec=spec if spec is not None else SpecCfg(),
        trace_name=trace_name)


@dataclasses.dataclass
class DriverCfg:
    router: str = "round_robin"         # any registered routing policy
    kv_transfer_bw: float = 16e9        # bytes/s for P/D handoff
    kv_transfer_latency: float = 10e-6
    # None -> ServingEngine-matched semantics; pass any SchedulerCfg to give
    # the real engine chunked prefill / SJF / preemption etc.
    scheduler: Optional[SchedulerCfg] = None


def check_pd_replicas(prefill: ServingEngine,
                      decode: ServingEngine) -> None:
    """Raise for a P/D pair of different tp whose tp = 1 engine has no
    replica handle over the other's ranks: that engine runs on every rank,
    and without the handle its wall times differ by rank, the ranks'
    schedules part and the next collective hangs."""
    if prefill.tp == decode.tp:
        return
    one, other = (prefill, decode) if prefill.tp == 1 else (decode, prefill)
    # a tp = 1 engine's ranks are its replica handle
    if one.tp == 1 and (one.ranks is None or one.ranks.size != other.tp):
        raise ValueError(
            f"ServeDriver: P/D from {prefill.name!r} at tp={prefill.tp} to "
            f"{decode.name!r} at tp={decode.tp}: the tp = 1 engine "
            f"{one.name!r} runs on every rank of {other.name!r}'s "
            f"{other.tp}-rank group and needs its replica handle: build it "
            f"with ServingEngine(..., replicas=<the rank's EngineGroup>)")


class ServeDriver:
    def __init__(self, engines: List[ServingEngine],
                 cfg: DriverCfg = DriverCfg(),
                 pd_map: Optional[Dict[str, Tuple[str, ...]]] = None,
                 recorder=None):
        self.cfg = cfg
        self.engines = {e.name: e for e in engines}
        # each prefill engine's P/D targets' tp, for its backend's export
        pd_tp: Dict[str, Dict[str, int]] = {}
        for src, dsts in (pd_map or {}).items():
            for dst in dsts:
                if src in self.engines and dst in self.engines:
                    check_pd_replicas(self.engines[src], self.engines[dst])
                    pd_tp.setdefault(src, {})[dst] = self.engines[dst].tp
        ccfg = ClusterCfg(
            instances=tuple(engine_instance_cfg(e, cfg.scheduler)
                            for e in engines),
            router=RouterCfg(cfg.router),
            network=NetworkCfg(inter_instance_bw=cfg.kv_transfer_bw,
                               inter_instance_latency=cfg.kv_transfer_latency),
            pd_map=pd_map)
        # recorder: a repro_torch.obs.EventRecorder; build it with
        # wall_clock=True so the real engine's events carry wall-clock
        # stamps beside the virtual time (the simulator's schema)
        self.runtime = ServingRuntime(
            ccfg,
            backend_factory=lambda icfg, trace: TorchBackend(
                self.engines[icfg.name], icfg, pd_tp.get(icfg.name)),
            recorder=recorder)

    @property
    def finished(self) -> List[SimRequest]:
        return self.runtime.finished

    def run(self, requests: Sequence[Request], warmup: bool = True) -> dict:
        if warmup:
            self.runtime.warmup()
        self.runtime.submit_workload(requests)
        return self._augment(self.runtime.run())

    def metrics(self) -> dict:
        return self._augment(self.runtime.metrics())

    def _augment(self, m: dict) -> dict:
        for name, stats in m.get("instances", {}).items():
            cache = stats.get("prefix_cache")
            if cache:
                m[f"{name}_cache_hits"] = cache["hits"]
                m[f"{name}_cache_misses"] = cache["misses"]
        return m
