"""Simulator configuration: hardware, instance, cluster, policies.

Mirrors the paper's Fig. 1: a cluster is a *global request router* plus a set
of heterogeneous *instances*; each instance has its own compute devices,
memory model, (optional) prefix cache, parallelism scheme and network links.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-device compute/memory spec (profiler hw registry feeds this)."""
    name: str
    peak_flops: float            # FLOP/s (bf16)
    hbm_bw: float                # bytes/s
    hbm_capacity: float          # bytes
    link_bw: float               # bytes/s per inter-device link
    host_bw: float = 16e9        # device<->host (PCIe-class)
    host_capacity: float = 512e9
    ssd_bw: float = 3e9
    ssd_capacity: float = 8e12
    mmu_efficiency: float = 0.85  # achievable fraction of peak on matmuls
    # egress to OTHER instances (NIC / DCN class).  ``NetworkModel`` derives
    # each inter-instance link from the two endpoint devices' values
    # (min-bw rule), so a heterogeneous P/D pair sees the slower NIC.
    inter_instance_bw: float = 25e9
    inter_instance_latency_s: float = 10e-6


@dataclasses.dataclass(frozen=True)
class ParallelismCfg:
    tp: int = 1                  # tensor parallel degree (within instance)
    pp: int = 1                  # pipeline parallel degree
    ep: int = 1                  # expert parallel degree
    dp: int = 1                  # replicas *inside* the instance


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """What the simulator needs to know about a served model."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_expert: int = 0
    moe_capacity_factor: float = 1.25   # per-expert capacity buffer scale
    mlp_gated: bool = True
    param_bytes: float = 0.0     # total weight bytes (computed if 0)
    dtype_bytes: int = 2

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def kv_bytes_per_token(self) -> float:
        return (2 * self.n_layers * self.n_kv_heads * self.d_head
                * self.dtype_bytes)

    def weight_bytes(self) -> float:
        if self.param_bytes:
            return self.param_bytes
        d = self.d_model
        attn = d * self.n_heads * self.d_head * 2 \
            + d * self.n_kv_heads * self.d_head * 2
        if self.is_moe:
            ff = 3 * d * self.moe_d_expert * self.moe_experts \
                + d * self.moe_experts
        else:
            ff = (3 if self.mlp_gated else 2) * d * self.d_ff
        emb = 2 * self.vocab * d
        return (self.n_layers * (attn + ff) + emb) * self.dtype_bytes

    def expert_bytes(self) -> float:
        return 3 * self.d_model * self.moe_d_expert * self.dtype_bytes

    def flops_per_token(self, context: int = 0) -> float:
        """Dense fwd FLOPs per token (+ attention O(context) part)."""
        d = self.d_model
        attn_w = 2 * d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        if self.is_moe:
            ff = 2 * 3 * d * self.moe_d_expert * self.moe_top_k
        else:
            ff = 2 * (3 if self.mlp_gated else 2) * d * self.d_ff
        attn_ctx = 4 * self.n_heads * self.d_head * context
        head = 2 * d * self.vocab
        return self.n_layers * (attn_w + ff + attn_ctx) + head


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """A multi-tenant request class: scheduling identity + SLO targets.

    Requests tagged with a tenant class carry its ``priority`` (the
    ``policy="priority"`` scheduler key — larger runs first), its
    ``weight`` (relative service share for the starvation guard,
    ``SchedulerCfg.share_guard_tokens``) and its SLO targets through
    router -> scheduler -> backends; ``metrics()["tenants"]`` rolls up
    per-tenant TTFT/TPOT percentiles, SLO attainment and goodput
    (throughput counting only SLO-met requests) against them, and the
    SLO-aware autoscaler (``repro_torch.runtime.autoscale``) scales the fleet
    on the worst tenant's attainment.
    """
    name: str
    priority: int = 0                # larger = scheduled first
    slo_ttft_ms: float = 2000.0      # time-to-first-token target
    slo_tpot_ms: float = 200.0       # time-per-output-token target
    weight: float = 1.0              # relative share for the fairness guard


@dataclasses.dataclass(frozen=True)
class SchedulerCfg:
    policy: str = "fcfs"             # fcfs | priority | sjf
    max_batch_size: int = 256        # max concurrent sequences
    max_batch_tokens: int = 8192     # per-iteration token budget
    chunked_prefill: bool = True
    prefill_chunk: int = 2048
    straggler_backup_ms: float = 0.0  # >0: re-dispatch if iteration exceeds
    # engine-matching semantics (mirrors repro_torch.serve.ServingEngine):
    # prefill runs alone (one request, whole prompt), decode pads to the
    # slot count, prefill lengths round up to power-of-2 buckets
    prefill_exclusive: bool = False
    decode_pad_to: int = 0
    bucket_prefill: bool = False
    # tokens one decode step may verify/write (speculative decoding sets
    # this to draft k + 1 so the KV ledger reserves the verification
    # window and the token budget charges the real compute width; the
    # step still *emits* a variable 1..k+1 tokens per the acceptance draw)
    decode_tokens: int = 1
    # weighted-share starvation guard for policy="priority": > 0 bounds
    # how far a waiting tenant's weight-normalized service (scheduled
    # tokens / tenant weight) may lag the head-of-queue tenant's before
    # the scheduler admits the lagging tenant first.  0 disables the
    # guard (pure priority order — low-priority tenants can starve).
    share_guard_tokens: int = 0


@dataclasses.dataclass(frozen=True)
class PrefixCacheCfg:
    enabled: bool = False
    block_tokens: int = 16           # radix-tree block granularity
    capacity_fraction: float = 0.5   # fraction of free HBM usable for cache
    host_spill: bool = True          # device eviction spills HBM -> host RAM
    ssd_spill: bool = False          # host eviction spills host -> SSD
    # pluggable eviction-victim selection, resolved through the registry in
    # repro_torch.runtime.prefix_cache (register_eviction_policy adds names):
    # "lru" | "lfu" | "priority" (priority-weighted LRU — low-priority
    # tenants' blocks evict first)
    eviction_policy: str = "lru"
    scope: str = "instance"          # instance | global


@dataclasses.dataclass(frozen=True)
class MoECfg:
    expert_parallel: bool = True
    offload: str = "none"            # none | host | pim
    offload_fraction: float = 0.0    # fraction of experts offloaded
    prefetch: bool = True            # overlap expert fetch with compute
    routing: str = "uniform"         # uniform | zipf | correlated
    zipf_a: float = 1.1
    # named ExpertRoutingTrace (resolved through repro_torch.moe's registry at
    # instance build time, like InstanceCfg.hw_name).  When set, expert
    # load is *replayed* from the trace instead of drawn statistically:
    # the simulator prices per-layer counts from it and the real engine
    # forces the same assignments through its routing hook, so both
    # backends report identical metrics()["expert_load"].
    routing_trace: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SpecCfg:
    """Speculative decoding (draft/verify) for one instance.

    The simulator prices every spec step as draft-cost + verify-cost and
    advances requests by accepted + 1 tokens drawn deterministically from
    the named ``AcceptanceTrace`` (resolved through ``repro_torch.spec``'s
    registry at instance build time, like ``MoECfg.routing_trace``); the
    real engine runs an actual draft model + batched target verification
    (``ServingEngine(spec=...)``) and, when replaying the same trace,
    reports identical ``metrics()["spec_decode"]``.
    """
    enabled: bool = False
    k: int = 4                       # draft proposal length per step
    # sim draft pricing model; None -> repro_torch.spec.draft_model_spec scales
    # the target down by ``draft_scale``
    draft: Optional[ModelSpec] = None
    draft_scale: float = 0.25
    # named AcceptanceTrace — required for simulation (the sim has no
    # draft/target pair to measure acceptance from)
    acceptance_trace: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class InstanceCfg:
    name: str
    hw: HardwareSpec
    model: ModelSpec
    n_devices: int = 1
    parallelism: ParallelismCfg = ParallelismCfg()
    scheduler: SchedulerCfg = SchedulerCfg()
    prefix_cache: PrefixCacheCfg = PrefixCacheCfg()
    moe: MoECfg = MoECfg()
    spec: SpecCfg = SpecCfg()
    # memory-side accelerator spec for MoE expert offloading
    # (``MoECfg.offload="pim"``): offloaded experts execute on this device
    # in ``ExpertExecutionModel``.  None falls back to the ``PIM_DEVICE``
    # preset when pim offload is configured, so the offload path always
    # prices against a real spec.
    pim: Optional[HardwareSpec] = None
    role: str = "unified"            # unified | prefill | decode
    kv_block_tokens: int = 16        # PagedAttention block size
    trace_name: Optional[str] = None  # perf-model trace to use
    # which kernel backend's hwtrace/3 sub-bucket rows price this instance
    # ("cuda" | "reference").  None auto-picks: cuda rows when the trace
    # carries them, else reference, else no kernel tier.
    kernel_backend: Optional[str] = None
    # hardware by name: resolved through the repro_torch.hw registry at instance
    # build time (measured HardwareTrace if one is loaded, synthetic
    # analytical trace otherwise).  Lets one cluster mix accelerators —
    # e.g. GPU-class prefill + TPU-class decode instances (docs/
    # adding-hardware.md).  When set, the trace's embedded spec overrides
    # ``hw`` so memory model and fallback pricing match the device.
    hw_name: Optional[str] = None
    # KV watermark timeline window (samples kept); evictions beyond it
    # are counted in stats()["kv_watermark_dropped"] — no silent caps
    watermark_window: int = 4096


@dataclasses.dataclass(frozen=True)
class RouterCfg:
    # round_robin | least_loaded | prefix_aware | hardware_aware |
    # kv_residency (prefix matches weighted by the tier the blocks live in)
    policy: str = "round_robin"
    model_affinity: bool = True      # requests route to instances serving their model


@dataclasses.dataclass(frozen=True)
class NetworkCfg:
    """Cluster network *defaults*.  Links between instances whose hardware
    was resolved through the trace registry are derived from the endpoint
    devices' ``InterconnectSpec``s (min-bw rule; see ``NetworkModel``) —
    these values only price links with at least one endpoint that carries
    no device interconnect info (e.g. raw ``hw=`` instances and the real
    engine driver's configurable transfer bandwidth)."""
    inter_instance_bw: float = 25e9  # bytes/s between instances (DCN/PCIe)
    inter_instance_latency: float = 10e-6
    kv_transfer_policy: str = "full_blocking"  # full_blocking | layerwise_overlap


@dataclasses.dataclass(frozen=True)
class ClusterCfg:
    instances: Tuple[InstanceCfg, ...]
    router: RouterCfg = RouterCfg()
    network: NetworkCfg = NetworkCfg()
    # P/D disaggregation: map prefill-instance name -> decode-instance names
    pd_map: Optional[Dict[str, Tuple[str, ...]]] = None


# --- hardware presets -------------------------------------------------------

RTX3090 = HardwareSpec(
    name="rtx3090", peak_flops=71e12, hbm_bw=936e9, hbm_capacity=24e9,
    link_bw=16e9,   # paper's GPU baseline: PCIe 4.0 x16 interconnect
    inter_instance_bw=25e9)           # 200GbE-class NIC

TPU_V5E = HardwareSpec(
    name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9, hbm_capacity=16e9,
    link_bw=50e9, inter_instance_bw=50e9)

TPU_V6E = HardwareSpec(
    name="tpu-v6e", peak_flops=918e12, hbm_bw=1.6e12, hbm_capacity=32e9,
    link_bw=100e9,  # paper's Colab TPU integration case study
    inter_instance_bw=100e9)          # ICI/DCN-class egress

PIM_DEVICE = HardwareSpec(
    name="pim", peak_flops=8e12, hbm_bw=2.0e12, hbm_capacity=16e9,
    link_bw=25e9,   # memory-side accelerator for expert offloading [7,8]
    inter_instance_bw=25e9)

H100 = HardwareSpec(
    # NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, HBM3, 80 GB,
    # NVLink 4 per direction, PCIe 5.0 x16 host link
    name="h100", peak_flops=989e12, hbm_bw=3.35e12, hbm_capacity=80e9,
    link_bw=450e9, host_bw=64e9)

CPU_HOST = HardwareSpec(
    name="cpu-host", peak_flops=2e12, hbm_bw=80e9, hbm_capacity=256e9,
    link_bw=16e9, inter_instance_bw=12.5e9)

ENGINE_HW = HardwareSpec(
    # matches the container's CPU engine environment: used for engine-matched
    # simulated instances and for the real JaxBackend's block accounting
    name="cpu-engine", peak_flops=5e10, hbm_bw=20e9, hbm_capacity=8e9,
    link_bw=8e9, host_bw=8e9, inter_instance_bw=8e9)


def engine_scheduler_cfg(max_batch: int) -> SchedulerCfg:
    """ServingEngine-matched scheduling semantics (the single definition
    shared by the real driver and the engine-matched sim benchmarks): one
    whole-prompt prefill at a time, decode pads to the slot count, bucketed
    prefill lengths."""
    return SchedulerCfg(
        max_batch_size=max_batch, max_batch_tokens=1 << 16,
        chunked_prefill=False, prefill_exclusive=True,
        bucket_prefill=True, decode_pad_to=max_batch)
