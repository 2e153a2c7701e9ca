"""MoE expert routing, parallelism and offloading models (paper §II-C).

The *expert router* mimics a gate function statistically: given the batch's
token count it produces per-expert loads under a configurable distribution
(uniform / zipf-skewed / temporally-correlated). Expert-parallel compute time
is set by the most-loaded expert shard (imbalance factor), with an all-to-all
on both sides. Offloading supports host and PIM targets with optional
prefetch overlap (Pre-gated MoE [7] / Duplex [8] style studies).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.config import HardwareSpec, InstanceCfg, MoECfg, ModelSpec


def expert_capacity(tokens: int, top_k: int, n_experts: int,
                    capacity_factor: float) -> int:
    """Per-expert capacity-buffer size — the single definition shared by
    trace-driven pricing and the drop-rate metric, mirroring the real
    dispatch in ``repro_torch.models.moe.moe_ffn``
    (``C = round(T * top_k * cf / E)``, floored at 1)."""
    return int(max(1, round(tokens * top_k * capacity_factor
                            / max(n_experts, 1))))


def imbalance_factor(counts, ep: int = 1) -> float:
    """max-shard / mean-shard load with experts split over ``ep`` ranks.

    The one definition of the expert-parallel imbalance metric — shared by
    the statistical router below, the trace-driven expert-load accounting
    (``repro_torch.moe.ExpertLoadTracker``) and the cluster-level metric merge,
    so sim and real report comparable numbers.
    """
    counts = np.asarray(counts, float)
    ep = max(int(ep), 1)
    per_rank = np.array([c.sum() for c in np.array_split(counts, ep)])
    if per_rank.sum() <= 0:
        return 1.0
    return float(per_rank.max() / max(per_rank.mean(), 1e-9))


class ExpertRouter:
    """Statistical stand-in for the gate; pluggable like the real one."""

    def __init__(self, cfg: MoECfg, model: ModelSpec, seed: int = 0):
        self.cfg = cfg
        self.model = model
        self.rng = np.random.default_rng(seed)
        E = model.moe_experts
        if cfg.routing == "zipf":
            w = 1.0 / np.arange(1, E + 1) ** cfg.zipf_a
        else:
            w = np.ones(E)
        self.base_weights = w / w.sum()
        self._drift = np.ones(E) / E

    def route(self, tokens: int) -> np.ndarray:
        """Per-expert token counts for one MoE layer invocation."""
        E = self.model.moe_experts
        k = self.model.moe_top_k
        if tokens <= 0:
            return np.zeros(E)
        if self.cfg.routing == "correlated":
            # slowly drifting hot set (session affinity effects)
            self._drift = 0.95 * self._drift + 0.05 * self.rng.dirichlet(
                np.ones(E))
            p = self._drift / self._drift.sum()
        else:
            p = self.base_weights
        counts = self.rng.multinomial(tokens * k, p)
        return counts.astype(float)

    def imbalance(self, counts: np.ndarray, ep: int) -> float:
        """max-shard / mean-shard load with experts split over ep ranks."""
        return imbalance_factor(counts, ep)


@dataclasses.dataclass
class MoELayerCost:
    compute_s: float
    alltoall_s: float
    fetch_s: float        # expert weight fetch (offloading)
    overlapped_s: float   # what actually lands on the critical path

    @property
    def total(self) -> float:
        return self.overlapped_s


class ExpertExecutionModel:
    """Cost of one MoE FFN layer under EP + offloading."""

    def __init__(self, icfg: InstanceCfg, router: ExpertRouter,
                 pim: Optional[HardwareSpec] = None):
        self.icfg = icfg
        self.router = router
        self.model = icfg.model
        self.hw = icfg.hw
        self.pim = pim
        self.moe = icfg.moe

    def layer_cost(self, tokens: int,
                   counts: Optional[np.ndarray] = None,
                   capacity_factor: Optional[float] = None) -> MoELayerCost:
        """Cost of one MoE layer for ``tokens`` batch tokens.

        ``counts`` (per-expert token counts) overrides the statistical
        router — the trace-driven path: a replayed ``ExpertRoutingTrace``
        supplies the exact per-layer load, so imbalance, the active expert
        set, and offload fetch traffic are all priced from the trace.

        ``capacity_factor`` (trace-driven path only) clamps each expert's
        load at the standard top-k capacity ``C = round(tokens * top_k *
        cf / E)``: overflow tokens are *dropped* by the real engine's
        dispatch (they never reach the grouped GEMM), so a hot expert's
        compute saturates at C instead of growing unboundedly with skew —
        the drop rate itself is surfaced via
        ``ExpertLoadTracker.metrics()["drop_rate"]``.
        """
        m = self.model
        hw = self.hw
        ep = max(self.icfg.parallelism.ep, 1)
        if counts is None:
            counts = self.router.route(tokens)
        else:
            counts = np.asarray(counts, float)
            if capacity_factor and tokens > 0:
                counts = np.minimum(counts, expert_capacity(
                    tokens, m.moe_top_k, m.moe_experts, capacity_factor))
        kappa = imbalance_factor(counts, ep)
        # compute: top_k experts' FFN on the hottest shard
        flops = 2 * 3 * m.d_model * m.moe_d_expert * counts.sum() / ep * kappa
        active = (counts > 0).sum()
        w_bytes = m.expert_bytes() * active / ep
        t_compute = max(flops / (hw.peak_flops * hw.mmu_efficiency),
                        w_bytes / hw.hbm_bw)
        # all-to-all both directions (dispatch + combine)
        a2a_bytes = 2 * tokens * m.d_model * m.dtype_bytes
        t_a2a = a2a_bytes * (ep - 1) / max(ep, 1) / hw.link_bw if ep > 1 \
            else 0.0
        # offloading
        t_fetch = 0.0
        if self.moe.offload == "host" and self.moe.offload_fraction > 0:
            fetch_bytes = m.expert_bytes() * active \
                * self.moe.offload_fraction / ep
            t_fetch = fetch_bytes / hw.host_bw
        elif self.moe.offload == "pim" and self.pim is not None \
                and self.moe.offload_fraction > 0:
            # offloaded experts execute ON the memory-side device instead
            off_tokens = counts.sum() * self.moe.offload_fraction
            off_flops = 2 * 3 * m.d_model * m.moe_d_expert * off_tokens / ep
            off_bytes = m.expert_bytes() * active \
                * self.moe.offload_fraction / ep
            t_pim = max(off_flops / self.pim.peak_flops,
                        off_bytes / self.pim.hbm_bw)
            t_compute = max(t_compute * (1 - self.moe.offload_fraction),
                            t_pim)   # device + PIM run concurrently
        if self.moe.prefetch:
            crit = max(t_compute, t_fetch) + t_a2a
        else:
            crit = t_compute + t_fetch + t_a2a
        return MoELayerCost(compute_s=t_compute, alltoall_s=t_a2a,
                            fetch_s=t_fetch, overlapped_s=crit)
