"""Paged KV-cache memory model (PagedAttention semantics) + memory tiers.

Device HBM holds model weights + a block pool for KV pages; the prefix cache
borrows idle pool blocks (paper §II-D: first-tier cache in device memory,
eviction spills to host, optionally SSD). Transfers between tiers produce
latency events through ``transfer_time``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.config import HardwareSpec, InstanceCfg, ModelSpec


@dataclasses.dataclass
class TierStats:
    capacity: float
    used: float = 0.0


class MemoryModel:
    def __init__(self, cfg: InstanceCfg):
        self.cfg = cfg
        hw = cfg.hw
        model = cfg.model
        self.block_tokens = cfg.kv_block_tokens
        self.kv_bytes_per_token = model.kv_bytes_per_token / max(
            cfg.parallelism.tp, 1)  # per-device share
        weight_bytes = model.weight_bytes() / max(
            cfg.parallelism.tp * cfg.parallelism.pp, 1)
        if cfg.moe.offload != "none" and model.is_moe:
            off = cfg.moe.offload_fraction
            expert_total = (model.expert_bytes() * model.moe_experts
                            * model.n_layers) / max(cfg.parallelism.tp, 1)
            weight_bytes -= expert_total * off
        self.weight_bytes = max(weight_bytes, 0.0)
        budget = hw.hbm_capacity * 0.9 - self.weight_bytes
        if budget <= 0:
            raise ValueError(
                f"model does not fit: weights {self.weight_bytes/1e9:.1f}GB "
                f"> HBM {hw.hbm_capacity/1e9:.1f}GB (instance {cfg.name})")
        self.bytes_per_block = self.kv_bytes_per_token * self.block_tokens
        self.total_blocks = int(budget / self.bytes_per_block)
        self.free_blocks = self.total_blocks
        self.cache_blocks_used = 0       # prefix-cache borrowed blocks
        self.host = TierStats(hw.host_capacity)
        self.ssd = TierStats(hw.ssd_capacity)
        self.hw = hw
        self.peak_used = 0

    # ---- block pool ----
    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block_tokens)

    def can_allocate(self, tokens: int) -> bool:
        return self.blocks_for(tokens) <= self.free_blocks

    def allocate(self, tokens: int) -> bool:
        n = self.blocks_for(tokens)
        if n > self.free_blocks:
            return False
        self.free_blocks -= n
        self.peak_used = max(self.peak_used,
                             self.total_blocks - self.free_blocks)
        return True

    def free(self, tokens: int):
        self.free_blocks = min(self.total_blocks,
                               self.free_blocks + self.blocks_for(tokens))

    # block-granular API (the scheduler's reservation ledger)
    def allocate_blocks(self, n: int) -> bool:
        if n > self.free_blocks:
            return False
        self.free_blocks -= n
        self.peak_used = max(self.peak_used,
                             self.total_blocks - self.free_blocks)
        return True

    def release_blocks(self, n: int):
        self.free_blocks = min(self.total_blocks, self.free_blocks + n)

    def utilization(self) -> float:
        return 1.0 - self.free_blocks / max(self.total_blocks, 1)

    # ---- prefix cache borrowing ----
    def cache_capacity_blocks(self, fraction: float) -> int:
        return int(self.total_blocks * fraction)

    def borrow_for_cache(self, blocks: int) -> bool:
        if blocks > self.free_blocks:
            return False
        self.free_blocks -= blocks
        self.cache_blocks_used += blocks
        return True

    def return_from_cache(self, blocks: int):
        take = min(blocks, self.cache_blocks_used)
        self.cache_blocks_used -= take
        self.free_blocks += take

    # ---- lower-tier pools (prefix-cache spill targets) ----
    def tier(self, name: str) -> TierStats:
        if name == "host":
            return self.host
        if name == "ssd":
            return self.ssd
        raise KeyError(f"unknown memory tier {name!r} (host | ssd)")

    def tier_reserve(self, name: str, n_bytes: float) -> bool:
        """Claim ``n_bytes`` in a lower tier; False when it would not fit."""
        ts = self.tier(name)
        if ts.used + n_bytes > ts.capacity:
            return False
        ts.used += n_bytes
        return True

    def tier_release(self, name: str, n_bytes: float):
        ts = self.tier(name)
        ts.used = max(0.0, ts.used - n_bytes)

    def tier_stats(self) -> Dict[str, Dict[str, float]]:
        return {
            "host": {"capacity": self.host.capacity, "used": self.host.used},
            "ssd": {"capacity": self.ssd.capacity, "used": self.ssd.used},
        }

    # ---- tier transfers ----
    def transfer_time(self, n_bytes: float, src: str, dst: str) -> float:
        """device<->host<->ssd transfer latency (bandwidth-limited)."""
        path_bw = {
            ("device", "host"): self.hw.host_bw,
            ("host", "device"): self.hw.host_bw,
            ("host", "ssd"): self.hw.ssd_bw,
            ("ssd", "host"): self.hw.ssd_bw,
            ("ssd", "device"): min(self.hw.ssd_bw, self.hw.host_bw),
            ("device", "ssd"): min(self.hw.ssd_bw, self.hw.host_bw),
        }[(src, dst)]
        return n_bytes / path_bw
