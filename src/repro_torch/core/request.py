"""Simulated request lifecycle + per-request metrics."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

QUEUED = "queued"
PREFILLING = "prefilling"
TRANSFERRING = "transferring"   # P/D disaggregation KV move
DECODING = "decoding"
PREEMPTED = "preempted"
FINISHED = "finished"
FAILED = "failed"


@dataclasses.dataclass
class SimRequest:
    req_id: int
    arrival: float
    prompt_tokens: Sequence[int]
    output_len: int
    model: str = "default"

    # multi-tenant class identity (repro_torch.core.config.TenantClass): the
    # priority keys the ``policy="priority"`` scheduler, the weight feeds
    # its starvation guard, and the SLO targets drive the per-tenant
    # attainment/goodput rollup (``metrics()["tenants"]``) plus the
    # SLO-aware autoscaler.
    tenant: str = "default"
    priority: int = 0
    weight: float = 1.0
    slo_ttft_ms: float = 2000.0
    slo_tpot_ms: float = 200.0

    state: str = QUEUED
    instance: Optional[str] = None
    decode_instance: Optional[str] = None

    prefill_done_tokens: int = 0     # chunked prefill progress
    cached_prefix: int = 0           # tokens served from prefix cache
    generated: int = 0

    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    n_preemptions: int = 0
    n_restarts: int = 0              # node-failure recoveries
    kv_blocks_peak: int = 0          # max KV blocks the ledger ever held

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)

    @property
    def context_len(self) -> int:
        return self.prompt_len + self.generated

    @property
    def remaining_prefill(self) -> int:
        return max(0, self.prompt_len - self.cached_prefix
                   - self.prefill_done_tokens)

    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival

    def tpot(self) -> Optional[float]:
        """Time per output token after the first (paper Fig 2a)."""
        if self.t_finish is None or self.t_first_token is None \
                or self.output_len <= 1:
            return None
        return (self.t_finish - self.t_first_token) / (self.output_len - 1)

    def itl(self) -> List[float]:
        return [t2 - t1 for t1, t2 in zip(self.token_times,
                                          self.token_times[1:])]
