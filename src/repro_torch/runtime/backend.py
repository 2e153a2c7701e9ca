"""The ``ExecutionBackend`` protocol: what the unified runtime needs from an
execution substrate.

The runtime (scheduler, prefix-cache policy, router, P/D orchestration)
makes every *decision*; a backend turns a decided batch into *time* — and,
for real backends, into actual tokens and KV state.  Two implementations
ship:

* ``repro_torch.runtime.backends.sim.SimBackend`` — prices batches with the
  trace-driven ``PerfModel`` (the discrete-event simulator).
* ``repro_torch.runtime.backends.jax_engine.JaxBackend`` — executes batches with
  jitted prefill/extend/decode over a slot-based KV cache and measures
  wall-clock latency (the real engine; virtual clocks come from the shared
  event queue).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Protocol, runtime_checkable

from repro_torch.core.memory import MemoryModel
from repro_torch.core.request import SimRequest
from repro_torch.runtime.prefix_cache import MatchResult
from repro_torch.runtime.scheduler import ScheduledWork


@dataclasses.dataclass
class KvHandoff:
    """A request's KV leaving one instance for another (P/D handoff).

    ``payload`` is backend-private (None for the simulator; real KV arrays +
    the first sampled token for the JAX engine).  ``nbytes`` is what the
    network model charges for the transfer.
    """
    nbytes: float
    payload: Optional[Any] = None


@runtime_checkable
class ExecutionBackend(Protocol):
    """Everything backend-specific about running one serving instance."""

    name: str
    memory: MemoryModel      # block pool the scheduler ledger draws from

    def warmup(self) -> None:
        """Pre-compile / pre-measure so steady-state latencies are clean."""
        ...

    def prompt_cap(self, req: SimRequest) -> Optional[int]:
        """Max prompt tokens this backend can hold for ``req`` (None =
        unbounded).  The runtime truncates the request on submission so
        scheduler bookkeeping and backend KV state always agree."""
        ...

    def execute(self, work: List[ScheduledWork], now: float) -> float:
        """Run one scheduled iteration; return its latency in seconds."""
        ...

    def on_prefix_hit(self, req: SimRequest, match: MatchResult,
                      usable: int) -> int:
        """A prefix-cache match was found for ``req``.  Return how many
        tokens the backend can actually serve from cache (<= ``usable``)
        and arrange any restore work / fetch pricing."""
        ...

    def on_prefill_complete(self, req: SimRequest) -> None:
        """Prompt fully in KV: persist the prefix payload if caching."""
        ...

    def on_preempt(self, req: SimRequest) -> int:
        """Request preempted; drop its KV.  Return the cached-prefix length
        still restorable when the request is rescheduled."""
        ...

    def release(self, req: SimRequest) -> None:
        """Request finished or left the instance: free backend state."""
        ...

    def export_kv(self, req: SimRequest) -> KvHandoff:
        """P/D: package the request's KV for transfer (frees local state)."""
        ...

    def import_kv(self, req: SimRequest, handoff: Optional[KvHandoff]) \
            -> None:
        """P/D decode side: land transferred KV before decoding starts."""
        ...

    def reset(self) -> None:
        """Instance failure: drop all backend state."""
        ...

    def stats(self) -> dict:
        ...
