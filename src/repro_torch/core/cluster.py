"""Cluster simulation driver: the unified ``ServingRuntime`` specialized to
the simulation backend.  ``simulate(requests)`` is the main entry point used
by every benchmark and example; the real-engine twin is
``repro_torch.serve.ServeDriver`` — same scheduler, cache, router and P/D code
path, different ``ExecutionBackend``.

``fast_path`` (default on) enables the simulator's iteration-cost memo and
decode fast-forward; it is decision- and metric-identical to the stepped
exact mode (``fast_path=False``), which remains available as the reference
for the parity suite and for debugging event-by-event timelines.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Sequence

from repro_torch.core.config import ClusterCfg
from repro_torch.core.trace import TraceRegistry
from repro_torch.runtime.backends.sim import SimBackend
from repro_torch.runtime.cluster import ServingRuntime
from repro_torch.workload.sharegpt import Request

if TYPE_CHECKING:
    from repro_torch.hw.registry import HardwareRegistry


class Cluster(ServingRuntime):
    def __init__(self, cfg: ClusterCfg,
                 traces: Optional[TraceRegistry] = None,
                 hw: Optional["HardwareRegistry"] = None,
                 fast_path: bool = True,
                 recorder=None):
        super().__init__(
            cfg,
            backend_factory=lambda icfg, trace: SimBackend(
                icfg, trace=trace, fast_path=fast_path),
            traces=traces, hw=hw, recorder=recorder)


def simulate(cfg: ClusterCfg, requests: Sequence[Request],
             traces: Optional[TraceRegistry] = None,
             hw: Optional["HardwareRegistry"] = None,
             until: Optional[float] = None,
             fast_path: bool = True,
             autoscale=None,
             trace=None) -> Dict:
    """Run the workload to completion.  ``autoscale`` optionally attaches
    an SLO autoscaler (metrics land under ``metrics()["autoscale"]``).

    ``trace`` enables runtime event tracing (``docs/observability.md``):
    pass a ``repro_torch.obs.EventRecorder`` to keep the event log in hand, or
    a path string to write a Perfetto-loadable Chrome trace JSON there.
    Either way ``metrics()["attribution"]`` carries the per-request
    latency waterfalls.  ``None`` (default) records nothing and costs
    nothing.
    """
    recorder, trace_path = None, None
    if trace is not None:
        # lazy import: repro_torch.core must not pull higher layers at
        # load time
        from repro_torch.obs.record import EventRecorder
        if isinstance(trace, EventRecorder):
            recorder = trace
        else:
            trace_path = str(trace)
            recorder = EventRecorder()
    cluster = Cluster(cfg, traces=traces, hw=hw, fast_path=fast_path,
                      recorder=recorder)
    if autoscale is not None:
        cluster.attach_autoscaler(autoscale)
    cluster.submit_workload(requests)
    m = cluster.run(until=until)
    if trace_path is not None:
        from repro_torch.obs.export import write_chrome_trace
        write_chrome_trace(recorder, trace_path)
    return m
