"""Unified runtime event tracing: Perfetto timelines, per-request
waterfalls, and simulated-time series on both backends.

Enable by passing an :class:`EventRecorder` (or an output path) to
``repro_torch.core.simulate(..., trace=...)``, ``Cluster(...,
recorder=...)``, or ``ServeDriver(..., recorder=...)``.  Disabled is
the default and costs nothing: the runtime's ``obs`` attributes stay
``None`` and every emission site is guarded.

Inside the real engine's iteration, ``span`` (``obs.spans``) names the
host's work on any ``torch.profiler`` trace of a serve, and each ``iter``
event carries the iteration's blocking waits (``Event.host``).
"""
from repro_torch.obs.attribution import SEGMENTS, attribution
from repro_torch.obs.events import Event
from repro_torch.obs.export import (chrome_trace, validate_chrome_trace,
                              write_chrome_trace)
from repro_torch.obs.record import EventRecorder
from repro_torch.obs.spans import Waits, span

__all__ = ["Event", "EventRecorder", "attribution", "SEGMENTS",
           "chrome_trace", "write_chrome_trace", "validate_chrome_trace",
           "span", "Waits"]
