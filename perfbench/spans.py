"""The program's own spans in a traced run: where the card's idle time
falls (inside model calls, in the backend's staging around them, in the
rest of an iteration, between iterations), how long the host takes to
issue a decode call, and which spans the host's time and the card's
operations go to.

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s>

serves one traced window of the cell (``harness.serve`` as ``--trace 1``
runs it, with no comparison against the reference) under a capture that
also keeps the program's ``repro_torch.*`` ranges (``repro_torch.obs.
spans``) and the CUDA runtime's and driver's calls (``cu*``) with their
correlation ids, and prints one JSON line: the cell's per-layer metrics
and, under ``spans``,

- ``idle_in_model_call_share``: percent of the profiled stretch with no
  device operation running, inside the union of the ``model.*`` spans;
- ``idle_in_staging_share``: the same inside ``backend.*`` spans but
  outside every ``model.*`` span;
- ``idle_in_iteration_rest_share``: inside the harness's
  ``perfbench.execute.*`` spans but outside both;
- ``idle_between_iterations_share``: outside all of them (the four sum to
  ``device_idle_share``; exact intervals, no midpoints);
- ``decode_dispatch_ms``: the mean ``model.decode`` span (the host's time
  to issue one decode call, which waits on nothing);
- ``iter_ms``: the mean ``perfbench.execute.*`` span (what the spans cost
  when on shows as this, against a program without them);
- ``host_spans``: the top spans by self time, each ``[name, calls, self
  ms, launches, device ms]``, the launches and their device time those
  issued from the span's self time, matched by correlation id.

The benchmark's runs do not run it: their capture (``tracing.Capture``)
keeps neither the program's ranges nor the launches.  Against a program
without spans every span number is None and ``host_spans`` is empty.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.tracing import _DEVICE_KINDS, Capture, Profile  # noqa: E402

PREFIX = "repro_torch."

Intervals = List[Tuple[int, int]]


@dataclasses.dataclass
class SpanProfile(Profile):
    #: the program's ranges, (start, end, name without ``repro_torch.``,
    #: nesting depth), ns
    host_spans: List[Tuple[int, int, str, int]] = \
        dataclasses.field(default_factory=list)
    #: (start, correlation id) of each launch that made a device operation
    launches: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    #: correlation id -> device ns of the operations it made
    launched: Dict[int, int] = dataclasses.field(default_factory=dict)


def _depths(spans) -> List[Tuple[int, int, str, int]]:
    out, ends = [], []
    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        while ends and ends[-1] <= s:
            ends.pop()
        out.append((s, e, n, len(ends)))
        ends.append(e)
    return out


class SpanCapture(Capture):
    """``tracing.Capture`` whose profile also holds the program's ranges
    and the launches; each reduced profile is appended to ``sink``."""

    def __init__(self, sink: Optional[list] = None):
        super().__init__()
        self.sink = sink

    def reduce(self) -> SpanProfile:
        base = super().reduce()
        t0 = time.perf_counter()
        lo, hi = base.window
        cuda = torch.autograd.DeviceType.CUDA
        spans, launches, launched = [], {}, {}
        for e in self.prof.profiler.kineto_results.events():
            s = e.start_ns()
            if not lo <= s < hi:
                continue
            name = e.name()
            if e.device_type() == cuda:
                # the device operations ``Capture.reduce`` keeps
                kind = getattr(e, "activity_type", None)
                kind = kind() if callable(kind) else None
                if kind in _DEVICE_KINDS or kind is None \
                        and not name.startswith(("perfbench.", PREFIX)):
                    c = e.correlation_id()
                    launched[c] = launched.get(c, 0) + e.duration_ns()
            elif name.startswith(PREFIX):
                spans.append((s, s + e.duration_ns(), name[len(PREFIX):]))
            elif name.startswith("cu"):
                # a runtime or driver call; it launched something if a
                # device operation carries its correlation id
                launches.setdefault(e.correlation_id(), s)
        p = SpanProfile(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(Profile)},
            host_spans=_depths(spans),
            launches=sorted((s, c) for c, s in launches.items()
                            if c in launched),
            launched=launched)
        self.reduce_s += time.perf_counter() - t0
        if self.sink is not None:
            self.sink.append(p)
        return p


# --------------------------------------------------------------------------
# interval arithmetic (sorted, disjoint, half-open intervals in ns)
# --------------------------------------------------------------------------

def union(intervals) -> Intervals:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def complement(a: Intervals, lo: int, hi: int) -> Intervals:
    out, at = [], lo
    for s, e in a:
        s, e = max(s, lo), min(e, hi)
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def intersect(a: Intervals, b: Intervals) -> Intervals:
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(a: Intervals) -> int:
    return sum(e - s for s, e in a)


# --------------------------------------------------------------------------
# the numbers
# --------------------------------------------------------------------------

def _named(p: SpanProfile, prefix: str) -> Intervals:
    return union((s, e) for s, e, n, _ in p.host_spans
                 if n.startswith(prefix))


def idle_split(p: SpanProfile) -> Optional[Dict[str, float]]:
    """Percent of the profiled stretch with no device operation running,
    split by where the host was: inside a model call, in the backend
    outside one, in the rest of an iteration, between iterations.  None
    without a device operation or without the program's spans."""
    lo, hi = p.window
    if not p.device or hi <= lo or not _named(p, "model."):
        return None
    idle = complement(p.busy_intervals(), lo, hi)
    model = _named(p, "model.")
    backend = union(_named(p, "backend.") + model)
    iteration = union(backend + [(s, e) for s, e, _ in p.spans])
    parts = {
        "idle_in_model_call_share": intersect(idle, model),
        "idle_in_staging_share": intersect(
            idle, intersect(backend, complement(model, lo, hi))),
        "idle_in_iteration_rest_share": intersect(
            idle, intersect(iteration, complement(backend, lo, hi))),
        "idle_between_iterations_share": intersect(
            idle, complement(iteration, lo, hi)),
    }
    return {k: 100.0 * length(v) / (hi - lo) for k, v in parts.items()}


def decode_dispatch_ms(p: SpanProfile) -> Optional[float]:
    d = [e - s for s, e, n, _ in p.host_spans if n == "model.decode"]
    return 1e-6 * sum(d) / len(d) if d else None


def iter_ms(p: Profile) -> Optional[float]:
    d = [e - s for s, e, _ in p.spans]
    return 1e-6 * sum(d) / len(d) if d else None


def host_span_table(p: SpanProfile, top: int = 15) -> List[list]:
    """The spans with the most self time (their own less their child
    spans'), each ``[name, calls, self ms, launches, device ms]``: the
    launches made in the span's self time and the device time of the
    operations they made."""
    stats: Dict[str, List[float]] = {}
    stack: List[list] = []                 # [end, name, start, child ns]
    launches = iter(sorted(p.launches))
    nxt = next(launches, None)

    def close(t):
        while stack and stack[-1][0] <= t:
            end, name, start, child = stack.pop()
            stats[name][1] += end - start - child
            if stack:
                stack[-1][3] += end - start

    def issue(t):
        nonlocal nxt
        while nxt is not None and nxt[0] < t:
            close(nxt[0])
            if stack:
                st = stats[stack[-1][1]]
                st[2] += 1
                st[3] += p.launched[nxt[1]]
            nxt = next(launches, None)

    for s, e, name, _ in sorted(p.host_spans, key=lambda x: (x[0], -x[1])):
        issue(s)
        close(s)
        stats.setdefault(name, [0, 0, 0, 0])[0] += 1
        stack.append([e, name, s, 0])
    issue(float("inf"))
    close(float("inf"))
    rows = sorted(stats.items(), key=lambda x: -x[1][1])[:top]
    return [[n, int(c), 1e-6 * own, int(k), 1e-6 * dev]
            for n, (c, own, k, dev) in rows]


def numbers(p: SpanProfile) -> dict:
    return dict(idle_split(p) or {}, decode_dispatch_ms=decode_dispatch_ms(p),
                iter_ms=iter_ms(p), iters=len(p.spans),
                host_spans=host_span_table(p))


# --------------------------------------------------------------------------
# the command
# --------------------------------------------------------------------------

def run(cell, seed: int, seconds: float, device, t_start: float) -> dict:
    """One traced window of ``cell``, the harness capturing with
    ``SpanCapture`` for its length."""
    from perfbench import harness
    sink: List[SpanProfile] = []
    saved = harness.Capture
    harness.Capture = functools.partial(SpanCapture, sink=sink)
    try:
        s = harness.serve(cell, seed, seconds, True, device, t_start)
    finally:
        harness.Capture = saved
    out = {"workload": cell.name, "seed": seed,
           "metrics": {k: v["value"] for k, v in s.out["metrics"].items()},
           "device": s.out["device"], "unfinished": s.unfinished}
    if sink:
        out["spans"] = numbers(sink[-1])
    return out


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(prog="perfbench/spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from perfbench import cells
    cell = cells.load(ROOT, args.workload)
    print(json.dumps(run(cell, args.seed, args.seconds, args.device,
                         t_start)), flush=True)
    return 0


if __name__ == "__main__":
    from perfbench.run import _environment
    _environment()
    sys.exit(main())
