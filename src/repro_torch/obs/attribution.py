"""Per-request latency waterfalls and per-tenant bottleneck rollups.

Each finished request's end-to-end latency (``t_finish - arrival``) is
decomposed into segments that sum back to it exactly (up to float
association):

- ``queue_wait``     — arrival/requeue until the scheduler admits it
- ``prefill``        — admission until the first decode step begins
  (or until P/D export on a prefill-role instance)
- ``pd_transfer``    — P/D KV handoff in flight (export → decode admit)
- ``decode``         — decode start until finish
- ``tier_restore``   — lower-tier KV fetch charge carved out of
  ``prefill`` (bounded by it: the restore is priced into whichever
  iteration runs next on the instance, so it is an attribution of
  intent, clamped to the prefill span it logically delays)
- ``preempt_redo``   — work thrown away by preemption/failure/drain:
  the span from the (re)admission that was interrupted back to the
  preemption instant

The decomposition is a deterministic walk over the request's lifecycle
events (admit / preempt / pd_export / pd_admit) with the final
prefill/decode split anchored on iteration spans: the decode start is
the start of the first decode-phase iteration containing the request
at or after its last admission.  Requests that never produce a decode
iteration (``output_len == 1``: the single token is emitted at prefill
completion) get ``decode = 0``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.events import (ADMIT, ITER, KV_RESTORE, PD_ADMIT,
                                    PD_EXPORT, PREEMPT, REQUEST_KINDS)

SEGMENTS = ("queue_wait", "prefill", "decode", "tier_restore",
            "pd_transfer", "preempt_redo")

#: slack for float round-trips when matching iteration starts
#: (``t_end - dur`` may land a hair before the admission timestamp)
_EPS = 1e-9


def _walk(req, evs: List) -> Tuple[dict, List[Tuple[float, float, str]],
                                   str, float, float]:
    """Walk one request's lifecycle events, closing segments at each
    transition.  Returns (segments, timeline, final_state,
    final_seg_start, restore_s)."""
    segs = {k: 0.0 for k in SEGMENTS}
    timeline: List[Tuple[float, float, str]] = []
    state = "queued"
    t0 = req.arrival
    restore_s = 0.0

    def close(t1: float, bucket: str) -> None:
        nonlocal t0
        if t1 > t0:
            segs[bucket] += t1 - t0
            timeline.append((t0, t1, bucket))
        t0 = t1

    for ev in evs:
        k = ev.kind
        if k == ADMIT:
            close(ev.t, "queue_wait")
            state = "active"
        elif k == PREEMPT:
            close(ev.t, "queue_wait" if state == "queued" else "preempt_redo")
            state = "queued"
        elif k == PD_EXPORT:
            close(ev.t, "prefill" if state == "active" else "preempt_redo")
            state = "transfer"
        elif k == PD_ADMIT:
            close(ev.t, "pd_transfer" if state == "transfer" else "queue_wait")
            state = "decode_active"
        elif k == KV_RESTORE:
            restore_s += (ev.payload or {}).get("seconds", 0.0)
    return segs, timeline, state, t0, restore_s


def attribution(requests: Iterable, recorder) -> dict:
    """Build ``metrics()["attribution"]`` from the event log.

    ``requests`` is the runtime's full request list; only finished
    requests (``t_finish`` set) are attributed.
    """
    by_req: Dict[int, List] = {}
    for ev in recorder.sorted_events():
        if ev.req is not None and ev.kind in REQUEST_KINDS:
            by_req.setdefault(ev.req, []).append(ev)

    finished = [r for r in requests if r.t_finish is not None]

    # first pass: walk lifecycles; remember which requests still need a
    # prefill/decode split anchored on iteration spans
    walked = {}
    need_decode_start: Dict[int, float] = {}
    for req in finished:
        segs, timeline, state, t0, restore_s = _walk(
            req, by_req.get(req.req_id, []))
        walked[req.req_id] = (req, segs, timeline, state, t0, restore_s)
        if state == "active":
            need_decode_start[req.req_id] = t0

    # second pass: one scan over iteration spans finds each pending
    # request's first decode-step start at/after its last admission
    decode_start: Dict[int, float] = {}
    if need_decode_start:
        for ev in recorder.events:
            if ev.kind != ITER:
                continue
            start = ev.t - ev.dur
            for rid, phase, _tok in (ev.payload or {}).get("items", ()):
                if phase != "decode" or rid not in need_decode_start:
                    continue
                if start >= need_decode_start[rid] - _EPS:
                    cur = decode_start.get(rid)
                    if cur is None or start < cur:
                        decode_start[rid] = start

    per_request = {}
    tenant_acc: Dict[str, dict] = {}
    for rid, (req, segs, timeline, state, t0, restore_s) in walked.items():
        tfin = req.t_finish
        if state == "decode_active":
            if tfin > t0:
                segs["decode"] += tfin - t0
                timeline.append((t0, tfin, "decode"))
        elif state == "active":
            # split the final active span; decode is the remainder so the
            # segment sum telescopes to t_finish - arrival by construction
            ds = decode_start.get(rid, tfin)
            ds = min(max(ds, t0), tfin)
            if ds > t0:
                segs["prefill"] += ds - t0
                timeline.append((t0, ds, "prefill"))
            if tfin > ds:
                segs["decode"] += tfin - ds
                timeline.append((ds, tfin, "decode"))
        else:  # queued/transfer at finish: defensive — should not happen
            if tfin > t0:
                segs["queue_wait"] += tfin - t0
                timeline.append((t0, tfin, "queue_wait"))
        carve = min(restore_s, segs["prefill"])
        if carve > 0.0:
            segs["prefill"] -= carve
            segs["tier_restore"] += carve
        total = tfin - req.arrival
        bottleneck = max(SEGMENTS, key=lambda k: segs[k])
        per_request[rid] = {"tenant": req.tenant, "total_s": total,
                            "segments": segs, "bottleneck": bottleneck,
                            "timeline": timeline}
        acc = tenant_acc.setdefault(req.tenant, {
            "requests": 0, "sum": {k: 0.0 for k in SEGMENTS},
            "bottlenecks": {}})
        acc["requests"] += 1
        for k in SEGMENTS:
            acc["sum"][k] += segs[k]
        acc["bottlenecks"][bottleneck] = \
            acc["bottlenecks"].get(bottleneck, 0) + 1

    tenants = {}
    for tenant, acc in sorted(tenant_acc.items()):
        n = acc["requests"]
        mean = {k: acc["sum"][k] / n for k in SEGMENTS}
        tenants[tenant] = {
            "requests": n,
            "mean_segments": mean,
            "dominant": max(SEGMENTS, key=lambda k: mean[k]),
            "bottleneck_counts": acc["bottlenecks"],
        }
    return {"segments": list(SEGMENTS),
            "requests": per_request,
            "tenants": tenants}
