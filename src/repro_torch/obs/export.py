"""Chrome trace-event / Perfetto JSON export and schema validation.

``chrome_trace(recorder)`` renders the event log as a Chrome
trace-event JSON object (load it at https://ui.perfetto.dev or
``chrome://tracing``):

- pid 0 ("fleet"): one thread lane per instance.  Iterations are
  complete-slices (``ph="X"``, micro-second ``ts``/``dur``) colored by
  the first request in the batch; admits, preemptions, tier moves,
  P/D handoffs, scale/autoscale actions are instants (``ph="i"``).
- pid 0, per-instance counter tracks (``ph="C"``): ``queue_depth``,
  ``batch`` (running), ``kv_used`` blocks, and per-tier KV residency;
  plus per-tenant ``inflight`` counters.
- pid 1 ("requests"): one lane per request rendering its attribution
  waterfall (queue_wait / prefill / decode / pd_transfer /
  preempt_redo slices), capped at ``max_request_lanes``.

``validate_chrome_trace(obj)`` checks the structural contract CI
relies on: every event has a known ``ph``; slices/instants/counters
carry numeric non-negative ``ts`` (and ``dur`` for slices) plus
``pid``/``tid``; counter tracks have non-decreasing timestamps.
"""
from __future__ import annotations

import json
from typing import List, Optional

from repro_torch.obs.events import (ADMIT, ARRIVAL, AUTOSCALE, FAIL,
                                    FINISH, ITER, KV_RESTORE, KV_TIER,
                                    PD_ADMIT, PD_EXPORT, PREEMPT, ROUTE,
                                    SCALE, SPEC_STEP)

#: Chrome's fixed reserved-color palette (only valid cnames render)
_CNAMES = ("thread_state_running", "thread_state_iowait",
           "thread_state_uninterruptible", "rail_response", "rail_animation",
           "rail_idle", "rail_load", "cq_build_running", "cq_build_passed",
           "cq_build_failed", "good", "bad", "terrible",
           "generic_work", "background_memory_dump", "light_memory_dump",
           "detailed_memory_dump", "vsync_highlight_color", "olive", "black")

_SEGMENT_CNAME = {"queue_wait": "rail_idle", "prefill": "rail_response",
                  "decode": "thread_state_running", "pd_transfer": "rail_load",
                  "preempt_redo": "bad", "tier_restore": "rail_animation"}

_US = 1e6


def _counter(name: str, ts: float, value, pid: int = 0, tid: int = 0) -> dict:
    return {"ph": "C", "pid": pid, "tid": tid, "name": name,
            "ts": ts, "args": {"value": value}}


def chrome_trace(recorder, max_request_lanes: int = 32) -> dict:
    """Render a recorder's event log as a Chrome trace-event dict."""
    evs = recorder.sorted_events()
    out: List[dict] = []

    # lane bookkeeping: tid 0 is the cluster lane, instances follow in
    # order of first appearance
    tids = {"": 0}

    def tid_of(inst: Optional[str]) -> int:
        lane = inst or ""
        if lane not in tids:
            tids[lane] = len(tids)
        return tids[lane]

    for ev in evs:
        ts = ev.t * _US
        tid = tid_of(ev.inst)
        p = ev.payload or {}
        args = dict(p)
        if ev.req is not None:
            args["req"] = ev.req
        if ev.tenant is not None:
            args["tenant"] = ev.tenant
        if ev.wall is not None:
            args["wall_s"] = ev.wall
        if ev.kind == ITER:
            items = p.get("items", ())
            first_req = items[0][0] if items else 0
            name = f"{ev.phase or 'iter'} b={p.get('running', len(items))}"
            args["items"] = [list(it) for it in items]
            out.append({"ph": "X", "pid": 0, "tid": tid, "name": name,
                        "cat": "iter", "ts": (ev.t - ev.dur) * _US,
                        "dur": ev.dur * _US,
                        "cname": _CNAMES[first_req % len(_CNAMES)],
                        "args": args})
            out.append(_counter(f"{ev.inst}/queue_depth", ts,
                                p.get("waiting", 0)))
            out.append(_counter(f"{ev.inst}/batch", ts, p.get("running", 0)))
            out.append(_counter(f"{ev.inst}/kv_used", ts, p.get("kv_used", 0)))
        elif ev.kind in (ADMIT, PREEMPT, KV_RESTORE, KV_TIER, PD_EXPORT,
                         PD_ADMIT, FINISH, ROUTE, SCALE, FAIL, AUTOSCALE,
                         SPEC_STEP):
            out.append({"ph": "i", "pid": 0, "tid": tid, "name": ev.kind,
                        "cat": ev.kind, "ts": ts, "s": "t", "args": args})
            if ev.kind == KV_TIER and "residency" in p:
                for tier, blocks in p["residency"].items():
                    out.append(_counter(f"{ev.inst}/kv_{tier}", ts, blocks))

    # per-tenant inflight counters (derived step function)
    inflight = {}
    for ev in evs:
        if ev.tenant is None:
            continue
        if ev.kind == ARRIVAL:
            inflight[ev.tenant] = inflight.get(ev.tenant, 0) + 1
        elif ev.kind == FINISH:
            inflight[ev.tenant] = inflight.get(ev.tenant, 0) - 1
        else:
            continue
        out.append(_counter(f"tenant/{ev.tenant}/inflight", ev.t * _US,
                            inflight[ev.tenant]))

    # request waterfall lanes (pid 1) from the attribution timelines
    from repro_torch.obs.attribution import attribution

    class _Req:
        __slots__ = ("req_id", "arrival", "t_finish", "tenant")

    reqs = {}
    for ev in evs:
        if ev.req is None:
            continue
        r = reqs.get(ev.req)
        if r is None:
            r = reqs[ev.req] = _Req()
            r.req_id, r.arrival, r.tenant = ev.req, ev.t, ev.tenant
            r.t_finish = None
        if ev.kind == ARRIVAL:
            r.arrival = ev.t
        if r.tenant is None and ev.tenant is not None:
            r.tenant = ev.tenant
        if ev.kind == FINISH:
            r.t_finish = ev.t
    attr = attribution(list(reqs.values()), recorder)
    shown = 0
    for rid, rep in attr["requests"].items():
        if shown >= max_request_lanes:
            break
        shown += 1
        rtid = shown
        out.append({"ph": "M", "pid": 1, "tid": rtid,
                    "name": "thread_name", "args":
                    {"name": f"req {rid} ({rep['tenant']})"}})
        for t0, t1, label in rep["timeline"]:
            out.append({"ph": "X", "pid": 1, "tid": rtid, "name": label,
                        "cat": "request", "ts": t0 * _US,
                        "dur": (t1 - t0) * _US,
                        "cname": _SEGMENT_CNAME.get(label, "generic_work"),
                        "args": {"req": rid, "tenant": rep["tenant"]}})

    meta = [{"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
             "args": {"name": "fleet"}},
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "requests"}}]
    for lane, tid in tids.items():
        meta.append({"ph": "M", "pid": 0, "tid": tid, "name": "thread_name",
                     "args": {"name": lane or "cluster"}})
    meta.append({"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
                 "args": {"name": f"waterfalls ({shown} of "
                                  f"{len(attr['requests'])} requests)"}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms",
            "otherData": {"schema": "repro_torch.obs/1",
                          "events": len(recorder.events),
                          "requests_total": len(attr["requests"]),
                          "requests_shown": shown}}


def write_chrome_trace(recorder, path: str,
                       max_request_lanes: int = 32) -> dict:
    trace = chrome_trace(recorder, max_request_lanes=max_request_lanes)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def validate_chrome_trace(obj) -> List[str]:
    """Return a list of schema violations (empty == valid)."""
    errors: List[str] = []
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        return ["top-level object must carry a traceEvents list"]
    last_counter_ts = {}
    for i, ev in enumerate(obj["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict) or "ph" not in ev:
            errors.append(f"{where}: missing ph")
            continue
        ph = ev["ph"]
        if ph not in ("M", "X", "i", "C", "B", "E"):
            errors.append(f"{where}: unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        for field in ("pid", "tid"):
            if not isinstance(ev.get(field), int):
                errors.append(f"{where}: {field} must be an int")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}: ts must be a non-negative number")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: X needs non-negative dur")
            if not ev.get("name"):
                errors.append(f"{where}: X needs a name")
        if ph == "C":
            name = ev.get("name")
            if not name:
                errors.append(f"{where}: C needs a name")
                continue
            if "args" not in ev or not isinstance(ev["args"], dict):
                errors.append(f"{where}: C needs an args dict")
                continue
            key = (ev.get("pid"), name)
            prev = last_counter_ts.get(key)
            if prev is not None and ts < prev:
                errors.append(f"{where}: counter {name!r} ts went backwards "
                              f"({ts} < {prev})")
            last_counter_ts[key] = ts
    return errors
