"""CLI: turn raw event logs into Perfetto traces, or validate traces.

    python -m repro_torch.obs export --events events.json --out trace.json
    python -m repro_torch.obs validate trace.json
    python -m repro_torch.obs series --events events.json --interval 0.5
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.export import chrome_trace, validate_chrome_trace
from repro_torch.obs.record import EventRecorder


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("export", help="raw event log -> Chrome trace JSON")
    pe.add_argument("--events", required=True,
                    help="raw event log (EventRecorder.save / --events)")
    pe.add_argument("--out", required=True, help="output trace JSON path")
    pe.add_argument("--requests", type=int, default=32,
                    help="max per-request waterfall lanes (default 32)")

    pv = sub.add_parser("validate",
                        help="check a trace against the Chrome schema")
    pv.add_argument("trace", help="trace JSON path")

    ps = sub.add_parser("series", help="print simulated-time-series gauges")
    ps.add_argument("--events", required=True)
    ps.add_argument("--interval", type=float, default=1.0,
                    help="sim-time sampling cadence in seconds")

    args = p.parse_args(argv)
    if args.cmd == "export":
        rec = EventRecorder.load(args.events)
        trace = chrome_trace(rec, max_request_lanes=args.requests)
        errors = validate_chrome_trace(trace)
        if errors:
            for e in errors:
                print(f"error: {e}", file=sys.stderr)
            return 1
        with open(args.out, "w") as f:
            json.dump(trace, f)
        print(f"wrote {args.out}: {len(trace['traceEvents'])} trace events "
              f"from {len(rec.events)} runtime events")
        return 0
    if args.cmd == "validate":
        with open(args.trace) as f:
            obj = json.load(f)
        errors = validate_chrome_trace(obj)
        for e in errors:
            print(f"error: {e}", file=sys.stderr)
        if not errors:
            print(f"{args.trace}: ok "
                  f"({len(obj.get('traceEvents', []))} events)")
        return 1 if errors else 0
    if args.cmd == "series":
        rec = EventRecorder.load(args.events)
        json.dump(rec.series(args.interval), sys.stdout)
        print()
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
