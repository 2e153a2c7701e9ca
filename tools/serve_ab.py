"""Serve the same workload from two checkouts of the repo, in turns, on
one card.

    python3 tools/serve_ab.py --base DIR [--arch phimini-moe] [--pairs 10]

``DIR`` is another checkout, e.g. the parent commit unpacked with
``git archive``.  Runs ``--pairs`` pairs of serves, base and this, each in
a process of its own, alternating which side runs first (base/this,
this/base, ...).  Each serves ``chip_smoke.py``'s full-width workload (8
requests, chunked prefill of 256, batch 8; for zamba2-1.2b and
xlstm-125m phase 7's, ``recurrent_serve_setup``) once, from fresh seeded
weights, behind a warmed-up driver.  Prints every serve's TTFT p50, TPOT
p50, output tokens/s and wall; then, per metric, each side's median and
quartiles, the pairs this side wins (ties count for neither), and whether
that is a gain: a win in at least nine tenths of the pairs and medians
further apart than the base's own quartiles.  The host's speed differs
from machine to machine, so two versions are compared only within one call
of this script.  Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def serve(root: Path, arch: str) -> int:
    """Child: serve once from the checkout at ``root``."""
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    chip_smoke.card_and_setup(torch)
    setup = chip_smoke.recurrent_serve_setup if arch in RECURRENT else \
        chip_smoke.full_serve_setup
    _, eng, drv, reqs = setup(torch, arch)
    t0 = time.perf_counter()
    drv.run(reqs, warmup=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = drv.finished
    print("SERVE " + json.dumps({
        "ttft_ms": 1e3 * statistics.median(r.ttft() for r in done),
        "tpot_ms": 1e3 * statistics.median(
            r.tpot() for r in done if r.tpot() is not None),
        "tok_s": sum(r.output_len for r in done) / wall,
        "wall_s": wall, "finished": len(done)}), flush=True)
    return 0


#: the archs phase 7 serves (``chip_smoke.recurrent_serve_setup``)
RECURRENT = ("zamba2-1.2b", "xlstm-125m")
#: metric -> True where higher is better
METRICS = {"ttft_ms": False, "tpot_ms": False, "tok_s": True,
           "wall_s": False}


def verdict(base: list, this: list) -> list:
    """Per metric: medians, quartiles, wins of ``this`` over ``base`` pair
    by pair, and whether that makes a gain."""
    out = []
    for k, higher in METRICS.items():
        b = [m[k] for m in base]
        t = [m[k] for m in this]
        bq, tq = statistics.quantiles(b, n=4), statistics.quantiles(t, n=4)
        wins = sum((y > x) if higher else (y < x) for x, y in zip(b, t))
        gain = (wins >= 0.9 * len(b) and abs(tq[1] - bq[1]) > bq[2] - bq[0])
        out.append(f"{k}: base median {bq[1]:.3f} (quartiles {bq[0]:.3f}-"
                   f"{bq[2]:.3f}), this median {tq[1]:.3f} (quartiles "
                   f"{tq[0]:.3f}-{tq[2]:.3f}); this wins {wins} of {len(b)} "
                   f"pairs; gain: {'yes' if gain else 'no'}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path, help="the other checkout")
    ap.add_argument("--arch", default="phimini-moe",
                    choices=("llama3.1-8b", "phimini-moe") + RECURRENT)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--serve", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.serve is not None:
        return serve(args.serve.resolve(), args.arch)
    if args.base is None:
        ap.error("--base is required")
    if args.pairs < 2:
        ap.error("--pairs must be at least 2")
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 2
    sides = {"base": args.base.resolve(), "this": ROOT}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    runs = {"base": [], "this": []}
    for pair in range(args.pairs):
        order = ("base", "this") if pair % 2 == 0 else ("this", "base")
        for label in order:
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--serve",
                 str(sides[label]), "--arch", args.arch],
                capture_output=True, text=True, timeout=600)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("SERVE ")]
            if proc.returncode != 0 or len(lines) != 1:
                print(proc.stdout[-3000:] + proc.stderr[-3000:],
                      file=sys.stderr)
                return 1
            m = json.loads(lines[0][6:])
            if m["finished"] != 8:
                print(f"serve_ab: {label} finished {m['finished']} of 8",
                      file=sys.stderr)
                return 1
            runs[label].append(m)
            print(f"[{card}] {args.arch} pair {pair} {label}: TTFT p50 "
                  f"{m['ttft_ms']:.1f} ms, TPOT p50 {m['tpot_ms']:.2f} ms, "
                  f"{m['tok_s']:.1f} tok/s, wall {m['wall_s']:.3f} s",
                  flush=True)
    for line in verdict(runs["base"], runs["this"]):
        print(f"[{card}] {args.arch} {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
