"""Measure the simulator's error against the port's real engine on one card,
at full width, on a real request count.

    python3 tools/torch_fidelity.py [--n 64] [--seeds 0,1] [--reps 3]
        [--out FILE]

Profiles llama3.1-8b and phimini-moe as ``chip_smoke.py`` phase 5 does
(``profile --device h100 --mode measured --kernels`` through the profiler
CLI's ``main``: batch 8, max_len 2048, bf16, seeded weights, a grid that
covers the serve, each point the median of ``--reps`` timings), then, for
each seed, serves ``--n`` requests of phase 4's shape (ShareGPT-shaped,
prompts up to 1024 tokens, outputs up to 32, rate 10/s, chunked prefill
of 256, batch 8) in S(D), M(D), PD(D) and S(D)+PC (the prefix store, on
a variant of the requests of which 0.6 continue one of 4 conversations)
on llama3.1-8b and S(M) on phimini-moe, each beside its simulated twin
priced by that profile, both sides with an event recorder (each row
carries the attribution's segment totals).
Prints one line per configuration and seed (real and simulated TTFT p50,
TPOT mean and tokens/s, and the error of each), the mean and max error
per seed, and writes every row, with the profiles' whole-iteration
points, as JSON to ``--out``.  Phase 5's structural gates hold here too.  ``chip_smoke.py`` runs the same
code on 8 requests as a gate; this script is the measurement.  Needs one
CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64,
                    help="requests per configuration and seed")
    ap.add_argument("--seeds", default="0,1",
                    help="comma-separated workload seeds")
    ap.add_argument("--reps", type=int, default=3,
                    help="timings per profile point (the profiler's "
                         "default: 3)")
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "torch_fidelity.json"))
    a = ap.parse_args()
    seeds = [int(t) for t in a.seeds.split(",") if t.strip()]
    import torch
    if not torch.cuda.is_available():
        print("torch_fidelity: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.bench.fig2_fidelity import summarize
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    try:
        card = chip_smoke.card_and_setup(torch)
        traces = {}
        for arch, _ in chip_smoke.PATHS:
            traces[arch], _ = chip_smoke.profile_card(torch, ops, arch,
                                                      reps=a.reps)
            gc.collect()
            torch.cuda.empty_cache()
        runs = []
        for seed in seeds:
            _, rows = chip_smoke.fidelity_card(torch, ops, card, traces,
                                               n=a.n, seed=seed)
            runs.append({"seed": seed, "rows": rows, **summarize(rows)})
    except chip_smoke.SmokeFailure as e:
        print(f"torch_fidelity FAILED: {e}", file=sys.stderr)
        return 1
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    profiles = {arch: {"meta": t.meta, "points": [
        [p.op, p.phase, p.tokens, p.context, p.latency_s]
        for p in t.points if not p.op.startswith("kern:")]}
        for arch, t in traces.items()}
    out.write_text(json.dumps({"card": card, "n": a.n, "reps": a.reps,
                               "runs": runs, "profiles": profiles},
                              indent=1, default=float))
    print(f"torch_fidelity [{card}]: {a.n} requests, seeds {seeds}, "
          f"profile reps {a.reps}, "
          f"{time.perf_counter() - t0:.1f} s; rows in {out}")
    for r in runs:
        print(f"  seed {r['seed']}: TPOT and tokens/s error mean "
              f"{r['mean_err_pct']:.2f}%, max {r['max_err_pct']:.2f}%; TTFT "
              f"p50 error mean {r['ttft_mean_err_pct']:.2f}%, max "
              f"{r['ttft_max_err_pct']:.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
