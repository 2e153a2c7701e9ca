"""Readings that set a cell's limits in ``perfbench/limits/``, and its knee.

    python3 perfbench/calibrate.py gaps --workload <cell> --seeds 1,2,3 \
        --seconds 8 [--control] [--witness] [--rate R] [--dtype float32]
    python3 perfbench/calibrate.py sweep --workload <cell> --seed 1 \
        --rates 1.0,2.0,3.0 --seconds 40

``gaps``: for each seed, one process serves a short window of the cell at
its own load (the timed path, as a run does), takes the sample a run
takes, and prints one JSON line of statistics of the served tokens' gaps
against the float32 reference of the configuration's family (the
program's readings); with ``--control``, of the tokens that the
reference computed through float8 (e4m3) projections puts first (the
control's); with ``--witness``, of the program's own whole-sequence
forward.  ``--dtype float32`` serves
the program in float32 (a second witness).

``sweep``: the open-loop cell at each offered rate (requests a second of
the runtime's clock): the cell's end-to-end metrics, the requests of the
window, those left unfinished after a short drain, and the queue of
requests not yet admitted at the window's open and close.  The knee is
the highest rate whose queue does not grow over the window; windows of
20 s hide a slow growth.

Neither is run by the benchmark's own runs.
"""
import argparse
import copy
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def witness(cell, params, seqs, want):
    """The program's own whole-sequence forward (``Model.forward``: flash
    prefill, no cache) in the served type, one sequence at a time: the
    logits at the positions ``want``."""
    import torch
    from perfbench import harness
    from repro_torch.models import Model
    cfg = harness.arch_config(cell.config, cell.family)
    model = Model(cfg)
    dev = params["final_norm"].device
    out = []
    for seq, pos in zip(seqs, want):
        logits, _ = model.forward(params, torch.as_tensor([seq], device=dev))
        out.append(logits[0, list(pos), :cfg.vocab].float())
    return out


def readings(cell, seed, seconds, device, control=True, second=False):
    """Serve a short window of the cell and take a run's sample: the gaps
    of the served tokens against the float32 reference (``program``),
    of the float8 reference's first choices (``control``), of the
    program's own whole-sequence forward's first choices (``witness``),
    and how far the served tokens lie below that forward's best
    (``below_witness``); with the run's unfinished and short requests."""
    import torch
    from perfbench import check, harness
    logits_at = cell.family.logits_at
    s = harness.serve(cell, seed, seconds, False, device,
                      time.perf_counter())
    spec = cell.limits
    ok = {i: t for i, t in s.served.items()
          if len(t) == s.lengths[i] and t}
    ids = check.sample(seed, s.prompts, ok, int(spec["sample_tokens"]),
                       int(spec["sample_requests"]))
    seqs, want = check.teacher_forced(s.prompts, ok, ids)
    out = {"requests": len(ids), "unfinished": s.unfinished,
           "short": sum(1 for i in s.served
                        if len(s.served[i]) != s.lengths[i])}
    with torch.no_grad():
        ref = logits_at(s.params, s.sizes, seqs, want)
        out["program"] = check.gaps(ref, [torch.as_tensor(ok[i])
                                          for i in ids])
        if control:
            low = logits_at(s.params, s.sizes, seqs, want, quantize="fp8")
            out["control"] = check.gaps(ref, [t.argmax(dim=-1)
                                              for t in low])
        if second:
            w = witness(cell, s.params, seqs, want)
            out["witness"] = check.gaps(ref, [t.argmax(dim=-1) for t in w])
            out["below_witness"] = check.gaps(
                w, [torch.as_tensor(ok[i]) for i in ids])
    return out


def stats(g):
    """The numbers a limit could hold a sample's gaps to."""
    q = g.float().quantile(g.new_tensor([0.5, 0.95, 0.99]).float())
    return {"widest": float(g.max()), "mean": float(g.mean()),
            "median": float(q[0]), "p95": float(q[1]), "p99": float(q[2]),
            "share_off_top": float((g > 0).float().mean())}


def gaps(cell, seeds, seconds, control, device, second=False):
    import torch
    for seed in seeds:
        r = readings(cell, seed, seconds, device, control, second)
        row = {"workload": cell.name, "seed": seed,
               "dtype": cell.config["dtype"],
               "tokens": int(r["program"].numel())}
        for k, v in r.items():
            if isinstance(v, torch.Tensor):
                row.update({f"{k}_{n}": x for n, x in stats(v).items()})
            else:
                row[k] = v
        print(json.dumps(row), flush=True)
        del r
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def sweep(cell, seed, rates, seconds, device):
    from perfbench import harness
    for rate in rates:
        c = copy.deepcopy(cell)
        c.traffic["arrival"]["rate"] = rate
        s = harness.serve(c, seed, seconds, False, device,
                          time.perf_counter(), drain_s=30.0)
        print(json.dumps({
            "workload": cell.name, "rate": rate,
            **{k: v["value"] for k, v in s.out["metrics"].items()},
            "attempted": s.out["attempted"], "unfinished": s.unfinished,
            "waiting_open_close": list(s.waiting)}), flush=True)
        del s
        gc.collect()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("what", choices=("gaps", "sweep"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rate", type=float, default=None,
                    help="offer this rate instead of the traffic file's")
    ap.add_argument("--dtype", default=None,
                    help="serve in this type instead (a witness)")
    args = ap.parse_args(argv)
    from perfbench import cells
    cell = cells.load(ROOT, args.workload)
    if args.rate is not None:
        cell.traffic["arrival"]["rate"] = args.rate
    if args.dtype is not None:
        cell.config["dtype"] = args.dtype
    if args.what == "gaps":
        gaps(cell, [int(x) for x in args.seeds.split(",")], args.seconds,
             args.control, args.device, args.witness)
    else:
        sweep(cell, args.seed, [float(x) for x in args.rates.split(",")],
              args.seconds, args.device)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
