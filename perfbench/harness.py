"""One run of one cell: set up, serve a measured window, check, report.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (``run.py`` puts the checkout's ``src`` on the path and
calls ``main``).  The run

1. draws the cell's weights on the card and its requests from the seed
   (the configuration's family's ``make_params``, ``workload.py``);
2. builds the program's normal serving path for the cell:
   ``repro_torch.serve.ServeDriver`` over one ``ServingEngine``, the
   runtime's scheduler with chunked prefill, ``TorchBackend``;
3. warms up every prefill, extend and decode shape the cell's traffic
   uses, then serves the traffic for ``warm_s`` virtual seconds, so the
   window opens on a running system (``setup_s`` ends here);
4. serves for ``--seconds`` of wall time, driving the runtime's event
   queue in slices and submitting arrivals as they fall due; with
   ``--trace 1`` the runtime records its events and the window's last
   ``PROFILE_S`` seconds run under ``torch.profiler``;
5. serves on until every request of the window has finished (at most
   ``DRAIN_S``), reads the peak memory, frees the program and compares
   a sample of the served tokens with the family's plain reference
   (``check.py``);
6. prints the checks on standard error and one JSON line on standard
   output, last.

The program's runtime keeps a virtual clock that each iteration advances
by its measured wall time (ending in ``torch.cuda.synchronize``), with
idle gaps skipped: TTFT and TPOT are read on that clock, as the program
defines them, from when each request was due.  The clock leaves out the
runtime's own host work between iterations, so throughput is taken over
the wall window instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from perfbench import cells, check
from perfbench.tracing import Capture
from perfbench.workload import Traffic

#: virtual seconds of the event queue a slice of the loop runs
SLICE_V = 0.05
#: wall seconds the window's requests may take to finish after it closes
DRAIN_S = 90.0
#: wall seconds at the end of the window the profiler covers in a traced
#: run
PROFILE_S = 8.0
#: top-level modules that must not be loaded in the process
BANNED = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    sizes: dict
    setup_s: float
    window_s: float
    wall_open: float
    wall_close: float
    v_open: float
    v_close: float
    requests: list               # the window's SimRequests
    tokens: int                  # output tokens emitted in the wall window
    events: Optional[list] = None
    rec_t0: float = 0.0
    profile: Optional[object] = None
    family: Optional[object] = None   # the configuration's family module


# --------------------------------------------------------------------------
# the program, built for the cell
# --------------------------------------------------------------------------

def _fields(kind, given: dict, where: str) -> dict:
    """``given`` checked against the fields of the dataclass ``kind``, an
    unknown key refused by name; float and bool fields as their type."""
    types = {f.name: getattr(f.type, "__name__", f.type)
             for f in dataclasses.fields(kind)}
    unknown = sorted(set(given) - set(types))
    if unknown:
        raise ValueError(f"{where}: {', '.join(unknown)} name no field of "
                         f"the program's {kind.__name__}")
    cast = {"float": float, "bool": bool}
    return {k: cast[types[k]](v) if types[k] in cast else v
            for k, v in given.items()}


def arch_config(config: dict, family):
    """The program's ``ArchConfig`` for a configuration file: the registry
    entry named by ``arch`` with every field that ``sizes`` names
    (``stages`` a list of ``Stage`` fields, by default one stage of
    attention + MLP, or + MoE; ``moe`` the ``MoECfg`` fields, or no MoE
    where it is left out), refused unless the family's reference
    computes it."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import (ATTN_MLP, ATTN_MOE, ArchConfig,
                                          MoECfg, Stage, simple_stages)
    name = config["name"]
    base = registry.get_config(config["arch"])
    s = _fields(ArchConfig, config["sizes"], f"{name}: sizes")
    own = {"name": name, "compute_dtype": config["dtype"]}
    if set(s) & set(own):
        raise ValueError(f"{name}: sizes may not set "
                         f"{', '.join(sorted(set(s) & set(own)))}: the "
                         f"file's name and dtype do")
    moe = s.get("moe")
    if moe is not None:
        s["moe"] = MoECfg(**_fields(MoECfg, moe, f"{name}: sizes.moe"))
    s.setdefault("moe", None)
    if "stages" in s:
        s["stages"] = tuple(Stage(**_fields(Stage, st, f"{name}: stages"))
                            for st in s["stages"])
        n = s.get("n_layers", base.n_layers)
        if sum(st.n_layers for st in s["stages"]) != n:
            raise ValueError(f"{name}: the stages' layers do not add up to "
                             f"n_layers {n}")
    else:
        s["stages"] = simple_stages(ATTN_MOE if moe else ATTN_MLP,
                                    s["n_layers"])
    cfg = dataclasses.replace(base, **s, **own)
    reason = family.covers(cfg)
    if reason is not None:
        raise ValueError(f"{name}: {reason}")
    return cfg


def sizes_of(config: dict, cfg) -> dict:
    return dict(config["sizes"], padded_vocab=cfg.padded_vocab)


def build(cfg, params, traffic: dict, device, recorder=None):
    from repro_torch.core.config import SchedulerCfg
    from repro_torch.serve import ServeDriver, ServingEngine
    from repro_torch.serve.driver import DriverCfg
    e = traffic["engine"]
    engine = ServingEngine(cfg, params=params, max_batch=e["max_batch"],
                           max_len=e["max_len"], device=device,
                           name="engine0")
    sched = SchedulerCfg(max_batch_size=e["max_batch"],
                         max_batch_tokens=e["max_batch_tokens"],
                         chunked_prefill=True,
                         prefill_chunk=e["prefill_chunk"])
    driver = ServeDriver([engine], DriverCfg(scheduler=sched),
                         recorder=recorder)
    return engine, driver


def warm(driver, engine, traffic: dict):
    """The runtime's warm-up (extend at every chunk bucket, decode), and
    prefill at every bucket up to the chunk's."""
    driver.runtime.warmup()
    top = min(traffic["engine"]["prefill_chunk"],
              traffic["engine"]["max_len"] - 1)
    buckets, b = [], 16
    while b < 2 * top and b < engine.max_len:
        buckets.append(b)
        b *= 2
    engine.warmup(buckets=tuple(buckets))
    engine.synchronize()


class Feeder:
    """Submits the traffic to the runtime as it falls due (open loop), or
    keeps a backlog of ``depth`` unfinished requests (every one due at
    0)."""

    def __init__(self, rt, traffic: Traffic, depth: int):
        self.rt = rt
        self.it = iter(traffic)
        self.backlog = traffic.backlog
        self.depth = depth
        self.next = next(self.it)
        self.sims: Dict[int, object] = {}
        self.reqs: Dict[int, object] = {}

    def _submit(self, batch):
        n0 = len(self.rt._all_requests)
        self.rt.submit_workload(batch)
        for r, s in zip(batch, self.rt._all_requests[n0:]):
            self.sims[r.req_id] = s
            self.reqs[r.req_id] = r

    def feed(self):
        now = self.rt.queue.now
        batch = []
        if self.backlog:
            open_ = len(self.sims) - len(self.rt.finished)
            while open_ + len(batch) < self.depth:
                batch.append(self.next)
                self.next = next(self.it)
        else:
            while self.next.arrival <= now + 1.0 or (
                    not batch and self.rt.queue.empty):
                batch.append(self.next)
                self.next = next(self.it)
        if batch:
            self._submit(batch)

    def emitted(self) -> int:
        return sum(s.generated for s in self.sims.values())


def step(rt, feeder: Feeder):
    feeder.feed()
    rt.queue.run(until=rt.queue.now + SLICE_V)


def annotate(backend, capture: Capture):
    """Wrap the backend's ``execute`` in a profiler range named by the
    iteration's kind, noting its work items while the capture is on."""
    execute = backend.execute

    def traced(work, now):
        phases = {w.phase for w in work}
        kind = phases.pop() if len(phases) == 1 else "mixed"
        if capture.active:
            capture.note([(w.phase, w.tokens,
                           w.request.prefill_done_tokens
                           + w.request.cached_prefix if w.phase == "prefill"
                           else w.request.prompt_len + w.request.generated
                           - 1) for w in work])
        with torch.profiler.record_function(f"perfbench.execute.{kind}"):
            return execute(work, now)

    backend.execute = traced


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------

def window_requests(feeder: Feeder, v_open: float, v_close: float):
    """The window's requests: those due in its span of the runtime's
    clock, or, for a backlog (every request due at 0), those whose first
    token came in it."""
    sims = list(feeder.sims.values())
    if feeder.backlog:
        return [s for s in sims if s.t_first_token is not None
                and v_open <= s.t_first_token < v_close]
    return [s for s in sims if v_open <= s.arrival < v_close]


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


@dataclasses.dataclass
class Served:
    """A served window with the program freed: the result's numbers, and
    what the comparison reads (the harness's weights, each finished
    request's prompt, served tokens and due output length)."""
    out: dict
    params: dict
    sizes: dict
    prompts: Dict[int, list]
    served: Dict[int, list]
    lengths: Dict[int, int]
    unfinished: int
    waiting: tuple = (0, 0)      # queued, not admitted: window open, close


def serve(cell, seed: int, seconds: float, trace: bool, device,
          t_start: float, drain_s: float = DRAIN_S) -> Served:
    """Set up, serve the window and let its requests finish, read the
    metrics, and free the program."""
    from repro_torch.obs import EventRecorder
    cfg = arch_config(cell.config, cell.family)
    sizes = sizes_of(cell.config, cfg)
    params = cell.family.make_params(
        sizes, seed, device, dtype=getattr(torch, cell.config["dtype"]))
    traffic = Traffic(cell.traffic, seed, sizes["vocab"])
    rec = EventRecorder(wall_clock=True) if trace else None
    engine, driver = build(cfg, params, cell.traffic, device, recorder=rec)
    rt = driver.runtime
    backend = rt.instances["engine0"].backend
    capture = Capture() if trace else None
    if trace:
        annotate(backend, capture)
    warm(driver, engine, cell.traffic)
    if capture is not None:
        capture.warm()
    feeder = Feeder(rt, traffic, depth=3 * cell.traffic["engine"]
                    ["max_batch"])
    while rt.queue.now < float(cell.traffic["warm_s"]):
        step(rt, feeder)
    # ---- the window
    wall_open = time.perf_counter()
    setup_s = wall_open - t_start
    sched = rt.instances["engine0"].scheduler
    v_open, tok_open = rt.queue.now, feeder.emitted()
    waiting_open = len(sched.waiting)
    # the profiler covers the window's last PROFILE_S seconds and stops
    # after the window has closed: stopping it takes seconds of host time
    prof_at = wall_open + max(0.0, seconds - PROFILE_S)
    try:
        while True:
            now = time.perf_counter()
            if now - wall_open >= seconds:
                break
            if capture is not None and capture.prof is None \
                    and now >= prof_at:
                capture.start()
            step(rt, feeder)
        wall_close = time.perf_counter()
    finally:
        # the kernel wrappers go back even where the window raised
        if capture is not None and capture.active:
            capture.stop()
    v_close, tok_close = rt.queue.now, feeder.emitted()
    waiting = (waiting_open, len(sched.waiting))
    # ---- the window's requests finish
    mine = window_requests(feeder, v_open, v_close)
    deadline = time.perf_counter() + drain_s
    while any(s.t_finish is None for s in mine) \
            and time.perf_counter() < deadline:
        step(rt, feeder)
    engine.synchronize()
    peak = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0
    run = Run(sizes=sizes, setup_s=setup_s,
              window_s=wall_close - wall_open, wall_open=wall_open,
              wall_close=wall_close, v_open=v_open, v_close=v_close,
              requests=mine, tokens=tok_close - tok_open,
              events=rec.events if rec is not None else None,
              rec_t0=rec._t0 if rec is not None else 0.0,
              profile=capture.reduce() if capture is not None
              and capture.prof is not None else None, family=cell.family)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.readers[m["name"]](run)
        if v is None and not trace:
            raise RuntimeError(f"perfbench: {m['name']} has no value in "
                               f"{cell.name}")
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    finished = [s for s in mine if s.t_finish is not None]
    served = {s.req_id: list(backend.out_tokens.get(s.req_id, []))
              for s in finished}
    prompts = {s.req_id: list(feeder.reqs[s.req_id].prompt_tokens)
               for s in finished}
    lengths = {s.req_id: feeder.reqs[s.req_id].output_len for s in finished}
    # ---- the program's state freed, then the reference
    del driver, engine, rt, backend, feeder, capture, traffic, sched
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"attempted": len(mine), "failed": len(mine) - len(finished),
           "metrics": metrics,
           "device": device_info(device, peak, run.profile)}
    if run.profile is not None:
        out["breakdown"] = {"device_ops": run.profile.device_ops(),
                            "idle_gaps": run.profile.idle_gaps()}
    return Served(out=out, params=params, sizes=sizes, prompts=prompts,
                  served=served, lengths=lengths,
                  unfinished=len(mine) - len(finished), waiting=waiting)


def serve_cell(cell, seed: int, seconds: float, trace: bool, device,
               t_start: float) -> dict:
    """Everything of a run after the chip check; returns the result, its
    checks last."""
    s = serve(cell, seed, seconds, trace, device, t_start)
    verdict = check.compare(s.params, s.sizes, cell.limits, seed,
                            s.prompts, s.served, s.lengths, s.unfinished,
                            family=cell.family)
    return {"correct": verdict["correct"], **s.out,
            "checks": verdict["checks"]}


def device_info(device, peak: int, profile) -> dict:
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    if profile is not None:
        info["busy_s"] = profile.busy_s
        info["window_s"] = profile.window_s
    return info


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, root: Path, t_start: float, device="cuda",
         look_for_chip: bool = True) -> int:
    args = parse(argv)
    cell = cells.load(root, args.workload)
    if look_for_chip and (not torch.cuda.is_available()
                          or torch.cuda.device_count() < cell.chips):
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = serve_cell(cell, args.seed, args.seconds, bool(args.trace),
                     device, t_start)
    banned = banned_modules()
    if banned:
        print(f"perfbench: {', '.join(banned)} loaded in the benchmark's "
              f"process", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
