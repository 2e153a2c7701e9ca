"""Fig. 2 on the port: the simulator against the real engine, configuration
by configuration (the twin of ``benchmarks/fig2_fidelity.py``).

The paper's loop: profile the device through the real engine
(``runtime_trace``), price the same cluster with the trace-driven
simulator, and compare both on the same workload.  Both sides run the
copied ``repro_torch.runtime`` scheduler, router and P/D code, so every
dispatch decision is the same code and the error isolates the hardware
model.  The sim instance of each engine is ``engine_instance_cfg(eng,
scheduler, trace_name=arch)``: the engine's spec and block ledger, priced
by the measured trace.

Configurations: S(D) one dense engine, S(M) one MoE engine, M(D) two dense
engines behind round robin, PD(D) a dense prefill engine handing KV to a
dense decode engine, S(D)+PC one dense engine with the real radix prefix
store (on a workload that shares prefixes, ``PC_SHARE``); the engines of
one configuration share their weights.  ``compare`` attaches an event
recorder to both sides and adds the attribution's segment totals to the
row (queueing, prefill, decode, tier restore, handoff), which splits a
TTFT error into queueing and pricing.  The arch, the engine sizes, the
scheduler and the workload are arguments, so the same code runs tiny on
the CPU and at full width on the card.  The real engine is wall-clock timed: run it on a
quiet machine.
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np

from repro_torch.bench.common import DENSE_TINY, MOE_TINY, pct_err
from repro_torch.configs import get_config
from repro_torch.core import ClusterCfg, NetworkCfg, RouterCfg, TraceRegistry
from repro_torch.core.cluster import Cluster
from repro_torch.core.config import SchedulerCfg
from repro_torch.hw.trace import kern_op
from repro_torch.obs import SEGMENTS, EventRecorder
from repro_torch.profiler.arch_spec import model_spec_from_arch
from repro_torch.workload import ShareGPTConfig, generate

#: configurations the twin runs
CONFIGS = ("S(D)", "S(M)", "M(D)", "PD(D)", "S(D)+PC")
#: the prefix-shared fraction of the S(D)+PC workload (the JAX benchmark's)
PC_SHARE = 0.6
N_REQ = 36
RATE = 8.0
KV_TRANSFER_BW = 16e9       # the real driver's P/D handoff rate (DriverCfg)


def workload(vocab: int, *, n: int = N_REQ, rate: float = RATE,
             seed: int = 7, **kw):
    """ShareGPT-shaped requests; the defaults are the JAX benchmark's."""
    args = dict(mean_prompt=90, mean_output=24, sigma_prompt=0.6,
                sigma_output=0.5, max_prompt=230, max_output=40,
                share_fraction=0.0, n_conversations=4)
    args.update(kw)
    return generate(ShareGPTConfig(n_requests=n, rate=rate, vocab=vocab,
                                   seed=seed, **args))


def make_engines(config: str, arch: str, *, params=None, max_batch: int = 4,
                 max_len: int = 512, device=None):
    """The real engines of one configuration and its P/D map.  The first
    engine draws weights from seed 0 unless ``params`` is given; the
    others share them."""
    from repro_torch.serve import ServingEngine
    cfg = get_config(arch)
    kw = dict(max_batch=max_batch, max_len=max_len, device=device)
    if config.startswith("S"):
        return [ServingEngine(cfg, params, name="e0",
                              prefix_cache=config.endswith("PC"), **kw)], \
            None
    if config.startswith("M"):
        e0 = ServingEngine(cfg, params, name="e0", **kw)
        return [e0, ServingEngine(cfg, e0.params, name="e1", **kw)], None
    if config.startswith("PD"):
        p0 = ServingEngine(cfg, params, name="p0", role="prefill", **kw)
        d0 = ServingEngine(cfg, p0.params, name="d0", role="decode", **kw)
        return [p0, d0], {"p0": ("d0",)}
    raise ValueError(f"unknown configuration {config!r}; have {CONFIGS}")


def _summary(m: dict) -> dict:
    ttft = m["tenants"]["default"]["ttft_p50_s"] if m.get("tenants") \
        else None
    # per instance: iterations and their mean latency, which separate a
    # mispriced iteration from a different iteration count
    iters = {n: (s["iterations"], s["busy_s"] / max(s["iterations"], 1))
             for n, s in m["instances"].items()}
    out = {"finished": m["finished"], "ttft_p50_s": ttft, "iters": iters,
           "tpot_mean_s": m.get("tpot_mean_s"),
           "itl_mean_s": m.get("itl_mean_s"),
           "throughput_tok_s": m.get("throughput_tok_s"),
           "handoff_bytes": float(sum(m.get("network_bytes", {})
                                      .values())),
           "kv_tiers": {n: s["kv_tiers"] for n, s in m["instances"].items()
                        if "kv_tiers" in s}}
    # per-request waterfalls: segment totals, and the largest gap between
    # a request's segments and its e2e latency (0 up to float rounding:
    # the segments partition the lifetime)
    rows = m["attribution"]["requests"].values()
    out["segments"] = {k: sum(r["segments"][k] for r in rows)
                       for k in SEGMENTS}
    out["attr_requests"] = len(rows)
    out["attr_max_gap_s"] = max(
        (abs(sum(r["segments"].values()) - r["total_s"]) for r in rows),
        default=0.0)
    return out


def compare(config: str, arch: str, reqs, trace, *,
            scheduler: Optional[SchedulerCfg] = None, params=None,
            max_batch: int = 4, max_len: int = 512, device=None) -> dict:
    """Serve ``reqs`` on the real engines of ``config`` and simulate the
    same cluster priced by ``trace`` (a ``repro_torch.core.trace.Trace``
    measured for ``arch``): one row of real and sim metrics and errors,
    with each side's attribution from an event recorder (wall-clock
    stamps on the real one)."""
    from repro_torch.serve import DriverCfg, ServeDriver
    from repro_torch.serve.driver import engine_instance_cfg
    engines, pd = make_engines(config, arch, params=params,
                               max_batch=max_batch, max_len=max_len,
                               device=device)
    drv = ServeDriver(engines, DriverCfg(scheduler=scheduler,
                                         kv_transfer_bw=KV_TRANSFER_BW),
                      pd_map=pd, recorder=EventRecorder(wall_clock=True))
    real = _summary(drv.run(reqs))
    registry = TraceRegistry()
    registry.register(arch, trace)
    ccfg = ClusterCfg(
        instances=tuple(engine_instance_cfg(e, scheduler, trace_name=arch)
                        for e in engines),
        router=RouterCfg("round_robin"),
        network=NetworkCfg(inter_instance_bw=KV_TRANSFER_BW), pd_map=pd)
    cluster = Cluster(ccfg, traces=registry, recorder=EventRecorder())
    cluster.submit_workload(reqs)
    sim = _summary(cluster.run())
    row = {"config": config, "arch": arch, "n": len(reqs)}
    for side, m in (("real", real), ("sim", sim)):
        row[f"{side}_finished"] = m["finished"]
        row[f"{side}_ttft_p50_ms"] = (m["ttft_p50_s"] or 0) * 1e3
        row[f"{side}_tpot_ms"] = (m["tpot_mean_s"] or 0) * 1e3
        row[f"{side}_itl_ms"] = (m["itl_mean_s"] or 0) * 1e3
        row[f"{side}_tput"] = m["throughput_tok_s"]
        row[f"{side}_handoff_bytes"] = m["handoff_bytes"]
        row[f"{side}_iterations"] = {n: c
                                     for n, (c, _) in m["iters"].items()}
        row[f"{side}_iter_ms"] = {n: t * 1e3
                                  for n, (_, t) in m["iters"].items()}
        for key in ("kv_tiers", "segments", "attr_requests",
                    "attr_max_gap_s"):
            row[f"{side}_{key}"] = m[key]
    for key, name in (("ttft_p50_s", "ttft"), ("tpot_mean_s", "tpot"),
                      ("itl_mean_s", "itl"), ("throughput_tok_s", "tput")):
        row[f"{name}_err_pct"] = pct_err(sim[key], real[key])
    return row


def kernel_attribution(tr, arch: str, backend: str = "cuda"):
    """Per-kernel error attribution: for every measured whole-iteration
    bucket with full kernel coverage, the measured latency, the kernel
    composition ``L*attention + L*ffn + head`` (PerfModel's kernel tier),
    the gap between them (host and framework time the kernel tier cannot
    see, or a mispriced kernel), and each kernel's share of the
    composition."""
    spec = model_spec_from_arch(get_config(arch))
    L = spec.n_layers
    names = ("attention", "moe_gmm" if spec.is_moe else "mlp", "head")
    rows = []
    for phase in ("prefill", "decode"):
        for p in tr._grid("iter", phase):
            vals = [tr.interpolate(kern_op(backend, kn), phase,
                                   p.tokens, p.context) for kn in names]
            if any(v is None for v in vals):
                continue
            parts = {names[0]: L * vals[0], names[1]: L * vals[1],
                     names[2]: vals[2]}
            comp = sum(parts.values())
            rows.append({
                "phase": phase, "tokens": p.tokens, "context": p.context,
                "iter_ms": p.latency_s * 1e3, "kernel_sum_ms": comp * 1e3,
                "gap_pct": 100.0 * (comp - p.latency_s) / p.latency_s,
                "share": {kn: v / comp for kn, v in parts.items()},
            })
    return rows


def summarize(rows: Sequence[dict]) -> dict:
    """Mean and max error over the rows' TPOT and throughput errors (the
    JAX benchmark's summary) and over TTFT p50."""
    errs = [r[k] for r in rows for k in ("tput_err_pct", "tpot_err_pct")]
    ttft = [r["ttft_err_pct"] for r in rows]
    return {"mean_err_pct": float(np.nanmean(errs)),
            "max_err_pct": float(np.nanmax(errs)),
            "ttft_mean_err_pct": float(np.nanmean(ttft)),
            "ttft_max_err_pct": float(np.nanmax(ttft))}


def run(quick: bool = False, kernels: bool = False, *, device=None,
        n_requests: int = N_REQ, reps: int = 3):
    """Profile each arch through the real engine on ``device`` (None: the
    card), then compare every configuration at the JAX benchmark's engine
    sizes (batch 4, max_len 512); ``quick`` keeps S(D) and S(M) only.
    ``kernels`` adds the kernel sweep (the ``cuda`` rows on the card,
    ``reference`` rows elsewhere) and its attribution."""
    from repro_torch.profiler.kernel_profiler import kernel_points
    from repro_torch.profiler.runtime_profiler import runtime_trace
    from repro_torch.serve.engine import resolve_device
    backend = "cuda" if resolve_device(device).type == "cuda" \
        else "reference"
    configs = CONFIGS[:2] if quick else CONFIGS
    archs = {c: MOE_TINY if c.endswith("(M)") else DENSE_TINY
             for c in configs}
    traces, attribution, rows = {}, {}, []
    for arch in dict.fromkeys(archs.values()):
        tr = runtime_trace(arch, reps=reps, engine_device=device).to_trace()
        if kernels:
            tr.points.extend(kernel_points(arch, backend, reps=reps,
                                           device=device))
            attribution[arch] = kernel_attribution(tr, arch, backend)
        traces[arch] = tr
    for config in configs:
        arch = archs[config]
        reqs = workload(get_config(arch).vocab, n=n_requests,
                        share_fraction=PC_SHARE if config.endswith("PC")
                        else 0.0)
        row = compare(config, arch, reqs, traces[arch], device=device)
        rows.append(row)
        print(f"fig2,{config},ttft_err={row['ttft_err_pct']:.1f}%,"
              f"tpot_err={row['tpot_err_pct']:.1f}%,"
              f"tput_err={row['tput_err_pct']:.1f}%", flush=True)
    out = {"rows": rows, **summarize(rows),
           "traces": {a: t.meta for a, t in traces.items()}}
    if attribution:
        out["kernel_attribution"] = attribution
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--kernels", action="store_true",
                    help="also sweep kernel sub-buckets and report "
                         "per-kernel error attribution")
    ap.add_argument("--device", default=None,
                    help="torch device of the engines (default: the card)")
    a = ap.parse_args()
    print(json.dumps(run(quick=a.quick, kernels=a.kernels, device=a.device),
                     indent=1, default=float))
