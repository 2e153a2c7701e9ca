"""Iteration-level profiler that probes through the unified runtime.

The port of ``repro/profiler/runtime_profiler.py``: every measurement runs
``TorchBackend.execute`` on hand-composed ``ScheduledWork`` batches — the
code paths production serving takes (bucketed ``prefill`` for fresh
prompts, ``extend`` for chunked-prefill continuations, one full-buffer
``decode`` per iteration, the slot export for KV copies).  Each iteration
is wall-timed and ends in ``torch.cuda.synchronize`` on the card, so a
point holds the host's work and the device's, as the serve pays them.

Emitted trace points (the highest-fidelity tier — ``PerfModel`` prefers
them over operator-level composition):

* ``("iter", "prefill", P, P)``       — one whole-prompt prefill at bucket P
* ``("extend", "prefill", S, c+S)``   — an S-token chunk extending context c
* ``("iter", "decode", B, c)``        — a B-wide decode step at context c
* ``("kv_export", "prefill", P, P)``  — slot KV copy-out (P/D transfer)
  for P tokens

The result is a portable :class:`repro_torch.hw.HardwareTrace` artifact
labelled ``device``; the engine runs on ``engine_device`` (None: the card)
and the artifact embeds that device's spec (``serve.driver.device_hw``:
the ``h100`` preset on a card, ``ENGINE_HW`` on the CPU).  The label
defaults to that spec's name, and a run on the card refuses a CPU label
(``measured_label``).  The single
command on the card is ``python -m repro_torch.profiler profile --device
h100 --mode measured --arch llama3.1-8b --kernels``.
"""
from __future__ import annotations

import itertools
import time
from typing import Optional, Sequence

import numpy as np

import torch

from repro_torch.configs import get_config
from repro_torch.core.config import (H100, HardwareSpec, InstanceCfg,
                                     ParallelismCfg, PrefixCacheCfg,
                                     SchedulerCfg)
from repro_torch.core.request import SimRequest
from repro_torch.core.trace import Trace
from repro_torch.hw.trace import HardwareTrace, InterconnectSpec
from repro_torch.profiler.arch_spec import model_spec_from_arch


def is_cpu_label(label: str) -> bool:
    """A label that names a CPU measurement (``cpu-engine``,
    ``cpu-measured``, ``local``)."""
    return label == "local" or label.startswith("cpu")


def measured_label(label: Optional[str], device: torch.device,
                   cpu_default: str) -> str:
    """The label of an artifact measured on torch ``device``: ``label``,
    or by default ``cpu_default`` on the CPU and ``h100`` on the card.  A
    run on the card never carries a CPU label: its times would price a CPU
    instance."""
    if label is None:
        return H100.name if device.type == "cuda" else cpu_default
    if device.type == "cuda" and is_cpu_label(label):
        raise ValueError(f"label {label!r} names a CPU, but the engine "
                         f"runs on {device}; label the card's artifact "
                         f"with its own name (e.g. {H100.name!r})")
    return label


def _probe_instance_cfg(arch: str, max_batch: int, max_len: int,
                        chunk: int, hw: HardwareSpec,
                        tp: int = 1) -> InstanceCfg:
    """Engine-matched InstanceCfg for the probe backend (chunked prefill on
    so ``warmup`` runs the extend buckets we measure)."""
    return InstanceCfg(
        name="probe", hw=hw, model=model_spec_from_arch(get_config(arch)),
        parallelism=ParallelismCfg(tp=tp),
        scheduler=SchedulerCfg(max_batch_size=max_batch,
                               max_batch_tokens=1 << 16,
                               chunked_prefill=True, prefill_chunk=chunk),
        prefix_cache=PrefixCacheCfg(enabled=False))


def runtime_trace(arch: str, *, device: Optional[str] = None,
                  max_batch: int = 4, max_len: int = 512,
                  prefill_buckets: Sequence[int] = (16, 32, 64, 128, 256),
                  decode_ctxs: Sequence[int] = (32, 64, 128, 256),
                  extend_ctxs: Sequence[int] = (16, 64, 128),
                  extend_suffixes: Sequence[int] = (16, 64, 128),
                  reps: int = 3, seed: int = 0, tp: int = 1,
                  engine=None, engine_device=None,
                  group=None) -> HardwareTrace:
    """Measure ``arch`` through ``TorchBackend``.

    ``engine`` may supply a pre-built ``ServingEngine`` (params reuse);
    otherwise one is made from ``seed`` on ``engine_device`` (None means
    the card).  ``tp`` > 1 probes one rank of a sharded engine (``group``,
    this rank's engine group; :func:`runtime_trace_tp` spawns the ranks):
    every point is the slowest rank's time, so the grid prices tp-degree
    instances, and a ``kv_export`` point is the ranks' parallel copy-out
    of their own KV heads.  Returns a ``HardwareTrace`` labelled
    ``device`` (default: ``cpu-engine`` on the CPU, ``h100`` on the card)
    with the engine device's spec embedded.
    """
    from repro_torch.runtime.backends.torch_engine import TorchBackend
    from repro_torch.runtime.scheduler import ScheduledWork
    from repro_torch.serve.driver import device_hw
    from repro_torch.serve.engine import ServingEngine

    cfg = get_config(arch)
    device = measured_label(device, engine.device if engine is not None
                            else torch.device(engine_device or "cuda"),
                            "cpu-engine")
    t_start = time.time()
    eng = engine or ServingEngine(cfg, max_batch=max_batch, max_len=max_len,
                                  name="probe", seed=seed, tp=tp,
                                  device=engine_device, group=group)
    spec = device_hw(eng.device)
    icfg = _probe_instance_cfg(arch, max_batch, max_len,
                               chunk=max(extend_suffixes), hw=spec,
                               tp=eng.tp)
    backend = TorchBackend(eng, icfg)
    backend.warmup()

    trace = Trace(model=arch, hardware=device, tp=eng.tp)
    rng = np.random.default_rng(seed)
    rid = itertools.count()

    def make_req(n_prompt: int, output_len: int = 1) -> SimRequest:
        toks = rng.integers(0, cfg.vocab, n_prompt).tolist()
        return SimRequest(req_id=next(rid), arrival=0.0,
                          prompt_tokens=toks, output_len=output_len)

    def run(req: SimRequest, tokens: int, phase: str) -> float:
        return backend.execute([ScheduledWork(req, tokens, phase)], 0.0)

    # --- whole-prompt prefill per bucket (+ KV-export / slot copy cost) ---
    for P in prefill_buckets:
        if P >= max_len - 8:
            continue
        lat, exp_lat = [], []
        for _ in range(reps):
            req = make_req(P - 1)
            lat.append(run(req, P - 1, "prefill"))
            t0 = time.perf_counter()
            backend.export_kv(req)      # slot copy-out; also frees the slot
            exp_lat.append(eng.slowest(time.perf_counter() - t0))
            backend._carry_s = 0.0      # export time was measured directly
        trace.add("iter", "prefill", P, P, float(np.median(lat)))
        trace.add("kv_export", "prefill", P, P, float(np.median(exp_lat)))

    # --- chunked prefill (extend) per (suffix, context) ---
    # chunk 2+ runs the engine's extend path, which attends over the
    # slot's pages — priced separately from fresh prefill.  A model with
    # no cached-prefill path (xLSTM) gets no extend points, and the perf
    # model prices its chunks as fresh prefill, as in JAX
    try:
        for ctx in extend_ctxs:
            for S in extend_suffixes:
                if ctx + S >= max_len:
                    continue
                lat = []
                for rep in range(reps + 1):
                    req = make_req(ctx + S)
                    run(req, ctx, "prefill")          # chunk 1: fresh
                    try:
                        dt = run(req, S, "prefill")   # chunk 2: extend
                    finally:
                        backend.release(req)
                    if rep:                           # rep 0 warms up
                        lat.append(dt)
                trace.add("extend", "prefill", S, ctx + S,
                          float(np.median(lat)))
    except NotImplementedError:
        pass

    # --- batched decode per (batch, context) ---
    for ctx in decode_ctxs:
        if ctx + 16 >= max_len:
            continue
        for nb in sorted({1, max(1, max_batch // 2), max_batch}):
            reqs = []
            for _ in range(nb):
                req = make_req(ctx, output_len=reps + 4)
                run(req, ctx, "prefill")
                reqs.append(req)
            lat = []
            for _ in range(reps + 1):
                work = [ScheduledWork(r, 1, "decode") for r in reqs]
                lat.append(backend.execute(work, 0.0))
            for r in reqs:
                backend.release(r)
            trace.add("iter", "decode", nb, ctx,
                      float(np.median(lat[1:]) if len(lat) > 1 else lat[0]))

    trace.meta.update({
        "mode": "runtime", "profile_wall_s": time.time() - t_start,
        "n_points": len(trace.points), "max_batch": max_batch,
        "max_len": max_len, "tp": eng.tp,
        "engine_device": str(eng.device),
    })
    return HardwareTrace.from_trace(
        trace, device=device, spec=spec,
        interconnect=InterconnectSpec.from_hw(spec))


def _trace_rank(group, job):
    arch, kw = job
    return runtime_trace(arch, tp=group.size, group=group,
                         engine_device=group.device, **kw)


def runtime_trace_tp(arch: str, tp: int, *, engine_device=None,
                     **kw) -> HardwareTrace:
    """:func:`runtime_trace` at ``tp`` > 1: ``tp`` ranks on ``tp``
    devices of ``engine_device``'s kind (None: the card), each measuring
    its shard; every rank records the same (slowest-rank) latencies, and
    rank 0's trace is returned."""
    from repro_torch.launch.mesh import run_ranks
    kind = torch.device(engine_device or "cuda").type
    ranks = run_ranks(_trace_rank, tp, (arch, kw), device=kind)
    return ranks[0]
