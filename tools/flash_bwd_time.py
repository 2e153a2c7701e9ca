"""Time the flash backward kernel of the checkout this file sits in, on the
card, at the training shapes ``chip_smoke.py`` phase 3 times (demo-110m's
B8 S1024 H12 KV4 dh64 and llama3.1-8b's B2 S1024 H32 KV8 dh128, bf16),
and check it against its plain version once; then time demo-110m's
training step and split one profiled step by kernel class.

    python3 tools/flash_bwd_time.py [--reps 20] [--steps 10]

Prints one JSON line: the card, per shape the kernel's median time (CUDA
events, L2 flushed, ``chip_smoke.time_ms``) and the largest error against
the plain version, and the step: demo-110m at B8 S1024 (the trainer's
model, optimizer, schedule and data, ``remat=False``), p50 of ``--steps``
steps after 3 warm-up steps (host clock, each step ending when its loss
is on the host) and tokens/s, then one more step under
``torch.profiler``: its wall, device time by class (flash forward, flash
backward, cuBLAS, the rest) and the device's idle time (the profiled
wall less the device time).  To compare two checkouts, run both in one
call on one card, in turns (base, change, change, base); a checkout
without this version of the file takes a copy of it in its ``tools/``.
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

SHAPES = ((8, 1024, 12, 4, 64), (2, 1024, 32, 8, 128))
STEP_B, STEP_S, WARM = 8, 1024, 3


def kernel_rows(torch, chip_smoke, ops, reps):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for B, S, H, KV, dh in SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(torch.bfloat16) for shape in
                       ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh),
                        (B, S, H, dh)))
        lt = torch.full((B,), S, dtype=torch.int32, device=dev)
        out, lse = ops.flash_attention(q, k, v, lt, return_lse=True)
        got = ops.flash_attention_bwd(q, k, v, out, lse, do, lt)
        want = ops.flash_attention_bwd_plain(q, k, v, out, lse, do, lt)
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        ms = chip_smoke.time_ms(
            torch, lambda: ops.flash_attention_bwd(q, k, v, out, lse, do,
                                                   lt), reps=reps)
        rows.append({"shape": f"B{B} S{S} H{H} KV{KV} dh{dh} bf16",
                     "ms": ms, "max_abs_err": err})
        del q, k, v, do, out, lse, got, want
        torch.cuda.empty_cache()
    return rows


def _step_class(name):
    from profile_torch_serve import _kernel_class
    if "flash_bwd" in name:
        return "flash backward"
    if "flash_fwd" in name:
        return "flash forward"
    return "cuBLAS" if _kernel_class(name) == "matmul (cuBLAS)" else "rest"


def train_step(torch, n_steps):
    """demo-110m's step as ``repro_torch.launch.train.train`` runs it."""
    from repro_torch.launch import train as trainer
    from repro_torch.models import Model
    from repro_torch.train import (AdamW, cosine_schedule, init_state,
                                   make_train_step)
    from repro_torch.workload.datasets import DataConfig, token_batches
    dev = torch.device("cuda")
    cfg = trainer.DEMO_110M
    steps = WARM + n_steps + 1
    model = Model(cfg, remat=False)
    opt = AdamW(lr=cosine_schedule(3e-3, 20, steps))
    step_fn = make_train_step(model, opt)
    state = init_state(model, opt, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    data = token_batches(DataConfig(vocab=cfg.vocab, batch=STEP_B,
                                    seq_len=STEP_S, seed=0))
    times = []
    for i in range(WARM + n_steps):
        b = {k: torch.from_numpy(x).to(dev) for k, x in next(data).items()}
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        float(m["loss"])
        if i >= WARM:
            times.append(time.perf_counter() - t0)
    b = {k: torch.from_numpy(x).to(dev) for k, x in next(data).items()}
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split = {c: [0.0, 0] for c in ("flash forward", "flash backward",
                                   "cuBLAS", "rest")}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and getattr(e, "device_type", None) != \
                torch.autograd.DeviceType.CPU:
            c = split[_step_class(e.key)]
            c[0] += us / 1e3
            c[1] += e.count
    busy = sum(ms for ms, _ in split.values())
    p50 = statistics.median(times) * 1e3
    return {"arch": cfg.name, "batch": STEP_B, "seq": STEP_S,
            "steps_timed": n_steps, "step_p50_ms": p50,
            "step_ms": [t * 1e3 for t in times],
            "tokens_per_s": STEP_B * STEP_S / (p50 / 1e3),
            "profiled_step_ms": wall, "device_busy_ms": busy,
            "device_idle_ms": wall - busy,
            "by_class": {c: {"ms": ms, "launches": n}
                         for c, (ms, n) in split.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rows = kernel_rows(torch, chip_smoke, ops, args.reps)
    step = train_step(torch, args.steps)
    print(json.dumps({"card": card, "root": str(ROOT), "rows": rows,
                      "step": step}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
