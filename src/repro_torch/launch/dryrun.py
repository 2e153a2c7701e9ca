"""Dry run: size and count every (arch × shape) cell on the meta device.

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each cell on a forced 512-device host mesh and reads XLA's memory analysis
and HLO.  Here each cell's step (a train step with AdamW and remat, a
prefill, or a decode) runs once on meta tensors, which have shapes and
dtypes but no data, under ``repro_torch.roofline.counter.Counter``:

1. ``launch/specs.input_specs`` builds the inputs (params, optimizer
   state, batch, the paged cache) on meta;
2. the step runs eagerly on meta: every aten op is counted (FLOPs, HBM
   bytes), every storage is sized while it lives, each kernel wrapper
   charges its kernel's work and adds a predicted launch, and the
   counting group (tp > 1) records the collectives;
3. the record carries the memory (argument / output / temp / alias bytes),
   whether it fits one card (argument + temp <= the ``h100`` preset's HBM
   capacity), the roofline against that preset, the
   model FLOPs (6·N·D train, 2·N·D otherwise) and the kernels' launches,
   FLOPs and bytes.

Usage:
  python -m repro_torch.launch.dryrun --arch starcoder2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out results.jsonl] [--tp 2]

Not ported, each with its reason: ``--multi-pod`` and ``--both-meshes``
(the 16×16 and 2×16×16 GSPMD meshes: the port runs one process a rank, and
``--tp`` takes the (1, tp) engine mesh it serves on); ``--no-unroll``
(eager PyTorch has no while loops to unroll; a Python loop runs every
iteration, or one under a trip count); ``--zero1`` (a GSPMD sharding of
the optimizer state over a data-parallel mesh; the port trains on one
card, so a train cell at tp > 1 raises, naming
``TrainStepConfig.dp_axes``).  ``compile_s`` is null: nothing is compiled.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (ALL_SHAPES, ASSIGNED, cell_is_runnable,
                                 get_config, get_shape)
from repro_torch.kernels import paged_attention as _paged
from repro_torch.launch.mesh import CountingGroup
from repro_torch.launch.sharding import shard_params
from repro_torch.launch.specs import input_specs
from repro_torch.models import Model
from repro_torch.roofline import analysis as ra
from repro_torch.roofline.counter import Counter
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import TrainStepConfig, make_train_step
from repro_torch.train.tree import leaves


def run_step(model: Model, step: str, inputs: dict, *,
             microbatches: int = 1):
    """One step of kind ``step`` ("train": AdamW, "prefill", "decode" or
    "extend") on ``inputs`` (``input_specs``' keys; "extend" takes
    "params", "cache" and "tokens"); returns its outputs."""
    if step == "train":
        fn = make_train_step(model, AdamW(),
                             TrainStepConfig(microbatches=microbatches))
        return fn(inputs["state"], inputs["batch"])
    with torch.no_grad():
        if step == "prefill":
            return model.prefill(inputs["params"], inputs["tokens"])
        if step == "decode":
            return model.decode(inputs["params"], inputs["cache"],
                                inputs["tokens"])
        if step == "extend":
            return model.extend(inputs["params"], inputs["cache"],
                                inputs["tokens"])
    raise ValueError(step)


def count_step(model: Model, step: str, inputs: dict, *,
               microbatches: int = 1, trip_counts: bool = True):
    """Run ``run_step`` once under a fresh counter, on whatever device the
    inputs live (meta for the dry run, the card or the CPU to check it).
    Returns (the counter, its memory record, the step's outputs)."""
    # the decode workspace persists across calls: make this step allocate
    # it, as a process's first decode does
    _paged._SCRATCH.pop(torch.device("meta"), None)
    gc.collect()
    counter = Counter(trip_counts=trip_counts)
    with counter:
        counter.arguments(inputs)
        out = run_step(model, step, inputs, microbatches=microbatches)
        gc.collect()
        mem = counter.memory(out)
    return counter, mem, out


def state_bytes(tree) -> int:
    """Bytes of a tree's tensors, each storage once."""
    seen, total = set(), 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total


def record(counter, mem, *, n_devices: int = 1, cfg=None,
           shape=None) -> dict:
    """The record's measured keys from a counted step, against the
    ``h100`` preset."""
    from repro_torch.hw.specs import get_hw
    roof = ra.from_counter(counter, n_devices)
    rec = {
        "hw": roof.hw,
        "memory": {k: v for k, v in mem.items() if k != "peak_bytes"},
        "fits": mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        <= get_hw(roof.hw).hbm_capacity,
        "roofline": roof.summary(),
        "kernels": {n: {"launches": k.launches, "flops": k.flops,
                        "bytes": k.bytes}
                    for n, k in sorted(counter.kernels.items())},
        "flops_outside_kernels": counter.flops,
        "bytes_outside_kernels": counter.hbm_bytes,
    }
    if cfg is not None:
        mf = ra.model_flops(cfg, shape)
        rec.update(model_flops_global=mf,
                   model_flops_per_device=mf / n_devices,
                   useful_flops_frac=(mf / n_devices) / max(roof.flops, 1.0))
    return rec


def lower_cell(arch: str, shape_name: str, *, tp: int = 1,
               attn_impl: str = "flash", microbatches: int = 1,
               fuse_qkv: bool = False, norm_ct16: bool = False,
               variant: str = "baseline") -> dict:
    """Count one cell on meta; returns its record (the JAX record's keys
    where they mean something here, see the module docstring)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    head = {"arch": arch, "shape": shape_name, "multi_pod": False,
            "mesh": [1, tp], "n_devices": tp}
    if not cell_is_runnable(cfg.subquadratic, shape):
        return {**head, "status": "skipped",
                "reason": "long_500k requires sub-quadratic attention "
                          "(DESIGN.md §5)"}
    if shape.step == "train" and tp > 1:
        raise NotImplementedError(
            f"train at tp={tp}: the port trains on one card; data- or "
            f"tensor-parallel training is TrainStepConfig.dp_axes, not "
            f"ported (ROADMAP.md, not queued)")
    group = CountingGroup(0, tp) if tp > 1 else None
    model = Model(cfg, attn_impl=attn_impl, fuse_qkv=fuse_qkv,
                  norm_ct16=norm_ct16, group=group)
    t0 = time.time()
    inputs = input_specs(cfg, shape, model)
    if group is not None:
        inputs["params"] = shard_params(inputs["params"], 0, tp, cfg=cfg)
    counter, mem, out = count_step(model, shape.step, inputs,
                                   microbatches=microbatches)
    del out, inputs
    trace_s = time.time() - t0
    return {**head, "status": "ok", "attn_impl": attn_impl,
            "microbatches": microbatches, "variant": variant,
            "trace_s": round(trace_s, 2), "compile_s": None,
            **record(counter, mem, n_devices=tp, cfg=cfg, shape=shape)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--attn-impl", default="flash",
                    choices=("flash", "chunked", "folded"))
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = auto (8 for train, 1 otherwise)")
    args = ap.parse_args(argv)

    done = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["multi_pod"],
                              r.get("attn_impl", "flash"),
                              r.get("n_devices", 1)))
                except Exception:
                    pass

    archs = ASSIGNED if args.all or not args.arch else [args.arch]
    shapes = [s.name for s in ALL_SHAPES] if args.all or not args.shape \
        else [args.shape]
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                key = (arch, shape, False, args.attn_impl, args.tp)
                if key in done:
                    print(f"skip (done): {key}")
                    continue
                print(f"=== {arch} x {shape} tp={args.tp} ===", flush=True)
                mb = args.microbatches
                if mb == 0:
                    mb = 8 if get_shape(shape).step == "train" else 1
                try:
                    rec = lower_cell(arch, shape, tp=args.tp,
                                     attn_impl=args.attn_impl,
                                     microbatches=mb)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "multi_pod": False,
                           "n_devices": args.tp, "status": "error",
                           "error": str(e)[:2000],
                           "attn_impl": args.attn_impl,
                           "traceback": traceback.format_exc()[-4000:]}
                print(json.dumps({k: v for k, v in rec.items()
                                  if k != "traceback"}), flush=True)
                f.write(json.dumps(rec) + "\n")
                f.flush()


if __name__ == "__main__":
    main()
