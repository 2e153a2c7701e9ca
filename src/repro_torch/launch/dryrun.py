"""Dry run: size and count every (arch × shape) cell on the meta device.

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each cell on a forced 512-device host mesh and reads XLA's memory analysis
and HLO.  Here each cell's step (a train step with AdamW and remat, a
prefill, or a decode) runs once on meta tensors, which have shapes and
dtypes but no data, under ``repro_torch.roofline.counter.Counter``:

Each cell is counted as one rank's program on a grid of ranks: the mesh
``(dp, tp)``, or the JAX study's production meshes, 16×16 ``(data,
model)`` and 2×16×16 ``(pod, data, model)`` (``launch/mesh``; the pod axis
folds into data parallelism).  Rank 0's program runs on a
``mesh.counting_grid``, whose groups stand in for every axis:

1. ``launch/specs.input_specs`` builds the rank's inputs on meta: its
   shard of the params (``launch/sharding``), of the AdamW state (under
   ``zero1``, its slice of each moment over the data axis), its
   ``global_batch / dp`` rows of the batch, the paged cache of its slots;
2. the step runs eagerly on meta: every aten op is counted (FLOPs, HBM
   bytes), every storage is sized while it lives, each kernel wrapper
   charges its kernel's work and adds a predicted launch, and the
   counting groups record the collectives by kind and mesh axis (a train
   step's gradient reduction, the ZeRO-1 gather, the MoE layers' global
   routing);
3. the record carries the memory (argument / output / temp / alias bytes)
   of one rank, whether it fits one card (argument + temp <= the ``h100``
   preset's HBM capacity), the roofline against that preset, the model
   FLOPs (6·N·D train, 2·N·D otherwise) and the kernels' launches, FLOPs
   and bytes.

Query heads that do not divide tp split in GSPMD's padded layout
(``launch/sharding.py``): rank 0 holds ceil(H / tp) heads, as every device
does under GSPMD, and is the most loaded rank, so its program is the
per-device one; such a record says so in its ``note``.  The recurrent
stages (Mamba2, the zamba superblock, xLSTM) split their heads the same
way (xlstm-125m's four heads at tp = 16: ranks 4-15 hold none).  A cell
the port cannot shard (a feed-forward width that does not divide tp, the
sLSTM's among them: ``sharding.unsupported``) gets ``status:
"unsupported"`` and the reason.

A decode cache's sequence splits as JAX's ``cache_pspecs`` splits it
(``RankGrid.seq_group``): a batch of one (every ``long_500k`` cell) over
the ``data`` axis alone (16 ways at 16×16 and at 2×16×16, where the pod
axis holds a replica), each rank holding ``seq_len / 16`` tokens of its
KV heads and combining its partial attention over ``data`` by the
kernel's log-sum-exp (``collective_bytes_by_axis["data"]``); under
``seq_shard_cache=True`` (a keyword, as in JAX, whose CLI has no flag) a
larger batch over the ``model`` axis, each rank holding every KV head for
``seq_len / tp`` tokens, the query heads all-gathered and the combine on
``model``.  ``shard_experts=True`` (a keyword too) holds the MoE experts
whole on the model ranks in GSPMD's padded layout (ceil(E / tp) a rank
from rank 0, which the note names) and carries the tokens to them by
all-to-all (``collective_bytes_by_axis["model"]["all-to-all"]``).  The
recurrent state at a batch of one is split by heads over ``model`` and
replicated over ``data``, as in JAX (xlstm-125m's
``long_500k`` has nothing to split; its note says so).  The record's
``note`` names the split.  A batch above one that does not divide by dp
is replicated over the data-parallel ranks, and the record says so
(``batch_replicated``; no shape of the study has one).

Usage:
  python -m repro_torch.launch.dryrun --arch starcoder2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out results.jsonl] \
      [--dp 16 --tp 16 | --multi-pod | --both-meshes] [--zero1]

Not ported, with its reason: ``--no-unroll`` (eager PyTorch has no while
loops to unroll; a Python loop runs every iteration, or one under a trip
count).  ``compile_s`` is null: nothing is compiled.
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
from repro_torch.launch.mesh import (counting_grid, grid_mesh,
                                     make_production_mesh)
from repro_torch.launch.sharding import expert_range, unsupported
from repro_torch.launch.specs import input_specs, rank_batch
from repro_torch.models import Model
from repro_torch.roofline import analysis as ra
from repro_torch.roofline.counter import Counter
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import TrainStepConfig, make_train_step
from repro_torch.train.tree import leaves


def run_step(model: Model, step: str, inputs: dict, *,
             microbatches: int = 1, grid=None, zero1: bool = False):
    """One step of kind ``step`` ("train": AdamW, "prefill", "decode" or
    "extend") on ``inputs`` (``input_specs``' keys; "extend" takes
    "params", "cache" and "tokens"); returns its outputs.  ``grid``: the
    rank's grid of a train step (``make_train_step``'s)."""
    if step == "train":
        fn = make_train_step(model, AdamW(), TrainStepConfig(
            microbatches=microbatches), grid=grid, zero1=zero1)
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
               microbatches: int = 1, trip_counts: bool = True,
               grid=None, zero1: bool = False):
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
        out = run_step(model, step, inputs, microbatches=microbatches,
                       grid=grid, zero1=zero1)
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
        "collective_bytes_by_axis": {
            a: {k: int(v) for k, v in sorted(d.items())}
            for a, d in sorted(counter.coll_by_axis.items())},
        "flops_outside_kernels": counter.flops,
        "bytes_outside_kernels": counter.hbm_bytes,
    }
    if cfg is not None:
        mf = ra.model_flops(cfg, shape)
        rec.update(model_flops_global=mf,
                   model_flops_per_device=mf / n_devices,
                   useful_flops_frac=(mf / n_devices) / max(roof.flops, 1.0))
    return rec


def cell_mesh(dp: int = 1, tp: int = 1, multi_pod: bool = False):
    """The mesh of a cell: the JAX study's 2×16×16 under ``multi_pod``,
    else ``(dp, tp)``."""
    if multi_pod:
        return make_production_mesh(multi_pod=True)
    return grid_mesh(dp, tp)


def lower_cell(arch: str, shape_name: str, *, dp: int = 1, tp: int = 1,
               multi_pod: bool = False, zero1: bool = False,
               attn_impl: str = "flash", microbatches: int = 1,
               fuse_qkv: bool = False, norm_ct16: bool = False,
               seq_shard_cache: bool = False, shard_experts: bool = False,
               variant: str = "baseline") -> dict:
    """Count rank 0's program of one cell on meta; returns its record (the
    JAX record's keys where they mean something here, see the module
    docstring).  ``multi_pod``: the 2×16×16 mesh (``dp`` and ``tp`` must
    be left at 1); else the ``(dp, tp)`` grid, ``dp=16, tp=16`` the JAX
    single pod.  ``seq_shard_cache``: a decode of a batch above one splits
    its cache's sequence over the model axis (JAX's keyword).
    ``shard_experts``: the MoE experts whole on the model ranks in the
    padded layout, the tokens carried to them by all-to-all (JAX's
    keyword)."""
    if multi_pod and (dp, tp) != (1, 1):
        raise ValueError("multi_pod is the 2x16x16 mesh; dp and tp are its")
    mesh = cell_mesh(dp, tp, multi_pod)
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    grid = counting_grid(mesh)
    head = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "mesh": list(mesh.extents), "n_devices": mesh.size,
            "zero1": zero1}
    if not cell_is_runnable(cfg.subquadratic, shape):
        return {**head, "status": "skipped",
                "reason": "long_500k requires sub-quadratic attention "
                          "(DESIGN.md §5)"}
    why = unsupported(cfg, grid.tp, fuse_qkv, shard_experts)
    if why is not None:
        return {**head, "status": "unsupported", "reason": why}
    kw = grid.model_kw()
    seq_group = None
    if shape.step != "train":
        kw["dp_group"] = None       # a serve's ranks share no collective
    if shape.step == "decode":
        seq_group = grid.seq_group(shape.global_batch, seq_shard_cache)
        kw["seq_group"] = seq_group
    model = Model(cfg, attn_impl=attn_impl, fuse_qkv=fuse_qkv,
                  norm_ct16=norm_ct16, shard_experts=shard_experts, **kw)
    t0 = time.time()
    inputs = input_specs(cfg, shape, model, grid=grid, zero1=zero1)
    counter, mem, out = count_step(model, shape.step, inputs,
                                   microbatches=microbatches, grid=grid,
                                   zero1=zero1)
    del out, inputs
    trace_s = time.time() - t0
    rec = {**head, "status": "ok", "attn_impl": attn_impl,
           "microbatches": microbatches, "variant": variant,
           "seq_shard_cache": seq_shard_cache, "fuse_qkv": fuse_qkv,
           "shard_experts": shard_experts,
           "trace_s": round(trace_s, 2), "compile_s": None,
           "batch_per_rank": rank_batch(shape, grid),
           **record(counter, mem, n_devices=mesh.size, cfg=cfg,
                    shape=shape)}
    notes = []
    if cfg.n_heads % grid.tp:
        what = "xLSTM" if any(st.kind == "xlstm_pair" for st in cfg.stages) \
            else "query"
        notes.append(f"{cfg.n_heads} {what} heads over tp={grid.tp}: "
                     f"GSPMD's padded layout, ceil(H / tp) = "
                     f"{-(-cfg.n_heads // grid.tp)} a rank from rank 0; "
                     f"rank 0, counted here, is the most loaded rank")
    if shard_experts and cfg.moe is not None and grid.tp > 1:
        E = cfg.moe.n_experts
        lo, hi = expert_range(E, 0, grid.tp)
        held = [b - a for a, b in (expert_range(E, r, grid.tp)
                                   for r in range(grid.tp))]
        notes.append(f"shard_experts: {E} experts whole over tp={grid.tp} "
                     f"in GSPMD's padded layout ({held.count(hi - lo)} "
                     f"ranks of {hi - lo}"
                     + "".join(f", {held.count(k)} of {k}"
                               for k in sorted(set(held) - {hi - lo},
                                               reverse=True))
                     + f"); rank 0, counted here, holds experts {lo}-"
                     f"{hi - 1}, the most; the tokens reach them by "
                     f"all-to-all over model")
    attends = any(st.kind in ("attn_mlp", "attn_moe", "zamba_super")
                  for st in cfg.stages)
    if seq_group is not None and attends:
        axis = "model" if seq_group is grid.model else "data"
        lo, hi = model.init_cache(1, shape.seq_len, device="meta")[
            "seq_range"]
        notes.append(f"the decode cache's sequence splits over {axis} "
                     f"({seq_group.size} ranks, {hi - lo} of "
                     f"{shape.seq_len} tokens a rank"
                     f"{', every KV head' if axis == 'model' else ''}); "
                     f"the partial attentions combine over {axis} by "
                     f"their log-sum-exp")
    elif shape.global_batch == 1 and grid.dp_size > 1:
        notes.append(f"a batch of one: no attention cache to split over "
                     f"data; the recurrent state is split by heads over "
                     f"model and replicated over the {grid.dp_size} "
                     f"data-parallel ranks, as in JAX")
    elif shape.global_batch % grid.dp_size:
        rec["batch_replicated"] = True
        notes.append(f"a batch of {shape.global_batch} does not split "
                     f"over dp={grid.dp_size}: every data-parallel rank "
                     f"holds the whole batch and its cache")
    if notes:
        rec["note"] = "; ".join(notes)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the JAX study's 2x16x16 (pod, data, model) mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the JAX study's 16x16 and 2x16x16 meshes")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--attn-impl", default="flash",
                    choices=("flash", "chunked", "folded"))
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = auto (8 for train, 1 otherwise)")
    args = ap.parse_args(argv)
    if (args.multi_pod or args.both_meshes) and (args.dp, args.tp) != (1, 1):
        ap.error("--multi-pod and --both-meshes are the JAX meshes; "
                 "--dp and --tp take another grid")
    if args.both_meshes:
        meshes = [dict(dp=16, tp=16), dict(multi_pod=True)]
    elif args.multi_pod:
        meshes = [dict(multi_pod=True)]
    else:
        meshes = [dict(dp=args.dp, tp=args.tp)]

    def key(r):
        return (r["arch"], r["shape"], tuple(r.get("mesh", ())),
                r.get("attn_impl", "flash"), bool(r.get("zero1", False)))

    done = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    done.add(key(json.loads(line)))
                except Exception:
                    pass

    archs = ASSIGNED if args.all or not args.arch else [args.arch]
    shapes = [s.name for s in ALL_SHAPES] if args.all or not args.shape \
        else [args.shape]
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for m in meshes:
                    mesh = cell_mesh(**m)
                    head = {"arch": arch, "shape": shape,
                            "multi_pod": m.get("multi_pod", False),
                            "mesh": list(mesh.extents),
                            "n_devices": mesh.size, "zero1": args.zero1,
                            "attn_impl": args.attn_impl}
                    if key(head) in done:
                        print(f"skip (done): {key(head)}")
                        continue
                    print(f"=== {arch} x {shape} mesh={head['mesh']} "
                          f"zero1={args.zero1} ===", flush=True)
                    mb = args.microbatches
                    if mb == 0:
                        mb = 8 if get_shape(shape).step == "train" else 1
                    try:
                        rec = lower_cell(arch, shape, zero1=args.zero1,
                                         attn_impl=args.attn_impl,
                                         microbatches=mb, **m)
                    except Exception as e:
                        rec = {**head, "status": "error",
                               "error": str(e)[:2000],
                               "traceback": traceback.format_exc()[-4000:]}
                    print(json.dumps({k: v for k, v in rec.items()
                                      if k != "traceback"}), flush=True)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()


if __name__ == "__main__":
    main()
