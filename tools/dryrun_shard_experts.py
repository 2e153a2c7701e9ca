"""The dry run's cells of ``shard_experts`` beside the same cells without
it, on the meta device (no card needed).

For each MoE arch, at the JAX study's 16x16 and 2x16x16 meshes: the two
hill-climb cells of ``results/run_hillclimb.py`` (``train_4k`` at 8
microbatches with ZeRO-1, with and without ``fuse_qkv``), ``prefill_32k``
and ``decode_32k``, each with ``shard_experts`` off and on.  One JSON
record a cell goes to ``--out`` (``dryrun.lower_cell``'s record), and a
line a cell to stdout: the need (argument + temp bytes), the roofline's
compute, memory and collective seconds, the collective result bytes by
axis and kind, and under ``shard_experts`` rank 0's rows sent by the
all-to-all (``E · n_s`` a MoE layer each way, the static blocks) against
the rows its tokens route (``ceil(T / tp) · k``).

Usage:
  PYTHONPATH=src python tools/dryrun_shard_experts.py \
      [--arch granite-moe-3b-a800m] [--out build/dryrun_shard_experts.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import get_config, get_shape
from repro_torch.core.expert import expert_capacity
from repro_torch.launch import dryrun

ARCHS = ("granite-moe-3b-a800m", "granite-moe-1b-a400m")
#: (shape, label, lower_cell keywords)
CELLS = (("train_4k", "train mb8 zero1", dict(microbatches=8, zero1=True)),
         ("train_4k", "train mb8 zero1 fuse_qkv",
          dict(microbatches=8, zero1=True, fuse_qkv=True)),
         ("prefill_32k", "prefill", {}),
         ("decode_32k", "decode", {}))
MESHES = (("16x16", dict(dp=16, tp=16)), ("2x16x16", dict(multi_pod=True)))


def rows(arch: str, shape_name: str, rec: dict) -> dict:
    """Rank 0's rows a MoE layer each way: sent (the static blocks, E ·
    n_s) and routed (its tokens' entries, ceil(T / tp) · k)."""
    cfg, shape = get_config(arch), get_shape(shape_name)
    mesh = rec["mesh"]
    tp = mesh[-1]
    dp = rec["n_devices"] // tp
    B = shape.global_batch
    B = B // dp if B % dp == 0 else B
    mb = rec.get("microbatches", 1) if shape.step == "train" else 1
    T = (B // mb) * (1 if shape.step == "decode" else shape.seq_len)
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    ndp = dp if shape.step == "train" else 1
    C = expert_capacity(T * ndp, k, E, cfg.moe.capacity_factor)
    n_s = min(C, -(-T // tp))
    return {"tokens": T, "C": C, "n_s": n_s, "sent": E * n_s,
            "routed": -(-T // tp) * k}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append")
    ap.add_argument("--out", default="build/dryrun_shard_experts.jsonl")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        for arch in args.arch or ARCHS:
            for shape, label, kw in CELLS:
                for mname, mkw in MESHES:
                    for se in (False, True):
                        rec = dryrun.lower_cell(arch, shape,
                                                shard_experts=se, **kw,
                                                **mkw)
                        rec["label"] = label
                        if se and rec["status"] == "ok":
                            rec["a2a_rows_rank0"] = rows(arch, shape, rec)
                        f.write(json.dumps(rec) + "\n")
                        f.flush()
                        r = rec.get("roofline", {})
                        m = rec.get("memory", {})
                        need = (m.get("argument_size_in_bytes", 0)
                                + m.get("temp_size_in_bytes", 0)) / 1e9
                        print(json.dumps({
                            "arch": arch, "cell": label, "mesh": mname,
                            "shard_experts": se, "status": rec["status"],
                            "need_gb": round(need, 3),
                            "t_compute_s": r.get("t_compute_s"),
                            "t_memory_s": r.get("t_memory_s"),
                            "t_collective_s": r.get("t_collective_s"),
                            "bytes": rec.get("collective_bytes_by_axis"),
                            "rows": rec.get("a2a_rows_rank0"),
                            "trace_s": rec.get("trace_s")}), flush=True)


if __name__ == "__main__":
    main()
