"""Measure the paged decode kernel's pages per split on the card.

    python3 tools/paged_split_sweep.py

The decode kernel (``paged_decode_split_kernel`` in
``src/repro_torch/kernels/csrc/paged_attention.cu``) gives each block a
fixed range of pages; how many is a constant of the source.  This script
builds the library once for each of 1, 2 and 4 pages per split (with
``-DREPRO_PAGED_PAGES_PER_SPLIT=<n>``; nothing else sets that macro) into
``build/paged_split_sweep/``, checks each build against the plain version
in f32 and bf16, and times the bf16 decode at the llama3.1-8b serve's shape
(B 8, H 32, KV 8, dh 128, page size 64, 32 pages a table, lengths 97 to
1056), with ``chip_smoke.time_ms`` (median of 20 CUDA-event timings, L2
flushed before each), in three rounds that alternate the order of the
values.  Prints the card, one line per value and a JSON line.  Needs one
CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VALUES = (1, 2, 4)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("paged_split_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import paged_attention as pa
    card = chip_smoke.card_and_setup(torch)
    out_dir = build.BUILD_ROOT.parent / "paged_split_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in VALUES:                       # one nvcc per value, all at once
        cmd = [build._nvcc(), *build.NVCC_FLAGS,
               f"-DREPRO_PAGED_PAGES_PER_SPLIT={v}", "-I", str(build.CSRC),
               "-o", str(out_dir / f"libpaged_pps{v}.so"),
               str(build.CSRC / "paged_attention.cu"), *build.LINK_FLAGS]
        procs[v] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    libs = {}
    for v, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed for {v} pages per split:\n{log}",
                  file=sys.stderr)
            return 1
        libs[v] = ctypes.CDLL(str(out_dir / f"libpaged_pps{v}.so"))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, H, KV, dh, ps, maxp = 8, 32, 8, 128, 64, 32
    lens = (97, 180, 333, 512, 640, 781, 900, 1056)
    P = B * maxp + 1
    table = torch.randperm(P - 1, generator=gen, device=dev)[
        :B * maxp].reshape(B, maxp).to(torch.int32)
    lt = torch.tensor(lens, dtype=torch.int32, device=dev)
    inputs = {}
    for dtype in (torch.float32, torch.bfloat16):
        inputs[dtype] = tuple(
            chip_smoke._rand(torch, gen, shape, dtype, dev)
            for shape in ((B, H, dh), (P, ps, KV, dh), (P, ps, KV, dh)))

    def run(dtype):
        q, kp, vp = inputs[dtype]
        return ops.paged_attention(q, kp, vp, table, lt, page_size=ps)

    nbytes = sum(lens) * KV * dh * 2 * 2 + 2 * B * H * dh * 2 \
        + table.numel() * 4 + B * 4
    bound_ms = chip_smoke.bound(nbytes, 4 * sum(lens) * H * dh)[0]
    times = {v: [] for v in VALUES}
    for rnd in range(3):
        order = VALUES if rnd % 2 == 0 else VALUES[::-1]
        for v in order:
            build._libs["paged_attention"] = libs[v]
            pa._SPLITS.clear()             # the split count is the build's
            if rnd == 0:                   # each build right before timing
                for dtype in inputs:
                    got = run(dtype)
                    want = ops.paged_attention_plain(
                        *inputs[dtype], table, lt, page_size=ps)
                    dn = str(dtype).split(".")[-1]
                    ok, err = chip_smoke._close(torch, got, want, dn)
                    if not ok or not torch.equal(got, run(dtype)):
                        print(f"{v} pages per split, {dn}: disagrees with "
                              f"the plain version ({err}) or with itself",
                              file=sys.stderr)
                        return 1
            times[v].append(chip_smoke.time_ms(
                torch, lambda: run(torch.bfloat16)))
    build._libs.pop("paged_attention", None)
    pa._SPLITS.clear()
    rows = []
    for v in VALUES:
        splits = libs[v].paged_decode_splits(maxp)
        ms = statistics.median(times[v])
        rows.append({"pages_per_split": v, "n_split": splits, "ms": ms,
                     "ms_rounds": times[v], "bound_ms": bound_ms})
        print(f"[{card}] {v} pages per split ({splits} splits): "
              f"{ms:.4f} ms (rounds {', '.join(f'{t:.4f}' for t in times[v])}"
              f"), bound {bound_ms:.4f} ms")
    best = min(rows, key=lambda r: r["ms"])["pages_per_split"]
    print(json.dumps({"card": card, "shape": f"B{B} H{H} KV{KV} dh{dh} "
                      f"ps{ps} maxp{maxp} len{lens} bf16",
                      "sweep": rows, "fastest": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
