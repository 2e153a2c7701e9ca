"""Time the flash backward kernel of the checkout this file sits in, on the
card, at the training shapes ``chip_smoke.py`` phase 3 times (demo-110m's
B8 S1024 H12 KV4 dh64 and llama3.1-8b's B2 S1024 H32 KV8 dh128, bf16),
and check it against its plain version once.

    python3 tools/flash_bwd_time.py [--reps 20]

Prints one JSON line: the card, and per shape the kernel's median time
(CUDA events, L2 flushed, ``chip_smoke.time_ms``) and the largest error
against the plain version.  To compare two checkouts, run both in one
call on one card, in turns (base, change, change, base).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SHAPES = ((8, 1024, 12, 4, 64), (2, 1024, 32, 8, 128))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels import ops
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
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
                                                   lt), reps=args.reps)
        rows.append({"shape": f"B{B} S{S} H{H} KV{KV} dh{dh} bf16",
                     "ms": ms, "max_abs_err": err})
        del q, k, v, do, out, lse, got, want
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "root": str(ROOT), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
