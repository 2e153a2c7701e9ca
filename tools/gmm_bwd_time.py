"""Time the grouped matmul's backward kernel of the checkout this file sits
in, on the card, at the training shapes ``chip_smoke.py`` phase 3 times
(``gmm_train_timings``: phimini-moe's B2 S1024 step, 2048 tokens routed
top-2 over 16 experts by the same seeded draw, capacity 320; gate/up d 4096
-> f 960 and down 960 -> 4096, bf16, the same inputs), check it against
its plain version once, and split one profiled call's device time between
the dx kernel and the dw kernel by kernel name.

    python3 tools/gmm_bwd_time.py [--reps 20] [--calls 5]

Prints one JSON line: the card (``nvidia-smi``'s name and power limit),
and per shape the backward's median time (CUDA events, L2 flushed,
``chip_smoke.time_ms``), the library's (autograd through ``torch.bmm``
times the row mask), the bound (phase 3's), the largest error against the
plain version, and the device time of each kernel per call from
``--calls`` calls under ``torch.profiler`` (dx, dw, and anything else the
call launched).  The checkout is built on first use
(``repro_torch.kernels.build``).  To compare two checkouts, run both in
one call on one card, in turns (base, change, change, base); a checkout
without this file takes a copy of it in its ``tools/``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

E, TOP_K, TOKENS = 16, 2, 2048
PARTS = ((4096, 960, "gate_up"), (960, 4096, "down"))


def kernel_part(name: str) -> str:
    """dx, dw or other, by the kernel's name (either build of the file:
    the dx kernel ran on the forward's ``gmm_wgmma_kernel`` before it had
    its own)."""
    if "gmm_dx" in name or "gmm_wgmma_kernel" in name:
        return "dx"
    if "gmm_dw" in name:
        return "dw"
    return "other"


def split(torch, fn, calls):
    """Device ms per call of ``fn`` by kernel part, over ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {"dx": [0.0, 0], "dw": [0.0, 0], "other": [0.0, 0]}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and getattr(e, "device_type", None) != \
                torch.autograd.DeviceType.CPU:
            part = out[kernel_part(e.key)]
            part[0] += us / 1e3 / calls
            part[1] += e.count
    return {k: {"ms": ms, "launches": n} for k, (ms, n) in out.items()}


def rows(torch, chip_smoke, ops, reps, calls):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    C = round(TOKENS * TOP_K * 1.25 / E)
    pick = torch.rand((TOKENS, E), generator=gen, device=dev).argsort(-1)[
        :, :TOP_K]
    counts = torch.bincount(pick.reshape(-1), minlength=E)
    gs = torch.clamp(counts, max=C).to(torch.int32)
    n_rows = int(gs.sum())
    active = int((gs > 0).sum())
    mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
    out = []
    for d, f, part in PARTS:
        x = chip_smoke._rand(torch, gen, (E, C, d), bf, dev)
        w = chip_smoke._rand(torch, gen, (E, d, f), bf, dev) * d ** -0.5
        dy = chip_smoke._rand(torch, gen, (E, C, f), bf, dev)
        got = ops.moe_gmm_bwd(x, w, gs, dy)
        want = ops.moe_gmm_bwd_plain(x, w, gs, dy)
        err = max(float((g.float() - r.float()).abs().max())
                  for g, r in zip(got, want))
        xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
        ref = torch.bmm(xl, wl) * mask
        nbytes = active * d * f * 2 + n_rows * (d + f) * 2 \
            + (E * C * d + E * d * f) * 2 + E * 4
        bound_ms, bound_by = chip_smoke.bound(nbytes, 4 * n_rows * d * f)
        out.append({
            "part": part,
            "shape": f"E{E} C{C} d{d} f{f} bf16, {active} experts active, "
                     f"{n_rows} rows",
            "ms": chip_smoke.time_ms(
                torch, lambda: ops.moe_gmm_bwd(x, w, gs, dy), reps=reps),
            "library_ms": chip_smoke.time_ms(
                torch, lambda: torch.autograd.grad(ref, (xl, wl), dy,
                                                   retain_graph=True),
                reps=reps),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err,
            "split": split(torch, lambda: ops.moe_gmm_bwd(x, w, gs, dy),
                           calls)})
        del x, w, dy, got, want, xl, wl, ref
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gmm_bwd_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "root": str(ROOT),
                      "rows": rows(torch, chip_smoke, ops, args.reps,
                                   args.calls)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
