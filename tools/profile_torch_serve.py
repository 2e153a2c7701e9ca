"""Where the time goes when the PyTorch port serves on one card.

    python3 tools/profile_torch_serve.py [--arch llama3.1-8b|phimini-moe|
                                          zamba2-1.2b|xlstm-125m]

Builds a serve of ``chip_smoke.py`` (full-width ``--arch``, llama3.1-8b by
default, bf16, seeded random weights, 8 requests, batch 8: chunked prefill
of 256 as phase 4 serves, or for the recurrent families phase 7's serve),
runs it once without the profiler and once under
``torch.profiler``, and prints:
the wall time of each run, the device's busy and idle share of the
profiled run, device time by kernel class (the port's attention kernels,
matrix products, everything else) and the top kernels by device time.
Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


#: (kernel name in csrc/*.cu, class): the kernels of both dtypes; a name
#: is matched as a substring, in this order, so demangled ("void
#: repro_gmm::gmm_kernel<...>(...)") and mangled symbols both fall into
#: their class.  The grouped matmul backward's bf16 kernels (dx and dw)
#: have names of their own and the backward's class; its f32 dx runs the
#: forward's FMA kernel (``gmm_kernel`` with its WT template argument, the
#: last, true) and falls into the forward's class
PORT_CLASSES = (("gmm_dx_wgmma_kernel", "moe_gmm_bwd (port)"),
                ("gmm_dw_wgmma_kernel", "moe_gmm_bwd (port)"),
                ("gmm_dw_kernel", "moe_gmm_bwd (port)"),
                ("flash_fwd_kernel", "flash_attention (port)"),
                ("flash_fwd_wgmma_kernel", "flash_attention (port)"),
                ("paged_fwd_kernel", "paged_attention (port)"),
                ("paged_decode_split_kernel", "paged_attention (port)"),
                ("paged_extend_wgmma_kernel", "paged_attention (port)"),
                ("gmm_kernel", "moe_gmm (port)"),
                ("gmm_wgmma_kernel", "moe_gmm (port)"),
                ("flash_bwd_delta_kernel", "flash_attention_bwd (port)"),
                ("flash_bwd_dkdv_kernel", "flash_attention_bwd (port)"),
                ("flash_bwd_dq_kernel", "flash_attention_bwd (port)"),
                ("flash_bwd_dkdv_wgmma_kernel", "flash_attention_bwd (port)"),
                ("flash_bwd_dq_wgmma_kernel", "flash_attention_bwd (port)"),
                ("rope_qk_kernel", "rope (port)"))


def _kernel_class(name: str) -> str:
    for key, cls in PORT_CLASSES:
        if key in name:
            return cls
    n = name.lower()
    if any(k in n for k in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.1-8b",
                    choices=("llama3.1-8b", "phimini-moe", "zamba2-1.2b",
                             "xlstm-125m"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_and_setup(torch)
    setup = chip_smoke.recurrent_serve_setup \
        if args.arch in (chip_smoke.ZAMBA_PATH, chip_smoke.XLSTM_PATH) \
        else chip_smoke.full_serve_setup

    _, eng, drv, reqs = setup(torch, args.arch)
    t0 = time.perf_counter()
    m = drv.run(reqs, warmup=False)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    n_iter = m["instances"]["e0"]["engine_iterations"]
    del eng, drv
    gc.collect()             # ServeDriver and its runtime form a cycle
    torch.cuda.empty_cache()

    _, eng, drv, reqs = setup(torch, args.arch)
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        drv.run(reqs, warmup=False)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0

    kernels = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0 and getattr(e, "device_type", None) != \
                torch.autograd.DeviceType.CPU:
            kernels[e.key] = (dev_us / 1e3, e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    print(f"[{card}] {args.arch} serve of chip_smoke.py: {n_iter} "
          f"iterations, wall "
          f"{wall_plain * 1e3:.1f} ms without the profiler, "
          f"{wall_prof * 1e3:.1f} ms under it")
    print(f"device busy {busy_ms:.1f} ms = "
          f"{100 * busy_ms / (wall_prof * 1e3):.1f}% of the profiled wall "
          f"(idle {100 - 100 * busy_ms / (wall_prof * 1e3):.1f}%), "
          f"{100 * busy_ms / (wall_plain * 1e3):.1f}% of the unprofiled "
          f"one")
    by_class = {}
    for name, (ms, n) in kernels.items():
        c = _kernel_class(name)
        t, k = by_class.get(c, (0.0, 0))
        by_class[c] = (t + ms, k + n)
    for c, (ms, n) in sorted(by_class.items(), key=lambda x: -x[1][0]):
        print(f"  {c}: {ms:.1f} ms over {n} launches "
              f"({100 * ms / busy_ms:.1f}% of device time)")
    print("top kernels by device time:")
    for name, (ms, n) in sorted(kernels.items(), key=lambda x: -x[1][0])[:12]:
        print(f"  {ms:9.2f} ms {n:6d}x  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
