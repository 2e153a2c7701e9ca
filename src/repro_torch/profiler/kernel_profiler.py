"""Kernel-granular profiler: per-kernel latency sub-buckets (hwtrace/3).

The port of ``repro/profiler/kernel_profiler.py``.  Where
``runtime_profiler`` measures whole engine iterations, this module times
the four kernels one forward pass composes from — ``attention`` (qkv
projection + flash/paged attention + output projection), ``mlp``,
``moe_gmm`` (capacity-dispatched expert FFN: gate, up and down), and
``head`` — in isolation, per kernel backend, over the buckets the runtime
profiler sweeps.  The rows land in a ``HardwareTrace`` as
``kern:<backend>:<kernel>`` points:

* ``cuda`` times the port's kernel wrappers (``kernels/ops.py``): flash
  attention for prefill, paged decode for decode, the grouped ``moe_gmm``
  for the expert FFN.  It needs the card: on CPU tensors the wrappers run
  their plain versions, which would then be labelled as the kernels, so a
  ``cuda`` sweep on a CPU device raises.
* ``reference`` times the plain versions (``kernels/ref.py``) on the same
  device.

Row keys match ``PerfModel._kernel_level``: prefill rows at ``(tokens=T,
context=T)``, decode rows at ``(tokens=B, context=c)``.  Each point is the
median wall time of ``reps`` calls after one warm call, each call ending in
``torch.cuda.synchronize()`` on the card: host-inclusive, like the JAX
package's, because the rows price iterations.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.core.trace import OpPoint
from repro_torch.hw.trace import HardwareTrace, kern_op
from repro_torch.models.transformer import torch_dtype

#: kernel backends a sweep can target
SWEEP_BACKENDS = ("reference", "cuda")


def _median_time(fn, args, reps: int, device: torch.device) -> float:
    def call():
        fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    call()                                     # warm (and build the kernel)
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        lat.append(time.perf_counter() - t0)
    return float(np.median(lat))


def kernel_points(arch: str, backend: str, *,
                  max_batch: int = 4, max_len: int = 512,
                  prefill_buckets: Sequence[int] = (16, 32, 64, 128, 256),
                  decode_ctxs: Sequence[int] = (32, 64, 128, 256),
                  reps: int = 3, seed: int = 0, page_size: int = 64,
                  device=None) -> List[OpPoint]:
    """Sweep one kernel backend for ``arch`` on ``device`` (None: the
    card); returns ``kern:*`` OpPoints."""
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.engine import resolve_device

    if backend not in SWEEP_BACKENDS:
        raise ValueError(f"kernel sweep backend must be one of "
                         f"{SWEEP_BACKENDS}, got {backend!r}")
    dev = resolve_device(device)
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError(
            f"the cuda kernel sweep needs the card, got device {dev}: on "
            f"the CPU the wrappers run their plain versions (sweep "
            f"'reference' there)")
    cfg = get_config(arch)
    dt = torch_dtype(cfg.compute_dtype)
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device=dev).manual_seed(seed)
    if backend == "cuda":
        flash, paged, gmm = (ops.flash_attention, ops.paged_attention,
                             ops.moe_gmm)
    else:
        flash = ref.flash_attention_ref
        paged, gmm = ref.paged_attention_ref, ref.moe_gmm_ref

    def rand(*shape):
        return (torch.randn(shape, generator=gen, device=dev)
                * shape[-1] ** -0.5).to(dt)

    wqkv = rand(d, (H + 2 * KV) * dh)
    wo = rand(H * dh, d)
    wh = rand(d, cfg.vocab).float()
    pts: List[OpPoint] = []

    def add(kernel, phase, tokens, context, fn, args):
        pts.append(OpPoint(kern_op(backend, kernel), phase, int(tokens),
                           int(context), _median_time(fn, args, reps, dev)))

    def split_qkv(x):
        """(N, d) -> q (N,H,dh), k/v (N,KV,dh) via one fused projection."""
        qkv = x @ wqkv
        n = x.shape[0]
        return (qkv[:, :H * dh].reshape(n, H, dh),
                qkv[:, H * dh:(H + KV) * dh].reshape(n, KV, dh),
                qkv[:, (H + KV) * dh:].reshape(n, KV, dh))

    def batches():
        return sorted({1, max(1, max_batch // 2), max_batch})

    # ---- attention: prefill (flash) ----
    def attn_prefill(x, lengths):
        T = x.shape[0]
        q, k, v = (t[None].contiguous() for t in split_qkv(x))
        o = flash(q, k, v, lengths=lengths)
        return o.reshape(T, H * dh) @ wo

    for T in prefill_buckets:
        if T >= max_len:
            continue
        add("attention", "prefill", T, T, attn_prefill,
            (rand(T, d), torch.full((1,), T, dtype=torch.int32,
                                    device=dev)))

    # ---- attention: decode (paged) ----
    def attn_decode(x, kp, vp, table, lengths):
        q = split_qkv(x)[0].contiguous()
        o = paged(q, kp, vp, table, lengths, page_size=page_size)
        return o.reshape(-1, H * dh) @ wo

    for ctx in decode_ctxs:
        if ctx + 16 >= max_len:
            continue
        npg = -(-ctx // page_size)
        for nb in batches():
            kp = rand(nb * npg, page_size, KV, dh)
            vp = rand(nb * npg, page_size, KV, dh)
            table = torch.arange(nb * npg, dtype=torch.int32,
                                 device=dev).reshape(nb, npg)
            lengths = torch.full((nb,), ctx, dtype=torch.int32, device=dev)
            add("attention", "decode", nb, ctx, attn_decode,
                (rand(nb, d), kp, vp, table, lengths))

    # ---- ffn: mlp or moe_gmm ----
    if cfg.moe is None:
        wg, wu = rand(d, cfg.d_ff), rand(d, cfg.d_ff)
        wd = rand(cfg.d_ff, d)

        def mlp(x):
            h = F.silu(x @ wg) * (x @ wu) if cfg.mlp_gated \
                else F.gelu(x @ wg, approximate="tanh")
            return h @ wd

        def ffn_at(phase, tokens, context):
            add("mlp", phase, tokens, context, mlp, (rand(tokens, d),))
    else:
        E, k_top = cfg.moe.n_experts, cfg.moe.top_k
        de = cfg.moe.d_expert
        weg, weu = rand(E, d, de), rand(E, d, de)
        wed = rand(E, de, d)

        def moe(xe, gs):
            h = F.silu(gmm(xe, weg, gs)) * gmm(xe, weu, gs)
            return gmm(h.contiguous(), wed, gs)

        def ffn_at(phase, tokens, context):
            # capacity-dispatched expert FFN at this batch's expert load
            C = max(1, int(np.ceil(tokens * k_top
                                   * cfg.moe.capacity_factor / E)))
            gs = torch.full((E,), min(C, tokens), dtype=torch.int32,
                            device=dev)
            add("moe_gmm", phase, tokens, context, moe, (rand(E, C, d), gs))

    # ---- head ----
    def head(x):
        return x.float() @ wh

    for T in prefill_buckets:
        if T >= max_len:
            continue
        ffn_at("prefill", T, T)
        add("head", "prefill", T, T, head, (rand(T, d),))
    for ctx in decode_ctxs:
        if ctx + 16 >= max_len:
            continue
        for nb in batches():
            ffn_at("decode", nb, ctx)
            add("head", "decode", nb, ctx, head, (rand(nb, d),))
    return pts


def add_kernel_grid(hwt: HardwareTrace, arch: str,
                    backends: Sequence[str] = SWEEP_BACKENDS,
                    device: Optional[str] = None,
                    **kwargs) -> HardwareTrace:
    """Sweep ``backends`` on ``device`` and append the rows to ``hwt``'s
    base grid (kernel sweeps are single-device; the perf model composes
    tp collectives analytically on top of kernel rows).  The artifact's
    ``meta["kernel_launches"]`` keeps, per backend, how many times the
    sweep launched each port kernel (0 for ``reference``)."""
    from repro_torch.kernels import ops
    t0 = time.time()
    launches = {}
    for backend in backends:
        before = ops.launch_counts()
        hwt.points.extend(kernel_points(arch, backend, device=device,
                                        **kwargs))
        launches[backend] = {k: n - before[k]
                             for k, n in ops.launch_counts().items()}
    hwt.meta["kernel_backends"] = list(backends)
    hwt.meta["kernel_launches"] = launches
    hwt.meta["kernel_wall_s"] = round(time.time() - t0, 3)
    return hwt
