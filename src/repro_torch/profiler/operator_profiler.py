"""Operator-level profiler (paper §II-A) for the port's models.

The port of ``repro/profiler/operator_profiler.py``.  Two backends:

  * **measured** — times each operator class on one torch device (None:
    the card) over a (tokens × context) grid: ``attn_qkv``, ``mlp`` or
    ``moe_ffn``, ``norm``, ``head``, ``embed``, and ``attn_score`` for
    decode and prefill.  On the card ``attn_score`` runs the port's kernels
    through ``kernels/ops.py`` (paged decode over an identity block table,
    flash attention for prefill) and ``moe_ffn`` launches the grouped
    matmul; on the CPU the same calls run their plain versions.  Each
    point is the median wall time of ``reps`` calls, each ending in
    ``torch.cuda.synchronize()`` on the card.
  * **analytical** — derives the same grid from a ``HardwareSpec`` roofline
    (``repro_torch.hw.synthetic``), for a device that is not at hand.

Both emit a ``repro_torch.core.trace.Trace`` consumed by the simulator's
PerfModel.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.config import HardwareSpec
from repro_torch.core.trace import Trace
from repro_torch.hw.specs import get_hw
from repro_torch.hw.synthetic import add_synthetic_points
from repro_torch.profiler.arch_spec import model_spec_from_arch

DEFAULT_TOKEN_GRID = (1, 2, 4, 8, 16, 32, 64, 128, 256)
DEFAULT_CTX_GRID = (64, 256, 1024)


def _time_fn(fn, *args, device: torch.device, reps: int = 5,
             warmup: int = 2) -> float:
    def call():
        fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    for _ in range(warmup):
        call()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@dataclasses.dataclass
class ProfilerConfig:
    arch: str
    # the trace's label; None: cpu-measured, or h100 when measured on the
    # card (measured_label)
    hardware: Optional[str] = None
    mode: str = "measured"             # measured | analytical
    token_grid: Sequence[int] = DEFAULT_TOKEN_GRID
    ctx_grid: Sequence[int] = DEFAULT_CTX_GRID
    tp: int = 1
    seed: int = 0
    device: Optional[str] = None       # measured mode: torch device


class OperatorProfiler:
    def __init__(self, pcfg: ProfilerConfig):
        self.pcfg = pcfg
        self.cfg = get_config(pcfg.arch)

    # ---- measured backend ----
    def _measured_points(self, trace: Trace, dev: torch.device):
        from repro_torch.kernels import ops
        from repro_torch.models.layers import rmsnorm, swiglu_mlp
        from repro_torch.models.moe import moe_ffn

        cfg = self.cfg
        gen = torch.Generator(device=dev).manual_seed(self.pcfg.seed)
        d, dh = cfg.d_model, cfg.d_head
        H, KV = cfg.n_heads, cfg.n_kv_heads
        dt = torch.bfloat16
        ps = 64

        def rand(*shape, scale=0.02):
            return (torch.randn(shape, generator=gen, device=dev)
                    * scale).to(dt)

        def time_fn(fn, *args):
            return _time_fn(fn, *args, device=dev)

        wq, wk = rand(d, H * dh), rand(d, KV * dh)
        wo, wz = rand(H * dh, d), torch.zeros((KV * dh, d), dtype=dt,
                                              device=dev)
        ff = max(cfg.d_ff, 8)
        w_gate, w_up, w_down = rand(d, ff), rand(d, ff), rand(ff, d)
        head_w = rand(d, cfg.padded_vocab)
        emb = rand(cfg.padded_vocab, d)
        scale = torch.zeros((d,), device=dev)
        moe_params = None
        if cfg.moe:
            E, de = cfg.moe.n_experts, cfg.moe.d_expert
            moe_params = {"router": rand(d, E), "w_gate": rand(E, d, de),
                          "w_up": rand(E, d, de), "w_down": rand(E, de, d)}

        for T in self.pcfg.token_grid:
            x = rand(T, d, scale=1.0)
            # qkv + out projections
            t = time_fn(lambda x: (x @ wq) @ wo + (x @ wk) @ wz, x)
            trace.add("attn_qkv", "decode", T, 1, t)
            trace.add("attn_qkv", "prefill", T, T, t)
            # mlp or moe
            if moe_params is None:
                t = time_fn(lambda x: swiglu_mlp(x, w_gate, w_up, w_down), x)
                trace.add("mlp", "decode", T, 1, t)
                trace.add("mlp", "prefill", T, T, t)
            else:
                t = time_fn(lambda x: moe_ffn(
                    x, moe_params, top_k=cfg.moe.top_k)[0], x)
                trace.add("moe_ffn", "decode", T, 1, t)
                trace.add("moe_ffn", "prefill", T, T, t)
            # norm
            t = time_fn(lambda x: rmsnorm(x, scale), x)
            trace.add("norm", "decode", T, 1, t)
            trace.add("norm", "prefill", T, T, t)
            # head + embed
            t = time_fn(lambda x: x @ head_w, x)
            trace.add("head", "decode", T, 1, t)
            trace.add("head", "prefill", T, T, t)
            ids = torch.zeros((T,), dtype=torch.long, device=dev)
            t = time_fn(lambda i: emb[i], ids)
            trace.add("embed", "decode", T, 1, t)
            trace.add("embed", "prefill", T, T, t)

        # attention score/context term over the ctx grid
        for ctx in self.pcfg.ctx_grid:
            npg = -(-ctx // ps)
            for B in (1, 4, 16, 64):
                q = rand(B, H, dh, scale=1.0)
                kp = rand(B * npg, ps, KV, dh, scale=1.0)
                vp = rand(B * npg, ps, KV, dh, scale=1.0)
                table = torch.arange(B * npg, dtype=torch.int32,
                                     device=dev).reshape(B, npg)
                lengths = torch.full((B,), ctx, dtype=torch.int32,
                                     device=dev)
                t = time_fn(lambda q, kp, vp: ops.paged_attention(
                    q, kp, vp, table, lengths, page_size=ps), q, kp, vp)
                trace.add("attn_score", "decode", B, ctx, t)
            # prefill attention (flash) for one sequence of length ctx
            q = rand(1, ctx, H, dh, scale=1.0)
            kk = rand(1, ctx, KV, dh, scale=1.0)
            vv = rand(1, ctx, KV, dh, scale=1.0)
            t = time_fn(lambda q, kk, vv: ops.flash_attention(q, kk, vv),
                        q, kk, vv)
            trace.add("attn_score", "prefill", ctx, ctx, t)

    # ---- analytical backend ----
    def _analytical_points(self, trace: Trace, hw: HardwareSpec):
        # the analytical model lives once, in the synthetic-trace generator
        add_synthetic_points(trace, hw, model_spec_from_arch(self.cfg),
                             tp=self.pcfg.tp,
                             token_grid=self.pcfg.token_grid,
                             ctx_grid=self.pcfg.ctx_grid)

    # ---- entry ----
    def profile(self) -> Trace:
        from repro_torch.profiler.runtime_profiler import measured_label
        from repro_torch.serve.engine import resolve_device
        pcfg = self.pcfg
        t0 = time.time()
        if pcfg.mode == "measured":
            dev = torch.device(pcfg.device or "cuda")
            trace = Trace(model=pcfg.arch, tp=pcfg.tp,
                          hardware=measured_label(pcfg.hardware, dev,
                                                  "cpu-measured"))
            self._measured_points(trace, resolve_device(dev))
        else:
            hardware = pcfg.hardware or "cpu-measured"
            trace = Trace(model=pcfg.arch, hardware=hardware, tp=pcfg.tp)
            self._analytical_points(trace, get_hw(hardware))
        trace.meta["profile_wall_s"] = time.time() - t0
        trace.meta["mode"] = pcfg.mode
        trace.meta["n_points"] = len(trace.points)
        return trace


def profile_arch(arch: str, hardware: Optional[str] = None,
                 mode: str = "measured", tp: int = 1, **kw) -> Trace:
    return OperatorProfiler(ProfilerConfig(
        arch=arch, hardware=hardware, mode=mode, tp=tp, **kw)).profile()
