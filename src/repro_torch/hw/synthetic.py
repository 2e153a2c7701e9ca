"""Synthetic hardware traces from an analytical roofline (jax-free).

This is the "integrate a hypothetical accelerator instantly" path (paper
Table III): given a ``HardwareSpec`` (peak FLOP/s, HBM bandwidth, link
bandwidth) and a ``ModelSpec``, derive the same operator-latency grid the
measured profiler would emit.  The analytical model lives here ONCE — the
operator profiler's analytical mode and the hardware registry's fallback
both call :func:`add_synthetic_points`, and ``core.perfmodel`` keeps only a
per-query roofline for op/shape combos outside any trace grid.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.config import HardwareSpec, ModelSpec
from repro_torch.hw.trace import HardwareTrace, InterconnectSpec

DEFAULT_TOKEN_GRID = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
DEFAULT_CTX_GRID = (64, 256, 1024, 4096)
DEFAULT_BATCH_GRID = (1, 4, 16, 64)


def add_synthetic_points(trace, spec: HardwareSpec, model: ModelSpec,
                         tp: int = 1,
                         token_grid: Sequence[int] = DEFAULT_TOKEN_GRID,
                         ctx_grid: Sequence[int] = DEFAULT_CTX_GRID,
                         batch_grid: Sequence[int] = DEFAULT_BATCH_GRID):
    """Fill ``trace`` (anything with an ``add(op, phase, tokens, context,
    latency_s)`` method) with analytical operator points for one device."""
    tp = max(tp, 1)

    def roof(flops: float, nbytes: float) -> float:
        return max(flops / (spec.peak_flops * spec.mmu_efficiency),
                   nbytes / spec.hbm_bw) + 2e-6

    d, dh = model.d_model, model.d_head
    qkv_d = (model.n_heads + 2 * model.n_kv_heads) * dh
    for T in token_grid:
        for phase, ctx in (("decode", 1), ("prefill", T)):
            wb = (d * qkv_d + model.n_heads * dh * d) / tp * 2
            trace.add("attn_qkv", phase, T, ctx, roof(
                2 * T * (d * qkv_d + model.n_heads * dh * d) / tp,
                wb + T * d * 4))
            if model.is_moe:
                de, E, k = model.moe_d_expert, model.moe_experts, \
                    model.moe_top_k
                trace.add("moe_ffn", phase, T, ctx, roof(
                    2 * 3 * T * k * d * de / tp,
                    3 * d * de * min(E, T * k) / tp * 2 + T * d * 4))
            else:
                mults = 3 if model.mlp_gated else 2
                trace.add("mlp", phase, T, ctx, roof(
                    2 * mults * T * d * model.d_ff / tp,
                    mults * d * model.d_ff / tp * 2 + T * d * 4))
            trace.add("norm", phase, T, ctx, roof(10 * T * d, 4 * T * d))
            trace.add("head", phase, T, ctx, roof(
                2 * T * d * model.vocab / tp,
                d * model.vocab / tp * 2 + T * d * 2))
            trace.add("embed", phase, T, ctx, roof(0, T * d * 4))
    for ctx in ctx_grid:
        for B in batch_grid:
            kv_b = ctx * B * model.kv_bytes_per_token / tp
            trace.add("attn_score", "decode", B, ctx, roof(
                4 * B * ctx * model.n_heads * dh / tp, kv_b))
        trace.add("attn_score", "prefill", ctx, ctx, roof(
            4 * ctx * (ctx / 2) * model.n_heads * dh / tp,
            ctx * model.kv_bytes_per_token / tp * 2))
    return trace


class _GridAdder:
    """Adapter routing ``add`` calls into one tp grid of an artifact."""

    def __init__(self, hwt: HardwareTrace, tp: int):
        self.hwt, self.tp = hwt, tp

    def add(self, op, phase, tokens, context, latency_s):
        self.hwt.add(op, phase, tokens, context, latency_s, tp=self.tp)


def synthetic_trace(spec: HardwareSpec, model: ModelSpec, *, tp=1,
                    device: Optional[str] = None,
                    token_grid: Sequence[int] = DEFAULT_TOKEN_GRID,
                    ctx_grid: Sequence[int] = DEFAULT_CTX_GRID) \
        -> HardwareTrace:
    """A full ``HardwareTrace`` artifact for a device that was never
    measured — the analytical model as a "synthetic trace" generator.

    ``tp`` may be a single tensor-parallel degree or a sequence of degrees
    (``tp=(1, 2)``); each degree gets its own grid in the one artifact,
    mirroring what a measured ``--tp 1,2`` profiler sweep emits.
    """
    tps = sorted({max(int(t), 1)
                  for t in (tp if isinstance(tp, (list, tuple)) else (tp,))})
    hwt = HardwareTrace(device=device or spec.name, model=model.name,
                        tp=tps[0], spec=spec,
                        interconnect=InterconnectSpec.from_hw(spec))
    for t in tps:
        add_synthetic_points(_GridAdder(hwt, t), spec, model, tp=t,
                             token_grid=token_grid, ctx_grid=ctx_grid)
    hwt.meta.update({"mode": "synthetic", "tp_degrees": tps,
                     "n_points": sum(len(hwt.grid(t)) for t in tps)})
    return hwt
