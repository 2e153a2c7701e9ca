"""ArchConfig -> ModelSpec bridge (jax-free).

The simulator describes models with ``ModelSpec``; the real engine and
profiler use ``ArchConfig``.  This converter is the only coupling, kept out
of the jax-importing profiler modules so the pure-sim path (and the
synthetic-trace CLI) never pays the engine import.
"""
from __future__ import annotations

from repro_torch.configs import ArchConfig
from repro_torch.core.config import ModelSpec


def model_spec_from_arch(cfg: ArchConfig) -> ModelSpec:
    moe = cfg.moe
    return ModelSpec(
        name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        d_ff=cfg.d_ff, vocab=cfg.vocab,
        moe_experts=moe.n_experts if moe else 0,
        moe_top_k=moe.top_k if moe else 0,
        moe_d_expert=moe.d_expert if moe else 0,
        moe_capacity_factor=moe.capacity_factor if moe else 1.25,
        mlp_gated=cfg.mlp_gated,
        param_bytes=cfg.param_count() * 2)
