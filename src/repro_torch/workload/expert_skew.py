"""Parameterized expert-skew generators -> ``ExpertRoutingTrace``.

A copy of ``repro/workload/expert_skew.py``: a fixed seed gives the same
trace bytes as the original.

Synthesizes the deterministic routing tables the MoE scenario studies
replay (uniform / zipf-skewed / temporally-correlated hot sets — the same
taxonomy ``core.expert.ExpertRouter`` modeled statistically, now emitted as
a replayable artifact both backends consume).  Sampling is Gumbel top-k
over per-position log-weights: each position draws ``top_k`` *distinct*
experts from a Plackett-Luce distribution, so token counts are conserved
(``period * top_k`` per layer) and a fixed seed reproduces the trace
byte-for-byte.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.moe.trace import ExpertRoutingTrace


@dataclasses.dataclass(frozen=True)
class SkewConfig:
    kind: str = "zipf"        # uniform | zipf | correlated
    zipf_a: float = 1.1       # zipf exponent (higher -> more imbalance)
    period: int = 512         # table length (positions wrap mod period)
    drift: float = 0.08       # correlated: per-position log-weight walk
    seed: int = 0


def _layer_logweights(skew: SkewConfig, n_experts: int,
                      rng: np.random.Generator) -> np.ndarray:
    """(period, n_experts) unnormalized log-weights for one layer.

    The zipf ranking is permuted per layer (each layer has its own hot
    set, as observed in real MoE checkpoints); ``correlated`` adds a
    random walk over positions so the hot set drifts through the sequence
    (session-affinity effects).  The rng consumption order is independent
    of ``zipf_a`` so sweeps over the exponent share all other randomness.
    """
    if skew.kind == "uniform":
        base = np.zeros(n_experts)
    elif skew.kind in ("zipf", "correlated"):
        base = -skew.zipf_a * np.log(np.arange(1, n_experts + 1))
    else:
        raise ValueError(
            f"unknown skew kind {skew.kind!r} "
            f"(uniform | zipf | correlated)")
    base = base[rng.permutation(n_experts)]
    if skew.kind == "correlated":
        walk = np.cumsum(
            rng.normal(0.0, skew.drift, size=(skew.period, n_experts)),
            axis=0)
        return base[None, :] + walk
    return np.broadcast_to(base, (skew.period, n_experts)).copy()


def synthesize_routing(n_layers: int, n_experts: int, top_k: int,
                       skew: SkewConfig = SkewConfig(),
                       model: str = "*") -> ExpertRoutingTrace:
    """Build a deterministic ``ExpertRoutingTrace`` from a skew spec."""
    if n_layers < 1:
        raise ValueError(f"n_layers must be >= 1, got {n_layers}")
    if top_k > n_experts:
        raise ValueError(
            f"top_k={top_k} exceeds n_experts={n_experts}")
    if skew.period < 1:
        raise ValueError(f"period must be >= 1, got {skew.period}")
    rng = np.random.default_rng(skew.seed)
    layers = []
    for _ in range(n_layers):
        logw = _layer_logweights(skew, n_experts, rng)
        gumbel = rng.gumbel(size=(skew.period, n_experts))
        # Gumbel top-k == sampling top_k distinct experts ~ Plackett-Luce
        order = np.argsort(-(logw + gumbel), axis=1, kind="stable")
        layers.append(order[:, :top_k].astype(np.int32))
    meta = {"source": "synthetic", "kind": skew.kind, "seed": skew.seed,
            "period": skew.period}
    if skew.kind in ("zipf", "correlated"):
        meta["zipf_a"] = skew.zipf_a
    if skew.kind == "correlated":
        meta["drift"] = skew.drift
    return ExpertRoutingTrace(model=model, n_experts=n_experts,
                              top_k=top_k, layers=layers,
                              meta=meta).validate()


def routing_for_model(model, skew: SkewConfig = SkewConfig()
                      ) -> ExpertRoutingTrace:
    """Convenience: synthesize a trace shaped for a ``ModelSpec`` or
    ``ArchConfig`` (MoE layer count, expert count and top-k read off the
    config)."""
    from repro_torch.moe.trace import moe_layer_count
    moe = getattr(model, "moe", None)
    if moe is not None:
        n_experts, top_k = moe.n_experts, moe.top_k
    else:
        n_experts, top_k = model.moe_experts, model.moe_top_k
    if not n_experts:
        raise ValueError(
            f"{getattr(model, 'name', model)!r} is not a MoE model")
    return synthesize_routing(moe_layer_count(model), n_experts, top_k,
                              skew, model=model.name)
