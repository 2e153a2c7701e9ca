"""Parameterized acceptance-rate generators -> ``AcceptanceTrace``.

Synthesizes the deterministic acceptance-length distributions the
speculative-decoding scenario studies replay (the spec-decode analogue of
``repro_torch.workload.expert_skew``).  The model is the standard truncated
geometric: with per-token target acceptance rate ``alpha``, a spec step
accepts exactly ``a < k`` drafts with probability ``alpha^a * (1 -
alpha)`` and all ``k`` with probability ``alpha^k``.  ``jitter`` perturbs
``alpha`` per position bucket (seeded; rng consumption is independent of
``alpha`` so sweeps over the rate share all other randomness), modeling
position-dependent acceptance (e.g. early tokens verifying easier than
late ones).  A fixed seed reproduces the artifact byte-for-byte.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.spec.trace import AcceptanceTrace


@dataclasses.dataclass(frozen=True)
class AcceptanceConfig:
    alpha: float = 0.7        # per-token target acceptance rate
    k: int = 4                # draft proposal length per step
    period: int = 256         # position-bucket count (wrap mod period)
    jitter: float = 0.0       # per-bucket gaussian alpha perturbation
    seed: int = 0


def synthesize_acceptance(cfg: AcceptanceConfig = AcceptanceConfig(),
                          model: str = "*",
                          draft: str = "*") -> AcceptanceTrace:
    """Build a deterministic ``AcceptanceTrace`` from an acceptance spec."""
    if not 0.0 <= cfg.alpha <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {cfg.alpha}")
    if cfg.k < 1:
        raise ValueError(f"k must be >= 1, got {cfg.k}")
    if cfg.period < 1:
        raise ValueError(f"period must be >= 1, got {cfg.period}")
    rng = np.random.default_rng(cfg.seed)
    # noise drawn unconditionally: the rng stream is identical across
    # alpha sweeps, so per-bucket rates move monotonically with alpha
    noise = rng.normal(0.0, 1.0, cfg.period)
    alpha_b = np.clip(cfg.alpha + cfg.jitter * noise, 0.0, 1.0)
    a = np.arange(cfg.k + 1)[None, :]
    hist = alpha_b[:, None] ** a
    hist[:, :-1] *= (1.0 - alpha_b)[:, None]
    # truncated geometric rows sum to 1 exactly (modulo float), including
    # the degenerate alpha in {0, 1} cases
    meta = {"source": "synthetic", "alpha": cfg.alpha,
            "jitter": cfg.jitter, "seed": cfg.seed, "period": cfg.period}
    return AcceptanceTrace(model=model, draft=draft, k=cfg.k, hist=hist,
                           meta=meta).validate()
