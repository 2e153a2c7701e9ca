"""ShareGPT-like request workload (deterministic synthetic).

The paper samples 100 requests from ShareGPT [12] with Poisson arrivals at
10 req/s. This container is offline, so we synthesize requests whose
prompt/output length distributions match the published ShareGPT statistics
(lognormal-ish, mean prompt ~161 tokens / mean output ~338 tokens as reported
in the vLLM paper's ShareGPT analysis), plus a configurable shared-prefix
structure to exercise prefix caching (multi-turn conversations share their
conversation history — the property RadixAttention exploits).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.workload.arrival import poisson


@dataclasses.dataclass
class Request:
    req_id: int
    arrival: float               # seconds
    prompt_tokens: Sequence[int]  # token ids (for prefix-cache matching)
    output_len: int
    model: str = "default"
    slo_ttft_ms: float = 2000.0
    slo_tpot_ms: float = 200.0
    # multi-tenant class identity (see repro_torch.core.config.TenantClass and
    # repro_torch.workload.tenants): carried onto the SimRequest at submission
    # so the priority scheduler, the per-tenant metrics rollup and the
    # SLO-aware autoscaler all see the same class.
    tenant: str = "default"
    priority: int = 0
    weight: float = 1.0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)


@dataclasses.dataclass(frozen=True)
class ShareGPTConfig:
    n_requests: int = 100
    rate: float = 10.0            # Poisson rate (req/s)
    seed: int = 0
    vocab: int = 32_000
    mean_prompt: float = 161.0    # ShareGPT stats (vLLM paper)
    sigma_prompt: float = 0.9
    mean_output: float = 338.0
    sigma_output: float = 0.9
    max_prompt: int = 4096
    max_output: int = 2048
    min_len: int = 4
    # prefix sharing: fraction of requests that continue an earlier
    # conversation (reusing its prompt as a prefix)
    share_fraction: float = 0.3
    n_conversations: int = 20


def generate(cfg: ShareGPTConfig = ShareGPTConfig()) -> List[Request]:
    rng = np.random.default_rng(cfg.seed)
    arrivals = poisson(cfg.rate, cfg.n_requests, seed=cfg.seed + 1)

    def sample_len(mean, sigma, cap):
        mu = np.log(mean) - sigma ** 2 / 2
        return int(np.clip(rng.lognormal(mu, sigma), cfg.min_len, cap))

    conversations: List[List[int]] = [[] for _ in range(cfg.n_conversations)]
    requests = []
    for i in range(cfg.n_requests):
        out_len = sample_len(cfg.mean_output, cfg.sigma_output, cfg.max_output)
        conv_id = int(rng.integers(cfg.n_conversations))
        history = conversations[conv_id]
        if history and rng.random() < cfg.share_fraction:
            # multi-turn: prompt = shared history + new turn
            new_turn = rng.integers(0, cfg.vocab,
                                    sample_len(cfg.mean_prompt / 2,
                                               cfg.sigma_prompt,
                                               cfg.max_prompt // 2)).tolist()
            prompt = list(history) + new_turn
        else:
            prompt = rng.integers(0, cfg.vocab,
                                  sample_len(cfg.mean_prompt,
                                             cfg.sigma_prompt,
                                             cfg.max_prompt)).tolist()
        prompt = prompt[: cfg.max_prompt]
        conversations[conv_id] = prompt  # history grows with the turn
        requests.append(Request(
            req_id=i, arrival=float(arrivals[i]),
            prompt_tokens=prompt, output_len=out_len))
    return requests


def stats(requests: List[Request]) -> dict:
    p = np.array([r.prompt_len for r in requests], float)
    o = np.array([r.output_len for r in requests], float)
    return {"n": len(requests),
            "prompt_mean": p.mean(), "prompt_p50": np.median(p),
            "prompt_p99": np.percentile(p, 99),
            "output_mean": o.mean(), "output_p50": np.median(o),
            "output_p99": np.percentile(o, 99)}
