"""Multi-tenant workload generation: tenant-class mixes layered over the
arrival processes (Poisson / gamma-burst / diurnal).

Each :class:`TenantSpec` pairs a :class:`repro_torch.core.config.TenantClass`
(identity, priority, SLO targets, weighted share) with that tenant's
traffic shape — its share of the aggregate request count and its own
prompt/output length distributions.  ``generate_tenants`` apportions the
global request budget across tenants by share (largest-remainder, so the
counts are deterministic and sum exactly), draws each tenant's arrivals
and lengths from tenant-derived seeds, and merges the streams into one
globally arrival-sorted workload with sequential request ids.

Determinism contract (pinned by the property suite): a fixed
``TenantWorkloadCfg`` yields a byte-identical workload — same ids, same
arrivals, same token ids — independent of the process or platform, so
fast/exact and sim/real comparisons can share one workload by value.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Sequence

import numpy as np

from repro_torch.core.config import TenantClass
from repro_torch.workload.arrival import diurnal, gamma, poisson
from repro_torch.workload.sharegpt import Request


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant class plus its traffic shape in the mix."""
    tenant: TenantClass
    rate_share: float = 1.0       # relative share of the aggregate load
    mean_prompt: float = 161.0    # lognormal-ish lengths (ShareGPT stats)
    sigma_prompt: float = 0.9
    mean_output: float = 338.0
    sigma_output: float = 0.9
    max_prompt: int = 4096
    max_output: int = 2048


@dataclasses.dataclass(frozen=True)
class TenantWorkloadCfg:
    tenants: Sequence[TenantSpec] = ()
    n_requests: int = 100         # aggregate across all tenants
    rate: float = 10.0            # aggregate arrival rate (req/s)
    seed: int = 0
    arrival: str = "poisson"      # poisson | gamma | diurnal
    cv: float = 2.0               # gamma / diurnal burstiness
    period_s: float = 60.0        # diurnal period
    amplitude: float = 0.8        # diurnal amplitude
    vocab: int = 32_000
    min_len: int = 4


def apportion(n: int, shares: Sequence[float]) -> List[int]:
    """Split ``n`` into integer counts proportional to ``shares`` using
    largest-remainder apportionment: deterministic, sums to exactly
    ``n``, and every positive share gets its floor first.  Ties on the
    remainder break toward the earlier tenant (stable ordering)."""
    if not shares:
        return []
    total = float(sum(shares))
    if total <= 0:
        raise ValueError(f"tenant shares must sum > 0, got {list(shares)}")
    quotas = [n * s / total for s in shares]
    counts = [int(q) for q in quotas]
    remainder = n - sum(counts)
    order = sorted(range(len(shares)),
                   key=lambda i: (-(quotas[i] - counts[i]), i))
    for i in order[:remainder]:
        counts[i] += 1
    return counts


def _arrivals(cfg: TenantWorkloadCfg, rate: float, n: int, seed: int):
    if cfg.arrival == "poisson":
        return poisson(rate, n, seed=seed)
    if cfg.arrival == "gamma":
        return gamma(rate, cfg.cv, n, seed=seed)
    if cfg.arrival == "diurnal":
        return diurnal(rate, n, period=cfg.period_s,
                       amplitude=cfg.amplitude, cv=cfg.cv, seed=seed)
    raise ValueError(f"unknown arrival process {cfg.arrival!r}; "
                     f"valid: poisson, gamma, diurnal")


def generate_tenants(cfg: TenantWorkloadCfg) -> List[Request]:
    """The tenant-class mix as one arrival-sorted request list.

    Per tenant: ``count_i`` requests (largest-remainder share of
    ``n_requests``) arriving at rate ``rate * share_i`` from the
    configured process, with lengths drawn from the tenant's own
    distributions.  Each tenant's RNG streams derive from
    ``cfg.seed`` and the tenant *index*, so adding a tenant to the end
    of the mix never perturbs the earlier tenants' draws.  The merge
    sorts by ``(arrival, tenant_index, intra_index)`` — a total order,
    so equal arrival times cannot make the output platform-dependent —
    and re-ids sequentially.
    """
    if not cfg.tenants:
        raise ValueError("TenantWorkloadCfg.tenants must name at least "
                         "one TenantSpec")
    names = [s.tenant.name for s in cfg.tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names in mix: {names}")
    counts = apportion(cfg.n_requests,
                       [s.rate_share for s in cfg.tenants])
    total_share = float(sum(s.rate_share for s in cfg.tenants))
    tagged = []   # (arrival, tenant_idx, intra_idx, Request)
    for idx, (spec, count) in enumerate(zip(cfg.tenants, counts)):
        if count == 0:
            continue
        base = cfg.seed + 9973 * (idx + 1)
        rate = cfg.rate * spec.rate_share / total_share
        arrivals = _arrivals(cfg, rate, count, seed=base)
        rng = np.random.default_rng(base + 1)

        def sample_len(mean, sigma, cap):
            mu = np.log(mean) - sigma ** 2 / 2
            return int(np.clip(rng.lognormal(mu, sigma), cfg.min_len, cap))

        t = spec.tenant
        for j in range(count):
            plen = sample_len(spec.mean_prompt, spec.sigma_prompt,
                              spec.max_prompt)
            prompt = rng.integers(0, cfg.vocab, plen).tolist()
            out_len = sample_len(spec.mean_output, spec.sigma_output,
                                 spec.max_output)
            tagged.append((float(arrivals[j]), idx, j, Request(
                req_id=0, arrival=float(arrivals[j]),
                prompt_tokens=prompt, output_len=out_len,
                tenant=t.name, priority=t.priority, weight=t.weight,
                slo_ttft_ms=t.slo_ttft_ms, slo_tpot_ms=t.slo_tpot_ms)))
    tagged.sort(key=lambda e: e[:3])
    out = []
    for i, (_, _, _, req) in enumerate(tagged):
        req.req_id = i
        out.append(req)
    return out


def workload_bytes(requests: List[Request]) -> bytes:
    """Canonical byte serialization of a workload (sorted-key JSON with
    repr-roundtrip floats): equal workloads <=> equal bytes.  The
    byte-identity property test pins ``generate_tenants`` determinism
    on this."""
    rows = [{
        "req_id": r.req_id, "arrival": repr(r.arrival),
        "prompt_tokens": list(r.prompt_tokens), "output_len": r.output_len,
        "model": r.model, "tenant": r.tenant, "priority": r.priority,
        "weight": repr(r.weight), "slo_ttft_ms": repr(r.slo_ttft_ms),
        "slo_tpot_ms": repr(r.slo_tpot_ms),
    } for r in requests]
    return json.dumps(rows, sort_keys=True,
                      separators=(",", ":")).encode()
