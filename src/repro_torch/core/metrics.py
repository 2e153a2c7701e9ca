"""Serving metric aggregation: TTFT / TPOT / ITL / throughput (paper Fig 2)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.expert import imbalance_factor
from repro_torch.core.request import FINISHED, SimRequest


def merge_expert_load(loads: List[Dict], timeline_len: int = 4096) -> Dict:
    """Cluster-level expert-load view: elementwise-sum the per-instance
    (layer, expert) count matrices, recompute the imbalance over the
    merged counts, and interleave the bounded hot-expert timelines by
    time.  Instances serving a different MoE shape (other model, other
    trace) cannot be summed; the rollup anchors on the *most common*
    shape across instances — not dict order — and reports how many
    instances merged."""
    all_shapes = [np.asarray(l["counts"]).shape for l in loads]
    shape = max(set(all_shapes), key=all_shapes.count)
    counts = np.zeros(shape, np.int64)
    tokens = 0
    merged = 0
    timeline = []
    dropped = 0
    routed = 0
    for load in loads:
        c = np.asarray(load["counts"])
        if c.shape != shape:
            continue
        counts += c
        tokens += int(load.get("tokens", 0))
        dropped += int(load.get("dropped", 0))
        routed += int(load.get("routed", 0))
        timeline.extend(load.get("hot_timeline", ()))
        merged += 1
    timeline = sorted(timeline, key=lambda e: e[0])[-timeline_len:]
    total = counts.sum(axis=0)
    # per-expert imbalance (max/mean over experts): the cluster view has
    # no single expert-parallel sharding to report against
    shards = shape[1]
    return {
        "counts": counts.tolist(),
        "tokens": tokens,
        "instances_merged": merged,
        "imbalance": imbalance_factor(total, shards),
        "per_layer_imbalance": [imbalance_factor(c, shards)
                                for c in counts],
        "hot_expert": int(total.argmax()) if total.sum() else None,
        "hot_timeline": timeline,
        "dropped": dropped,
        "routed": routed,
        "drop_rate": dropped / max(routed, 1),
    }


def merge_spec_decode(stats: List[Dict], timeline_len: int = 4096) -> Dict:
    """Cluster-level speculative-decoding view: sum per-instance step /
    proposal / acceptance counters, recompute the rates over the merged
    totals, and interleave the bounded per-step timelines by time.
    Instances speculating a different draft length cannot be summed; the
    rollup anchors on the most common ``k`` and reports how many
    instances merged (mirroring ``merge_expert_load``)."""
    ks = [int(s["k"]) for s in stats]
    k = max(set(ks), key=ks.count)
    hist = np.zeros(k + 1, np.int64)
    steps = proposed = accepted = 0
    merged = 0
    timeline = []
    for s in stats:
        if int(s["k"]) != k:
            continue
        steps += int(s["steps"])
        proposed += int(s["proposed_tokens"])
        accepted += int(s["accepted_tokens"])
        hist += np.asarray(s["accepted_hist"], np.int64)
        timeline.extend(s.get("step_timeline", ()))
        merged += 1
    timeline = sorted(timeline, key=lambda e: e[0])[-timeline_len:]
    return {
        "k": k,
        "instances_merged": merged,
        "steps": steps,
        "proposed_tokens": proposed,
        "accepted_tokens": accepted,
        "emitted_tokens": accepted + steps,
        "acceptance_rate": accepted / max(proposed, 1),
        "mean_accepted_len": accepted / max(steps, 1),
        "wasted_draft_tokens": proposed - accepted,
        "accepted_hist": hist.tolist(),
        "step_timeline": timeline,
    }


def merge_kv_tiers(stats: List[Dict]) -> Dict:
    """Cluster-level KV-tier view: per-cache residency (deduplicated by
    cache name — a ``scope="global"`` radix tree appears in every
    instance's stats but must be counted once) plus summed hit-token and
    transfer traffic over the distinct caches."""
    by_cache: Dict[str, Dict] = {}
    for s in stats:
        by_cache.setdefault(s.get("cache", "cache"), s)
    residency = {"device": 0, "host": 0, "ssd": 0}
    hit_tokens = {"device": 0, "host": 0, "ssd": 0}
    transfers: Dict[str, Dict[str, float]] = {}
    for s in by_cache.values():
        for tier, n in s.get("residency_blocks", {}).items():
            residency[tier] = residency.get(tier, 0) + int(n)
        for tier, n in s.get("hit_tokens", {}).items():
            hit_tokens[tier] = hit_tokens.get(tier, 0) + int(n)
        for path, t in s.get("transfers", {}).items():
            agg = transfers.setdefault(path, {"blocks": 0, "bytes": 0.0})
            agg["blocks"] += int(t.get("blocks", 0))
            agg["bytes"] += float(t.get("bytes", 0.0))
    return {"caches_merged": len(by_cache),
            "residency_blocks": residency,
            "hit_tokens": hit_tokens,
            "transfers": transfers}


def slo_met(r: SimRequest) -> bool:
    """A finished request meets its tenant SLO when TTFT and TPOT are
    within the class targets (TPOT is vacuous for single-token outputs)."""
    ttft = r.ttft()
    if ttft is None or ttft > r.slo_ttft_ms / 1e3:
        return False
    tpot = r.tpot()
    return tpot is None or tpot <= r.slo_tpot_ms / 1e3


def tenant_rollup(requests: List[SimRequest]) -> Dict[str, Dict]:
    """Per-tenant serving metrics (``metrics()["tenants"]``, both
    backends): TTFT/TPOT p50/p95/p99, SLO attainment (fraction of
    finished requests meeting both targets) and **goodput** — throughput
    counting only SLO-met requests, in output tokens/s and requests/s.

    Goodput is normalized by the *global* serving window (first arrival
    to last finish over all tenants, the same span ``aggregate`` uses for
    throughput), so per-tenant goodputs are comparable to each other and
    sum toward the cluster figure.
    """
    done_all = [r for r in requests if r.state == FINISHED]
    if not done_all:
        return {}
    span = max(max(r.t_finish for r in done_all)
               - min(r.arrival for r in done_all), 1e-9)
    out: Dict[str, Dict] = {}
    for name in sorted({r.tenant for r in requests}):
        reqs = [r for r in requests if r.tenant == name]
        done = [r for r in reqs if r.state == FINISHED]
        row: Dict = {"submitted": len(reqs), "finished": len(done)}
        if done:
            ttft = np.array([r.ttft() for r in done
                             if r.ttft() is not None])
            tpot = np.array([r.tpot() for r in done
                             if r.tpot() is not None])

            def pct(a, q):
                return float(np.percentile(a, q)) if a.size else None

            met = [r for r in done if slo_met(r)]
            row.update({
                "priority": done[0].priority,
                "slo_ttft_ms": done[0].slo_ttft_ms,
                "slo_tpot_ms": done[0].slo_tpot_ms,
                "ttft_p50_s": pct(ttft, 50), "ttft_p95_s": pct(ttft, 95),
                "ttft_p99_s": pct(ttft, 99),
                "tpot_p50_s": pct(tpot, 50), "tpot_p95_s": pct(tpot, 95),
                "tpot_p99_s": pct(tpot, 99),
                "slo_attainment": len(met) / len(done),
                "slo_met": len(met),
                "goodput_tok_s": sum(r.generated for r in met) / span,
                "goodput_req_s": len(met) / span,
            })
        out[name] = row
    return out


def aggregate(requests: List[SimRequest]) -> Dict:
    done = [r for r in requests if r.state == FINISHED]
    if not done:
        return {"finished": 0}
    ttft = np.array([r.ttft() for r in done if r.ttft() is not None])
    tpot = np.array([r.tpot() for r in done if r.tpot() is not None])
    # no request produced inter-token latencies (e.g. every output was a
    # single token): report None like the other empty-stat fields rather
    # than fabricating a perfect 0.0 latency
    itls = np.concatenate([np.array(r.itl()) for r in done
                           if len(r.itl())]) if any(
        len(r.itl()) for r in done) else np.array([])
    t_end = max(r.t_finish for r in done)
    t_start = min(r.arrival for r in done)
    out_tokens = sum(r.generated for r in done)
    return {
        "finished": len(done),
        "ttft_mean_s": float(ttft.mean()) if ttft.size else None,
        "ttft_p99_s": float(np.percentile(ttft, 99)) if ttft.size else None,
        "tpot_mean_s": float(tpot.mean()) if tpot.size else None,
        "itl_mean_s": float(itls.mean()) if itls.size else None,
        "itl_p99_s": float(np.percentile(itls, 99)) if itls.size else None,
        "throughput_tok_s": out_tokens / max(t_end - t_start, 1e-9),
        "makespan_s": t_end - t_start,
        "preemptions": sum(r.n_preemptions for r in done),
        "restarts": sum(r.n_restarts for r in done),
        # scheduler-ledger view: peak KV block reservation per request
        # (per-instance occupancy/watermark timelines live in
        # instances[<name>]["kv_occupancy"/"kv_watermark"])
        "kv_blocks_peak_mean": float(np.mean(
            [r.kv_blocks_peak for r in done])),
        "kv_blocks_peak_max": int(max(r.kv_blocks_peak for r in done)),
    }
