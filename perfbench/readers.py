"""What the metric files under ``metrics/`` share: the window's requests
and iterations, and the profile's rooflines and model FLOPs (the
configuration's family counts them: ``run.family.model_flops``).

Each returns None where the run holds nothing to read (no traced
profile, no iteration of the kind, no call of the kernel), so the harness
leaves the metric out of the line; none returns 0 for a share of a peak.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from perfbench import counts


def pct(values, q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(values, dtype=float), q)) \
        if len(values) else None


def ttft_ms(run) -> List[float]:
    return [1e3 * (s.t_first_token - s.arrival) for s in run.requests
            if s.t_first_token is not None]


def tpot_ms(run) -> List[float]:
    return [1e3 * (s.t_finish - s.t_first_token) / (s.output_len - 1)
            for s in run.requests
            if s.t_finish is not None and s.output_len > 1]


def iters(run) -> list:
    """The runtime's ``iter`` events stamped inside the wall window."""
    if run.events is None:
        return []
    lo, hi = run.wall_open - run.rec_t0, run.wall_close - run.rec_t0
    return [e for e in run.events
            if e.kind == "iter" and e.wall is not None and lo <= e.wall < hi]


def phases(event) -> set:
    return {item[1] for item in event.payload["items"]}


def roofline(run, families) -> Optional[float]:
    """Percent: the bound time of every call of the kernel ``families``
    in the profiled stretch over the device time of their kernels.  None
    without a profile, without a call, or where the kernels launched do
    not pair one to one with the calls."""
    p = run.profile
    if p is None:
        return None
    bound, device, n_calls, n_kernels = 0.0, 0.0, 0, 0
    for fam in families:
        calls = p.calls[fam]
        secs, n = p.family_seconds(fam)
        device += secs
        n_kernels += n
        n_calls += len(calls)
        for c in calls:
            bound += counts.bound_s(*call_work(fam, c))
    if n_calls == 0 or n_kernels != n_calls or device <= 0:
        return None
    return 100.0 * bound / device


def call_work(fam: str, c: dict):
    """(FLOPs, bytes) of one recorded kernel call, its window honoured."""
    window = c.get("window")
    if fam == "flash":
        B, S, H, dh = c["q"]
        lengths = c["lengths"] if c["lengths"] is not None else [S] * B
        return counts.flash_prefill(lengths, H, c["KV"], dh, c["itemsize"],
                                    window)
    if fam == "extend":
        B, S, H, dh = c["q"]
        starts = c["start"]
        news = [n - s for n, s in zip(c["lengths"], starts)]
        return counts.paged_extend(starts, news, H, c["KV"], dh,
                                   c["page_size"], c["itemsize"], window)
    if fam == "gmm":
        E, C, d = c["x"]
        return counts.moe_gmm(E, C, d, c["w"][2], c["group_sizes"],
                              c["itemsize"])
    raise ValueError(fam)


def mfu(run) -> Optional[float]:
    """Percent: model FLOPs of the tokens the profiled stretch processed
    over its wall time at the card's bf16 peak."""
    p = run.profile
    if p is None or not p.works or p.window_s <= 0:
        return None
    chunks = []
    for work in p.works:
        for phase, n, start in work:
            # a prefill chunk's logits are the last token's; a decode's
            # its one token's
            chunks.append((start, n, 1))
    flops = run.family.model_flops(run.sizes, chunks)
    return 100.0 * flops / (p.window_s * counts.PEAK_BF16_FLOPS)
