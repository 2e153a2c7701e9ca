"""How ``correct`` is decided: the served tokens against the plain
reference.

Once the window has closed and the program is freed, a sample of the
window's finished requests, drawn from the seed and always holding the
longest one, is run through the plain reference of the configuration's
family (its ``logits_at``; ``reference/``) over each prompt and its
served tokens (teacher-forced).  A served token's gap is how far its
reference logit lies below the reference's best at that position.  The
cell's limits file (``perfbench/limits/<cell>.json``) holds the sample
to one or more of ``max_logit_gap`` (the
widest gap), ``mean_logit_gap`` (the mean over the served tokens) and
``median_logit_gap`` (their median).  Greedy
serving of a sound program puts the best or a near-tie first, so its
gaps are rounding; the limits and the readings they were set from are
in ``PERF.md``.  A request of the window that never finished, or one
whose output is short, fails the run as well.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch


def sample(seed: int, prompts: Dict[int, list], served: Dict[int, list],
           tokens: int, most: int) -> List[int]:
    """Request ids: the longest, then others in an order drawn from the
    seed, until ``tokens`` served tokens or ``most`` requests."""
    ids = sorted(served)
    if not ids:
        return []
    longest = max(ids, key=lambda i: (len(prompts[i]) + len(served[i]), -i))
    rest = [i for i in ids if i != longest]
    rng = np.random.default_rng([int(seed), 0x5A3])
    chosen, n = [longest], len(served[longest])
    for j in rng.permutation(len(rest)):
        if n >= tokens or len(chosen) >= most:
            break
        chosen.append(rest[j])
        n += len(served[rest[j]])
    return chosen


def teacher_forced(prompts, served, ids):
    """Sequences (prompt + served tokens but the last) and the positions
    whose logits predict each served token."""
    seqs, want = [], []
    for i in ids:
        p, s = list(prompts[i]), list(served[i])
        seqs.append(p + s[:-1])
        want.append(list(range(len(p) - 1, len(p) - 1 + len(s))))
    return seqs, want


def gaps(ref: List[torch.Tensor], picks: List[torch.Tensor]) -> torch.Tensor:
    """Per token: the reference's best logit less its logit of the pick."""
    out = []
    for r, t in zip(ref, picks):
        t = t.to(r.device).long()
        out.append(r.max(dim=-1).values - r.gather(1, t[:, None])[:, 0])
    return torch.cat(out)


def compare(params, sizes: dict, spec: dict, seed: int,
            prompts: Dict[int, list], served: Dict[int, list],
            lengths: Dict[int, int], unfinished: int, *, family) -> dict:
    short = sum(1 for i in served if len(served[i]) != lengths[i])
    ok = {i: s for i, s in served.items() if len(s) == lengths[i] and s}
    ids = sample(seed, prompts, ok, int(spec["sample_tokens"]),
                 int(spec["sample_requests"]))
    g = None
    if ids:
        t0 = time.perf_counter()
        seqs, want = teacher_forced(prompts, ok, ids)
        with torch.no_grad():
            ref = family.logits_at(params, sizes, seqs, want)
        g = gaps(ref, [torch.as_tensor(ok[i]) for i in ids])
        q = g.float().quantile(g.new_tensor([0.5, 0.99]).float())
        print(f"reference: {len(ids)} requests, {g.numel()} served tokens, "
              f"{sum(len(s) for s in seqs)} positions, "
              f"{time.perf_counter() - t0:.2f} s; gaps: widest "
              f"{float(g.max())!r} mean {float(g.mean())!r} median "
              f"{float(q[0])!r} p99 {float(q[1])!r} off the top "
              f"{float((g > 0).float().mean())!r}", file=sys.stderr)
    read = {"max_logit_gap": lambda: float(g.max()),
            "mean_logit_gap": lambda: float(g.mean()),
            "median_logit_gap": lambda: float(g.float().median())}
    checks = {name: {"value": None if g is None else fn(),
                     "limit": float(spec[name])}
              for name, fn in read.items() if name in spec}
    if not checks:
        raise ValueError("the cell's limits file names no limit")
    correct = g is not None and all(c["value"] <= c["limit"]
                                    for c in checks.values())
    checks["unfinished"] = {"value": unfinished, "limit": 0}
    checks["short_outputs"] = {"value": short, "limit": 0}
    correct = correct and unfinished == 0 and short == 0
    return {"correct": bool(correct), "checks": checks}
