"""Operator-latency trace format (the contract between profiler and sim).

A trace is a set of measured operator latencies for one (model, hardware,
parallelism) triple, keyed by operator kind and phase, over a grid of
(tokens, context) points. The perf model interpolates this grid; anything
outside the grid falls back to the analytical model. This is LLMServingSim
2.0's central abstraction: integrating new hardware == producing one trace
file with the operator-level profiler (paper §II-A, Table III).

Lookup path: points are pre-indexed per ``(op, phase)`` into numpy arrays
(log-space coordinates precomputed once), and every interpolation result is
memoized on its exact ``(op, phase, tokens, context)`` key.  The scalar
``interpolate`` and the vectorized ``interpolate_many`` share one kernel, so
a fleet-scale fast path that prices whole decode windows at once returns
bit-identical values to per-step lookups.  The index is invalidated by
appending points (``add``/``load``); mutating an ``OpPoint`` in place after
a lookup is not supported.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

# operator kinds the profiler emits and the sim consumes
OP_KINDS = (
    "embed", "attn_qkv", "attn_score", "attn_out", "mlp", "moe_ffn",
    "moe_router", "norm", "head", "mamba", "xlstm", "sampler",
)

#: memo entries kept per trace before a wholesale reset (exact keys, so a
#: reset only costs recomputation, never accuracy)
_MEMO_CAP = 1 << 18


class _OpGrid:
    """One (op, phase)'s points with log-space coordinates precomputed."""

    __slots__ = ("pts", "lt", "lc", "ll", "lat")

    def __init__(self, pts: List["OpPoint"]):
        self.pts = pts
        tok = np.array([p.tokens for p in pts], dtype=np.float64)
        ctx = np.array([p.context for p in pts], dtype=np.float64)
        self.lt = np.log(np.maximum(tok, 1.0))
        self.lc = np.log(np.maximum(ctx, 1.0))
        self.lat = np.array([p.latency_s for p in pts], dtype=np.float64)
        self.ll = np.log(self.lat)

    def lookup(self, tokens, context) -> np.ndarray:
        """Vectorized nearest-4 inverse-distance-weighted interpolation in
        log space (simple + robust for monotone latency surfaces).  One row
        per query; the scalar path is a 1-row call of this same kernel."""
        qtok = np.maximum(np.asarray(tokens, dtype=np.float64), 1.0)
        qctx = np.maximum(np.asarray(context, dtype=np.float64), 1.0)
        if len(self.pts) == 1:
            # linear scaling in tokens as last resort
            p = self.pts[0]
            return self.lat[0] * qtok / max(p.tokens, 1)
        qt = np.log(qtok)
        qc = np.log(qctx)
        k = min(4, self.lt.shape[0])
        if qt.shape[0] == 1:
            # 1-row lane: identical elementwise double ops on 1-D arrays,
            # so the value matches row 0 of the broadcast path bit-for-bit
            # (the fast==exact contract crosses this boundary)
            d = (self.lt - qt[0]) ** 2 + 0.25 * (self.lc - qc[0]) ** 2
        else:
            d = (self.lt[None, :] - qt[:, None]) ** 2 \
                + 0.25 * (self.lc[None, :] - qc[:, None]) ** 2
        # stable sort: equidistant points keep insertion order
        sel = np.argsort(d, axis=-1, kind="stable")[..., :k]
        if d.ndim == 1:
            ds = d[sel]
        else:
            ds = d[np.arange(d.shape[0])[:, None], sel]
        lls = self.ll[sel]
        # an exact grid hit would divide by ~0; clamping keeps the kernel
        # finite and warning-free, and any row that close to a point takes
        # the exact-hit branch below, so the IDW value never survives
        ws = 1.0 / np.maximum(ds, 1e-300)
        num = ws[..., 0] * lls[..., 0]
        den = ws[..., 0] + 0.0
        for j in range(1, k):
            num = num + ws[..., j] * lls[..., j]
            den = den + ws[..., j]
        out = np.exp(num / den)
        # exact grid hit: return the nearest point's measured latency
        if d.ndim == 1:
            if ds[0] < 1e-12:
                out = self.lat[sel[0]]
            return np.asarray([out])
        near = ds[:, 0] < 1e-12
        if near.any():
            out = np.where(near, self.lat[sel[:, 0]], out)
        return out


@dataclasses.dataclass
class OpPoint:
    op: str
    phase: str          # prefill | decode
    tokens: int         # batch tokens processed this iteration
    context: int        # KV/context length (decode) or seq len (prefill)
    latency_s: float


@dataclasses.dataclass
class Trace:
    model: str
    hardware: str
    tp: int
    points: List[OpPoint] = dataclasses.field(default_factory=list)
    meta: Dict = dataclasses.field(default_factory=dict)

    def add(self, op, phase, tokens, context, latency_s):
        self.points.append(OpPoint(op, phase, int(tokens), int(context),
                                   float(latency_s)))

    # ---- lookup ----
    def _index(self) -> Dict[Tuple[str, str], _OpGrid]:
        """Per-(op, phase) grid index, rebuilt when points were appended."""
        idx = getattr(self, "_idx", None)
        if idx is not None and self._idx_n == len(self.points):
            return idx
        buckets: Dict[Tuple[str, str], List[OpPoint]] = {}
        for p in self.points:
            buckets.setdefault((p.op, p.phase), []).append(p)
        idx = {key: _OpGrid(pts) for key, pts in buckets.items()}
        self._idx = idx
        self._idx_n = len(self.points)
        self._memo: Dict[Tuple, Optional[float]] = {}
        return idx

    def _grid(self, op: str, phase: str) -> List[OpPoint]:
        g = self._index().get((op, phase))
        return g.pts if g is not None else []

    def interpolate(self, op: str, phase: str, tokens: int,
                    context: int) -> Optional[float]:
        """Log-space nearest-4 IDW over the (tokens, context) grid;
        nearest-edge clamp outside; None when no points exist.  Results are
        memoized per exact key (an instance fleet sharing one trace object
        shares the memo)."""
        g = self._index().get((op, phase))
        if g is None:
            return None
        memo = self._memo
        key = (op, phase, tokens, context)
        v = memo.get(key)
        if v is None:
            if len(memo) >= _MEMO_CAP:
                memo.clear()
            v = float(g.lookup((tokens,), (context,))[0])
            memo[key] = v
        return v

    def interpolate_many(self, op: str, phase: str, tokens,
                         context) -> Optional[np.ndarray]:
        """Vectorized ``interpolate`` over parallel token/context arrays —
        same kernel, so element i is bit-identical to the scalar lookup at
        ``(tokens[i], context[i])``.  None when the grid has no points."""
        g = self._index().get((op, phase))
        if g is None:
            return None
        return g.lookup(tokens, context)

    # ---- io ----
    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({
                "model": self.model, "hardware": self.hardware, "tp": self.tp,
                "meta": self.meta,
                "points": [dataclasses.asdict(p) for p in self.points],
            }, f)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            d = json.load(f)
        t = cls(model=d["model"], hardware=d["hardware"], tp=d.get("tp", 1),
                meta=d.get("meta", {}))
        for p in d["points"]:
            t.points.append(OpPoint(**p))
        return t


class TraceRegistry:
    """Named traces; instances reference them by ``trace_name``."""

    def __init__(self):
        self._traces: Dict[str, Trace] = {}

    def register(self, name: str, trace: Trace):
        self._traces[name] = trace

    def get(self, name: str) -> Optional[Trace]:
        return self._traces.get(name)

    def load_dir(self, path: str):
        for fn in os.listdir(path):
            if fn.endswith(".json"):
                self.register(fn[:-5], Trace.load(os.path.join(path, fn)))
