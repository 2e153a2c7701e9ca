"""Portable expert-routing trace artifacts (the MoE sim <-> real contract).

A copy of ``repro/moe/trace.py``; the artifact bytes are the same.

An ``ExpertRoutingTrace`` is the versioned, JSON-serializable artifact that
makes MoE expert-load skew *replayable*: one deterministic table of top-k
expert assignments per MoE layer, indexed by token position.  It is either
**recorded** from a real engine run (``repro_torch.moe.record``) or
**synthesized** from a parameterized skew generator
(``repro_torch.workload.expert_skew``), and the same artifact then drives both
execution backends:

* ``SimBackend`` prices expert compute/offload traffic from the trace's
  per-layer counts (``PerfModel(routing=...)`` -> ``ExpertExecutionModel``)
  and accounts expert-load metrics through :class:`ExpertLoadTracker`;
* ``TorchBackend`` replays the trace on the real model through an injectable
  routing hook (``repro_torch.moe.hooks.make_replay_hook`` — forced assignment —
  or ``make_bias_hook`` — logit biasing), and accounts the same metrics.

The position convention is shared by everything that consumes a trace: a
token's *position* is its 0-based index in the sequence KV (prompt tokens
sit at their prompt offsets; the n-th generated token sits at
``prompt_len + n - 1``), and position ``p`` of MoE layer ``l`` routes to
``layers[l][p % period]``.  ``tests/test_expert_routing.py`` pins that both
backends produce identical per-layer expert token counts for a replayed
trace.

JSON schema (version ``moetrace/2``)::

    {
      "schema": "moetrace/2",       # required; moetrace/1 still loads
      "model": "granite-moe-1b-a400m-tiny",
      "n_experts": 4,
      "top_k": 2,
      "layers": [                   # one assignment table per MoE layer
        {"layer": 0,
         "assignments": [[0, 2],    #   position p -> top-k expert ids
                         [1, 0],    #   (period rows of top_k ids each;
                         ...]},     #   lookup is assignments[p % period])
        {"layer": 1, "assignments": [...]}
      ],
      "meta": {"source": "synthetic", "kind": "zipf", "seed": 0, ...}
    }

The legacy ``moetrace/1`` layout (one top-level ``assignments`` table shared
by every layer, plus ``n_layers``) loads transparently — the table is
replicated per layer — and ``save`` always re-emits ``moetrace/2``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

SCHEMA_VERSION = "moetrace/2"
#: schema versions this build can read (save always emits SCHEMA_VERSION)
READABLE_SCHEMAS = ("moetrace/1", "moetrace/2")


def _imbalance(counts, shards: int) -> float:
    """``repro_torch.core.expert.imbalance_factor`` — imported lazily: this
    module sits above ``repro_torch.core`` in the layering (the sim backend
    imports it back), so a cold import here must not re-enter core's
    package init mid-flight."""
    from repro_torch.core.expert import imbalance_factor
    return imbalance_factor(counts, shards)


def _metric_shards(ep: int, n_experts: int) -> int:
    """Sharding the *metric* imbalance is computed over: the instance's
    expert-parallel degree when it actually shards (ep > 1), else every
    expert is its own shard — the conventional max/mean-over-experts MoE
    imbalance (an unsharded instance would otherwise always report 1.0)."""
    return ep if ep > 1 else n_experts


def moe_layer_count(cfg) -> int:
    """Number of MoE layers a config describes.

    ``ArchConfig`` (real engine) counts its ``attn_moe`` stage layers;
    ``ModelSpec`` (simulator) has no stage structure — every layer of a
    MoE model is an MoE layer there, so its ``n_layers`` is returned.
    """
    stages = getattr(cfg, "stages", None)
    if stages:
        n = sum(st.n_layers for st in stages
                if getattr(st, "kind", "") == "attn_moe")
        if n:
            return n
    return int(getattr(cfg, "n_layers", 0))


@dataclasses.dataclass
class ExpertRoutingTrace:
    """One replayable expert-routing artifact (see module docstring).

    ``layers[l]`` is an ``(period, top_k)`` int array of expert ids; all
    layers share one ``period`` (the position bucket length — lookups wrap
    with ``position % period``, like the latency grids bucket shapes).
    """

    model: str
    n_experts: int
    top_k: int
    layers: List[np.ndarray] = dataclasses.field(default_factory=list)
    meta: Dict = dataclasses.field(default_factory=dict)

    # ---- shape access ----
    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def period(self) -> int:
        return int(self.layers[0].shape[0]) if self.layers else 0

    # ---- lookup ----
    def assignments_for(self, layer: int, positions) -> np.ndarray:
        """Top-k expert ids for each token position: ``(len(positions),
        top_k)`` — the replay contract both backends share."""
        pos = np.asarray(positions, np.int64) % self.period
        return self.layers[layer][pos]

    def counts_for(self, layer: int, positions) -> np.ndarray:
        """Per-expert token counts for one layer over ``positions``
        (sums to ``len(positions) * top_k``)."""
        a = self.assignments_for(layer, positions)
        return np.bincount(a.reshape(-1), minlength=self.n_experts)

    def static_imbalance(self, ep: int = 1) -> float:
        """Imbalance factor of the table itself (all layers, one full
        period) — the workload-independent skew the generators are
        parameterized by.  ``ep=1`` reports the per-expert imbalance
        (max/mean over experts); ``ep>1`` the per-rank sharded view."""
        total = np.zeros(self.n_experts, np.int64)
        pos = np.arange(self.period)
        for l in range(self.n_layers):
            total += self.counts_for(l, pos)
        return _imbalance(total, _metric_shards(ep, self.n_experts))

    # ---- compatibility ----
    def check_model(self, spec) -> "ExpertRoutingTrace":
        """Raise unless this trace can route ``spec`` (a ``ModelSpec`` or
        an ``ArchConfig.moe``-carrying config): expert count and top-k are
        structural — a mismatched table would silently clamp ids."""
        n_experts = getattr(spec, "moe_experts", None)
        top_k = getattr(spec, "moe_top_k", None)
        if n_experts is None and getattr(spec, "moe", None) is not None:
            n_experts = spec.moe.n_experts
            top_k = spec.moe.top_k
        if not n_experts:
            raise ValueError(
                f"routing trace {self.model!r} applied to a non-MoE model "
                f"{getattr(spec, 'name', spec)!r}")
        if (self.n_experts, self.top_k) != (n_experts, top_k):
            raise ValueError(
                f"routing trace {self.model!r} has {self.n_experts} "
                f"experts top-{self.top_k}, but model "
                f"{getattr(spec, 'name', spec)!r} routes "
                f"{n_experts} experts top-{top_k}")
        return self

    # ---- validation ----
    def validate(self) -> "ExpertRoutingTrace":
        if self.n_experts < 1 or self.top_k < 1:
            raise ValueError(
                f"ExpertRoutingTrace needs n_experts >= 1 and top_k >= 1, "
                f"got {self.n_experts}/{self.top_k}")
        if self.top_k > self.n_experts:
            raise ValueError(
                f"top_k={self.top_k} exceeds n_experts={self.n_experts}")
        if not self.layers:
            raise ValueError("ExpertRoutingTrace has no layer tables")
        period = self.period
        for l, table in enumerate(self.layers):
            table = np.asarray(table)
            if table.ndim != 2 or table.shape != (period, self.top_k):
                raise ValueError(
                    f"layer {l}: assignment table shape {table.shape} != "
                    f"({period}, {self.top_k})")
            if table.size and (table.min() < 0
                               or table.max() >= self.n_experts):
                raise ValueError(
                    f"layer {l}: expert id out of range [0, "
                    f"{self.n_experts}) in assignment table")
        return self

    # ---- io ----
    def to_doc(self) -> Dict:
        return {
            "schema": SCHEMA_VERSION,
            "model": self.model,
            "n_experts": int(self.n_experts),
            "top_k": int(self.top_k),
            "layers": [{"layer": l,
                        "assignments": np.asarray(t, int).tolist()}
                       for l, t in enumerate(self.layers)],
            "meta": self.meta,
        }

    def to_json(self) -> str:
        """Canonical serialization — byte-identical for identical traces
        (the determinism contract the skew generators are tested on)."""
        return json.dumps(self.to_doc(), sort_keys=True,
                          separators=(",", ":"))

    def save(self, path: str) -> str:
        self.validate()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_doc(), f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "ExpertRoutingTrace":
        with open(path) as f:
            doc = json.load(f)
        schema = doc.get("schema")
        if schema not in READABLE_SCHEMAS:
            raise ValueError(
                f"{path}: unsupported expert-routing schema {schema!r} "
                f"(this build reads {READABLE_SCHEMAS!r})")
        for key in ("n_experts", "top_k"):
            if key not in doc:
                raise ValueError(f"{path}: missing required key {key!r}")
        if schema == "moetrace/1":
            # legacy: one table shared by every MoE layer
            if "assignments" not in doc:
                raise ValueError(
                    f"{path}: missing required key 'assignments'")
            table = np.asarray(doc["assignments"], np.int32)
            n_layers = int(doc.get("n_layers", 1))
            layers = [table.copy() for _ in range(max(n_layers, 1))]
        else:
            raw = doc.get("layers")
            if not raw:
                raise ValueError(f"{path}: missing required key 'layers'")
            raw = sorted(raw, key=lambda g: int(g.get("layer", 0)))
            layers = [np.asarray(g["assignments"], np.int32) for g in raw]
        trace = cls(model=doc.get("model", "*"),
                    n_experts=int(doc["n_experts"]),
                    top_k=int(doc["top_k"]),
                    layers=layers, meta=doc.get("meta", {}))
        return trace.validate()


class ExpertLoadTracker:
    """Uniform expert-load accounting for both execution backends.

    Each backend calls ``observe(positions, now)`` once per executed
    iteration with the KV positions of the workload tokens it processed;
    the tracker maps them through the routing trace (the same table the
    real engine's replay hook forces in-graph) into per-layer per-expert
    token counts, an imbalance factor over the instance's expert-parallel
    sharding, and a bounded hot-expert occupancy timeline.  The parity
    suite pins that sim and real produce identical counts.
    """

    def __init__(self, trace: ExpertRoutingTrace, ep: int = 1,
                 timeline_len: int = 4096,
                 capacity_factor: Optional[float] = None):
        self.trace = trace
        self.ep = max(int(ep), 1)
        self.capacity_factor = capacity_factor
        self.counts = np.zeros((trace.n_layers, trace.n_experts), np.int64)
        self.tokens = 0
        # capacity-overflow accounting: routed (token, expert) entries
        # exceeding the per-iteration expert capacity C = round(T *
        # top_k * cf / E) at the iteration's *workload* token count —
        # the one definition in ``repro_torch.core.expert.expert_capacity``,
        # computed identically on both backends, so the metric is
        # backend-parity by construction.  It models what capacity-
        # exact top-k dispatch drops for this workload; the real
        # engine's jitted buffers compute C over the padded batch width
        # instead, so its physical drop count can be lower when slots
        # are padded (same formula, different T).
        self.dropped = 0
        self.routed = 0
        # (t, hot expert id, hot expert's share of this iteration's load)
        self.hot_timeline = deque(maxlen=timeline_len)

    def observe(self, positions: Sequence[int], now: float):
        pos = np.asarray(positions, np.int64).reshape(-1)
        if pos.size == 0:
            return
        self.observe_counts(
            [self.trace.counts_for(l, pos)
             for l in range(self.trace.n_layers)], int(pos.size), now)

    def observe_counts(self, per_layer_counts, tokens: int, now: float):
        """Record one iteration from already-derived per-layer counts —
        lets the sim backend share the counts its perf model priced with
        instead of recomputing the same bincounts per iteration."""
        if not tokens:
            return
        cap = None
        if self.capacity_factor:
            from repro_torch.core.expert import expert_capacity
            cap = expert_capacity(int(tokens), self.trace.top_k,
                                  self.trace.n_experts,
                                  self.capacity_factor)
        iter_counts = np.zeros(self.trace.n_experts, np.int64)
        for l, c in enumerate(per_layer_counts):
            self.counts[l] += c
            iter_counts += c
            if cap is not None:
                self.dropped += int(np.maximum(
                    np.asarray(c, np.int64) - cap, 0).sum())
                self.routed += int(np.asarray(c, np.int64).sum())
        self.tokens += int(tokens)
        hot = int(iter_counts.argmax())
        self.hot_timeline.append(
            (float(now), hot,
             float(iter_counts[hot] / max(iter_counts.sum(), 1))))

    def metrics(self) -> Dict:
        total = self.counts.sum(axis=0)
        shards = _metric_shards(self.ep, self.trace.n_experts)
        return {
            "counts": self.counts.tolist(),
            "tokens": int(self.tokens),
            "imbalance": _imbalance(total, shards),
            "per_layer_imbalance": [_imbalance(c, shards)
                                    for c in self.counts],
            "hot_expert": int(total.argmax()) if total.sum() else None,
            "hot_timeline": list(self.hot_timeline),
            # capacity-overflow drops (0.0 when no capacity_factor set;
            # "routed" is the denominator — (token, expert) entries that
            # went through capacity-checked dispatch)
            "dropped": int(self.dropped),
            "routed": int(self.routed),
            "drop_rate": self.dropped / max(self.routed, 1),
        }
