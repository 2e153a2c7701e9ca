"""Portable acceptance-trace artifacts (the spec-decode sim <-> real contract).

An ``AcceptanceTrace`` is the versioned, JSON-serializable artifact that
makes speculative-decoding acceptance dynamics *replayable*: per token
position (bucketed ``position % period``), a distribution over how many of
the draft model's ``k`` proposed tokens the target model accepts.  It is
either **recorded** from a real draft/target run (``python -m
repro_torch.profiler record-acceptance --arch <arch>``; see
``repro_torch.spec.record``) or **synthesized** from a target per-token
acceptance rate (``repro_torch.workload.acceptance``), and the same artifact
then drives both execution backends:

* ``SimBackend`` prices every spec step as draft-cost + verify-cost and
  advances each request by the trace's accepted length + 1 (the bonus /
  correction token), so TTFT/TPOT/goodput reflect acceptance dynamics;
* ``TorchBackend`` replays the trace on the real engine: the draft still
  proposes and the target still verifies in-graph, but the acceptance
  *decision* is forced to the trace's draw (the spec-decode analogue of
  ``repro_torch.moe``'s forced-assignment routing hook).

The determinism contract both backends share: a spec step for a request
that has already emitted ``g`` output tokens draws its accepted length at
``position = g - 1`` (the 0-based index of the last emitted token), via
:meth:`AcceptanceTrace.accepted_for` — an inverse-CDF lookup at a fixed
Weyl-sequence point, so one artifact yields one deterministic realization
with no RNG state to synchronize.  ``tests/test_spec_decode.py`` pins that
both backends produce identical per-step accepted-token counts for a
shared trace, the same way ``test_expert_routing.py`` does for expert
loads.

JSON schema (version ``spectrace/1``)::

    {
      "schema": "spectrace/1",      # required
      "model": "llama3.1-8b",       # target model
      "draft": "llama3.1-8b-draft", # draft model (informational)
      "k": 4,                       # draft proposal length per step
      "hist": [[w0, ..., wk],       # one row per position bucket:
               ...],                #   weights over accepted lengths 0..k
      "meta": {"source": "synthetic", "alpha": 0.7, ...}
    }

Rows are unnormalized nonnegative weights (recorded traces store counts,
synthesized ones probabilities); lookups normalize.
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections import deque
from typing import Dict, Optional

import numpy as np

SCHEMA_VERSION = "spectrace/1"
#: schema versions this build can read (save always emits SCHEMA_VERSION)
READABLE_SCHEMAS = ("spectrace/1",)

#: Weyl-sequence increment (golden ratio conjugate): successive spec
#: steps visit quantiles low-discrepancy-uniformly, so the realized
#: acceptance rate over a run converges to the trace's distributions.
#: The quantile is keyed on the request's spec-step ordinal, NOT its
#: token position: positions advance by the draw itself (accepted + 1),
#: so a position-keyed sequence would orbit-lock onto a biased subset of
#: quantiles, while the step ordinal increments by exactly 1 per step.
_WEYL = 0.6180339887498949


def _quantile_point(step: int) -> float:
    """Deterministic quantile in [0, 1) for one per-request spec-step
    ordinal — the single definition both backends draw through."""
    return float(((int(step) + 1) * _WEYL) % 1.0)


@dataclasses.dataclass
class AcceptanceTrace:
    """One replayable acceptance-length artifact (see module docstring).

    ``hist`` is a ``(period, k + 1)`` float array: row ``b`` weights the
    accepted lengths ``0..k`` for positions with ``position % period ==
    b``.
    """

    model: str
    draft: str
    k: int
    hist: np.ndarray
    meta: Dict = dataclasses.field(default_factory=dict)

    # ---- shape access ----
    @property
    def period(self) -> int:
        return int(np.asarray(self.hist).shape[0])

    def _probs(self) -> np.ndarray:
        h = np.asarray(self.hist, float)
        return h / h.sum(axis=1, keepdims=True)

    # ---- lookup ----
    def accepted_for(self, position: int, step: int = 0) -> int:
        """Accepted draft-token count (0..k) for one spec step — the
        deterministic inverse-CDF draw both backends share.  ``position``
        (the 0-based index of the request's last emitted output token)
        selects the distribution bucket; ``step`` (the request's 0-based
        spec-step ordinal, +1 per executed step) selects the quantile,
        keeping the realized acceptance equidistributed (see module
        docstring on why position alone would bias it)."""
        position = max(int(position), 0)
        row = np.asarray(self.hist[position % self.period], float)
        cdf = np.cumsum(row)
        u = _quantile_point(step) * cdf[-1]
        return int(min(np.searchsorted(cdf, u, side="right"), self.k))

    def mean_accepted(self) -> float:
        """Expected accepted length per step (averaged over buckets)."""
        p = self._probs()
        return float((p * np.arange(self.k + 1)[None, :]).sum(axis=1).mean())

    def acceptance_rate(self) -> float:
        """Expected per-proposal acceptance: mean accepted length / k."""
        return self.mean_accepted() / max(self.k, 1)

    # ---- compatibility ----
    def check_k(self, k: int) -> "AcceptanceTrace":
        """Raise unless this trace was built for draft length ``k`` —
        a mismatched table would silently mis-draw accepted lengths."""
        if int(k) != self.k:
            raise ValueError(
                f"acceptance trace {self.model!r} was recorded for draft "
                f"length k={self.k}, but the config speculates k={k}")
        return self

    # ---- validation ----
    def validate(self) -> "AcceptanceTrace":
        if self.k < 1:
            raise ValueError(f"AcceptanceTrace needs k >= 1, got {self.k}")
        h = np.asarray(self.hist, float)
        if h.ndim != 2 or h.shape[1] != self.k + 1 or h.shape[0] < 1:
            raise ValueError(
                f"hist shape {h.shape} != (period >= 1, k + 1 = "
                f"{self.k + 1})")
        if np.any(h < 0) or np.any(~np.isfinite(h)):
            raise ValueError("hist weights must be finite and >= 0")
        if np.any(h.sum(axis=1) <= 0):
            raise ValueError(
                "every hist row needs positive total weight (an "
                "all-zero bucket has no acceptance distribution)")
        return self

    # ---- io ----
    def to_doc(self) -> Dict:
        return {
            "schema": SCHEMA_VERSION,
            "model": self.model,
            "draft": self.draft,
            "k": int(self.k),
            "hist": np.asarray(self.hist, float).tolist(),
            "meta": self.meta,
        }

    def to_json(self) -> str:
        """Canonical serialization — byte-identical for identical traces
        (the determinism contract the synthesis generator is tested on)."""
        return json.dumps(self.to_doc(), sort_keys=True,
                          separators=(",", ":"))

    def save(self, path: str) -> str:
        self.validate()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_doc(), f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "AcceptanceTrace":
        with open(path) as f:
            doc = json.load(f)
        schema = doc.get("schema")
        if schema not in READABLE_SCHEMAS:
            raise ValueError(
                f"{path}: unsupported acceptance schema {schema!r} "
                f"(this build reads {READABLE_SCHEMAS!r})")
        for key in ("k", "hist"):
            if key not in doc:
                raise ValueError(f"{path}: missing required key {key!r}")
        trace = cls(model=doc.get("model", "*"),
                    draft=doc.get("draft", "*"),
                    k=int(doc["k"]),
                    hist=np.asarray(doc["hist"], float),
                    meta=doc.get("meta", {}))
        return trace.validate()


class SpecDecodeTracker:
    """Uniform spec-decode accounting for both execution backends.

    Each backend calls ``observe(position, accepted, now)`` once per
    executed spec step per request; since both backends draw accepted
    lengths from the same trace at the same positions (sim from the
    scheduler's request bookkeeping, real from the engine's independently
    tracked per-slot emit counts), the parity suite pins that the
    resulting metrics — acceptance rate, mean accepted length, wasted
    draft tokens, per-step timeline — are identical.
    """

    def __init__(self, k: int, timeline_len: int = 4096):
        self.k = int(k)
        self.steps = 0
        self.proposed = 0
        self.accepted = 0
        self.hist = np.zeros(self.k + 1, np.int64)
        # (t, position, accepted) per spec step, bounded
        self.timeline = deque(maxlen=timeline_len)

    def observe(self, position: int, accepted: int, now: float,
                proposed: Optional[int] = None):
        """``proposed`` is the drafts actually produced for this request
        this step — ``k`` normally, fewer when the tail clamp shrank the
        window near the output budget (both backends clamp identically, so
        acceptance-rate accounting stays comparable)."""
        a = int(min(max(accepted, 0), self.k))
        self.steps += 1
        self.proposed += self.k if proposed is None else int(proposed)
        self.accepted += a
        self.hist[a] += 1
        self.timeline.append((float(now), int(position), a))

    def metrics(self) -> Dict:
        steps = max(self.steps, 1)
        return {
            "k": self.k,
            "steps": int(self.steps),
            "proposed_tokens": int(self.proposed),
            "accepted_tokens": int(self.accepted),
            # every step also emits the bonus/correction token
            "emitted_tokens": int(self.accepted + self.steps),
            "acceptance_rate": self.accepted / max(self.proposed, 1),
            "mean_accepted_len": self.accepted / steps,
            "wasted_draft_tokens": int(self.proposed - self.accepted),
            "accepted_hist": self.hist.tolist(),
            "step_timeline": list(self.timeline),
        }
