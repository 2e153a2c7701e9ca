"""Portable hardware-trace artifacts (the profiler <-> simulator contract).

A ``HardwareTrace`` is the versioned, JSON-serializable artifact the
profiler emits and the simulator's hardware registry consumes: one file per
device describing everything the perf model needs to price a cluster
instance on that hardware — the measured (or synthesized) operator-latency
tables, the interconnect parameters, and optionally the full device spec
for off-grid analytical fallback.  Integrating a new accelerator is
producing one of these files (``python -m repro_torch.profiler profile --device
<name> --tp 1,2 --out traces/<name>.json``) and referencing it from an
``InstanceCfg`` by ``hw_name`` (see ``docs/adding-hardware.md``).

JSON schema (version ``hwtrace/3``)::

    {
      "schema": "hwtrace/3",          # required; hwtrace/1 and /2 still load
      "device": "tpu-v6e",            # hardware name (registry key)
      "model": "llama3.1-8b-tiny",    # arch the op tables were captured for
      "interconnect": {               # network parameters of the device
        "link_bw": 1.0e11,            #   bytes/s per intra-instance link
        "host_bw": 1.6e10,            #   device<->host bytes/s
        "inter_instance_bw": 2.5e10,  #   bytes/s between instances
        "inter_instance_latency_s": 1.0e-5
      },
      "spec": {                       # optional full HardwareSpec: enables
        "name": "tpu-v6e",            #   analytical fallback for op/shape
        "peak_flops": 9.18e14,        #   combos outside the trace grid and
        "hbm_bw": 1.6e12, ...         #   the paged KV memory model
      },
      "grids": [                      # one latency grid per tensor-parallel
        {"tp": 1,                     #   degree the device was profiled at;
         "points": [                  #   each grid is an op -> latency table
           {"op": "iter",             #   over (tokens x context) buckets;
            "phase": "prefill",       #   op kinds: iter | extend |
            "tokens": 64,             #   kv_export | attn_qkv | attn_score
            "context": 64,            #   | mlp | moe_ffn | norm | head |
            "latency_s": 0.0123},     #   embed  (see repro_torch.core.trace)
           ...],
         "kernels": [                 #   optional kernel sub-buckets (new
           {"kernel": "attention",    #   in hwtrace/3): per-kernel latency
            "backend": "pallas",      #   rows keyed by the kernel backend
            "phase": "decode",        #   that produced them; kernel kinds:
            "tokens": 4,              #   attention | mlp | moe_gmm | head
            "context": 128,           #   (see repro_torch.profiler.kernel_profiler)
            "latency_s": 3.1e-4},
           ...]},
        {"tp": 2, "points": [...]}
      ],
      "meta": {"mode": "runtime", "profile_wall_s": 12.3, ...}
    }

The legacy ``hwtrace/1`` layout (top-level ``"tp"`` + ``"points"`` instead
of ``"grids"``) loads transparently as a single-grid artifact, and
``hwtrace/2`` (no ``"kernels"`` lists) loads as an artifact with op-level
grids only; ``save`` always emits ``hwtrace/3``, so loading an older file
and re-saving it migrates in place.

In memory, kernel rows are ordinary ``OpPoint``s whose op string is
``kern:<backend>:<kernel>`` (e.g. ``kern:pallas:attention``) — the
``Trace`` interpolation machinery is op-string-agnostic, so kernel grids
get indexing/memoization for free and ``PerfModel`` prices them as a
fidelity tier between whole-iteration and op-class points.

``points`` with op ``iter`` are whole-iteration measurements (highest
fidelity tier, preferred by ``PerfModel``); operator-class points compose an
iteration when no ``iter`` grid exists; anything else falls back to the
device spec's analytical roofline.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

from repro_torch.core.config import HardwareSpec
from repro_torch.core.trace import OpPoint, Trace

SCHEMA_VERSION = "hwtrace/3"
#: schema versions this build can read (save always emits SCHEMA_VERSION)
READABLE_SCHEMAS = ("hwtrace/1", "hwtrace/2", "hwtrace/3")

#: prefix marking an in-memory kernel-granular point (hwtrace/3 sub-buckets)
KERN_PREFIX = "kern:"
#: kernel kinds the kernel profiler sweeps (one engine forward pass is
#: L x attention + L x (mlp | moe_gmm) + head under either backend)
KERNEL_KINDS = ("attention", "mlp", "moe_gmm", "head")


def kern_op(backend: str, kernel: str) -> str:
    """Op string for a kernel sub-bucket row (``kern:<backend>:<kernel>``)."""
    return f"{KERN_PREFIX}{backend}:{kernel}"


def split_kern_op(op: str) -> Optional[tuple]:
    """``(backend, kernel)`` when ``op`` is a kernel row, else None."""
    if not op.startswith(KERN_PREFIX):
        return None
    backend, _, kernel = op[len(KERN_PREFIX):].partition(":")
    return (backend, kernel)


@dataclasses.dataclass(frozen=True)
class InterconnectSpec:
    """Network parameters carried with a trace.  These are what
    ``NetworkModel`` derives inter-instance ``Link``s from (min-bw rule
    across the two endpoints), so heterogeneous cluster configs inherit
    realistic, per-device-pair transfer pricing."""
    link_bw: float = 16e9                 # bytes/s per intra-instance link
    host_bw: float = 16e9                 # device <-> host bytes/s
    inter_instance_bw: float = 25e9       # bytes/s between instances
    inter_instance_latency_s: float = 10e-6

    @classmethod
    def from_hw(cls, spec: HardwareSpec) -> "InterconnectSpec":
        return cls(link_bw=spec.link_bw, host_bw=spec.host_bw,
                   inter_instance_bw=spec.inter_instance_bw,
                   inter_instance_latency_s=spec.inter_instance_latency_s)


@dataclasses.dataclass
class HardwareTrace:
    """One device's portable performance artifact (see module docstring).

    ``tp``/``points`` are the *base* grid (lowest profiled tensor-parallel
    degree — tp=1 for every artifact the profiler emits today);
    ``tp_grids`` holds additional grids captured at other tp degrees.
    Single-tp consumers (``to_trace``, ``add``, round-trip pricing) keep
    working unchanged on the base grid.
    """

    device: str
    model: str
    tp: int = 1
    points: List[OpPoint] = dataclasses.field(default_factory=list)
    interconnect: InterconnectSpec = \
        dataclasses.field(default_factory=InterconnectSpec)
    spec: Optional[HardwareSpec] = None
    meta: Dict = dataclasses.field(default_factory=dict)
    # extra tensor-parallel grids: tp degree -> points (never contains
    # ``self.tp``; use ``grid``/``tp_degrees`` for uniform access)
    tp_grids: Dict[int, List[OpPoint]] = dataclasses.field(
        default_factory=dict)

    # ---- construction ----
    def add(self, op: str, phase: str, tokens: int, context: int,
            latency_s: float, tp: Optional[int] = None):
        """Append one point to the base grid (or the ``tp`` grid)."""
        pt = OpPoint(op, phase, int(tokens), int(context), float(latency_s))
        if tp is None or tp == self.tp:
            self.points.append(pt)
        else:
            self.tp_grids.setdefault(int(tp), []).append(pt)

    def add_grid(self, tp: int, points: List[OpPoint]):
        """Attach a whole latency grid captured at tensor-parallel ``tp``."""
        tp = int(tp)
        if tp == self.tp:
            raise ValueError(
                f"{self.device}: grid for tp={tp} already exists (base)")
        if tp in self.tp_grids:
            raise ValueError(
                f"{self.device}: grid for tp={tp} already exists")
        self.tp_grids[tp] = list(points)

    def merge(self, other: "HardwareTrace") -> "HardwareTrace":
        """Absorb ``other``'s grids (same device+model) into this artifact —
        how the profiler CLI folds a ``--tp 1,2`` sweep into one file."""
        if (other.device, other.model) != (self.device, self.model):
            raise ValueError(
                f"cannot merge trace for ({other.device}, {other.model}) "
                f"into ({self.device}, {self.model})")
        for tp in other.tp_degrees():
            self.add_grid(tp, other.grid(tp))
        return self

    @classmethod
    def from_trace(cls, trace: Trace, *, device: Optional[str] = None,
                   spec: Optional[HardwareSpec] = None,
                   interconnect: Optional[InterconnectSpec] = None) \
            -> "HardwareTrace":
        """Wrap a raw perf-model ``Trace`` into a portable artifact."""
        if interconnect is None:
            interconnect = (InterconnectSpec.from_hw(spec) if spec
                            else InterconnectSpec())
        return cls(device=device or trace.hardware, model=trace.model,
                   tp=trace.tp, points=list(trace.points),
                   interconnect=interconnect, spec=spec,
                   meta=dict(trace.meta))

    # ---- grid access ----
    def tp_degrees(self) -> List[int]:
        """Every tensor-parallel degree this artifact has a grid for."""
        return sorted({self.tp, *self.tp_grids})

    def grid(self, tp: int) -> Optional[List[OpPoint]]:
        """The latency grid at tensor-parallel ``tp`` (None if absent)."""
        if tp == self.tp:
            return self.points
        return self.tp_grids.get(tp)

    def at_tp(self, tp: int) -> Optional["HardwareTrace"]:
        """A single-grid view of this artifact at tensor-parallel ``tp``
        (``self`` when ``tp`` is the base degree; None when no grid
        matches).  This is how ``HardwareRegistry.resolve`` hands the perf
        model the grid matching the instance's parallelism instead of
        rescaling analytically."""
        if tp == self.tp:
            return self
        pts = self.tp_grids.get(tp)
        if pts is None:
            return None
        # defensive copies (like every other construction path): mutating
        # a resolved view must never reach back into the cached artifact
        return HardwareTrace(device=self.device, model=self.model, tp=tp,
                             points=list(pts),
                             interconnect=self.interconnect,
                             spec=self.spec, meta=dict(self.meta))

    def to_trace(self, tp: Optional[int] = None) -> Trace:
        """The ``repro_torch.core.trace.Trace`` view the ``PerfModel`` consumes
        (base grid by default; pass ``tp`` for another profiled degree)."""
        tp = self.tp if tp is None else tp
        pts = self.grid(tp)
        if pts is None:
            raise KeyError(
                f"{self.device}: no grid at tp={tp} "
                f"(have {self.tp_degrees()})")
        return Trace(model=self.model, hardware=self.device, tp=tp,
                     points=list(pts), meta=dict(self.meta))

    def shared_trace(self, tp: Optional[int] = None) -> Trace:
        """Cached ``to_trace`` view: every caller at the same ``tp`` gets
        the SAME ``Trace`` object, so a fleet of identical instances
        shares one interpolation index and one exact-key memo instead of
        re-deriving them per instance.  Treat the result as read-only
        (``Trace.add`` on it would leak into every sharer)."""
        cache = self.__dict__.setdefault("_shared_traces", {})
        key = self.tp if tp is None else tp
        t = cache.get(key)
        if t is None:
            t = cache[key] = self.to_trace(tp)
        return t

    # ---- validation ----
    def validate(self):
        if not self.device:
            raise ValueError("HardwareTrace.device must be non-empty")
        if self.tp < 1:
            raise ValueError(f"HardwareTrace.tp must be >= 1, got {self.tp}")
        if self.tp in self.tp_grids:
            raise ValueError(
                f"tp_grids must not duplicate the base tp={self.tp}")
        for tp in self.tp_degrees():
            if tp < 1:
                raise ValueError(f"grid tp must be >= 1, got {tp}")
            for i, p in enumerate(self.grid(tp)):
                if p.tokens < 1 or p.context < 0:
                    raise ValueError(
                        f"tp={tp} point {i} ({p.op}/{p.phase}) has invalid "
                        f"shape tokens={p.tokens} context={p.context}")
                if not p.latency_s > 0:
                    raise ValueError(
                        f"tp={tp} point {i} ({p.op}/{p.phase}) has "
                        f"non-positive latency {p.latency_s}")
        return self

    # ---- kernel sub-buckets ----
    def kernel_backends(self, tp: Optional[int] = None) -> List[str]:
        """Kernel backends the grid at ``tp`` carries sub-bucket rows for."""
        pts = self.grid(self.tp if tp is None else tp) or []
        seen = []
        for p in pts:
            bk = split_kern_op(p.op)
            if bk is not None and bk[0] not in seen:
                seen.append(bk[0])
        return seen

    # ---- io ----
    @staticmethod
    def _grid_doc(points: List[OpPoint]) -> Dict:
        """Serialize one grid: op-class rows under ``points``, kernel rows
        (op ``kern:<backend>:<kernel>``) under ``kernels``."""
        doc: Dict = {"points": []}
        kerns = []
        for p in points:
            bk = split_kern_op(p.op)
            if bk is None:
                doc["points"].append(dataclasses.asdict(p))
            else:
                kerns.append({"kernel": bk[1], "backend": bk[0],
                              "phase": p.phase, "tokens": p.tokens,
                              "context": p.context, "latency_s": p.latency_s})
        if kerns:
            doc["kernels"] = kerns
        return doc

    def save(self, path: str) -> str:
        self.validate()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        doc = {
            "schema": SCHEMA_VERSION,
            "device": self.device,
            "model": self.model,
            "interconnect": dataclasses.asdict(self.interconnect),
            "spec": dataclasses.asdict(self.spec) if self.spec else None,
            "grids": [{"tp": tp, **self._grid_doc(self.grid(tp))}
                      for tp in self.tp_degrees()],
            "meta": self.meta,
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return path

    @classmethod
    def load(cls, path: str) -> "HardwareTrace":
        with open(path) as f:
            doc = json.load(f)
        schema = doc.get("schema")
        if schema not in READABLE_SCHEMAS:
            raise ValueError(
                f"{path}: unsupported hardware-trace schema {schema!r} "
                f"(this build reads {READABLE_SCHEMAS!r})")
        if "device" not in doc:
            raise ValueError(f"{path}: missing required key 'device'")

        def parse_points(raw):
            try:
                return [OpPoint(**p) for p in raw]
            except TypeError as e:
                raise ValueError(
                    f"{path}: malformed trace point: {e}") from e

        def parse_kernels(raw):
            # hwtrace/3 kernel sub-buckets -> kern:<backend>:<kernel> points
            # (hwtrace/2 grids simply have no "kernels" key: op-level only)
            try:
                return [OpPoint(kern_op(k["backend"], k["kernel"]),
                                k["phase"], k["tokens"], k["context"],
                                k["latency_s"]) for k in raw]
            except (KeyError, TypeError) as e:
                raise ValueError(
                    f"{path}: malformed kernel point: {e}") from e

        if schema == "hwtrace/1":
            # legacy single-grid layout: top-level tp + points
            if "points" not in doc:
                raise ValueError(f"{path}: missing required key 'points'")
            grids = {int(doc.get("tp", 1)): parse_points(doc["points"])}
        else:
            raw_grids = doc.get("grids")
            if not raw_grids:
                raise ValueError(f"{path}: missing required key 'grids'")
            grids = {}
            for g in raw_grids:
                tp = int(g.get("tp", 1))
                if tp in grids:
                    raise ValueError(f"{path}: duplicate grid for tp={tp}")
                grids[tp] = parse_points(g.get("points", [])) \
                    + parse_kernels(g.get("kernels", []))
        base = min(grids)
        spec = HardwareSpec(**doc["spec"]) if doc.get("spec") else None
        hwt = cls(device=doc["device"], model=doc.get("model", "*"),
                  tp=base, points=grids.pop(base), tp_grids=grids,
                  interconnect=InterconnectSpec(**doc.get("interconnect",
                                                          {})),
                  spec=spec, meta=doc.get("meta", {}))
        return hwt.validate()
