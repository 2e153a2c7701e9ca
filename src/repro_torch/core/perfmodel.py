"""Trace-consuming performance model.

``iteration_latency`` prices one engine iteration (a batch of prefill
chunks + decode steps) from a hardware trace, in fidelity order:

1. **iter-level points** (``iter``/``extend``/``kv_export``) — whole
   measured iterations captured by ``repro_torch.profiler.runtime_profiler``
   through the unified runtime's ``TorchBackend``; highest fidelity.
2. **kernel-level points** (hwtrace/3 ``kern:<backend>:<kernel>`` rows,
   swept by ``repro_torch.profiler.kernel_profiler``) — per-kernel latencies
   (attention / mlp / moe_gmm / head) composed as ``L * attention +
   L * ffn + head``; lets fidelity studies attribute error to one kernel
   and compares kernel backends (reference vs cuda) on the same grid.
3. **operator-level points** — per-op-class latencies interpolated over
   the (tokens, context) grid (paper §II-A) and composed per layer.
4. **analytical roofline** — per-query fallback from the hardware spec for
   op/shape combos no trace covers.

Traces arrive as portable ``repro_torch.hw.HardwareTrace`` artifacts resolved by
``InstanceCfg.hw_name`` (or raw ``Trace`` objects via ``trace_name``); for
never-measured devices the registry synthesizes one from the same
analytical model (``repro_torch.hw.synthetic``), so this class is always a trace
*consumer* — the roofline here only patches grid gaps.

A copy of ``repro/core/perfmodel.py``.  One label differs: the port's
hand-written kernels write ``kern:cuda:<kernel>`` rows, so the kernel tier
prefers ``cuda`` rows, then ``reference`` ones.  The artifact schema is
the same, so a trace whose only kernel rows are ``kern:pallas:*`` prices
here at that tier when ``InstanceCfg.kernel_backend="pallas"`` pins them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.config import InstanceCfg
from repro_torch.core.expert import ExpertExecutionModel, ExpertRouter
from repro_torch.core.network import allreduce_time
from repro_torch.core.trace import Trace
from repro_torch.hw.trace import kern_op


@dataclasses.dataclass
class BatchItem:
    tokens: int          # tokens processed for this request this iteration
    context: int         # total context length (for attention cost)
    phase: str           # prefill | decode
    start: int = 0       # KV already in cache before this work (cache hits
                         # and chunked-prefill continuations run ``extend``)
    completes: bool = True   # this work finishes the request's prefill


@dataclasses.dataclass
class IterationCost:
    total_s: float
    breakdown: dict


def _item_positions(it: BatchItem) -> np.ndarray:
    """KV positions of the tokens a batch item processes — the lookup key
    into an ``ExpertRoutingTrace``.  Follows the ``to_batch_items``
    convention: prefill work covers ``[start, start + tokens)``; a decode
    item's ``tokens`` consecutive slots end at ``context - 2`` (its
    ``context`` is ``context_len + tokens`` and the first new token's
    0-based KV index is ``context_len - 1``) — one token classically,
    the k + 1 verification window under speculative decoding."""
    if it.phase == "prefill":
        return np.arange(it.start, it.start + it.tokens)
    n = max(it.tokens, 1)
    first = max(it.context - n - 1, 0)
    return first + np.arange(n)


def batch_positions(items: List[BatchItem]) -> np.ndarray:
    """All KV positions of one batch — the single implementation shared by
    MoE trace pricing (``_moe_layer_cost``) and the backends' expert-load
    accounting, so the position convention cannot drift between them."""
    return np.concatenate([_item_positions(i) for i in items]) \
        if items else np.zeros(0, np.int64)


class PerfModel:
    def __init__(self, cfg: InstanceCfg, trace: Optional[Trace] = None,
                 expert_model: Optional[ExpertExecutionModel] = None,
                 routing=None):
        """``routing`` (an ``repro_torch.moe.ExpertRoutingTrace``) switches MoE
        pricing from the statistical router to replayed per-layer counts;
        see ``_moe_layer_cost``."""
        self.cfg = cfg
        self.trace = trace
        self.m = cfg.model
        self.hw = cfg.hw
        self.tp = max(cfg.parallelism.tp, 1)
        self.pp = max(cfg.parallelism.pp, 1)
        self.routing = routing
        self.expert_model = expert_model
        if self.m.is_moe and expert_model is None:
            # PIM offload prices against the instance's memory-side
            # accelerator spec; the preset keeps offload="pim" from
            # silently degenerating into a free no-op when unset
            pim = cfg.pim
            if pim is None and cfg.moe.offload == "pim":
                from repro_torch.core.config import PIM_DEVICE
                pim = PIM_DEVICE
            self.expert_model = ExpertExecutionModel(
                cfg, ExpertRouter(cfg.moe, self.m), pim=pim)

    # ---- analytical op costs (per layer-stack, per device) ----
    def _roof(self, flops: float, nbytes: float) -> float:
        return max(flops / (self.hw.peak_flops * self.hw.mmu_efficiency),
                   nbytes / self.hw.hbm_bw)

    def _linear_cost(self, tokens: int, d_in: int, d_out: int) -> float:
        flops = 2.0 * tokens * d_in * d_out / self.tp
        nbytes = (d_in * d_out / self.tp + tokens * (d_in + d_out)) \
            * self.m.dtype_bytes
        return self._roof(flops, nbytes)

    def _attn_context_cost(self, items: List[BatchItem]) -> float:
        m = self.m
        flops = 0.0
        nbytes = 0.0
        for it in items:
            if it.phase == "prefill":
                # causal: tokens x (context) / 2 average
                span = it.tokens * max(it.context, 1) / 2
            else:
                span = it.context
            flops += 4.0 * span * m.n_heads * m.d_head / self.tp
            nbytes += span * m.kv_bytes_per_token / self.tp \
                + it.tokens * m.n_heads * m.d_head * m.dtype_bytes * 3
        return self._roof(flops, nbytes)

    # ---- trace lookup with analytical fallback ----
    def _op(self, op: str, phase: str, tokens: int, context: int,
            analytical) -> float:
        """``analytical`` is a 0-arg thunk, evaluated only when the trace
        has no grid for ``(op, phase)`` — keeping the fallback lazy both
        skips wasted roofline math on trace-covered ops and leaves the
        statistical MoE router's RNG untouched when a trace prices the
        layer (so memoized pricing stays deterministic)."""
        if self.trace is not None:
            v = self.trace.interpolate(op, phase, tokens, context)
            if v is not None:
                return v
        return analytical()

    @staticmethod
    def _bucket(n: int, lo: int = 16) -> int:
        b = lo
        while b < n:
            b *= 2
        return b

    def _iter_level(self, items: List[BatchItem]) -> Optional[IterationCost]:
        """Iteration-granularity trace lookup (runtime_profiler points)."""
        if self.trace is None:
            return None
        pre = [i for i in items if i.phase == "prefill"]
        dec = [i for i in items if i.phase == "decode"]
        # prefill continuations (prefix-cache hits, chunked-prefill chunks
        # past the first) run the engine's ``extend`` path, which is priced
        # separately when the profiler measured it
        cont = [i for i in pre if i.start > 0]
        if cont and self.trace._grid("extend", "prefill"):
            pre = [i for i in pre if i.start == 0]
        else:
            cont = []
        total = 0.0
        for i in cont:
            v = self.trace.interpolate("extend", "prefill",
                                       self._bucket(i.tokens),
                                       i.start + i.tokens)
            if v is None:
                return None
            total += v
        if pre:
            T = sum(i.tokens for i in pre)
            if self.cfg.scheduler.bucket_prefill:
                T = self._bucket(T)
            v = self.trace.interpolate("iter", "prefill", T, T)
            if v is None:
                return None
            total += v
            if any(i.completes for i in pre) and \
                    (self.cfg.role == "prefill"
                     or self.cfg.prefix_cache.enabled):
                # P/D export, or radix-cache insert (same slot copy-out) —
                # charged once, when a request's prefill finishes
                ex = self.trace.interpolate("kv_export", "prefill", T, T)
                if ex is not None:
                    total += ex
        done_cont = [i for i in cont if i.completes]
        if done_cont and (self.cfg.role == "prefill"
                          or self.cfg.prefix_cache.enabled):
            # the insert (slot copy-out) lands once, on the extend iteration
            # that finishes the prompt — not on every chunk
            Tc = max(self._bucket(i.start + i.tokens) for i in done_cont)
            ex = self.trace.interpolate("kv_export", "prefill", Tc, Tc)
            if ex is not None:
                total += ex
        if dec:
            # the engine pads decode batches to its fixed slot count, so a
            # half-full batch costs the same as a full one: price at the
            # configured width, not the occupancy
            B = len(dec)
            if self.cfg.scheduler.decode_pad_to:
                B = max(B, self.cfg.scheduler.decode_pad_to)
            ctx = sum(i.context for i in dec) / len(dec)
            v = self.trace.interpolate("iter", "decode", B, int(ctx))
            if v is None:
                return None
            total += v
        return IterationCost(total, {"iter": total})

    # ---- kernel-granular tier (hwtrace/3 sub-buckets) ----
    def _kernel_backend(self) -> Optional[str]:
        """Which backend's ``kern:*`` rows price this instance.  The cfg's
        ``kernel_backend`` pins it; otherwise prefer cuda rows (they match
        what the port's engine runs on the card) and fall back to
        reference rows.  None
        when the trace carries no kernel sub-buckets for any candidate.
        Resolved once per model — traces are read-only in the sim."""
        bk = getattr(self, "_kern_bk", False)
        if bk is not False:
            return bk
        bk = None
        tr = self.trace
        if tr is not None:
            prefs = ([self.cfg.kernel_backend] if self.cfg.kernel_backend
                     else ["cuda", "reference"])
            for cand in prefs:
                if tr._grid(kern_op(cand, "attention"), "decode") \
                        or tr._grid(kern_op(cand, "attention"), "prefill"):
                    bk = cand
                    break
        self._kern_bk = bk
        return bk

    def _kernel_names(self) -> Tuple[str, str, str]:
        """The three kernel kinds one forward pass composes from."""
        return ("attention", "moe_gmm" if self.m.is_moe else "mlp", "head")

    def _kernel_coverage(self, phase: str) -> bool:
        """All three kernel grids present for ``phase``?"""
        bk = self._kernel_backend()
        return bk is not None and all(
            self.trace._grid(kern_op(bk, kn), phase)
            for kn in self._kernel_names())

    def _kernel_level(self, items: List[BatchItem]) -> Optional[IterationCost]:
        """Kernel-granularity pricing: ``L * attention + L * (mlp|moe_gmm) +
        head`` from hwtrace/3 sub-bucket rows, at the op-level tier's batch
        key (tokens = batch tokens, context = max context).  TP collectives
        and PP hops are composed analytically on top — single-device kernel
        sweeps cannot see them.  None when any kernel grid is missing for
        the batch's phase (op-level composition then takes over)."""
        bk = self._kernel_backend()
        if bk is None:
            return None
        tr = self.trace
        m = self.m
        phase = "prefill" if any(i.phase == "prefill" for i in items) \
            else "decode"
        T = sum(it.tokens for it in items)
        ctx = max(it.context for it in items)
        names = self._kernel_names()
        vals = []
        for kn in names:
            v = tr.interpolate(kern_op(bk, kn), phase, T, ctx)
            if v is None:
                return None
            vals.append(v)
        L = m.n_layers
        t_attn = L * vals[0]
        t_ffn = L * vals[1]
        t_head = vals[2]
        ar_bytes = T * m.d_model * m.dtype_bytes
        t_coll = 2 * L * allreduce_time(ar_bytes, self.tp, self.hw.link_bw)
        total = t_attn + t_ffn + t_head + t_coll
        if self.pp > 1:
            hop = T * m.d_model * m.dtype_bytes / self.hw.link_bw + 5e-6
            total = total + (self.pp - 1) * hop
        return IterationCost(total, {
            "kernel:attention": t_attn, f"kernel:{names[1]}": t_ffn,
            "kernel:head": t_head, "collective": t_coll,
            "kernel_backend": bk})

    def _moe_layer_cost(self, items: List[BatchItem], T: int,
                        routing_counts=None) -> float:
        """Mean per-MoE-layer analytical cost for this batch.

        With a routing trace attached, each of the trace's layers is
        priced from its *replayed* per-expert counts at the batch's token
        positions (imbalance, active expert set and offload traffic all
        follow the trace); the mean keeps the ``L * cost`` composition in
        ``iteration_latency`` exact even when the sim model's layer count
        differs from the trace's MoE-layer count.  Without a trace, the
        statistical router draws one representative layer.
        """
        if self.routing is not None:
            if routing_counts is None:
                pos = batch_positions(items)
                routing_counts = [self.routing.counts_for(l, pos)
                                  for l in range(self.routing.n_layers)]
            # counts are priced unclamped: capacity overflow is surfaced
            # as expert_load["drop_rate"] (a quality signal, dropped
            # tokens emit no output), while latency keeps charging the
            # full routed load — pass capacity_factor to ``layer_cost``
            # explicitly to study capacity-saturated pricing instead
            per = [self.expert_model.layer_cost(T, counts=c).total
                   for c in routing_counts]
            return float(np.mean(per))
        return self.expert_model.layer_cost(T).total

    def kv_copy_cost(self, tokens: int) -> float:
        """Slot copy cost (export/restore) for ``tokens`` of KV, from the
        measured kv_export trace; 0 when unprofiled."""
        if self.trace is None or tokens <= 0:
            return 0.0
        v = self.trace.interpolate("kv_export", "prefill",
                                   self._bucket(tokens), self._bucket(tokens))
        return v or 0.0

    def iteration_latency(self, items: List[BatchItem],
                          routing_counts=None) -> IterationCost:
        """``routing_counts`` optionally supplies the per-MoE-layer expert
        counts for this batch (derived once by the caller from the routing
        trace) so pricing and expert-load accounting share one bincount
        pass per iteration instead of each recomputing it."""
        if not items:
            return IterationCost(0.0, {})
        lvl = self._iter_level(items)
        if lvl is not None:
            return lvl
        lvl = self._kernel_level(items)
        if lvl is not None:
            return lvl
        m = self.m
        L = m.n_layers
        T = sum(it.tokens for it in items)
        phase = "prefill" if any(i.phase == "prefill" for i in items) \
            else "decode"
        ctx = max(it.context for it in items)

        qkv_d = (m.n_heads + 2 * m.n_kv_heads) * m.d_head
        t_qkv = L * self._op(
            "attn_qkv", phase, T, ctx,
            lambda: self._linear_cost(T, m.d_model, qkv_d)
            + self._linear_cost(T, m.n_heads * m.d_head, m.d_model))
        t_attn = L * self._op(
            "attn_score", phase, T, ctx,
            lambda: self._attn_context_cost(items))
        if m.is_moe:
            t_ffn = L * self._op(
                "moe_ffn", phase, T, ctx,
                lambda: self._moe_layer_cost(items, T, routing_counts))
        else:
            mults = 3 if m.mlp_gated else 2
            t_ffn = L * self._op(
                "mlp", phase, T, ctx,
                lambda: self._linear_cost(T, m.d_model, m.d_ff) * mults / 2
                + self._linear_cost(T, m.d_ff, m.d_model) / 2
                + self._linear_cost(T, m.d_model, m.d_ff) * (mults - 2))
        t_norm = L * self._op(
            "norm", phase, T, ctx,
            lambda: self._roof(10.0 * T * m.d_model,
                               4.0 * T * m.d_model * m.dtype_bytes))
        t_head = self._op(
            "head", phase, T, ctx,
            lambda: self._linear_cost(sum(1 for i in items)
                                      if phase == "decode"
                                      else T, m.d_model, m.vocab))
        t_embed = self._op(
            "embed", phase, T, ctx,
            lambda: self._roof(0.0, T * m.d_model * m.dtype_bytes * 2))
        # TP all-reduce: 2 per layer on the activations
        ar_bytes = T * m.d_model * m.dtype_bytes
        t_coll = 2 * L * allreduce_time(ar_bytes, self.tp, self.hw.link_bw)
        total = t_qkv + t_attn + t_ffn + t_norm + t_head + t_embed + t_coll
        # pipeline parallelism: per-iteration inter-stage activation hops
        # (throughput overlap across iterations is handled by the scheduler
        # running pp iterations in flight)
        if self.pp > 1:
            hop = T * m.d_model * m.dtype_bytes / self.hw.link_bw + 5e-6
            total = total + (self.pp - 1) * hop
        return IterationCost(total, {
            "qkv": t_qkv, "attn": t_attn, "ffn": t_ffn, "norm": t_norm,
            "head": t_head, "embed": t_embed, "collective": t_coll})

    # ---- fast-path helpers ----
    def pricing_deterministic(self) -> bool:
        """Whether iteration pricing is a pure function of the batch shape.
        False only when the statistical MoE router (a stateful RNG) can be
        consumed: an MoE model whose trace does not cover ``moe_ffn`` for
        both phases.  Memoizing or speculatively re-pricing such batches
        would change the draw stream and thus the simulated timeline."""
        if not self.m.is_moe or self.routing is not None:
            return True
        tr = self.trace
        if tr is None:
            return False
        if self._kernel_coverage("prefill") and \
                self._kernel_coverage("decode"):
            # complete hwtrace/3 kernel coverage: every batch is priced at
            # the kernel tier (or above), so the analytical MoE thunk —
            # and with it the router RNG — is never reached
            return True
        return bool(tr._grid("moe_ffn", "prefill")) \
            and bool(tr._grid("moe_ffn", "decode"))

    def decode_window(self, items: List[BatchItem],
                      n: int) -> Optional[np.ndarray]:
        """Per-step totals for ``n`` successive decode iterations of a
        frozen batch (every item's context grows by 1 per step): element
        ``i`` equals ``iteration_latency`` on the batch advanced ``i``
        steps, bit-identically — both paths run the same interpolation
        kernel and the same scalar accumulation chains.  None when
        vectorization can't guarantee that (no trace, an op grid missing so
        the per-item analytical fallback would engage, a routing trace
        making cost position-dependent, or a non-decode item) — callers
        then price step by step."""
        if self.trace is None or self.routing is not None or n <= 0:
            return None
        if not items or any(i.phase != "decode" for i in items):
            return None
        tr = self.trace
        steps = np.arange(n)
        if tr._grid("iter", "decode"):
            B = len(items)
            if self.cfg.scheduler.decode_pad_to:
                B = max(B, self.cfg.scheduler.decode_pad_to)
            csum = sum(i.context for i in items)
            ctx = ((csum + steps * len(items))
                   / len(items)).astype(np.int64)
            return tr.interpolate_many("iter", "decode", np.full(n, B), ctx)
        m = self.m
        bk = self._kernel_backend()
        if bk is not None and self._kernel_coverage("decode"):
            # kernel tier, vectorized: same interpolation kernel and the
            # same accumulation order as ``_kernel_level`` — bit-identical
            # to stepped pricing
            names = self._kernel_names()
            L = m.n_layers
            T = sum(it.tokens for it in items)
            ctx = max(it.context for it in items) + steps
            tok = np.full(n, T)
            t_attn = L * tr.interpolate_many(kern_op(bk, names[0]),
                                             "decode", tok, ctx)
            t_ffn = L * tr.interpolate_many(kern_op(bk, names[1]),
                                            "decode", tok, ctx)
            t_head = tr.interpolate_many(kern_op(bk, names[2]),
                                         "decode", tok, ctx)
            ar_bytes = T * m.d_model * m.dtype_bytes
            t_coll = 2 * L * allreduce_time(ar_bytes, self.tp,
                                            self.hw.link_bw)
            total = t_attn + t_ffn + t_head + t_coll
            if self.pp > 1:
                hop = T * m.d_model * m.dtype_bytes / self.hw.link_bw + 5e-6
                total = total + (self.pp - 1) * hop
            return total
        ops = ("attn_qkv", "attn_score",
               "moe_ffn" if m.is_moe else "mlp", "norm", "head", "embed")
        if not all(tr._grid(op, "decode") for op in ops):
            return None
        L = m.n_layers
        T = sum(it.tokens for it in items)
        ctx = max(it.context for it in items) + steps
        tok = np.full(n, T)

        def op(name):
            return tr.interpolate_many(name, "decode", tok, ctx)

        t_qkv = L * op("attn_qkv")
        t_attn = L * op("attn_score")
        t_ffn = L * op(ops[2])
        t_norm = L * op("norm")
        t_head = op("head")
        t_embed = op("embed")
        ar_bytes = T * m.d_model * m.dtype_bytes
        t_coll = 2 * L * allreduce_time(ar_bytes, self.tp, self.hw.link_bw)
        total = t_qkv + t_attn + t_ffn + t_norm + t_head + t_embed + t_coll
        if self.pp > 1:
            hop = T * m.d_model * m.dtype_bytes / self.hw.link_bw + 5e-6
            total = total + (self.pp - 1) * hop
        return total
