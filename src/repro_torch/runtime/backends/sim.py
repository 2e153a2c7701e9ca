"""Simulation backend: batches are priced, never executed.

Wraps the trace-driven ``PerfModel`` + paged ``MemoryModel`` — exactly the
pricing the old ``core.instance.Instance`` iteration loop did inline.  All
scheduling/caching/routing decisions arrive from the unified runtime; this
class only turns a decided batch into seconds.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.config import InstanceCfg
from repro_torch.core.memory import MemoryModel
from repro_torch.core.perfmodel import BatchItem, PerfModel, batch_positions
from repro_torch.core.request import SimRequest
from repro_torch.core.trace import Trace
from repro_torch.obs.events import SPEC_STEP
from repro_torch.runtime.backend import KvHandoff
from repro_torch.runtime.prefix_cache import MatchResult
from repro_torch.runtime.scheduler import ScheduledWork, to_batch_items


#: iteration-memo entries kept before a wholesale reset (exact keys)
_ITER_MEMO_CAP = 1 << 17


class SimBackend:
    name = "sim"

    def __init__(self, cfg: InstanceCfg, trace: Optional[Trace] = None,
                 fast_path: bool = True):
        self.cfg = cfg
        self.fast_path = bool(fast_path)
        self.memory = MemoryModel(cfg)
        # replayable expert-routing trace (MoECfg.routing_trace): prices
        # per-layer expert load and feeds the uniform expert_load metrics.
        # Imported lazily: repro_torch.moe sits above repro_torch.core in the layering
        # (it consumes core.expert), so a cold import of this module must
        # not re-enter it mid-initialization.
        from repro_torch.moe import ExpertLoadTracker, resolve_routing
        self.routing = resolve_routing(cfg)
        self.expert_load = ExpertLoadTracker(
            self.routing, ep=cfg.parallelism.ep,
            capacity_factor=cfg.model.moe_capacity_factor) \
            if self.routing is not None else None
        self.perf = PerfModel(cfg, trace=trace, routing=self.routing)
        # speculative decoding (SpecCfg): every decode step becomes a
        # draft-propose + target-verify pair priced below, advancing the
        # request by accepted + 1 tokens drawn deterministically from the
        # named AcceptanceTrace (repro_torch.spec — lazily imported, same
        # layering rule as repro_torch.moe above).
        self.spec = cfg.spec if getattr(cfg.spec, "enabled", False) else None
        self.spec_trace = None
        self.spec_tracker = None
        self.draft_perf = None
        self._emitted = {}       # req_id -> tokens emitted by the last step
        self._spec_steps = {}    # req_id -> spec-step ordinal (quantile key)
        if self.spec is not None:
            import dataclasses

            from repro_torch.spec import (SpecDecodeTracker,
                                          draft_model_spec,
                                          resolve_acceptance)
            if self.routing is not None:
                raise ValueError(
                    f"instance {cfg.name!r} enables both a routing trace "
                    f"and speculative decoding — the combination is not "
                    f"supported (positions of draft tokens that fail "
                    f"verification have no expert-load semantics)")
            self.spec_trace = resolve_acceptance(cfg)
            if self.spec_trace is None:
                raise ValueError(
                    f"instance {cfg.name!r} enables speculative decoding "
                    f"but names no acceptance_trace; the simulator draws "
                    f"accepted lengths from the trace — record one with "
                    f"`python -m repro_torch.profiler record-acceptance` or "
                    f"synthesize one with repro_torch.workload.acceptance")
            if cfg.scheduler.decode_tokens != self.spec.k + 1:
                raise ValueError(
                    f"instance {cfg.name!r} speculates k={self.spec.k} "
                    f"but its scheduler reserves decode_tokens="
                    f"{cfg.scheduler.decode_tokens}; set SchedulerCfg("
                    f"decode_tokens=k + 1) so the KV ledger covers the "
                    f"verification window")
            self.spec_tracker = SpecDecodeTracker(self.spec.k)
            draft = self.spec.draft or draft_model_spec(
                cfg.model, self.spec.draft_scale)
            self.draft_perf = PerfModel(
                dataclasses.replace(cfg, model=draft,
                                    spec=dataclasses.replace(
                                        cfg.spec, enabled=False)),
                trace=None)
        # prefix-cache restore / tier-fetch latency charged to the next
        # iteration (the request that hit pays for its own fetch); spill
        # traffic (device->host->ssd demotions) is priced the same way —
        # the instance whose insert/admission forced the eviction pays
        self._pending_fetch_s = 0.0
        # last on_prefix_hit's total restore charge — the per-request
        # seconds the kv_restore event (and latency attribution) reports
        self.last_restore_s = 0.0
        # event recorder, wired by RuntimeInstance.attach_obs
        self.obs = None
        self._restored_tokens = 0
        self._restore_events = 0
        self._fetch_bytes = 0.0
        self._spill_bytes = 0.0
        self._fetch_s = 0.0
        self._spill_s = 0.0
        self._tput_hint = {}     # phase -> lazily priced reference tokens/s
        # ---- fast path (exact-mode opt-out: fast_path=False) ----
        # iteration-cost memo on the exact batch-shape signature.  Safe
        # only when pricing is a pure function of the signature: no
        # replayed routing trace (position-dependent), no spec decode
        # (step-ordinal-dependent draws), no statistical-MoE fallback
        # (stateful RNG).  Exact keys mean a hit returns the identical
        # float the slow path would have computed.
        self._memo_on = (self.fast_path and self.routing is None
                         and self.spec is None
                         and self.perf.pricing_deterministic())
        self._iter_memo = {}
        # decode fast-forward needs the same determinism guarantees
        self.supports_fast_forward = self._memo_on

    def warmup(self):
        pass

    def prompt_cap(self, req: SimRequest):
        return None

    def throughput_hint(self, phase: Optional[str] = None) -> float:
        """Trace-priced tokens/s on a reference batch — the cold-start
        signal ``hardware_aware`` routing uses before observed throughput
        exists.  ``phase`` selects the per-phase reference (a 256-token
        prefill, or a 4-wide decode at context 256); ``None`` blends both
        for unified-role instances.  P/D role-aware placement queries the
        matching phase so a prefill-fast device is rated by its prefill
        grid, not a blend it will never run."""
        if None not in self._tput_hint:
            pre = self.perf.iteration_latency(
                [BatchItem(tokens=256, context=256, phase="prefill")])
            dec = self.perf.iteration_latency(
                [BatchItem(tokens=1, context=256, phase="decode")
                 for _ in range(4)])
            self._tput_hint["prefill"] = 256 / max(pre.total_s, 1e-12)
            self._tput_hint["decode"] = 4 / max(dec.total_s, 1e-12)
            self._tput_hint[None] = (256 + 4) / max(
                pre.total_s + dec.total_s, 1e-12)
        # unknown phase strings fall back to the blended estimate rather
        # than crashing a custom routing policy
        return self._tput_hint.get(phase, self._tput_hint[None])

    def execute(self, work: List[ScheduledWork], now: float) -> float:
        spec_s = 0.0
        if self.spec is not None:
            decodes = [w for w in work if w.phase == "decode"]
            if decodes:
                spec_s = self._spec_step(decodes, now)
            work = [w for w in work if w.phase != "decode"]
        items = to_batch_items(work)
        counts = n_tokens = None
        if self.routing is not None:
            # one bincount pass per iteration, shared by pricing and the
            # expert-load accounting (the real engine accounts
            # independently, from its slot lengths — that independence is
            # what the parity suite tests)
            pos = batch_positions(items)
            n_tokens = int(pos.size)
            counts = [self.routing.counts_for(l, pos)
                      for l in range(self.routing.n_layers)]
        total = self._priced(items, counts)
        latency = total + spec_s + self._pending_fetch_s
        self._pending_fetch_s = 0.0
        if self.expert_load is not None:
            self.expert_load.observe_counts(counts, n_tokens, now)
        return latency

    def _priced(self, items: List[BatchItem], counts=None) -> float:
        """Memoized ``iteration_latency``: identical batch shapes price
        once (exact-key signature, so a hit is the identical float)."""
        if not self._memo_on:
            return self.perf.iteration_latency(
                items, routing_counts=counts).total_s
        sig = tuple((i.phase, i.tokens, i.context, i.start, i.completes)
                    for i in items)
        total = self._iter_memo.get(sig)
        if total is None:
            if len(self._iter_memo) >= _ITER_MEMO_CAP:
                self._iter_memo.clear()
            total = self.perf.iteration_latency(items).total_s
            self._iter_memo[sig] = total
        return total

    def fast_forward(self, work: List[ScheduledWork], n_max: int,
                     now: float, horizon: float) -> Optional[List[float]]:
        """Price up to ``n_max`` successive decode iterations of a frozen
        batch (every request emits 1 token/step).  Returns per-step
        latencies ``[l1..ln]`` with every chained completion time strictly
        before ``horizon`` and ``n >= 2``, or None when fewer than 2 steps
        fit (the caller then runs the normal single-step path).  Step 1's
        price includes any pending prefix-fetch charge, exactly as
        ``execute`` would have applied it; the charge is only consumed on
        success."""
        items = to_batch_items(work)
        fetch0 = self._pending_fetch_s
        # cheap pre-cap: step 1's price (memoized) bounds how many steps
        # can fit before the horizon, so a near barrier fails fast and a
        # far one doesn't price thousands of steps it will then discard.
        # Latencies grow with context, so the estimate only ever trims
        # the window — the exact strict-inequality cap below decides.
        span = horizon - now
        if span != float("inf"):
            l1 = self._priced(items) + fetch0
            if l1 > 0.0:
                est = int(span / l1) + 1
                if est < 2:
                    return None
                n_max = min(n_max, est)
        totals = self.perf.decode_window(items, n_max)
        if totals is None:
            # per-step fallback: same call sequence the slow path makes
            totals = []
            for i in range(n_max):
                if i:
                    for it in items:
                        it.context += 1
                totals.append(self._priced(items))
        lat: List[float] = []
        t = now
        fetch = self._pending_fetch_s
        for i, v in enumerate(totals):
            v = float(v)
            if i == 0:
                v = v + fetch
            t2 = t + v
            if t2 >= horizon:
                break
            lat.append(v)
            t = t2
        if len(lat) < 2:
            return None
        self._pending_fetch_s = 0.0
        return lat

    def _spec_step(self, decodes: List[ScheduledWork], now: float) -> float:
        """Price one speculative decode step for the scheduled decode set
        and draw each request's accepted length from the trace.

        Cost model mirrors what the real engine executes: ``k + 1``
        sequential draft decode iterations (propose d1..dk, then consume
        dk so the draft KV stays in sync) plus one batched target
        verification — an ``extend`` over the pending token + k drafts,
        priced through the measured extend grid when the hardware trace
        has one.  Acceptance does not change the step's cost, only its
        progress: that asymmetry is exactly the wasted-compute crossover
        ``benchmarks/spec_decode_sweep.py`` sweeps.

        Tail clamp: a request with fewer than ``k + 1`` output tokens left
        shrinks its draft/verify window to what it can still emit
        (``k_eff = output_len - generated - 1``); the batch drafts to the
        widest surviving window.  The real engine applies the identical
        clamp, so near-budget steps neither price nor execute drafts the
        request could never keep.
        """
        k = self.spec.k
        verify_items = []
        draft_items = []
        k_step = 0
        for w in decodes:
            req = w.request
            k_eff = max(0, min(k, req.output_len - req.generated - 1))
            k_step = max(k_step, k_eff)
            ctx = req.context_len
            verify_items.append(BatchItem(
                tokens=k_eff + 1, context=ctx + k_eff, phase="prefill",
                start=max(ctx - 1, 0), completes=False))
            draft_items.append(BatchItem(
                tokens=1, context=ctx + 1, phase="decode"))
        latency = self.perf.iteration_latency(verify_items).total_s \
            + (k_step + 1) * self.draft_perf.iteration_latency(
                draft_items).total_s
        obs = self.obs
        for w in decodes:
            req = w.request
            k_eff = max(0, min(k, req.output_len - req.generated - 1))
            pos = max(req.generated - 1, 0)
            step = self._spec_steps.get(req.req_id, 0)
            self._spec_steps[req.req_id] = step + 1
            accepted = min(self.spec_trace.accepted_for(pos, step), k_eff)
            self._emitted[req.req_id] = max(
                1, min(accepted + 1, req.output_len - req.generated))
            self.spec_tracker.observe(pos, accepted, now, proposed=k_eff)
            if obs is not None:
                obs.emit(now, SPEC_STEP, inst=self.cfg.name,
                         req=req.req_id, tenant=req.tenant,
                         payload={"accepted": int(accepted),
                                  "proposed": int(k_eff)})
        return latency

    def decode_emitted(self, req: SimRequest) -> int:
        """Tokens the last decode step emitted for ``req`` (1 without
        speculative decoding; accepted + 1 with it)."""
        return self._emitted.pop(req.req_id, 1)

    def on_prefix_hit(self, req: SimRequest, match: MatchResult,
                      usable: int) -> int:
        kb = self.memory.kv_bytes_per_token
        host_b = match.host_tokens * kb
        ssd_b = match.ssd_tokens * kb
        fetch0 = self._pending_fetch_s
        if host_b > 0:
            # promote host-tier blocks: pay the fetch on this request
            t = self.memory.transfer_time(host_b, "host", "device")
            self._pending_fetch_s += t
            self._fetch_s += t
            self._fetch_bytes += host_b
        if ssd_b > 0:
            # SSD-resident blocks pay the (slower) SSD->device path
            t = self.memory.transfer_time(ssd_b, "ssd", "device")
            self._pending_fetch_s += t
            self._fetch_s += t
            self._fetch_bytes += ssd_b
        if usable > 0:
            # restoring the hit KV into the running cache is a real slot
            # copy (measured by the engine profiler as kv_export)
            self._pending_fetch_s += self.perf.kv_copy_cost(usable)
            self._restored_tokens += usable
            self._restore_events += 1
        self.last_restore_s = self._pending_fetch_s - fetch0
        return usable

    def on_tier_transfer(self, src: str, dst: str, n_bytes: float,
                         prefix) -> None:
        """Settle one cache tier move.  Spills (dst is a lower tier) are
        priced through ``transfer_time`` into the next iteration, same
        carry discipline as prefix fetches.  Promotes (dst == device) were
        already priced by ``on_prefix_hit`` from the match's lower-tier
        bytes — pricing them again here would double-charge.  Drops move
        no bytes."""
        if dst in ("host", "ssd"):
            t = self.memory.transfer_time(n_bytes, src, dst)
            self._pending_fetch_s += t
            self._spill_s += t
            self._spill_bytes += n_bytes

    def kv_tier_stats(self) -> dict:
        return {"restored_tokens": self._restored_tokens,
                "restore_events": self._restore_events,
                "fetch_bytes": self._fetch_bytes,
                "spill_bytes": self._spill_bytes,
                "fetch_s": self._fetch_s,
                "spill_s": self._spill_s}

    def on_prefill_complete(self, req: SimRequest):
        pass     # insert cost is modeled inside the perf trace (kv_export)

    def on_preempt(self, req: SimRequest) -> int:
        # a preempted request restarts its decode from scratch, so its
        # spec-step ordinal restarts too (the real backend's counter is
        # slot-scoped and resets the same way on release)
        self._spec_steps.pop(req.req_id, None)
        self._emitted.pop(req.req_id, None)
        return req.cached_prefix   # simulated KV prefix stays restorable

    def release(self, req: SimRequest):
        self._spec_steps.pop(req.req_id, None)
        self._emitted.pop(req.req_id, None)

    def export_kv(self, req: SimRequest) -> KvHandoff:
        return KvHandoff(
            nbytes=req.prompt_len * self.cfg.model.kv_bytes_per_token)

    def import_kv(self, req: SimRequest, handoff: Optional[KvHandoff]):
        pass

    def reset(self):
        self._emitted.clear()
        self._spec_steps.clear()

    def stats(self) -> dict:
        s = {}
        if self.expert_load is not None:
            s["expert_load"] = self.expert_load.metrics()
        if self.spec_tracker is not None:
            s["spec_decode"] = self.spec_tracker.metrics()
        return s
