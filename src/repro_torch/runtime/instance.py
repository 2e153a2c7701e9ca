"""A serving instance: scheduler + prefix cache + pluggable backend.

Runs the iteration loop as events on the shared queue: pick a batch with the
unified ``BatchScheduler``, hand it to the ``ExecutionBackend`` (which either
prices it — simulator — or really executes it and measures wall time — JAX
engine), schedule the completion event, apply results (prefill progress,
decode tokens, finishes), repeat.  Roles: unified | prefill | decode (P/D
disaggregation wires prefill instances to decode instances via the cluster's
KV-transfer path).

Because the loop, scheduler, cache policy and P/D flow are shared, the
sequence of scheduling decisions (``self.decisions``) is identical across
backends for the same workload — only the time axis differs.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.config import InstanceCfg
from repro_torch.core.engine import EventQueue
from repro_torch.core.request import (DECODING, FINISHED, QUEUED,
                                TRANSFERRING, SimRequest)
from repro_torch.obs.events import (ADMIT, FINISH, ITER, KV_RESTORE, KV_TIER,
                              PD_ADMIT, PREEMPT)
from repro_torch.runtime.backend import ExecutionBackend, KvHandoff
from repro_torch.runtime.prefix_cache import RadixPrefixCache
from repro_torch.runtime.scheduler import BatchScheduler, ScheduledWork


class RuntimeInstance:
    def __init__(self, cfg: InstanceCfg, queue: EventQueue,
                 backend: ExecutionBackend,
                 cache: Optional[RadixPrefixCache] = None):
        self.cfg = cfg
        self.name = cfg.name
        self.queue = queue
        self.backend = backend
        self.mem = backend.memory
        self.scheduler = BatchScheduler(cfg.scheduler, self.mem)
        self.scheduler.on_preempt = self._on_preempt
        self.cache = cache
        self.alive = True
        self.busy = False
        # set by the cluster: True when this instance's iteration events
        # provably touch only this instance (no P/D wiring, no shared
        # prefix cache), making them skippable for other instances'
        # decode fast-forward horizons
        self.iter_skippable = False
        # last observed decode-step latency: a cheap span pre-gate for
        # fast-forward attempts (purely advisory — skipping an attempt
        # never changes results, only which iterations get bulked)
        self._ff_latency_hint: Optional[float] = None
        self.busy_time = 0.0
        self.iterations = 0
        self.total_tokens = 0
        # per-phase observed throughput: pure-phase iterations attribute
        # their latency+tokens to that phase (mixed iterations only feed
        # the blended totals above) — the signal P/D role-aware routing
        # prefers over the blended reference batch
        self.phase_tokens: Dict[str, int] = {"prefill": 0, "decode": 0}
        self.phase_time: Dict[str, float] = {"prefill": 0.0, "decode": 0.0}
        self.phase_iters: Dict[str, int] = {"prefill": 0, "decode": 0}
        # (req_id, phase, tokens) per work item per iteration — the policy
        # trace the sim/real parity test compares across backends (bounded:
        # long production simulations keep only the most recent window)
        self.decisions: Deque[Tuple[Tuple[int, str, int], ...]] = \
            deque(maxlen=65536)
        # KV-pool watermark timeline: (t, pool blocks in use, running reqs)
        # sampled once per iteration — vLLM-style watermark plots.  The
        # window is configurable (InstanceCfg.watermark_window) and the
        # dropped-sample count is surfaced in stats() so timeline
        # consumers know when the record is truncated
        self.kv_watermark: Deque[Tuple[float, int, int]] = \
            deque(maxlen=max(int(cfg.watermark_window), 1))
        self._wm_appended = 0
        # event recorder (None = tracing disabled; every emission site is
        # guarded so the disabled path costs one attribute load)
        self.obs = None
        # callbacks wired by the cluster
        self.on_prefill_done: Optional[Callable] = None   # P/D handoff
        self.on_request_done: Optional[Callable] = None
        # set when the instance has been removed from the fleet (elastic
        # scale-in): a late P/D arrival (KV transfer scheduled before the
        # removal landed) is handed back for re-dispatch instead of being
        # parked on an instance that will never iterate again
        self.on_dead_arrival: Optional[Callable] = None
        # P/D arrivals that found no slot/memory; drained as capacity frees
        self._pending_decode: Deque[Tuple[SimRequest,
                                          Optional[KvHandoff]]] = deque()

    # ---- observability ----
    def attach_obs(self, recorder) -> None:
        """Enable event tracing: wire the recorder into the instance, its
        scheduler (admission hook) and its backend (spec-step events)."""
        self.obs = recorder
        self.scheduler.on_admit = self._emit_admit
        self.backend.obs = recorder

    def _emit_admit(self, req: SimRequest):
        self.obs.emit(self.queue.now, ADMIT, inst=self.name,
                      req=req.req_id, tenant=req.tenant)

    # ---- request entry ----
    def submit(self, req: SimRequest):
        if not self.alive:
            raise RuntimeError(f"submit to dead instance {self.name}")
        req.instance = self.name
        cap = self.backend.prompt_cap(req)
        if cap is not None and req.prompt_len > cap:
            # keep scheduler bookkeeping and backend KV state in agreement
            req.prompt_tokens = list(req.prompt_tokens)[:max(cap, 1)]
        if self.cache is not None and req.state == QUEUED \
                and req.prefill_done_tokens == 0:
            m = self.cache.match(req.prompt_tokens, self.queue.now,
                                 getattr(req, "priority", 0))
            # never cache-skip the whole prompt: the last token must be
            # recomputed to produce the first output logits
            usable = min(m.tokens, req.prompt_len - 1)
            usable = max(usable, 0)
            # backend clamps to what it can actually restore and accounts
            # any tier-fetch / KV-copy cost
            req.cached_prefix = self.backend.on_prefix_hit(req, m, usable)
            if m.lower_tier_bytes > 0:
                self.cache.promote(m.nodes, self.queue.now)
            self.cache.pin(m.nodes)
            req._pinned_nodes = m.nodes   # type: ignore[attr-defined]
            self._settle_cache()
            obs = self.obs
            if obs is not None and m.tokens > 0:
                obs.emit(self.queue.now, KV_RESTORE, inst=self.name,
                         req=req.req_id, tenant=req.tenant,
                         payload={"tokens": usable,
                                  "seconds": getattr(self.backend,
                                                     "last_restore_s", 0.0),
                                  "host_tokens": m.host_tokens,
                                  "ssd_tokens": m.ssd_tokens})
        self.scheduler.enqueue(req)
        self._kick()

    # ---- iteration loop ----
    def _kick(self):
        if self.alive and not self.busy:
            self._start_iteration()

    def _start_iteration(self):
        work = self.scheduler.next_batch()
        if not work:
            self.busy = False
            return
        self.busy = True
        if self._maybe_fast_forward(work):
            return
        self.decisions.append(
            tuple((w.request.req_id, w.phase, w.tokens) for w in work))
        latency = self.backend.execute(work, self.queue.now)
        host = None
        if self.obs is not None:
            # the real engine's blocking waits, read before another
            # instance's iteration can run
            waits = getattr(self.backend, "iteration_waits", None)
            host = waits() if waits is not None else None
        self.iterations += 1
        tokens = sum(w.tokens for w in work)
        self.total_tokens += tokens
        self.busy_time += latency
        phases = {w.phase for w in work}
        if len(phases) == 1:
            phase = phases.pop()
            self.phase_tokens[phase] += tokens
            self.phase_time[phase] += latency
            self.phase_iters[phase] += 1
            if phase == "decode":
                # rough per-step cost, feeding the fast-forward pre-gate
                self._ff_latency_hint = latency
        self.queue.schedule(latency,
                            lambda: self._finish_iteration(work, latency,
                                                           host),
                            tag=f"{self.name}.iter",
                            skippable=self.iter_skippable)

    def _finish_iteration(self, work: List[ScheduledWork],
                          latency: float = 0.0,
                          host: Optional[dict] = None):
        if not self.alive:
            return
        now = self.queue.now
        self.kv_watermark.append(
            (now, self.mem.total_blocks - self.mem.free_blocks,
             len(self.scheduler.running)))
        self._wm_appended += 1
        obs = self.obs
        if obs is not None:
            phases = {w.phase for w in work}
            obs.emit(now, ITER, inst=self.name,
                     phase=(phases.pop() if len(phases) == 1 else "mixed"),
                     dur=latency,
                     payload={"items": tuple((w.request.req_id, w.phase,
                                              w.tokens) for w in work),
                              "kv_used": self.mem.total_blocks
                              - self.mem.free_blocks,
                              "running": len(self.scheduler.running),
                              "waiting": len(self.scheduler.waiting)},
                     host=host)
        for w in work:
            req = w.request
            if w.phase == "prefill":
                req.prefill_done_tokens += w.tokens
                if req.remaining_prefill == 0:
                    self._prefill_complete(req)
            else:
                # a decode step emits 1 token classically; a speculative
                # step emits accepted + 1 (backends report the count —
                # the trace draw in sim, the verification outcome for the
                # real engine), capped at the request's output budget
                emitted = 1
                fn = getattr(self.backend, "decode_emitted", None)
                if fn is not None:
                    emitted = fn(req)
                emitted = max(1, min(emitted,
                                     req.output_len - req.generated))
                req.generated += emitted
                req.token_times.extend([now] * emitted)
                if req.t_first_token is None:
                    req.t_first_token = now
                if req.generated >= req.output_len:
                    self._finish_request(req)
        self._drain_pending_decode()
        self.busy = False
        self._start_iteration()

    # ---- decode fast-forward ----
    #: max steps per bulk event — bounds the synthesized timeline arrays
    #: (and matches the kv_watermark window) without limiting total skip
    FF_CHUNK = 4096

    def _maybe_fast_forward(self, work: List[ScheduledWork]) -> bool:
        """Advance a provably frozen decode set many iterations in one
        event.  Sound exactly when nothing can change the per-step
        decision between now and the next barrier: the backend's pricing
        is deterministic, no request is waiting/parked (admission retries
        every slow-path iteration), every running request is mid-decode
        (finishes can only land on the window's LAST step — the window
        never extends past the earliest completion, and the apply event
        runs the identical finish handling), and memory can grow the
        whole window without a preemption the slow path wouldn't have
        done.  Every synthesized
        artifact — decisions, token times, watermark samples, phase
        accounting, the KV ledger — is computed by the same arithmetic
        the stepped path runs, so fast and exact modes are bit-identical
        (``tests/test_fast_path.py``)."""
        be = self.backend
        if not getattr(be, "supports_fast_forward", False):
            return False
        if self._pending_decode:
            return False
        if self.scheduler.waiting and len(self.scheduler.running) \
                < self.scheduler.cfg.max_batch_size:
            # a free slot means the slow path would retry admission every
            # iteration (with possible preemption on memory pressure); at
            # capacity the admission loop is slot-gated before any side
            # effect, no slot can free before the window's last step, and
            # the apply event re-runs admission right there — so waiting
            # requests stay frozen exactly as the stepped path would
            # leave them
            return False
        if any(w.phase != "decode" for w in work):
            return False
        if any(r.state != DECODING for r in self.scheduler.running):
            return False
        # advisory pre-gate: when the span to the next barrier can't fit
        # ~2 steps of the last observed decode latency, skip the attempt
        # before paying any pricing.  A skipped window runs stepped —
        # results are identical either way (fast-forward is
        # identity-preserving), so a stale hint costs only speed.  This
        # keeps barrier-dense shapes (P/D interleaving, saturated
        # arrivals) from paying attempt overhead thousands of times.
        horizon = self.queue.next_barrier_time()
        span = horizon - self.queue.now
        if span <= 0.0:
            return False
        hint = self._ff_latency_hint
        if hint is not None and span < 2.0 * hint:
            return False
        n_max = min(w.request.output_len - w.request.generated
                    for w in work)
        n_max = min(n_max, self.FF_CHUNK)
        if n_max < 2:
            return False
        reqs = [w.request for w in work]
        n_max = self.scheduler.decode_window_steps(reqs, n_max)
        if n_max < 2:
            return False
        lat = be.fast_forward(work, n_max, self.queue.now, horizon)
        if lat is None:
            return False
        self._ff_latency_hint = lat[-1]
        # commit: capture pool usage BEFORE the lump reservation, then
        # grow the ledger exactly as n stepped reservations would have
        used0 = self.mem.total_blocks - self.mem.free_blocks
        used_deltas = self.scheduler.decode_window_usage(reqs, len(lat))
        self.scheduler.advance_decode(reqs, len(lat))
        decision = tuple((w.request.req_id, w.phase, w.tokens)
                         for w in work)
        times = []
        t = self.queue.now
        for l in lat:
            t = t + l
            times.append(t)
        self.queue.schedule_at(
            times[-1],
            lambda: self._apply_fast_forward(work, decision, lat, times,
                                             used_deltas, used0),
            tag=f"{self.name}.iter", skippable=self.iter_skippable)
        return True

    def _apply_fast_forward(self, work: List[ScheduledWork], decision,
                            lat, times, used_deltas, used0: int):
        """Land the bulk event: replay the per-step bookkeeping the
        stepped path would have produced, in the same accumulation
        order (float sums are order-sensitive)."""
        if not self.alive:
            return
        n = len(lat)
        tokens = sum(w.tokens for w in work)
        nrun = len(self.scheduler.running)
        # the window stands for n next_batch calls but composed only one:
        # replay the other n - 1 steps' per-tenant service increments
        self.scheduler.account_window(work, n - 1)
        for i in range(n):
            self.decisions.append(decision)
            self.kv_watermark.append(
                (times[i], used0 + int(used_deltas[i]), nrun))
            self.busy_time += lat[i]
            self.phase_time["decode"] += lat[i]
        self._wm_appended += n
        obs = self.obs
        if obs is not None:
            # synthesize the per-step iteration events the stepped path
            # would have emitted — same timestamps, durations and gauges
            # (the waiting/running sets are provably frozen mid-window)
            waiting = len(self.scheduler.waiting)
            for i in range(n):
                obs.emit(times[i], ITER, inst=self.name, phase="decode",
                         dur=lat[i],
                         payload={"items": decision,
                                  "kv_used": used0 + int(used_deltas[i]),
                                  "running": nrun, "waiting": waiting})
        self.iterations += n
        self.total_tokens += tokens * n
        self.phase_tokens["decode"] += tokens * n
        self.phase_iters["decode"] += n
        for w in work:
            req = w.request
            req.generated += n
            req.token_times.extend(times)
            if req.t_first_token is None:
                req.t_first_token = times[0]
            if req.generated >= req.output_len:
                # only possible on the window's last step (the window is
                # capped at the earliest remaining-output count), so this
                # runs at the same simulated time as the stepped path's
                # finish — releasing KV, unpinning, notifying the cluster
                self._finish_request(req)
        self._drain_pending_decode()
        self.busy = False
        self._start_iteration()

    def _prefill_complete(self, req: SimRequest):
        now = self.queue.now
        # first token is produced by the prefill's last iteration
        if req.t_first_token is None:
            req.t_first_token = now
            req.token_times.append(now)
            req.generated = 1
        if self.cache is not None:
            self.cache.insert(req.prompt_tokens, now,
                              getattr(req, "priority", 0))
            self.backend.on_prefill_complete(req)
            self._settle_cache()
        if self.cfg.role == "prefill" and self.on_prefill_done is not None:
            req.state = TRANSFERRING
            self.scheduler.complete(req)
            self._unpin(req)
            self.on_prefill_done(req, self)
        else:
            req.state = DECODING
            if req.generated >= req.output_len:
                self._finish_request(req)

    def _finish_request(self, req: SimRequest):
        req.state = FINISHED
        req.t_finish = self.queue.now
        obs = self.obs
        if obs is not None:
            obs.emit(req.t_finish, FINISH, inst=self.name, req=req.req_id,
                     tenant=req.tenant, payload={"tokens": req.generated})
        self.scheduler.complete(req)
        self.backend.release(req)
        self._unpin(req)
        if self.on_request_done is not None:
            self.on_request_done(req, self)

    def _on_preempt(self, req: SimRequest):
        req.cached_prefix = max(0, self.backend.on_preempt(req))
        obs = self.obs
        if obs is not None:
            obs.emit(self.queue.now, PREEMPT, inst=self.name,
                     req=req.req_id, tenant=req.tenant,
                     payload={"reason": "memory"})

    def _settle_cache(self):
        """Hand tier moves from the last cache mutation to the backend.

        Called immediately after every mutating cache call (match+promote
        in ``submit``, ``insert`` in ``_prefill_complete``,
        ``release_pressure`` in ``admit_decode``) so — even with a shared
        ``scope="global"`` cache — the pending list only ever holds moves
        *this* instance caused, and this instance's backend is the one
        that prices (sim) or performs (JaxBackend payload offload/restore)
        them.  Tier moves never create standalone events: their cost rides
        the instance's next iteration (``_pending_fetch_s`` /
        ``_carry_s``), which keeps the decode fast-forward sound — spills
        and promotes only happen at submit/prefill-complete/admit edges,
        all of which are barriers already.
        """
        if self.cache is None:
            return
        transfers = self.cache.take_transfers()
        fn = getattr(self.backend, "on_tier_transfer", None)
        if fn is not None:
            for src, dst, n_bytes, prefix in transfers:
                fn(src, dst, n_bytes, prefix)
        obs = self.obs
        if obs is not None and transfers:
            now = self.queue.now
            res = self.cache.residency()
            for src, dst, n_bytes, _prefix in transfers:
                obs.emit(now, KV_TIER, inst=self.name,
                         payload={"src": src, "dst": dst,
                                  "bytes": float(n_bytes),
                                  "residency": res})

    def _unpin(self, req: SimRequest):
        nodes = getattr(req, "_pinned_nodes", None)
        if nodes and self.cache is not None:
            self.cache.unpin(nodes)
            req._pinned_nodes = []   # type: ignore[attr-defined]

    # ---- decode-side admission for P/D ----
    def admit_decode(self, req: SimRequest,
                     handoff: Optional[KvHandoff] = None):
        """Request arrives with KV already transferred (P/D handoff)."""
        if not self.alive and self.on_dead_arrival is not None:
            # the instance was scaled in while this KV transfer was in
            # flight: the transferred KV is gone with the instance, so the
            # request restarts from prefill wherever the router sends it
            # (a *failed* instance keeps the classic park-until-revive
            # path below — on_dead_arrival is only set on removal)
            self.on_dead_arrival(req)
            return
        req.instance = self.name
        req.state = DECODING
        req.prefill_done_tokens = req.prompt_len - req.cached_prefix
        ok = self.scheduler.admit_remote(req)
        if not ok and self.cache is not None and self.cache.mem is self.mem:
            # memory pressure from prefix-cache borrows: evict and retry
            # (only when the cache borrows from THIS instance's pool — a
            # global-scope cache may be bound to a sibling's memory)
            self.cache.release_pressure(
                self.mem.blocks_for(req.context_len + 1), self.queue.now)
            self._settle_cache()
            ok = self.scheduler.admit_remote(req)
        if not ok and not self.scheduler.running:
            # idle instance: nothing will ever free memory, so a parked
            # request would be lost — admit with whatever blocks remain
            # (the ledger records the partial reservation exactly)
            ok = self.scheduler.admit_remote(req, force=True)
        if not ok:
            # slots/memory busy: safe to park — running work is in flight
            # and _finish_iteration drains the queue as capacity frees
            self._pending_decode.append((req, handoff))
            return
        self.backend.import_kv(req, handoff)
        obs = self.obs
        if obs is not None:
            obs.emit(self.queue.now, PD_ADMIT, inst=self.name,
                     req=req.req_id, tenant=req.tenant,
                     payload={"parked": False})
        self._kick()

    def _drain_pending_decode(self):
        while self._pending_decode:
            req, handoff = self._pending_decode[0]
            ok = self.scheduler.admit_remote(req)
            if not ok and not self.scheduler.running:
                ok = self.scheduler.admit_remote(req, force=True)
            if not ok:
                break
            self._pending_decode.popleft()
            self.backend.import_kv(req, handoff)
            obs = self.obs
            if obs is not None:
                obs.emit(self.queue.now, PD_ADMIT, inst=self.name,
                         req=req.req_id, tenant=req.tenant,
                         payload={"parked": True})

    # ---- failures / elasticity ----
    def fail(self) -> List[SimRequest]:
        """Node failure: drop in-flight state, return requests to re-route."""
        self.alive = False
        self.busy = False
        orphans = self.scheduler.requeue_all()
        for req, _ in self._pending_decode:
            # parked P/D arrivals lost their KV too: full restart elsewhere
            req.prefill_done_tokens = 0
            req.generated = 0
            req.n_restarts += 1
            orphans.append(req)
        self._pending_decode.clear()
        for req in orphans:
            # release radix pins so a (possibly shared) cache stays evictable
            self._unpin(req)
        self.backend.reset()
        return orphans

    def drain(self) -> List[SimRequest]:
        """Elastic scale-in: stop the instance and preempt-and-requeue all
        in-flight work.  Same bookkeeping as ``fail`` — running requests
        drop their KV and restart from prefill elsewhere (counted in
        ``n_restarts``), queued requests just move — but the removal is
        intentional: the cluster re-dispatches the orphans immediately and
        retires the instance instead of awaiting a revive."""
        return self.fail()

    def revive(self):
        self.alive = True
        self._kick()

    def load(self) -> float:
        """Router load signal: queue depth + memory pressure."""
        return (len(self.scheduler.waiting) + len(self.scheduler.running)
                + len(self._pending_decode) + 2.0 * self.mem.utilization())

    def throughput_estimate(self, phase: Optional[str] = None) -> float:
        """Tokens/s signal for hardware-aware routing: observed throughput
        once enough iterations ran, else the backend's static hint (the
        trace-priced reference batch for ``SimBackend``).

        ``phase`` ("prefill" | "decode") returns the phase-specific
        estimate — observed from pure-phase iterations when available,
        else the backend's per-phase hint — so P/D role-aware placement
        stops rating a prefill-only instance by a blended batch it never
        runs.  ``None`` keeps the blended estimate for unified instances.
        """
        if phase in self.phase_iters:    # unknown phase -> blended
            if self.phase_iters[phase] >= 8 and self.phase_time[phase] > 0:
                return self.phase_tokens[phase] / self.phase_time[phase]
            hint = getattr(self.backend, "throughput_hint", None)
            if hint is not None:
                return hint(phase)
        if self.iterations >= 8 and self.busy_time > 0:
            return self.total_tokens / self.busy_time
        hint = getattr(self.backend, "throughput_hint", None)
        return hint() if hint is not None else 1.0

    def stats(self) -> dict:
        s = {"iterations": self.iterations, "tokens": self.total_tokens,
             "busy_s": self.busy_time, "backend": self.backend.name,
             "hw": self.cfg.hw_name or self.cfg.hw.name,
             "preemptions": self.scheduler.n_preemptions,
             "mem_peak_blocks": self.mem.peak_used,
             # per-tenant service split (scheduled tokens) — the signal
             # the weighted-share guard balances
             "tenant_service": dict(self.scheduler.served_tokens),
             # scheduler ledger exposure: per-request blocks held right now
             # plus the sampled pool watermark timeline (vLLM-style plots)
             "kv_occupancy": self.scheduler.occupancy(),
             "kv_watermark": list(self.kv_watermark),
             # samples evicted by the bounded window — nonzero means the
             # timeline above is truncated (raise watermark_window)
             "kv_watermark_dropped": self._wm_appended
             - len(self.kv_watermark)}
        if self.cache is not None:
            s["prefix_cache"] = self.cache.stats()
            kv = {"cache": self.cache.name,
                  "residency_blocks": self.cache.residency(),
                  "hit_tokens": dict(self.cache.tier_hit_tokens),
                  "transfers": {k: dict(v) for k, v in
                                self.cache.tier_transfers.items()}}
            extra = getattr(self.backend, "kv_tier_stats", None)
            if extra is not None:
                kv.update(extra())
            s["kv_tiers"] = kv
        s.update(self.backend.stats())
        return s
