"""Iteration-level batch scheduler (vLLM-style continuous batching).

Backend-agnostic: each call to ``next_batch`` composes one engine iteration
from the running set + waiting queue under token/size budgets, with optional
chunked prefill (Sarathi-style) and preemption on memory pressure.  The same
instance drives both the discrete-event simulator and the real JAX engine —
backends only differ in how the returned ``ScheduledWork`` list is executed.

Preemption policy: memory pressure from decode growth recycles the longest-
context running request (its KV is freed; it restarts from the prefix cache
/ full prefill).  Requests whose work is already composed into the current
batch are never evicted mid-composition, and new admissions defer to
in-flight work rather than evicting it — mutual eviction livelocks.

KV block accounting is exact: every admission records its reservation in a
per-request ledger, decode extensions grow the reservation as the context
grows, and completion/preemption/requeue free exactly what was reserved —
never ``context + output//4`` recomputed after the fact (which silently
over-freed the pool as decode advanced).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.config import SchedulerCfg
from repro_torch.core.memory import MemoryModel
from repro_torch.core.perfmodel import BatchItem
from repro_torch.core.request import (DECODING, PREFILLING, QUEUED, SimRequest)


@dataclasses.dataclass
class ScheduledWork:
    request: SimRequest
    tokens: int
    phase: str


#: scheduling policies the wait queue understands; anything else is a
#: config error and is rejected loudly at scheduler construction time
#: (``policy="priority"`` silently degrading to arrival order was a bug).
POLICIES = ("fcfs", "sjf", "priority")

#: ``push_front`` key — sorts before any normal entry under every policy
#: (priority keys are ``-req.priority``, so plain ``-1`` would let a
#: priority>=1 request overtake a preempted one).
_FRONT_KEY = -(1 << 62)


class WaitQueue:
    """Policy-ordered wait queue.

    A single heap replaces the old re-sort-the-whole-deque-per-enqueue SJF
    path: O(log n) per push instead of O(n log n).  ``push_front`` (preempted
    requests go back to the head) sorts before every normal entry, LIFO among
    themselves, matching the old ``appendleft`` semantics.
    """

    def __init__(self, policy: str = "fcfs"):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown scheduler policy {policy!r}; valid policies: "
                f"{', '.join(POLICIES)}")
        self.policy = policy
        self._heap: List[tuple] = []
        self._seq = itertools.count()

    def _key(self, req: SimRequest) -> int:
        if self.policy == "sjf":
            return req.remaining_prefill        # shortest prompt first
        if self.policy == "priority":
            return -req.priority                # tenant priority, then arrival
        return 0                                # fcfs: arrival order

    def push(self, req: SimRequest):
        heapq.heappush(self._heap, (self._key(req), next(self._seq), req))

    def push_front(self, req: SimRequest):
        heapq.heappush(self._heap, (_FRONT_KEY, -next(self._seq), req))

    def peek(self) -> SimRequest:
        return self._heap[0][2]

    def pop(self) -> SimRequest:
        return heapq.heappop(self._heap)[2]

    def remove(self, req: SimRequest):
        """Remove a specific queued request (the share guard admits from
        the middle of the heap).  ``remove(peek())`` == ``pop()``."""
        for i, entry in enumerate(self._heap):
            if entry[2] is req:
                last = self._heap.pop()
                if i < len(self._heap):
                    self._heap[i] = last
                    heapq.heapify(self._heap)
                return
        raise ValueError(f"request {req.req_id} not in wait queue")

    def entries(self) -> List[tuple]:
        """Raw ``(key, seq, request)`` heap entries (policy order is NOT
        the list order; compare the key tuples)."""
        return self._heap

    def clear(self):
        self._heap.clear()

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def __iter__(self) -> Iterator[SimRequest]:
        return (entry[2] for entry in self._heap)


class BatchScheduler:
    """The unified iteration scheduler (one per instance, both backends).

    ``next_batch()`` composes one engine iteration: decode steps for the
    running set first, then continuation chunks for in-flight prefills,
    then new admissions — under ``max_batch_tokens``/``max_batch_size``
    budgets with exact KV-block reservations.  The returned
    ``ScheduledWork`` list is what an ``ExecutionBackend`` prices (sim) or
    really executes (JAX engine); ``complete``/``requeue_all`` close the
    ledger.  See the module docstring for preemption and accounting
    invariants.
    """

    def __init__(self, cfg: SchedulerCfg, mem: MemoryModel):
        self.cfg = cfg
        self.mem = mem
        self.waiting = WaitQueue(cfg.policy)
        self.running: List[SimRequest] = []
        self.n_preemptions = 0
        # exact KV accounting: req_id -> blocks currently reserved
        self._reserved: Dict[int, int] = {}
        # per-tenant service: tokens scheduled so far (prefill + decode),
        # the signal the weighted-share starvation guard compares and the
        # per-tenant service split instance stats expose.  Decode
        # fast-forward replays the stepped increments via
        # ``account_window`` so both modes read identical counters.
        self.served_tokens: Dict[str, int] = {}
        # wired by the instance: free backend-side state on preemption
        self.on_preempt: Optional[Callable[[SimRequest], None]] = None
        # wired by the instance only when event tracing is enabled:
        # fires once per waiting->running admission (P/D remote admits
        # are reported separately as pd_admit events)
        self.on_admit: Optional[Callable[[SimRequest], None]] = None

    def enqueue(self, req: SimRequest):
        self.waiting.push(req)

    # ---- per-tenant service accounting ----
    def _account(self, work: List[ScheduledWork]):
        for w in work:
            t = w.request.tenant
            self.served_tokens[t] = self.served_tokens.get(t, 0) + w.tokens

    def account_window(self, work: List[ScheduledWork], extra_steps: int):
        """Decode fast-forward replay: a window of ``n`` identical decode
        steps was composed once but stands for ``n`` stepped ``next_batch``
        calls; add the ``n - 1`` uncomposed steps' service so the counters
        match the stepped path exactly (integer adds — bit-identical)."""
        for w in work:
            t = w.request.tenant
            self.served_tokens[t] = (self.served_tokens.get(t, 0)
                                     + w.tokens * extra_steps)

    def _pick_admission(self) -> SimRequest:
        """Next admission candidate (left in the queue until the KV
        reservation succeeds).  Normally the policy head; under
        ``policy="priority"`` with ``share_guard_tokens > 0`` a starved
        tenant — one whose weight-normalized service lags the head
        tenant's by at least the guard — is admitted first (earliest of
        its queued requests), bounding priority starvation."""
        head = self.waiting.peek()
        guard = self.cfg.share_guard_tokens
        if guard <= 0 or self.cfg.policy != "priority":
            return head
        best: Dict[str, tuple] = {}     # tenant -> best (key, seq, req)
        for entry in self.waiting.entries():
            t = entry[2].tenant
            if t not in best or entry[:2] < best[t][:2]:
                best[t] = entry
        if len(best) < 2:
            return head

        def normalized(t: str) -> float:
            return self.served_tokens.get(t, 0) / max(best[t][2].weight,
                                                      1e-9)

        starved = min(best, key=lambda t: (normalized(t), t))
        if starved != head.tenant and \
                normalized(starved) + guard <= normalized(head.tenant):
            return best[starved][2]
        return head

    # ---- KV block ledger ----
    def _reserve_tokens(self, req: SimRequest, tokens: int) -> bool:
        """Grow ``req``'s reservation to cover ``tokens``; True on success."""
        need = self.mem.blocks_for(tokens)
        have = self._reserved.get(req.req_id, 0)
        if need <= have:
            return True
        if not self.mem.allocate_blocks(need - have):
            return False
        self._reserved[req.req_id] = need
        req.kv_blocks_peak = max(req.kv_blocks_peak, need)
        return True

    def _release(self, req: SimRequest):
        blocks = self._reserved.pop(req.req_id, 0)
        if blocks:
            self.mem.release_blocks(blocks)

    def reserved_blocks(self, req: SimRequest) -> int:
        return self._reserved.get(req.req_id, 0)

    def occupancy(self) -> Dict[int, int]:
        """Ledger snapshot: req_id -> KV blocks currently reserved (the
        per-request occupancy ``Metrics`` exposes for watermark plots)."""
        return dict(self._reserved)

    def _try_admit(self, req: SimRequest) -> bool:
        """Reserve KV blocks for prompt + a slice of the expected output."""
        need = req.remaining_prefill + req.cached_prefix + req.output_len // 4
        return self._reserve_tokens(req, need)

    def _tokens_held(self, req: SimRequest) -> int:
        """Tokens whose KV this request holds right now."""
        return req.cached_prefix + req.prefill_done_tokens + req.generated

    def _preempt_one(self, protected=()) -> Optional[SimRequest]:
        """Evict the longest-context running request not in ``protected``
        (requests already scheduled in the batch being composed must never
        be preempted: their work items are about to execute)."""
        pool = [r for r in self.running if r not in protected]
        if not pool:
            return None
        victim = max(pool, key=lambda r: r.context_len)
        self._preempt(victim)
        return victim

    def _preempt(self, victim: SimRequest):
        self.running.remove(victim)
        self._release(victim)
        victim.state = QUEUED
        victim.n_preemptions += 1
        victim.prefill_done_tokens = 0
        victim.generated = 0        # conservatively restart decoding state
        if self.on_preempt is not None:
            self.on_preempt(victim)
        self.waiting.push_front(victim)
        self.n_preemptions += 1

    def _ensure_decode_capacity(self, req: SimRequest, protected) -> bool:
        """Grow the reservation for the next decode step; preempt (others
        first, then ``req`` itself) under memory pressure.  A step writes
        up to ``decode_tokens`` KV entries (1 classically; the k-draft +
        bonus verification window under speculative decoding), so the
        ledger reserves the full window even though acceptance may emit
        fewer — the backend really writes that many rows before rollback."""
        need = self._tokens_held(req) + max(self.cfg.decode_tokens, 1)
        while not self._reserve_tokens(req, need):
            if self._preempt_one(protected=protected) is None:
                self._preempt(req)
                return False
        return True

    def next_batch(self) -> List[ScheduledWork]:
        cfg = self.cfg
        if cfg.prefill_exclusive:
            return self._next_batch_exclusive()
        work: List[ScheduledWork] = []
        scheduled: List[SimRequest] = []   # never preempt these: their work
        tokens_left = cfg.max_batch_tokens  # items execute this iteration
        dt = max(cfg.decode_tokens, 1)     # decode step width (spec: k + 1)

        # 1. decode steps for all running decode-phase requests
        for req in list(self.running):
            if req.state == DECODING and tokens_left > 0:
                if not self._ensure_decode_capacity(
                        req, protected=scheduled + [req]):
                    continue
                work.append(ScheduledWork(req, dt, "decode"))
                scheduled.append(req)
                tokens_left -= dt

        # 2. continue chunked prefills already running
        for req in list(self.running):
            if req.state == PREFILLING and tokens_left > 0:
                chunk = min(req.remaining_prefill,
                            cfg.prefill_chunk if cfg.chunked_prefill
                            else req.remaining_prefill,
                            tokens_left)
                if chunk > 0:
                    work.append(ScheduledWork(req, chunk, "prefill"))
                    scheduled.append(req)
                    tokens_left -= chunk

        # 3. admit new requests while budget remains
        while self.waiting and tokens_left > 0 and \
                len(self.running) < cfg.max_batch_size:
            req = self._pick_admission()
            if not self._try_admit(req):
                # memory pressure: admission defers to in-flight work (a
                # request already composed into this batch is never evicted
                # for a newcomer — mutual eviction livelocks); preemption
                # recycles memory for decode growth instead, so newcomers
                # wait for completions to free blocks
                if not self.running or \
                        self._preempt_one(protected=scheduled) is None:
                    break
                if not self._try_admit(req):
                    break
            self.waiting.remove(req)
            req.state = PREFILLING
            self.running.append(req)
            if self.on_admit is not None:
                self.on_admit(req)
            chunk = min(req.remaining_prefill,
                        cfg.prefill_chunk if cfg.chunked_prefill
                        else req.remaining_prefill,
                        tokens_left)
            chunk = max(chunk, 0)
            if chunk > 0:
                work.append(ScheduledWork(req, chunk, "prefill"))
                scheduled.append(req)
                tokens_left -= chunk
            elif req.remaining_prefill == 0:
                # fully prefix-cached prompt: go straight to decode
                req.state = DECODING
                work.append(ScheduledWork(req, dt, "decode"))
                scheduled.append(req)
                tokens_left -= dt
        self._account(work)
        return work

    def _next_batch_exclusive(self) -> List[ScheduledWork]:
        """ServingEngine semantics: one whole-prompt prefill OR all decodes."""
        cfg = self.cfg
        if self.waiting and len(self.running) < cfg.max_batch_size:
            req = self._pick_admission()
            if self._try_admit(req):
                self.waiting.remove(req)
                req.state = PREFILLING
                self.running.append(req)
                if self.on_admit is not None:
                    self.on_admit(req)
                n = req.remaining_prefill
                if n > 0:
                    work = [ScheduledWork(req, n, "prefill")]
                    self._account(work)
                    return work
                req.state = DECODING
        work = []
        dt = max(cfg.decode_tokens, 1)
        for req in list(self.running):
            if req.state == DECODING and self._ensure_decode_capacity(
                    req, protected=[w.request for w in work] + [req]):
                work.append(ScheduledWork(req, dt, "decode"))
        self._account(work)
        return work

    # ---- decode fast-forward (see RuntimeInstance._maybe_fast_forward) ----
    def decode_window_steps(self, reqs: List[SimRequest], n_max: int) -> int:
        """Largest ``n <= n_max`` successive decode steps the pool can grow
        into without any reservation failing (so no preemption the slow
        path wouldn't have done either).  Step ``i``'s reservation target
        is ``tokens_held + (i - 1) + decode_tokens`` — exactly what
        ``_ensure_decode_capacity`` would ask for at that step, since every
        step emits one token.  Block demand is monotone in ``n``, so a
        binary search finds the frontier."""
        dt = max(self.cfg.decode_tokens, 1)
        bt = self.mem.block_tokens
        base = [self._tokens_held(r) + dt for r in reqs]
        have = [self._reserved.get(r.req_id, 0) for r in reqs]
        free = self.mem.free_blocks

        def new_blocks(n: int) -> int:
            s = 0
            for b, h in zip(base, have):
                nb = -(-(b + n - 1) // bt) - h
                if nb > 0:
                    s += nb
            return s

        if new_blocks(n_max) <= free:
            return n_max
        lo, hi = 1, n_max
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if new_blocks(mid) <= free:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def decode_window_usage(self, reqs: List[SimRequest],
                            n: int) -> np.ndarray:
        """Pool-usage deltas the window's per-step reservations add:
        element ``i`` (0-based) is blocks-in-use growth after step
        ``i + 1``'s start-of-iteration reservations — what the slow path's
        watermark would have sampled.  Element 0 is always 0 (step 1's
        reservation was made when the batch was composed)."""
        dt = max(self.cfg.decode_tokens, 1)
        bt = self.mem.block_tokens
        base = np.array([self._tokens_held(r) + dt for r in reqs],
                        dtype=np.int64)
        have = np.array([self._reserved.get(r.req_id, 0) for r in reqs],
                        dtype=np.int64)
        steps = np.arange(n, dtype=np.int64)
        need = -(-(base[:, None] + steps[None, :]) // bt)
        return np.maximum(need - have[:, None], 0).sum(axis=0)

    def advance_decode(self, reqs: List[SimRequest], n: int):
        """Apply ``n`` decode steps' ledger growth in one lump.  Growth is
        monotone, so the lump reservation yields the same final ledger,
        pool peak and per-request ``kv_blocks_peak`` as stepping would
        have; feasibility was pre-checked by ``decode_window_steps``."""
        dt = max(self.cfg.decode_tokens, 1)
        for r in reqs:
            if not self._reserve_tokens(r, self._tokens_held(r)
                                        + n - 1 + dt):
                raise RuntimeError(
                    f"fast-forward reservation failed for req "
                    f"{r.req_id} — decode_window_steps over-estimated")

    def admit_remote(self, req: SimRequest, force: bool = False) -> bool:
        """P/D decode-side admission: KV already transferred; reserve blocks
        and join the running set (False when slots/memory are exhausted).
        ``force`` admits on an otherwise-idle scheduler with whatever blocks
        are left (slot capacity is still respected — it is physical)."""
        if len(self.running) >= self.cfg.max_batch_size:
            return False
        tokens = self._tokens_held(req) + req.output_len // 4
        if not self._reserve_tokens(req, tokens):
            if not force:
                return False
            got = min(self.mem.blocks_for(tokens), self.mem.free_blocks)
            if got > 0:
                self.mem.allocate_blocks(got)
            held = self._reserved.get(req.req_id, 0) + got
            self._reserved[req.req_id] = held
            req.kv_blocks_peak = max(req.kv_blocks_peak, held)
        self.running.append(req)
        return True

    def complete(self, req: SimRequest):
        if req in self.running:
            self.running.remove(req)
        self._release(req)

    def requeue_all(self) -> List[SimRequest]:
        """Node failure: return every in-flight request for re-dispatch."""
        out = list(self.running) + list(self.waiting)
        for r in self.running:
            self._release(r)
            r.state = QUEUED
            r.prefill_done_tokens = 0
            r.generated = 0
            r.n_restarts += 1
        self.running.clear()
        self.waiting.clear()
        self._reserved.clear()
        return out

    def to_batch_items(self, work: List[ScheduledWork]) -> List[BatchItem]:
        return to_batch_items(work)


def to_batch_items(work: List[ScheduledWork]) -> List[BatchItem]:
    """PerfModel view of scheduled work (shared by scheduler + SimBackend).
    A decode step's context covers its full verification window
    (``context_len + tokens``; tokens is 1 classically, draft k + 1 under
    speculative decoding)."""
    return [BatchItem(tokens=w.tokens,
                      context=w.request.context_len + w.tokens,
                      phase=w.phase,
                      start=(w.request.cached_prefix
                             + w.request.prefill_done_tokens)
                      if w.phase == "prefill" else 0,
                      completes=(w.phase != "prefill"
                                 or w.tokens >= w.request.remaining_prefill))
            for w in work]
