"""Real-execution backend: prefill/extend/decode over paged slot KV.

The port of ``repro/runtime/backends/jax_engine.py`` (``JaxBackend``).  It
wraps a ``repro_torch.serve.engine.ServingEngine`` as a KV mechanism; every
serving decision (admission, chunking, decode composition, preemption)
comes from the unified runtime.

Hybrid emulation as in the JAX backend: compute is real and wall-clock
timed, ending in ``torch.cuda.synchronize`` on the card (where JAX calls
``block_until_ready``) so the time covers the device's work; time is
virtual, advanced by the measured latencies on the runtime's event queue.

Chunked prefill: the first chunk runs the bucketed ``prefill``; later
chunks ``extend`` a one-row view of the slot.  One full-buffer ``decode``
serves all scheduled decode slots per iteration.  For a model with
recurrent stages every unscheduled row of that decode carries the
sentinel token -1, so the state of a slot that is mid-prefill, or whose
first token is pending, does not move (the JAX backend advances it).

Trace-driven MoE routing as in the JAX backend: an engine built with
``ServingEngine(routing=<trace>)`` replays the trace in every MoE layer,
and this backend mirrors it in an ``ExpertLoadTracker`` over the KV
positions it executed, so ``stats()["expert_load"]`` states what really
routed.  Under any routing hook the full-buffer decode marks unscheduled
slots with the token -1 and free slots keep length 0, so neither is
recorded nor takes a real token's expert capacity.

P/D disaggregation as in the JAX backend: ``export_kv`` copies a prefill
slot's KV out (``ServingEngine._export_slot``, to host memory), frees the
slot and charges its wall time to the next iteration through ``_carry_s``;
``import_kv`` restores the payload into a free decode slot with the first
token the prefill emitted pending (``_restore_slot``, which takes the
engine's own KV heads out of a payload of every head).

The prefix store as in the JAX backend: a runtime prefix hit matches the
engine's ``RealRadixCache`` (``on_prefix_hit``), and the request's first
chunk restores the matched payload into its slot (``_restore_slot``; an SSD
stub is read back there, inside the timed region) and extends from the
restored length; ``on_prefill_complete`` inserts the prompt's KV on the
device tier and ``on_tier_transfer`` carries out the runtime's tier moves,
both wall-timed into ``_carry_s``.

Speculative decoding as in the JAX backend (``_spec_decode_step``): the
draft engine proposes k tokens per slot, the target verifies them in one
batched ``Model.verify`` (the paged extend kernel at S = k + 1 on the
card), each slot keeps its accepted prefix and the target's bonus token,
and both KV lengths roll back.  Acceptance is the greedy match, or replayed
from the engine's ``AcceptanceTrace``; ``stats()["spec_decode"]`` accounts
it.

Tensor parallelism: every rank of an engine group runs the same driver and
its own copy of the runtime, and the runtime's decisions depend on the
iteration latencies it is handed (the hybrid emulation).  Each rank
measures its own wall time, so ``execute`` hands the runtime the group's
largest (``ServingEngine.slowest``, an all-reduce MAX, the carried wall
time included): a TP iteration ends when its slowest rank ends, and
identical latencies keep the ranks' schedules, allocators and collectives
in step.  Every rank samples from the same all-gathered logits.  Under
P/D between engines of the same tp a rank exports and imports its own KV
heads.  Between engines of different tp (``pd_tp``: each P/D target's tp,
from the driver; the runtime names the target in ``req.decode_instance``
before it calls ``export_kv``) the export holds every head: a prefill
group all-gathers them, and a tp = 1 engine on every rank, replicated,
holds them all.  The handoff carries the tp = 1 payload's bytes
(``ServingEngine.handoff_nbytes``), so the network delay, and with it the
decode admission, is the same on every rank.  A replicated tp = 1 engine
hands the runtime the slowest rank's latency too, through its replica
handle.  The prefix store's counts (restored tokens, store residency)
count tokens and entries, the same on every rank; a tier move's time is
the slowest rank's.  A speculative step checks that the ranks accepted
alike (one all-gather of the accepted lengths) and raises if they did
not.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.config import InstanceCfg
from repro_torch.core.memory import MemoryModel
from repro_torch.core.request import SimRequest
from repro_torch.moe import ExpertLoadTracker, resolve_routing
from repro_torch.obs.events import SPEC_STEP
from repro_torch.obs.spans import span
from repro_torch.runtime.backend import KvHandoff
from repro_torch.runtime.prefix_cache import MatchResult
from repro_torch.runtime.scheduler import ScheduledWork


class TorchBackend:
    name = "torch"

    def __init__(self, engine, cfg: InstanceCfg,
                 pd_tp: Optional[Dict[str, int]] = None):
        self.eng = engine
        self.cfg = cfg
        self._pd_tp = dict(pd_tp or {})      # P/D target -> its tp
        self.memory = MemoryModel(cfg)
        self._slot: Dict[int, int] = {}      # req_id -> engine slot
        self._len: Dict[int, int] = {}       # slot   -> tokens held in KV
        self._restore: Dict[int, tuple] = {} # req_id -> (payload, length)
        self._iterations = 0
        # real work done outside execute() (prefix store, P/D export) is
        # wall-timed and charged to the next iteration
        self._carry_s = 0.0
        # event recorder, wired by RuntimeInstance.attach_obs; restore
        # cost is folded into the wall-timed iteration, so kv_restore
        # reports 0 seconds
        self.obs = None
        self.last_restore_s = 0.0
        # KV-tier accounting: restores counted at match time (as the
        # simulator does), tier moves measured as they run on the store
        self._restored_tokens = 0
        self._restore_events = 0
        self._tier_moves = 0
        self._tier_move_s = 0.0
        # output-token capture: req_id -> emitted token ids, in order
        self.out_tokens: Dict[int, List[int]] = {}
        # speculative decoding: the engine carries the mechanism (draft
        # engine, ServingEngine(spec=...)); this backend runs propose /
        # verify / rollback and accounts spec_decode.  A cfg that names
        # spec decoding the engine does not run, or another acceptance
        # trace than the engine replays, is an error
        self.spec = engine.spec
        self.spec_tracker = None
        if (cfg.spec.enabled or cfg.spec.acceptance_trace) \
                and self.spec is None:
            raise ValueError(
                f"instance {cfg.name!r} configures speculative decoding "
                f"but its engine has no draft; build it with "
                f"ServingEngine(spec=SpecDecodeCfg(...)) so the "
                f"scheduler's multi-token accounting matches what "
                f"actually executes")
        if self.spec is not None:
            from repro_torch.spec import SpecDecodeTracker, resolve_acceptance
            if cfg.spec.acceptance_trace:
                named = resolve_acceptance(cfg)
                if self.spec.acceptance is None:
                    raise ValueError(
                        f"instance {cfg.name!r} names acceptance_trace="
                        f"{cfg.spec.acceptance_trace!r} but its engine "
                        f"replays no trace; build it with ServingEngine("
                        f"spec=SpecDecodeCfg(acceptance=<trace>)) so the "
                        f"reported spec_decode is what actually ran")
                if named is not self.spec.acceptance \
                        and named.to_json() != self.spec.acceptance.to_json():
                    raise ValueError(
                        f"instance {cfg.name!r} names acceptance_trace="
                        f"{cfg.spec.acceptance_trace!r} but its engine "
                        f"replays a different trace; the accounting "
                        f"table must be the one the engine draws from")
            dt = cfg.scheduler.decode_tokens
            if dt != self.spec.k + 1:
                raise ValueError(
                    f"instance {cfg.name!r} speculates k={self.spec.k} "
                    f"but its scheduler reserves decode_tokens={dt}; set "
                    f"SchedulerCfg(decode_tokens=k + 1) (engine_instance_"
                    f"cfg does this automatically) so the KV ledger "
                    f"covers the verification window")
            self.spec_tracker = SpecDecodeTracker(self.spec.k)
        # spec bookkeeping by engine slot, kept apart from the scheduler's
        # (the sim/real parity tests hold the two to each other): token
        # history in the target KV, draft KV length, emitted-token count
        self._hist: Dict[int, List[int]] = {}
        self._draft_len: Dict[int, int] = {}
        self._emit: Dict[int, int] = {}
        self._steps: Dict[int, int] = {}     # slot -> spec-step ordinal
        self._emitted: Dict[int, int] = {}   # req_id -> last step's tokens
        # expert-load mirror of a replayed trace: the engine's own trace is
        # the only valid source; a cfg-named trace the engine does not
        # replay would report routing that never ran, so it is an error
        self.routing = engine.routing_trace
        if cfg.moe.routing_trace:
            if self.routing is None:
                raise ValueError(
                    f"instance {cfg.name!r} names routing_trace="
                    f"{cfg.moe.routing_trace!r} but its engine replays no "
                    f"trace; build it with ServingEngine(routing=<trace>) "
                    f"so the reported expert_load is what actually routed")
            named = resolve_routing(cfg)
            if named is not self.routing \
                    and named.to_json() != self.routing.to_json():
                raise ValueError(
                    f"instance {cfg.name!r} names routing_trace="
                    f"{cfg.moe.routing_trace!r} but its engine replays a "
                    f"different trace ({self.routing.model!r}); the "
                    f"accounting table must be the one the model executes")
        self.expert_load = ExpertLoadTracker(
            self.routing, ep=cfg.parallelism.ep,
            capacity_factor=engine.cfg.moe.capacity_factor) \
            if self.routing is not None else None
        self._routed_pos: List[int] = []     # positions routed this iter

    # ---- helpers ----
    def prompt_cap(self, req: SimRequest) -> int:
        """Slot capacity: prompt + generated output + 1 must fit max_len.
        The runtime truncates the request on submit, so the scheduler's
        chunk plan and the backend's KV state always agree.  Speculative
        decoding writes up to k draft rows past the accepted context before
        the rollback, so the window shrinks by k."""
        extra = self.eng.spec.k if self.eng.spec is not None else 0
        return max(self.eng.max_len - req.output_len - 1 - extra, 1)

    def _prompt(self, req: SimRequest) -> List[int]:
        toks = list(req.prompt_tokens)
        cap = self.prompt_cap(req)
        return toks[:cap] if len(toks) > cap else toks

    def warmup(self):
        # serve/ imports this module back (driver): import it late
        from repro_torch.serve.engine import _bucket
        eng = self.eng
        eng.warmup()
        sched = self.cfg.scheduler
        if sched.chunked_prefill or eng.radix is not None:
            # chunk 2+ of a chunked prefill (and any prefix-hit suffix)
            # runs ``extend``: run it once at every padded chunk bucket so
            # the measured run starts warm
            top = _bucket(min(max(sched.prefill_chunk, 16),
                              eng.max_len - 1)) \
                if sched.chunked_prefill else eng.max_len - 1
            P = 16
            while P <= top and P < eng.max_len:
                pad = eng.tensor(np.zeros((1, P), np.int32))
                try:
                    _, sub = eng.model.extend(eng.params,
                                              eng._slot_subcache(0, 16),
                                              pad, eng.tensor([P]))
                except NotImplementedError:
                    break   # no cached-prefill path (xLSTM), as in JAX
                eng._write_slot(0, sub, 16)
                P *= 2
            eng._release_slot(0)
        if eng.radix is not None:
            # the slot export / restore at every bucket a hit can restore
            for blen in (16, 32, 64, 128, 256):
                if blen >= eng.max_len:
                    break
                payload = eng._export_slot(0, blen)
                eng._restore_slot(0, payload, blen)
            eng._release_slot(0)
        if eng.spec is not None:
            # draft prefill / decode buckets and one verify of every slot
            # (its writes land on the free slots' scratch pages)
            eng.draft.warmup()
            vt = eng.tensor(np.zeros((eng.max_batch, eng.spec.k + 1),
                                     np.int32))
            eng.model.verify(eng.params, eng.cache, vt,
                             eng.tensor(np.zeros((eng.max_batch,),
                                                 np.int32)))
        eng.synchronize()

    # ---- execution ----
    def execute(self, work: List[ScheduledWork], now: float) -> float:
        t0 = time.perf_counter()
        self.eng.waits.reset()
        decodes = [w for w in work if w.phase == "decode"]
        prefills = [w for w in work if w.phase == "prefill"]
        if decodes:
            if self.eng.spec is not None:
                self._spec_decode_step(decodes, now)
            else:
                with span("backend.decode_step"):
                    self._decode_step(decodes)
        for w in prefills:
            with span("backend.prefill_chunk"):
                self._prefill_chunk(w)
        with span("backend.sync"):
            self.eng.synchronize()
        self._iterations += 1
        latency = self.eng.slowest(time.perf_counter() - t0 + self._carry_s)
        self._carry_s = 0.0
        if self.expert_load is not None:
            self.expert_load.observe(self._routed_pos, now)
            self._routed_pos = []
        return latency

    def iteration_waits(self) -> dict:
        """The last ``execute``'s blocking host-device waits by kind."""
        return self.eng.waits.as_dict()

    def _decode_step(self, decodes: List[ScheduledWork]):
        from repro_torch.serve.sampler import greedy
        eng = self.eng
        with span("stage"):
            tokens = eng._tokens_buf
            for w in decodes:
                # the decode writes each scheduled slot's new token at its
                # old length: make sure that page exists
                slot = self._slot[w.request.req_id]
                eng.ensure_capacity(slot, self._len[slot] + 1)
            hooked = eng.model.routing_hook is not None
            # a recurrent model's decode moves the state of every row it
            # runs on a real token, so its unscheduled rows take the
            # sentinel too
            masked = hooked or eng.model.recurrent
            if masked:
                # mark every slot that is not scheduled (free, or
                # mid-prefill) with the sentinel -1: its row still
                # computes, but is neither recorded nor given expert
                # capacity, and keeps its recurrent state.  The engine's
                # buffer keeps the mid-prefill slots' pending first tokens.
                tokens = tokens.copy()
                scheduled_slots = {self._slot[w.request.req_id]
                                   for w in decodes}
                for slot in range(eng.max_batch):
                    if slot not in scheduled_slots:
                        tokens[slot, 0] = -1
            tokens = eng.tensor(tokens)
        logits, eng.cache = eng.model.decode(eng.params, eng.cache, tokens)
        with span("sample"):
            nxt = eng.to_host(greedy(logits, eng.cfg.vocab)).numpy()
        with span("bookkeep"):
            scheduled = set()
            for w in decodes:
                slot = self._slot[w.request.req_id]
                eng._tokens_buf[slot, 0] = int(nxt[slot, 0])
                self.out_tokens.setdefault(w.request.req_id, []).append(
                    int(nxt[slot, 0]))
                if self.expert_load is not None:
                    # the decode wrote this slot's token at KV index _len
                    self._routed_pos.append(self._len[slot])
                self._len[slot] += 1
                scheduled.add(slot)
            if scheduled != set(self._len) \
                    or (masked and len(self._len) < eng.max_batch):
                # the full-buffer decode bumped every slot's length;
                # restore the lengths of mid-prefill / unscheduled slots.
                # Under a routing hook (and for a recurrent model) also
                # zero the free slots every step: the hook's decode mask
                # knows an empty slot by its position 0, and bumps left to
                # pile up over decode-only steps would mark phantom rows
                # valid
                lengths = np.zeros((eng.max_batch,), np.int32)
                for s, n in self._len.items():
                    lengths[s] = n
                eng.cache["lengths"] = eng.tensor(lengths)

    def _spec_decode_step(self, decodes: List[ScheduledWork], now: float):
        """One speculative iteration for the scheduled decode set: the
        draft proposes k tokens per slot (k + 1 full-buffer draft decodes:
        the last consumes the last proposal, so the draft KV stays one
        pending token behind, like the target's), the target verifies all
        proposals in one batched ``verify``, and each slot keeps the
        accepted prefix and the target's bonus token, rolling both KV
        lengths back to the accepted context.  Acceptance is the greedy
        match unless the engine replays an ``AcceptanceTrace``: then the
        decision is the trace's draw at the slot's emitted position."""
        from repro_torch.serve.engine import _bucket
        from repro_torch.serve.sampler import accept_length, greedy
        eng = self.eng
        dr = eng.draft
        k = eng.spec.k
        trace = eng.spec.acceptance
        recorder = eng.spec.recorder

        # 1. draft context sync: rebuild a slot's draft KV from its token
        # history whenever the two diverged (first spec step, preemption
        # restart, P/D arrival): one bucketed draft prefill per slot
        for w in decodes:
            slot = self._slot[w.request.req_id]
            hist = self._hist[slot]
            if self._draft_len.get(slot) != len(hist):
                P = _bucket(max(len(hist), 1))
                pad = np.zeros((1, P), np.int32)
                pad[0, :len(hist)] = np.asarray(hist, np.int32)
                _, c1 = dr.model.prefill(dr.params, dr.tensor(pad),
                                         lengths=dr.tensor([len(hist)]))
                dr._write_slot_from_prefill(slot, c1, len(hist))
                self._draft_len[slot] = len(hist)

        # tail clamp: a request with r output tokens left emits at most r
        # a step (accepted + bonus), so it proposes min(k, r - 1) drafts;
        # the simulator prices the same step the same way
        k_eff = {}
        for w in decodes:
            req = w.request
            k_eff[self._slot[req.req_id]] = max(
                0, min(k, req.output_len - req.generated - 1))
        k_step = max(k_eff.values(), default=0)

        # verify writes the pending token and k_eff drafts at [len, len +
        # k_eff]; the draft's k_step + 1 decodes walk one position a call
        for w in decodes:
            slot = self._slot[w.request.req_id]
            eng.ensure_capacity(slot, self._len[slot] + k_eff[slot] + 1)
            dr.ensure_capacity(slot,
                               self._draft_len.get(slot, 0) + k_step + 1)

        # 2. propose: k_step + 1 full-buffer draft decodes
        cur = np.maximum(eng._tokens_buf, 0)
        drafts = np.zeros((eng.max_batch, k_step), np.int32)
        for j in range(k_step + 1):
            dlogits, dr.cache = dr.model.decode(dr.params, dr.cache,
                                                dr.tensor(cur))
            cur = dr.to_host(greedy(dlogits, eng.cfg.vocab)).numpy()
            if j < k_step:
                drafts[:, j] = cur[:, 0]

        # 3. one batched target verification over [pending, d1..dk_eff]
        vt = np.concatenate([np.maximum(eng._tokens_buf, 0), drafts],
                            axis=1)
        n_new = np.zeros((eng.max_batch,), np.int32)
        for w in decodes:
            slot = self._slot[w.request.req_id]
            n_new[slot] = k_eff[slot] + 1
        vlogits, eng.cache = eng.model.verify(eng.params, eng.cache,
                                              eng.tensor(vt),
                                              eng.tensor(n_new))
        # (B, k + 1)
        target = eng.to_host(greedy(vlogits, eng.cfg.vocab)).numpy()
        matched = accept_length(drafts, target)

        # 4. acceptance and rollback per scheduled slot
        acc = np.full((eng.max_batch,), -1, np.int64)
        for w in decodes:
            req = w.request
            slot = self._slot[req.req_id]
            pos = self._emit[slot] - 1       # last emitted token's index
            step = self._steps.get(slot, 0)
            self._steps[slot] = step + 1
            if trace is not None:
                accepted = trace.accepted_for(pos, step)
            else:
                accepted = int(matched[slot])
            # a slot near its output budget verified only k_eff positions
            # (the target's later rows are padding), so clamp first
            accepted = min(accepted, k_eff[slot])
            acc[slot] = accepted
            if recorder is not None:
                recorder.observe(pos, min(int(matched[slot]), k_eff[slot]))
            if self.spec_tracker is not None:
                self.spec_tracker.observe(pos, accepted, now,
                                          proposed=k_eff[slot])
            bonus = int(target[slot, accepted])
            emitted = [int(t) for t in drafts[slot, :accepted]] + [bonus]
            remaining = max(req.output_len - req.generated, 1)
            emitted = emitted[:remaining]
            t0 = int(eng._tokens_buf[slot, 0])
            self._hist[slot].extend(
                [t0] + [int(t) for t in drafts[slot, :accepted]])
            self._len[slot] += 1 + accepted
            self._draft_len[slot] += 1 + accepted
            # truncation happens only on the request's last step (its slot
            # is released before another decode), so the bonus is always
            # the right next pending token
            eng._tokens_buf[slot, 0] = bonus
            self.out_tokens.setdefault(req.req_id, []).extend(emitted)
            self._emit[slot] += len(emitted)
            self._emitted[req.req_id] = len(emitted)
            if self.obs is not None:
                self.obs.emit(now, SPEC_STEP, inst=self.cfg.name,
                              req=req.req_id, tenant=req.tenant,
                              payload={"accepted": int(accepted),
                                       "proposed": int(k_eff[slot])})

        if eng.ranks is not None:
            # acceptance is a function of the gathered logits (or of a
            # replica's own) and the replicated draft, so every rank
            # accepts alike; ranks that parted would hang the next
            # collective, so check each step
            eng.ranks.check_equal(acc, "accepted lengths")

        # 5. authoritative lengths on both caches: verify bumped the
        # scheduled slots to the full window, the draft decodes every row;
        # rows past a length are overwritten by the next write there
        lengths = np.zeros((eng.max_batch,), np.int32)
        for s, n in self._len.items():
            lengths[s] = n
        eng.cache["lengths"] = eng.tensor(lengths)
        dlen = np.zeros((eng.max_batch,), np.int32)
        for s, n in self._draft_len.items():
            dlen[s] = n
        dr.cache["lengths"] = dr.tensor(dlen)

    def decode_emitted(self, req: SimRequest) -> int:
        """Tokens the last decode step emitted for ``req`` (1 for vanilla
        decode; accepted + 1 under speculative decoding)."""
        return self._emitted.pop(req.req_id, 1)

    def _prefill_chunk(self, w: ScheduledWork):
        from repro_torch.serve.engine import _bucket
        from repro_torch.serve.sampler import greedy
        eng = self.eng
        req = w.request
        with span("bookkeep"):
            toks = self._prompt(req)
            slot = self._slot.get(req.req_id)
            if slot is None:
                slot = eng.slot_free.pop()
                self._slot[req.req_id] = slot
                self._len[slot] = 0
                self._hist[slot] = []
                self._draft_len.pop(slot, None)
                restore = self._restore.pop(req.req_id, None)
                if restore is not None and req.cached_prefix > 0:
                    payload, length = restore
                    length = min(length, req.cached_prefix)
                    # an SSD-tier stub loads here, inside execute()'s
                    # timed region, so the disk read lands on the virtual
                    # clock
                    payload = eng.radix.resolve(payload)
                    eng._restore_slot(slot, payload, length)
                    self._len[slot] = length
                    self._hist[slot] = list(toks[:length])
            start = self._len[slot]
            end = min(start + w.tokens, len(toks))
            chunk = toks[start:end]
        logits = None
        if chunk:
            with span("stage"):
                P = _bucket(len(chunk))
                pad = np.zeros((1, P), np.int32)
                pad[0, :len(chunk)] = np.asarray(chunk, np.int32)
                n_new = eng.tensor([len(chunk)])
                if start > 0:
                    eng.ensure_capacity(slot, start + len(chunk))
                    sub = eng._slot_subcache(slot, start)
                pad = eng.tensor(pad)
            if start == 0:
                logits, c1 = eng.model.prefill(eng.params, pad,
                                               lengths=n_new)
                with span("write_slot"):
                    eng._write_slot_from_prefill(slot, c1, len(chunk))
            else:
                logits, new_sub = eng.model.extend(eng.params, sub, pad,
                                                   n_new)
                with span("write_slot"):
                    eng._write_slot(slot, new_sub, start + len(chunk))
            with span("bookkeep"):
                if self.expert_load is not None:
                    # the chunk's tokens occupy KV positions [start,
                    # start+n)
                    self._routed_pos.extend(range(start, start + len(chunk)))
                self._len[slot] = start + len(chunk)
                self._hist[slot].extend(int(t) for t in chunk)
        if self._len[slot] >= len(toks) and logits is not None:
            # prompt complete: the last chunk's logits give the first token
            with span("sample"):
                first = int(eng.to_host(greedy(logits, eng.cfg.vocab))[0, 0])
            eng._tokens_buf[slot, 0] = first
            self.out_tokens.setdefault(req.req_id, []).append(first)
            self._emit[slot] = 1

    # ---- prefix store ----
    def on_prefix_hit(self, req: SimRequest, match: MatchResult,
                      usable: int) -> int:
        if self.eng.radix is None or usable <= 0:
            return 0
        toks = self._prompt(req)
        limit = min(usable, len(toks) - 1 if toks else 0)
        length, payload = self.eng.radix.match(toks, limit=limit)
        if payload is None or length <= 0:
            return 0
        self._restore[req.req_id] = (payload, length)
        if match is not None:
            # match is None on the preemption re-match (on_preempt): that
            # restore was counted when the request first hit
            self._restored_tokens += length
            self._restore_events += 1
        return length

    def on_prefill_complete(self, req: SimRequest):
        if self.eng.radix is None:
            return
        slot = self._slot.get(req.req_id)
        if slot is None:
            return
        t0 = time.perf_counter()
        toks = self._prompt(req)
        blk = (len(toks) // self.eng.radix.block) * self.eng.radix.block
        if blk > 0:
            # a device-tier entry: the gathered tensors stay on the
            # engine's device until the runtime demotes them
            self.eng.radix.insert(
                toks, self.eng._export_slot(slot, blk, to_host=False))
        self.eng.synchronize()    # the carry covers the device's gather
        self._carry_s += time.perf_counter() - t0

    def on_tier_transfer(self, src: str, dst: str, n_bytes: float,
                         prefix) -> None:
        """Carry out the runtime's tier decision on the payload store:
        demotions copy device entries to host memory (and on to a spill
        file for SSD), promotions copy them back, drops delete.  All of it
        is wall-timed into ``_carry_s``, as store inserts are, so tier
        traffic is measured here where the simulator prices it."""
        if self.eng.radix is None:
            return
        t0 = time.perf_counter()
        if dst == "device":
            self.eng.radix.promote(prefix)
        elif dst in ("host", "ssd"):
            self.eng.radix.demote(prefix, dst)
        else:
            self.eng.radix.drop(prefix)
        self.eng.synchronize()    # the move's copies, not their enqueue
        dt = time.perf_counter() - t0
        self._carry_s += dt
        self._tier_move_s += self.eng.slowest(dt)
        self._tier_moves += 1

    def kv_tier_stats(self) -> dict:
        s = {"restored_tokens": self._restored_tokens,
             "restore_events": self._restore_events,
             "tier_moves": self._tier_moves,
             "tier_move_s": self._tier_move_s}
        if self.eng.radix is not None:
            s["store_residency"] = self.eng.radix.residency()
        return s

    def on_preempt(self, req: SimRequest) -> int:
        self.release(req)
        # the restart regenerates the whole output from scratch
        self.out_tokens.pop(req.req_id, None)
        # re-match the store so the restart restores whatever KV survives
        return self.on_prefix_hit(req, None, req.cached_prefix) \
            if req.cached_prefix > 0 else 0

    def release(self, req: SimRequest):
        slot = self._slot.pop(req.req_id, None)
        self._restore.pop(req.req_id, None)
        self._emitted.pop(req.req_id, None)
        if slot is None:
            return
        self._len.pop(slot, None)
        self._hist.pop(slot, None)
        self._draft_len.pop(slot, None)
        self._emit.pop(slot, None)
        self._steps.pop(slot, None)
        self.eng._release_slot(slot)

    # ---- P/D handoff ----
    def export_kv(self, req: SimRequest) -> KvHandoff:
        t0 = time.perf_counter()
        slot = self._slot[req.req_id]
        length = self._len[slot]
        tp = self._pd_tp.get(req.decode_instance, self.eng.tp)
        kv = self.eng._export_slot(slot, length, all_heads=tp != self.eng.tp)
        first = int(self.eng._tokens_buf[slot, 0])
        nbytes = self.eng.handoff_nbytes(kv)
        self.release(req)
        self._carry_s += time.perf_counter() - t0
        return KvHandoff(nbytes=nbytes,
                         payload={"kv": kv, "first": first, "len": length})

    def import_kv(self, req: SimRequest, handoff: Optional[KvHandoff]):
        if handoff is None or handoff.payload is None:
            return
        slot = self.eng.slot_free.pop()
        self._slot[req.req_id] = slot
        p = handoff.payload
        self.eng._restore_slot(slot, p["kv"], p["len"])
        self.eng._tokens_buf[slot, 0] = p["first"]
        self._len[slot] = p["len"]
        # spec bookkeeping: the KV holds exactly the (possibly truncated)
        # prompt; the pending first token is the one emitted
        self._hist[slot] = list(self._prompt(req))[:p["len"]]
        self._draft_len.pop(slot, None)
        self._emit[slot] = 1
        self.out_tokens.setdefault(req.req_id, []).append(p["first"])

    # ---- lifecycle ----
    def reset(self):
        eng = self.eng
        self._slot.clear()
        self._len.clear()
        self._restore.clear()
        self._routed_pos = []
        self._hist.clear()
        self._draft_len.clear()
        self._emit.clear()
        self._steps.clear()
        self._emitted.clear()
        engines = [eng] + ([eng.draft] if eng.spec is not None else [])
        eng.slot_free = list(range(eng.max_batch))
        for e in engines:
            e.cache["lengths"] = e.tensor(np.zeros((e.max_batch,), np.int32))
            for slot in range(e.max_batch):
                e._free_pages(slot)

    def stats(self) -> dict:
        s = {"engine_iterations": self._iterations}
        if self.eng.radix is not None:
            s["kv_store_hits"] = self.eng.radix.hits
            s["kv_store_misses"] = self.eng.radix.misses
        if self.expert_load is not None:
            s["expert_load"] = self.expert_load.metrics()
        if self.spec_tracker is not None:
            s["spec_decode"] = self.spec_tracker.metrics()
        return s
