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
serves all scheduled decode slots per iteration.

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
token the prefill emitted pending.

Speculative decoding and the prefix store are not ported yet; the backend
refuses configurations that ask for them.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.config import InstanceCfg
from repro_torch.core.memory import MemoryModel
from repro_torch.core.request import SimRequest
from repro_torch.moe import ExpertLoadTracker, resolve_routing
from repro_torch.runtime.backend import KvHandoff
from repro_torch.runtime.prefix_cache import MatchResult
from repro_torch.runtime.scheduler import ScheduledWork


class TorchBackend:
    name = "torch"

    def __init__(self, engine, cfg: InstanceCfg):
        if cfg.spec.enabled or cfg.spec.acceptance_trace:
            raise NotImplementedError(
                f"instance {cfg.name!r}: speculative decoding is not "
                f"ported yet")
        self.eng = engine
        self.cfg = cfg
        self.memory = MemoryModel(cfg)
        self._slot: Dict[int, int] = {}      # req_id -> engine slot
        self._len: Dict[int, int] = {}       # slot   -> tokens held in KV
        self._iterations = 0
        # real work done outside execute() (P/D export) is wall-timed and
        # charged to the next iteration
        self._carry_s = 0.0
        self.obs = None
        # output-token capture: req_id -> emitted token ids, in order
        self.out_tokens: Dict[int, List[int]] = {}
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
        chunk plan and the backend's KV state always agree."""
        return max(self.eng.max_len - req.output_len - 1, 1)

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
        if sched.chunked_prefill:
            # chunk 2+ of a chunked prefill runs ``extend``: run it once at
            # every padded chunk bucket so the measured run starts warm
            top = _bucket(min(max(sched.prefill_chunk, 16),
                              eng.max_len - 1))
            P = 16
            while P <= top and P < eng.max_len:
                pad = eng.tensor(np.zeros((1, P), np.int32))
                sub = eng._slot_subcache(0, 16)
                eng.model.extend(eng.params, sub, pad, eng.tensor([P]))
                eng._write_slot(0, sub, 16)
                P *= 2
            eng._release_slot(0)
        eng.synchronize()

    # ---- execution ----
    def execute(self, work: List[ScheduledWork], now: float) -> float:
        t0 = time.perf_counter()
        decodes = [w for w in work if w.phase == "decode"]
        prefills = [w for w in work if w.phase == "prefill"]
        if decodes:
            self._decode_step(decodes)
        for w in prefills:
            self._prefill_chunk(w)
        self.eng.synchronize()
        self._iterations += 1
        latency = time.perf_counter() - t0 + self._carry_s
        self._carry_s = 0.0
        if self.expert_load is not None:
            self.expert_load.observe(self._routed_pos, now)
            self._routed_pos = []
        return latency

    def _decode_step(self, decodes: List[ScheduledWork]):
        from repro_torch.serve.sampler import greedy
        eng = self.eng
        tokens = eng._tokens_buf
        for w in decodes:
            # the decode writes each scheduled slot's new token at its old
            # length: make sure that page exists
            slot = self._slot[w.request.req_id]
            eng.ensure_capacity(slot, self._len[slot] + 1)
        hooked = eng.model.routing_hook is not None
        if hooked:
            # mark every slot that is not scheduled (free, or mid-prefill)
            # with the sentinel -1: its row still computes, but is neither
            # recorded nor given expert capacity.  The engine's buffer keeps
            # the mid-prefill slots' pending first tokens.
            tokens = tokens.copy()
            scheduled_slots = {self._slot[w.request.req_id]
                               for w in decodes}
            for slot in range(eng.max_batch):
                if slot not in scheduled_slots:
                    tokens[slot, 0] = -1
        logits, eng.cache = eng.model.decode(eng.params, eng.cache,
                                             eng.tensor(tokens))
        nxt = greedy(logits, eng.cfg.vocab).cpu().numpy()
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
                or (hooked and len(self._len) < eng.max_batch):
            # the full-buffer decode bumped every slot's length; restore
            # the lengths of mid-prefill / unscheduled slots.  Under a
            # routing hook also zero the free slots every step: the hook's
            # decode mask knows an empty slot by its position 0, and bumps
            # left to pile up over decode-only steps would mark phantom
            # rows valid
            lengths = np.zeros((eng.max_batch,), np.int32)
            for s, n in self._len.items():
                lengths[s] = n
            eng.cache["lengths"] = eng.tensor(lengths)

    def _prefill_chunk(self, w: ScheduledWork):
        from repro_torch.serve.engine import _bucket
        from repro_torch.serve.sampler import greedy
        eng = self.eng
        req = w.request
        toks = self._prompt(req)
        slot = self._slot.get(req.req_id)
        if slot is None:
            slot = eng.slot_free.pop()
            self._slot[req.req_id] = slot
            self._len[slot] = 0
        start = self._len[slot]
        end = min(start + w.tokens, len(toks))
        chunk = toks[start:end]
        logits = None
        if chunk:
            P = _bucket(len(chunk))
            pad = np.zeros((1, P), np.int32)
            pad[0, :len(chunk)] = np.asarray(chunk, np.int32)
            n_new = eng.tensor([len(chunk)])
            if start == 0:
                logits, c1 = eng.model.prefill(eng.params, eng.tensor(pad),
                                               lengths=n_new)
                eng._write_slot_from_prefill(slot, c1, len(chunk))
            else:
                eng.ensure_capacity(slot, start + len(chunk))
                sub = eng._slot_subcache(slot, start)
                logits, new_sub = eng.model.extend(eng.params, sub,
                                                   eng.tensor(pad), n_new)
                eng._write_slot(slot, new_sub, start + len(chunk))
            if self.expert_load is not None:
                # the chunk's tokens occupy KV positions [start, start+n)
                self._routed_pos.extend(range(start, start + len(chunk)))
            self._len[slot] = start + len(chunk)
        if self._len[slot] >= len(toks) and logits is not None:
            # prompt complete: the last chunk's logits give the first token
            first = int(greedy(logits, eng.cfg.vocab)[0, 0])
            eng._tokens_buf[slot, 0] = first
            self.out_tokens.setdefault(req.req_id, []).append(first)

    # ---- prefix cache (not ported: the engine has no store) ----
    def on_prefix_hit(self, req: SimRequest, match: MatchResult,
                      usable: int) -> int:
        return 0

    def on_prefill_complete(self, req: SimRequest):
        return None

    def on_preempt(self, req: SimRequest) -> int:
        self.release(req)
        # the restart regenerates the whole output from scratch
        self.out_tokens.pop(req.req_id, None)
        return 0

    def release(self, req: SimRequest):
        slot = self._slot.pop(req.req_id, None)
        if slot is None:
            return
        self._len.pop(slot, None)
        self.eng._release_slot(slot)

    # ---- P/D handoff ----
    def export_kv(self, req: SimRequest) -> KvHandoff:
        t0 = time.perf_counter()
        slot = self._slot[req.req_id]
        length = self._len[slot]
        kv = self.eng._export_slot(slot, length)
        first = int(self.eng._tokens_buf[slot, 0])
        nbytes = float(sum(t.nbytes for key, layer in kv.items()
                           if not key.startswith("_")
                           for t in layer.values()))
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
        self.out_tokens.setdefault(req.req_id, []).append(p["first"])

    # ---- lifecycle ----
    def reset(self):
        eng = self.eng
        self._slot.clear()
        self._len.clear()
        self._routed_pos = []
        eng.slot_free = list(range(eng.max_batch))
        eng.cache["lengths"] = eng.tensor(np.zeros((eng.max_batch,),
                                                   np.int32))
        for slot in range(eng.max_batch):
            eng._free_pages(slot)

    def stats(self) -> dict:
        s = {"engine_iterations": self._iterations}
        if self.expert_load is not None:
            s["expert_load"] = self.expert_load.metrics()
        return s
