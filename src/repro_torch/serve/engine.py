"""Real PyTorch execution substrate: model calls over a paged slot KV cache.

``ServingEngine`` is mechanism only, as in ``repro/serve/engine.py``: it
owns the params, the paged slot KV cache with its page allocator, and the
slot plumbing (prefill write-back, one-row subcache views, release).  The
unified runtime (``repro_torch.runtime``) schedules every iteration and
drives it through ``TorchBackend.execute``.

The KV layout is the JAX package's paged one: shared page pools per layer
(page size 64), a per-slot block table whose free entries point at the
slot's own scratch page (never allocated; see ``Model.page_geometry``),
and a free-list allocator.  MoE routing is injected here,
as in JAX: ``routing`` is an ``ExpertRoutingTrace`` (replayed, and kept as
``routing_trace`` so ``TorchBackend`` accounts expert load from the same
table) or a hook callable (``repro_torch.moe.hooks``).  A slot's KV can be
copied out and restored into another slot or engine (``_export_slot`` /
``_restore_slot``, the P/D handoff and the prefix store) in the JAX
package's contiguous payload layout; ``role`` ("unified" | "prefill" |
"decode") is only stored, as in JAX.

``prefix_cache=True`` gives the engine a real radix prefix store
(``RealRadixCache``: KV payloads keyed by token prefix on three tiers,
the card, host memory and a spill file).  ``spec=SpecDecodeCfg(...)``
gives it a nested draft engine with the same slot geometry on the same
device (and stream), so draft slot i mirrors target slot i; the target
verifies all proposals in one ``Model.verify`` call (the paged extend
kernel at S = k + 1).  ``TorchBackend`` drives both.

``tp > 1`` makes the engine one rank of a tensor-parallel group (``group``,
a ``repro_torch.launch.mesh.EngineGroup``; one process a rank): the full
params come in the JAX layout and each rank keeps its shard
(``repro_torch.launch.sharding``; any tp, in GSPMD's padded head
layout), its pools hold its KV slots (``Model.kv_heads``: its KV heads,
one repeated where its query heads straddle groups unevenly, none on a
rank with no query head), and the model's collectives complete every
layer.  The page allocator and the block table are the same on every
rank because every rank's runtime makes the same decisions
(``TorchBackend`` hands it the slowest rank's latency).  Every engine
of a process shares the one default process group, so several engines
(a P/D pair, several instances) run their
collectives in the order the deterministic driver calls them, the same on
every rank.  Each rank's prefix store keeps its own heads' payload under
the same token key, moved between tiers by the same runtime decisions on
every rank; a store entry is never gathered.  The draft of speculative
decoding is a tp = 1 engine on the rank's device, replicated on every rank
and never given the group, as in JAX.

A tp = 1 engine served beside a tp > 1 one (a P/D pair of different tp)
is replicated: every rank builds it from the same weights and drives it
through the same decisions, and ``replicas`` (the rank's engine group)
makes its wall times the slowest rank's and lets a speculative step check
that the ranks accepted alike.  It never joins the model's collectives.

Every slot export holds each of its KV heads once (a repeated slot is
read once, ``sharding.from_slots``; a restore repeats it again,
``to_slots``) and is tagged with them (``_kv_heads``: ``(lo, hi, KV)``).
Under P/D between engines of the same tp, rank r of the prefill engine
hands its own heads to rank r of the decode engine.  Between engines of
different tp the payload holds every head, as the JAX package ships it:
a prefill group all-gathers its ranks' heads, padded to the most any
rank reads and cut back, each head taken from its owner (``all_heads=
True``; ``launch.sharding.gather_kv_heads``), and each rank of a decode
group restores its own out of the full payload
(``launch.sharding.take_kv_heads``).  A payload whose heads match neither
the engine's nor the full set raises.  The handoff's bytes are those of
the tp = 1 payload in every case (``handoff_nbytes``).

A model with recurrent stages (Mamba2, the zamba superblock, xLSTM) keeps
dense per-slot state beside the pools (``Model.state_leaves``: each leaf
with its batch axis, 2 for a superblock's ``(L, 6, B, ...)``).  The slot
plumbing carries it on that axis: a prefill's state is copied into the
slot, a one-row subcache views it, an ``extend``'s new state is copied
back, a P/D payload carries the slot's state leaves (batch axis removed)
beside ``{"k", "v"}``, and a released slot gets fresh state.  At tp > 1
a rank's state holds its heads (``launch.sharding.state_pieces``).  As
with the K/V, under P/D between engines of the same tp rank r hands its
own part to rank r (tagged ``_state_rank``); between engines of different
tp the payload carries the state in the tp = 1 layout: the export
all-gathers it over the group (``sharding.gather_state``) and a restore
takes the rank's part (``sharding.take_state``).  The handoff's state
bytes are tp = 1's in every case.  The prefix store and speculative
decoding refuse such a model (``refuse_unported_recurrent``).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import Model
from repro_torch.models.transformer import RECURRENT, cast_params, torch_dtype
from repro_torch.obs.spans import Waits, span


@dataclasses.dataclass
class SpecDecodeCfg:
    """Speculative decoding for a real engine: draft model + verification.

    ``draft`` is the proposer's architecture (its own params, its own slot
    KV cache: a nested mechanism-only ``ServingEngine``; ``draft_params``
    lets it share another engine's tensors); the target verifies all ``k``
    proposals in one batched ``verify``.  With ``acceptance`` unset the
    engine is greedy-lossless: it emits exactly the tokens of vanilla
    greedy decode (the accepted prefix and the target's own bonus token).
    With an ``AcceptanceTrace`` attached the acceptance decision is
    replayed from the trace, so the simulator and the engine can be held
    to the same steps; ``recorder`` taps (position, accepted) pairs
    (``repro_torch.spec.record``)."""
    draft: ArchConfig
    k: int = 4
    acceptance: Optional[Any] = None      # repro_torch.spec.AcceptanceTrace
    draft_seed: int = 1
    draft_params: Optional[Any] = None
    recorder: Optional[Any] = None        # repro_torch.spec.AcceptanceRecorder


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


#: hotter tiers have lower rank; demotion only moves entries downward
_TIER_RANK = {"device": 0, "host": 1, "ssd": 2}


def _payload_map(payload: dict, fn) -> dict:
    """Apply ``fn`` to every tensor of a store entry; metadata keys (a
    leading ``_``) pass through."""
    return {k: v if k.startswith("_") else {n: fn(t) for n, t in v.items()}
            for k, v in payload.items()}


def _payload_to_host(payload: dict) -> dict:
    """Device -> host copy of a store entry."""
    return _payload_map(payload, lambda t: t.cpu())


def _payload_nbytes(payload: dict, names=None) -> float:
    """The bytes of a payload's tensors (only those named ``names``)."""
    return float(sum(t.nbytes for k, v in payload.items()
                     if not k.startswith("_") for n, t in v.items()
                     if names is None or n in names))


class RealRadixCache:
    """Real prefix cache: token prefix -> stored KV payload, tier-tagged.

    The port of ``repro/serve/engine.py``'s store.  Entries live on one of
    three tiers mirroring the runtime radix tree's block accounting:
    ``device`` (tensors on the engine's device, the insert default),
    ``host`` (CPU tensors), ``ssd`` (written with ``torch.save`` to a spill
    file under a ``tempfile.mkdtemp`` directory; a matched stub is read
    back only through :meth:`resolve`, so the disk read lands inside the
    caller's wall-timed region).  Tier moves are driven by the runtime's
    eviction decisions through ``TorchBackend.on_tier_transfer``; this
    class is mechanism only.  Moves are entry-granular: demoting one radix
    block demotes every stored entry containing it (payloads are
    whole-prefix slices, not per-block pages).  A spill that fails
    raises.  Each store makes its own spill directory, so the ranks of a
    tensor-parallel engine (one process a rank, each storing its own KV
    heads under the same keys) never write one path."""

    def __init__(self, block: int = 16, max_entries: int = 64,
                 device=None):
        self.block = block
        self.device = torch.device("cpu" if device is None else device)
        self.store: "OrderedDict[tuple, dict]" = OrderedDict()
        self.tier: Dict[tuple, str] = {}
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self._ssd_dir: Optional[str] = None
        self._ssd_seq = 0

    def match(self, tokens,
              limit: Optional[int] = None) -> Tuple[int, Optional[dict]]:
        """Longest stored prefix of ``tokens`` (optionally capped at
        ``limit`` tokens, e.g. the runtime's radix-tree match length)."""
        best_len, best = 0, None
        n = (len(tokens) // self.block) * self.block
        if limit is not None:
            n = min(n, (limit // self.block) * self.block)
        for l in range(n, 0, -self.block):
            key = tuple(tokens[:l])
            if key in self.store:
                self.store.move_to_end(key)
                best_len, best = l, self.store[key]
                break
        if best is None:
            self.misses += 1
        else:
            self.hits += 1
        return best_len, best

    def insert(self, tokens, kv_slices: dict, tier: str = "device"):
        l = (len(tokens) // self.block) * self.block
        if l == 0:
            return
        key = tuple(tokens[:l])
        if key in self.store:
            return
        self.store[key] = kv_slices
        self.tier[key] = tier
        while len(self.store) > self.max_entries:
            old, payload = self.store.popitem(last=False)
            self.tier.pop(old, None)
            self._unlink(payload)

    # ---- tier moves (entry-granular; see class docstring) ----
    def _covering(self, prefix) -> list:
        p = tuple(prefix)
        n = len(p)
        return [k for k in list(self.store) if len(k) >= n and k[:n] == p]

    def demote(self, prefix, dst: str) -> float:
        """Move entries containing ``prefix`` down to ``dst`` ("host" |
        "ssd"); returns the bytes moved."""
        moved = 0.0
        for k in self._covering(prefix):
            if _TIER_RANK.get(self.tier.get(k, "host"), 1) \
                    >= _TIER_RANK[dst]:
                continue
            host = _payload_to_host(self.resolve(self.store[k]))
            moved += _payload_nbytes(host)
            self._unlink(self.store[k])
            self.store[k] = host if dst == "host" else self._to_ssd(host)
            self.tier[k] = dst
        return moved

    def promote(self, prefix) -> float:
        """Bring entries containing ``prefix`` back to the device."""
        moved = 0.0
        for k in self._covering(prefix):
            if self.tier.get(k, "device") == "device":
                continue
            host = self.resolve(self.store[k])
            moved += _payload_nbytes(host)
            dev = _payload_map(host, lambda t: t.to(self.device))
            self._unlink(self.store[k])
            self.store[k] = dev
            self.tier[k] = "device"
        return moved

    def drop(self, prefix):
        for k in self._covering(prefix):
            payload = self.store.pop(k)
            self.tier.pop(k, None)
            self._unlink(payload)

    def resolve(self, payload: dict) -> dict:
        """Materialize a matched payload: SSD stubs are loaded here, so
        call this inside the region whose wall time should absorb the disk
        read (``TorchBackend._prefill_chunk`` does)."""
        if isinstance(payload, dict) and "_ssd" in payload:
            return torch.load(payload["_ssd"], weights_only=True)
        return payload

    def residency(self) -> Dict[str, int]:
        out = {"device": 0, "host": 0, "ssd": 0}
        for k in self.store:
            out[self.tier.get(k, "device")] += 1
        return out

    def _to_ssd(self, host_payload: dict) -> dict:
        if self._ssd_dir is None:
            self._ssd_dir = tempfile.mkdtemp(prefix="kv-ssd-")
        self._ssd_seq += 1
        path = os.path.join(self._ssd_dir, f"kv{self._ssd_seq}.pt")
        with open(path, "wb") as f:
            torch.save(host_payload, f)
        return {"_ssd": path,
                "_length": host_payload.get("_length"),
                "_length_bucket": host_payload.get("_length_bucket")}

    @staticmethod
    def _unlink(payload):
        path = payload.get("_ssd") if isinstance(payload, dict) else None
        if path:
            try:
                os.remove(path)
            except OSError:
                pass


def refuse_unported_recurrent(cfg: ArchConfig, *,
                              prefix_cache: bool = False,
                              spec=None) -> None:
    """Raise for the serving techniques not ported to models with
    recurrent stages (ROADMAP queue 1 item 7): a prefix hit needs the
    state at the hit's length, which neither package stores, and a
    rejected draft cannot be rolled back out of a recurrent state."""
    if not any(st.kind in RECURRENT for st in cfg.stages):
        return
    what = [w for w, on in (("the prefix store", prefix_cache),
                            ("speculative decoding", spec is not None))
            if on]
    if what:
        raise NotImplementedError(
            f"ServingEngine: {' and '.join(what)} on {cfg.name}, a model "
            f"with recurrent stages, not ported yet (ROADMAP queue 1 "
            f"item 7)")


def resolve_device(device) -> torch.device:
    """``None`` means the card; a card that is absent raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ServingEngine: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    return dev


class ServingEngine:
    """One instance's execution substrate (slots, model calls, paged KV).

    Driven by ``repro_torch.runtime.backends.torch_engine.TorchBackend``.
    ``params``: a nested dict in the JAX layout (e.g. from
    ``repro_torch.convert.params_from_numpy``); when None they are drawn
    on the device from ``seed``.  Matmul weights are cast to the compute
    dtype once, here; the JAX model casts at every call, to the same
    values.  At ``tp > 1`` the engine runs on ``group.device`` and keeps
    rank ``group.rank``'s shard of the (full) params.  ``replicas``: a tp
    = 1 engine's handle on the ranks it is replicated over (the rank's
    engine group; see the module docstring); it runs on
    ``replicas.device``.
    """

    def __init__(self, cfg: ArchConfig, params=None, *, max_batch: int = 8,
                 max_len: int = 512, prefix_cache: bool = False,
                 role: str = "unified", name: str = "engine0", seed: int = 0,
                 tp: int = 1, routing=None,
                 spec: Optional[SpecDecodeCfg] = None, device=None,
                 group=None, replicas=None):
        tp = int(tp)
        if tp < 1:
            raise ValueError(f"ServingEngine: tp must be >= 1, got {tp}")
        if not cfg.embed_inputs or cfg.n_codebooks:
            raise NotImplementedError(
                f"ServingEngine: {cfg.name} reads precomputed embeddings "
                f"and has codebook heads; the serving engine takes token "
                f"ids only, as the JAX one does (ROADMAP.md, \"After the "
                f"port\": serving musicgen-large)")
        refuse_unported_recurrent(cfg, prefix_cache=prefix_cache, spec=spec)
        if tp > 1:
            if group is None:
                raise ValueError(
                    f"ServingEngine: tp={tp} needs an engine group, one "
                    f"process a rank: launch the ranks with python -m "
                    f"repro_torch.launch.serve --tp {tp}, or "
                    f"repro_torch.launch.mesh.run_ranks, and pass each "
                    f"its group=")
            if group.size != tp:
                raise ValueError(f"ServingEngine: tp={tp} but the engine "
                                 f"group has {group.size} ranks")
            if replicas is not None:
                raise ValueError(f"ServingEngine: replicas= is a tp = 1 "
                                 f"engine's handle; at tp={tp} pass group=")
            from repro_torch.launch.sharding import unsupported
            why = unsupported(cfg, tp)
            if why is not None:
                raise ValueError(f"ServingEngine: {why}")
        elif group is not None and group.size != 1:
            raise ValueError(f"ServingEngine: tp=1 in a {group.size}-rank "
                             f"engine group; a tp = 1 engine replicated "
                             f"on every rank takes replicas=")
        ranks = group if tp > 1 else replicas
        if ranks is not None:
            if device is not None:
                d = resolve_device(device)
                if d.type != ranks.device.type or d.index not in (
                        None, ranks.device.index):
                    raise ValueError(f"ServingEngine: device {device} is "
                                     f"not rank {ranks.rank}'s "
                                     f"{ranks.device}")
            device = ranks.device
        if spec is not None:
            if routing is not None:
                raise ValueError(
                    "speculative decoding and trace-driven MoE routing "
                    "cannot be combined on one engine (draft tokens that "
                    "fail verification have no expert-load semantics)")
            if spec.k < 1:
                raise ValueError(f"spec.k must be >= 1, got {spec.k}")
            if spec.draft.vocab != cfg.vocab:
                raise ValueError(
                    f"draft {spec.draft.name!r} has vocab "
                    f"{spec.draft.vocab} but target {cfg.name!r} has "
                    f"{cfg.vocab}; draft/target token ids must line up")
            if spec.acceptance is not None:
                spec.acceptance.validate().check_k(spec.k)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.name = name
        self.role = role
        self.tp = tp
        self.group = group if tp > 1 else None
        #: the ranks that agree on this engine's wall times: its group, its
        #: replica handle, or None
        self.ranks = ranks
        self.page_size = 64
        self.routing_trace = None
        hook = None
        if routing is not None:
            if callable(routing):
                hook = routing
            else:
                from repro_torch.moe.hooks import make_replay_hook
                from repro_torch.moe.trace import moe_layer_count
                routing.check_model(cfg)
                if routing.n_layers != moe_layer_count(cfg):
                    raise ValueError(
                        f"routing trace {routing.model!r} has "
                        f"{routing.n_layers} MoE layers but {cfg.name!r} "
                        f"has {moe_layer_count(cfg)}")
                self.routing_trace = routing
                hook = make_replay_hook(routing)
        self.model = Model(cfg, page_size=self.page_size, routing_hook=hook,
                           group=self.group)
        from repro_torch.launch.sharding import kv_heads
        KV = cfg.n_kv_heads
        #: the KV heads ``(lo, hi, KV)`` this engine's pools hold
        self.kv_range = (0, KV, KV) if self.group is None else \
            kv_heads(cfg, self.group.rank, tp) + (KV,)
        dtype = torch_dtype(cfg.compute_dtype)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, device=self.device, dtype=dtype)
        if self.group is not None:
            from repro_torch.launch.sharding import shard_params
            params = shard_params(params, self.group.rank, tp, cfg=cfg)
        self.params = cast_params(params, dtype, self.device)
        del params
        if self.group is not None and self.device.type == "cuda":
            # the full params drawn here are garbage now: give their
            # memory back to the card (another rank may share it)
            torch.cuda.empty_cache()
        self.max_batch = max_batch
        self.max_len = max_len
        self.cache = self.model.init_cache(max_batch, max_len,
                                           device=self.device)
        # one slot's fresh recurrent state, given back to a released slot
        self._fresh = [t.select(ax, 0).clone() for _, _, t, ax
                       in self.model.state_leaves(self.cache)]
        # page allocator: a free list over the shared pool, a host mirror
        # of the device block table, and per-slot allocation counts.  Past
        # the allocatable pages come one scratch page per slot, then the
        # page that takes writes past the table.
        self._maxp, self._n_pages = self.model.page_geometry(max_batch,
                                                             max_len)
        n_alloc = max_batch * self._maxp
        self._scratch = self._n_pages - 1
        self._slot_scratch = [n_alloc + b for b in range(max_batch)]
        self._page_free = list(range(n_alloc))
        self._table_np = np.repeat(
            np.asarray(self._slot_scratch, np.int32)[:, None], self._maxp,
            axis=1)
        self._slot_pages = [0] * max_batch
        self.slot_free = list(range(max_batch))
        self._tokens_buf = np.zeros((max_batch, 1), np.int32)
        #: blocking host-device waits (``obs.spans.Waits``); the backend
        #: resets them at each iteration's start
        self.waits = Waits()
        self.radix = RealRadixCache(device=self.device) \
            if prefix_cache else None
        # speculative decoding: a nested mechanism-only draft engine with
        # the same slot geometry on the same device (draft slot i mirrors
        # target slot i); TorchBackend runs propose / verify / rollback
        self.spec = spec
        self.draft = None
        if spec is not None:
            self.draft = ServingEngine(
                spec.draft, params=spec.draft_params, max_batch=max_batch,
                max_len=max_len, name=f"{name}.draft", seed=spec.draft_seed,
                device=self.device)
            # one iteration's waits, whichever engine makes them
            self.draft.waits = self.waits

    def tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        """Host data on the device: a pageable copy, which waits for the
        stream on a card (a ``wait.h2d``)."""
        self.waits.h2d += 1
        with span("wait.h2d"):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A device value read on the host (a ``wait.d2h``)."""
        self.waits.d2h += 1
        with span("wait.d2h"):
            return t.cpu()

    def synchronize(self):
        """Wait for the device, so a wall-clock time covers its work."""
        self.waits.sync += 1
        with span("wait.sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def slowest(self, seconds: float) -> float:
        """A wall time measured on this rank -> the largest over the ranks
        of its group or its replicas (the time itself for an engine
        alone)."""
        return seconds if self.ranks is None else self.ranks.slowest(seconds)

    def handoff_nbytes(self, payload: dict) -> float:
        """The bytes of an ``_export_slot`` payload over the whole group,
        the same on every rank and the size of the payload tp = 1 ships.
        A payload of every KV head (tp = 1, a replica, a gathered export)
        counts its own bytes once; a rank's payload at tp > 1 counts the
        heads it owns (``launch.sharding.owned_kv_heads``: a head that
        several ranks hold counts once), summed over the ranks with one
        all-reduce.  Recurrent state counts the same way: a whole state
        once, a rank's part (``_state_rank``) by the entries it owns
        (``launch.sharding.owned_state_width``: Mamba2's B/C conv
        channels, which every rank holds, count on rank 0)."""
        from repro_torch.launch import sharding
        kv = int(_payload_nbytes(payload, ("k", "v")))
        state = int(_payload_nbytes(payload)) - kv
        lo, hi, KV = payload["_kv_heads"]
        whole = float(kv if hi - lo == KV else 0)
        mine, split = 0, False
        if hi - lo < KV:
            split = True
            olo, ohi = sharding.owned_kv_heads(self.cfg, self.group.rank,
                                               self.tp)
            # a rank with no query head ships no K/V
            mine += kv // (hi - lo) * (ohi - olo) if hi > lo else 0
        if payload.get("_state_rank") is None:
            whole += state
        else:
            split = True
            for key, name, _, _ in self.model.state_leaves(self.cache):
                t = payload[key][name]
                dim, _ = sharding.state_pieces(self.cfg, name,
                                               self.group.rank, self.tp)
                if t.shape[dim]:
                    mine += t.nbytes // t.shape[dim] * \
                        sharding.owned_state_width(
                            self.cfg, name, self.group.rank, self.tp)
        return whole + (float(self.group.total(mine)) if split else 0.0)

    def warmup(self, buckets=(16, 32, 64, 128, 256)):
        """Run prefill (and, with a prefix store, extend) at every bucket
        and one decode, so the first measured iteration pays no one-time
        cost (library handles, the kernels' build and load).  Extend and
        decode writes land on the scratch pages of free slots and their
        returned caches are dropped; the decode runs every row on the
        sentinel token, so no slot's recurrent state moves."""
        for P in buckets:
            if P >= self.max_len:
                continue
            pad = torch.zeros((1, P), dtype=torch.int32, device=self.device)
            self.model.prefill(self.params, pad, lengths=self.tensor([P]))
            if self.radix is not None:
                self.model.extend(self.params, self._slot_subcache(0, 16),
                                  pad, self.tensor([P]))
        self.model.decode(self.params, self.cache,
                          self.tensor(np.full_like(self._tokens_buf, -1)))
        self.synchronize()

    # ---- paged-KV allocator ----
    def ensure_capacity(self, slot: int, length: int):
        """Grow ``slot``'s page allocation to cover ``length`` tokens; the
        free list can hold every slot's full ``maxp`` pages at once."""
        need = min(-(-length // self.page_size), self._maxp)
        have = self._slot_pages[slot]
        if need <= have:
            return
        for j in range(have, need):
            self._table_np[slot, j] = self._page_free.pop()
        self._slot_pages[slot] = need
        self._push_table()

    def _push_table(self):
        # in place: one-row subcache views share this tensor
        self.waits.h2d += 1
        with span("wait.h2d"):
            self.cache["block_table"].copy_(torch.from_numpy(self._table_np))

    def _free_pages(self, slot: int):
        if not self._slot_pages[slot]:
            return
        for j in range(self._slot_pages[slot]):
            self._page_free.append(int(self._table_np[slot, j]))
            self._table_np[slot, j] = self._slot_scratch[slot]
        self._slot_pages[slot] = 0
        self._push_table()

    def _set_length(self, slot: int, n: int):
        self.cache["lengths"][slot] = n

    def _release_slot(self, slot: int):
        if slot not in self.slot_free:
            self.slot_free.append(slot)
        self._set_length(slot, 0)
        self._free_pages(slot)
        for (_, _, t, ax), fresh in zip(
                self.model.state_leaves(self.cache), self._fresh):
            t.select(ax, slot).copy_(fresh)

    def _copy_state(self, slot: int, src):
        """Copy a (B=1) cache's recurrent state into ``slot``."""
        for (_, _, t, ax), (_, _, one, _) in zip(
                self.model.state_leaves(self.cache),
                self.model.state_leaves(src)):
            t.narrow(ax, slot, 1).copy_(one)

    def _write_slot_from_prefill(self, slot: int, cache1, n: int):
        """Scatter a (B=1) prefill cache's K/V through ``slot``'s table row
        (pad-tail positions past the table go to the last page) and copy
        its recurrent state into the slot."""
        chunks = self.model.attention_caches(cache1)
        P = chunks[0][1]["k"].shape[2] if chunks else n
        self.ensure_capacity(slot, min(P, self.max_len))
        if chunks:
            row = self.cache["block_table"][slot].long()
            pos = torch.arange(P, device=self.device)
            pidx = pos // self.page_size
            page = row[torch.clamp(pidx, max=self._maxp - 1)]
            page = torch.where(pidx < self._maxp, page,
                               torch.full_like(page, self._scratch))
            off = pos % self.page_size
            for (_, pools), (_, kv) in zip(
                    self.model.attention_caches(self.cache), chunks):
                pools["k_pages"][:, page, off] = kv["k"][:, 0]
                pools["v_pages"][:, page, off] = kv["v"][:, 0]
        self._copy_state(slot, cache1)
        self._set_length(slot, n)

    def _slot_subcache(self, slot: int, length: int):
        """A (B=1) view of one slot: the shared pools, a one-row table, the
        slot's recurrent state (views), and the given length.  ``extend``
        on it writes the slot's pages and returns its new state."""
        sub = {"lengths": self.tensor([length]),
               "block_table": self.cache["block_table"][slot: slot + 1]}
        sub.update(self.model.slot_view(self.cache, slot))
        return sub

    def _write_slot(self, slot: int, sub_cache, n: int):
        """Adopt an ``extend`` on a subcache: its K/V writes are already in
        the shared pools; its new recurrent state is copied into the
        slot, and the slot's length changes."""
        self._copy_state(slot, sub_cache)
        self._set_length(slot, n)

    # ---- slot KV copy-out / restore (P/D handoff) ----
    def _export_slot(self, slot: int, length: int, to_host: bool = True,
                     all_heads: bool = False) -> dict:
        """Copy a slot's KV out in the JAX package's contiguous layout:
        per attending stage ``{"k", "v"}`` of ``(layers, blen, KV_e, dh)``
        with ``blen`` the bucketed length (capped at ``max_len``) and
        ``KV_e`` the engine's KV heads (``_kv_heads`` says which),
        gathered through the slot's table row, and beside them the slot's
        recurrent state leaves under ``Model.state_leaves``' names, batch
        axis removed.  Rows past the pages in use come from the slot's
        scratch page (finite, never read back).  ``to_host=True`` copies
        the payload to host memory.  ``all_heads=True`` at tp > 1
        all-gathers every KV head and the whole recurrent state over the
        group (collectives: every rank calls it for the same slot), for a
        decode engine of another tp; without it a rank's state part is
        tagged ``_state_rank`` ``(rank, tp)``."""
        blen = min(_bucket(length), self.max_len)
        ps = self.page_size
        npg = min(-(-blen // ps), self._maxp)
        pages = self.cache["block_table"][slot, :npg].long()
        lo, hi, KV = self.kv_range
        gather = all_heads and hi - lo < KV
        out = {}
        for key, pools in self.model.attention_caches(self.cache):
            kv = {}
            for name in ("k", "v"):
                pool = pools[f"{name}_pages"][:, pages]
                t = pool.reshape((pool.shape[0], npg * ps)
                                 + pool.shape[3:])[:, :blen]
                if self.group is not None:       # each KV head once
                    from repro_torch.launch.sharding import from_slots
                    t = from_slots(t, self.cfg, self.group.rank, self.tp)
                t = t.contiguous()
                if gather:
                    t = self._gather_heads(t)
                kv[name] = t.cpu() if to_host else t.to(self.device)
            out[key] = kv
        leaves = self.model.state_leaves(self.cache)
        for key, name, t, ax in leaves:
            # a copy, also on the CPU: the slot's state moves on; whole
            # (tp = 1's layout) for a decode engine of another tp
            one = t.select(ax, slot)
            if self.group is not None and all_heads:
                one = self._gather_state(one, name)
            out.setdefault(key, {})[name] = one.to(
                "cpu" if to_host else self.device, copy=True)
        out["_length"] = length
        out["_length_bucket"] = blen
        out["_kv_heads"] = (0, KV, KV) if gather else self.kv_range
        if leaves and self.group is not None and not all_heads:
            out["_state_rank"] = (self.group.rank, self.tp)
        return out

    def _gather_heads(self, t: torch.Tensor) -> torch.Tensor:
        """Every KV head of a ``(layers, blen, KV_e, dh)`` payload over the
        group, each once (a collective): each rank's KV heads (ranks read
        different counts, or none, where the heads do not divide tp),
        gathered, each head taken from its owner
        (``sharding.gather_kv_heads``)."""
        from repro_torch.launch.sharding import gather_kv_heads, kv_heads
        counts = [hi - lo for lo, hi in (kv_heads(self.cfg, r, self.tp)
                                         for r in range(self.tp))]
        return gather_kv_heads(self._gather_parts(t, 2, counts), self.cfg,
                               self.tp)

    def _gather_parts(self, t: torch.Tensor, dim: int, widths) -> list:
        """Every rank's ``t`` (``widths[r]`` wide along ``dim``), in rank
        order, through the host under gloo (``collectives.gather_parts``
        over ``group.all_gather``)."""
        from repro_torch.launch.collectives import gather_parts
        return gather_parts(t, self.group, widths, dim,
                            self.group.all_gather)

    def _gather_state(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """A slot's state leaf ``name`` whole from every rank's part (a
        collective): the parts gathered along the head dim and put in
        place (``sharding.gather_state``)."""
        from repro_torch.launch.sharding import gather_state, state_pieces
        dim = state_pieces(self.cfg, name, 0, self.tp)[0] % t.dim()
        widths = [sum(hi - lo for lo, hi in state_pieces(
            self.cfg, name, r, self.tp)[1]) for r in range(self.tp)]
        return gather_state(self._gather_parts(t, dim, widths), self.cfg,
                            name, self.tp)

    def _restore_slot(self, slot: int, kv: dict, length: int):
        """Scatter an ``_export_slot`` payload through ``slot``'s freshly
        allocated table row, copy its state leaves into the slot and set
        its length.  Pages are allocated for ``length`` tokens; payload
        rows past them land on the slot's own scratch page.  A payload of
        every KV head restores the engine's own (an untagged payload, the
        JAX package's, holds every head); one of other heads than the
        engine's raises."""
        lo, hi, KV = self.kv_range
        heads = tuple(kv.get("_kv_heads", (0, KV, KV)))
        own = heads == self.kv_range
        if not own and heads != (0, KV, KV):
            raise ValueError(
                f"ServingEngine {self.name!r}: a payload of KV heads "
                f"[{heads[0]}, {heads[1]}) of {heads[2]} does not restore "
                f"into pools of heads [{lo}, {hi}) of {KV}; only this "
                f"engine's heads or every head do")
        part = kv.get("_state_rank")
        me = None if self.group is None else (self.group.rank, self.tp)
        if part is not None and tuple(part) != me:
            raise ValueError(
                f"ServingEngine {self.name!r}: the recurrent state part of "
                f"(rank, tp) {tuple(part)} does not restore into {me}; "
                f"only this rank's part or the whole state does")
        blen = kv["_length_bucket"]
        self.ensure_capacity(slot, length)
        row = self.cache["block_table"][slot].long()
        pos = torch.arange(blen, device=self.device)
        page = row[pos // self.page_size]
        off = pos % self.page_size
        for key, pools in self.model.attention_caches(self.cache):
            for name in ("k", "v"):
                t = kv[key][name]
                if self.group is not None:
                    from repro_torch.launch.sharding import (take_kv_heads,
                                                             to_slots)
                    if not own:
                        t = take_kv_heads(t, self.cfg, self.group.rank,
                                          self.tp)
                    t = to_slots(t, self.cfg, self.group.rank, self.tp)
                pools[f"{name}_pages"][:, page, off] = t.to(self.device)
        for key, name, t, ax in self.model.state_leaves(self.cache):
            one = kv[key][name]
            if self.group is not None and part is None:  # the rank's heads
                from repro_torch.launch.sharding import take_state
                one = take_state(one, self.cfg, name, self.group.rank,
                                 self.tp)
            t.select(ax, slot).copy_(one)
        self._set_length(slot, length)
