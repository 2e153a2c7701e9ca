"""Radix-tree prefix cache (RadixAttention-style) with multi-tier eviction.

Paper §II-D: each request does a longest-prefix match; hits insert
memory-transfer events (if the blocks live in a lower tier) instead of
prefill compute; after prefill the new prefix is inserted; capacity pressure
evicts leaves down a real HBM -> host -> SSD hierarchy (``PrefixCacheCfg.
host_spill`` / ``ssd_spill``) instead of discarding, with per-tier byte
accounting against the instance's ``MemoryModel`` pools.  Victim selection
is pluggable (``PrefixCacheCfg.eviction_policy``): ``lru``, ``lfu`` and
``priority`` ship registered; :func:`register_eviction_policy` adds more.

Every tier move is recorded as a pending transfer the runtime settles to
the execution backend (``RuntimeInstance._settle_cache``): the simulator
prices it through ``MemoryModel.transfer_time`` + the ``kv_export`` trace
rows, the real ``JaxBackend`` actually moves the stored KV payload
(device jax array -> host numpy -> disk file) so the cost is measured.
Routing probes use :meth:`RadixPrefixCache.peek` — read-only, so candidate
scans never pollute hit-rate metrics or eviction recency.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Type

from repro_torch.core.config import PrefixCacheCfg
from repro_torch.core.memory import MemoryModel

#: tier order, hottest first; eviction demotes one step down this chain
#: (skipping disabled tiers) and promotion moves straight back to device
TIERS = ("device", "host", "ssd")
_RANK = {t: i for i, t in enumerate(TIERS)}


class _Node:
    __slots__ = ("key", "children", "parent", "tokens", "tier",
                 "last_access", "accesses", "priority", "ref_count",
                 "node_id")
    _ids = itertools.count()

    def __init__(self, key: Tuple[int, ...], parent: Optional["_Node"]):
        self.key = key                  # token block (length <= block_tokens)
        self.children: Dict[int, "_Node"] = {}
        self.parent = parent
        self.tokens = len(key)
        self.tier = "device"
        self.last_access = 0.0
        self.accesses = 0               # lifetime hit count (LFU signal)
        self.priority = 0               # max tenant priority that touched it
        self.ref_count = 0              # pinned by running requests
        self.node_id = next(self._ids)


@dataclasses.dataclass
class MatchResult:
    tokens: int                      # matched prefix length (tokens)
    device_tokens: int               # portion already in device HBM
    lower_tier_bytes: float          # bytes to fetch from host/ssd
    host_tokens: int = 0             # portion resident in host RAM
    ssd_tokens: int = 0              # portion resident on SSD
    nodes: List[_Node] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# eviction-policy registry
# ---------------------------------------------------------------------------

class EvictionPolicy:
    """Victim selection for one eviction: the candidate with the SMALLEST
    ``victim_key`` is evicted first.  Candidates are always unpinned leaf
    nodes of the tier under pressure; ``node_id`` tie-breaks keep the
    choice deterministic (and therefore fast==exact bit-identical)."""
    name = "base"

    def victim_key(self, node: _Node, now: float):
        raise NotImplementedError


_EVICTION_POLICIES: Dict[str, Type[EvictionPolicy]] = {}


def register_eviction_policy(cls: Type[EvictionPolicy]):
    """Make an ``EvictionPolicy`` subclass available (by its ``name``) to
    every ``PrefixCacheCfg``; returns the class (decorator-friendly)."""
    _EVICTION_POLICIES[cls.name] = cls
    return cls


def eviction_policies() -> Tuple[str, ...]:
    return tuple(sorted(_EVICTION_POLICIES))


@register_eviction_policy
class LRUEviction(EvictionPolicy):
    name = "lru"

    def victim_key(self, node, now):
        return (node.last_access, node.node_id)


@register_eviction_policy
class LFUEviction(EvictionPolicy):
    """Least-frequently-used, recency tie-broken: one-shot prefixes evict
    before reused ones even when the reused prefix is momentarily older."""
    name = "lfu"

    def victim_key(self, node, now):
        return (node.accesses, node.last_access, node.node_id)


@register_eviction_policy
class PriorityWeightedEviction(EvictionPolicy):
    """Priority-weighted LRU: blocks only ever touched by low-priority
    tenants evict before any high-priority tenant's, recency within a
    priority class."""
    name = "priority"

    def victim_key(self, node, now):
        return (node.priority, node.last_access, node.node_id)


def node_prefix(node: _Node) -> Tuple[int, ...]:
    """Full token prefix from the root through ``node`` (inclusive) — the
    payload key the real backend's KV store is addressed by."""
    parts = []
    while node is not None and node.parent is not None:
        parts.append(node.key)
        node = node.parent
    return tuple(t for key in reversed(parts) for t in key)


class RadixPrefixCache:
    """Block-granular radix tree over token-id sequences.

    The runtime owns the *policy* (what is matched, inserted, pinned,
    promoted, evicted — per-instance or shared ``scope="global"``);
    backends own the *payloads*: the simulator prices restore/fetch costs
    from the trace (``kv_export``), while ``JaxBackend`` keeps real KV
    slices keyed by prefix and restores them on a hit so only the suffix
    runs ``extend``.  Capacity borrows idle KV-pool blocks from the
    instance's ``MemoryModel``; under pressure the configured eviction
    policy demotes leaves device -> host -> SSD -> drop, with every tier's
    bytes accounted against the matching ``MemoryModel`` pool (the
    invariant ``n_host_blocks * bytes_per_block == mem.host.used`` holds
    at every quiescent point, ditto SSD).  Running requests ``pin``/
    ``unpin`` their matched nodes so shared prefixes are never evicted
    mid-flight.
    """

    def __init__(self, cfg: PrefixCacheCfg, mem: MemoryModel,
                 name: str = "cache"):
        self.cfg = cfg
        self.mem = mem
        self.name = name
        self.root = _Node((), None)
        self.block = cfg.block_tokens
        self.n_device_blocks = 0
        self.n_host_blocks = 0
        self.n_ssd_blocks = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.capacity_blocks = mem.cache_capacity_blocks(
            cfg.capacity_fraction)
        policy = getattr(cfg, "eviction_policy", "lru")
        if policy not in _EVICTION_POLICIES:
            raise ValueError(
                f"unknown eviction policy {policy!r}; registered: "
                f"{sorted(_EVICTION_POLICIES)}")
        self.policy = _EVICTION_POLICIES[policy]()
        # per-tier matched tokens (accounting matches only: peek is free)
        self.tier_hit_tokens: Dict[str, int] = {t: 0 for t in TIERS}
        # cumulative tier moves: "device->host", "host->ssd", promotes
        # ("host->device", "ssd->device") and drops ("<tier>->drop")
        self.tier_transfers: Dict[str, Dict[str, float]] = {}
        # tier moves since the last settle — drained by the runtime and
        # handed to the backend (sim prices them, JaxBackend executes the
        # real payload move); entries are (src, dst, n_bytes, full_prefix)
        self._pending_transfers: List[Tuple[str, str, float,
                                            Tuple[int, ...]]] = []

    # ---- lookup ----
    def _walk(self, tokens: Sequence[int]) -> List[_Node]:
        node = self.root
        matched: List[_Node] = []
        i = 0
        n = len(tokens)
        while i + self.block <= n:
            blk = tuple(tokens[i: i + self.block])
            child = node.children.get(hash(blk))
            if child is None or child.key != blk:
                break
            matched.append(child)
            node = child
            i += self.block
        return matched

    def _result(self, matched: List[_Node]) -> MatchResult:
        dev = host = ssd = 0
        for nd in matched:
            if nd.tier == "device":
                dev += nd.tokens
            elif nd.tier == "host":
                host += nd.tokens
            else:
                ssd += nd.tokens
        return MatchResult(
            tokens=sum(nd.tokens for nd in matched), device_tokens=dev,
            lower_tier_bytes=(host + ssd) * self.mem.kv_bytes_per_token,
            host_tokens=host, ssd_tokens=ssd, nodes=matched)

    def match(self, tokens: Sequence[int], now: float,
              priority: int = 0) -> MatchResult:
        """Longest-prefix match THAT ACCOUNTS: bumps hit/miss counters,
        per-tier hit tokens, recency/frequency/priority on every matched
        node.  Exactly one call per dispatched request (the instance's
        ``submit``); routing probes must use :meth:`peek` instead."""
        matched = self._walk(tokens)
        for nd in matched:
            nd.last_access = now
            nd.accesses += 1
            if priority > nd.priority:
                nd.priority = priority
        if matched:
            self.hits += 1
        else:
            self.misses += 1
        res = self._result(matched)
        self.tier_hit_tokens["device"] += res.device_tokens
        self.tier_hit_tokens["host"] += res.host_tokens
        self.tier_hit_tokens["ssd"] += res.ssd_tokens
        return res

    def peek(self, tokens: Sequence[int]) -> MatchResult:
        """Read-only longest-prefix probe for routing policies: identical
        match semantics to :meth:`match` but touches NO state — no hit/miss
        counters, no recency/frequency bumps — so probing M candidates per
        request leaves accounting and eviction order exactly as if only
        the chosen instance had been consulted."""
        return self._result(self._walk(tokens))

    def pin(self, nodes: List[_Node]):
        for nd in nodes:
            nd.ref_count += 1

    def unpin(self, nodes: List[_Node]):
        for nd in nodes:
            nd.ref_count = max(0, nd.ref_count - 1)

    # ---- insertion ----
    def insert(self, tokens: Sequence[int], now: float,
               priority: int = 0) -> int:
        """Insert prefix blocks; returns #blocks newly placed on device.

        The chain being inserted is temporarily pinned so the evictions a
        reservation triggers can only hit *other* subtrees — the old code
        attached the child before reserving, letting the eviction scan
        select the not-yet-counted node itself (last_access 0.0 made it
        the LRU victim) and corrupt every tier counter."""
        node = self.root
        i = 0
        new_blocks = 0
        n = len(tokens)
        path: List[_Node] = []
        try:
            while i + self.block <= n:
                blk = tuple(tokens[i: i + self.block])
                child = node.children.get(hash(blk))
                if child is None or child.key != blk:
                    child = _Node(blk, node)
                    if not self._reserve_device_block(now):
                        break
                    node.children[hash(blk)] = child
                    new_blocks += 1
                    self.n_device_blocks += 1
                child.last_access = now
                if priority > child.priority:
                    child.priority = priority
                child.ref_count += 1
                path.append(child)
                node = child
                i += self.block
        finally:
            for nd in path:
                nd.ref_count -= 1
        return new_blocks

    def promote(self, nodes: List[_Node], now: float):
        """Bring lower-tier nodes back to device (caller pays transfer —
        the simulator prices the fetch in ``on_prefix_hit``, the real
        backend re-devices the stored payload at settle time)."""
        bpb = self.mem.bytes_per_block
        for nd in nodes:
            if nd.tier == "device":
                continue
            if not self._reserve_device_block(now):
                continue
            src = nd.tier
            if src == "host":
                self.n_host_blocks -= 1
            else:
                self.n_ssd_blocks -= 1
            # the lower-tier copy is released with the move: without this
            # the host pool leaks until host_spill permanently fails
            self.mem.tier_release(src, bpb)
            nd.tier = "device"
            self.n_device_blocks += 1
            self._record(src, "device", bpb, nd)

    # ---- eviction ----
    def _reserve_device_block(self, now: float) -> bool:
        if self.n_device_blocks >= self.capacity_blocks or \
                not self.mem.borrow_for_cache(1):
            if not self._evict_one(now):
                return False
            return self.mem.borrow_for_cache(1)
        return True

    def _victim(self, tier: str) -> Optional[_Node]:
        """Policy-selected unpinned node of ``tier`` with no child at its
        own tier or hotter.  Plain leaves qualify, but so does an
        interior node whose subtree has already spilled past it —
        demoting it keeps every child at-or-below its parent's
        temperature.  Restricting victims to strict leaves instead jams
        the cache: once a chain's tail spills, its interior device
        blocks become permanently unreclaimable and inserts start
        failing while lower tiers sit empty."""
        rank = _RANK[tier]
        best = None
        best_key = None
        stack = [self.root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if nd is self.root or nd.ref_count > 0 or nd.tier != tier:
                continue
            if any(_RANK[c.tier] <= rank for c in nd.children.values()):
                continue
            key = self.policy.victim_key(nd, 0.0)
            if best is None or key < best_key:
                best, best_key = nd, key
        return best

    def _evict_one(self, now: float) -> bool:
        """Free one DEVICE block: demote the policy's device victim to
        host (then SSD, then drop, per config), evicting lower tiers as
        needed to make room — so sustained pressure cascades device ->
        host -> SSD -> drop instead of silently leaking the host pool."""
        victim = self._victim("device")
        if victim is None:
            return False
        self.evictions += 1
        self.n_device_blocks -= 1
        self.mem.return_from_cache(1)
        self._demote(victim, "device")
        return True

    def _evict_lower(self, tier: str) -> bool:
        """Free one block of a LOWER tier (host/ssd) by demoting its
        policy victim one step further down the chain."""
        victim = self._victim(tier)
        if victim is None:
            return False
        if tier == "host":
            self.n_host_blocks -= 1
        else:
            self.n_ssd_blocks -= 1
        self.mem.tier_release(tier, self.mem.bytes_per_block)
        self._demote(victim, tier)
        return True

    def _demote(self, victim: _Node, src: str):
        """Move an already-released ``src``-tier victim one tier down:
        host for device victims (when enabled), SSD for host victims
        (when enabled), dropping when the next tier is disabled or cannot
        be freed up.  Lower-tier space is made by recursively evicting
        that tier's own victims — each recursion strictly descends the
        tier chain, so it terminates."""
        bpb = self.mem.bytes_per_block
        if src == "device" and self.cfg.host_spill:
            while not self.mem.tier_reserve("host", bpb):
                if not self._evict_lower("host"):
                    break
            else:
                victim.tier = "host"
                self.n_host_blocks += 1
                self._record("device", "host", bpb, victim)
                return
        if src in ("device", "host") and getattr(self.cfg, "ssd_spill",
                                                 False):
            while not self.mem.tier_reserve("ssd", bpb):
                if not self._evict_lower("ssd"):
                    break
            else:
                victim.tier = "ssd"
                self.n_ssd_blocks += 1
                self._record(src, "ssd", bpb, victim)
                return
        self._drop(victim, src)

    def _drop(self, victim: _Node, src: str):
        """Detach ``victim``'s subtree.  The victim's own device/tier
        accounting was already released by the caller; descendants (all
        strictly colder — victim selection guarantees it — and never
        pinned, since pins cover whole root paths) release theirs here.
        """
        parent = victim.parent
        if parent:
            parent.children.pop(hash(victim.key), None)
        bpb = self.mem.bytes_per_block
        self._record(src, "drop", bpb, victim)
        stack = list(victim.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if nd.tier == "host":
                self.n_host_blocks -= 1
            else:
                self.n_ssd_blocks -= 1
            self.mem.tier_release(nd.tier, bpb)
            self._record(nd.tier, "drop", bpb, nd)

    def _record(self, src: str, dst: str, n_bytes: float, node: _Node):
        key = f"{src}->{dst}"
        t = self.tier_transfers.setdefault(key, {"blocks": 0, "bytes": 0.0})
        t["blocks"] += 1
        t["bytes"] += n_bytes
        self._pending_transfers.append(
            (src, dst, n_bytes, node_prefix(node)))

    def take_transfers(self) -> List[Tuple[str, str, float,
                                           Tuple[int, ...]]]:
        """Drain tier moves recorded since the last settle.  The runtime
        calls this right after every cache-mutating operation and hands
        the moves to the instance's backend, so the instance that caused
        a spill is the one that pays for (sim) or performs (real) it."""
        pending, self._pending_transfers = self._pending_transfers, []
        return pending

    def release_pressure(self, blocks_needed: int, now: float) -> int:
        """Evict until ``blocks_needed`` device blocks were freed."""
        freed = 0
        while freed < blocks_needed and self._evict_one(now):
            freed += 1
        return freed

    # ---- accounting ----
    def check_invariants(self):
        """Tier accounting invariants, asserted by the regression suite:
        per-tier node counts match the counters, and every lower tier's
        byte pool holds exactly ``blocks * bytes_per_block``."""
        counts = {t: 0 for t in TIERS}
        stack = [self.root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if nd is not self.root:
                counts[nd.tier] += 1
        bpb = self.mem.bytes_per_block
        assert counts["device"] == self.n_device_blocks, \
            (counts, self.n_device_blocks)
        assert counts["host"] == self.n_host_blocks, \
            (counts, self.n_host_blocks)
        assert counts["ssd"] == self.n_ssd_blocks, (counts, self.n_ssd_blocks)
        assert self.n_host_blocks * bpb == self.mem.host.used, \
            (self.n_host_blocks, bpb, self.mem.host.used)
        assert self.n_ssd_blocks * bpb == self.mem.ssd.used, \
            (self.n_ssd_blocks, bpb, self.mem.ssd.used)
        assert self.mem.host.used <= self.mem.host.capacity
        assert self.mem.ssd.used <= self.mem.ssd.capacity

    def residency(self) -> Dict[str, int]:
        return {"device": self.n_device_blocks, "host": self.n_host_blocks,
                "ssd": self.n_ssd_blocks}

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "device_blocks": self.n_device_blocks,
                "host_blocks": self.n_host_blocks,
                "ssd_blocks": self.n_ssd_blocks,
                "evictions": self.evictions,
                "eviction_policy": self.policy.name}
