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
``_restore_slot``, the P/D handoff) in the JAX package's contiguous payload
layout; ``role`` ("unified" | "prefill" | "decode") is only stored, as in
JAX.  Prefix caching, tensor parallelism and speculative decoding are not
ported yet; asking for any of them raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import Model
from repro_torch.models.transformer import cast_params, torch_dtype


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


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
    values.
    """

    def __init__(self, cfg: ArchConfig, params=None, *, max_batch: int = 8,
                 max_len: int = 512, prefix_cache: bool = False,
                 role: str = "unified", name: str = "engine0", seed: int = 0,
                 tp: int = 1, routing=None, spec=None, device=None):
        for asked, what in ((prefix_cache, "prefix_cache=True"),
                            (int(tp) != 1, f"tp={tp}"),
                            (spec is not None, "spec=")):
            if asked:
                raise NotImplementedError(
                    f"ServingEngine: {what} is not ported yet (ROADMAP "
                    f"queue 1)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.name = name
        self.role = role
        self.tp = 1
        self.radix = None
        self.spec = None
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
        self.model = Model(cfg, page_size=self.page_size, routing_hook=hook)
        dtype = torch_dtype(cfg.compute_dtype)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, device=self.device, dtype=dtype)
        self.params = cast_params(params, dtype, self.device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.cache = self.model.init_cache(max_batch, max_len,
                                           device=self.device)
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

    def tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def synchronize(self):
        """Wait for the device, so a wall-clock time covers its work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, buckets=(16, 32, 64, 128, 256)):
        """Run prefill at every bucket and one decode, so the first
        measured iteration pays no one-time cost (library handles, the
        kernels' build and load).  Decode writes land on the scratch pages
        of free slots and its returned cache is dropped."""
        for P in buckets:
            if P >= self.max_len:
                continue
            pad = torch.zeros((1, P), dtype=torch.int32, device=self.device)
            self.model.prefill(self.params, pad, lengths=self.tensor([P]))
        self.model.decode(self.params, self.cache,
                          self.tensor(self._tokens_buf))
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

    def _write_slot_from_prefill(self, slot: int, cache1, n: int):
        """Scatter a (B=1) prefill cache through ``slot``'s table row;
        pad-tail positions past the table go to the last page."""
        P = cache1["stage0"]["k"].shape[2]
        self.ensure_capacity(slot, min(P, self.max_len))
        row = self.cache["block_table"][slot].long()
        pos = torch.arange(P, device=self.device)
        pidx = pos // self.page_size
        page = row[torch.clamp(pidx, max=self._maxp - 1)]
        page = torch.where(pidx < self._maxp, page,
                           torch.full_like(page, self._scratch))
        off = pos % self.page_size
        for key, stage in self.cache.items():
            if key in ("lengths", "block_table"):
                continue
            stage["k_pages"][:, page, off] = cache1[key]["k"][:, 0]
            stage["v_pages"][:, page, off] = cache1[key]["v"][:, 0]
        self._set_length(slot, n)

    def _slot_subcache(self, slot: int, length: int):
        """A (B=1) view of one slot: the shared pools and a one-row table,
        with the given length.  ``extend`` on it writes the slot's pages."""
        sub = {"lengths": self.tensor([length]),
               "block_table": self.cache["block_table"][slot: slot + 1]}
        for key, stage in self.cache.items():
            if key not in ("lengths", "block_table"):
                sub[key] = stage
        return sub

    def _write_slot(self, slot: int, sub_cache, n: int):
        """Adopt an ``extend`` on a subcache: its writes are already in
        the shared pools, so only the slot's length changes."""
        self._set_length(slot, n)

    # ---- slot KV copy-out / restore (P/D handoff) ----
    def _export_slot(self, slot: int, length: int,
                     to_host: bool = True) -> dict:
        """Copy a slot's KV out in the JAX package's contiguous layout:
        per stage ``{"k", "v"}`` of ``(layers, blen, KV, dh)`` with ``blen``
        the bucketed length (capped at ``max_len``), gathered through the
        slot's table row.  Rows past the pages in use come from the slot's
        scratch page (finite, never read back).  ``to_host=True`` copies
        the payload to host memory."""
        blen = min(_bucket(length), self.max_len)
        ps = self.page_size
        npg = min(-(-blen // ps), self._maxp)
        pages = self.cache["block_table"][slot, :npg].long()
        out = {}
        for key, stage in self.cache.items():
            if key in ("lengths", "block_table"):
                continue
            kv = {}
            for name in ("k", "v"):
                pool = stage[f"{name}_pages"][:, pages]
                t = pool.reshape((pool.shape[0], npg * ps)
                                 + pool.shape[3:])[:, :blen].contiguous()
                kv[name] = t.cpu() if to_host else t
            out[key] = kv
        out["_length"] = length
        out["_length_bucket"] = blen
        return out

    def _restore_slot(self, slot: int, kv: dict, length: int):
        """Scatter an ``_export_slot`` payload through ``slot``'s freshly
        allocated table row and set its length.  Pages are allocated for
        ``length`` tokens; payload rows past them land on the slot's own
        scratch page."""
        blen = kv["_length_bucket"]
        self.ensure_capacity(slot, length)
        row = self.cache["block_table"][slot].long()
        pos = torch.arange(blen, device=self.device)
        page = row[pos // self.page_size]
        off = pos % self.page_size
        for key, stage in self.cache.items():
            if key in ("lengths", "block_table"):
                continue
            for name in ("k", "v"):
                stage[f"{name}_pages"][:, page, off] = \
                    kv[key][name].to(self.device)
        self._set_length(slot, length)
