"""Tensor-parallel sharding rules: one rank's shard of a full param dict.

The counterpart of the JAX package's ``repro/launch/sharding.py`` rules
(``_COL``, ``_ROW``, ``_REPL`` and the embed, head and MoE cases of
``_param_spec``).  JAX hands those rules to GSPMD as PartitionSpecs; the
port runs explicit Megatron-style tensor parallelism, so each rank cuts
its own slice out of the full params in the JAX layout
(:func:`shard_params`) and uploads only that:

* column-parallel (the last dim split, contiguous per rank): ``wq``,
  ``wk``, ``wv`` (and their biases), ``w_gate``, ``w_up``, ``w_in``;
* row-parallel (dim -2 split): ``wo``, ``w_down``, ``w_out``; their
  outputs are partial sums, all-reduced by the model;
* vocab-parallel: the head's padded vocab, all-gathered by the model; a
  padded vocab that does not divide by tp leaves the head replicated (as
  ``fit_to_mesh`` replicates a dim that does not divide the mesh axis);
* replicated: the norms, the router, and the embedding table.  JAX shards
  the table's rows; here it stays whole (1.05 GB a rank for llama3.1-8b in
  bf16), which keeps the lookup free of a collective and computes the same
  function;
* MoE experts: expert parallelism when the expert count divides tp (each
  rank holds E / tp whole experts), otherwise tensor parallelism inside
  every expert (``w_gate``/``w_up`` column-, ``w_down`` row-parallel), the
  JAX rule's two branches.

**One deviation from GSPMD.**  When the KV heads do not divide tp, GSPMD
shards the KV cache's ``d_head`` instead (``cache_pspecs``).  Explicit TP
cannot split ``d_head`` without one more reduction inside attention, so
here each rank keeps the KV heads its query heads read (their K/V
projections and their pages are then computed and held on more than one
rank).  The query heads must split evenly, and a rank's query heads must
cover whole groups or lie inside one group, so the group size is the same
on every rank.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

_COL = {"wq", "wk", "wv", "bq", "bk", "bv", "w_gate", "w_up", "w_in"}
_ROW = {"wo", "w_down", "w_out"}
_KV = {"wk", "wv", "bk", "bv"}


def query_heads(cfg: ArchConfig, rank: int, tp: int) -> Tuple[int, int]:
    """The query heads ``[lo, hi)`` of ``rank``."""
    H = cfg.n_heads
    if H % tp:
        raise ValueError(f"{cfg.name}: {H} query heads do not split over "
                         f"tp={tp}")
    n = H // tp
    return rank * n, (rank + 1) * n


def kv_heads(cfg: ArchConfig, rank: int, tp: int) -> Tuple[int, int]:
    """The KV heads ``[lo, hi)`` that ``rank``'s query heads read: an even
    split when the KV heads divide tp, else the group(s) its query heads
    fall in (the deviation in the module docstring)."""
    KV = cfg.n_kv_heads
    lo, hi = query_heads(cfg, rank, tp)
    G = cfg.n_heads // KV
    n = hi - lo
    if n % G and G % n:
        raise ValueError(
            f"{cfg.name}: {n} query heads a rank at tp={tp} neither cover "
            f"whole groups of {G} nor lie inside one")
    return lo // G, (hi - 1) // G + 1


def owned_kv_heads(cfg: ArchConfig, rank: int, tp: int) -> Tuple[int, int]:
    """The KV heads ``[lo, hi)`` that ``rank`` owns: those of
    :func:`kv_heads` that no lower rank holds, so that over the ranks every
    KV head is owned once (a head held by several ranks, where the KV heads
    do not divide tp, belongs to the lowest).  Counting a payload's bytes
    by owned heads gives the group the tp = 1 payload's size."""
    lo, hi = kv_heads(cfg, rank, tp)
    if rank > 0:
        lo = max(lo, kv_heads(cfg, rank - 1, tp)[1])
    return lo, max(lo, hi)


def gather_kv_heads(parts, cfg: ArchConfig, tp: int) -> torch.Tensor:
    """The full ``(layers, blen, KV, dh)`` payload from every rank's
    ``(layers, blen, KV_r, dh)`` one (``parts``, in rank order): each
    rank's owned heads (:func:`owned_kv_heads`), concatenated, so a head
    that several ranks hold appears once."""
    out = []
    for rank, part in enumerate(parts):
        lo, _ = kv_heads(cfg, rank, tp)
        olo, ohi = owned_kv_heads(cfg, rank, tp)
        out.append(part.narrow(2, olo - lo, ohi - olo))
    return torch.cat(out, dim=2)


def take_kv_heads(full: torch.Tensor, cfg: ArchConfig, rank: int,
                  tp: int) -> torch.Tensor:
    """``rank``'s heads (:func:`kv_heads`: every head it reads, a shared
    one included) of a full ``(layers, blen, KV, dh)`` payload; a view."""
    lo, hi = kv_heads(cfg, rank, tp)
    return full.narrow(2, lo, hi - lo)


def experts_parallel(cfg: ArchConfig, tp: int) -> bool:
    """Expert parallelism when the experts divide tp (the JAX rule)."""
    return cfg.moe is not None and cfg.moe.n_experts % tp == 0


def head_parallel(cfg: ArchConfig, tp: int) -> bool:
    return cfg.padded_vocab % tp == 0


def _split(leaf, dim: int, lo: int, hi: int):
    """A fresh copy of ``leaf[..., lo:hi, ...]`` along ``dim``: the shard
    never keeps the full tensor's storage alive."""
    idx = [slice(None)] * leaf.ndim
    idx[dim] = slice(lo, hi)
    part = leaf[tuple(idx)]
    if isinstance(part, torch.Tensor):
        return part.clone(memory_format=torch.contiguous_format)
    return np.array(part, order="C")


def _even(leaf, dim: int, rank: int, tp: int, what: str):
    n = leaf.shape[dim]
    if n % tp:
        raise ValueError(f"{what}: dim {dim} of size {n} does not split "
                         f"over tp={tp}")
    step = n // tp
    return _split(leaf, dim, rank * step, (rank + 1) * step)


def shard_params(params: dict, rank: int, tp: int, *,
                 cfg: ArchConfig) -> dict:
    """Rank ``rank``'s shard of ``params`` (a nested dict of numpy arrays
    or tensors in the JAX layout) at tensor-parallel degree ``tp``.  Split
    leaves are fresh copies; replicated leaves are the inputs themselves.
    ``tp == 1`` returns ``params``."""
    if tp == 1:
        return params
    dh = cfg.d_head
    qlo, qhi = query_heads(cfg, rank, tp)
    klo, khi = kv_heads(cfg, rank, tp)
    ep = experts_parallel(cfg, tp)

    def leaf_shard(path, leaf):
        name = path[-1]
        where = "/".join(path)
        if path[0] == "embed":
            return leaf
        if path[0] == "head":
            return _even(leaf, -1, rank, tp, where) \
                if head_parallel(cfg, tp) else leaf
        if "moe" in path and name in ("w_gate", "w_up", "w_down"):
            if ep:
                return _even(leaf, -3, rank, tp, where)
            return _even(leaf, -1 if name != "w_down" else -2, rank, tp,
                         where)
        if name in ("wq", "bq"):
            return _split(leaf, -1, qlo * dh, qhi * dh)
        if name in _KV:
            return _split(leaf, -1, klo * dh, khi * dh)
        if name == "wo":
            return _split(leaf, -2, qlo * dh, qhi * dh)
        if name in _COL:
            return _even(leaf, -1, rank, tp, where)
        if name in _ROW:
            return _even(leaf, -2, rank, tp, where)
        return leaf                    # norms, the router: replicated

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return leaf_shard(path, tree)

    return walk(params, ())
