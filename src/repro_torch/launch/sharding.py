"""Sharding rules: one rank's shard of the params, the optimizer state
and the batch on a (data, model) grid.

The counterpart of the JAX package's ``repro/launch/sharding.py``
(``param_pspecs``, ``state_pspecs``, ``batch_pspecs``, ``fit_to_mesh``).
JAX hands those rules to GSPMD as PartitionSpecs; the port runs explicit
Megatron-style tensor parallelism, so each rank cuts its own slice out of
the full params in the JAX layout (:func:`shard_params`) and uploads only
that:

* column-parallel (the last dim split, contiguous per rank): ``wq``,
  ``wk``, ``wv`` (and their biases), ``w_gate``, ``w_up``, ``w_in``; the
  fused ``wqkv`` strided: the rank's query heads' columns, then its KV
  heads' K and V columns (where a KV head has several readers only those
  K and V columns are summed over them in training, never the query
  columns);
* row-parallel (dim -2 split): ``wo``, ``w_down``, ``w_out``; their
  outputs are partial sums, all-reduced by the model;
* vocab-parallel: the embedding table's rows (JAX's ``P(MODEL, None)``:
  the lookup is a masked local gather plus one all-reduce, a sum of exact
  zeros and one row) and the head's padded vocab (all-gathered by the
  model); a padded vocab that does not divide by tp leaves both
  replicated (as ``fit_to_mesh`` replicates a dim that does not divide
  the mesh axis);
* replicated: the norms and the router;
* MoE experts: expert parallelism when the expert count divides tp (each
  rank holds E / tp whole experts), otherwise tensor parallelism inside
  every expert (``w_gate``/``w_up`` column-, ``w_down`` row-parallel), the
  JAX rule's two branches; under ``shard_experts`` (the JAX model's
  placement hint, every function here takes the flag) the third layout:
  every expert whole on one rank in GSPMD's padded layout
  (:func:`expert_range`: ceil(E / tp) a rank from rank 0, a later rank
  fewer or none, ``(0, d, f)`` leaves), whatever E and ``d_expert``; where
  E divides tp it is the expert-parallel layout.  An expert leaf then
  lives on one rank: no gradient sum over the model axis.

**A decode cache's sequence** splits over a group as JAX's
``cache_pspecs`` splits it (over ``data`` for a batch of one, over
``model`` under ``seq_shard_cache``; ``RankGrid.seq_group``): rank r of
n holds tokens :func:`seq_range` of every sequence (ceil(S / n) a rank
from rank 0), and :func:`take_seq_pages` / :func:`gather_seq_pages` move a
whole cache's pools to a rank's and back.

ZeRO-1 (:func:`zero1_dim`, JAX's ``state_pspecs(zero1=True)``): each Adam
moment leaf is further split over the ``data`` axis on its first dim that
the model rule does not name and that divides by the data extent (JAX
hard-codes 16, the extent of its meshes, and never splits over ``pod``).
:func:`shard_batch` gives a data-parallel rank its rows (JAX's
``batch_pspecs`` and the train step's microbatch split).
:func:`leaf_plan` says, leaf by leaf, how a gradient is completed over
the model axis and counted in the global norm.

**Heads that do not divide tp.**  GSPMD pads the query heads to a
multiple of tp; the port splits them in that padded layout without the
pad heads (:func:`query_heads`): rank r holds heads ``[min(r·c, H),
min((r+1)·c, H))`` with ``c = ceil(H / tp)``, so rank 0 holds c heads, as
every device does under GSPMD, and a later rank may hold fewer, or none.
A rank with no query head holds ``(d, 0)`` ``wq`` and ``(0, d)`` ``wo``
shards, launches no attention kernel and adds exact zeros to the output
projection's all-reduce, which it still joins.

**The recurrent stages** (Mamba2 blocks, the zamba superblock's six,
xLSTM pairs) split their heads the same way (:func:`recurrent_heads`:
Mamba2's ``d_in / head_dim``, xLSTM's ``n_heads``; ceil(nh / tp) a rank
from rank 0).  The leaves JAX names column-parallel are cut by head, and
where a projection packs several parts side by side the rank's columns
of each part are kept, in order (strided: Mamba2's ``w_zx`` its z and x
heads, the mLSTM's ``w_up`` its ``x_in`` and z heads, the sLSTM's
``w_gates`` its heads of each gate i, f, z, o, the sLSTM FFN's ``w_up``
its 1/tp of a and of b); ``w_out`` / ``w_down`` are row-parallel.  Every
other recurrent leaf stays replicated, as in JAX; where a rank reads only
its heads' part of one (or, like Mamba2's ``w_bc``, feeds only its heads
from it) its gradient is summed over the model group
(:data:`_READ_IN_PART`).  The recurrent state splits by the same heads
(:func:`state_pieces`; Mamba2's conv state keeps all of B and C's
channels on every rank), and a P/D payload carries it in the tp = 1
layout (:func:`gather_state`, :func:`take_state`).  Where JAX splits the
mLSTM's heads' columns evenly across head boundaries (xlstm-125m's four
heads at tp = 16), rank 0 here holds one head whole: its ``w_up``,
``w_q``, ``w_k``, ``w_v``, ``w_down`` and ``w_gates`` are wider than
GSPMD's per-device shards, and ranks 4-15 hold none.

**One deviation from GSPMD.**  When the KV heads do not divide tp, GSPMD
shards the KV projections' and the KV cache's ``d_head`` instead
(``_COL``, ``cache_pspecs``).  Explicit TP cannot split ``d_head`` without
one more reduction inside attention, so here each rank keeps the KV heads
its query heads read (:func:`kv_heads`; their K/V projections are then
computed on every rank that reads them, and their ``wk``/``wv``/``bk``/
``bv`` gradients are summed over those ranks, :func:`shared_kv_heads`).
The kernels take one group size a call (query head h reads KV head
h // G), so a rank's K/V go into *KV slots* (:func:`kv_slots`): each KV
head it reads repeated (its query heads on it) / g times in a row, g the
gcd of those counts, and g is the rank's group size.  Where every head
is one slot (every arch at the JAX study's meshes) the slots are the
heads; starcoder2-7b at tp = 3 gives rank 0 slots [0, 0, 0, 1] for its
nine query heads on KV 0 and three on KV 1.  The pools hold slots; a
payload, a gradient and the global norm hold each KV head once
(:func:`owned_kv_heads`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

_COL = {"wq", "wk", "wv", "wqkv", "bq", "bk", "bv", "w_gate", "w_up",
        "w_in", "w_zx", "w_dt", "w_q", "w_k", "w_v", "w_gates"}
_ROW = {"wo", "w_down", "w_out"}
_KV = {"wk", "wv", "bk", "bv"}
_QK_NORM = {"q_norm", "k_norm"}
#: the recurrent blocks' replicated leaves that a rank reads only in part
#: (its heads' entries) or uses only for its heads: gradients summed over
#: the model group, by block
_READ_IN_PART = {
    "mamba": {"w_bc", "conv_w", "conv_b", "A_log", "D", "dt_bias",
              "norm_scale"},
    "mlstm": {"conv_w", "conv_b", "w_i", "w_f", "f_bias", "norm_h"},
    "slstm": {"r_gates", "b_gates"}}


def head_range(n: int, rank: int, tp: int) -> Tuple[int, int]:
    """Heads ``[lo, hi)`` of ``n`` that ``rank`` holds: GSPMD's padded
    layout without the pad heads (ceil(n / tp) a rank from rank 0; a later
    rank may hold fewer, or none)."""
    c = -(-n // tp)
    return min(rank * c, n), min((rank + 1) * c, n)


def group_heads(n: int, group) -> Tuple[int, int]:
    """The heads ``[lo, hi)`` of ``n`` that ``group``'s rank holds
    (:func:`head_range`; all of them without a group)."""
    if group is None:
        return 0, n
    return head_range(n, group.rank, group.size)


def head_widths(n: int, width: int, tp: int) -> List[int]:
    """Every rank's width of ``n`` heads ``width`` wide, in rank order."""
    return [(hi - lo) * width
            for lo, hi in (head_range(n, r, tp) for r in range(tp))]


def query_heads(cfg: ArchConfig, rank: int, tp: int) -> Tuple[int, int]:
    """The query heads ``[lo, hi)`` of ``rank`` (:func:`head_range`)."""
    return head_range(cfg.n_heads, rank, tp)


def mamba_dims(d: int, ssm) -> Tuple[int, int, int, int]:
    """Mamba2's ``(d_in, heads, head_dim, d_state)`` of the whole block at
    model width ``d``."""
    d_in = ssm.expand * d
    nh = ssm.n_heads or d_in // ssm.head_dim
    return d_in, nh, d_in // nh, ssm.d_state


def slstm_ff(cfg: ArchConfig) -> int:
    """The sLSTM block's feed-forward width (JAX's ``int(d * 4 / 3)``)."""
    return int(cfg.d_model * 4 / 3)


def recurrent_heads(cfg: ArchConfig, rank: int, tp: int,
                    block: str = "mamba") -> Tuple[int, int]:
    """The heads ``[lo, hi)`` of ``rank`` in a recurrent block: Mamba2's
    (``block`` "mamba") or the xLSTM's ("mlstm", "slstm": ``n_heads``),
    in the padded layout (:func:`head_range`)."""
    nh = mamba_dims(cfg.d_model, cfg.ssm)[1] if block == "mamba" else cfg.n_heads
    return head_range(nh, rank, tp)


def _block(path: Tuple[str, ...]) -> Optional[str]:
    """The recurrent block a param path lies in, or None."""
    for b in ("mamba", "mlstm", "slstm"):
        if b in path[:-1]:
            return b
    return None


def _heads_cols(cfg: ArchConfig, block: str, rank: int, tp: int
                ) -> Tuple[int, int, int]:
    """``(lo, hi, head width)`` of ``rank``'s heads in ``block``."""
    lo, hi = recurrent_heads(cfg, rank, tp, block)
    if block == "mamba":
        return lo, hi, mamba_dims(cfg.d_model, cfg.ssm)[2]
    d_in = 2 * cfg.d_model if block == "mlstm" else cfg.d_model
    return lo, hi, d_in // cfg.n_heads


def state_pieces(cfg: ArchConfig, name: str, rank: int, tp: int
                 ) -> Tuple[int, List[Tuple[int, int]]]:
    """``(dim from the end, [(lo, hi), ...])``: where ``rank``'s part of
    a recurrent state leaf (``Model.state_leaves``' name) lies in the
    whole one, the pieces in the order the rank holds them.  The dim
    counts from the end, so it holds with or without the batch axis."""
    leaf = name.split(".")[-1]
    if "mlstm" in name or "slstm" in name:
        block = "mlstm" if "mlstm" in name else "slstm"
        lo, hi, hd = _heads_cols(cfg, block, rank, tp)
        if leaf == "conv":
            return -1, [(lo * hd, hi * hd)]
        dim = {"C": -3, "m": -1}.get(leaf, -2) if block == "mlstm" else -2
        return dim, [(lo, hi)]
    lo, hi, hd = _heads_cols(cfg, "mamba", rank, tp)
    if leaf == "ssd":
        return -3, [(lo, hi)]
    d_in, _, _, ds = mamba_dims(cfg.d_model, cfg.ssm)
    return -1, [(lo * hd, hi * hd), (d_in, d_in + 2 * ds)]


def owned_state_width(cfg: ArchConfig, name: str, rank: int, tp: int
                      ) -> int:
    """The width (along :func:`state_pieces`' dim) of ``rank``'s part of a
    recurrent state leaf that no lower rank holds: its heads, and a piece
    every rank holds (Mamba2's B/C conv channels) on rank 0 only."""
    lower = {p for r in range(rank)
             for p in state_pieces(cfg, name, r, tp)[1]}
    return sum(hi - lo for lo, hi in state_pieces(cfg, name, rank, tp)[1]
               if (lo, hi) not in lower)


@functools.lru_cache(maxsize=None)
def kv_slots(cfg: ArchConfig, rank: int, tp: int) -> Tuple[int, ...]:
    """The KV head of each of ``rank``'s KV slots, in order (see the
    module docstring): ``rank``'s query head ``lo + i`` reads slot
    ``i // g``, g = its query heads over its slots.  Empty for a rank
    with no query head."""
    lo, hi = query_heads(cfg, rank, tp)
    G = cfg.n_heads // cfg.n_kv_heads
    counts: dict = {}
    for h in range(lo, hi):
        counts[h // G] = counts.get(h // G, 0) + 1
    g = math.gcd(*counts.values()) if counts else 1
    return tuple(k for k, n in counts.items() for _ in range(n // g))


def kv_heads(cfg: ArchConfig, rank: int, tp: int) -> Tuple[int, int]:
    """The KV heads ``[lo, hi)`` that ``rank``'s query heads read, each
    once: an even split when the KV heads divide tp and the query heads
    cover whole groups, else the group(s) its query heads fall in (the
    deviation in the module docstring); ``(KV, KV)`` for a rank with no
    query head."""
    slots = kv_slots(cfg, rank, tp)
    if not slots:
        return cfg.n_kv_heads, cfg.n_kv_heads
    return slots[0], slots[-1] + 1


def to_slots(t: torch.Tensor, cfg: ArchConfig, rank: int, tp: int,
             dim: int = 2) -> torch.Tensor:
    """``t`` over ``rank``'s KV heads (:func:`kv_heads`) along ``dim`` ->
    over its KV slots (each head repeated as :func:`kv_slots` says; a
    head's copies are expanded views concatenated, so autograd sums their
    gradients into the head).  ``t`` itself where every head is one
    slot."""
    slots = kv_slots(cfg, rank, tp)
    lo, hi = kv_heads(cfg, rank, tp)
    if len(slots) == hi - lo:
        return t
    parts = []
    for k in range(lo, hi):
        one = t.narrow(dim, k - lo, 1)
        shape = list(one.shape)
        shape[dim] = slots.count(k)
        parts.append(one.expand(shape))
    return torch.cat(parts, dim=dim)


def from_slots(t: torch.Tensor, cfg: ArchConfig, rank: int, tp: int,
               dim: int = 2) -> torch.Tensor:
    """The inverse of :func:`to_slots`: each KV head's first slot, in head
    order (``t`` itself where every head is one slot)."""
    slots = kv_slots(cfg, rank, tp)
    lo, hi = kv_heads(cfg, rank, tp)
    if len(slots) == hi - lo:
        return t
    return torch.cat([t.narrow(dim, slots.index(k), 1)
                      for k in range(lo, hi)], dim=dim)


def owned_kv_heads(cfg: ArchConfig, rank: int, tp: int) -> Tuple[int, int]:
    """The KV heads ``[lo, hi)`` that ``rank`` owns: those of
    :func:`kv_heads` that no lower rank holds, so that over the ranks every
    KV head is owned once (a head held by several ranks belongs to the
    lowest).  Counting a payload's bytes by owned heads gives the group
    the tp = 1 payload's size."""
    lo, hi = kv_heads(cfg, rank, tp)
    if rank > 0:
        lo = max(lo, kv_heads(cfg, rank - 1, tp)[1])
    return lo, max(lo, hi)


def shared_kv_heads(cfg: ArchConfig, tp: int
                    ) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
    """``(KV head, the ranks that read it)`` for every KV head that two or
    more ranks read, in ascending head order.  At tp = 3 starcoder2-7b's
    reader sets overlap: KV 1 is read by ranks (0, 1), KV 2 by (1, 2)."""
    readers: dict = {}
    for r in range(tp):
        lo, hi = kv_heads(cfg, r, tp)
        for k in range(lo, hi):
            readers.setdefault(k, []).append(r)
    return tuple((k, tuple(rs)) for k, rs in sorted(readers.items())
                 if len(rs) > 1)


def gather_kv_heads(parts, cfg: ArchConfig, tp: int) -> torch.Tensor:
    """The full ``(layers, blen, KV, dh)`` payload from every rank's
    ``(layers, blen, KV_r, dh)`` one over its KV heads (``parts``, in rank
    order): each rank's owned heads (:func:`owned_kv_heads`), concatenated,
    so a head that several ranks hold appears once."""
    out = []
    for rank, part in enumerate(parts):
        lo, _ = kv_heads(cfg, rank, tp)
        olo, ohi = owned_kv_heads(cfg, rank, tp)
        out.append(part.narrow(2, olo - lo, ohi - olo))
    return torch.cat(out, dim=2)


def take_kv_heads(full: torch.Tensor, cfg: ArchConfig, rank: int,
                  tp: int) -> torch.Tensor:
    """``rank``'s heads (:func:`kv_heads`: every head it reads, a shared
    one included, each once) of a full ``(layers, blen, KV, dh)`` payload;
    a view."""
    lo, hi = kv_heads(cfg, rank, tp)
    return full.narrow(2, lo, hi - lo)


def seq_range(S: int, rank: int, n: int) -> Tuple[int, int]:
    """The tokens ``[lo, hi)`` of a decode cache of ``S`` tokens a sequence
    that ``rank`` of ``n`` holds when the cache's sequence splits over a
    group (JAX's ``cache_pspecs``: over ``data`` for a batch of one, over
    ``model`` under ``seq_shard_cache``): ceil(S / n) a rank from rank 0,
    a later rank fewer where ``n`` does not divide ``S``."""
    return head_range(S, rank, n)


def _seq_index(table, lo: int, hi: int, page_size: int):
    """(pages (B, hi - lo), offsets (hi - lo,)) of positions ``lo..hi-1``
    of every sequence through ``table``."""
    pos = torch.arange(lo, hi, device=table.device)
    return table[:, pos // page_size].long(), pos % page_size


def take_seq_pages(pool, table, out_pool, out_table, lo: int, hi: int,
                   page_size: int) -> None:
    """Copy tokens ``[lo, hi)`` of every sequence of a whole cache's pool
    (``pool`` (L, P, ps, KV, dh) through ``table`` (B, maxp)) into a rank's
    pool (``out_pool`` through ``out_table``, its positions from 0), in
    place: a rank's part of a sequence-sharded cache.  The heads are the
    pools' own (take a rank's KV heads before or after)."""
    src_p, off = _seq_index(table, lo, hi, page_size)
    dst_p, doff = _seq_index(out_table, 0, hi - lo, page_size)
    out_pool[:, dst_p, doff] = pool[:, src_p, off].to(out_pool.device,
                                                        out_pool.dtype)


def gather_seq_pages(parts, pool, table, page_size: int) -> None:
    """The inverse of :func:`take_seq_pages`: every rank's ``(pool, table,
    lo, hi)`` written back into a whole cache's ``pool`` through
    ``table``, in place."""
    for part, ptable, lo, hi in parts:
        dst_p, off = _seq_index(table, lo, hi, page_size)
        src_p, soff = _seq_index(ptable, 0, hi - lo, page_size)
        pool[:, dst_p, off] = part[:, src_p, soff].to(pool.device,
                                                      pool.dtype)


def experts_parallel(cfg: ArchConfig, tp: int) -> bool:
    """Expert parallelism when the experts divide tp (the JAX rule)."""
    return cfg.moe is not None and cfg.moe.n_experts % tp == 0


def expert_range(n: int, rank: int, tp: int) -> Tuple[int, int]:
    """The experts ``[lo, hi)`` of ``n`` that ``rank`` holds under
    ``shard_experts`` (:func:`head_range`: ceil(n / tp) a rank from rank
    0).  40 experts at tp = 16: ranks 0-12 hold 3, rank 13 one, ranks 14
    and 15 none; at tp = 3: 14, 14 and 12."""
    return head_range(n, rank, tp)


def _expert_leaf(path: Tuple[str, ...]) -> bool:
    return "moe" in path and path[-1] in ("w_gate", "w_up", "w_down")


def head_parallel(cfg: ArchConfig, tp: int) -> bool:
    """Whether the head's padded vocab (and the embedding's rows) split
    over tp."""
    return cfg.padded_vocab % tp == 0


def unsupported(cfg: ArchConfig, tp: int, fuse_qkv: bool = False,
                shard_experts: bool = False) -> Optional[str]:
    """Why the port cannot shard ``cfg`` over ``tp`` ranks (every reason,
    joined), or None.  Any head count splits, the recurrent blocks'
    included (the module docstring), and so does the fused QKV projection
    (``fuse_qkv``, strided: :func:`_pieces`); a feed-forward or expert
    width that does not divide tp does not, except that under
    ``shard_experts`` any expert count splits (whole experts a rank)."""
    if tp == 1:
        return None
    why = []
    present = {st.kind for st in cfg.stages}
    # zamba's superblock runs the shared attention + MLP block
    if present & {"attn_mlp", "zamba_super"} and cfg.d_ff % tp:
        why.append(f"d_ff {cfg.d_ff} does not split over tp={tp}")
    if "xlstm_pair" in present and slstm_ff(cfg) % tp:
        why.append(f"the sLSTM's feed-forward width {slstm_ff(cfg)} does "
                   f"not split over tp={tp}")
    if "attn_moe" in present and not shard_experts \
            and not experts_parallel(cfg, tp) and cfg.moe.d_expert % tp:
        why.append(f"{cfg.moe.n_experts} experts do not split over "
                   f"tp={tp}, nor does d_expert {cfg.moe.d_expert}")
    # weights with no rule of the model axis yet: refused, not replicated
    # or cut wrong
    if cfg.attn_out_gate:
        why.append("the attention output gate (attn.wg) has no tp split")
    if "attn_moe" in present and cfg.moe.n_shared_experts:
        why.append("the shared expert (moe.shared_*) has no tp split")
    if "attn_moe" in present and cfg.moe.score_func == "sigmoid":
        why.append("the sigmoid router's expert bias (moe.expert_bias) has "
                   "no tp rule")
    return f"{cfg.name}: " + "; ".join(why) if why else None


def _named(path: Tuple[str, ...], cfg: ArchConfig, tp: int,
           shard_experts: bool = False) -> Optional[int]:
    name = path[-1]
    if path[0] == "embed":
        return 0
    if path[0] == "head":
        return -1
    if _expert_leaf(path):
        if shard_experts or experts_parallel(cfg, tp):
            return -3
        return -1 if name != "w_down" else -2
    if name in _COL:
        return -1
    if name in _ROW:
        return -2
    return None


def model_dim(path: Tuple[str, ...], ndim: int, cfg: ArchConfig,
              tp: int, shard_experts: bool = False) -> Optional[int]:
    """The dim of a param leaf that the model rule names (non-negative),
    or None for a replicated leaf.  Named is not always split: a padded
    vocab that does not divide tp leaves the embedding and the head whole
    (:func:`split`), as ``fit_to_mesh`` does after JAX's rule named it."""
    dim = _named(path, cfg, tp, shard_experts)
    return None if dim is None else dim % ndim


def split(path: Tuple[str, ...], cfg: ArchConfig, tp: int,
          shard_experts: bool = False) -> bool:
    """Whether tp > 1 cuts the leaf (rather than replicating it)."""
    if tp == 1 or _named(path, cfg, tp, shard_experts) is None:
        return False
    if path[0] in ("embed", "head"):
        return head_parallel(cfg, tp)
    return True


def zero1_dim(path: Tuple[str, ...], shape, cfg: ArchConfig, tp: int,
              data: int, shard_experts: bool = False) -> Optional[int]:
    """The dim of a moment leaf (``shape``: the param leaf's full shape)
    that ZeRO-1 splits over the ``data`` axis: the first one the model
    rule does not name that divides by ``data`` and is above 1.  None
    without one, or at ``data == 1``."""
    if data == 1:
        return None
    named = model_dim(path, len(shape), cfg, tp, shard_experts)
    for i, d in enumerate(shape):
        if i != named and d > 1 and d % data == 0:
            return i
    return None


def _split(leaf, dim: int, lo: int, hi: int):
    """A fresh copy of ``leaf[..., lo:hi, ...]`` along ``dim``: the shard
    never keeps the full tensor's storage alive."""
    idx = [slice(None)] * leaf.ndim
    idx[dim] = slice(lo, hi)
    part = leaf[tuple(idx)]
    if isinstance(part, torch.Tensor):
        return part.detach().clone(memory_format=torch.contiguous_format)
    return np.array(part, order="C")


def _full_len(path, n: int, cfg: ArchConfig, tp: int,
              shard_experts: bool = False) -> int:
    """The whole length along the model dim of a split leaf whose rank
    part has ``n`` there (rank 0's part where ranks differ)."""
    name, block = path[-1], _block(path)
    if shard_experts and _expert_leaf(path):
        return cfg.moe.n_experts
    if block == "mamba":
        d_in, nh, _, _ = mamba_dims(cfg.d_model, cfg.ssm)
        return {"w_zx": 2 * d_in, "w_dt": nh}.get(name, d_in)
    if block == "mlstm":
        return 4 * cfg.d_model if name == "w_up" else 2 * cfg.d_model
    if block == "slstm" and name == "w_gates":
        return 4 * cfg.d_model
    if name in ("wq", "bq", "wo"):
        return cfg.n_heads * cfg.d_head
    if name in _KV:
        return cfg.n_kv_heads * cfg.d_head
    if name == "wqkv":
        return (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head
    return n * tp


def _pieces(path, n: int, cfg: ArchConfig, rank: int, tp: int,
            shard_experts: bool = False) -> List[Tuple[int, int]]:
    """``rank``'s parts ``[(lo, hi), ...]`` of a leaf that tp splits,
    along its model dim of whole length ``n``, in the order the shard
    holds them (several where a projection packs parts side by side)."""
    name, block = path[-1], _block(path)
    if shard_experts and _expert_leaf(path):
        return [expert_range(n, rank, tp)]
    if block in ("mamba", "mlstm") or (block == "slstm"
                                       and name == "w_gates"):
        lo, hi, hd = _heads_cols(cfg, block, rank, tp)
        if name == "w_dt":
            return [(lo, hi)]
        if name in ("w_zx", "w_up", "w_gates"):
            # z | x (Mamba2), x_in | z (mLSTM), i | f | z | o (sLSTM)
            k = 4 if name == "w_gates" else 2
            return [(j * n // k + lo * hd, j * n // k + hi * hd)
                    for j in range(k)]
        return [(lo * hd, hi * hd)]
    if name in ("wq", "bq", "wo"):
        lo, hi = query_heads(cfg, rank, tp)
        return [(lo * cfg.d_head, hi * cfg.d_head)]
    if name in _KV:
        lo, hi = kv_heads(cfg, rank, tp)
        return [(lo * cfg.d_head, hi * cfg.d_head)]
    if name == "wqkv":
        # q | k | v: the rank's query heads' columns, then its KV heads'
        # of K and of V (strided, as ``w_zx``)
        H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        qlo, qhi = query_heads(cfg, rank, tp)
        klo, khi = kv_heads(cfg, rank, tp)
        return [(qlo * dh, qhi * dh), ((H + klo) * dh, (H + khi) * dh),
                ((H + KV + klo) * dh, (H + KV + khi) * dh)]
    k = 2 if block == "slstm" and name == "w_up" else 1   # a | b
    if n % (k * tp):
        raise ValueError(f"{'/'.join(path)}: a model dim of size {n} does "
                         f"not split over tp={tp} (sharding.unsupported "
                         f"names such a configuration)")
    c = n // (k * tp)
    return [(j * n // k + rank * c, j * n // k + (rank + 1) * c)
            for j in range(k)]


def _take(leaf, dim: int, pieces):
    """A fresh copy of ``leaf``'s ``pieces`` along ``dim``, concatenated:
    the shard never keeps the full tensor's storage alive."""
    parts = [_split(leaf, dim, lo, hi) for lo, hi in pieces]
    if len(parts) == 1:
        return parts[0]
    if isinstance(leaf, torch.Tensor):
        return torch.cat(parts, dim=dim)
    return np.concatenate(parts, axis=dim)


def _place(parts, pieces, dim: int, n: int):
    """The whole leaf of length ``n`` along ``dim`` from every rank's part
    (``parts``) and its pieces (``pieces``, one list a rank), each piece
    written where it lies; a column several ranks hold is taken from the
    lowest of them (the ranks are written from the last)."""
    first = parts[0]
    shape = list(first.shape)
    shape[dim] = n
    if isinstance(first, torch.Tensor):
        out = first.new_zeros(shape)
        parts = [p.detach() for p in parts]
    else:
        out = np.zeros(shape, dtype=first.dtype)
    for part, pcs in reversed(list(zip(parts, pieces))):
        off = 0
        for lo, hi in pcs:
            src = [slice(None)] * len(shape)
            dst = [slice(None)] * len(shape)
            src[dim] = slice(off, off + hi - lo)
            dst[dim] = slice(lo, hi)
            out[tuple(dst)] = part[tuple(src)]
            off += hi - lo
    return out


def take_state(full, cfg: ArchConfig, name: str, rank: int, tp: int):
    """``rank``'s part of a whole recurrent state leaf (tp = 1's layout;
    ``name`` as ``Model.state_leaves`` gives it), a fresh copy."""
    dim, pcs = state_pieces(cfg, name, rank, tp)
    return _take(full, full.dim() + dim, pcs)


def gather_state(parts, cfg: ArchConfig, name: str, tp: int):
    """The whole recurrent state leaf (tp = 1's layout) from every rank's
    part (``parts``, in rank order)."""
    dim = state_pieces(cfg, name, 0, tp)[0]
    pcs = [state_pieces(cfg, name, r, tp)[1] for r in range(tp)]
    n = max(hi for p in pcs for _, hi in p)
    return _place(parts, pcs, parts[0].dim() + dim, n)


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def shard_params(params: dict, rank: int, tp: int, *,
                 cfg: ArchConfig, shard_experts: bool = False) -> dict:
    """Rank ``rank``'s shard of ``params`` (a nested dict of numpy arrays
    or tensors in the JAX layout) at tensor-parallel degree ``tp``.  Split
    leaves are fresh copies; replicated leaves are the inputs themselves.
    ``tp == 1`` returns ``params``.  ``shard_experts``: the experts whole
    in the padded layout (:func:`expert_range`)."""
    if tp == 1:
        return params

    def leaf_shard(path, leaf):
        if not split(path, cfg, tp, shard_experts):
            return leaf            # norms, the router, a vocab that stays
        dim = model_dim(path, leaf.ndim, cfg, tp, shard_experts)
        return _take(leaf, dim, _pieces(path, leaf.shape[dim], cfg, rank,
                                        tp, shard_experts))

    return _map(params, leaf_shard)


def gather_params(parts, cfg: ArchConfig, tp: int,
                  shard_experts: bool = False) -> dict:
    """The full params in the JAX layout from every rank's shard
    (``parts``, in rank order): each split leaf's parts written where they
    lie (strided ones included), a KV head that several ranks hold taken
    once (from its owner, the lowest), replicated leaves from rank 0.
    ``shard_experts``: the shards' layout of the experts."""
    if tp == 1:
        return parts[0]

    def leaf(path, _):
        got = list(parts)
        for k in path:
            got = [g[k] for g in got]
        if not split(path, cfg, tp, shard_experts):
            return got[0]
        dim = model_dim(path, got[0].ndim, cfg, tp, shard_experts)
        n = _full_len(path, got[0].shape[dim], cfg, tp, shard_experts)
        return _place(got, [_pieces(path, n, cfg, r, tp, shard_experts)
                            for r in range(tp)], dim, n)

    return _map(parts[0], leaf)


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How one param leaf lies over the model axis and the data axis.

    ``grad_sum``: the group its gradient is summed over after the backward
    (besides data parallelism): "model" for a replicated leaf used inside
    the sharded region (``q_norm``, ``k_norm``, the recurrent blocks'
    :data:`_READ_IN_PART`: each rank's gradient holds only its heads'
    part), "kv" for the projections of KV heads that other
    ranks read too (``wk``, ``wv``, their biases, and the K and V columns
    of the fused ``wqkv``; never its query columns), None otherwise.
    ``kv_shared``: with "kv", ``(KV head, lo, hi)`` for each such head's
    columns ``[lo, hi)`` of the rank's leaf along its model dim (two a
    head in ``wqkv``: K's, then V's), in ascending head order (each summed
    over the head's readers, ``shared_kv_heads``).  ``norm``: how it counts
    in the global norm: "replicated" (once), "model" (the rank's part,
    summed over the model group) or "skip" (KV heads that lower ranks
    own); ``norm_cols``: with "model", the column ranges ``((lo, hi),
    ...)`` along the model dim that count (the rank's owned KV heads, and
    in ``wqkv`` its query columns), None for all of them.  ``zero1_dim``:
    the dim ZeRO-1 splits its moments on."""
    path: Tuple[str, ...]
    split: bool
    grad_sum: Optional[str]
    norm: str
    zero1_dim: Optional[int]
    kv_shared: Tuple[Tuple[int, int, int], ...] = ()
    norm_cols: Optional[Tuple[Tuple[int, int], ...]] = None


def leaf_plan(params: dict, cfg: ArchConfig, tp: int, rank: int,
              data: int = 1, zero1: bool = False,
              shard_experts: bool = False) -> List[LeafPlan]:
    """A :class:`LeafPlan` for every leaf of ``rank``'s params (any
    device, meta included), in ``repro_torch.train.tree.leaves`` order.
    ``data``: the data axis's extent (ZeRO-1's split, when ``zero1``);
    ``shard_experts``: the params' expert layout (an expert leaf lives on
    one rank: no sum over the model axis, counted once in the norm)."""
    from repro_torch.train.tree import leaves
    full = {}
    se = shard_experts

    def note(path, leaf):
        shape = list(leaf.shape)
        if split(path, cfg, tp, se):
            dim = model_dim(path, leaf.ndim, cfg, tp, se)
            shape[dim] = _full_len(path, shape[dim], cfg, tp, se)
        full[path] = tuple(shape)
        return "/".join(path)      # a string: ``leaves`` walks tuples

    paths = [tuple(p.split("/")) for p in leaves(_map(params, note))]
    dh = cfg.d_head
    klo, khi = kv_heads(cfg, rank, tp)
    olo, ohi = owned_kv_heads(cfg, rank, tp)
    shared = {k for k, _ in shared_kv_heads(cfg, tp)} if tp > 1 else set()
    mine = tuple((k, (k - klo) * dh, (k - klo + 1) * dh)
                 for k in range(klo, khi) if k in shared)
    owned = None if (olo, ohi) == (klo, khi) else \
        (((olo - klo) * dh, (ohi - klo) * dh),)
    # the fused leaf: the rank's query columns, then K's and V's of its
    # KV heads (``_pieces``)
    qlo, qhi = query_heads(cfg, rank, tp)
    hq = (qhi - qlo) * dh
    hk = (khi - klo) * dh
    fused_kv = tuple((k, off + lo, off + hi) for k, lo, hi in mine
                     for off in (hq, hq + hk))
    fused_owned = None if owned is None else \
        ((0, hq),) + tuple((off + lo, off + hi) for lo, hi in owned
                           for off in (hq, hq + hk) if hi > lo)
    plans = []
    for path in paths:
        cut = split(path, cfg, tp, se)
        grad_sum, norm, kv, cols = None, \
            "model" if cut else "replicated", (), None
        if tp > 1 and (path[-1] in _QK_NORM or path[-1]
                       in _READ_IN_PART.get(_block(path), ())):
            grad_sum = "model"
        elif cut and path[-1] in _KV:
            if mine:
                grad_sum, kv = "kv", mine
            if ohi == olo:
                norm = "skip"
            else:
                cols = owned
        elif cut and path[-1] == "wqkv":
            if mine:
                grad_sum, kv = "kv", fused_kv
            cols = fused_owned
        z = zero1_dim(path, full[path], cfg, tp, data, se) if zero1 \
            else None
        plans.append(LeafPlan(path, cut, grad_sum, norm, z, kv, cols))
    return plans


def zero1_slice(t, dim: Optional[int], rank: int, data: int):
    """``rank``'s part of ``t`` along ``dim`` over ``data`` ranks (a
    view), or ``t`` with no dim."""
    if dim is None:
        return t
    n = t.shape[dim] // data
    return t.narrow(dim, rank * n, n)


def shard_batch(batch: dict, rank: int, dp: int,
                microbatches: int = 1) -> dict:
    """Data-parallel rank ``rank``'s rows of a global batch, ordered so
    that the train step's microbatch i is this rank's 1/dp of global
    microbatch i: JAX reshapes the batch to ``(mb, B/mb)`` and shards dim 1
    over the data axes.  A batch whose rows do not divide by ``mb · dp``
    raises; ``dp == 1`` returns ``batch``."""
    if dp == 1:
        return batch
    out = {}
    for k, x in batch.items():
        B = x.shape[0]
        if B % (microbatches * dp):
            raise ValueError(f"a batch of {B} rows does not split into "
                             f"{microbatches} microbatches over dp={dp}")
        y = x.reshape((microbatches, dp, B // (microbatches * dp))
                      + tuple(x.shape[1:]))[:, rank]
        out[k] = y.reshape((B // dp,) + tuple(x.shape[1:]))
        if isinstance(out[k], torch.Tensor):
            out[k] = out[k].contiguous()
    return out
