"""Decoder-only model over a paged KV cache and per-slot recurrent state.

The counterpart of ``repro/models/transformer.py`` for attention + MLP
stages (``ATTN_MLP``), attention + MoE stages (``ATTN_MOE``), Mamba2
stages (``MAMBA2``), zamba superblocks (``ZAMBA_SUPER``: six Mamba2 blocks,
then the one shared attention + MLP block, ``params["shared_attn"]``) and
xLSTM pairs (``XLSTM_PAIR``), with the same parameter layout (``init``),
the same entry points (``prefill``, ``decode``, ``extend``, ``verify``)
and the same paged slot-KV layout (``init_cache``, ``page_geometry``):

* ``prefill`` runs flash attention over a bucketed chunk and returns the
  chunk's K/V contiguously; the engine scatters it into pages.
* ``decode`` writes each row's new K/V through the block table and runs
  paged attention; a negative token marks a row that is not scheduled
  this step (it computes on token 0; the engine discards its output).
* ``extend`` writes a chunk of K/V after ``cache["lengths"]`` and runs
  paged attention with per-sequence ``start``.

In these serving modes RoPE rotates a layer's q and k in one kernel call
(``ops.rope``); training rotates each with ``layers.rope``, which autograd
differentiates.

A local:global interleave counts its layers over the whole model (layer
``i`` of the model is global iff ``i % P == P - 1``, ``P`` its stage's
period), and MoE layers take their windows as MLP layers do.  The options
of the port's own afmoe model (trinity-mini, which the JAX package
lacks), each off by default: ``rope_local_only`` (global layers attend
without RoPE), ``attn_out_gate`` (the attention output times sigmoid of
``attn.wg`` applied to the layer's normed input, before ``wo``),
``sandwich_norm`` (``post_attn_norm`` and ``post_mlp_norm`` on each
sublayer's output before its residual add), ``embed_multiplier``, and, in
``MoECfg``, sigmoid scoring with a per-layer expert bias, a route scale
and shared experts (``moe.shared_*``, added to the routed sum).

Each slot's unallocated table entries point at a scratch page of its own
(``init_cache``): a free or unscheduled slot's decode writes its K/V there
and reads back exactly that, as it would from its own row of the JAX
model's contiguous cache, and no two slots' throwaway writes collide (on
the card, which of two colliding writes lands is not defined; an MoE layer
routes those rows too, so their values reach real tokens through expert
capacity).  Writes past the table go to the pool's last page, which is
never read.  The JAX model
updates its pools functionally (``.at[].set``); this one writes them in
place with ``index_put_``, so the cache a call returns shares its pools
with the cache it was given.

Recurrent stages hold dense per-slot state beside the pools, laid out as
the JAX package's ``_stage_cache``: ``MAMBA2`` ``{"ssd", "conv"}`` of
``(L, B, ...)``, ``ZAMBA_SUPER`` ``{"mamba": {"ssd", "conv"} of (L, 6, B,
...), "attn": pools}`` (each superblock's shared-attention application has
its own K/V), ``XLSTM_PAIR`` ``{"mlstm": {"C", "n", "m", "conv"}, "slstm":
{"h", "c", "n", "m"}}`` of ``(L, B, ...)``.  That state is functional, as
in JAX: every call returns new state tensors.  ``decode`` leaves the state
of every row whose token is the sentinel (< 0) exactly as it was, where
the JAX model advances it by the step on token 0 (the JAX engine's
full-buffer decode then moves the state of a slot that is mid-prefill).
``extend`` on an xLSTM stage raises ``NotImplementedError``, as in JAX.
``attention_caches`` and ``state_leaves`` name the pools and the state
leaves (with their batch axis) for the engine's slot plumbing.

Attention and the MoE grouped matmul always go through
``repro_torch.kernels.ops``: the Hopper kernels for CUDA tensors, their
plain versions for CPU tensors.  ``ArchConfig.kernels`` is not read.
``routing_hook`` (``repro_torch.moe.hooks``) replaces the top-k assignment
of every MoE layer; only then do pad-tail rows and unscheduled decode rows
(the negative-token sentinel) leave MoE dispatch, as in JAX.  ``verify``
(speculative decoding) is ``extend`` returning every position's logits: on
the card it runs the same paged extend kernel, at S = k + 1.

Training (``forward``, ``loss_fn``) runs every stage in ``mode ==
"train"``: no cache, attention through ``repro_torch.models.flash`` (the
flash kernel and its backward kernel on the card, with autograd between
them), each layer under ``torch.utils.checkpoint`` when ``remat`` (JAX's
``jax.checkpoint`` with ``nothing_saveable``), the MoE layers' aux loss
summed over layers.  ``attn_impl`` ("flash" by default) picks training's
and prefill's attention: the flash kernel, or the plain ``chunked`` /
``folded`` attentions of ``layers`` that the JAX dry run studies (JAX's
``gemma_superblock`` is read nowhere there and ``unroll`` has no eager
meaning; neither is ported).  Params stay f32 and every weight is cast per call
(``w.to(x.dtype)``), so gradients reach the f32 leaves; ``fuse_qkv`` and
``norm_ct16`` are the JAX model's options of the same names.  The MoE
layers train through ``repro_torch.models.moe.grouped_matmul``: the grouped
matmul kernel forward and its backward kernel on the card (autograd
between them), their plain versions on the CPU.

Models on precomputed embeddings with codebook heads (musicgen,
``embed_inputs=False``, ``n_codebooks``) have no ``embed`` table: every
entry point takes ``(B, S, d)`` embeddings, cast to the compute dtype, and
the head gives ``(B, S, n_codebooks, padded_vocab)``.  A decode on
embeddings has no negative-token sentinel, so no row is held back.

Tensor parallelism (``group``, a ``repro_torch.launch.mesh.EngineGroup``):
the params are one rank's shard (``repro_torch.launch.sharding``, any tp:
GSPMD's padded head layout); the recurrent blocks run their heads
(``models.mamba2``, ``models.xlstm``) and the state holds only those, and
attention runs on the rank's query heads
over its KV slots (its KV heads, one repeated where its query heads
straddle groups unevenly, so every kernel sees one group size), the pools
hold only its slots, a rank with no query head computes no attention (the
kernel wrappers return empty outputs) and adds zeros, and the
collectives of ``repro_torch.launch.collectives`` complete the model: the
embedding's lookup of the rank's vocab rows all-reduced, an
all-reduce after the attention output projection, one after the MLP's (or
MoE's) down projection, and an all-gather of the head's vocab shards, so
every rank samples from the same full logits.  In training each sharded
region starts with ``copy_to`` (identity forward, the gradient all-reduced
backward) and the head's gather gives each rank its slice of the gradient,
so every replicated tensor gets its whole gradient.  Without a group none of
them runs.  Under ``shard_experts`` (JAX's hint; ``ServingEngine`` does not
take it, as the JAX engine does not) the params hold whole experts in the
padded layout and a MoE layer ends with two all-to-alls and an all-gather
of the ranks' tokens instead of the all-reduce (``models.moe``).

Data parallelism (``dp_group``, training only): the batch is the rank's
rows (``sharding.shard_batch``); ``loss_fn`` divides the rank's weighted
NLL by the global weight sum and sums it over the group (each rank keeps
the gradient of its own part, so the train step sums the gradients), and
the MoE layers route as the whole batch does (``moe_ffn``'s ``dp_group``).

A sequence-sharded decode cache (``seq_group``, JAX's ``cache_pspecs``:
``RankGrid.seq_group``): each rank's pools hold tokens ``[lo, hi)`` of
every sequence (``sharding.seq_range`` of the cache's length,
``cache["seq_range"]``; ``lengths`` stay the whole sequences').  A decode
runs the paged kernel over the rank's tokens (local lengths ``clamp(len -
lo, 0, hi - lo)``, the query at its local position, which lies before or
past the rank's tokens on most ranks), which returns its output and
log-sum-exp, and ``collectives.combine_lse`` merges the ranks' parts over
``seq_group``; the new token's K/V lands on the rank holding its position,
the other ranks write it past the table.  Over the ``data`` group (a batch
of one) the heads split over ``group`` as above.  Over the model group
itself (``seq_group is group``: ``seq_shard_cache``) every rank's pools
hold every KV head: the query heads and the new K/V are all-gathered over
the model group (the padded layout), each rank attends every head over its
tokens and keeps its own heads after the combine, and ``wo`` stays
row-parallel.  The recurrent state is whole on every rank of
``seq_group`` (JAX replicates it over ``data``).  Prefill runs over whole
sequences (``sharding.take_seq_pages`` moves its K/V to the ranks);
extend and verify refuse a sequence-sharded cache.

``fuse_qkv`` at tp > 1: the rank's ``wqkv`` holds its query heads'
columns, then its KV heads' K and V columns (``sharding``'s strided
shard), so the fused branch splits by the rank's heads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (ATTN_MLP, ATTN_MOE, MAMBA2, XLSTM_PAIR,
                                      ZAMBA_SUPER, ArchConfig)
from repro_torch.kernels import ops
from repro_torch.launch.collectives import (combine_lse, copy_to, gather_last,
                                           gather_parts, reduce_from)
from repro_torch.launch.sharding import (gather_kv_heads, kv_heads, kv_slots,
                                         query_heads, recurrent_heads,
                                         seq_range, to_slots)
from repro_torch.models import mamba2 as mb
from repro_torch.models import module as m
from repro_torch.models import xlstm as xl
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import (chunked_attention,
                                       folded_causal_attention, gelu_mlp,
                                       rmsnorm, rmsnorm_ct16, rope,
                                       swiglu_mlp)
from repro_torch.models.moe import moe_ffn
from repro_torch.obs.spans import mode_span as _span, span

#: stage kinds that carry per-slot recurrent state
RECURRENT = (MAMBA2, ZAMBA_SUPER, XLSTM_PAIR)
#: zamba superblock: Mamba2 blocks before the shared attention block
ZAMBA_INNER = 6
#: params the recurrent blocks read in f32 whatever the compute dtype
_F32_PARAMS = frozenset({"A_log", "dt_bias", "D", "r_gates",
                         "expert_bias"})

#: global layers of a local:global interleave attend without a window
_GLOBAL_WINDOW = 2 ** 30


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def cast_params(params: dict, dtype: torch.dtype, device=None) -> dict:
    """Move params to ``device`` and cast every weight the forward pass
    casts to the compute dtype (projections, biases, MLP, embedding, head)
    once.  Norm scales stay f32 (``rmsnorm`` reads them in f32), and so do
    the recurrent blocks' decay, skip and recurrent weights
    (``_F32_PARAMS``), which JAX reads in f32."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        t = torch.as_tensor(tree).to(device)
        if t.is_floating_point() and path[-1] not in _F32_PARAMS \
                and not any("norm" in k for k in path):
            t = t.to(dtype)
        return t.contiguous()
    return walk(params, ())


# --------------------------------------------------------------------------
# per-block init (the layout of repro/models/transformer.py)
# --------------------------------------------------------------------------

def _init_attn(gen, cfg: ArchConfig, lead: tuple, fuse_qkv=False,
               **kw) -> dict:
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if fuse_qkv:
        # one (H + 2 KV) * dh projection, split after the matmul
        p = {"wqkv": m.dense_init(gen, d, (H + 2 * KV) * dh, lead=lead,
                                  **kw),
             "wo": m.dense_init(gen, H * dh, d, lead=lead, **kw)}
    else:
        p = {"wq": m.dense_init(gen, d, H * dh, lead=lead, **kw),
             "wk": m.dense_init(gen, d, KV * dh, lead=lead, **kw),
             "wv": m.dense_init(gen, d, KV * dh, lead=lead, **kw),
             "wo": m.dense_init(gen, H * dh, d, lead=lead, **kw)}
    if cfg.qkv_bias:
        p["bq"] = m.zeros(lead + (H * dh,), **kw)
        p["bk"] = m.zeros(lead + (KV * dh,), **kw)
        p["bv"] = m.zeros(lead + (KV * dh,), **kw)
    if cfg.qk_norm:
        p["q_norm"] = m.zeros(lead + (dh,), device=kw.get("device"))
        p["k_norm"] = m.zeros(lead + (dh,), device=kw.get("device"))
    if cfg.attn_out_gate:
        p["wg"] = m.dense_init(gen, d, H * dh, lead=lead, **kw)
    return p


def _init_mlp(gen, cfg: ArchConfig, lead: tuple, **kw) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_gated:
        return {"w_gate": m.dense_init(gen, d, ff, lead=lead, **kw),
                "w_up": m.dense_init(gen, d, ff, lead=lead, **kw),
                "w_down": m.dense_init(gen, ff, d, lead=lead, **kw)}
    return {"w_in": m.dense_init(gen, d, ff, lead=lead, **kw),
            "w_out": m.dense_init(gen, ff, d, lead=lead, **kw)}


def _init_attn_ffn(gen, cfg: ArchConfig, lead: tuple, fuse_qkv: bool,
                   name: str, ffn, **kw) -> dict:
    """An attention + feed-forward layer: the norms, the attention, then
    the feed-forward ``name`` that ``ffn()`` draws; with ``sandwich_norm``,
    a norm on each sublayer's output too."""
    dev = kw.get("device")
    p = {"norm1": m.zeros(lead + (cfg.d_model,), device=dev),
         "attn": _init_attn(gen, cfg, lead, fuse_qkv, **kw),
         "norm2": m.zeros(lead + (cfg.d_model,), device=dev)}
    p[name] = ffn()
    if cfg.sandwich_norm:
        p["post_attn_norm"] = m.zeros(lead + (cfg.d_model,), device=dev)
        p["post_mlp_norm"] = m.zeros(lead + (cfg.d_model,), device=dev)
    return p


def _init_attn_mlp(gen, cfg: ArchConfig, lead: tuple, fuse_qkv=False,
                   **kw) -> dict:
    return _init_attn_ffn(gen, cfg, lead, fuse_qkv, "mlp",
                          lambda: _init_mlp(gen, cfg, lead, **kw), **kw)


def _init_mamba_layer(gen, cfg: ArchConfig, lead: tuple, **kw) -> dict:
    return {"norm": m.zeros(lead + (cfg.d_model,), device=kw.get("device")),
            "mamba": mb.init_mamba(gen, cfg.d_model, cfg.ssm, lead=lead,
                                   **kw)}


def _init_xlstm_pair(gen, cfg: ArchConfig, lead: tuple, **kw) -> dict:
    return {"mlstm": xl.init_mlstm(gen, cfg.d_model, cfg.n_heads, lead=lead,
                                   **kw),
            "slstm": xl.init_slstm(gen, cfg.d_model, cfg.n_heads, lead=lead,
                                   **kw)}


def _init_moe(gen, cfg: ArchConfig, L: int, **kw) -> dict:
    """The router and the routed experts; the shared expert (``shared_*``,
    one SwiGLU of ``n_shared_experts * d_expert``) where there is one, and
    the sigmoid router's expert bias (f32, zero)."""
    d, mo = cfg.d_model, cfg.moe
    router = m.dense_init(gen, d, mo.n_experts, lead=(L,),
                          device=kw.get("device")) * 0.1
    p = {"router": router.to(kw.get("dtype", torch.float32)),
         "w_gate": m.dense_init(gen, d, mo.d_expert,
                                lead=(L, mo.n_experts), **kw),
         "w_up": m.dense_init(gen, d, mo.d_expert,
                              lead=(L, mo.n_experts), **kw),
         "w_down": m.dense_init(gen, mo.d_expert, d,
                                lead=(L, mo.n_experts), **kw)}
    if mo.n_shared_experts:
        fs = mo.n_shared_experts * mo.d_expert
        p["shared_gate"] = m.dense_init(gen, d, fs, lead=(L,), **kw)
        p["shared_up"] = m.dense_init(gen, d, fs, lead=(L,), **kw)
        p["shared_down"] = m.dense_init(gen, fs, d, lead=(L,), **kw)
    if mo.score_func == "sigmoid":
        p["expert_bias"] = m.zeros((L, mo.n_experts),
                                   device=kw.get("device"))
    return p


# --------------------------------------------------------------------------
# block forward
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SeqShard:
    """A decode over a sequence-sharded cache: this rank holds tokens
    ``[lo, hi)`` of every sequence, its attention is combined over
    ``group``, and ``over_model``: the group is the model group (all heads
    on every rank, ``seq_shard_cache``)."""
    group: Any
    lo: int
    hi: int
    over_model: bool


def _gather_heads(t, cfg: ArchConfig, group, kv: bool):
    """The whole model's query heads (``kv`` False) or KV heads (True) of
    ``t`` (B, S, heads, dh), from every rank's in the padded layout (a KV
    head that several ranks read taken from its owner)."""
    tp = group.size
    spans = [kv_heads(cfg, r, tp) if kv else query_heads(cfg, r, tp)
             for r in range(tp)]
    parts = gather_parts(t, group, [hi - lo for lo, hi in spans], dim=2)
    if kv:
        return gather_kv_heads(parts, cfg, tp)
    return torch.cat(parts, dim=2)


def _chunk_kv(k, v, cfg: ArchConfig) -> dict:
    """A prefill's K/V, contiguous in the compute dtype (not a view of the
    fused projection's output, which would keep all of it alive)."""
    dtype = torch_dtype(cfg.compute_dtype)
    return {"k": k.to(dtype).contiguous(), "v": v.to(dtype).contiguous()}


def _attention(p, x, cfg: ArchConfig, *, norm, positions, lengths, window,
               mode, cache, block_table, page_size, group=None,
               attn_impl="flash", seq: Optional[SeqShard] = None):
    """One layer's attention over the heads of ``p`` (all of them, or one
    rank's shard), on ``norm(x)``. Returns (out, new_cache).  ``seq``: a
    decode over the rank's part of a sequence-sharded cache (see
    ``Model``)."""
    B, S, _ = x.shape
    dh = cfg.d_head
    with _span(mode, "attn.proj"):
        x = copy_to(norm(x), group)
        if "wqkv" in p:
            # the fused projection: this rank's query heads' columns, then
            # its KV heads' K and V columns (``sharding``'s strided pieces)
            if group is None:
                H, KV = cfg.n_heads, cfg.n_kv_heads
            else:
                qlo, qhi = query_heads(cfg, group.rank, group.size)
                klo, khi = kv_heads(cfg, group.rank, group.size)
                H, KV = qhi - qlo, khi - klo
            q, k, v = torch.split(x @ p["wqkv"].to(x.dtype),
                                  [H * dh, KV * dh, KV * dh], dim=-1)
        else:
            H, KV = p["wq"].shape[-1] // dh, p["wk"].shape[-1] // dh
            q = x @ p["wq"].to(x.dtype)
            k = x @ p["wk"].to(x.dtype)
            v = x @ p["wv"].to(x.dtype)
        if cfg.qkv_bias:
            q = q + p["bq"].to(x.dtype)
            k = k + p["bk"].to(x.dtype)
            v = v + p["bv"].to(x.dtype)
        q = q.reshape(B, S, H, dh)
        k = k.reshape(B, S, KV, dh)
        v = v.reshape(B, S, KV, dh)
        if cfg.qk_norm:
            q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
            k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    h = x                           # the normed input: the gate reads it
    # (``rope_local_only``: a global layer attends without RoPE)
    if not (cfg.rope_local_only and window == _GLOBAL_WINDOW):
        with _span(mode, "attn.rope"):
            if mode == "train":     # autograd differentiates the plain ops
                q = rope(q, positions, cfg.rope_theta)
                k = rope(k, positions, cfg.rope_theta)
            else:                   # one kernel launch on the card
                q, k = ops.rope(q, k, positions, cfg.rope_theta)
    keep = None
    if seq is not None and seq.over_model:
        # the sequence splits over the model ranks: each attends every
        # head over its tokens and keeps its own heads after the combine
        lo, hi = query_heads(cfg, group.rank, group.size)
        keep = (lo, hi)
        q = _gather_heads(q, cfg, group, kv=False)
        k = _gather_heads(k, cfg, group, kv=True)
        v = _gather_heads(v, cfg, group, kv=True)
    elif group is not None:
        # the rank's KV heads into its KV slots, one group size for every
        # kernel (``sharding.kv_slots``; the heads themselves, unless
        # query heads straddle groups unevenly)
        k = to_slots(k, cfg, group.rank, group.size)
        v = to_slots(v, cfg, group.rank, group.size)

    if mode in ("train", "prefill") and attn_impl != "flash":
        # the dry run's plain attentions (JAX's attn_impl); folded has no
        # window, so a windowed layer takes chunked
        with _span(mode, "attn.kernel"):
            if attn_impl == "folded" and window is None:
                out = folded_causal_attention(q, k, v, lengths=lengths)
            else:
                out = chunked_attention(q, k, v, lengths=lengths,
                                        window=window)
        with _span(mode, "attn.kv_write"):
            new_cache = None if mode == "train" else _chunk_kv(k, v, cfg)
    elif mode == "train":
        out = flash_attention(q, k, v, lengths, window)
        new_cache = None
    elif mode == "prefill":
        with span("attn.kernel"):
            out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), lengths, window)
        with span("attn.kv_write"):
            new_cache = _chunk_kv(k, v, cfg)
    else:
        kc, vc = cache["k_pages"], cache["v_pages"]
        with span("attn.kv_write"):
            n_pages = kc.shape[0]
            maxp = block_table.shape[1]
            rows = torch.arange(B, device=x.device)
            if mode == "decode" and seq is not None:
                # the rank's tokens [lo, hi): local lengths, the query at
                # its local position (below 0 or past the rank's keys
                # where it lies outside them); the new K/V lands on the
                # rank holding its position, the others write past the
                # table
                pos = (lengths.long() - 1 - seq.lo)[:, None]       # (B,1)
                mine = (pos >= 0) & (pos < seq.hi - seq.lo)
            elif mode == "decode":
                pos = torch.clamp(lengths.long() - 1, min=0)[:, None]
            else:
                start = positions[:, 0].to(torch.int32)
                pos = positions.long()                              # (B,S)
            pidx = pos // page_size
            page = block_table[rows[:, None],
                               torch.clamp(pidx, min=0, max=maxp - 1)].long()
            # writes past the table land on the last page, never read
            past = pidx >= maxp if seq is None else ~mine
            page = torch.where(past, torch.full_like(page, n_pages - 1),
                               page)
            off = pos % page_size
            # in place (index_put_): the pools are the storage of every
            # slot
            kc[page, off] = k.to(kc.dtype)
            vc[page, off] = v.to(vc.dtype)
        with span("attn.kernel"):
            if mode == "decode" and seq is not None:
                local = torch.clamp(lengths - seq.lo, 0,
                                    seq.hi - seq.lo).to(torch.int32)
                out, lse = ops.paged_attention(
                    q[:, 0].contiguous(), kc, vc, block_table, local,
                    page_size=page_size, start=pos[:, 0].to(torch.int32),
                    window=window, return_lse=True)
                out = combine_lse(out, lse, seq.group, keep)[:, None]
            elif mode == "decode":
                out = ops.paged_attention(q[:, 0].contiguous(), kc, vc,
                                          block_table, lengths,
                                          page_size=page_size,
                                          window=window)[:, None]
            else:
                out = ops.paged_attention(q.contiguous(), kc, vc,
                                          block_table, lengths,
                                          page_size=page_size, start=start,
                                          window=window)
        new_cache = cache
    out = out.reshape(B, S, H * dh)
    if cfg.attn_out_gate:
        with _span(mode, "attn.gate"):
            out = out * torch.sigmoid(h @ p["wg"].to(h.dtype))
    with _span(mode, "attn.out"):
        return reduce_from(out @ p["wo"].to(x.dtype), group), new_cache


def _mlp(p, x, cfg: ArchConfig, group=None):
    x = copy_to(x, group)
    if cfg.mlp_gated:
        y = swiglu_mlp(x, p["w_gate"], p["w_up"], p["w_down"])
    else:
        y = gelu_mlp(x, p["w_in"], p["w_out"])
    return reduce_from(y, group)


def _post(p, name: str, y, cfg, norm_fn=rmsnorm):
    """A sublayer's output, through its own norm under ``sandwich_norm``."""
    return norm_fn(y, p[name], cfg.norm_eps) if cfg.sandwich_norm else y


def _attn_mlp_block(p, x, cfg, norm_fn=rmsnorm, **kw):
    h, new_cache = _attention(
        p["attn"], x, cfg, norm=lambda t: norm_fn(t, p["norm1"],
                                                  cfg.norm_eps), **kw)
    with _span(kw["mode"], "mlp"):
        x = x + _post(p, "post_attn_norm", h, cfg, norm_fn)
        f = _mlp(p["mlp"], norm_fn(x, p["norm2"], cfg.norm_eps), cfg,
                 kw["group"])
        x = x + _post(p, "post_mlp_norm", f, cfg, norm_fn)
    return x, new_cache


def _attn_moe_block(p, x, cfg, *, layer_idx, routing_hook, row_valid,
                    dp_group=None, shard_experts=False, **kw):
    """Returns (x, new_cache, the layer's MoE aux loss)."""
    h, new_cache = _attention(
        p["attn"], x, cfg, norm=lambda t: rmsnorm(t, p["norm1"],
                                                  cfg.norm_eps), **kw)
    mo = cfg.moe
    with _span(kw["mode"], "moe"):
        x = x + _post(p, "post_attn_norm", h, cfg)
        B, S, d = x.shape
        xn = rmsnorm(x, p["norm2"], cfg.norm_eps).reshape(B * S, d)
        pos_flat = valid = None
        if routing_hook is not None:
            # the flattened (B*S,) positions key the hook's per-position
            # tables; the validity mask drops pad tails (prefill/extend)
            # and, in decode, empty slots (position 0) and rows the engine
            # marked unscheduled (``row_valid``, from the negative-token
            # sentinel)
            positions, lengths = kw["positions"], kw["lengths"]
            pos_flat = positions.reshape(B * S)
            if kw["mode"] == "decode":
                valid = pos_flat > 0
                if row_valid is not None:
                    valid = valid & row_valid[:, None].expand(
                        B, S).reshape(-1)
            elif lengths is not None:
                valid = (positions < lengths[:, None]).reshape(B * S)
        y, aux = moe_ffn(xn, p["moe"], top_k=mo.top_k,
                         capacity_factor=mo.capacity_factor,
                         gated=cfg.mlp_gated, router_fn=routing_hook,
                         positions=pos_flat, layer=layer_idx, valid=valid,
                         group=kw["group"], dp_group=dp_group,
                         shard_experts=shard_experts,
                         score_func=mo.score_func,
                         route_scale=mo.route_scale, mode=kw["mode"])
        if mo.n_shared_experts:
            with _span(kw["mode"], "moe.shared"):
                q = p["moe"]
                y = y + swiglu_mlp(xn, q["shared_gate"], q["shared_up"],
                                   q["shared_down"])
        y = _post(p, "post_mlp_norm", y.reshape(B, S, d), cfg)
        return x + y, new_cache, aux


def _keep_rows(new, old, row_valid):
    """Decode: a row whose token is the sentinel keeps its old state (no
    sentinel on embeddings: ``row_valid`` None keeps every new row)."""
    if row_valid is None:
        return new
    if isinstance(new, dict):
        return {k: _keep_rows(new[k], old[k], row_valid) for k in new}
    mask = row_valid.reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(mask, new, old)


def _mamba_block(p, x, cfg, *, mode, cache, row_valid, group=None):
    """Pre-norm residual Mamba2 block; ``cache``: the layer's state (None
    in prefill and training).  Returns (x, new state; None in training).
    ``group``: this rank's heads (``models.mamba2``)."""
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    if mode == "train":
        return x + mb.mamba_forward(p["mamba"], xn, cfg, group=group), None
    if mode == "decode":
        y, st = mb.mamba_decode(p["mamba"], xn, cfg, cache, group=group)
        st = _keep_rows(st, cache, row_valid)
    else:
        y, st = mb.mamba_forward(p["mamba"], xn, cfg, state=cache,
                                 return_state=True, group=group)
    return x + y, st


def _xlstm_block(p, x, cfg, *, mode, cache, row_valid, group=None):
    """An mLSTM block, then an sLSTM block.  Returns (x, new state).
    ``group``: this rank's heads (``models.xlstm``)."""
    nh, eps = cfg.n_heads, cfg.norm_eps
    if mode == "extend":
        raise NotImplementedError(
            "xLSTM cached-prefill (extend) is not supported; the serving "
            "engine uses fresh prefill for xLSTM models")
    if mode == "decode":
        x, st_m = xl.mlstm_decode(p["mlstm"], x, nh, eps, cache["mlstm"],
                                  group=group)
        x, st_s = xl.slstm_decode(p["slstm"], x, nh, eps, cache["slstm"],
                                  group=group)
        return x, _keep_rows({"mlstm": st_m, "slstm": st_s}, cache,
                             row_valid)
    if mode == "train":
        x = xl.mlstm_forward(p["mlstm"], x, nh, eps, group=group)
        return xl.slstm_forward(p["slstm"], x, nh, eps, group=group), None
    x, st_m = xl.mlstm_forward(p["mlstm"], x, nh, eps, return_state=True,
                               group=group)
    x, st_s = xl.slstm_forward(p["slstm"], x, nh, eps, return_state=True,
                               group=group)
    return x, {"mlstm": st_m, "slstm": st_s}


def _zamba_super(p, shared, x, cfg, *, cache, row_valid, **kw):
    """Six Mamba2 blocks, then the shared attention + MLP block over the
    superblock's own K/V.  Returns (x, {"mamba": state, "attn": K/V})."""
    states = []
    for j in range(ZAMBA_INNER):
        cj = None if cache is None else _layer(cache["mamba"], j)
        x, st = _mamba_block(_layer(p["inner"], j), x, cfg, mode=kw["mode"],
                             cache=cj, row_valid=row_valid,
                             group=kw["group"])
        states.append(st)
    x, attn = _attn_mlp_block(shared, x, cfg, window=None,
                              cache=None if cache is None else cache["attn"],
                              **kw)
    if kw["mode"] == "train":
        return x, None
    return x, {"mamba": _stack(states), "attn": attn}


def _layer(tree, li):
    if isinstance(tree, dict):
        return {k: _layer(v, li) for k, v in tree.items()}
    return tree[li]


def _stack(trees):
    """Per-layer trees of tensors -> one tree of tensors stacked on dim 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _lead(tree, lead: tuple):
    """A tree of per-slot state -> the same with leading stack dims."""
    if isinstance(tree, dict):
        return {k: _lead(v, lead) for k, v in tree.items()}
    return tree.expand(lead + tuple(tree.shape)).contiguous()


# --------------------------------------------------------------------------
# the Model
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    page_size: int = 64
    # the MoE routing hook (``repro_torch.moe.hooks``): replaces the top-k
    # assignment step of every MoE layer (forced replay, logit bias or a
    # recording tap); None routes with the learned router
    routing_hook: Optional[Any] = None
    # the engine group of a tensor-parallel rank (params are then its
    # shard); None: the whole model on one device
    group: Optional[Any] = None
    # training only: the data-parallel group (the batch is then the
    # rank's rows); None: the whole batch
    dp_group: Optional[Any] = None
    # training only: recompute each layer in the backward (JAX's
    # jax.checkpoint(nothing_saveable)); the JAX model's default
    remat: bool = True
    # one fused QKV projection ``attn.wqkv`` in the attention stages
    fuse_qkv: bool = False
    # the attention + MLP blocks' norms cast their input's cotangent to
    # the compute dtype (``layers.rmsnorm_ct16``)
    norm_ct16: bool = False
    # training and prefill attention: "flash" (the kernel), or the dry
    # run's plain "chunked" / "folded" (``layers``), as in JAX
    attn_impl: str = "flash"
    # the group a decode cache's sequence splits over (``RankGrid.
    # seq_group``: the data group of a batch-1 decode, or ``group`` itself
    # under seq_shard_cache); None: every rank holds whole sequences
    seq_group: Optional[Any] = None
    # JAX's expert-buffer hint: under ``group`` the params hold whole
    # experts in the padded layout and the MoE layers carry the tokens to
    # them by all-to-all (``moe_ffn``); without a group it changes nothing
    shard_experts: bool = False

    def __post_init__(self):
        if self.attn_impl not in ("flash", "chunked", "folded"):
            raise ValueError(f"attn_impl {self.attn_impl!r}: flash, "
                             f"chunked or folded")

    @property
    def recurrent(self) -> bool:
        """Whether any stage carries per-slot recurrent state."""
        return any(st.kind in RECURRENT for st in self.cfg.stages)

    # ---- init ----
    def init(self, gen: torch.Generator, *, device=None,
             dtype=torch.float32) -> dict:
        """Params in the JAX layout; matmul weights in ``dtype``, norm
        scales and ``_F32_PARAMS`` in f32."""
        cfg = self.cfg
        kw = dict(dtype=dtype, device=device)
        params: Dict[str, Any] = {}
        if cfg.embed_inputs:
            params["embed"] = {"tok": m.embed_init(gen, cfg.padded_vocab,
                                                   cfg.d_model, **kw)}
        for i, st in enumerate(cfg.stages):
            lead = (st.n_layers,)
            if st.kind == ATTN_MOE:
                p = _init_attn_ffn(gen, cfg, lead, self.fuse_qkv, "moe",
                                   lambda: _init_moe(gen, cfg, st.n_layers,
                                                     **kw), **kw)
            elif st.kind == ATTN_MLP:
                p = _init_attn_mlp(gen, cfg, lead, self.fuse_qkv, **kw)
            elif st.kind == MAMBA2:
                p = _init_mamba_layer(gen, cfg, lead, **kw)
            elif st.kind == ZAMBA_SUPER:
                p = {"inner": _init_mamba_layer(gen, cfg,
                                                lead + (ZAMBA_INNER,), **kw)}
            else:
                p = _init_xlstm_pair(gen, cfg, lead, **kw)
            params[f"stage{i}"] = p
        if any(st.kind == ZAMBA_SUPER for st in cfg.stages):
            params["shared_attn"] = _init_attn_mlp(gen, cfg, (), **kw)
        params["final_norm"] = m.zeros((cfg.d_model,), device=device)
        params["head"] = {"w": m.dense_init(
            gen, cfg.d_model, self._n_heads_out() * cfg.padded_vocab, **kw)}
        return params

    # ---- embedding / head ----
    def _n_heads_out(self) -> int:
        return max(1, self.cfg.n_codebooks or 1)

    def _embed(self, params, tokens):
        """Token ids through the table, or precomputed ``(B, S, d)``
        embeddings (``embed_inputs=False``), in the compute dtype.  A rank
        holding a shard of the table's rows looks up the ids in its rows,
        zeros the others, and sums over the group: exact zeros and one
        row, so every rank gets the same bits as the whole table."""
        dtype = torch_dtype(self.cfg.compute_dtype)
        if not self.cfg.embed_inputs:
            return tokens.to(dtype)
        table = params["embed"]["tok"].to(dtype)
        ids = tokens.long()
        n = table.shape[0]
        if n == self.cfg.padded_vocab:
            x = table[ids]
        else:
            local = ids - self.group.rank * n
            outside = (local < 0) | (local >= n)
            x = table[local.clamp(0, n - 1)].masked_fill(outside[..., None],
                                                         0)
            x = reduce_from(x, self.group)
        if self.cfg.embed_multiplier != 1.0:
            x = x * self.cfg.embed_multiplier
        return x

    def _head(self, params, x):
        """Logits over the *padded* vocab; consumers slice [..., :vocab];
        ``(B, S, n_codebooks, padded_vocab)`` with codebook heads.  A rank
        holding a vocab shard gathers the others'."""
        cfg = self.cfg
        w = params["head"]["w"]
        split = w.shape[-1] != self._n_heads_out() * cfg.padded_vocab
        if split:
            x = copy_to(x, self.group)
        logits = x @ w.to(x.dtype)
        if split:
            logits = gather_last(logits, self.group)
        if cfg.n_codebooks:
            B, S, _ = logits.shape
            logits = logits.reshape(B, S, cfg.n_codebooks, cfg.padded_vocab)
        return logits

    def _window_for_layer(self, li: int, period: int) -> Optional[int]:
        """The window of the model's layer ``li`` (counted over every stage)
        in a stage of local:global ``period``.  None = full causal
        everywhere; global layers of a local:global interleave get a window
        wider than any context."""
        cfg = self.cfg
        if cfg.sliding_window == 0 or period == 0:
            return None
        if li % period == period - 1:
            return _GLOBAL_WINDOW
        return cfg.sliding_window

    def _layer(self, st, li, moe_layer, p, x, kcache, shared, row_valid,
               **kw):
        """One layer of stage ``st``, the model's layer ``li``: (x, its new
        cache or state, its MoE aux loss or None)."""
        cfg = self.cfg
        kw["cache"] = kcache
        if st.kind == ATTN_MOE:
            return _attn_moe_block(p, x, cfg, window=self._window_for_layer(
                                       li, st.local_global_period),
                                   layer_idx=moe_layer,
                                   routing_hook=self.routing_hook,
                                   row_valid=row_valid,
                                   dp_group=self.dp_group,
                                   shard_experts=self.shard_experts, **kw)
        if st.kind == ATTN_MLP:
            x, nc = _attn_mlp_block(
                p, x, cfg, window=self._window_for_layer(
                    li, st.local_global_period),
                norm_fn=rmsnorm_ct16 if self.norm_ct16 else rmsnorm, **kw)
        elif st.kind == MAMBA2:
            x, nc = _mamba_block(p, x, cfg, mode=kw["mode"], cache=kcache,
                                 row_valid=row_valid, group=self.group)
        elif st.kind == ZAMBA_SUPER:
            x, nc = _zamba_super(p, shared, x, cfg, row_valid=row_valid,
                                 **kw)
        else:
            x, nc = _xlstm_block(p, x, cfg, mode=kw["mode"], cache=kcache,
                                 row_valid=row_valid, group=self.group)
        return x, nc, None

    @property
    def seq_over_model(self) -> bool:
        """Whether the cache's sequence splits over the model ranks
        (``seq_shard_cache``: every rank holds every KV head)."""
        return self.seq_group is not None and self.seq_group is self.group

    def _seq(self, cache) -> Optional[SeqShard]:
        if self.seq_group is None:
            return None
        lo, hi = cache["seq_range"]
        return SeqShard(self.seq_group, lo, hi, self.seq_over_model)

    def _run_stages(self, params, x, *, positions, lengths, mode, cache,
                    block_table, row_valid=None):
        """Every stage in order: (x, the new caches by stage key, the MoE
        layers' aux loss summed, f32).  In training each layer runs under
        ``torch.utils.checkpoint`` when ``remat``, and no cache is kept."""
        cfg = self.cfg
        seq = self._seq(cache) if mode == "decode" else None
        if mode == "extend" and self.seq_group is not None:
            raise NotImplementedError(
                "a sequence-sharded cache takes decode only: extend and "
                "verify run over whole sequences (the JAX package shards "
                "only the decode cache's sequence)")
        new_caches = {}
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        moe_off = 0          # model-wide MoE layer index of the stage's 0
        layer_off = 0        # model-wide layer index of the stage's 0
        remat = mode == "train" and self.remat
        for i, st in enumerate(cfg.stages):
            key = f"stage{i}"
            sp = params[key]
            layer_caches = []
            for li in range(st.n_layers):
                p = _layer(sp, li)
                kcache = None if cache is None else _layer(cache[key], li)
                args = (st, layer_off + li, moe_off + li, p, x, kcache,
                        params.get("shared_attn"), row_valid)
                kw = dict(positions=positions, lengths=lengths, mode=mode,
                          block_table=block_table, page_size=self.page_size,
                          group=self.group, attn_impl=self.attn_impl,
                          seq=seq)
                if remat:
                    x, nc, aux = torch.utils.checkpoint.checkpoint(
                        self._layer, *args, use_reentrant=False, **kw)
                else:
                    x, nc, aux = self._layer(*args, **kw)
                if aux is not None:
                    aux_total = aux_total + aux
                layer_caches.append(nc)
            if st.kind == ATTN_MOE:
                moe_off += st.n_layers
            layer_off += st.n_layers
            if mode == "train":
                continue
            if mode == "prefill" or st.kind in (MAMBA2, XLSTM_PAIR):
                new_caches[key] = _stack(layer_caches)
            elif st.kind == ZAMBA_SUPER:
                # new Mamba state; the pools were written in place
                new_caches[key] = {
                    "mamba": _stack([c["mamba"] for c in layer_caches]),
                    "attn": cache[key]["attn"]}
            else:
                # the pools were written in place
                new_caches[key] = cache[key]
        return x, new_caches, aux_total

    # ---- entry points ----
    def forward(self, params, inputs, *, lengths=None):
        """Training/scoring forward. inputs: (B,S) ids or (B,S,d)
        embeddings.  Returns (logits over the padded vocab, the MoE aux
        loss summed over layers, f32)."""
        x = self._embed(params, inputs)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        x, _, aux = self._run_stages(params, x, positions=positions,
                                     lengths=lengths, mode="train",
                                     cache=None, block_table=None)
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        return self._head(params, x), aux

    def loss_fn(self, params, batch):
        """batch: {inputs, labels, (weights)} -> (total, metrics): the
        mean NLL over the padded vocab (averaged over codebook heads),
        weighted, plus 0.01 times the MoE aux loss.  Under ``dp_group`` the
        mean is the whole batch's: the rank's weighted sum over the global
        weight sum, summed over the group (its gradient stays the rank's
        part); the metrics are the whole batch's."""
        labels = batch["labels"]
        logits, aux = self.forward(params, batch["inputs"])
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
        if self.cfg.n_codebooks:
            nll = nll.mean(dim=-1)          # average over codebook heads
        weights = batch.get("weights")
        if weights is None:
            weights = torch.ones(nll.shape, dtype=torch.float32,
                                 device=nll.device)
        weights = weights.float()
        num, den = (nll * weights).sum(), weights.sum()
        if self.dp_group is not None:
            num = reduce_from(num, self.dp_group)
            den = self.dp_group.all_reduce_sum(den.detach().clone())
        loss = num / torch.clamp(den, min=1.0)
        total = loss + 0.01 * aux
        return total, {"loss": loss, "aux_loss": aux, "tokens": den}

    def prefill(self, params, tokens, *, lengths=None):
        """Returns (logits_last, cache). tokens: (B,S) ids or (B,S,d)
        embeddings; the cache holds the chunk's K/V contiguously, ``(L, B,
        S, KV, dh)`` per stage."""
        with span("model.prefill"):
            with span("embed"):
                x = self._embed(params, tokens)
            B, S = x.shape[:2]
            positions = torch.arange(S, device=x.device).expand(B, S)
            if lengths is None:
                lengths = torch.full((B,), S, dtype=torch.int32,
                                     device=x.device)
            x, caches, _ = self._run_stages(params, x, positions=positions,
                                            lengths=lengths, mode="prefill",
                                            cache=None, block_table=None)
            with span("head"):
                x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
                idx = torch.clamp(lengths.long() - 1, min=0)
                x_last = x[torch.arange(B, device=x.device), idx][:, None]
                logits = self._head(params, x_last)
            caches["lengths"] = lengths
            return logits, caches

    def decode(self, params, cache, tokens):
        """One decode step. tokens: (B,1) ids or (B,1,d) embeddings.

        cache["lengths"] counts tokens *already in* the cache; the new token
        is written at index lengths (then lengths+1 is returned).  A
        negative token id is the engine's sentinel for a row that is not
        scheduled this step; it runs on token 0, its recurrent state stays
        as it was, and under a routing hook its row takes no MoE capacity
        and is not recorded.  Embeddings have no sentinel."""
        with span("model.decode"):
            row_valid = None
            with span("embed"):
                if not tokens.is_floating_point():
                    row_valid = tokens.reshape(tokens.shape[0],
                                               -1)[:, 0] >= 0
                    tokens = torch.clamp(tokens, min=0)
                x = self._embed(params, tokens)
            lengths = cache["lengths"] + 1       # include current token
            positions = (lengths - 1)[:, None]
            block_table = cache["block_table"]
            x, stages, _ = self._run_stages(params, x, positions=positions,
                                            lengths=lengths, mode="decode",
                                            cache=cache,
                                            block_table=block_table,
                                            row_valid=row_valid)
            with span("head"):
                x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
                logits = self._head(params, x)
            new_cache = {"lengths": lengths, "block_table": block_table,
                         **stages}
            if "seq_range" in cache:
                new_cache["seq_range"] = cache["seq_range"]
            return logits, new_cache

    def _extend_states(self, params, cache, tokens, n_new):
        """Shared body of ``extend`` and ``verify``: append up to S tokens
        to the cache and return the hidden states of every position before
        the final norm, ``(B, S, d)``, the new cache and ``n_new``."""
        with span("embed"):
            x = self._embed(params, tokens)
        B, S = x.shape[:2]
        start = cache["lengths"]
        if n_new is None:
            n_new = torch.full((B,), S, dtype=torch.int32, device=x.device)
        lengths = (start + n_new).to(torch.int32)
        positions = start[:, None].long() + \
            torch.arange(S, device=x.device)[None, :]
        block_table = cache["block_table"]
        x, stages, _ = self._run_stages(params, x, positions=positions,
                                        lengths=lengths, mode="extend",
                                        cache=cache, block_table=block_table)
        new_cache = {"lengths": lengths, "block_table": block_table,
                     **stages}
        return x, new_cache, n_new

    def extend(self, params, cache, tokens, n_new=None):
        """Cached/chunked prefill: append up to S tokens (``n_new`` (B,)
        real, rest padding) to a cache holding cache["lengths"] tokens per
        sequence. Returns (last-real-token logits, cache)."""
        with span("model.extend"):
            x, new_cache, n_new = self._extend_states(params, cache, tokens,
                                                      n_new)
            with span("head"):
                x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
                idx = torch.clamp(n_new.long() - 1, min=0)
                x_last = x[torch.arange(x.shape[0], device=x.device),
                           idx][:, None]
                return self._head(params, x_last), new_cache

    def verify(self, params, cache, tokens, n_new=None):
        """Speculative verification: ``extend`` the cache with up to S
        tokens (the pending token and the draft's proposals) and return the
        logits at every position, ``(B, S, Vpad)``, so the caller can take
        the accepted prefix and the bonus token.  K/V of all S positions is
        written; the caller rolls ``lengths`` back to the accepted context
        (rows past it are overwritten by the next write there)."""
        with span("model.verify"):
            x, new_cache, _ = self._extend_states(params, cache, tokens,
                                                  n_new)
            with span("head"):
                x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
                return self._head(params, x), new_cache

    # ---- cache construction ----
    def page_geometry(self, batch: int, max_len: int) -> Tuple[int, int]:
        """(pages per sequence, total pool pages): ``batch * maxp`` pages to
        allocate, then one scratch page per slot (slot b's is
        ``batch * maxp + b``), then the page that takes writes past the
        table."""
        maxp = -(-max_len // self.page_size)
        return maxp, batch * maxp + batch + 1

    def kv_heads(self) -> int:
        """KV heads this model's pools hold: all, or a rank's KV slots
        (``sharding.kv_slots``: its KV heads, a head repeated where its
        query heads straddle groups unevenly; none without query heads);
        all of them where the sequence splits over the model ranks."""
        if self.group is None or self.seq_over_model:
            return self.cfg.n_kv_heads
        return len(kv_slots(self.cfg, self.group.rank, self.group.size))

    def _rank_heads(self, block: str) -> Optional[int]:
        """The heads of a recurrent ``block`` this model's state holds:
        None (all) without a group, else the rank's count
        (``sharding.recurrent_heads``)."""
        if self.group is None:
            return None
        lo, hi = recurrent_heads(self.cfg, self.group.rank, self.group.size,
                                 block)
        return hi - lo

    def init_cache(self, batch: int, max_len: int, device=None):
        """Zeroed paged cache in the compute dtype over this model's KV
        heads, every table entry of slot b at b's scratch page, and fresh
        recurrent state for every slot (``_stage_cache``'s layout; a
        rank's heads of it under a group).  Under ``seq_group`` the pools
        hold the rank's tokens ``[lo, hi)`` of each sequence
        (``sharding.seq_range`` of ``max_len``; ``cache["seq_range"]``),
        its block table addresses them from 0, and ``lengths`` stay the
        whole sequences'; the recurrent state is whole on every rank."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.compute_dtype)
        seq = None
        if self.seq_group is not None:
            g = self.seq_group
            seq = seq_range(max_len, g.rank, g.size)
            if seq[1] == seq[0]:
                raise ValueError(f"a cache of {max_len} tokens a sequence "
                                 f"leaves rank {g.rank} of {g.size} none")
            max_len = seq[1] - seq[0]
        maxp, n_pages = self.page_geometry(batch, max_len)
        scratch = batch * maxp + torch.arange(batch, dtype=torch.int32,
                                              device=device)
        cache: Dict[str, Any] = {
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device),
            "block_table": scratch[:, None].expand(batch, maxp).contiguous()}
        if seq is not None:
            cache["seq_range"] = seq

        def pools(L):
            shape = (L, n_pages, self.page_size, self.kv_heads(), cfg.d_head)
            return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                    "v_pages": torch.zeros(shape, dtype=dtype, device=device)}

        mamba = None if cfg.ssm is None else mb.init_mamba_state(
            batch, cfg.d_model, cfg.ssm, dtype, device,
            heads=self._rank_heads("mamba"))
        for i, st in enumerate(cfg.stages):
            L = st.n_layers
            if st.kind in (ATTN_MLP, ATTN_MOE):
                c = pools(L)
            elif st.kind == MAMBA2:
                c = _lead(mamba, (L,))
            elif st.kind == ZAMBA_SUPER:
                c = {"mamba": _lead(mamba, (L, ZAMBA_INNER)),
                     "attn": pools(L)}
            else:
                heads = self._rank_heads("mlstm")
                c = {"mlstm": _lead(xl.init_mlstm_state(
                        batch, cfg.d_model, cfg.n_heads, dtype, device,
                        heads), (L,)),
                     "slstm": _lead(xl.init_slstm_state(
                         batch, cfg.d_model, cfg.n_heads, device, heads),
                         (L,))}
            cache[f"stage{i}"] = c
        return cache

    # ---- the cache's parts, for the engine's slot plumbing ----
    def attention_caches(self, cache) -> list:
        """``(stage key, attention cache)`` of every stage that attends, in
        stage order: the pools ``{"k_pages", "v_pages"}`` of a serving
        cache, or the ``{"k", "v"}`` a prefill returns."""
        out = []
        for i, st in enumerate(self.cfg.stages):
            key = f"stage{i}"
            if st.kind in (ATTN_MLP, ATTN_MOE):
                out.append((key, cache[key]))
            elif st.kind == ZAMBA_SUPER:
                out.append((key, cache[key]["attn"]))
        return out

    def _state_dicts(self, cache):
        """``(stage key, sub-dict key or None, dict of state leaves, batch
        axis)`` for every dict of recurrent-state leaves, in stage order."""
        for i, st in enumerate(self.cfg.stages):
            key = f"stage{i}"
            if st.kind == MAMBA2:
                yield key, None, cache[key], 1
            elif st.kind == ZAMBA_SUPER:
                yield key, "mamba", cache[key]["mamba"], 2
            elif st.kind == XLSTM_PAIR:
                for blk in ("mlstm", "slstm"):
                    yield key, blk, cache[key][blk], 1

    def state_leaves(self, cache) -> list:
        """``(stage key, leaf name, tensor, batch axis)`` of every
        recurrent-state leaf, in a fixed order; the name is the leaf's
        dotted path inside its stage, and the batch axis is 2 for a
        superblock's ``(L, 6, B, ...)``, else 1."""
        return [(key, n if sub is None else f"{sub}.{n}", t, ax)
                for key, sub, d, ax in self._state_dicts(cache)
                for n, t in d.items()]

    def slot_view(self, cache, slot: int) -> dict:
        """The stage entries of ``cache`` with every state leaf narrowed to
        ``slot`` (a view, batch 1); the pools pass through whole."""
        out = {f"stage{i}": cache[f"stage{i}"]
               for i in range(len(self.cfg.stages))}
        for key, sub, d, ax in self._state_dicts(cache):
            view = {n: t.narrow(ax, slot, 1) for n, t in d.items()}
            out[key] = view if sub is None else {**out[key], sub: view}
        return out
