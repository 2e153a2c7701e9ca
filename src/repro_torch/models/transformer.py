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
the params are one rank's shard (``repro_torch.launch.sharding``), so
attention runs on the rank's query and KV heads, the pools hold only its KV
heads, and three collectives complete the layer: an all-reduce after the
attention output projection, one after the MLP's (or MoE's) down
projection, and an all-gather of the head's vocab shards, so every rank
samples from the same full logits.  Without a group none of them runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (ATTN_MLP, ATTN_MOE, MAMBA2, XLSTM_PAIR,
                                      ZAMBA_SUPER, ArchConfig)
from repro_torch.kernels import ops
from repro_torch.models import mamba2 as mb
from repro_torch.models import module as m
from repro_torch.models import xlstm as xl
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import (chunked_attention,
                                       folded_causal_attention, gelu_mlp,
                                       rmsnorm, rmsnorm_ct16, rope,
                                       swiglu_mlp)
from repro_torch.models.moe import moe_ffn

#: stage kinds that carry per-slot recurrent state
RECURRENT = (MAMBA2, ZAMBA_SUPER, XLSTM_PAIR)
#: zamba superblock: Mamba2 blocks before the shared attention block
ZAMBA_INNER = 6
#: params the recurrent blocks read in f32 whatever the compute dtype
_F32_PARAMS = frozenset({"A_log", "dt_bias", "D", "r_gates"})

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
    return p


def _init_mlp(gen, cfg: ArchConfig, lead: tuple, **kw) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_gated:
        return {"w_gate": m.dense_init(gen, d, ff, lead=lead, **kw),
                "w_up": m.dense_init(gen, d, ff, lead=lead, **kw),
                "w_down": m.dense_init(gen, ff, d, lead=lead, **kw)}
    return {"w_in": m.dense_init(gen, d, ff, lead=lead, **kw),
            "w_out": m.dense_init(gen, ff, d, lead=lead, **kw)}


def _init_attn_mlp(gen, cfg: ArchConfig, lead: tuple, fuse_qkv=False,
                   **kw) -> dict:
    dev = kw.get("device")
    return {"norm1": m.zeros(lead + (cfg.d_model,), device=dev),
            "attn": _init_attn(gen, cfg, lead, fuse_qkv, **kw),
            "norm2": m.zeros(lead + (cfg.d_model,), device=dev),
            "mlp": _init_mlp(gen, cfg, lead, **kw)}


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
    d, mo = cfg.d_model, cfg.moe
    router = m.dense_init(gen, d, mo.n_experts, lead=(L,),
                          device=kw.get("device")) * 0.1
    return {"router": router.to(kw.get("dtype", torch.float32)),
            "w_gate": m.dense_init(gen, d, mo.d_expert,
                                   lead=(L, mo.n_experts), **kw),
            "w_up": m.dense_init(gen, d, mo.d_expert,
                                 lead=(L, mo.n_experts), **kw),
            "w_down": m.dense_init(gen, mo.d_expert, d,
                                   lead=(L, mo.n_experts), **kw)}


# --------------------------------------------------------------------------
# block forward
# --------------------------------------------------------------------------

def _all_reduce(x, group):
    """Sum a row-parallel projection's partial outputs over the group."""
    return x if group is None else group.all_reduce_sum(x)


def _attention(p, x, cfg: ArchConfig, *, positions, lengths, window, mode,
               cache, block_table, page_size, group=None, attn_impl="flash"):
    """One layer's attention over the heads of ``p`` (all of them, or one
    rank's shard). Returns (out, new_cache)."""
    B, S, _ = x.shape
    dh = cfg.d_head
    if "wqkv" in p:
        H, KV = cfg.n_heads, cfg.n_kv_heads
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
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if mode in ("train", "prefill") and attn_impl != "flash":
        # the dry run's plain attentions (JAX's attn_impl); folded has no
        # window, so a windowed layer takes chunked
        if attn_impl == "folded" and window is None:
            out = folded_causal_attention(q, k, v, lengths=lengths)
        else:
            out = chunked_attention(q, k, v, lengths=lengths, window=window)
        new_cache = None if mode == "train" else {
            "k": k.to(torch_dtype(cfg.compute_dtype)),
            "v": v.to(torch_dtype(cfg.compute_dtype))}
    elif mode == "train":
        out = flash_attention(q, k, v, lengths, window)
        new_cache = None
    elif mode == "prefill":
        out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), lengths, window)
        new_cache = {"k": k.to(torch_dtype(cfg.compute_dtype)),
                     "v": v.to(torch_dtype(cfg.compute_dtype))}
    else:
        kc, vc = cache["k_pages"], cache["v_pages"]
        n_pages = kc.shape[0]
        maxp = block_table.shape[1]
        rows = torch.arange(B, device=x.device)
        if mode == "decode":
            pos = torch.clamp(lengths.long() - 1, min=0)[:, None]   # (B,1)
        else:
            start = positions[:, 0].to(torch.int32)
            pos = positions.long()                                  # (B,S)
        pidx = pos // page_size
        page = block_table[rows[:, None],
                           torch.clamp(pidx, max=maxp - 1)].long()
        # writes past the table land on the last page, never read
        page = torch.where(pidx < maxp, page,
                           torch.full_like(page, n_pages - 1))
        off = pos % page_size
        # in place (index_put_): the pools are the storage of every slot
        kc[page, off] = k.to(kc.dtype)
        vc[page, off] = v.to(vc.dtype)
        if mode == "decode":
            out = ops.paged_attention(q[:, 0].contiguous(), kc, vc,
                                      block_table, lengths,
                                      page_size=page_size,
                                      window=window)[:, None]
        else:
            out = ops.paged_attention(q.contiguous(), kc, vc, block_table,
                                      lengths, page_size=page_size,
                                      start=start, window=window)
        new_cache = cache
    out = out.reshape(B, S, H * dh)
    return _all_reduce(out @ p["wo"].to(x.dtype), group), new_cache


def _mlp(p, x, cfg: ArchConfig, group=None):
    if cfg.mlp_gated:
        y = swiglu_mlp(x, p["w_gate"], p["w_up"], p["w_down"])
    else:
        y = gelu_mlp(x, p["w_in"], p["w_out"])
    return _all_reduce(y, group)


def _attn_mlp_block(p, x, cfg, norm_fn=rmsnorm, **kw):
    h, new_cache = _attention(p["attn"], norm_fn(x, p["norm1"], cfg.norm_eps),
                              cfg, **kw)
    x = x + h
    x = x + _mlp(p["mlp"], norm_fn(x, p["norm2"], cfg.norm_eps), cfg,
                 kw["group"])
    return x, new_cache


def _attn_moe_block(p, x, cfg, *, layer_idx, routing_hook, row_valid,
                    **kw):
    """Returns (x, new_cache, the layer's MoE aux loss)."""
    h, new_cache = _attention(p["attn"], rmsnorm(x, p["norm1"], cfg.norm_eps),
                              cfg, **kw)
    x = x + h
    B, S, d = x.shape
    xn = rmsnorm(x, p["norm2"], cfg.norm_eps).reshape(B * S, d)
    pos_flat = valid = None
    if routing_hook is not None:
        # the flattened (B*S,) positions key the hook's per-position
        # tables; the validity mask drops pad tails (prefill/extend) and,
        # in decode, empty slots (position 0) and rows the engine marked
        # unscheduled (``row_valid``, from the negative-token sentinel)
        positions, lengths = kw["positions"], kw["lengths"]
        pos_flat = positions.reshape(B * S)
        if kw["mode"] == "decode":
            valid = pos_flat > 0
            if row_valid is not None:
                valid = valid & row_valid[:, None].expand(B, S).reshape(-1)
        elif lengths is not None:
            valid = (positions < lengths[:, None]).reshape(B * S)
    y, aux = moe_ffn(xn, p["moe"], top_k=cfg.moe.top_k,
                     capacity_factor=cfg.moe.capacity_factor,
                     gated=cfg.mlp_gated, router_fn=routing_hook,
                     positions=pos_flat, layer=layer_idx, valid=valid,
                     group=kw["group"])
    return x + y.reshape(B, S, d), new_cache, aux


def _keep_rows(new, old, row_valid):
    """Decode: a row whose token is the sentinel keeps its old state (no
    sentinel on embeddings: ``row_valid`` None keeps every new row)."""
    if row_valid is None:
        return new
    if isinstance(new, dict):
        return {k: _keep_rows(new[k], old[k], row_valid) for k in new}
    mask = row_valid.reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(mask, new, old)


def _mamba_block(p, x, cfg, *, mode, cache, row_valid):
    """Pre-norm residual Mamba2 block; ``cache``: the layer's state (None
    in prefill and training).  Returns (x, new state; None in training)."""
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    if mode == "train":
        return x + mb.mamba_forward(p["mamba"], xn, cfg), None
    if mode == "decode":
        y, st = mb.mamba_decode(p["mamba"], xn, cfg, cache)
        st = _keep_rows(st, cache, row_valid)
    else:
        y, st = mb.mamba_forward(p["mamba"], xn, cfg, state=cache,
                                 return_state=True)
    return x + y, st


def _xlstm_block(p, x, cfg, *, mode, cache, row_valid):
    """An mLSTM block, then an sLSTM block.  Returns (x, new state)."""
    nh, eps = cfg.n_heads, cfg.norm_eps
    if mode == "extend":
        raise NotImplementedError(
            "xLSTM cached-prefill (extend) is not supported; the serving "
            "engine uses fresh prefill for xLSTM models")
    if mode == "decode":
        x, st_m = xl.mlstm_decode(p["mlstm"], x, nh, eps, cache["mlstm"])
        x, st_s = xl.slstm_decode(p["slstm"], x, nh, eps, cache["slstm"])
        return x, _keep_rows({"mlstm": st_m, "slstm": st_s}, cache,
                             row_valid)
    if mode == "train":
        x = xl.mlstm_forward(p["mlstm"], x, nh, eps)
        return xl.slstm_forward(p["slstm"], x, nh, eps), None
    x, st_m = xl.mlstm_forward(p["mlstm"], x, nh, eps, return_state=True)
    x, st_s = xl.slstm_forward(p["slstm"], x, nh, eps, return_state=True)
    return x, {"mlstm": st_m, "slstm": st_s}


def _zamba_super(p, shared, x, cfg, *, cache, row_valid, **kw):
    """Six Mamba2 blocks, then the shared attention + MLP block over the
    superblock's own K/V.  Returns (x, {"mamba": state, "attn": K/V})."""
    states = []
    for j in range(ZAMBA_INNER):
        cj = None if cache is None else _layer(cache["mamba"], j)
        x, st = _mamba_block(_layer(p["inner"], j), x, cfg, mode=kw["mode"],
                             cache=cj, row_valid=row_valid)
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
                p = {"norm1": m.zeros(lead + (cfg.d_model,), device=device),
                     "attn": _init_attn(gen, cfg, lead, self.fuse_qkv, **kw),
                     "norm2": m.zeros(lead + (cfg.d_model,), device=device),
                     "moe": _init_moe(gen, cfg, st.n_layers, **kw)}
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
        embeddings (``embed_inputs=False``), in the compute dtype."""
        dtype = torch_dtype(self.cfg.compute_dtype)
        if not self.cfg.embed_inputs:
            return tokens.to(dtype)
        return params["embed"]["tok"].to(dtype)[tokens.long()]

    def _head(self, params, x):
        """Logits over the *padded* vocab; consumers slice [..., :vocab];
        ``(B, S, n_codebooks, padded_vocab)`` with codebook heads.  A rank
        holding a vocab shard gathers the others'."""
        cfg = self.cfg
        w = params["head"]["w"]
        logits = x @ w.to(x.dtype)
        if w.shape[-1] != self._n_heads_out() * cfg.padded_vocab:
            logits = self.group.all_gather_last(logits)
        if cfg.n_codebooks:
            B, S, _ = logits.shape
            logits = logits.reshape(B, S, cfg.n_codebooks, cfg.padded_vocab)
        return logits

    def _window_for_layer(self, li: int, period: int) -> Optional[int]:
        """None = full causal everywhere; global layers of a local:global
        interleave get a window wider than any context."""
        cfg = self.cfg
        if cfg.sliding_window == 0 or period == 0:
            return None
        if li % period == period - 1:
            return _GLOBAL_WINDOW
        return cfg.sliding_window

    def _layer(self, st, li, moe_layer, p, x, kcache, shared, row_valid,
               **kw):
        """One layer of stage ``st``: (x, its new cache or state, its MoE
        aux loss or None)."""
        cfg = self.cfg
        kw["cache"] = kcache
        if st.kind == ATTN_MOE:
            # MoE layers attend without a window, as in JAX
            return _attn_moe_block(p, x, cfg, window=None,
                                   layer_idx=moe_layer,
                                   routing_hook=self.routing_hook,
                                   row_valid=row_valid, **kw)
        if st.kind == ATTN_MLP:
            x, nc = _attn_mlp_block(
                p, x, cfg, window=self._window_for_layer(
                    li, st.local_global_period),
                norm_fn=rmsnorm_ct16 if self.norm_ct16 else rmsnorm, **kw)
        elif st.kind == MAMBA2:
            x, nc = _mamba_block(p, x, cfg, mode=kw["mode"], cache=kcache,
                                 row_valid=row_valid)
        elif st.kind == ZAMBA_SUPER:
            x, nc = _zamba_super(p, shared, x, cfg, row_valid=row_valid,
                                 **kw)
        else:
            x, nc = _xlstm_block(p, x, cfg, mode=kw["mode"], cache=kcache,
                                 row_valid=row_valid)
        return x, nc, None

    def _run_stages(self, params, x, *, positions, lengths, mode, cache,
                    block_table, row_valid=None):
        """Every stage in order: (x, the new caches by stage key, the MoE
        layers' aux loss summed, f32).  In training each layer runs under
        ``torch.utils.checkpoint`` when ``remat``, and no cache is kept."""
        cfg = self.cfg
        new_caches = {}
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        moe_off = 0          # model-wide MoE layer index of the stage's 0
        remat = mode == "train" and self.remat
        for i, st in enumerate(cfg.stages):
            key = f"stage{i}"
            sp = params[key]
            layer_caches = []
            for li in range(st.n_layers):
                p = _layer(sp, li)
                kcache = None if cache is None else _layer(cache[key], li)
                args = (st, li, moe_off + li, p, x, kcache,
                        params.get("shared_attn"), row_valid)
                kw = dict(positions=positions, lengths=lengths, mode=mode,
                          block_table=block_table, page_size=self.page_size,
                          group=self.group, attn_impl=self.attn_impl)
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
        weighted, plus 0.01 times the MoE aux loss."""
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
        loss = (nll * weights).sum() / torch.clamp(weights.sum(), min=1.0)
        total = loss + 0.01 * aux
        return total, {"loss": loss, "aux_loss": aux,
                       "tokens": weights.sum()}

    def prefill(self, params, tokens, *, lengths=None):
        """Returns (logits_last, cache). tokens: (B,S) ids or (B,S,d)
        embeddings; the cache holds the chunk's K/V contiguously, ``(L, B,
        S, KV, dh)`` per stage."""
        x = self._embed(params, tokens)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32,
                                 device=x.device)
        x, caches, _ = self._run_stages(params, x, positions=positions,
                                        lengths=lengths, mode="prefill",
                                        cache=None, block_table=None)
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        idx = torch.clamp(lengths.long() - 1, min=0)
        x_last = x[torch.arange(B, device=x.device), idx][:, None]
        caches["lengths"] = lengths
        return self._head(params, x_last), caches

    def decode(self, params, cache, tokens):
        """One decode step. tokens: (B,1) ids or (B,1,d) embeddings.

        cache["lengths"] counts tokens *already in* the cache; the new token
        is written at index lengths (then lengths+1 is returned).  A
        negative token id is the engine's sentinel for a row that is not
        scheduled this step; it runs on token 0, its recurrent state stays
        as it was, and under a routing hook its row takes no MoE capacity
        and is not recorded.  Embeddings have no sentinel."""
        row_valid = None
        if not tokens.is_floating_point():
            row_valid = tokens.reshape(tokens.shape[0], -1)[:, 0] >= 0
            tokens = torch.clamp(tokens, min=0)
        x = self._embed(params, tokens)
        lengths = cache["lengths"] + 1       # include current token
        positions = (lengths - 1)[:, None]
        block_table = cache["block_table"]
        x, stages, _ = self._run_stages(params, x, positions=positions,
                                        lengths=lengths, mode="decode",
                                        cache=cache, block_table=block_table,
                                        row_valid=row_valid)
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        new_cache = {"lengths": lengths, "block_table": block_table,
                     **stages}
        return self._head(params, x), new_cache

    def _extend_states(self, params, cache, tokens, n_new):
        """Shared body of ``extend`` and ``verify``: append up to S tokens
        to the cache and return the final-norm hidden states of every
        position, ``(B, S, d)``, the new cache and ``n_new``."""
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
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        new_cache = {"lengths": lengths, "block_table": block_table,
                     **stages}
        return x, new_cache, n_new

    def extend(self, params, cache, tokens, n_new=None):
        """Cached/chunked prefill: append up to S tokens (``n_new`` (B,)
        real, rest padding) to a cache holding cache["lengths"] tokens per
        sequence. Returns (last-real-token logits, cache)."""
        x, new_cache, n_new = self._extend_states(params, cache, tokens,
                                                  n_new)
        idx = torch.clamp(n_new.long() - 1, min=0)
        x_last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
        return self._head(params, x_last), new_cache

    def verify(self, params, cache, tokens, n_new=None):
        """Speculative verification: ``extend`` the cache with up to S
        tokens (the pending token and the draft's proposals) and return the
        logits at every position, ``(B, S, Vpad)``, so the caller can take
        the accepted prefix and the bonus token.  K/V of all S positions is
        written; the caller rolls ``lengths`` back to the accepted context
        (rows past it are overwritten by the next write there)."""
        x, new_cache, _ = self._extend_states(params, cache, tokens, n_new)
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
        """KV heads this model's pools hold: all, or a rank's share."""
        if self.group is None:
            return self.cfg.n_kv_heads
        from repro_torch.launch.sharding import kv_heads
        lo, hi = kv_heads(self.cfg, self.group.rank, self.group.size)
        return hi - lo

    def init_cache(self, batch: int, max_len: int, device=None):
        """Zeroed paged cache in the compute dtype over this model's KV
        heads, every table entry of slot b at b's scratch page, and fresh
        recurrent state for every slot (``_stage_cache``'s layout)."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.compute_dtype)
        maxp, n_pages = self.page_geometry(batch, max_len)
        scratch = batch * maxp + torch.arange(batch, dtype=torch.int32,
                                              device=device)
        cache: Dict[str, Any] = {
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device),
            "block_table": scratch[:, None].expand(batch, maxp).contiguous()}

        def pools(L):
            shape = (L, n_pages, self.page_size, self.kv_heads(), cfg.d_head)
            return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                    "v_pages": torch.zeros(shape, dtype=dtype, device=device)}

        mamba = None if cfg.ssm is None else mb.init_mamba_state(
            batch, cfg.d_model, cfg.ssm, dtype, device)
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
                c = {"mlstm": _lead(xl.init_mlstm_state(
                        batch, cfg.d_model, cfg.n_heads, dtype, device),
                        (L,)),
                     "slstm": _lead(xl.init_slstm_state(
                         batch, cfg.d_model, cfg.n_heads, device), (L,))}
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
