"""Mixture-of-Experts FFN with top-k routing and sort-based dispatch.

The counterpart of ``repro/models/moe.py`` on its ``backend="pallas"``
branch: tokens are sorted by expert id, packed into per-expert capacity
buffers, run through the grouped expert matmul (``kernels.ops.moe_gmm``:
the Hopper kernel for CUDA tensors, its plain version for CPU tensors)
three times (gate, up, down; twice for the GELU path) and combined back
with their weights.  Capacity overflow is dropped.  The combine
(``combine``) adds each token's weighted rows one after another in
ascending sorted position, rounding in the compute dtype after each add:
the order in which JAX's ``.at[tok_of].add`` runs on the CPU, so the two
agree bitwise in f32 and bf16, and with no float atomics the sum repeats
on the card at any top-k (``index_add_``'s atomics reordered it there
past top-2).  In training the three products go through
``grouped_matmul``, an autograd Function whose backward is
``kernels.ops.moe_gmm_bwd`` (the Hopper kernel on the card, its plain
version on the CPU): the JAX package differentiates its einsum branch
with XLA's autodiff instead.

Under tensor parallelism (``group``) the router and the top-k run on every
rank (the router is replicated), so the capacity and the drops equal tp =
1's.  With expert parallelism (the rank's params hold E / tp whole
experts, ``repro_torch.launch.sharding``) a rank dispatches only the
entries routed to its experts, in the same order and at the same slots as
tp = 1, and sends the others to the trash bucket; otherwise every rank
dispatches every entry through its slice of each expert's hidden dim.
Either way a rank's combine is a partial sum, all-reduced over the group
(``collectives.reduce_from``); in training the dispatched tokens and the
combine weights enter through ``collectives.copy_to``, so the tokens and
the router get the sum of the ranks' partial gradients.

Under ``shard_experts`` (the JAX model's hint that pins the expert buffers
to the model axis, so that GSPMD routes the tokens with one all-to-all)
the port does explicitly what the hint asks of GSPMD.  The rank's params
hold whole experts in GSPMD's padded layout (``sharding.expert_range``:
ceil(E / tp) a rank from rank 0, a later rank fewer or none).  Every rank
still routes every token and decides the drops as tp = 1 does, the
routing being replicated; then each takes its share of the tokens
(``sharding.head_range(T, rank, tp)``, ``collectives.take_rows``; none
past T, as at decode), and one all-to-all (``collectives.all_to_all``)
carries its kept entries to the ranks of their experts in static blocks:
``n_s = min(C, ceil(T / tp))`` rows an expert from every rank, the most
any routing can put there (the top-k experts of a token are distinct; a
routing hook may repeat one, so ``n_s`` is then ``min(C, ceil(T / tp) ·
k)``).  The splits depend on shapes only, so a rank's bytes are its meta
count.  A rank scatters what it receives into the ``(E_loc, n, d)``
buffer that the expert-parallel path builds for the same experts, row
for row, runs the grouped matmul on it (none for a rank with no expert,
which still joins every collective with empty blocks), and a second
all-to-all sends the rows back.  Each rank combines its own tokens, and
``collectives.gather_rows`` all-gathers them over the group: no
all-reduce.  A rank adds its tokens' rows in tp = 1's order, so on the
CPU the gathered output equals tp = 1's bitwise.  Without a group the
flag changes nothing, as the hint changes nothing on one device.  The
JAX package turns its Pallas kernel off under the hint; the port keeps
its grouped matmul.

Under data parallelism (``dp_group``, training) the routing is the whole
batch's, as JAX's over its global microbatch: the capacity comes from the
global token count, and since the stable sort orders entries token-major
and the ranks hold consecutive rows, a rank's entries of expert e take the
slots after the lower ranks' (one all-gather of the E routed counts a
layer gives the offsets), so the drops are the global batch's.  A rank
computes only its own kept entries.  The Switch aux loss takes the global
mean probability and routed fraction.

The JAX dispatch buffer is ``(E, C + 1, d)`` with an overflow slot per
expert that dropped entries all write to ``(0, C)``.  Here each expert
holds ``n = min(C, T)`` rows, T the rank's tokens (C under a routing
hook): the router gives an expert at most one entry a token, so a rank
keeps at most ``min(room, count) <= n`` of them (under data parallelism C
is the whole batch's and can be many times T).  The buffer is ``(E * n + 1, d)`` with the one overflow row at the
end, so the first ``E * n`` rows are the contiguous ``(E, n, d)`` input the
kernel takes, and a kept entry's row is its rank-local position, the same
whatever n.  Dropped entries read back row ``n - 1`` of expert 0 with
weight 0, as JAX's read a clamped row, so they add exactly 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.expert import expert_capacity
from repro_torch.kernels import ops
from repro_torch.launch.collectives import (all_to_all, copy_to,
                                           gather_rows, reduce_from,
                                           take_rows)
from repro_torch.launch.sharding import expert_range, head_range
from repro_torch.obs.spans import mode_span


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return ops.moe_gmm(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dx, dw = ops.moe_gmm_bwd(x, w, group_sizes, dy.contiguous())
        return dx, dw, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """``ops.moe_gmm`` with a gradient when one is needed: x (E,C,d), w
    (E,d,f) -> (E,C,f); ``group_sizes`` gets none.  Without one (the
    serve, ``no_grad``) it is the plain ``ops.moe_gmm`` call."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedMatmul.apply(x, w, group_sizes)
    return ops.moe_gmm(x, w, group_sizes)


def normalize_topk(probs: torch.Tensor, top_k: int):
    """Top-k of ``probs`` with its weights renormalised to sum to 1:
    (expert_idx (T,k) int64, combine_w (T,k) f32).  Ties go to the lower
    index, as ``jax.lax.top_k`` breaks them: a stable descending sort, since
    ``torch.topk`` promises no order (exact ties are common with bf16
    router logits)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    combine_w, expert_idx = vals[..., :top_k], idx[..., :top_k]
    combine_w = combine_w / torch.clamp(combine_w.sum(-1, keepdim=True),
                                        min=1e-9)
    return expert_idx, combine_w


def sigmoid_topk(x, w_router, top_k: int, bias=None,
                 route_scale: float = 1.0):
    """The sigmoid router (``MoECfg.score_func == "sigmoid"``): scores
    ``s = sigmoid(x @ w_router)`` with the product in f32, the top k of ``s
    + bias`` chosen (``bias`` (E,), selection only; ties to the lower index,
    a stable descending sort), their weights ``s`` renormalised (``+ 1e-20``)
    and scaled by ``route_scale``: (expert_idx (T,k) int32, combine_w (T,k)
    f32, aux 0; no balance loss)."""
    s = torch.sigmoid(x.float() @ w_router.float())            # (T, E)
    pick = s if bias is None else s + bias.float()
    expert_idx = torch.sort(pick, dim=-1, descending=True,
                            stable=True).indices[..., :top_k]
    w = s.gather(-1, expert_idx)
    combine_w = w / (w.sum(-1, keepdim=True) + 1e-20) * route_scale
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return expert_idx.to(torch.int32), combine_w, aux


def router_topk(x, w_router, top_k: int, dp_group=None):
    """Return (expert_idx (T,k) int32, combine_w (T,k) f32, aux_loss);
    under ``dp_group`` the aux loss is the whole batch's."""
    logits = (x @ w_router.to(x.dtype)).float()               # (T, E)
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    expert_idx, combine_w = normalize_topk(probs, top_k)
    # Switch-style load-balancing aux loss: E * sum_e f_e * p_e
    flat = expert_idx.reshape(-1)
    hits = torch.zeros((E,), dtype=torch.float32, device=x.device) \
        .index_add_(0, flat, torch.ones(flat.shape, device=x.device))
    if dp_group is None:
        me = probs.mean(dim=0)
        ce = hits / flat.numel()
    else:
        n = dp_group.size
        me = reduce_from(probs.sum(dim=0), dp_group) / (probs.shape[0] * n)
        ce = dp_group.all_reduce_sum(hits) / (flat.numel() * n)
    aux = E * torch.sum(me * ce)
    return expert_idx.to(torch.int32), combine_w, aux


def entries_by_token(tok_of: torch.Tensor, top_k: int, lo: int = 0,
                     n_tok: int | None = None) -> torch.Tensor:
    """The sorted positions of the entries of tokens ``lo`` to ``lo + n_tok
    - 1`` (every token when ``n_tok`` is None), each token's ``top_k``
    consecutive and ascending: ``tok_of`` (T * top_k,) is the token of
    each sorted entry, and every token has exactly ``top_k``."""
    pos = torch.argsort(tok_of, stable=True)
    return pos if n_tok is None else pos[lo * top_k:(lo + n_tok) * top_k]


def combine(rows: torch.Tensor, w: torch.Tensor, top_k: int) -> torch.Tensor:
    """The MoE combine: y (T, d) from ``rows`` (T * top_k, d), the entries'
    expert outputs, and ``w`` (T * top_k,), their combine weights in
    ``rows``' dtype, each token's ``top_k`` entries consecutive in ascending
    sorted position (``entries_by_token``).  Each product is rounded to
    the dtype, then a token's products are added one after another, every
    add rounded: the order of JAX's ``jnp.zeros((T, d)).at[tok_of].add(
    contrib)``, which XLA:CPU runs update by update in index order.  So y
    equals JAX's bitwise in f32 and bf16 (JAX's sum starts from +0, so a
    token whose every product is -0 gives -0 here and +0 there), and the
    sum takes no float atomics and repeats on the card.  ``top_k``
    launches: the product and ``top_k - 1`` adds (``sum`` over k would
    accumulate bf16 in f32: another result)."""
    contrib = (rows * w[:, None]).view(-1, top_k, rows.shape[-1])
    y = contrib[:, 0]
    for j in range(1, top_k):
        y = y + contrib[:, j]
    return y


def _expert_ffn(hidden_in, params, group_sizes, gated: bool, dtype):
    """The grouped expert FFN on ``(E, n, d)``: three launches of the
    grouped matmul (two on the GELU path).  Rows at or past a group's size
    come out 0 either way.  The casts stay outside the Function, so dw
    reaches f32 params through them."""
    if gated:
        g = F.silu(grouped_matmul(hidden_in, params["w_gate"].to(dtype),
                                  group_sizes))
        u = grouped_matmul(hidden_in, params["w_up"].to(dtype), group_sizes)
        h = g * u
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(grouped_matmul(hidden_in, params["w_up"].to(dtype),
                                  group_sizes), approximate="tanh")
    return grouped_matmul(h, params["w_down"].to(dtype), group_sizes)


def _pad_row(t: torch.Tensor) -> torch.Tensor:
    """``t`` (rows, ...) with one zero row after its last: the row that
    entries which move nothing read."""
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


def _experts_on_ranks(x, combine_w, params, group, *, order, tok_of,
                      s_sorted, pos_in_e, keep, group_sizes, n: int,
                      n_s: int, top_k: int, gated: bool):
    """``shard_experts`` under a group (the module docstring): the
    entries' rows to their experts' ranks and back by two all-to-alls,
    each rank's tokens combined and gathered over the group.  The sorted
    entries, their positions, drops and group sizes are the whole
    routing's, the same on every rank; returns y (T, d)."""
    T, d = x.shape
    tp, me = group.size, group.rank
    E = group_sizes.shape[0]
    dev = x.device
    tok_n = [hi - lo for lo, hi in (head_range(T, r, tp) for r in range(tp))]
    exp_n = [hi - lo for lo, hi in (expert_range(E, r, tp)
                                    for r in range(tp))]
    tlo, T_loc = sum(tok_n[:me]), tok_n[me]
    elo, E_loc = sum(exp_n[:me]), exp_n[me]
    ct = -(-T // tp)
    idx = torch.arange(T * top_k, device=dev)
    # each entry's source rank (its token's) and its index j among the
    # entries of its (expert, source) pair: the entries of one expert are
    # token-major, so a pair's are consecutive
    src = tok_of // ct
    key = s_sorted * tp + src
    per = torch.zeros(((E + 1) * tp,), dtype=torch.long, device=dev) \
        .scatter_add_(0, key, torch.ones_like(key))
    j = idx - (torch.cumsum(per, 0) - per)[key]
    # send: rank me's kept entries, row e * n_s + j (rank s's block is its
    # experts' rows, E_loc(s) * n_s); the rest into the overflow row
    sent = keep & (src == me)
    mine = tok_of - tlo
    buf = torch.zeros((E * n_s + 1, d), dtype=x.dtype, device=dev)
    xd = _pad_row(take_rows(x, group, tok_n))
    buf[torch.where(sent, s_sorted * n_s + j, E * n_s)] = \
        xd[torch.where(sent, mine, T_loc)]
    recv = all_to_all(buf[:E * n_s], group, [k * n_s for k in exp_n],
                      [E_loc * n_s] * tp)
    # receive: rank r's rows of expert e into the buffer the
    # expert-parallel path builds, row (e - elo) * n + pos_in_e
    held = keep & (s_sorted >= elo) & (s_sorted < elo + E_loc)
    rrow = torch.where(held, src * (E_loc * n_s) + (s_sorted - elo) * n_s
                       + j, tp * E_loc * n_s)
    brow = torch.where(held, (s_sorted - elo) * n + pos_in_e, E_loc * n)
    hidden = torch.zeros((E_loc * n + 1, d), dtype=x.dtype, device=dev)
    hidden[brow] = _pad_row(recv)[rrow]
    hidden_in = hidden[:E_loc * n].view(E_loc, n, d)
    # a rank with no expert launches nothing; its empty buffer keeps the
    # backward's path through both all-to-alls
    # (the rank's group sizes copied: the kernel takes them 16-byte aligned)
    out_e = hidden_in if E_loc == 0 else _expert_ffn(
        hidden_in, params, group_sizes[elo:elo + E_loc].clone(), gated,
        x.dtype)
    back = torch.zeros((tp * E_loc * n_s + 1, d), dtype=x.dtype, device=dev)
    back[rrow] = _pad_row(out_e.reshape(E_loc * n, d))[brow]
    got = all_to_all(back[:tp * E_loc * n_s], group, [E_loc * n_s] * tp,
                     [k * n_s for k in exp_n])
    # combine the rank's tokens, each in ascending sorted position as at tp
    # = 1 (a dropped entry reads the zero row past the received ones)
    pos = entries_by_token(tok_of, top_k, tlo, T_loc)
    kept = keep[pos]
    rows = _pad_row(got)[torch.where(kept, (s_sorted * n_s + j)[pos],
                                     E * n_s)]
    cw = take_rows(combine_w, group, tok_n).reshape(-1)
    w = (cw[order[pos] - tlo * top_k] * kept).to(x.dtype)
    y = combine(rows, w, top_k)
    return gather_rows(y, group, tok_n)


def moe_ffn(x, params, *, top_k: int, capacity_factor: float = 1.25,
            gated: bool = True, router_fn=None, positions=None, layer=None,
            valid=None, group=None, dp_group=None,
            shard_experts: bool = False, score_func: str = "softmax",
            route_scale: float = 1.0, mode: str = "train"):
    """x: (T, d). params: router (d,E), w_gate/w_up (E,d,de), w_down (E,de,d).

    ``router_fn`` is the injectable routing hook (``repro_torch.moe.hooks``):
    called as ``router_fn(logits, positions=(T,), layer=int, top_k=int,
    valid=(T,) bool or None)`` and returning ``(expert_idx (T,k), combine_w
    (T,k), aux)``.  It replaces only the assignment step.  ``valid`` flags
    the rows that are real workload tokens; invalid rows sort into a trash
    bucket past every expert and go straight to the overflow slot, so they
    take no real token's capacity.  With ``valid=None`` every row routes
    and competes for capacity (pad tails included), as in JAX.  ``group``
    (an engine group) makes ``params`` one rank's shard, and ``dp_group``
    ``x`` one data-parallel rank's tokens; ``shard_experts`` with a group,
    ``params`` hold the rank's whole experts in the padded layout and the
    tokens reach them by all-to-all; see the module docstring.

    ``score_func`` "sigmoid" routes by ``sigmoid_topk`` with the layer's
    ``params["expert_bias"]`` and ``route_scale``.  In a serving ``mode``
    the ``moe.*`` spans wrap the route, the dispatch, the experts and the
    combine.
    """
    T, d = x.shape
    E = params["router"].shape[-1]
    a2a = shard_experts and group is not None
    # E / tp under expert parallel; under shard_experts the routing is
    # dispatched over every expert, as at tp = 1
    E_loc = E if a2a else params["w_down"].shape[0]
    first = 0 if group is None or E_loc == E else group.rank * E_loc
    with mode_span(mode, "moe.route"):
        if router_fn is not None:
            if dp_group is not None:
                raise ValueError("moe_ffn: a routing hook under data "
                                 "parallelism")
            logits = (x @ params["router"].to(x.dtype)).float()
            expert_idx, combine_w, aux = router_fn(
                logits, positions=positions, layer=layer, top_k=top_k,
                valid=valid)
        elif score_func == "sigmoid":
            expert_idx, combine_w, aux = sigmoid_topk(
                x, params["router"], top_k, params.get("expert_bias"),
                route_scale)
        else:
            expert_idx, combine_w, aux = router_topk(x, params["router"],
                                                     top_k, dp_group)
    with mode_span(mode, "moe.dispatch"):
        ndp = 1 if dp_group is None else dp_group.size
        C = expert_capacity(T * ndp, top_k, E, capacity_factor)
        if not a2a:
            # the sharded region: the tokens dispatched and the combine
            # weights
            xd = copy_to(x, group)
            combine_w = copy_to(combine_w, group)

        # --- dispatch: sort (token, k) pairs by expert ----------------------
        # (this rank's experts renumbered from 0; the others and invalid rows
        # into the trash bucket E_loc, past every expert)
        flat_e = expert_idx.reshape(-1).long() - first          # (T*k,)
        routed = (flat_e >= 0) & (flat_e < E_loc) if E_loc != E else None
        if valid is not None:
            v = valid[:, None].expand(T, top_k).reshape(-1)
            routed = v if routed is None else routed & v
        if routed is None:
            sort_e = flat_e
        else:
            sort_e = torch.where(routed, flat_e,
                                 torch.full_like(flat_e, E_loc))
        order = torch.argsort(sort_e, stable=True)
        tok_of = order // top_k                             # token per entry
        e_sorted = flat_e[order]
        s_sorted = sort_e[order]
        # position within expert group = rank - group_start[expert]
        # (scatter_add_, not bincount: bincount syncs the host on the card)
        counts = torch.zeros((E_loc + 1,), dtype=torch.long,
                             device=x.device) \
            .scatter_add_(0, sort_e, torch.ones_like(sort_e))
        starts = torch.cumsum(counts, 0) - counts
        pos_in_e = torch.arange(T * top_k, device=x.device) \
            - starts[s_sorted]
        # the slots the lower data-parallel ranks take in each expert first
        slot, room = pos_in_e, C
        if dp_group is not None:
            every = expert_idx.reshape(-1).long()
            if valid is not None:
                every = torch.where(v, every, torch.full_like(every, E))
            mine = torch.zeros((E + 1,), dtype=torch.long, device=x.device) \
                .scatter_add_(0, every, torch.ones_like(every))
            ranks = dp_group.all_gather_dim(mine[None], 0)   # (dp, E + 1)
            below = ranks[:dp_group.rank].sum(dim=0)
            offset = torch.zeros((E_loc + 1,), dtype=torch.long,
                                 device=x.device)
            offset[:E_loc] = below[first:first + E_loc]
            slot = pos_in_e + offset[s_sorted]
            room = torch.clamp(C - offset[:E_loc], min=0)
        keep = (slot < C) & (s_sorted < E_loc)              # capacity drop
        # the rows an expert holds here: a kept entry's pos_in_e is below C
        # and, the router's top-k being distinct experts, below T (a hook's
        # routing may repeat an expert within a token: C then)
        n = min(C, T) if router_fn is None else C
        group_sizes = torch.clamp(counts[:E_loc], max=room).to(torch.int32)
        if not a2a:
            # flat buffer row: expert * n + pos_in_e, the overflow row
            # E_loc * n
            dst = torch.where(keep, e_sorted * n + pos_in_e,
                              torch.full_like(pos_in_e, E_loc * n))
            buf = torch.zeros((E_loc * n + 1, d), dtype=x.dtype,
                              device=x.device)
            buf[dst] = xd[tok_of]
            hidden_in = buf[:E_loc * n].view(E_loc, n, d)
    if a2a:
        ct = -(-T // group.size)
        n_s = min(C, ct if router_fn is None else ct * top_k)
        y = _experts_on_ranks(x, combine_w, params, group, order=order,
                              tok_of=tok_of, s_sorted=s_sorted,
                              pos_in_e=pos_in_e, keep=keep,
                              group_sizes=group_sizes, n=n, n_s=n_s,
                              top_k=top_k, gated=gated)
        return y, aux

    # --- grouped expert FFN: three launches of the grouped matmul -----------
    with mode_span(mode, "moe.experts"):
        out_e = _expert_ffn(hidden_in, params, group_sizes, gated, x.dtype)

    # --- combine: gather back and weight, in JAX's order ---------------------
    # dropped entries read expert 0's row n - 1 (JAX's clamp of slot C)
    # with weight 0; each token's entries in ascending sorted position
    with mode_span(mode, "moe.combine"):
        src = torch.where(keep, dst, n - 1)
        w = (combine_w.reshape(-1)[order] * keep).to(x.dtype)
        pos = entries_by_token(tok_of, top_k)
        y = combine(out_e.reshape(E_loc * n, d)[src[pos]], w[pos], top_k)
        return reduce_from(y, group), aux
