"""Collectives under autograd: the transposes GSPMD derives for the JAX
package, written out for explicit tensor and data parallelism.

Megatron's pair and the head's gather, each an autograd Function over an
engine group (``repro_torch.launch.mesh``):

* :func:`copy_to` (``f``): identity forward, all-reduce of the gradient
  backward.  It stands at the input of every region that a rank computes
  only a part of (a column-parallel projection, the MoE dispatch, the
  combine weights), so the replicated tensor before it gets the sum of
  the ranks' partial gradients;
* :func:`reduce_from` (``g``): all-reduce forward, identity backward.  It
  closes such a region (a row-parallel projection's partial sums, the MoE
  combine, the vocab-parallel embedding's lookup) and, over the
  data-parallel group, makes a per-rank partial sum global (the loss's
  numerator, the router's mean probability) while each rank keeps the
  gradient of its own part;
* :func:`gather_last` : all-gather of the last dim forward, the rank's
  slice of the gradient backward (the head's vocab shards; with
  ``counts``, parts of different widths: the recurrent blocks' heads in
  GSPMD's padded layout, where a later rank holds fewer heads, or none.
  Each part is padded to the widest, gathered and cut back, and the
  backward's slice is the rank's own width at its offset).  Where every
  rank then reads only its columns of the gathered tensor (the mLSTM's
  ``cx`` and ``x_in`` before ``w_q``/``w_k``/``w_v``, the sLSTM's ``h``
  before its column-parallel FFN), a :func:`copy_to` follows the gather,
  so the two together are a reduce-scatter backward;
* :func:`take_rows` / :func:`gather_rows`: a rank's share of a replicated
  tensor's rows (``counts[r]`` rows a rank, in rank order: the MoE layer's
  tokens under ``shard_experts``, GSPMD's padded layout) and back.
  ``take_rows`` slices forward and all-gathers the ranks' row gradients
  backward, so the replicated input gets its whole gradient (as
  :func:`copy_to` gives it); ``gather_rows`` all-gathers the ranks' rows
  forward (each part padded to the widest) and takes the rank's rows of
  the gradient backward, which every rank holds whole after it (never an
  all-reduce: that would count it tp times);
* :func:`all_to_all`: rows to their ranks with static splits forward, the
  reverse all-to-all backward (the MoE layer's dispatch to the ranks that
  hold the experts and the return of their outputs);
* :func:`norm_stat`: a statistic summed over the ranks that every rank's
  outputs read (the mean square of a norm over a feature dim the ranks
  split: Mamba2's gated norm, the mLSTM's ``norm_h``), ``copy_to`` after
  ``reduce_from``: an all-reduce forward and an all-reduce of the
  gradient backward.

One more, outside autograd (inference only, as JAX shards only the decode
cache's sequence): :func:`combine_lse` merges the partial decode
attentions of ranks that each hold a range of a sequence's keys (a
split-KV decode across ranks), by the log-sum-exp each rank's kernel
writes beside its output.

Without a group each is the identity.  Without autograd (``no_grad``, or
an input that needs no gradient) each runs the plain collective, in place
for the all-reduce, as the serving engine always has.
"""
from __future__ import annotations

import torch


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.group.all_reduce_sum(dy.contiguous().clone()), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = group.all_reduce_sum(x)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def gather_parts(x: torch.Tensor, group, counts, dim: int = -1,
                 gather=None) -> list:
    """Every rank's ``x`` (``counts[r]`` wide along ``dim`` on rank r), in
    rank order (a collective, no autograd): each padded to the widest,
    all-gathered, cut back.  ``gather(x, dim)`` is the group's all-gather
    (``group.all_gather_dim`` by default, on ``x``'s device)."""
    dim %= x.dim()
    width = max(counts)
    if x.shape[dim] < width:
        pad = list(x.shape)
        pad[dim] = width - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    parts = (gather or group.all_gather_dim)(x, dim).split(width, dim)
    return [p.narrow(dim, 0, n) for p, n in zip(parts, counts)]


def _gather_uneven(x: torch.Tensor, group, counts) -> torch.Tensor:
    return torch.cat(gather_parts(x, group, counts), dim=-1)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, counts):
        ctx.n = x.shape[-1]
        if counts is None:
            ctx.off = group.rank * ctx.n
            return group.all_gather_last(x)
        ctx.off = sum(counts[:group.rank])
        return _gather_uneven(x, group, counts)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(-1, ctx.off, ctx.n).contiguous(), None, None


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, counts):
        ctx.group, ctx.counts = group, counts
        lo = sum(counts[:group.rank])
        return x.narrow(0, lo, counts[group.rank])

    @staticmethod
    def backward(ctx, dy):
        return torch.cat(gather_parts(dy.contiguous(), ctx.group, ctx.counts,
                                      dim=0), dim=0), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, counts):
        ctx.lo, ctx.n = sum(counts[:group.rank]), x.shape[0]
        return torch.cat(gather_parts(x, group, counts, dim=0), dim=0)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(0, ctx.lo, ctx.n).contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, in_splits, out_splits):
        ctx.group, ctx.splits = group, (in_splits, out_splits)
        return group.all_to_all(x, in_splits, out_splits)

    @staticmethod
    def backward(ctx, dy):
        in_splits, out_splits = ctx.splits
        return ctx.group.all_to_all(dy.contiguous(), out_splits,
                                    in_splits), None, None, None


def take_rows(x: torch.Tensor, group, counts) -> torch.Tensor:
    """This rank's rows of a replicated ``x`` (``counts[r]`` rows rank r,
    in rank order along dim 0); backward, every rank's row gradients
    all-gathered into the whole one."""
    lo = sum(counts[:group.rank])
    if not _needs_grad(x):
        return x.narrow(0, lo, counts[group.rank])
    return _TakeRows.apply(x, group, tuple(counts))


def gather_rows(x: torch.Tensor, group, counts) -> torch.Tensor:
    """Every rank's rows (``counts[r]`` on rank r) concatenated along dim 0
    in rank order; backward, this rank's rows of the gradient."""
    if not _needs_grad(x):
        return torch.cat(gather_parts(x, group, counts, dim=0), dim=0)
    return _GatherRows.apply(x, group, tuple(counts))


def all_to_all(x: torch.Tensor, group, in_splits, out_splits
               ) -> torch.Tensor:
    """``group.all_to_all``: rows ``in_splits[r]`` of ``x`` to rank r, the
    rows ``out_splits[r]`` from rank r back; backward, the reverse."""
    if not _needs_grad(x):
        return group.all_to_all(x, in_splits, out_splits)
    return _AllToAll.apply(x, group, tuple(in_splits), tuple(out_splits))


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``f``: identity forward, the gradient all-reduced over ``group``."""
    if group is None or not _needs_grad(x):
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """``g``: ``x`` summed over ``group`` (in place), the gradient passed
    through."""
    if group is None:
        return x
    if not _needs_grad(x):
        return group.all_reduce_sum(x)
    return _ReduceFrom.apply(x, group)


def gather_last(x: torch.Tensor, group, counts=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated on the last dim in rank order; the
    gradient's slice of this rank goes back.  ``counts``: each rank's
    width, in rank order, where they differ (None: all ``x``'s)."""
    if counts is not None and len(set(counts)) == 1:
        counts = None
    if not _needs_grad(x):
        if counts is None:
            return group.all_gather_last(x)
        return _gather_uneven(x, group, counts)
    return _GatherLast.apply(x, group, counts)


def norm_stat(s: torch.Tensor, group) -> torch.Tensor:
    """``s`` summed over ``group``, forward, and its gradient summed over
    ``group``, backward: every rank's outputs read the total."""
    if group is None:
        return s
    return copy_to(reduce_from(s, group), group)


def combine_lse(out: torch.Tensor, lse: torch.Tensor, group, keep=None
                ) -> torch.Tensor:
    """The attention over every rank's keys from each rank's attention over
    its own: ``out`` (B, H, dh) and ``lse`` (B, H) f32 (natural log, -inf
    for a row with no key on the rank; ``paged_attention(return_lse=
    True)``).  Each part is weighted by ``exp(lse - max)``, the max taken
    over ``group`` (0 where ``lse`` is -inf), and the weighted parts and
    the weights are summed over ``group`` in one all-reduce; the result is
    their quotient in f32 (0 where no rank holds a key), cast to
    ``out``'s dtype.  ``keep``: ``(lo, hi)``, the heads this rank keeps
    (its query heads, when the sequence splits over the model axis).
    Every rank gets the same bits.  Collectives: an all-reduce (max) of B
    · H · 4 bytes and one (sum) of B · H · (dh + 1) · 4, under the
    group's axis."""
    if group is not None:
        m = group.all_reduce_max(lse.clone())
        live = lse > float("-inf")
        w = torch.where(live, torch.exp(lse - torch.where(live, m, 0.0)),
                        torch.zeros_like(lse))
        acc = torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)
        acc = group.all_reduce_sum(acc)
        num, den = acc[..., :-1], acc[..., -1:]
        out = torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                          torch.zeros_like(num)).to(out.dtype)
    if keep is not None:
        out = out[:, keep[0]:keep[1]]
    return out
