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
  slice of the gradient backward (the head's vocab shards).

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


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.n = group.rank, x.shape[-1]
        return group.all_gather_last(x)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(-1, ctx.rank * ctx.n, ctx.n).contiguous(), None


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


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated on the last dim in rank order; the
    gradient's slice of this rank goes back."""
    if not _needs_grad(x):
        return group.all_gather_last(x)
    return _GatherLast.apply(x, group)
