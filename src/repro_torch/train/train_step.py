"""Training step: loss, gradients and the AdamW update, with optional
microbatching (gradient accumulation), the int8 gradient-compression round
trip of ``repro/train/train_step.py``, and data and tensor parallelism on a
rank grid.

Gradients come from ``torch.autograd.grad`` of ``model.loss_fn``'s total
with respect to every param leaf (float leaves are made to require grad
here).  With ``microbatches = mb`` the batch splits along dim 0 into mb
slices, the f32 gradients and the totals are summed and divided by mb, and
the last slice's metrics are kept, as the JAX ``lax.scan`` does.

On a rank grid (``grid``, a ``repro_torch.launch.mesh.RankGrid``; the
model built with ``grid.model_kw()`` and the params, state and batch the
rank's: ``rank_state``, ``sharding.shard_batch``):

* the grid decides data parallelism (``grid.dp_size``); the batch is the
  rank's rows, laid out so that microbatch i is the rank's slice of global
  microbatch i (JAX's reshape to ``(mb, B/mb)`` sharded on dim 1).
  ``TrainStepConfig.dp_axes`` may be left empty; it is kept so that a JAX
  config carries over, and when given must name the grid's data-parallel
  axes (``("data",)``, or ``("pod", "data")``);
* each microbatch's loss is the global weighted mean and its metrics are
  global (``Model.loss_fn``); each rank's gradient is its part of the
  global loss's, so after the microbatches the gradients are summed over
  the data-parallel group: the mean over dp of the ranks' usual
  data-parallel gradients;
* over the model axis, the leaves ``sharding.leaf_plan`` marks are summed
  (an expert held whole on one rank, ``Model.shard_experts``, is not):
  ``q_norm``/``k_norm`` over the model group, and the columns of each KV
  head that several ranks read (their ``wk``/``wv``/``bk``/``bv``) over
  those ranks (``sharding.shared_kv_heads``; one group a head, made here
  on every rank in ascending head order, and summed in that order);
* ``grad_compress`` runs after the reduction, as in JAX, with each split
  leaf's scale the whole leaf's (a max over the model group);
* ``zero1`` keeps the Adam moments split over the data axis (the
  optimizer's ``Layout``).

Gradients are reduced with all-reduces; gloo has no reduce-scatter, so
ZeRO-1 slices the all-reduced gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.train.optimizer import AdamW, AdamWState, Layout
from repro_torch.train.tree import leaves, map_tree, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1          # grad accumulation steps per train step
    grad_compress: bool = False    # int8 quantized gradient representation
    # JAX's data-parallel mesh axes; on a rank grid the grid decides, and
    # a non-empty value must name its axes (checked, else unused)
    dp_axes: tuple = ()


def compress(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8 quantize/dequantize with a per-leaf absmax scale (round half
    to even, as ``jnp.round``); ``group``: the leaf is split over it, and
    the scale is the whole leaf's."""
    x32 = x.float()
    top = x32.abs().max()
    if group is not None:
        top = group.all_reduce_max(top.reshape(1))[0]
    scale = torch.clamp(top, min=1e-12) / 127.0
    xi = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return xi.float() * scale


def layout_for(model, params, grid, zero1: bool = False) -> Layout:
    """The optimizer's ``Layout`` of ``params`` (the rank's) on ``grid``."""
    from repro_torch.launch.sharding import leaf_plan
    tp = grid.tp
    data = grid.mesh.shape["data"]
    plans = leaf_plan(params, model.cfg, tp, grid.coords["model"], data,
                      zero1, model.shard_experts)
    return Layout(plans, grid.model if tp > 1 else None,
                  grid.data if zero1 and data > 1 else None)


def make_train_step(model, optimizer: AdamW,
                    cfg: TrainStepConfig = TrainStepConfig(), *,
                    grid=None, zero1: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).  ``grid``:
    this rank's grid (see the module docstring); ``zero1`` needs one."""
    dp = None
    readers = {}          # KV head -> the group of the ranks that read it
    if grid is None:
        if cfg.dp_axes or zero1:
            raise ValueError(
                f"TrainStepConfig.dp_axes={cfg.dp_axes!r}, zero1={zero1}: "
                f"data parallelism needs this rank's grid "
                f"(make_train_step(..., grid=), repro_torch.launch.mesh)")
    else:
        from repro_torch.launch.mesh import dp_axes
        from repro_torch.launch.sharding import shared_kv_heads
        want = dp_axes(grid.mesh)
        if cfg.dp_axes and tuple(cfg.dp_axes) != want:
            raise ValueError(f"dp_axes {cfg.dp_axes!r}: the grid's "
                             f"data-parallel axes are {want!r}")
        if grid.dp_size > 1:
            dp = grid.dp
        if (model.group is None) != (grid.tp == 1) or \
                (model.dp_group is None) != (dp is None):
            raise ValueError("the model's groups are not the grid's: build "
                             "it with Model(cfg, **grid.model_kw())")
        if grid.tp > 1:
            # collective: every rank makes every reader group, in head order
            for head, ranks in shared_kv_heads(model.cfg, grid.tp):
                g = grid.model_subgroup(ranks)
                if g is not None:
                    readers[head] = g
    layout = None

    def single(params, batch):
        ps = leaves(params)
        for p in ps:
            if p.is_floating_point() and not p.requires_grad:
                p.requires_grad_(True)
        total, metrics = model.loss_fn(params, batch)
        grads = torch.autograd.grad(total, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, ps)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return total.detach(), metrics, unflatten(params, grads)

    def reduce(grads, layout):
        """Complete the rank's gradients over the grid, in place."""
        for g, plan in zip(leaves(grads), layout.plans):
            if plan.grad_sum == "model":
                layout.model.all_reduce_sum(g)
            elif plan.grad_sum == "kv":
                # each shared head's columns over its readers, in ascending
                # head order on every rank, so overlapping reader sets
                # (KV 1 on ranks 0 and 1, KV 2 on 1 and 2) cannot deadlock
                for head, lo, hi in plan.kv_shared:
                    part = g.narrow(g.dim() - 1, lo, hi - lo)
                    part.copy_(readers[head].all_reduce_sum(
                        part.contiguous()))
            if dp is not None:
                dp.all_reduce_sum(g)

    def train_step(state: TrainState, batch):
        nonlocal layout
        params = state.params
        if grid is not None and layout is None:
            layout = layout_for(model, params, grid, zero1)
        mb = cfg.microbatches
        if mb <= 1:
            loss, metrics, grads = single(params, batch)
        else:
            grads = map_tree(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32)
            for i in range(mb):
                part = {k: x.reshape((mb, x.shape[0] // mb) + x.shape[1:])[i]
                        for k, x in batch.items()}
                l_i, metrics, g_i = single(params, part)
                for acc, g in zip(leaves(grads), leaves(g_i)):
                    acc.add_(g)
                loss = loss.to(l_i.device) + l_i
            loss = loss / mb
        if layout is not None:
            reduce(grads, layout)
        if mb > 1:
            grads = map_tree(lambda g: g / mb, grads)
        if cfg.grad_compress:
            if layout is None:
                grads = map_tree(compress, grads)
            else:
                grads = unflatten(grads, [
                    compress(g, layout.model if plan.split else None)
                    for g, plan in zip(leaves(grads), layout.plans)])
        params, opt, opt_metrics = optimizer.update(grads, state.opt, params,
                                                    layout)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss_total"] = loss
        return TrainState(params, opt), metrics

    return train_step


def init_state(model, optimizer: AdamW, gen: torch.Generator, *,
               device=None) -> TrainState:
    """Seeded f32 params on ``device`` (drawn with ``gen``, which must
    live there) and a fresh optimizer state."""
    params = model.init(gen, device=device)
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params, optimizer.init(params))


def rank_state(model, optimizer: AdamW, params, grid,
               zero1: bool = False) -> TrainState:
    """This rank's train state on ``grid`` from the full ``params`` (JAX
    layout, any device): its shard (``sharding.shard_params``) and fresh
    moments, under ``zero1`` its slice of them over the data axis."""
    from repro_torch.launch.sharding import shard_params
    params = shard_params(params, grid.coords["model"], grid.tp,
                          cfg=model.cfg, shard_experts=model.shard_experts)
    return TrainState(params, optimizer.init(
        params, layout_for(model, params, grid, zero1)))
