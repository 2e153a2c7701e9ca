"""Training step: loss, gradients and the AdamW update, with optional
microbatching (gradient accumulation) and the int8 gradient-compression
round trip of ``repro/train/train_step.py``.

Gradients come from ``torch.autograd.grad`` of ``model.loss_fn``'s total
with respect to every param leaf (float leaves are made to require grad
here).  With ``microbatches = mb`` the batch splits along dim 0 into mb
slices, the f32 gradients and the totals are summed and divided by mb, and
the last slice's metrics are kept, as the JAX ``lax.scan`` does.
``dp_axes`` is a GSPMD sharding hint for a data-parallel mesh; the port
trains on one card and refuses a non-empty one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.train.optimizer import AdamW, AdamWState
from repro_torch.train.tree import leaves, map_tree, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1          # grad accumulation steps per train step
    grad_compress: bool = False    # int8 quantized gradient representation
    # the JAX package's data-parallel mesh axes (a GSPMD sharding hint);
    # must stay empty here
    dp_axes: tuple = ()


def compress(x: torch.Tensor) -> torch.Tensor:
    """int8 quantize/dequantize with a per-leaf absmax scale (round half
    to even, as ``jnp.round``)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    xi = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return xi.float() * scale


def make_train_step(model, optimizer: AdamW,
                    cfg: TrainStepConfig = TrainStepConfig()):
    """Returns train_step(state, batch) -> (state, metrics)."""
    if cfg.dp_axes:
        raise NotImplementedError(
            f"TrainStepConfig.dp_axes={cfg.dp_axes!r}: a GSPMD sharding hint "
            f"for data-parallel training over a device mesh; the port trains "
            f"on one card, and data- or tensor-parallel training waits for a "
            f"machine with more than one (ROADMAP.md, queue 1)")

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

    def train_step(state: TrainState, batch):
        params = state.params
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
            grads = map_tree(lambda g: g / mb, grads)
            loss = loss / mb
        if cfg.grad_compress:
            grads = map_tree(compress, grads)
        params, opt, opt_metrics = optimizer.update(grads, state.opt, params)
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
