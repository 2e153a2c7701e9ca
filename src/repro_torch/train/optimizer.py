"""AdamW, cosine schedule and global-norm clipping: the arithmetic of
``repro/train/optimizer.py`` on trees of tensors.

``AdamW.update`` writes the params and both moments IN PLACE under
``torch.no_grad()`` (the JAX version returns new arrays): at llama3.1-8b's
widths a functional update would hold a second copy of params and
moments at once.  It returns the same tensors, and a new ``AdamWState``
around the moments with the incremented step.  Moments are f32; the bias
correction uses the incremented step; weight decay is decoupled and
applies to leaves with two or more dims only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.train.tree import leaves, map_tree


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32: updates applied so far
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32,
                                    requires_grad=False)
        first = leaves(params)[0]
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=first.device),
                          mu=map_tree(zeros, params),
                          nu=map_tree(zeros, params))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """Returns (params, new state, metrics); params, ``state.mu`` and
        ``state.nu`` are updated in place."""
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = state.step + 1
        sf = step.float()
        bc1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32,
                                 device=sf.device) ** sf
        bc2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32,
                                 device=sf.device) ** sf
        lr = self._lr(step)
        b1, b2 = self.b1, self.b2
        for g, mu, nu, p in zip(leaves(grads), leaves(state.mu),
                                leaves(state.nu), leaves(params)):
            g = g.float() * scale
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * g.square())
            delta = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if p.dim() >= 2:      # decoupled weight decay on matrices only
                delta = delta + self.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
        return params, AdamWState(step, state.mu, state.nu), {
            "grad_norm": gnorm, "lr": lr}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaf by leaf in
    the JAX package's order."""
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``; ``step`` a tensor."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return sched
