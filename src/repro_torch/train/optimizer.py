"""AdamW, cosine schedule and global-norm clipping: the arithmetic of
``repro/train/optimizer.py`` on trees of tensors.

``AdamW.update`` writes the params and both moments IN PLACE under
``torch.no_grad()`` (the JAX version returns new arrays): at llama3.1-8b's
widths a functional update would hold a second copy of params and
moments at once.  It returns the same tensors, and a new ``AdamWState``
around the moments with the incremented step.  Moments are f32; the bias
correction uses the incremented step; weight decay is decoupled and
applies to leaves with two or more dims only.

On a rank grid (a :class:`Layout`: the leaves' plans from
``repro_torch.launch.sharding.leaf_plan`` and the groups) the global norm
is the whole model's: the squares of the leaves tp splits are summed over
the model group, a replicated leaf counts once, and a KV head that several
ranks read counts once (its owner's columns, ``LeafPlan.norm_cols``).
Under ZeRO-1 each moment leaf is the rank's slice over the data axis
(``LeafPlan.zero1_dim``): the rank
updates that slice of the moments and of the params, then the params are
all-gathered over the data group.  Every update is elementwise, so the
params come out bitwise equal to the update without ZeRO-1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Union

import torch

from repro_torch.train.tree import leaves, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32: updates applied so far
    mu: Any
    nu: Any


@dataclasses.dataclass
class Layout:
    """How a rank's leaves lie over a grid: ``plans`` (one
    ``sharding.LeafPlan`` a leaf, in ``leaves`` order), the model group
    (None at tp = 1) and the ZeRO-1 data group (None: moments whole)."""
    plans: List[Any]
    model: Any = None
    data: Any = None

    def zero1(self, i: int) -> Optional[int]:
        return None if self.data is None else self.plans[i].zero1_dim

    def part(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO-1 slice of leaf ``i`` (a view), or ``t``."""
        from repro_torch.launch.sharding import zero1_slice
        d = self.zero1(i)
        if d is None:
            return t
        return zero1_slice(t, d, self.data.rank, self.data.size)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params, layout: Optional[Layout] = None) -> AdamWState:
        """Zero moments (each the rank's ZeRO-1 slice under ``layout``)."""
        ps = leaves(params)

        def zeros(i):
            t = ps[i] if layout is None else layout.part(i, ps[i])
            return torch.zeros(t.shape, dtype=torch.float32,
                               device=t.device)
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=ps[0].device),
                          mu=unflatten(params, [zeros(i) for i in
                                                range(len(ps))]),
                          nu=unflatten(params, [zeros(i) for i in
                                                range(len(ps))]))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params,
               layout: Optional[Layout] = None):
        """Returns (params, new state, metrics); params, ``state.mu`` and
        ``state.nu`` are updated in place."""
        gnorm = global_norm(grads, layout)
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
        for i, (g, mu, nu, p) in enumerate(zip(
                leaves(grads), leaves(state.mu), leaves(state.nu),
                leaves(params))):
            whole = p
            if layout is not None:
                g, p = layout.part(i, g), layout.part(i, p)
            g = g.float() * scale
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * g.square())
            delta = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if p.dim() >= 2:      # decoupled weight decay on matrices only
                delta = delta + self.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
            if layout is not None and layout.zero1(i) is not None:
                whole.copy_(layout.data.all_gather_dim(p, layout.zero1(i)))
        return params, AdamWState(step, state.mu, state.nu), {
            "grad_norm": gnorm, "lr": lr}


def global_norm(tree, layout: Optional[Layout] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaf by leaf in
    the JAX package's order; under ``layout`` the whole model's (see the
    module docstring)."""
    total = split = None
    for i, x in enumerate(leaves(tree)):
        how = "replicated" if layout is None else layout.plans[i].norm
        if how == "model" and layout.plans[i].norm_cols is not None:
            parts = [x.narrow(x.dim() - 1, lo, hi - lo)
                     for lo, hi in layout.plans[i].norm_cols]
            x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        sq = torch.sum(torch.square(x.float()))
        if how == "replicated":
            total = sq if total is None else total + sq
        elif how == "model":
            split = sq if split is None else split + sq
    if split is not None:
        if layout.model is not None:
            split = layout.model.all_reduce_sum(split.reshape(1))[0]
        total = split if total is None else total + split
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
