"""Parameter initialisers on an explicit ``torch.Generator``.

Params are nested dicts of tensors with the JAX package's layout
(``repro/models/module.py``): stacked stages carry a leading layer dim.
The distributions match the JAX initialisers (truncated-normal fan-in
dense weights, N(0, 0.02) embeddings, zero norms and biases); the bits do
not, since the two frameworks draw different numbers from one seed.
"""
from __future__ import annotations

import math
import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               lead=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun), ``lead + (d_in, d_out)``,
    drawn in f32 and then cast to ``dtype``."""
    w = torch.empty(tuple(lead) + (d_in, d_out), dtype=torch.float32,
                    device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               dtype=torch.float32, device=None) -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    return w.normal_(0.0, 0.02, generator=gen).to(dtype)


def zeros(shape, *, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)
