"""Token samplers over (possibly vocab-padded) logits, and the greedy
acceptance count of speculative decoding (``repro/serve/sampler.py``)."""
from __future__ import annotations

import numpy as np
import torch


def greedy(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """logits: (B, S, Vpad). Returns the per-position argmax, (B, S)
    int32; ties go to the first index, as ``jnp.argmax`` does.  S is 1 for
    a decode and k + 1 for a speculative verification."""
    return torch.argmax(logits[..., :vocab], dim=-1).to(torch.int32)


def accept_length(draft_tokens, target_tokens) -> np.ndarray:
    """Per-row count of leading draft tokens the target's greedy
    verification confirms: ``draft`` (B, k) against ``target`` (B, >= k),
    target position i being the greedy prediction after draft token i's
    prefix.  Returns (B,) ints in [0, k]."""
    d = np.asarray(draft_tokens)
    t = np.asarray(target_tokens)[:, :d.shape[1]]
    return np.cumprod(d == t, axis=1).sum(axis=1).astype(np.int64)


def temperature(logits: torch.Tensor, vocab: int, generator: torch.Generator,
                temp: float = 1.0) -> torch.Tensor:
    """Sample each position from ``softmax(logits / temp)`` over the real
    vocab with an explicit ``generator`` (on the logits' device).  Returns
    (B, S) int32.  The ranks of a tensor-parallel engine hold the same
    gathered logits, so generators seeded alike draw the same tokens on
    every rank."""
    scaled = logits[..., :vocab].float() / max(temp, 1e-4)
    probs = torch.softmax(scaled, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    out = torch.multinomial(flat, 1, generator=generator)
    return out.reshape(probs.shape[:-1]).to(torch.int32)
