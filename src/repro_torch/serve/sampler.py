"""Token samplers over (possibly vocab-padded) logits."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """logits: (B, S, Vpad). Returns the per-position argmax, (B, S)
    int32; ties go to the first index, as ``jnp.argmax`` does."""
    return torch.argmax(logits[..., :vocab], dim=-1).to(torch.int32)
