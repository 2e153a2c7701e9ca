"""Differentiable causal GQA flash attention for training.

The counterpart of ``repro/models/flash.py``: the forward saves only
``(q, k, v, out, lse)`` and the backward recomputes P per key block
(FlashAttention-2), as the JAX package's ``custom_vjp`` does.  Both halves
go through ``repro_torch.kernels.ops``: on the card the forward is the
flash kernel (``csrc/flash_attention.cu``, asked for its ``lse``) and the
backward is ``csrc/flash_attention_bwd.cu``; on the CPU both are their
plain versions.  ``lengths`` and ``window`` get no gradient, as in JAX's
``zero_ct``.  The JAX function's ``bkv`` and ``unroll`` are its scan's
block size and unrolling and have no counterpart here: the kernels choose
their own tiles.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, window):
        out, lse = ops.flash_attention(q, k, v, lengths, window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.lengths, ctx.window = lengths, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse,
                                             dout.contiguous(), ctx.lengths,
                                             ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,dh); k/v: (B,S,KV,dh) -> (B,S,H,dh), causal.  Keeps the
    forward's ``lse`` only when a gradient is needed."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, lengths, window)
    return ops.flash_attention(q, k, v, lengths, window)
