"""Core layers: RMSNorm, RoPE, gated and plain MLPs, and the depthwise
causal convolution of the recurrent blocks.

Each is the same function as its counterpart in ``repro/models/layers.py``
(``causal_conv``: the ``_causal_conv`` of ``repro/models/mamba2.py`` and
``repro/models/xlstm.py``); attention itself goes through
``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """Normalise in f32 and scale by ``1 + scale`` (zero-init scales)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dtype)


class _CotangentDtype(torch.autograd.Function):
    """Identity whose backward casts the cotangent to the input's dtype.
    The JAX package's ``_bf16_ct_boundary`` also wraps both in an XLA
    optimization barrier, which keeps XLA from hoisting the norm's f32
    convert across the TP all-reduce; eager PyTorch has no such rewrite to
    stop, so only the cast is kept."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return dy.to(ctx.dtype)


def rmsnorm_ct16(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """``rmsnorm`` with a compute-dtype cotangent boundary at its input
    (``repro/models/layers.py``'s ``rmsnorm_ct16``)."""
    return rmsnorm(_CotangentDtype.apply(x), scale, eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0):
    """Rotary embedding with the half-split rotation.

    x: (..., S, H, dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32,
                                     device=x.device) / half)
    angles = positions[..., None].float() * freqs        # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu_mlp(x, w_in, w_out):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ w_in.to(x.dtype), approximate="tanh")
    return h @ w_out.to(x.dtype)


def swiglu_mlp(x, w_gate, w_up, w_down):
    g = F.silu(x @ w_gate.to(x.dtype))
    h = g * (x @ w_up.to(x.dtype))
    return h @ w_down.to(x.dtype)


def causal_conv(x, w, b):
    """Depthwise causal conv1d. x: (B, S, C); w: (k, C); b: (C,)."""
    k, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i: i + S] * w[i]
    return out + b
