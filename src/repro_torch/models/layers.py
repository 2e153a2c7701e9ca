"""Core layers: RMSNorm, RoPE, gated and plain MLPs, the depthwise causal
convolution of the recurrent blocks, and the two plain attentions the dry
run studies.

Each is the same function as its counterpart in ``repro/models/layers.py``
(``causal_conv``: the ``_causal_conv`` of ``repro/models/mamba2.py`` and
``repro/models/xlstm.py``).  Attention goes through
``repro_torch.kernels.ops``; ``chunked_attention`` and
``folded_causal_attention`` are plain PyTorch, taken only under
``Model(attn_impl="chunked" | "folded")``.  Neither is a kernel or
replaces one: their JAX counterparts are plain JAX too.  The JAX
``lax.scan`` over key blocks is a Python loop here, and its ``unroll``
has no counterpart.
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


NEG_INF = -1e30


def _gqa_scores(qb, kb):
    """qb: (B, bq, KV, G, dh); kb: (B, bkv, KV, dh) -> (B, KV, G, bq, bkv),
    summed in f32."""
    return torch.einsum("bqkgd,bjkd->bkgqj", qb.float(), kb.float())


def _online_softmax(qr, k, v, q_pos, *, lengths, window, causal, bkv):
    """Online-softmax attention of the queries ``qr`` (B, Sq, KV, G, dh),
    at positions ``q_pos``, over the keys in blocks of ``bkv``: (B, KV, G,
    Sq, dh) in f32."""
    B, Sq, KV, G, dh = qr.shape
    nk = k.shape[1] // bkv
    acc = torch.zeros((B, KV, G, Sq, dh), dtype=torch.float32,
                      device=qr.device)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=qr.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=qr.device)
    for j in range(nk):
        kj, vj = k[:, j * bkv:(j + 1) * bkv], v[:, j * bkv:(j + 1) * bkv]
        s = _gqa_scores(qr, kj)
        kv_pos = j * bkv + torch.arange(bkv, device=qr.device)
        mask = torch.ones((Sq, bkv), dtype=torch.bool, device=qr.device)
        if causal:
            mask = mask & (q_pos[:, None] >= kv_pos[None, :])
        if window is not None:
            mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
        if lengths is not None:
            mask = mask[None] & (kv_pos[None, None, :]
                                 < lengths[:, None, None])
            mask = mask[:, None, None]
        else:
            mask = mask[None, None, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqj,bjkd->bkgqd", p.to(vj.dtype).float(),
                          vj.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    return acc / torch.clamp(l[..., None], min=1e-20)


def chunked_attention(q, k, v, *, lengths=None, window=None,
                      causal: bool = True, bkv: int = 1024):
    """Online-softmax attention over KV blocks.

    q: (B, S, H, dh), k/v: (B, S, KV, dh). Returns (B, S, H, dh).
    ``lengths``: (B,) valid token counts (None = all valid).
    ``window``: sliding window size; None = full causal.
    """
    B, S, H, dh = q.shape
    KV = k.shape[2]
    bkv = min(bkv, S)
    if S % bkv:
        raise ValueError(f"chunked_attention: S {S} is not a multiple of "
                         f"the key block {bkv}")
    qr = (q * dh ** -0.5).reshape(B, S, KV, H // KV, dh)
    out = _online_softmax(qr, k, v, torch.arange(S, device=q.device),
                          lengths=lengths, window=window, causal=causal,
                          bkv=bkv)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh).to(q.dtype)


def folded_causal_attention(q, k, v, *, lengths=None, bkv: int = 1024,
                            depth: int = 3):
    """Recursive-halving causal attention: the lower half of the queries
    attends the lower half of the keys (recurse), the upper half attends
    all keys; ~0.67·S² score entries at depth 3 against S² for the
    rectangle.  Falls back to ``chunked_attention`` when the halves do not
    split into key blocks."""
    B, S, H, dh = q.shape
    if depth <= 0 or S // 2 < bkv or (S // 2) % bkv != 0:
        return chunked_attention(q, k, v, lengths=lengths,
                                 bkv=min(bkv, S))
    half = S // 2
    out_lo = folded_causal_attention(
        q[:, :half], k[:, :half], v[:, :half], lengths=lengths, bkv=bkv,
        depth=depth - 1)
    out_hi = _hi_half_causal(q, k, v, lengths=lengths, bkv=bkv)
    return torch.cat([out_lo, out_hi], dim=1)


def _hi_half_causal(q, k, v, *, lengths, bkv):
    """Causal attention for the upper-half queries over all S keys."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    half = S // 2
    qr = (q[:, half:] * dh ** -0.5).reshape(B, half, KV, H // KV, dh)
    out = _online_softmax(qr, k, v,
                          torch.arange(half, device=q.device) + half,
                          lengths=lengths, window=None, causal=True,
                          bkv=bkv)
    return out.permute(0, 3, 1, 2, 4).reshape(B, half, H, dh).to(q.dtype)
