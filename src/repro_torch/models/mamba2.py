"""Mamba2 (SSD) block: the chunked SSD scan, its single-token decode and
the per-sequence state they carry.

The counterpart of ``repro/models/mamba2.py``, function for function:
within a chunk the scan is a quadratic product of (chunk x chunk) blocks,
across chunks a linear recurrence over the chunk states (a loop over
chunks where JAX runs ``lax.scan``).  The four-operand contractions of the
JAX einsums are written as pairwise products in a fixed order, so no
intermediate outgrows (b, heads, chunks, Q, Q) at a 2048-token prefill in
chunks of 256.  ``A_log``, ``dt_bias``, ``D`` and ``norm_scale`` are read
in f32, and the SSD state is f32, as in JAX.

Decode keeps ``{"ssd": (B, nh, hd, ds) f32, "conv": (B, k-1, conv_dim)}``
per sequence and costs O(1) per token.  Neither entry point masks by
length: a bucket's pad tail moves the state, as in JAX.

Tensor parallelism (``group``; the params one rank's shard,
``repro_torch.launch.sharding``): the rank runs its heads (its columns of
``w_zx``'s z and x halves and of ``w_dt``), computes B and C in full from
the replicated ``w_bc`` (one group of B/C for every head), convolves its x
channels and all of B/C's, reads its heads' entries of ``A_log``, ``D``,
``dt_bias`` and ``norm_scale``, takes the gated norm's mean square over
the whole ``d_in`` (``layers.rmsnorm_split``) and ends with the
row-parallel ``w_out`` and an all-reduce.  Its state holds its heads:
``ssd (B, nh_r, hd, ds)``, ``conv (B, k-1, d_in_r + 2·ds)``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.launch.collectives import copy_to, reduce_from
from repro_torch.launch.sharding import group_heads, mamba_dims
from repro_torch.models import module as m
from repro_torch.models.layers import causal_conv, rmsnorm_split


def _rank(params, d: int, ssm, group):
    """``(d_in, head_dim, d_state, lo, hi)``: the whole ``d_in`` and this
    rank's heads ``[lo, hi)`` (all of them without a group; the count is
    the shard's ``w_dt`` width)."""
    d_in, nh, hd, ds = mamba_dims(d, ssm)
    lo, hi = group_heads(nh, group)
    assert params["w_dt"].shape[-1] == hi - lo, "not this rank's shard"
    return d_in, hd, ds, lo, hi


def _rank_params(params, d_in, hd, ds, lo, hi):
    """The replicated leaves' entries this rank reads: its x channels and
    all of B/C's of the conv, its heads of ``dt_bias``, ``A_log``, ``D``,
    its ``d_in`` slice of ``norm_scale`` (the leaves themselves for all
    heads)."""
    p = dict(params)
    if hi - lo == params["A_log"].shape[-1]:
        return p
    for k in ("conv_w", "conv_b"):
        t = params[k]
        p[k] = torch.cat([t.narrow(-1, lo * hd, (hi - lo) * hd),
                          t.narrow(-1, d_in, 2 * ds)], dim=-1)
    for k in ("dt_bias", "A_log", "D"):
        p[k] = params[k].narrow(-1, lo, hi - lo)
    p["norm_scale"] = params["norm_scale"].narrow(-1, lo * hd,
                                                  (hi - lo) * hd)
    return p


def init_mamba(gen: torch.Generator, d: int, ssm, *, lead=(),
               dtype=torch.float32, device=None) -> dict:
    """One block's params (``lead`` stacks them), JAX ``init_mamba``'s
    layout and distributions; ``dt_bias``, ``A_log``, ``D`` and
    ``norm_scale`` in f32."""
    d_in, nh, _, ds = mamba_dims(d, ssm)
    conv_dim = d_in + 2 * ds
    lead = tuple(lead)
    kw = dict(lead=lead, dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.empty(lead + (nh,), **f32).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen)
    return {
        "w_zx": m.dense_init(gen, d, 2 * d_in, **kw),
        "w_bc": m.dense_init(gen, d, 2 * ds, **kw),
        "w_dt": m.dense_init(gen, d, nh, **kw),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "conv_w": (m.dense_init(gen, ssm.d_conv, conv_dim, lead=lead,
                                device=device)
                   * ssm.d_conv ** 0.5).to(dtype),
        "conv_b": m.zeros(lead + (conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, nh + 1, **f32)).expand(
            lead + (nh,)).contiguous(),
        "D": torch.ones(lead + (nh,), **f32),
        "norm_scale": m.zeros(lead + (d_in,), device=device),
        "w_out": m.dense_init(gen, d_in, d, **kw),
    }


def _segsum(a):
    """a: (..., Q) log-decays -> (..., Q, Q) lower-triangular pairwise sums
    (sum of a over j+1..i at [i, j]), -inf above the diagonal: masked
    before the ``exp`` that reads it, so no NaN arises."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    upper = ~torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=a.device))
    return diff.masked_fill(upper, float("-inf"))


def ssd_chunked(xs, a, B, C, chunk: int, h0=None):
    """Chunked SSD scan.

    xs: (b, s, h, p) inputs (already dt-scaled); a: (b, s, h) log decay
    (dt * A, negative); B, C: (b, s, n); all f32.  Returns (y (b, s, h, p),
    h_final (b, h, p, n))."""
    b, s, nh, p = xs.shape
    n = B.shape[-1]
    Q = min(chunk, s)
    s_orig = s
    if s % Q:
        # zero tail: no input, decay 1 (state kept), B = C = 0; the padded
        # outputs are sliced off
        pad = Q - s % Q
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        s += pad
    nc = s // Q
    xh = xs.reshape(b, nc, Q, nh, p).permute(0, 3, 1, 2, 4)  # (b,h,c,l,p)
    a = a.reshape(b, nc, Q, nh).permute(0, 3, 1, 2)          # (b,h,c,l)
    B_ = B.reshape(b, nc, Q, n)
    C_ = C.reshape(b, nc, Q, n)

    A_cum = torch.cumsum(a, dim=-1)                          # (b,h,c,l)
    L = torch.exp(_segsum(a))                                # (b,h,c,l,l)
    # within-chunk blocks: ((C B^T) * L) @ x
    CB = C_ @ B_.transpose(-1, -2)                           # (b,c,l,s)
    y = (CB[:, None] * L) @ xh                               # (b,h,c,l,p)
    # each chunk's contribution to its final state
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)        # (b,h,c,l)
    states = (xh * decay_states[..., None]).transpose(-1, -2) \
        @ B_[:, None]                                        # (b,h,c,p,n)
    # the recurrence across chunks: the state entering each chunk
    chunk_decay = torch.exp(A_cum[..., -1])                  # (b,h,c)
    h = torch.zeros((b, nh, p, n), dtype=torch.float32,
                    device=xs.device) if h0 is None else h0
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = chunk_decay[:, :, c, None, None] * h + states[:, :, c]
    h_prev = torch.stack(h_prev, dim=2)                      # (b,h,c,p,n)
    # the entering state read out by C, decayed to each position
    y = y + (C_[:, None] @ h_prev.transpose(-1, -2)) \
        * torch.exp(A_cum)[..., None]                        # (b,h,c,l,p)
    y = y.permute(0, 2, 3, 1, 4).reshape(b, s, nh, p)[:, :s_orig]
    return y, h


def _gate_out(params, y, z, x, cfg, d_in, group):
    """Gated RMSNorm (over the whole ``d_in``) and the output
    projection, all-reduced over ``group``."""
    y = rmsnorm_split(y * F.silu(z), params["norm_scale"], cfg.norm_eps,
                      group, d_in)
    return reduce_from(y @ params["w_out"].to(x.dtype), group)


def mamba_forward(params, x, cfg, state: Optional[dict] = None,
                  return_state: bool = False, group=None):
    """Full-sequence Mamba2 block. x: (B, S, d) -> (B, S, d); ``state``
    continues a sequence (extend).  ``group``: this rank's heads (the
    module docstring)."""
    ssm = cfg.ssm
    B_, S, d = x.shape
    d_in, hd, ds, lo, hi = _rank(params, d, ssm, group)
    params = _rank_params(params, d_in, hd, ds, lo, hi)
    nh, d_r = hi - lo, (hi - lo) * hd
    x = copy_to(x, group)
    z, xc = torch.chunk(x @ params["w_zx"].to(x.dtype), 2, dim=-1)
    bc = x @ params["w_bc"].to(x.dtype)
    xbc = torch.cat([xc, bc], dim=-1)                  # (B, S, d_in + 2ds)
    # a continued sequence: the conv sees the previous chunk's last k-1
    full = xbc if state is None else \
        torch.cat([state["conv"].to(x.dtype), xbc], dim=1)
    if full.shape[1] < ssm.d_conv - 1:                 # a very short chunk
        full = F.pad(full, (0, 0, ssm.d_conv - 1 - full.shape[1], 0))
    conv_tail = full[:, full.shape[1] - (ssm.d_conv - 1):]
    conv_out = causal_conv(full, params["conv_w"].to(x.dtype),
                           params["conv_b"].to(x.dtype))
    xbc = F.silu(conv_out[:, full.shape[1] - S:])
    xc2, Bm, Cm = torch.split(xbc, [d_r, ds, ds], dim=-1)
    dt = F.softplus((x @ params["w_dt"].to(x.dtype)).float()
                    + params["dt_bias"].float())       # (B, S, nh)
    A = -torch.exp(params["A_log"].float())            # (nh,)
    xh = xc2.reshape(B_, S, nh, hd).float()
    h0 = None if state is None else state["ssd"]
    y, h_final = ssd_chunked(xh * dt[..., None], dt * A, Bm.float(),
                             Cm.float(), ssm.chunk, h0=h0)
    y = y + params["D"].float()[None, None, :, None] * xh
    out = _gate_out(params, y.reshape(B_, S, d_r).to(x.dtype), z, x, cfg,
                    d_in, group)
    if return_state:
        return out, {"ssd": h_final, "conv": conv_tail}
    return out


def mamba_decode(params, x, cfg, state, group=None):
    """Single-token decode. x: (B, 1, d); state: {ssd (B, nh, hd, ds),
    conv (B, k-1, conv_dim)}, this rank's heads under ``group``.  Returns
    (out, new state)."""
    ssm = cfg.ssm
    B_, _, d = x.shape
    d_in, hd, ds, lo, hi = _rank(params, d, ssm, group)
    params = _rank_params(params, d_in, hd, ds, lo, hi)
    nh, d_r = hi - lo, (hi - lo) * hd
    x = copy_to(x, group)
    z, xc = torch.chunk(x @ params["w_zx"].to(x.dtype), 2, dim=-1)
    bc = x @ params["w_bc"].to(x.dtype)
    xbc = torch.cat([xc, bc], dim=-1)                  # (B, 1, cd)
    conv_buf = torch.cat([state["conv"], xbc], dim=1)  # (B, k, cd)
    conv_out = (conv_buf * params["conv_w"].to(x.dtype)).sum(dim=1) \
        + params["conv_b"].to(x.dtype)                 # (B, cd)
    xc2, Bm, Cm = torch.split(F.silu(conv_out), [d_r, ds, ds], dim=-1)
    dt = F.softplus((x[:, 0] @ params["w_dt"].to(x.dtype)).float()
                    + params["dt_bias"].float())       # (B, nh)
    A = -torch.exp(params["A_log"].float())
    dA = torch.exp(dt * A)                             # (B, nh)
    xh = xc2.reshape(B_, nh, hd).float()
    Bf, Cf = Bm.float(), Cm.float()
    h = dA[..., None, None] * state["ssd"] + \
        (xh * dt[..., None])[..., None] * Bf[:, None, None, :]
    y = (h @ Cf[:, None, :, None])[..., 0]             # (B, nh, hd)
    y = y + params["D"].float()[None, :, None] * xh
    out = _gate_out(params, y.reshape(B_, 1, d_r).to(x.dtype), z, x, cfg,
                    d_in, group)
    return out, {"ssd": h, "conv": conv_buf[:, 1:]}


def init_mamba_state(batch: int, d: int, ssm, dtype=torch.float32,
                     device=None, heads: Optional[int] = None) -> dict:
    """Fresh state for ``heads`` heads (all of them by default; a
    tensor-parallel rank's count)."""
    d_in, nh, hd, ds = mamba_dims(d, ssm)
    if heads is not None:
        nh, d_in = heads, heads * hd
    return {
        "ssd": torch.zeros((batch, nh, hd, ds), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, ssm.d_conv - 1, d_in + 2 * ds),
                            dtype=dtype, device=device),
    }
