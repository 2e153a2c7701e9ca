"""xLSTM blocks: mLSTM (matrix memory, chunked parallel prefill) and sLSTM
(scalar memory, strictly sequential).

The counterpart of ``repro/models/xlstm.py``, function for function.  The
mLSTM prefill is attention with an additive log-decay bias (logD[i, j] =
F_i - F_j + i_j, F the cumulative log-sigmoid forget gate) and an abs-max
normalizer, run as an online scan over key chunks (a loop where JAX runs
``lax.scan``); decode carries (C, n, m) per head.  The sLSTM has no
parallel form: its prefill loops over time steps, a few launches a step
per layer, so a long prompt is host-bound.  Neither prefill masks by
length: a bucket's pad tail moves the state, as in JAX.  There is no
cached prefill (extend), as in JAX.

Tensor parallelism (``group``; the params one rank's shard,
``repro_torch.launch.sharding``), by head in GSPMD's padded layout.  A
rank may hold no head: it runs every op of the others on empty tensors
(its scans and the sLSTM loop over zero heads), so its backward reaches
the same collectives in the same order, and adds zeros to the
all-reduces.

* mLSTM: the rank's ``x_in`` and z channels (``w_up`` strided), its
  conv channels; ``cx`` and ``x_in`` all-gathered (parts of uneven width,
  ``collectives.gather_last``) since ``w_q``/``w_k``/``w_v`` read every
  channel, then the rank's head columns of those, of ``w_i``/``w_f`` and
  ``f_bias``; ``norm_h``'s mean square over the whole ``d_in``
  (``layers.rmsnorm_split``), the row-parallel ``w_down`` and an
  all-reduce.  State: ``C (B, nh_r, hd, hd)``, ``n``, ``m`` and ``conv
  (B, 3, d_in_r)``;
* sLSTM: the rank's heads of each gate (``w_gates`` strided, ``b_gates``
  and ``r_gates`` read by head; the recurrence is block-diagonal, so the
  time loop needs no collective), ``h`` all-gathered to the whole ``d``,
  ``norm_h`` replicated, the FFN's ``w_up`` column-parallel (its a and b
  halves strided) and ``w_down`` row-parallel with an all-reduce.  State:
  ``h, c, n, m (B, nh_r, hd)``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.launch.collectives import copy_to, gather_last, reduce_from
from repro_torch.launch.sharding import group_heads, head_widths
from repro_torch.models import module as m
from repro_torch.models.layers import causal_conv, rmsnorm, rmsnorm_split
from repro_torch.roofline import counter as _roof

NEG_INF = -1e30


def _cols(t, lo: int, n: int, dim: int = -1):
    """``t``'s entries ``[lo, lo + n)`` along ``dim`` (``t`` itself where
    that is all of them: a rank with every head, or no group)."""
    return t if n == t.shape[dim] else t.narrow(dim, lo, n)


def _gather_heads(x, nh: int, hd: int, group):
    """The whole ``(..., nh·hd)`` from every rank's heads' columns (the
    uneven all-gather), or ``x`` without a group."""
    if group is None:
        return x
    return gather_last(x, group, head_widths(nh, hd, group.size))


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, d: int, nh: int, *, lead=(),
               dtype=torch.float32, device=None) -> dict:
    """One block's params (``lead`` stacks them), JAX ``init_mlstm``'s
    layout and distributions."""
    d_in = 2 * d
    lead = tuple(lead)
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {
        "norm_in": m.zeros(lead + (d,), device=device),
        "w_up": m.dense_init(gen, d, 2 * d_in, **kw),
        "conv_w": (m.dense_init(gen, 4, d_in, lead=lead, device=device)
                   * 2.0).to(dtype),
        "conv_b": m.zeros(lead + (d_in,), dtype=dtype, device=device),
        "w_q": m.dense_init(gen, d_in, d_in, **kw),
        "w_k": m.dense_init(gen, d_in, d_in, **kw),
        "w_v": m.dense_init(gen, d_in, d_in, **kw),
        "w_i": m.dense_init(gen, d_in, nh, **kw),
        "w_f": m.dense_init(gen, d_in, nh, **kw),
        "f_bias": torch.full(lead + (nh,), 3.0, dtype=dtype,
                             device=device),
        "norm_h": m.zeros(lead + (d_in,), device=device),
        "w_down": m.dense_init(gen, d_in, d, **kw),
    }


def _mlstm_inner_chunked(q, k, v, i_pre, f_pre, chunk: int):
    """Chunked stabilized mLSTM. q, k, v: (B, S, nh, hd); i_pre, f_pre:
    (B, S, nh).  Returns h (B, S, nh, hd) in f32."""
    B, S, nh, hd = q.shape
    Fc = torch.cumsum(F.logsigmoid(f_pre.float()), dim=1)
    Ic = i_pre.float()
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        # zero tail: k = v = 0 add nothing, the padded queries are sliced
        # off, and the causal mask keeps them from the real ones
        pad = Q - S % Q
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        Fc, Ic = (F.pad(t, (0, 0, 0, pad)) for t in (Fc, Ic))
        S += pad
    nc = S // Q
    qc = (q * hd ** -0.5).reshape(B, nc, Q, nh, hd).float()
    kc = k.reshape(B, nc, Q, nh, hd).float()
    vc = v.reshape(B, nc, Q, nh, hd).float()
    Fc = Fc.reshape(B, nc, Q, nh)
    Ic = Ic.reshape(B, nc, Q, nh)
    qpos = (torch.arange(nc, device=q.device)[:, None] * Q
            + torch.arange(Q, device=q.device)[None, :])     # (nc, Q)

    acc = torch.zeros((B, nc, Q, nh, hd), dtype=torch.float32,
                      device=q.device)
    l = torch.zeros((B, nc, Q, nh), dtype=torch.float32, device=q.device)
    mx = torch.full((B, nc, Q, nh), NEG_INF, dtype=torch.float32,
                    device=q.device)
    for j in range(nc):                  # one chunk of keys a step
        s = torch.einsum("bcqhd,bjhd->bcqhj", qc, kc[:, j])
        logD = Fc[..., None] - Fc[:, j].transpose(1, 2)[:, None, None] \
            + Ic[:, j].transpose(1, 2)[:, None, None]     # (B,nc,Q,nh,Qj)
        causal = qpos[..., None] >= (j * Q + torch.arange(
            Q, device=q.device))                            # (nc, Q, Qj)
        logD = torch.where(causal[None, :, :, None, :], logD,
                           torch.full_like(logD, NEG_INF))
        m_new = torch.maximum(mx, logD.amax(dim=-1))
        sw = s * torch.exp(logD - m_new[..., None])
        corr = torch.exp(mx - m_new)
        acc = acc * corr[..., None] + torch.einsum("bcqhj,bjhd->bcqhd", sw,
                                                   vc[:, j])
        l = l * corr + sw.sum(dim=-1)
        mx = m_new
    denom = torch.maximum(l.abs(), torch.exp(-mx))
    h = acc / denom[..., None]
    return h.reshape(B, S, nh, hd)[:, :S_orig]


def _mlstm_qkv(params, x, cx, x_in, nh, group=None):
    """q, k, v and the gate pre-activations of this rank's heads from the
    conv branch ``cx`` and ``x_in`` (the rank's channels, gathered here
    over ``group``)."""
    lo, hi = group_heads(nh, group)
    hd = 2 * x.shape[-1] // nh
    cx = copy_to(_gather_heads(cx, nh, hd, group), group)
    x_in = copy_to(_gather_heads(x_in, nh, hd, group), group)
    shape = x.shape[:-1] + (hi - lo, hd)
    q = (cx @ params["w_q"].to(x.dtype)).reshape(shape)
    k = (cx @ params["w_k"].to(x.dtype)).reshape(shape)
    v = (x_in @ params["w_v"].to(x.dtype)).reshape(shape)
    w_i, w_f, f_bias = (_cols(params[n], lo, hi - lo)
                        for n in ("w_i", "w_f", "f_bias"))
    i_pre = cx @ w_i.to(x.dtype)
    f_pre = cx @ w_f.to(x.dtype) + f_bias.to(x.dtype)
    return q, k, v, i_pre, f_pre


def _mlstm_out(params, x, h, z, eps, lo: int, group=None):
    """``norm_h`` over the whole ``d_in`` (this rank's channels from
    ``lo``), the output gate, ``w_down`` and the residual."""
    scale = _cols(params["norm_h"], lo, h.shape[-1])
    h = rmsnorm_split(h, scale, eps, group, 2 * x.shape[-1]) * F.silu(z)
    return x + reduce_from(h @ params["w_down"].to(x.dtype), group)


def _mlstm_in(params, x, nh, eps, group):
    """The rank's ``x_in`` and z channels, its conv weights, and where its
    channels start."""
    lo, hi = group_heads(nh, group)
    hd = 2 * x.shape[-1] // nh
    xn = copy_to(rmsnorm(x, params["norm_in"], eps), group)
    x_in, z = torch.chunk(xn @ params["w_up"].to(x.dtype), 2, dim=-1)
    conv_w = _cols(params["conv_w"], lo * hd, (hi - lo) * hd)
    conv_b = _cols(params["conv_b"], lo * hd, (hi - lo) * hd)
    return x_in, z, conv_w.to(x.dtype), conv_b.to(x.dtype), lo * hd


def mlstm_forward(params, x, nh: int, eps: float,
                  state: Optional[dict] = None, return_state: bool = False,
                  chunk: int = 256, group=None):
    """mLSTM block. x: (B, S, d).  ``state`` is not read: a prefill starts
    fresh, as in JAX.  ``group``: this rank's heads (the module
    docstring)."""
    B, S, d = x.shape
    x_in, z, conv_w, conv_b, c0 = _mlstm_in(params, x, nh, eps, group)
    cx = F.silu(causal_conv(x_in, conv_w, conv_b))
    q, k, v, i_pre, f_pre = _mlstm_qkv(params, x, cx, x_in, nh, group)
    h = _mlstm_inner_chunked(q, k, v, i_pre, f_pre, chunk)
    out = _mlstm_out(params, x, h.reshape(B, S, z.shape[-1]).to(x.dtype), z,
                     eps, c0, group)
    if return_state:
        # the exact final recurrent state, for decode to continue from
        st = _mlstm_final_state(k, v, i_pre, f_pre)
        st["conv"] = x_in[:, S - 3:]
        return out, st
    return out


def _mlstm_final_state(k, v, i_pre, f_pre):
    """Exact (C, n, m) after consuming the whole sequence."""
    F_ = torch.cumsum(F.logsigmoid(f_pre.float()), dim=1)   # (B, S, nh)
    # the weight of step t in the final state: exp(F_S - F_t + I_t)
    logw = F_[:, -1:] - F_ + i_pre.float()
    mfin = logw.amax(dim=1)                                 # (B, nh)
    w = torch.exp(logw - mfin[:, None])                     # (B, S, nh)
    kf, vf = k.float(), v.float()
    C = (vf * w[..., None]).permute(0, 2, 3, 1) @ kf.transpose(1, 2)
    n = (kf * w[..., None]).sum(dim=1)
    return {"C": C, "n": n, "m": mfin}


def mlstm_decode(params, x, nh: int, eps: float, state: dict, group=None):
    """x: (B, 1, d); state: {C (B, nh, hd, hd), n (B, nh, hd), m (B, nh),
    conv (B, 3, d_in)}, this rank's heads under ``group``.  Returns (out,
    new state)."""
    B, _, d = x.shape
    hd = 2 * d // nh
    x_in, z, conv_w, conv_b, c0 = _mlstm_in(params, x, nh, eps, group)
    conv_buf = torch.cat([state["conv"], x_in], dim=1)      # (B, 4, d_in)
    cx = F.silu((conv_buf * conv_w).sum(dim=1) + conv_b)    # (B, d_in)
    q, k, v, i_pre, f_pre = _mlstm_qkv(params, x[:, 0], cx, x_in[:, 0], nh,
                                       group)
    i_pre, f_pre = i_pre.float(), f_pre.float()
    logf = F.logsigmoid(f_pre)
    m_prev = state["m"]
    m_new = torch.maximum(logf + m_prev, i_pre)
    f = torch.exp(logf + m_prev - m_new)
    i = torch.exp(i_pre - m_new)
    kf, vf = k.float(), v.float()
    C = f[..., None, None] * state["C"] + i[..., None, None] * (
        vf[..., :, None] * kf[..., None, :])
    n = f[..., None] * state["n"] + i[..., None] * kf
    qf = q.float() * hd ** -0.5
    num = (C @ qf[..., None])[..., 0]                       # (B, nh, hd)
    den = torch.maximum((n * qf).sum(dim=-1).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, z.shape[-1]).to(x.dtype)
    out = _mlstm_out(params, x, h, z, eps, c0, group)
    return out, {"C": C, "n": n, "m": m_new, "conv": conv_buf[:, 1:]}


def init_mlstm_state(batch: int, d: int, nh: int, dtype=torch.float32,
                     device=None, heads: Optional[int] = None) -> dict:
    """Fresh state for ``heads`` of the ``nh`` heads (all by default; a
    tensor-parallel rank's count)."""
    hd = 2 * d // nh
    nh = nh if heads is None else heads
    d_in = nh * hd
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, nh, hd, hd), **f32),
        "n": torch.zeros((batch, nh, hd), **f32),
        "m": torch.full((batch, nh), NEG_INF, **f32),
        "conv": torch.zeros((batch, 3, d_in), dtype=dtype, device=device),
    }


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, d: int, nh: int, *, lead=(),
               dtype=torch.float32, device=None) -> dict:
    """One block's params (``lead`` stacks them), JAX ``init_slstm``'s
    layout and distributions; the recurrent weights ``r_gates`` (4, nh,
    hd, hd) are f32, as the JAX block reads them."""
    hd = d // nh
    ff = int(d * 4 / 3)
    lead = tuple(lead)
    kw = dict(lead=lead, dtype=dtype, device=device)
    # per gate: a (hd, nh * hd) fan-in hd draw, viewed as (nh, hd, hd)
    rec = m.dense_init(gen, hd, hd * nh, lead=lead + (4,), device=device)
    rec = rec.reshape(lead + (4, hd, nh, hd)).transpose(-3, -2)
    return {
        "norm_in": m.zeros(lead + (d,), device=device),
        "w_gates": m.dense_init(gen, d, 4 * d, **kw),     # i, f, z, o
        "r_gates": rec.contiguous(),
        "b_gates": torch.cat([torch.zeros(lead + (d,), device=device),
                              torch.full(lead + (d,), 3.0, device=device),
                              torch.zeros(lead + (2 * d,), device=device)],
                             dim=-1).to(dtype=dtype),
        "norm_h": m.zeros(lead + (d,), device=device),
        "w_up": m.dense_init(gen, d, 2 * ff, **kw),
        "w_down": m.dense_init(gen, ff, d, **kw),
    }


def _slstm_cell(state, gates, nh: int):
    """One sLSTM step. gates: (B, 4d) pre-activations, recurrent part
    included; state: (h, c, n, m), each (B, nh, hd)."""
    h_prev, c_prev, n_prev, m_prev = state
    gi, gf, gz, go = (g.reshape(h_prev.shape)
                      for g in torch.chunk(gates, 4, dim=-1))
    logf = F.logsigmoid(gf)
    m_new = torch.maximum(logf + m_prev, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(logf + m_prev - m_new)
    c = f * c_prev + i * torch.tanh(gz)
    n = f * n_prev + i
    h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
    return h, c, n, m_new


def _recurrent(h, r):
    """h (B, nh, hd) through the block-diagonal recurrent weights r (4, nh,
    hd, hd) -> (B, 4d), gate-major."""
    return torch.einsum("bhd,ghde->bghe", h, r).reshape(
        h.shape[0], 4 * h.shape[1] * h.shape[2])


def _slstm_out(params, x, h, eps, nh: int, group=None):
    """``h`` (this rank's heads) gathered to the whole ``d``, ``norm_h``,
    the gated FFN (column- then row-parallel) and the residual."""
    h = _gather_heads(h, nh, x.shape[-1] // nh, group)
    h = copy_to(rmsnorm(h, params["norm_h"], eps), group)
    a, b = torch.chunk(h @ params["w_up"].to(x.dtype), 2, dim=-1)
    # jax.nn.gelu defaults to the tanh approximation
    return x + reduce_from((F.gelu(a, approximate="tanh") * b)
                           @ params["w_down"].to(x.dtype), group)


def _slstm_in(params, x, nh: int, eps: float, group):
    """The rank's gate pre-activations' input projection (``w_gates``
    with its heads' ``b_gates``) and its heads' recurrent weights."""
    lo, hi = group_heads(nh, group)
    d = x.shape[-1]
    hd = d // nh
    b = params["b_gates"]
    if hi - lo < nh:
        b = torch.cat([b.narrow(-1, g * d + lo * hd, (hi - lo) * hd)
                       for g in range(4)], dim=-1)
    xn = copy_to(rmsnorm(x, params["norm_in"], eps), group)
    gx = xn @ params["w_gates"].to(x.dtype) + b.to(x.dtype)
    return gx, _cols(params["r_gates"], lo, hi - lo, 1).float(), hi - lo


def slstm_forward(params, x, nh: int, eps: float,
                  state: Optional[dict] = None, return_state: bool = False,
                  group=None):
    """sLSTM block: a sequential loop over time. x: (B, S, d).  ``group``:
    this rank's heads (the module docstring)."""
    B, S, d = x.shape
    gates_x, r, nh_r = _slstm_in(params, x, nh, eps, group)
    if state is None:
        state = init_slstm_state(B, d, nh, device=x.device, heads=nh_r)
    st = (state["h"], state["c"], state["n"], state["m"])
    # one view a step: indexing the (B, S, 4d) projection inside the loop
    # would give each step's backward a zero gradient of all of it
    gx = gates_x.float().unbind(1)
    hs = []
    for t in range(S):
        if t == 1 and _roof.repeats(x):
            # the dry run: iteration 1 counted for iterations 1..S-1
            st, hs = _slstm_repeat(st, gx[1], r, nh_r, S, hs)
            break
        st = _slstm_cell(st, gx[t] + _recurrent(st[0], r), nh_r)
        hs.append(st[0])
    h = torch.stack(hs, dim=1).reshape(B, S, nh_r * (d // nh)).to(x.dtype)
    out = _slstm_out(params, x, h, eps, nh, group)
    if return_state:
        return out, dict(zip(("h", "c", "n", "m"), st))
    return out


def _slstm_repeat(st, gx1, r, nh, S, hs):
    """Iterations 1..S-1 of ``slstm_forward``'s time loop under an
    operation counter on meta (``roofline.counter.trip_count``): one
    iteration runs and is charged S - 1 times, its backward too; every
    step's ``h`` is kept (the loop stacks them), the cell state is carried.
    ``gx1``: step 1's view of the gate projection (each step reads its
    own).  Only the meta dry run comes here: on the CPU and the card every
    iteration runs."""
    r_loop = r.view_as(r)      # a non-leaf handle for the gradient's adds
    with _roof.trip_count(S - 1) as rep:
        new = _slstm_cell(st, gx1 + _recurrent(st[0], r_loop), nh)
        rep.region(inputs=(*st, gx1, r_loop), outputs=new,
                   shared=(r_loop,))
        rep.carry(*new[1:])
    return new, hs + [new[0]] * (S - 1)


def slstm_decode(params, x, nh: int, eps: float, state: dict, group=None):
    B, _, d = x.shape
    g_x, r, nh_r = _slstm_in(params, x[:, 0], nh, eps, group)
    st = _slstm_cell((state["h"], state["c"], state["n"], state["m"]),
                     g_x.float() + _recurrent(state["h"], r), nh_r)
    out = _slstm_out(params, x, st[0].reshape(B, 1, nh_r * (d // nh)).to(
        x.dtype), eps, nh, group)
    return out, dict(zip(("h", "c", "n", "m"), st))


def init_slstm_state(batch: int, d: int, nh: int, device=None,
                     heads: Optional[int] = None) -> dict:
    """Fresh state for ``heads`` of the ``nh`` heads (all by default)."""
    hd = d // nh
    nh = nh if heads is None else heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, nh, hd), **f32),
            "c": torch.zeros((batch, nh, hd), **f32),
            "n": torch.zeros((batch, nh, hd), **f32),
            "m": torch.full((batch, nh, hd), NEG_INF, **f32)}
