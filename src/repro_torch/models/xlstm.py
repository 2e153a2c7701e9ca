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
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import module as m
from repro_torch.models.layers import causal_conv, rmsnorm

NEG_INF = -1e30


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


def _mlstm_qkv(params, x, cx, x_in, nh):
    """q, k, v and the gate pre-activations from the conv branch ``cx``."""
    shape = x.shape[:-1] + (nh, -1)
    q = (cx @ params["w_q"].to(x.dtype)).reshape(shape)
    k = (cx @ params["w_k"].to(x.dtype)).reshape(shape)
    v = (x_in @ params["w_v"].to(x.dtype)).reshape(shape)
    i_pre = cx @ params["w_i"].to(x.dtype)
    f_pre = cx @ params["w_f"].to(x.dtype) + params["f_bias"].to(x.dtype)
    return q, k, v, i_pre, f_pre


def _mlstm_out(params, x, h, z, eps):
    h = rmsnorm(h, params["norm_h"], eps) * F.silu(z)
    return x + h @ params["w_down"].to(x.dtype)


def mlstm_forward(params, x, nh: int, eps: float,
                  state: Optional[dict] = None, return_state: bool = False,
                  chunk: int = 256):
    """mLSTM block. x: (B, S, d).  ``state`` is not read: a prefill starts
    fresh, as in JAX."""
    B, S, d = x.shape
    d_in = 2 * d
    xn = rmsnorm(x, params["norm_in"], eps)
    x_in, z = torch.chunk(xn @ params["w_up"].to(x.dtype), 2, dim=-1)
    cx = F.silu(causal_conv(x_in, params["conv_w"].to(x.dtype),
                            params["conv_b"].to(x.dtype)))
    q, k, v, i_pre, f_pre = _mlstm_qkv(params, x, cx, x_in, nh)
    h = _mlstm_inner_chunked(q, k, v, i_pre, f_pre, chunk)
    out = _mlstm_out(params, x, h.reshape(B, S, d_in).to(x.dtype), z, eps)
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


def mlstm_decode(params, x, nh: int, eps: float, state: dict):
    """x: (B, 1, d); state: {C (B, nh, hd, hd), n (B, nh, hd), m (B, nh),
    conv (B, 3, d_in)}.  Returns (out, new state)."""
    B, _, d = x.shape
    d_in = 2 * d
    hd = d_in // nh
    xn = rmsnorm(x, params["norm_in"], eps)
    x_in, z = torch.chunk(xn @ params["w_up"].to(x.dtype), 2, dim=-1)
    conv_buf = torch.cat([state["conv"], x_in], dim=1)      # (B, 4, d_in)
    cx = F.silu((conv_buf * params["conv_w"].to(x.dtype)).sum(dim=1)
                + params["conv_b"].to(x.dtype))             # (B, d_in)
    q, k, v, i_pre, f_pre = _mlstm_qkv(params, x[:, 0], cx, x_in[:, 0], nh)
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
    h = (num / den[..., None]).reshape(B, 1, d_in).to(x.dtype)
    out = _mlstm_out(params, x, h, z, eps)
    return out, {"C": C, "n": n, "m": m_new, "conv": conv_buf[:, 1:]}


def init_mlstm_state(batch: int, d: int, nh: int, dtype=torch.float32,
                     device=None) -> dict:
    d_in = 2 * d
    hd = d_in // nh
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
        "b_gates": torch.cat([torch.zeros(lead + (d,)),
                              torch.full(lead + (d,), 3.0),
                              torch.zeros(lead + (2 * d,))], dim=-1).to(
            dtype=dtype, device=device),
        "norm_h": m.zeros(lead + (d,), device=device),
        "w_up": m.dense_init(gen, d, 2 * ff, **kw),
        "w_down": m.dense_init(gen, ff, d, **kw),
    }


def _slstm_cell(state, gates, nh: int):
    """One sLSTM step. gates: (B, 4d) pre-activations, recurrent part
    included; state: (h, c, n, m), each (B, nh, hd)."""
    h_prev, c_prev, n_prev, m_prev = state
    B = h_prev.shape[0]
    gi, gf, gz, go = (g.reshape(B, nh, -1)
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
    return torch.einsum("bhd,ghde->bghe", h, r).reshape(h.shape[0], -1)


def _slstm_out(params, x, h, eps):
    h = rmsnorm(h, params["norm_h"], eps)
    a, b = torch.chunk(h @ params["w_up"].to(x.dtype), 2, dim=-1)
    # jax.nn.gelu defaults to the tanh approximation
    return x + (F.gelu(a, approximate="tanh") * b) \
        @ params["w_down"].to(x.dtype)


def slstm_forward(params, x, nh: int, eps: float,
                  state: Optional[dict] = None, return_state: bool = False):
    """sLSTM block: a sequential loop over time. x: (B, S, d)."""
    B, S, d = x.shape
    xn = rmsnorm(x, params["norm_in"], eps)
    gates_x = (xn @ params["w_gates"].to(x.dtype)
               + params["b_gates"].to(x.dtype)).float()      # (B, S, 4d)
    if state is None:
        state = init_slstm_state(B, d, nh, device=x.device)
    st = (state["h"], state["c"], state["n"], state["m"])
    r = params["r_gates"].float()
    hs = []
    for t in range(S):
        st = _slstm_cell(st, gates_x[:, t] + _recurrent(st[0], r), nh)
        hs.append(st[0])
    h = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    out = _slstm_out(params, x, h, eps)
    if return_state:
        return out, dict(zip(("h", "c", "n", "m"), st))
    return out


def slstm_decode(params, x, nh: int, eps: float, state: dict):
    B, _, d = x.shape
    xn = rmsnorm(x, params["norm_in"], eps)
    g_x = xn[:, 0] @ params["w_gates"].to(x.dtype) \
        + params["b_gates"].to(x.dtype)
    g = g_x.float() + _recurrent(state["h"], params["r_gates"].float())
    st = _slstm_cell((state["h"], state["c"], state["n"], state["m"]), g,
                     nh)
    out = _slstm_out(params, x, st[0].reshape(B, 1, d).to(x.dtype), eps)
    return out, dict(zip(("h", "c", "n", "m"), st))


def init_slstm_state(batch: int, d: int, nh: int, device=None) -> dict:
    hd = d // nh
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, nh, hd), **f32),
            "c": torch.zeros((batch, nh, hd), **f32),
            "n": torch.zeros((batch, nh, hd), **f32),
            "m": torch.full((batch, nh, hd), NEG_INF, **f32)}
