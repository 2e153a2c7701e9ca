"""The family of Arcee's AfMoE decoder (Trinity-Mini): its float32 forward
pass, its seeded weights and its FLOP count.

A layer ``l`` with input x, as Hugging Face transformers'
``models/afmoe/modeling_afmoe.py`` orders it (the configuration file's
``assumed`` lists what was taken from there):

    h = RMSNorm_in(x)
    q = RMSNorm_q(h Wq) per head;  k = RMSNorm_k(h Wk) per head;  v = h Wv
    a local layer rotates q and k (RoPE) and sees the keys less than
    ``sliding_window`` positions back; a global layer (l % P == P - 1, P
    the stage's ``local_global_period``, l counted over the whole model)
    has no RoPE and sees every earlier key
    a = softmax(q k^T / sqrt(dh)) v  (query head h reads KV head h // G)
    a = a * sigmoid(h Wg)                       (the output gate)
    x = x + RMSNorm_post_attn(a Wo)
    f = SwiGLU(RMSNorm_pre_mlp(x)) on a dense layer, MoE(...) on an MoE one
    x = x + RMSNorm_post_mlp(f)

    MoE(h): s = sigmoid(h Wr) (128 scores); the top k of s + b (b the
    layer's expert bias, selection only; ties to the lower index); weights
    s of the chosen, over their sum (+ 1e-20), times ``route_scale``; the
    weighted sum of the chosen experts' SwiGLUs plus the shared expert's.

The embedding is multiplied by ``embed_multiplier`` (sqrt(d_model), muP),
then the final RMSNorm and an untied head.  RMSNorm scales by ``1 +
scale`` (the published ``weight``, which starts at 1).

``logits_at`` runs one layer at a time: its attention sequence by
sequence (in blocks of queries), its feed-forward over every sequence's
tokens at once, the MoE one expert at a time over the tokens routed to it,
so the float32 copy of one layer's weights (one expert's at a time) is
alive at once.  Nothing of the program is imported.

``quantize="fp8"`` is the control: every projection (q, k, v, the gate,
the output, the dense MLP, every expert and the shared expert) multiplies
float8 (e4m3) copies of its input, scaled per row, and of its weight,
scaled per output column; the router and the head stay in float32.

The weights (``make_params``) are the decoder family's draws
(``weights.dense`` / ``norm``) in the program's layout, but for the
embedding, drawn N(0, 1 / d_model) so that the muP multiplier makes it
N(0, 1), and the expert bias, drawn N(0, ``BIAS_STD``^2) in float32: small
beside the gaps between the sigmoid scores near the top-8 boundary, so it
changes some selections but not most.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from perfbench import counts
from perfbench.reference.decoder import (Linear, causal_attention, no_tf32,
                                         rmsnorm, rope, rope_tables)
from perfbench.weights import dense, norm

#: the expert bias's spread (scores lie in (0, 1); near the top-8
#: boundary of 128 N(0, 1) logits neighbouring scores lie ~0.01 apart)
BIAS_STD = 0.004


def windows(sizes: dict) -> List[List[Optional[int]]]:
    """Each stage's layers' windows, the layers counted over the whole
    model: the sliding window on a local layer, None on a global one."""
    out, base = [], 0
    for st in sizes["stages"]:
        P = st.get("local_global_period", 0)
        out.append([None if not P or (base + li) % P == P - 1
                    else sizes["sliding_window"]
                    for li in range(st["n_layers"])])
        base += st["n_layers"]
    return out


def covers(cfg) -> Optional[str]:
    """None where this reference computes the program's ``cfg``: stages
    of attention + SwiGLU MLP or + sigmoid-routed SwiGLU experts with no
    entry dropped, QK norm, a local:global window with RoPE on the local
    layers only, the output gate and sandwich norms; else why not."""
    moe = cfg.moe
    ok = (cfg.qk_norm and cfg.mlp_gated and cfg.sliding_window
          and cfg.rope_local_only and cfg.attn_out_gate and cfg.sandwich_norm
          and not cfg.qkv_bias and not cfg.tie_embeddings
          and not cfg.n_codebooks and cfg.embed_inputs
          and all(st.kind in ("attn_mlp", "attn_moe")
                  and st.local_global_period for st in cfg.stages))
    if not ok:
        return ("the afmoe reference covers QK-norm, gated, sandwich-normed "
                "attention over a local:global window (RoPE on local layers "
                "only) with SwiGLU MLP or expert stages, no bias or tied or "
                "codebook head")
    if any(st.kind == "attn_moe" for st in cfg.stages) and (
            moe is None or moe.score_func != "sigmoid"
            or moe.capacity_factor * moe.top_k < moe.n_experts):
        return ("the afmoe reference covers sigmoid routing with no entry "
                "dropped (capacity_factor * top_k >= n_experts)")
    return None


def make_params(sizes: dict, seed: int, device, dtype=torch.bfloat16):
    """The program's layout: per stage the norms, the attention with its
    QK norms and gate, and the MLP or the experts (router, routed and
    shared experts, expert bias); the embedding over the padded
    vocabulary and the head."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    d, H, KV, dh = (sizes[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                       "d_head"))
    Vp, moe = sizes["padded_vocab"], sizes.get("moe")
    # N(0, 1 / d): times ``embed_multiplier`` (sqrt(d)), N(0, 1) as the
    # decoder family's embedding
    params = {"embed": {"tok": torch.randn(
        (Vp, d), generator=gen, dtype=dtype,
        device=device).mul_(1.0 / math.sqrt(d))}}
    for i, st in enumerate(sizes["stages"]):
        L = st["n_layers"]
        p = {"norm1": norm(gen, (L, d), device),
             "attn": {"wq": dense(gen, (L, d, H * dh), dtype, device),
                      "wk": dense(gen, (L, d, KV * dh), dtype, device),
                      "wv": dense(gen, (L, d, KV * dh), dtype, device),
                      "wo": dense(gen, (L, H * dh, d), dtype, device),
                      "q_norm": norm(gen, (L, dh), device),
                      "k_norm": norm(gen, (L, dh), device),
                      "wg": dense(gen, (L, d, H * dh), dtype, device)},
             "norm2": norm(gen, (L, d), device),
             "post_attn_norm": norm(gen, (L, d), device),
             "post_mlp_norm": norm(gen, (L, d), device)}
        if st["kind"] == "attn_moe":
            E, de = moe["n_experts"], moe["d_expert"]
            fs = moe.get("n_shared_experts", 0) * de
            m = {"router": dense(gen, (L, d, E), dtype, device),
                 "w_gate": dense(gen, (L, E, d, de), dtype, device),
                 "w_up": dense(gen, (L, E, d, de), dtype, device),
                 "w_down": dense(gen, (L, E, de, d), dtype, device),
                 "expert_bias": torch.randn(
                     (L, E), generator=gen, dtype=torch.float32,
                     device=device).mul_(BIAS_STD)}
            if fs:
                m.update(shared_gate=dense(gen, (L, d, fs), dtype, device),
                         shared_up=dense(gen, (L, d, fs), dtype, device),
                         shared_down=dense(gen, (L, fs, d), dtype, device))
            p["moe"] = m
        else:
            ff = sizes["d_ff"]
            p["mlp"] = {"w_gate": dense(gen, (L, d, ff), dtype, device),
                        "w_up": dense(gen, (L, d, ff), dtype, device),
                        "w_down": dense(gen, (L, ff, d), dtype, device)}
        params[f"stage{i}"] = p
    params["final_norm"] = norm(gen, (d,), device)
    params["head"] = {"w": dense(gen, (d, Vp), dtype, device)}
    return params


def swiglu(x, w_gate, w_up, w_down, lin: Linear):
    """SwiGLU of weights already through ``lin.weight``."""
    return lin(F.silu(lin(x, w_gate)) * lin(x, w_up), w_down)


def moe(x, m: dict, li: int, top_k: int, route_scale: float,
        lin: Linear):
    """The sigmoid-routed experts and the shared expert of layer ``li``:
    x (T, d) -> (T, d), every routed (token, expert) pair computed."""
    s = torch.sigmoid(x @ m["router"][li].float())
    pick = s + m["expert_bias"][li].float()
    idx = torch.sort(pick, dim=-1, descending=True,
                     stable=True).indices[:, :top_k]
    w = s.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * route_scale
    y = torch.zeros_like(x)
    for e in range(s.shape[-1]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(x[tok], *(lin.weight(m[n][li][e])
                               for n in ("w_gate", "w_up", "w_down")), lin)
        y.index_add_(0, tok, out * w[tok, slot, None])
    if "shared_gate" in m:
        y = y + swiglu(x, *(lin.weight(m[n][li]) for n in
                            ("shared_gate", "shared_up", "shared_down")),
                       lin)
    return y


def logits_at(params: dict, sizes: dict, seqs: Sequence[Sequence[int]],
              want: Sequence[Sequence[int]], *,
              quantize: Optional[str] = None,
              device=None) -> List[torch.Tensor]:
    """For each token sequence ``seqs[i]``, the float32 logits over the
    vocabulary at the positions ``want[i]``: (len(want[i]), vocab)."""
    dev = torch.device(device) if device is not None else \
        params["final_norm"].device
    no_tf32(dev)
    lin = Linear(quantize)
    H, KV, dh = sizes["n_heads"], sizes["n_kv_heads"], sizes["d_head"]
    eps, moe_cfg = sizes["norm_eps"], sizes.get("moe")
    lens = [len(s) for s in seqs]
    x = torch.cat([params["embed"]["tok"][torch.as_tensor(list(s),
                                                          device=dev)]
                   for s in seqs]).float() \
        * float(sizes.get("embed_multiplier", 1.0))
    cos, sin = rope_tables(max(lens), dh, float(sizes["rope_theta"]), dev)
    for i, wins in enumerate(windows(sizes)):
        st = params[f"stage{i}"]
        a = st["attn"]
        for li, window in enumerate(wins):
            wq, wk, wv, wo, wg = (lin.weight(a[n][li])
                                  for n in ("wq", "wk", "wv", "wo", "wg"))
            parts = []
            for xs in x.split(lens):
                S = xs.shape[0]
                h = rmsnorm(xs, st["norm1"][li], eps)
                q = rmsnorm(lin(h, wq).view(S, H, dh), a["q_norm"][li], eps)
                k = rmsnorm(lin(h, wk).view(S, KV, dh), a["k_norm"][li], eps)
                v = lin(h, wv).view(S, KV, dh)
                if window is not None:
                    q, k = rope(q, cos, sin), rope(k, cos, sin)
                att = causal_attention(q, k, v, window=window) \
                    * torch.sigmoid(lin(h, wg))
                parts.append(rmsnorm(lin(att, wo), st["post_attn_norm"][li],
                                     eps))
            x = x + torch.cat(parts)
            h = rmsnorm(x, st["norm2"][li], eps)
            if "moe" in st:
                f = moe(h, st["moe"], li, moe_cfg["top_k"],
                        float(moe_cfg.get("route_scale", 1.0)), lin)
            else:
                f = swiglu(h, *(lin.weight(st["mlp"][n][li])
                                for n in ("w_gate", "w_up", "w_down")), lin)
            x = x + rmsnorm(f, st["post_mlp_norm"][li], eps)
    head = params["head"]["w"][:, :sizes["vocab"]].float()
    return [rmsnorm(xs[torch.as_tensor(list(pos), device=dev)],
                    params["final_norm"], eps) @ head
            for xs, pos in zip(x.split(lens), want)]


def model_flops(sizes: dict, chunks: Sequence[tuple]) -> float:
    """Model FLOPs of the tokens processed: ``chunks`` of (start, n,
    logits).  2 FLOPs a weight a token in the projections (the gate's
    included), the dense MLP on dense layers, the router, the top-k
    experts and the shared expert on MoE layers; QK^T and PV over the
    (query, key) pairs each layer's window leaves (``counts.window_pairs``;
    every earlier key on a global layer); the head for ``logits`` tokens."""
    d, H, KV, dh = (sizes[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                       "d_head"))
    attn = d * (H + 2 * KV) * dh + 2 * H * dh * d
    moe = sizes.get("moe") or {}
    ffn = {"attn_mlp": 3 * d * sizes["d_ff"]}
    if moe:
        ffn["attn_moe"] = d * moe["n_experts"] + 3 * d * moe["d_expert"] * (
            moe["top_k"] + moe.get("n_shared_experts", 0))
    total = 0.0
    for start, n, logits in chunks:
        for st, wins in zip(sizes["stages"], windows(sizes)):
            for window in wins:
                total += 2.0 * n * (attn + ffn[st["kind"]]) + 4.0 * H * dh \
                    * counts.window_pairs(start, n, window)
        total += 2.0 * logits * d * sizes["vocab"]
    return total
