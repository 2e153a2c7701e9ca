"""The family of the plain pre-norm decoder: its float32 forward pass,
its seeded weights and its FLOP count.

A configuration file names its family module under ``reference``; this
is the first (see ``perfbench/reference/__init__.py`` for what a family
exports).  ``covers`` says which of the program's configurations this
reference computes; ``make_params`` is ``weights.make_params`` and
``model_flops`` is ``counts.model_flops``.

One pre-norm decoder covers both families of the benchmark's
configurations: a dense one (GQA attention with RoPE, then a GELU MLP:
starcoder2-7b) and a sparse one (GQA attention with RoPE, then top-k
experts with SwiGLU: phimini-moe).  It reads the weights the harness
made (the nested dict the harness hands the program as well, stacked
over layers) and works everything out from them itself, one layer at a
time for every sequence, so the float32 copy of only one layer's
weights is alive at once.  Attention runs in blocks of queries.  No
kernel, cache, padding or batching of the program is used, and nothing of
the program is imported.

The architecture is the program's, which departs from the published
models in ways the configuration files list (their ``departures``):

* RMSNorm scaled by ``1 + scale`` (the published models: LayerNorm with
  a bias); no bias in any projection (the published ``use_bias`` /
  ``attention_bias``);
* RoPE on the half-split rotation, ``theta ** (-i / (dh / 2))``;
* GELU with the tanh approximation (starcoder2-7b's
  ``gelu_pytorch_tanh``);
* routing: softmax over the router's logits, the top k by a stable
  descending sort, their weights renormalised to sum to 1, no token
  dropped (phimini-moe publishes ``sparsemixer`` routing);
* no sliding window (starcoder2-7b publishes 4,096; every sequence of its
  cells is shorter).

``quantize="fp8"`` is the control: every projection of the attention,
the MLP and the experts multiplies float8 (e4m3) copies of its input,
scaled per row, and of its weight, scaled per output column, as an fp8
serving path would; the router and the output head stay in float32.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from perfbench.counts import model_flops  # noqa: F401  (the family's count)
from perfbench.weights import make_params  # noqa: F401  (its weights)

FP8_MAX = 448.0


def covers(cfg) -> Optional[str]:
    """None where this reference computes the program's ``cfg``: one
    stage of attention + GELU MLP, or of attention + SwiGLU experts with
    no shared expert; else why not."""
    moe = cfg.moe
    plain = (not cfg.qkv_bias and not cfg.qk_norm and not cfg.sliding_window
             and not cfg.tie_embeddings and not cfg.n_codebooks
             and cfg.embed_inputs and (moe is not None or not cfg.mlp_gated)
             and (moe is None or cfg.mlp_gated))
    if not plain:
        return ("the reference covers a GELU MLP or SwiGLU experts, with no "
                "bias, QK norm, window, tied or codebook head")
    kind = "attn_moe" if moe is not None else "attn_mlp"
    if [(st.kind, st.n_layers, st.local_global_period)
            for st in cfg.stages] != [(kind, cfg.n_layers, 0)] \
            or (moe is not None and moe.n_shared_experts):
        return ("the reference covers one stage of attention + MLP or "
                "attention + MoE layers, with no local:global interleave "
                "or shared expert")
    return None


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded through float8 e4m3, scaled along ``dim`` so that
    each slice's largest magnitude maps to the format's largest."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Linear:
    def __init__(self, quantize: Optional[str]):
        if quantize not in (None, "fp8"):
            raise ValueError(f"quantize {quantize!r}: None or 'fp8'")
        self.quantize = quantize

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _fp8(w, 0) if self.quantize else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` with ``w`` already through ``weight``."""
        if self.quantize:
            x = _fp8(x, -1)
        return x @ w


def no_tf32(dev: torch.device):
    """Float32 matmuls in float32 on a card: TF32 off."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def rope_tables(n: int, dh: int, theta: float, device):
    """cos, sin (n, dh / 2) of positions 0 ... n - 1, worked out in
    float64."""
    half = dh // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=device) / half)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x: torch.Tensor, cos, sin):
    """x (S, heads, dh) rotated at positions 0 ... S - 1."""
    half = x.shape[-1] // 2
    c, s = cos[:x.shape[0], None, :], sin[:x.shape[0], None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def causal_attention(q, k, v, block: int = 512, window=None):
    """q (S, H, dh), k / v (S, KV, dh): softmax attention of each query
    over the keys at or before it (and, with a ``window``, less than
    ``window`` positions before it), query head h reading KV head
    h // (H / KV); (S, H * dh)."""
    S, H, dh = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)      # (H, S, dh)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty((S, H, dh), dtype=torch.float32, device=q.device)
    for lo in range(0, S, block):
        hi = min(lo + block, S)
        qb = q[lo:hi].transpose(0, 1)                       # (H, b, dh)
        s = (qb @ k[:, :hi].transpose(1, 2)) / math.sqrt(dh)
        pos = torch.arange(lo, hi, device=q.device)[:, None]
        key = torch.arange(hi, device=q.device)[None, :]
        masked = key > pos
        if window is not None:
            masked = masked | (pos - key >= window)
        s = s.masked_fill(masked, float("-inf"))
        out[lo:hi] = (torch.softmax(s, dim=-1) @ v[:, :hi]).transpose(0, 1)
    return out.reshape(S, H * dh)


def moe(x, router, w_gate, w_up, w_down, top_k: int, lin: Linear):
    """Top-k routing over the router's softmax, weights renormalised, every
    routed (token, expert) pair computed: x (T, d) -> (T, d)."""
    probs = torch.softmax(x @ router.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w = vals[:, :top_k] / vals[:, :top_k].sum(-1, keepdim=True)
    idx = idx[:, :top_k]
    y = torch.zeros_like(x)
    for e in range(router.shape[-1]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = x[tok]
        g = F.silu(lin(h, lin.weight(w_gate[e]))) * lin(h, lin.weight(w_up[e]))
        y.index_add_(0, tok, lin(g, lin.weight(w_down[e])) * w[tok, slot, None])
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
    eps, V = sizes["norm_eps"], sizes["vocab"]
    moe_cfg = sizes.get("moe")
    table = params["embed"]["tok"]
    xs = [table[torch.as_tensor(list(s), device=dev)].float() for s in seqs]
    cos, sin = rope_tables(max(len(s) for s in seqs), dh,
                           float(sizes["rope_theta"]), dev)
    st = params["stage0"]
    for li in range(sizes["n_layers"]):
        a = st["attn"]
        wq, wk, wv, wo = (lin.weight(a[n][li]) for n in ("wq", "wk", "wv",
                                                         "wo"))
        if moe_cfg:
            m = {n: st["moe"][n][li] for n in ("router", "w_gate", "w_up",
                                              "w_down")}
        else:
            w_in = lin.weight(st["mlp"]["w_in"][li])
            w_out = lin.weight(st["mlp"]["w_out"][li])
        for i, x in enumerate(xs):
            S = x.shape[0]
            h = rmsnorm(x, st["norm1"][li], eps)
            q = rope(lin(h, wq).view(S, H, dh), cos, sin)
            k = rope(lin(h, wk).view(S, KV, dh), cos, sin)
            v = lin(h, wv).view(S, KV, dh)
            x = x + lin(causal_attention(q, k, v), wo)
            h = rmsnorm(x, st["norm2"][li], eps)
            if moe_cfg:
                x = x + moe(h, m["router"], m["w_gate"], m["w_up"],
                            m["w_down"], moe_cfg["top_k"], lin)
            else:
                x = x + lin(F.gelu(lin(h, w_in), approximate="tanh"), w_out)
            xs[i] = x
    head = params["head"]["w"][:, :V].float()
    out = []
    for x, pos in zip(xs, want):
        h = rmsnorm(x[torch.as_tensor(list(pos), device=dev)],
                    params["final_norm"], eps)
        out.append(h @ head)
    return out
