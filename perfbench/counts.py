"""The benchmark's own counts: operations and bytes of each kernel call, a
model's FLOPs per token, and the card's peaks.

Each input byte is counted as read once and each output byte as written
once, whatever a kernel reads again; work that depends on the data
(causal masks, lengths, the rows routed to each expert) is counted for
the inputs at hand, not for the most they could need.  A roofline bound
is the larger of operations over the peak rate and bytes over the peak
bandwidth.

An attention call's ``window`` is the port's: a query at position ``p``
sees the keys at ``p - window + 1`` ... ``p``.  None, or a window as wide
as the context (the port passes ``2 ** 30`` for the global layers of a
local:global interleave), counts full causal attention.
"""
from __future__ import annotations

from typing import Sequence

#: NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for the work: seconds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def causal_pairs(start: int, n: int) -> int:
    """(query, key) pairs of ``n`` queries at positions ``start`` ...
    ``start + n - 1``, each attending every key up to its own position."""
    return n * start + n * (n + 1) // 2


def window_pairs(start: int, n: int, window=None) -> int:
    """(query, key) pairs of ``n`` queries at positions ``start`` ...
    ``start + n - 1``, each attending the keys up to its own position that
    lie inside ``window``: ``causal_pairs`` where the window reaches back
    to position 0."""
    if window is None:
        return causal_pairs(start, n)
    inside = max(0, min(start + n, window) - start)
    return causal_pairs(start, inside) + (n - inside) * window


def _first_key(start: int, window) -> int:
    """The first key position a query at ``start`` sees."""
    return 0 if window is None else max(0, start - window + 1)


def flash_prefill(lengths: Sequence[int], H: int, KV: int, dh: int,
                  itemsize: int = 2, window=None):
    """(FLOPs, bytes) of a causal prefill over rows of ``lengths`` real
    tokens: QK^T and PV over the causal pairs inside the window; Q, K, V
    read, O written, the lengths read."""
    flops = sum(4 * H * dh * window_pairs(0, n, window) for n in lengths)
    tok = sum(lengths)
    nbytes = (2 * tok * H * dh + 2 * tok * KV * dh) * itemsize \
        + 4 * len(lengths)
    return flops, nbytes


def paged_extend(starts: Sequence[int], news: Sequence[int], H: int,
                 KV: int, dh: int, page_size: int, itemsize: int = 2,
                 window=None):
    """(FLOPs, bytes) of an extend: row b appends ``news[b]`` queries after
    ``starts[b]`` cached tokens and attends causally over those inside the
    window.  Q read and O written for the new tokens, K and V read once
    for every key some query of the row sees, the block-table entries of
    their pages, starts and lengths."""
    flops = sum(4 * H * dh * window_pairs(s, n, window)
                for s, n in zip(starts, news))
    new = sum(news)
    first = [_first_key(s, window) for s in starts]
    ctx = sum(s + n - f for s, n, f in zip(starts, news, first))
    pages = sum(-(-(s + n) // page_size) - f // page_size
                for s, n, f in zip(starts, news, first))
    nbytes = (2 * new * H * dh + 2 * ctx * KV * dh) * itemsize \
        + 4 * pages + 8 * len(starts)
    return flops, nbytes


def paged_decode(lengths: Sequence[int], H: int, KV: int, dh: int,
                 page_size: int, itemsize: int = 2, window=None):
    """(FLOPs, bytes) of one decode step: one query a row over the keys of
    its ``lengths[b]`` inside the window."""
    first = [_first_key(n - 1, window) for n in lengths]
    seen = [n - f for n, f in zip(lengths, first)]
    flops = sum(4 * H * dh * k for k in seen)
    ctx = sum(seen)
    pages = sum(-(-n // page_size) - f // page_size
                for n, f in zip(lengths, first))
    nbytes = (2 * len(lengths) * H * dh + 2 * ctx * KV * dh) * itemsize \
        + 4 * pages + 4 * len(lengths)
    return flops, nbytes


def moe_gmm(E: int, C: int, d: int, f: int, group_sizes: Sequence[int],
            itemsize: int = 2):
    """(FLOPs, bytes) of one grouped matmul x (E, C, d) @ w (E, d, f):
    the rows inside the groups multiplied; the weights of the experts
    that have rows, those rows and the group sizes read, the whole (E,
    C, f) output written."""
    sizes = [min(max(int(n), 0), C) for n in group_sizes]
    rows = sum(sizes)
    active = sum(1 for n in sizes if n)
    flops = 2 * rows * d * f
    nbytes = (active * d * f + rows * d + E * C * f) * itemsize + 4 * E
    return flops, nbytes


def matmul_params(sizes: dict) -> dict:
    """Multiply-accumulate weights one token meets: per layer in the
    attention projections and the MLP or the routed experts, and in the
    output head."""
    d, H, KV, dh = sizes["d_model"], sizes["n_heads"], sizes["n_kv_heads"], \
        sizes["d_head"]
    attn = d * (H + 2 * KV) * dh + H * dh * d
    moe = sizes.get("moe")
    if moe:
        ffn = d * moe["n_experts"] + moe["top_k"] * 3 * d * moe["d_expert"]
    else:
        ffn = (3 if sizes["mlp_gated"] else 2) * d * sizes["d_ff"]
    return {"layer": attn + ffn, "head": d * sizes["vocab"]}


def model_flops(sizes: dict, chunks: Sequence[tuple]) -> float:
    """Model FLOPs of the tokens processed: ``chunks`` of (start, n,
    logits), n tokens at positions start ... start + n - 1, ``logits``
    of them through the output head.  2 FLOPs a weight a token, and
    causal attention over each token's context, in every layer."""
    w = matmul_params(sizes)
    L, H, dh = sizes["n_layers"], sizes["n_heads"], sizes["d_head"]
    total = 0.0
    for start, n, logits in chunks:
        total += 2.0 * n * w["layer"] * L
        total += 4.0 * H * dh * causal_pairs(start, n) * L
        total += 2.0 * logits * w["head"]
    return total
