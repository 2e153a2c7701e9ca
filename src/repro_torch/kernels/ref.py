"""Plain PyTorch versions of the kernels (the allclose ground truth), the
same functions as ``repro/kernels/ref.py``.  The kernel
wrappers run these for CPU tensors, and the tests and ``chip_smoke.py``
hold the CUDA kernels against them."""
from __future__ import annotations

import torch

NO_WINDOW = 1 << 30


def _flash_mask(S, device, *, causal=True, lengths=None, window=None, B=1):
    """(B, S, S) visibility of (query, key), the JAX package's masks."""
    pos = torch.arange(S, device=device)
    q_pos, kv_pos = pos[:, None], pos[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (q_pos >= kv_pos)
    if window is not None:
        mask = mask & (q_pos - kv_pos < window)
    mask = mask[None].expand(B, S, S)
    if lengths is not None:
        mask = mask & (kv_pos[None] < lengths.to(device)[:, None, None])
    return mask


def _flash_scores(q, k, *, causal=True, lengths=None, window=None):
    """Scaled scores (B, KV, G, S, S) in f32 under the -1e30 sentinel."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    qr = q.reshape(B, S, KV, H // KV, dh).float() * dh ** -0.5
    s = torch.einsum("bqkgd,bjkd->bkgqj", qr, k.float())
    mask = _flash_mask(S, q.device, causal=causal, lengths=lengths,
                       window=window, B=B)
    return torch.where(mask[:, None, None], s, torch.full_like(s, -1e30))


def flash_attention_ref(q, k, v, *, causal: bool = True, lengths=None,
                        window=None):
    """q: (B,S,H,dh); k/v: (B,S,KV,dh) -> (B,S,H,dh)."""
    B, S, H, dh = q.shape
    s = _flash_scores(q, k, causal=causal, lengths=lengths, window=window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqj,bjkd->bqkgd", p, v.float())
    return o.reshape(B, S, H, dh).to(q.dtype)


def flash_attention_fwd_ref(q, k, v, *, lengths=None, window=None):
    """Causal flash forward with its log-sum-exp: ``(out, lse)``, ``out``
    as ``flash_attention_ref`` and ``lse`` (B, H, S) f32 in natural-log
    units of the scaled scores, ``m + log(max(l, 1e-20))`` as
    ``repro/models/flash.py``'s ``_fwd_scan`` gives it (its (B, KV, G, S),
    head h = kv-head * G + g)."""
    B, S, H, dh = q.shape
    s = _flash_scores(q, k, lengths=lengths, window=window)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = torch.clamp(e.sum(dim=-1), min=1e-20)
    o = torch.einsum("bkgqj,bjkd->bqkgd", e / l[..., None], v.float())
    lse = (m + torch.log(l)).reshape(B, H, S)
    return o.reshape(B, S, H, dh).to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, out, lse, dout, lengths=None,
                            window=None):
    """The FlashAttention-2 backward of ``repro/models/flash.py``'s
    ``_flash_bwd``, step by step: ``(dq, dk, dv)`` in the inputs' dtypes
    from the forward's ``out`` and ``lse`` (B, H, S).  Sums in f32; P is
    rounded to dout's dtype for dV, dS to q's dtype for dQ and dK, and
    ``q * scale`` to q's dtype, where the JAX function rounds them."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    qr = (q * scale).reshape(B, S, KV, G, dh)
    do = dout.reshape(B, S, KV, G, dh)
    ob = out.reshape(B, S, KV, G, dh)
    delta = torch.einsum("bskgd,bskgd->bkgs", do.float(), ob.float())
    s = torch.einsum("bqkgd,bjkd->bkgqj", qr.float(), k.float())
    mask = _flash_mask(S, q.device, lengths=lengths, window=window, B=B)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, -1e30))
    p = torch.exp(s - lse.reshape(B, KV, G, S)[..., None])
    dv = torch.einsum("bkgqj,bqkgd->bjkd", p.to(do.dtype).float(),
                      do.float())
    dp = torch.einsum("bqkgd,bjkd->bkgqj", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.einsum("bkgqj,bjkd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqj,bqkgd->bjkd", ds, qr.float())
    return (dq.reshape(B, S, H, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def paged_attention_ref(q, k_pages, v_pages, block_table, lengths, *,
                        page_size: int, start=None, window=None):
    """q: (B,H,dh) decode or (B,S,H,dh) extend (with ``start``);
    k/v_pages: (P,ps,KV,dh); block_table: (B,maxp) int32; lengths: (B,)."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    B, S, H, dh = q.shape
    P, ps, KV, _ = k_pages.shape
    G = H // KV
    maxp = block_table.shape[1]
    lengths = lengths.to(q.device).long()
    if start is None:
        start = torch.clamp(lengths - 1, min=0)
    start = start.to(q.device).long()
    flat = block_table.reshape(-1).long()
    kg = k_pages[flat].reshape(B, maxp * ps, KV, dh)
    vg = v_pages[flat].reshape(B, maxp * ps, KV, dh)
    qr = q.reshape(B, S, KV, G, dh).float() * dh ** -0.5
    s = torch.einsum("bskgd,bjkd->bskgj", qr, kg.float())
    q_pos = start[:, None] + torch.arange(S, device=q.device)[None, :]
    kv_pos = torch.arange(maxp * ps, device=q.device)
    win = NO_WINDOW if window is None else window
    mask = (kv_pos[None, None] <= q_pos[..., None]) \
        & (kv_pos[None, None] < lengths[:, None, None]) \
        & (q_pos[..., None] - kv_pos[None, None] < win)      # (B, S, J)
    s = torch.where(mask[:, :, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bskgj,bjkd->bskgd", p, vg.float())
    o = o.reshape(B, S, H, dh).to(q.dtype)
    return o[:, 0] if squeeze else o


def paged_decode_lse_ref(q, k_pages, v_pages, block_table, lengths, *,
                         page_size: int, start=None, window=None):
    """Decode with its log-sum-exp: ``(out, lse)`` for q (B,H,dh) at
    ``start`` (B,) (default ``lengths - 1``), ``lse`` (B, H) f32 in
    natural-log units of the scaled scores over the visible keys.  A row
    with no visible key gives ``out`` 0 and ``lse`` -inf, as the kernel
    writes them, so a combine over key ranges weights it 0; every other
    row's ``out`` is ``paged_attention_ref``'s."""
    B, H, dh = q.shape
    P, ps, KV, _ = k_pages.shape
    G = H // KV
    maxp = block_table.shape[1]
    lengths = lengths.to(q.device).long()
    if start is None:
        start = torch.clamp(lengths - 1, min=0)
    start = start.to(q.device).long()
    flat = block_table.reshape(-1).long()
    kg = k_pages[flat].reshape(B, maxp * ps, KV, dh)
    vg = v_pages[flat].reshape(B, maxp * ps, KV, dh)
    qr = q.reshape(B, KV, G, dh).float() * dh ** -0.5
    s = torch.einsum("bkgd,bjkd->bkgj", qr, kg.float())
    kv_pos = torch.arange(maxp * ps, device=q.device)[None]
    win = NO_WINDOW if window is None else window
    mask = (kv_pos <= start[:, None]) & (kv_pos < lengths[:, None]) \
        & (start[:, None] - kv_pos < win)                     # (B, J)
    mask = mask[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)
    e = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = e.sum(dim=-1)
    o = torch.einsum("bkgj,bjkd->bkgd", e / torch.clamp(l, min=1e-20)[
        ..., None], vg.float())
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-20)),
                      torch.full_like(m, float("-inf")))
    return o.reshape(B, H, dh).to(q.dtype), lse.reshape(B, H)


def moe_gmm_ref(x, w, group_sizes):
    """Grouped matmul: x: (E,C,d); w: (E,d,f); rows >= group_sizes[e] give 0."""
    E, C, d = x.shape
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    mask = torch.arange(C, device=x.device)[None, :] \
        < group_sizes.to(x.device)[:, None]
    return (out * mask[..., None]).to(x.dtype)


def moe_gmm_bwd_ref(x, w, group_sizes, dy):
    """Backward of ``moe_gmm_ref`` given dy (E,C,f): (dx (E,C,d), dw
    (E,d,f)) in x's dtype, f32 sums.  Rows ``c >= group_sizes[e]`` of x and
    dy take no part, whatever they hold, and those rows of dx are 0."""
    C = x.shape[1]
    live = (torch.arange(C, device=x.device)[None, :]
            < group_sizes.to(x.device)[:, None])[..., None]
    dym = torch.where(live, dy.float(), 0.0)
    xm = torch.where(live, x.float(), 0.0)
    dx = torch.einsum("ecf,edf->ecd", dym, w.float())
    dw = torch.einsum("ecd,ecf->edf", xm, dym)
    return dx.to(x.dtype), dw.to(x.dtype)
