"""Paged attention (decode and extend): the CUDA kernels' wrapper, its plain
version, and its launch counters.

Replaces ``repro/kernels/paged_attention.py`` (``paged_attention_pallas``).
``paged_attention`` launches ``csrc/paged_attention.cu`` for CUDA tensors
and runs the plain version for CPU tensors; anything else, or a CUDA call
the chosen kernel does not take, raises.  There is no fallback from one
kernel to another or to the plain version.  The mode and dtype pick the
kernel: decode (q (B,H,dh)) the split-KV kernel in both dtypes, extend
(q (B,S,H,dh) with ``start``) the tensor-core kernel in bf16 and the FMA
kernel in f32.  Decode and extend are counted apart.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import NO_WINDOW, paged_attention_ref

#: launches of the CUDA kernel since the last reset (see ``ops``)
LAUNCHES = {"paged_attention_decode": 0, "paged_attention_extend": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
#: largest GQA group the decode kernel carries (rows per warp: 8 of 16)
_DECODE_MAX_GROUP = 16
#: the bf16 extend kernel packs a group's heads into 64 rows, and loads a
#: page in pieces of gcd(page_size, 64) rows, a multiple of 8
_EXTEND_MAX_GROUP = 64
_EXTEND_PAGE_MULTIPLE = 8

#: per device: the decode kernel's int32 ticket counters (zeroed once, 0
#: again after every launch) and its f32 split workspace, each grown when a
#: call needs more; launches on one stream reuse them in turn
_SCRATCH = {}
#: maxp -> splits of the decode grid (a constant of the kernel's source)
_SPLITS = {}


def paged_attention_plain(q, k_pages, v_pages, block_table, lengths, *,
                          page_size, start=None, window=None):
    return paged_attention_ref(q, k_pages, v_pages, block_table, lengths,
                               page_size=page_size, start=start,
                               window=window)


def _lib():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        lib.paged_decode_splits.argtypes = [i]
        lib.paged_decode_splits.restype = i
    return fn, lib.paged_decode_splits


def _decode_scratch(device, n_tickets, n_ws):
    tickets, ws = _SCRATCH.get(device, (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=device)
    _SCRATCH[device] = (tickets, ws)
    return tickets, ws


def _check(q, k_pages, v_pages, block_table, start, lengths, page_size):
    B, S, H, dh = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention: k/v pages (P,ps,KV,dh); got "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    P, ps, KV, dh_kv = k_pages.shape
    if ps != page_size or dh_kv != dh or H % KV:
        raise ValueError(f"paged_attention: pages {tuple(k_pages.shape)} "
                         f"do not match q {tuple(q.shape)} / page_size "
                         f"{page_size}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention: f32 or bf16, one dtype; got "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {dh} not in "
                         f"{_HEAD_DIMS}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError("paged_attention: block_table must be (B, maxp)")
    for name, t in (("block_table", block_table), ("start", start),
                    ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_attention: {name} must be int32")
    if start.shape != (B,) or lengths.shape != (B,):
        raise ValueError("paged_attention: start/lengths must be (B,)")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("start", start),
                    ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must be contiguous "
                             f"and 16-byte aligned")


def _check_kernel(decode, dtype, G, page_size):
    """Refuse what the kernel chosen by mode and dtype does not take."""
    if decode and G > _DECODE_MAX_GROUP:
        raise ValueError(f"paged_attention: decode takes at most "
                         f"{_DECODE_MAX_GROUP} query heads per kv-head; "
                         f"got {G}")
    if not decode and dtype == torch.bfloat16 and (
            G > _EXTEND_MAX_GROUP or page_size % _EXTEND_PAGE_MULTIPLE):
        raise ValueError(f"paged_attention: the bf16 extend kernel takes a "
                         f"page size that is a multiple of "
                         f"{_EXTEND_PAGE_MULTIPLE} and at most "
                         f"{_EXTEND_MAX_GROUP} query heads per kv-head; got "
                         f"page_size {page_size}, {G}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor, *, page_size: int,
                    start: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Decode: q (B,H,dh), one query per sequence at position length-1.
    Extend: q (B,S,H,dh) with ``start`` (B,), queries at start..start+S-1.
    k_pages/v_pages: (P,ps,KV,dh); block_table: (B,maxp) int32; ``window``
    masks q_pos - kv_pos >= window."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_table,
                                     lengths, page_size=page_size,
                                     start=start, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    decode = q.dim() == 3
    if decode:
        q = q[:, None]
        if start is None:
            start = torch.clamp(lengths - 1, min=0).to(torch.int32)
    elif start is None:
        raise ValueError("paged_attention: multi-query (extend) calls must "
                         "pass start= (the first query position)")
    if q.dim() != 4:
        raise ValueError(f"paged_attention: q (B,H,dh) or (B,S,H,dh); got "
                         f"{tuple(q.shape)}")
    q = q.contiguous()
    _check(q, k_pages, v_pages, block_table, start, lengths, page_size)
    B, S, H, dh = q.shape
    P, KV, maxp = k_pages.shape[0], k_pages.shape[2], block_table.shape[1]
    _check_kernel(decode, q.dtype, H // KV, page_size)
    fn, splits = _lib()
    out = torch.empty_like(q)
    win = NO_WINDOW if window is None else int(window)
    if out.numel():
        ws = tickets = None
        if decode:
            n_split = _SPLITS.get(maxp)
            if n_split is None:
                n_split = _SPLITS[maxp] = splits(maxp)
            tickets, ws = _decode_scratch(
                q.device, B * KV, B * KV * n_split * (H // KV) * (dh + 2))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     block_table.data_ptr(), start.data_ptr(),
                     lengths.data_ptr(), out.data_ptr(),
                     None if ws is None else ws.data_ptr(),
                     None if tickets is None else tickets.data_ptr(),
                     B, S, H, KV, dh, page_size, P, maxp, win, dh ** -0.5,
                     _DTYPES[q.dtype], 0 if decode else 1, stream)
        if err != 0:
            raise RuntimeError(f"paged_attention kernel launch failed: "
                               f"cudaError {err}")
        LAUNCHES["paged_attention_decode" if decode
                 else "paged_attention_extend"] += 1
    return out[:, 0] if decode else out
