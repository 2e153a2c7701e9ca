"""Paged attention (decode and extend): the CUDA kernel's wrapper, its plain
version, and its launch counters.

Replaces ``repro/kernels/paged_attention.py`` (``paged_attention_pallas``).
``paged_attention`` launches ``csrc/paged_attention.cu`` for CUDA tensors
and runs the plain version for CPU tensors; anything else, or a CUDA call
the kernel does not take, raises.  There is no fallback from the kernel to
the plain version.  Decode (q (B,H,dh)) and extend (q (B,S,H,dh) with
``start``) launch the same kernel and are counted apart.
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
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


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
    fn = _lib()
    out = torch.empty_like(q)
    B, S, H, dh = q.shape
    win = NO_WINDOW if window is None else int(window)
    if out.numel():
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     block_table.data_ptr(), start.data_ptr(),
                     lengths.data_ptr(), out.data_ptr(), B, S, H,
                     k_pages.shape[2], dh, page_size, block_table.shape[1],
                     win, dh ** -0.5, _DTYPES[q.dtype], stream)
        if err != 0:
            raise RuntimeError(f"paged_attention kernel launch failed: "
                               f"cudaError {err}")
        LAUNCHES["paged_attention_decode" if decode
                 else "paged_attention_extend"] += 1
    return out[:, 0] if decode else out
