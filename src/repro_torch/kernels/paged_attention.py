"""Paged attention (decode and extend): the CUDA kernels' wrapper, its plain
version, and its launch counters.

Replaces ``repro/kernels/paged_attention.py`` (``paged_attention_pallas``).
``paged_attention`` launches ``csrc/paged_attention.cu`` for CUDA tensors
and runs the plain version for CPU tensors; anything else, or a CUDA call
the chosen kernel does not take, raises.  There is no fallback from one
kernel to another or to the plain version.  The mode and dtype pick the
kernel: decode (q (B,H,dh)) the split-KV kernel in both dtypes, extend
(q (B,S,H,dh) with ``start``) the tensor-core kernel in bf16 and the FMA
kernel in f32.  Decode and extend are counted apart.  On meta tensors (the
dry run) the wrapper returns the kernel's output shape and allocates the
decode workspace as the CUDA path does, launching nothing.

``paged_decode_work`` and ``paged_extend_work`` are the two kernels' one
work count each (an active ``repro_torch.roofline.counter.Counter`` is
charged with them at every call, and ``chip_smoke.py``'s bounds use them).
"""
from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import NO_WINDOW, paged_attention_ref
from repro_torch.roofline import counter as _roof

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


@functools.lru_cache(maxsize=None)
def decode_pages_per_split() -> int:
    """Pages a decode split takes: the default of the source's
    ``REPRO_PAGED_PAGES_PER_SPLIT``, read from the file (the meta branch
    sizes the workspace without the library)."""
    src = (Path(__file__).parent / "csrc" / "paged_attention.cu").read_text()
    return int(re.search(r"#define REPRO_PAGED_PAGES_PER_SPLIT (\d+)",
                         src).group(1))


@functools.lru_cache(maxsize=4096)
def _row_work(start: int, S: int, length: int, window: int):
    """(keys read, visible (query, key) pairs) of one sequence whose S
    queries sit at start..start+S-1."""
    p = start + np.arange(S, dtype=np.int64)
    pairs = np.maximum(np.minimum(p, length - 1)
                       - np.maximum(0, p - window + 1) + 1, 0).sum()
    return max(0, length - max(0, start - window + 1)), int(pairs)


def paged_work(starts, S: int, lengths, window):
    """(keys read, visible pairs) summed over the batch; ``starts`` and
    ``lengths``: lists of ints (decode: start = length - 1, S = 1)."""
    win = NO_WINDOW if window is None else int(window)
    rows = pairs = 0
    for s0, n in zip(starts, lengths):
        r, p = _row_work(int(s0), S, int(n), win)
        rows, pairs = rows + r, pairs + p
    return rows, pairs


def paged_decode_work(B, H, KV, dh, itemsize, table_numel, kv_rows):
    """(FLOPs, bytes) of one decode call: QK^T and PV over ``kv_rows`` keys
    (one query each), 2 * dh FLOPs a head each; those keys' K and V, q,
    the block table and the lengths read, out written once."""
    flops = 4 * kv_rows * H * dh
    nbytes = kv_rows * KV * dh * itemsize * 2 + 2 * B * H * dh * itemsize \
        + table_numel * 4 + B * 4
    return flops, nbytes


def paged_extend_work(B, S, H, KV, dh, itemsize, table_numel, kv_rows,
                      pairs):
    """(FLOPs, bytes) of one extend (or verify) call: QK^T and PV over
    ``pairs`` visible pairs; ``kv_rows`` keys' K and V, q, the block
    table, start and lengths read, out written once."""
    flops = 4 * pairs * H * dh
    nbytes = kv_rows * KV * dh * itemsize * 2 \
        + 2 * B * S * H * dh * itemsize + table_numel * 4 + 2 * B * 4
    return flops, nbytes


def _charge(q, k_pages, block_table, lengths, page_size, start, window):
    """(FLOPs, bytes, launches) of a call, from the data where it can be
    read (the CPU, the card: a host sync, only under a counter), else
    (meta) with every table full: the queries end at its last row."""
    decode = q.dim() == 3
    B, H, dh = q.shape[0], q.shape[-2], q.shape[-1]
    S = 1 if decode else q.shape[1]
    KV = k_pages.shape[2]
    full = block_table.shape[1] * page_size
    if lengths.device.type == "meta":
        lens = [full] * B
        starts = [full - S] * B
    else:
        lens = lengths.tolist()
        starts = [n - 1 for n in lens] if decode else start.tolist()
    rows, pairs = paged_work(starts, S, lens, window)
    if decode:
        work = paged_decode_work(B, H, KV, dh, q.element_size(),
                                 block_table.numel(), rows)
    else:
        work = paged_extend_work(B, S, H, KV, dh, q.element_size(),
                                 block_table.numel(), rows, pairs)
    return work + (1 if q.numel() else 0,)


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
    if _roof.STACK:
        name = "paged_attention_decode" if q.dim() == 3 \
            else "paged_attention_extend"
        with _roof.kernel_call(name, *_charge(q, k_pages, block_table,
                                              lengths, page_size, start,
                                              window)):
            return _paged_attention(q, k_pages, v_pages, block_table,
                                    lengths, page_size, start, window)
    return _paged_attention(q, k_pages, v_pages, block_table, lengths,
                            page_size, start, window)


def _paged_attention(q, k_pages, v_pages, block_table, lengths, page_size,
                     start, window):
    if q.device.type == "cpu":      # contiguous, as the kernel writes it
        return paged_attention_plain(q, k_pages, v_pages, block_table,
                                     lengths, page_size=page_size,
                                     start=start, window=window).contiguous()
    if q.device.type not in ("cuda", "meta"):
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
    meta = q.device.type == "meta"
    fn, splits = (None, None) if meta else _lib()
    out = torch.empty_like(q)
    win = NO_WINDOW if window is None else int(window)
    if out.numel():
        ws = tickets = None
        if decode:
            if meta:
                n_split = -(-maxp // decode_pages_per_split())
            else:
                n_split = _SPLITS.get(maxp)
                if n_split is None:
                    n_split = _SPLITS[maxp] = splits(maxp)
            tickets, ws = _decode_scratch(
                q.device, B * KV, B * KV * n_split * (H // KV) * (dh + 2))
        if meta:
            return out[:, 0] if decode else out
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
