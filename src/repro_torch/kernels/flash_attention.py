"""Causal GQA flash attention, forward and backward: the CUDA kernels'
wrappers, their plain versions, and their launch counters.

``flash_attention`` replaces ``repro/kernels/flash_attention.py``
(``flash_attention_pallas``): it launches ``csrc/flash_attention.cu`` for
CUDA tensors (the dtype picks the kernel: bf16 the tensor-core one, f32
the FMA one) and runs the plain version for CPU tensors.  With
``return_lse`` it also gives the rows' log-sum-exp, which training saves.
``flash_attention_bwd`` is the counterpart of ``repro/models/flash.py``'s
``_flash_bwd`` (the JAX package's custom VJP, plain JAX, not a Pallas
kernel): it launches ``csrc/flash_attention_bwd.cu`` for CUDA tensors and
runs the plain version for CPU tensors (its outputs made contiguous, as
the kernels write them).  On meta tensors (the dry run,
``repro_torch.launch.dryrun``) each returns outputs of the kernel's shapes
and allocates the scratch the CUDA path allocates, launching nothing.
With no query head (H = 0: a tensor-parallel rank past GSPMD's padded
heads) each returns empty outputs on any device and launches nothing.
Anything else, or a CUDA or meta call a kernel does not take, raises.
There is no fallback from a kernel to its plain version.

``flash_attention_work`` and ``flash_attention_bwd_work`` are each
kernel's one work count (FLOPs over the visible (query, key) pairs, and
the bytes of every input read once and every output written once): an
active ``repro_torch.roofline.counter.Counter`` is charged with them at
every call, and ``chip_smoke.py``'s bounds use them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.roofline import counter as _roof
from repro_torch.kernels.ref import (NO_WINDOW, flash_attention_bwd_ref,
                                     flash_attention_fwd_ref,
                                     flash_attention_ref)

#: launches of the CUDA kernels since the last reset (see ``ops``); the
#: backward's three launches (delta, dK/dV, dQ) count as one call
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_plain(q, k, v, lengths=None, window=None,
                          return_lse=False):
    if return_lse:
        return flash_attention_fwd_ref(q, k, v, lengths=lengths,
                                       window=window)
    return flash_attention_ref(q, k, v, lengths=lengths, window=window)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, lengths=None,
                              window=None):
    return flash_attention_bwd_ref(q, k, v, out, lse, dout, lengths, window)


@functools.lru_cache(maxsize=4096)
def row_pairs(S: int, length: int, window: int) -> int:
    """Visible (query, key) pairs of one causal sequence of ``S`` queries:
    query i sees keys j <= i, j < ``length`` and i - j < ``window``."""
    i = np.arange(S, dtype=np.int64)
    hi = np.minimum(i, length - 1)
    lo = np.maximum(0, i - window + 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def causal_pairs(S: int, lengths, window) -> int:
    """``row_pairs`` summed over the batch; ``lengths``: a list of ints."""
    win = NO_WINDOW if window is None else int(window)
    return sum(row_pairs(S, int(n), win) for n in lengths)


def flash_attention_work(B, S, H, KV, dh, itemsize, pairs, lse=False):
    """(FLOPs, bytes) of one forward call: QK^T and PV over ``pairs``
    visible pairs, 2 * dh FLOPs each; q, k, v and the lengths read, out
    (and the lse, f32) written once."""
    flops = 4 * pairs * H * dh
    nbytes = 2 * B * S * H * dh * itemsize + 2 * B * S * KV * dh * itemsize \
        + 4 * B + (4 * B * H * S if lse else 0)
    return flops, nbytes


def flash_attention_bwd_work(B, S, H, KV, dh, itemsize, pairs):
    """(FLOPs, bytes) of one backward call: the FlashAttention-2
    backward's five products per visible pair (S recomputed, dP, dV, dK,
    dQ), 2 * dh FLOPs each; q, k, v, out, dout and the lse read, dq, dk,
    dv written once."""
    flops = 10 * dh * H * pairs
    nbytes = (4 * B * S * H + 4 * B * S * KV) * dh * itemsize + B * H * S * 4
    return flops, nbytes


def _known_lengths(q, lengths):
    """Each row's length: from ``lengths`` where its values can be read
    (the CPU, the card: a host sync, only under a counter), else (meta)
    the full sequence."""
    B, S = q.shape[:2]
    if lengths is None or lengths.device.type == "meta":
        return [S] * B
    return lengths.tolist()


def _charge(q, k, lengths, window, bwd=False, lse=False):
    B, S, H, dh = q.shape
    pairs = causal_pairs(S, _known_lengths(q, lengths), window)
    args = (B, S, H, k.shape[2], dh, q.element_size(), pairs)
    work = flash_attention_bwd_work(*args) if bwd \
        else flash_attention_work(*args, lse=lse)
    return work + (1 if q.numel() else 0,)


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i,
                       p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 6 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, lengths, *more):
    """The kernels' contract; ``more``: (name, tensor) pairs that must be
    shaped as q (out, dout), or (name, tensor, shape, dtype) pairs."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B,S,H,dh), k/v (B,S,KV,dh); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, dh = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != dh \
            or H % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: f32 or bf16, one dtype; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in "
                         f"{_HEAD_DIMS}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("flash_attention: lengths must be (B,) int32")
    for name, t, *spec in more:
        shape, dtype = spec if spec else (q.shape, q.dtype)
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"flash_attention: {name} must be "
                             f"{tuple(shape)} {dtype}; got "
                             f"{tuple(t.shape)} {t.dtype}")
    named = (("q", q), ("k", k), ("v", v), ("lengths", lengths)) + tuple(
        (m[0], m[1]) for m in more)
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"and 16-byte aligned")


def _full_lengths(q, lengths):
    if lengths is None:
        B, S = q.shape[:2]
        return torch.full((B,), S, dtype=torch.int32, device=q.device)
    return lengths


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    window: Optional[int] = None, return_lse: bool = False):
    """q: (B,S,H,dh); k/v: (B,S,KV,dh) -> (B,S,H,dh), causal.

    ``lengths`` (B,) masks KV positions >= length per sequence (rows past
    a length are unspecified); ``window`` masks q_pos - kv_pos >= window.
    ``return_lse``: return ``(out, lse)``, lse (B,H,S) f32 in natural-log
    units of the scaled scores (a row with no visible key: a large
    negative number, which differs between the kernels and the plain
    version).
    """
    if _roof.STACK:
        with _roof.kernel_call("flash_attention", *_charge(
                q, k, lengths, window, lse=return_lse)):
            return _flash_attention(q, k, v, lengths, window, return_lse)
    return _flash_attention(q, k, v, lengths, window, return_lse)


def _contiguous(out):
    """The CPU branch's outputs in the kernels' layout (contiguous), so
    that what follows a call runs the same ops on every device."""
    if isinstance(out, tuple):
        return tuple(t.contiguous() for t in out)
    return out.contiguous()


def _flash_attention(q, k, v, lengths, window, return_lse):
    if q.dim() == 4 and q.shape[2] == 0:
        # no query head (a tensor-parallel rank past the padded heads):
        # empty outputs on every device, nothing launched
        B, S = q.shape[:2]
        out = torch.empty_like(q)
        return (out, torch.empty((B, 0, S), dtype=torch.float32,
                                 device=q.device)) if return_lse else out
    if q.device.type == "cpu":
        return _contiguous(flash_attention_plain(q, k, v, lengths, window,
                                                 return_lse))
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    lengths = _full_lengths(q, lengths)
    _check(q, k, v, lengths)
    fn = _lib() if q.device.type == "cuda" else None
    B, S, H, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() and fn is not None:
        win = NO_WINDOW if window is None else int(window)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     lengths.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(), B, S, H,
                     k.shape[2], dh, win, dh ** -0.5, _DTYPES[q.dtype],
                     stream)
        if err != 0:
            raise RuntimeError(f"flash_attention kernel launch failed: "
                               f"cudaError {err}")
        LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None,
                        window: Optional[int] = None):
    """The gradients of ``flash_attention`` (``repro/models/flash.py``'s
    ``_flash_bwd``): ``(dq, dk, dv)`` shaped and typed as q, k, v, from the
    forward's ``out`` and ``lse`` (B,H,S) f32 and the output's cotangent
    ``dout``, under the forward's ``lengths`` and ``window``."""
    if _roof.STACK:
        with _roof.kernel_call("flash_attention_bwd", *_charge(
                q, k, lengths, window, bwd=True)):
            return _flash_attention_bwd(q, k, v, out, lse, dout, lengths,
                                        window)
    return _flash_attention_bwd(q, k, v, out, lse, dout, lengths, window)


def _flash_attention_bwd(q, k, v, out, lse, dout, lengths, window):
    if q.dim() == 4 and q.shape[2] == 0:      # no query head: nothing
        return tuple(torch.empty_like(t) for t in (q, k, v))
    if q.device.type == "cpu":
        return _contiguous(flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                     lengths, window))
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    lengths = _full_lengths(q, lengths)
    B, S, H, dh = q.shape
    _check(q, k, v, lengths, ("out", out), ("dout", dout),
           ("lse", lse, (B, H, S), torch.float32))
    fn = _bwd_lib() if q.device.type == "cuda" else None
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel():
        delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        if fn is None:                # meta: the scratch, no launch
            return dq, dk, dv
        win = NO_WINDOW if window is None else int(window)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                     lengths.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), delta.data_ptr(), B, S, H, k.shape[2],
                     dh, win, dh ** -0.5, _DTYPES[q.dtype], stream)
        if err != 0:
            raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                               f"cudaError {err}")
        LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
