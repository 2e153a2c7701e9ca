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
runs the plain version for CPU tensors.  Anything else, or a CUDA call a
kernel does not take, raises.  There is no fallback from a kernel to its
plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
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
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lengths, window, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    lengths = _full_lengths(q, lengths)
    _check(q, k, v, lengths)
    fn = _lib()
    B, S, H, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel():
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
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, lengths,
                                         window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    lengths = _full_lengths(q, lengths)
    B, S, H, dh = q.shape
    _check(q, k, v, lengths, ("out", out), ("dout", dout),
           ("lse", lse, (B, H, S), torch.float32))
    fn = _bwd_lib()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel():
        delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
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
