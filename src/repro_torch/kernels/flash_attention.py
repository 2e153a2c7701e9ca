"""Causal GQA prefill attention: the CUDA kernel's wrapper, its plain
version, and its launch counter.

Replaces ``repro/kernels/flash_attention.py`` (``flash_attention_pallas``).
``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors
(the dtype picks the kernel: bf16 the tensor-core one, f32 the FMA one)
and runs the plain version for CPU tensors; anything else, or a CUDA call
the kernel does not take, raises.  There is no fallback from the kernel to
the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import NO_WINDOW, flash_attention_ref

#: launches of the CUDA kernel since the last reset (see ``ops``)
LAUNCHES = {"flash_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_plain(q, k, v, lengths=None, window=None):
    return flash_attention_ref(q, k, v, lengths=lengths, window=window)


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, lengths):
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
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"and 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,dh); k/v: (B,S,KV,dh) -> (B,S,H,dh), causal.

    ``lengths`` (B,) masks KV positions >= length per sequence (rows past
    a length are unspecified); ``window`` masks q_pos - kv_pos >= window.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lengths, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    B, S = q.shape[:2]
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=q.device)
    _check(q, k, v, lengths)
    fn = _lib()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    win = NO_WINDOW if window is None else int(window)
    H, dh = q.shape[2], q.shape[3]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), B, S, H, k.shape[2],
                 dh, win, dh ** -0.5, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    return out
