"""Grouped expert matmul: the CUDA kernel's wrapper, its plain version, and
its launch counter.

Replaces ``repro/kernels/moe_gmm.py`` (``moe_gmm_pallas``).  ``moe_gmm``
launches ``csrc/moe_gmm.cu`` for CUDA tensors and runs the plain version
for CPU tensors; anything else, or a CUDA call the kernel does not take,
raises.  There is no fallback from the kernel to the plain version.  The
dtype picks the kernel: bf16 the tensor-core one, f32 the FMA one; each
chooses its own tiles (the TPU wrapper's ``bc`` has no counterpart), and
both read ``group_sizes`` from device memory, so a call costs no host
sync.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import moe_gmm_ref

#: launches of the CUDA kernel since the last reset (see ``ops``)
LAUNCHES = {"moe_gmm": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def moe_gmm_plain(x, w, group_sizes):
    return moe_gmm_ref(x, w, group_sizes)


def _lib():
    lib = build.load("moe_gmm")
    fn = lib.moe_gmm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, w, group_sizes):
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"moe_gmm: x (E,C,d) and w (E,d,f); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    E, C, d = x.shape
    if w.shape[:2] != (E, d):
        raise ValueError(f"moe_gmm: w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if group_sizes.shape != (E,) or group_sizes.dtype != torch.int32:
        raise ValueError(f"moe_gmm: group_sizes must be ({E},) int32; got "
                         f"{tuple(group_sizes.shape)} {group_sizes.dtype}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"moe_gmm: f32 or bf16, one dtype; got {x.dtype}, "
                        f"{w.dtype}")
    for name, t in (("x", x), ("w", w), ("group_sizes", group_sizes)):
        if t.device != x.device:
            raise ValueError(f"moe_gmm: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"moe_gmm: {name} must be contiguous and "
                             f"16-byte aligned")
    if E > 65535:
        raise ValueError(f"moe_gmm: {E} experts, the grid takes 65535")


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (E,C,d); w: (E,d,f); group_sizes: (E,) int32 -> (E,C,f) in x's
    dtype, summed in f32; rows ``c >= group_sizes[e]`` are 0."""
    if x.device.type == "cpu":
        return moe_gmm_plain(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm: no kernel for {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        # the kernel has no backward: its output would carry no grad_fn
        # and the expert weights would silently get no gradient
        raise NotImplementedError(
            "moe_gmm: training through the grouped expert matmul on the "
            "card needs its backward kernel, not ported yet (ROADMAP.md "
            "queue 1: the grouped-matmul backward kernel for MoE training "
            "on the card); MoE trains on the CPU through the plain version")
    _check(x, w, group_sizes)
    fn = _lib()
    E, C, d = x.shape
    f = w.shape[2]
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    if out.numel():
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                     out.data_ptr(), E, C, d, f, _DTYPES[x.dtype], stream)
        if err != 0:
            raise RuntimeError(f"moe_gmm kernel launch failed: cudaError "
                               f"{err}")
        LAUNCHES["moe_gmm"] += 1
    return out
