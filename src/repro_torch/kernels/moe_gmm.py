"""Grouped expert matmul and its backward: the CUDA kernels' wrappers, their
plain versions, and their launch counters.

``moe_gmm`` replaces ``repro/kernels/moe_gmm.py`` (``moe_gmm_pallas``);
``moe_gmm_bwd`` replaces XLA's autodiff of the JAX package's einsum branch
(``repro/models/moe.py:125-137``), which is not a Pallas kernel.  Each
launches ``csrc/moe_gmm.cu`` for CUDA tensors and runs its plain version
for CPU tensors; anything else, or a CUDA call the kernel does not take,
raises.  There is no fallback from a kernel to its plain version.  The
dtype picks the kernels: bf16 the tensor-core ones, f32 the FMA ones; they
choose their own tiles (the TPU wrapper's ``bc`` has no counterpart), and
read ``group_sizes`` from device memory, so a call costs no host sync.
Neither wrapper is differentiable: ``repro_torch.models.moe.
grouped_matmul`` puts the pair behind a ``torch.autograd.Function``.  On
meta tensors (the dry run) each returns its outputs' shapes and launches
nothing.

``moe_gmm_work`` and ``moe_gmm_bwd_work`` are the two kernels' one work
count each (an active ``repro_torch.roofline.counter.Counter`` is charged
with them at every call, and ``chip_smoke.py``'s bounds use them).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import moe_gmm_bwd_ref, moe_gmm_ref
from repro_torch.roofline import counter as _roof

#: launches of the CUDA kernels since the last reset (see ``ops``)
LAUNCHES = {"moe_gmm": 0, "moe_gmm_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def moe_gmm_plain(x, w, group_sizes):
    return moe_gmm_ref(x, w, group_sizes)


def moe_gmm_bwd_plain(x, w, group_sizes, dy):
    return moe_gmm_bwd_ref(x, w, group_sizes, dy)


def moe_gmm_work(E, C, d, f, itemsize, rows, active):
    """(FLOPs, bytes) of one forward call over ``rows`` rows inside the
    groups of ``active`` experts with a nonzero group: 2 * d * f FLOPs a
    row; the active experts' weights, the rows inside the groups and the
    group sizes read, every output row written once."""
    flops = 2 * rows * d * f
    nbytes = active * d * f * itemsize + rows * d * itemsize \
        + E * C * f * itemsize + E * 4
    return flops, nbytes


def moe_gmm_bwd_work(E, C, d, f, itemsize, rows, active):
    """(FLOPs, bytes) of one backward call: dx and dw, 2 * d * f FLOPs a
    row each; the active experts' weights and the rows of x and dy inside
    the groups read, dx (E, C, d) and dw (E, d, f) written once."""
    flops = 4 * rows * d * f
    nbytes = active * d * f * itemsize + rows * (d + f) * itemsize \
        + (E * C * d + E * d * f) * itemsize + E * 4
    return flops, nbytes


def _charge(x, w, group_sizes, bwd=False):
    """(FLOPs, bytes, launches), from the group sizes where they can be
    read (the CPU, the card: a host sync, only under a counter), else
    (meta) with every group full."""
    E, C, d = x.shape
    f = w.shape[2]
    if group_sizes.device.type == "meta":
        rows, active = E * C, E
    else:
        gs = [min(max(int(n), 0), C) for n in group_sizes.tolist()]
        rows, active = sum(gs), sum(1 for n in gs if n)
    work = (moe_gmm_bwd_work if bwd else moe_gmm_work)(
        E, C, d, f, x.element_size(), rows, active)
    return work + (1 if bwd or E * C * f else 0,)


def _lib(name="moe_gmm_fwd", n_ptrs=4):
    fn = getattr(build.load("moe_gmm"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_ptrs + [i] * 5 + [p]
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
        _check_layout(name, t)
    if E > 65535:
        raise ValueError(f"moe_gmm: {E} experts, the grid takes 65535")


def _check_layout(name, t):
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"moe_gmm: {name} must be contiguous and 16-byte "
                         f"aligned")


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (E,C,d); w: (E,d,f); group_sizes: (E,) int32 -> (E,C,f) in x's
    dtype, summed in f32; rows ``c >= group_sizes[e]`` are 0."""
    if _roof.STACK:
        with _roof.kernel_call("moe_gmm", *_charge(x, w, group_sizes)):
            return _moe_gmm(x, w, group_sizes)
    return _moe_gmm(x, w, group_sizes)


def _moe_gmm(x, w, group_sizes):
    if x.device.type == "cpu":      # contiguous, as the kernel writes it
        return moe_gmm_plain(x, w, group_sizes).contiguous()
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"moe_gmm: no kernel for {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        # the wrapper is not differentiable: its output would carry no
        # grad_fn and the expert weights would silently get no gradient
        raise RuntimeError(
            "moe_gmm: the kernel wrapper takes no part in autograd; train "
            "through repro_torch.models.moe.grouped_matmul, whose backward "
            "is ops.moe_gmm_bwd")
    _check(x, w, group_sizes)
    fn = _lib() if x.device.type == "cuda" else None
    E, C, d = x.shape
    f = w.shape[2]
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    if out.numel() and fn is not None:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                     out.data_ptr(), E, C, d, f, _DTYPES[x.dtype], stream)
        if err != 0:
            raise RuntimeError(f"moe_gmm kernel launch failed: cudaError "
                               f"{err}")
        LAUNCHES["moe_gmm"] += 1
    return out


def moe_gmm_bwd(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                dy: torch.Tensor):
    """The backward of ``moe_gmm`` given dy: (E,C,f): (dx (E,C,d), dw
    (E,d,f)) in x's dtype, summed in f32 in one fixed order (no atomics:
    two launches give the same bits).  dx's rows ``c >= group_sizes[e]``
    are 0, and those rows of x and dy take no part whatever they hold."""
    if _roof.STACK:
        with _roof.kernel_call("moe_gmm_bwd",
                               *_charge(x, w, group_sizes, bwd=True)):
            return _moe_gmm_bwd(x, w, group_sizes, dy)
    return _moe_gmm_bwd(x, w, group_sizes, dy)


def _moe_gmm_bwd(x, w, group_sizes, dy):
    if x.device.type == "cpu":
        return tuple(t.contiguous()
                     for t in moe_gmm_bwd_plain(x, w, group_sizes, dy))
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"moe_gmm_bwd: no kernel for {x.device}")
    _check(x, w, group_sizes)
    E, C, d = x.shape
    f = w.shape[2]
    if dy.shape != (E, C, f) or dy.dtype != x.dtype \
            or dy.device != x.device:
        raise ValueError(f"moe_gmm_bwd: dy must be ({E}, {C}, {f}) "
                         f"{x.dtype} on {x.device}; got {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}")
    _check_layout("dy", dy)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    if x.device.type == "meta":
        return dx, dw
    fn = _lib("moe_gmm_bwd", 6)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                 dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), E, C, d, f,
                 _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm_bwd kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES["moe_gmm_bwd"] += 1
    return dx, dw
