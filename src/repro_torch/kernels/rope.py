"""RoPE of one attention layer's q and k: the CUDA kernel's wrapper, its
plain version, and its launch counter.

Replaces no TPU kernel: the JAX package's ``rope``
(``repro/models/layers.py:63``) is plain JAX, which XLA fuses; eager
PyTorch issued ``repro_torch.models.layers.rope`` twice a layer, some 16
small ops each.  ``rope`` launches ``csrc/rope.cu`` once for q and k on
CUDA tensors and runs ``layers.rope`` on each for CPU and meta tensors, so
the CPU's numbers and the dry run's counts are the plain version's;
anything else, or a CUDA call the kernel does not take, raises.  The
kernel computes the plain version's bits (see the source): the inverse
frequencies are ``layers.rope_inv_freq``'s, computed once per (half,
theta, device) and kept.  It reads q, k and the positions (int32 or int64,
broadcastable to (B, S)) through their strides and writes both outputs
contiguous in q's dtype.  With no head to rotate (a tensor-parallel rank
past GSPMD's padded heads) or no token it returns empty outputs and
launches nothing.  The serving modes call it (``models/transformer.py``);
training keeps ``layers.rope``, which autograd differentiates.

``rope_work`` is the kernel's work count (an active
``repro_torch.roofline.counter.Counter`` is charged with it at every card
call, and ``chip_smoke.py``'s bound uses it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.roofline import counter as _roof

#: launches of the CUDA kernel since the last reset (see ``ops``)
LAUNCHES = {"rope": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POSITIONS = {torch.int32: 0, torch.int64: 1}
_MAX_HEAD_DIM = 256
#: (half, theta, device) -> the inverse frequencies on that device
_INV_FREQ = {}


def rope_plain(q, k, positions, theta=10_000.0):
    # imported here: ``repro_torch.models`` imports ``ops`` at its top
    from repro_torch.models.layers import rope as _rope
    return _rope(q, positions, theta), _rope(k, positions, theta)


def rope_work(B, S, H, KV, dh, itemsize, pos_itemsize):
    """(FLOPs, bytes) of one call: 4 multiplies and 2 adds a rotated pair
    of every q and k head of every token; q and k read and written once,
    a position a token and the dh / 2 f32 frequencies read."""
    elems = B * S * (H + KV) * dh
    return 3 * elems, 2 * elems * itemsize + B * S * pos_itemsize \
        + dh // 2 * 4


def _lib():
    fn = build.load("rope").rope_qk
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 6 + [i] * 5 + [ll] * 10 + [i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _inv_freq(half, theta, device):
    key = (half, float(theta), device)
    freqs = _INV_FREQ.get(key)
    if freqs is None:
        from repro_torch.models.layers import rope_inv_freq
        freqs = _INV_FREQ[key] = rope_inv_freq(half, theta, device)
    return freqs


def _check(q, k, positions):
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"rope: q (B,S,H,dh) and k (B,S,KV,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    dh = q.shape[3]
    if dh % 2 or not 0 < dh <= _MAX_HEAD_DIM:
        raise ValueError(f"rope: an even head dim of at most "
                         f"{_MAX_HEAD_DIM}; got {dh}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        raise TypeError(f"rope: f32 or bf16, one dtype; got {q.dtype}, "
                        f"{k.dtype}")
    if positions.dtype not in _POSITIONS:
        raise TypeError(f"rope: int32 or int64 positions; got "
                        f"{positions.dtype}")
    for name, t in (("k", k), ("positions", positions)):
        if t.device != q.device:
            raise ValueError(f"rope: {name} on {t.device}, q on "
                             f"{q.device}")


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0):
    """q (B,S,H,dh) and k (B,S,KV,dh) rotated by ``positions``
    (broadcastable to (B, S)): ``(q_out, k_out)``, contiguous."""
    if q.device.type in ("cpu", "meta"):
        return rope_plain(q, k, positions, theta)
    if q.device.type != "cuda":
        raise ValueError(f"rope: no kernel for {q.device}")
    _check(q, k, positions)
    B, S, H, dh = q.shape
    KV = k.shape[2]
    pos = positions.expand(B, S)
    q_out = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    k_out = torch.empty((B, S, KV, dh), dtype=q.dtype, device=q.device)
    if not B * S * (H + KV):
        return q_out, k_out
    if _roof.STACK:
        work = rope_work(B, S, H, KV, dh, q.element_size(),
                         pos.element_size())
        with _roof.kernel_call("rope", *work, 1):
            _launch(q, k, pos, theta, q_out, k_out)
    else:
        _launch(q, k, pos, theta, q_out, k_out)
    LAUNCHES["rope"] += 1
    return q_out, k_out


def _launch(q, k, pos, theta, q_out, k_out):
    B, S, H, dh = q.shape
    fn = _lib()
    freqs = _inv_freq(dh // 2, theta, q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), pos.data_ptr(),
                 freqs.data_ptr(), q_out.data_ptr(), k_out.data_ptr(), B, S,
                 H, k.shape[2], dh, *q.stride(), *k.stride(), *pos.stride(),
                 _DTYPES[q.dtype], _POSITIONS[pos.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rope kernel launch failed: cudaError {err}")
