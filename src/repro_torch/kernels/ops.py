"""The port's kernel entry points and its kernel registry.

``flash_attention``, ``flash_attention_bwd``, ``paged_attention``,
``moe_gmm``, ``moe_gmm_bwd`` and ``rope`` are the kernel wrappers: on a
CUDA tensor each launches its hand-written Hopper kernel or raises, on a
CPU tensor each runs its plain PyTorch version.  ``KERNELS`` names every
kernel with its source and what it replaces in the JAX package (a Pallas
TPU kernel, except the two backwards and RoPE: the flash backward's
counterpart is the plain-JAX custom VJP, the grouped matmul's XLA's
autodiff of an einsum, RoPE's the plain-JAX ``rope``), and
``launch_counts`` / ``reset_launch_counts`` read and clear the counters
the wrappers bump at each launch.  The ``*_work`` functions are each
kernel's one work count, (FLOPs, bytes), which the dry run's counter and
``chip_smoke.py``'s bounds share.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import rope as _rope
from repro_torch.kernels.flash_attention import (causal_pairs,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_bwd_work,
                                                 flash_attention_plain,
                                                 flash_attention_work)
from repro_torch.kernels.moe_gmm import (moe_gmm, moe_gmm_bwd,
                                         moe_gmm_bwd_plain,
                                         moe_gmm_bwd_work, moe_gmm_plain,
                                         moe_gmm_work)
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_plain,
                                                 paged_decode_work,
                                                 paged_extend_work,
                                                 paged_work)
from repro_torch.kernels.rope import rope, rope_plain, rope_work

#: name -> (CUDA source in the repo, what it replaces: the TPU kernel, or
#: for the two backwards what the JAX package trains through instead, plain
#: JAX (the flash custom VJP; XLA's autodiff of the MoE einsums), and for
#: RoPE the plain-JAX function; none of these three is a Pallas kernel)
KERNELS = {
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:81"),
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/models/flash.py:91"),
    "paged_attention_decode": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:32"),
    "paged_attention_extend": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:32"),
    "moe_gmm": (
        "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "src/repro/kernels/moe_gmm.py:39"),
    "moe_gmm_bwd": (
        "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "src/repro/models/moe.py:125"),
    "rope": (
        "src/repro_torch/kernels/csrc/rope.cu",
        "src/repro/models/layers.py:63"),
}

_COUNTERS = (_flash.LAUNCHES, _paged.LAUNCHES, _gmm.LAUNCHES, _rope.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0


__all__ = ["KERNELS", "causal_pairs", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_bwd_work", "flash_attention_plain",
           "flash_attention_work", "launch_counts", "moe_gmm", "moe_gmm_bwd",
           "moe_gmm_bwd_plain", "moe_gmm_bwd_work", "moe_gmm_plain",
           "moe_gmm_work", "paged_attention", "paged_attention_plain",
           "paged_decode_work", "paged_extend_work", "paged_work",
           "reset_launch_counts", "rope", "rope_plain", "rope_work"]
