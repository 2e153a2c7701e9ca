"""Profiler spans inside the serving iteration, and counts of the waits on
the device that it makes.

``span(name)`` is a profiler range named ``repro_torch.<name>`` while a
profiler collects, and one shared no-op context otherwise: no flag turns
the spans on, any ``torch.profiler`` around a serve records them, and
without one a span costs one check.  A range is stamped on the clock of
the profiler's device activities, so an idle stretch of the card can be
put down to the span the host was in.  The range is an operator's range
(``_RecordFunctionFast``), not a ``record_function`` annotation: the
profiler copies each annotation that encloses a launch onto the device's
timeline, where a span would read as device work, and an operator's range
costs a fraction of an annotation's.

The spans (serving modes only; a training step records none):

================================  ==========================================
``backend.decode_step``           ``TorchBackend``'s decode of an iteration
``backend.prefill_chunk``         one prefill or extend chunk
``backend.sync``                  the iteration's closing synchronize
``stage``                         the inputs' staging: pages, pads, copies
``sample``                        the sampler and its read-back
``write_slot``                    a chunk's cache adopted into its slot
``bookkeep``                      lengths re-pushed, loops over the work
``model.{decode,prefill,extend,   each model entry point
verify}``
``embed``, ``head``               the embedding; the final norm and head
``attn.proj``                     the pre-attention norm and QKV product
``attn.rope``                     rotary embedding of q and k
``attn.kv_write``                 page-index math and the K/V writes
``attn.kernel``                   the attention kernel's call
``attn.gate``                     the output gate's product and multiply
``attn.out``                      the output projection
``mlp`` / ``moe``                 the norm, the MLP (or MoE) and residuals
``moe.route``                     the router's product and top-k
``moe.dispatch``                  the entries' sort and the expert buffer
``moe.experts``                   the grouped matmul's products
``moe.shared``                    the shared expert
``moe.combine``                   the weighted sum of each token's rows
``wait.{h2d,d2h,sync}``           a blocking wait, as counted below
================================  ==========================================

``Waits`` counts the iteration's blocking waits by kind: ``h2d`` a
pageable host-to-device copy (``ServingEngine.tensor``, the block table's
push), ``d2h`` a read of a device value (``ServingEngine.to_host``),
``sync`` a synchronize.  On a card each empties the launch queue; the
counts are of the sites, so the CPU counts the same.  One integer add a
site, never one a layer.

A model without MoE layers makes no ``moe.*`` span.
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."

#: the one context every span returns while no profiler collects
NOOP = contextlib.nullcontext()

_collecting = torch.autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A profiler range ``repro_torch.<name>`` while a profiler collects,
    else ``NOOP``."""
    if _collecting():
        return _range(PREFIX + name)
    return NOOP


def mode_span(mode: str, name: str):
    """``span(name)`` in the serving modes; a training step records
    none."""
    return NOOP if mode == "train" else span(name)


class Waits:
    """Blocking host-device waits by kind, since the last ``reset``."""

    __slots__ = ("h2d", "d2h", "sync")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.h2d = self.d2h = self.sync = 0

    def as_dict(self) -> dict:
        return {"h2d": self.h2d, "d2h": self.d2h, "sync": self.sync}
