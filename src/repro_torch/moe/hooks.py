"""Injectable routing hooks for the port's MoE model.

The counterpart of ``repro/moe/hooks.py``.  Each hook plugs into
``repro_torch.models.moe.moe_ffn`` through ``Model(routing_hook=...)``
(most conveniently through ``ServingEngine(routing=<trace>)``) and
replaces the top-k assignment step of every MoE layer, while dispatch,
capacity, the grouped matmul and combine run unchanged.  Contract::

    hook(logits, *, positions, layer, top_k, valid=None)
        -> (expert_idx (T, k) int, combine_w (T, k) f32, aux scalar)

``logits`` are the router's pre-softmax scores ``(T, E)``; ``positions``
the flattened (T,) token KV positions; ``layer`` the model-wide MoE layer
index (a Python int); ``valid`` (when given) flags the rows that are real
workload tokens.

* :func:`make_replay_hook` — forced assignment: every token routes to
  ``trace.layers[layer][position % period]``.
* :func:`make_bias_hook` — the trace's per-layer expert frequencies added
  to the logits as a log-frequency bias.
* :func:`make_recording_hook` — the learned router, plus a call to
  ``recorder.tap`` with the layer's ``(positions, expert_idx, valid)`` as
  numpy arrays.  Where JAX taps through ``jax.debug.callback`` on every
  call, this hook calls the recorder directly and only while
  ``recorder.enabled``, so warmup pays no device-to-host copies.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.moe import normalize_topk


def _per_device(a: np.ndarray):
    """A getter for ``a`` as a tensor on a given device, copied once."""
    host = torch.from_numpy(a)
    on: Dict[torch.device, torch.Tensor] = {}

    def get(device: torch.device) -> torch.Tensor:
        t = on.get(device)
        if t is None:
            t = on[device] = host.to(device)
        return t
    return get


def make_replay_hook(trace):
    """Force every MoE layer's assignments to the trace's table."""
    trace.validate()
    tables = _per_device(np.stack([np.asarray(t, np.int32)
                                   for t in trace.layers]))  # (L, period, k)
    period = trace.period

    def hook(logits, *, positions, layer, top_k, valid=None):
        # layer is None when moe_ffn is driven directly (single layer)
        idx = tables(logits.device)[0 if layer is None else layer,
                                    positions.long() % period]   # (T, k)
        w = torch.full(idx.shape, 1.0 / top_k, dtype=torch.float32,
                       device=logits.device)
        return idx, w, torch.zeros((), device=logits.device)
    return hook


def make_bias_hook(trace, strength: float = 2.0):
    """Bias the learned router's logits toward the trace's expert
    frequencies (``strength`` scales the log-frequency bias; 0 is a
    no-op).  Softer than forced replay: combine weights stay learned."""
    trace.validate()
    pos = np.arange(trace.period)
    freq = np.stack([trace.counts_for(l, pos) + 1.0
                     for l in range(trace.n_layers)])    # (L, E), laplace
    freq = freq / freq.sum(axis=1, keepdims=True)
    bias = _per_device(np.asarray(
        strength * (np.log(freq) - np.log(freq).mean(axis=1, keepdims=True)),
        np.float32))

    def hook(logits, *, positions, layer, top_k, valid=None):
        probs = torch.softmax(
            logits + bias(logits.device)[0 if layer is None else layer],
            dim=-1)
        expert_idx, combine_w = normalize_topk(probs, top_k)
        return (expert_idx.to(torch.int32), combine_w,
                torch.zeros((), device=logits.device))
    return hook


def make_recording_hook(recorder):
    """Route exactly like the default learned router, and hand every
    layer's ``(positions, expert_idx, valid)`` to ``recorder.tap`` while
    the recorder is enabled (``repro_torch.moe.record.RoutingRecorder``)."""

    def hook(logits, *, positions, layer, top_k, valid=None):
        expert_idx, combine_w = normalize_topk(torch.softmax(logits, dim=-1),
                                               top_k)
        expert_idx = expert_idx.to(torch.int32)
        if recorder.enabled:
            ok = np.ones(positions.shape, bool) if valid is None \
                else valid.cpu().numpy()
            recorder.tap(layer, positions.cpu().numpy(),
                         expert_idx.cpu().numpy(), ok)
        return expert_idx, combine_w, torch.zeros((), device=logits.device)
    return hook
