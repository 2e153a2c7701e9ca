"""JAX parameter trees -> the port's parameters.

The JAX package's ``Model.init`` (``repro/models/transformer.py``) gives a
nested dict: ``embed.tok``, ``stage{i}`` stacked ``[n_layers, ...]`` with
``attn.{wq,wk,wv,wo[,bq,bk,bv][,q_norm,k_norm]}``,
``mlp.{w_gate,w_up,w_down | w_in,w_out}`` and ``norm1``/``norm2``,
``final_norm``, and ``head.w`` over ``padded_vocab``.  The port keeps that
layout, so conversion only turns each leaf into a tensor.  The caller hands
the tree over as numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``); nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree):
    """Nested dicts of numpy arrays -> nested dicts of CPU tensors, same
    keys and dtypes (``ServingEngine`` moves and casts them)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))      # a writable copy
