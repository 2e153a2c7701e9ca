"""JAX parameter trees -> the port's parameters.

The JAX package's ``Model.init`` (``repro/models/transformer.py``) gives a
nested dict: ``embed.tok``, ``stage{i}`` stacked ``[n_layers, ...]`` with
``attn.{wq,wk,wv,wo[,bq,bk,bv][,q_norm,k_norm]}``,
``mlp.{w_gate,w_up,w_down | w_in,w_out}`` and ``norm1``/``norm2``,
``final_norm``, and ``head.w`` over ``padded_vocab``.  The recurrent
stages add ``stage{i}.{norm, mamba}`` (``MAMBA2``: ``mamba.{w_zx, w_bc,
w_dt, dt_bias, conv_w, conv_b, A_log, D, norm_scale, w_out}``),
``stage{i}.inner.{norm, mamba}`` stacked ``[n_layers, 6, ...]``
(``ZAMBA_SUPER``) with the top-level ``shared_attn.{norm1, attn, norm2,
mlp}`` (unstacked), and ``stage{i}.{mlstm, slstm}`` (``XLSTM_PAIR``:
``mlstm.{norm_in, w_up, conv_w, conv_b, w_q, w_k, w_v, w_i, w_f, f_bias,
norm_h, w_down}``, ``slstm.{norm_in, w_gates, r_gates, b_gates, norm_h,
w_up, w_down}``).  The port keeps that layout, so conversion only turns
each leaf into a tensor of the same dtype (the JAX params are f32, and
``ServingEngine`` casts what the forward pass casts).  The caller hands
the tree over as numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``); nothing here imports JAX.  A JAX ``Model(fuse_qkv=True)``'s
``attn.wqkv`` (``(H + 2 KV) * dh`` wide) carries across unchanged, and the
port's ``Model(fuse_qkv=True)`` splits it the same way.  Training state
(``train_state_from_numpy``) carries across the same way: params, AdamW's
step and its two moment trees.
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


def train_state_from_numpy(params, mu, nu, step):
    """A JAX ``TrainState`` as numpy arrays (``params``, ``opt.mu``,
    ``opt.nu``, ``opt.step``) -> the port's ``TrainState``, on the CPU:
    the float params require grad, the moments and the () int32 step do
    not."""
    from repro_torch.train import TrainState
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.tree import map_tree
    p = map_tree(lambda t: t.requires_grad_(t.is_floating_point()),
                 params_from_numpy(params))
    return TrainState(p, AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32),
        mu=params_from_numpy(mu), nu=params_from_numpy(nu)))
