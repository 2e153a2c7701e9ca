"""Seeded weights on the device, in the nested layout the program takes.

The harness draws every weight itself, from ``--seed``, on the card and
in the type the configuration serves (one call for each leaf stacked over
the layers), and hands the same tensors to the program
(``ServingEngine(params=...)``) and, once the program is gone, to the
plain reference.  Matrices are N(0, 1 / fan-in); the embedding N(0, 1);
norm scales (read as ``1 + scale``) N(0, 0.1^2), in float32 as the
program reads them.  ``dense`` and ``norm`` are the draws another
family's ``make_params`` builds on (``reference/__init__.py``).
"""
from __future__ import annotations

import math

import torch


def dense(gen, shape, dtype, device):
    """A matrix (stack) of ``shape`` drawn N(0, 1 / fan-in)."""
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(1.0 / math.sqrt(shape[-2]))


def norm(gen, shape, device):
    """Norm scales of ``shape`` drawn N(0, 0.1^2) in float32."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(0.1)


def make_params(sizes: dict, seed: int, device, dtype=torch.bfloat16):
    """Params for one stage of ``sizes["n_layers"]`` attention + MLP (or
    attention + MoE) layers, the embedding over the padded vocabulary
    and the output head."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    L, d = sizes["n_layers"], sizes["d_model"]
    H, KV, dh = sizes["n_heads"], sizes["n_kv_heads"], sizes["d_head"]
    Vp = sizes["padded_vocab"]
    stage = {
        "norm1": norm(gen, (L, d), device),
        "attn": {"wq": dense(gen, (L, d, H * dh), dtype, device),
                 "wk": dense(gen, (L, d, KV * dh), dtype, device),
                 "wv": dense(gen, (L, d, KV * dh), dtype, device),
                 "wo": dense(gen, (L, H * dh, d), dtype, device)},
        "norm2": norm(gen, (L, d), device)}
    moe = sizes.get("moe")
    if moe:
        E, de = moe["n_experts"], moe["d_expert"]
        stage["moe"] = {"router": dense(gen, (L, d, E), dtype, device),
                        "w_gate": dense(gen, (L, E, d, de), dtype, device),
                        "w_up": dense(gen, (L, E, d, de), dtype, device),
                        "w_down": dense(gen, (L, E, de, d), dtype, device)}
    else:
        ff = sizes["d_ff"]
        stage["mlp"] = {"w_in": dense(gen, (L, d, ff), dtype, device),
                        "w_out": dense(gen, (L, ff, d), dtype, device)}
    return {
        "embed": {"tok": torch.randn((Vp, d), generator=gen, dtype=dtype,
                                     device=device)},
        "stage0": stage,
        "final_norm": norm(gen, (d,), device),
        "head": {"w": dense(gen, (d, Vp), dtype, device)}}
