"""Meta-device stand-ins for every model input: shapes and dtypes, no
allocation.  The dry run (``repro_torch.launch.dryrun``) runs its steps
on these.

The counterpart of ``repro/launch/specs.py``, which builds
``jax.ShapeDtypeStruct`` trees; each function here has its name and
returns meta tensors of the same shapes and dtypes, except
``cache_specs``: it is the port's paged cache, ``Model.init_cache(B, S,
device="meta")`` (page pools, a block table and per-slot lengths), not the
JAX model's contiguous ``(L, B, S, KV, dh)`` cache.  Params are f32, as
the JAX dry run lowers every step on them; ``params_specs`` takes another
dtype for a serve's (bf16 matmul weights, f32 norms).
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig, ShapeCfg
from repro_torch.models import Model
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import TrainState

META = torch.device("meta")


def _t(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ArchConfig, shape: ShapeCfg) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.embed_inputs:
        inputs = _t((B, S), torch.int32)
    else:
        inputs = _t((B, S, cfg.d_model), torch.bfloat16)
    if cfg.n_codebooks:
        labels = _t((B, S, cfg.n_codebooks), torch.int32)
    else:
        labels = _t((B, S), torch.int32)
    return {"inputs": inputs, "labels": labels}


def prefill_specs(cfg: ArchConfig, shape: ShapeCfg) -> torch.Tensor:
    B, S = shape.global_batch, shape.seq_len
    if cfg.embed_inputs:
        return _t((B, S), torch.int32)
    return _t((B, S, cfg.d_model), torch.bfloat16)


def decode_token_specs(cfg: ArchConfig, shape: ShapeCfg) -> torch.Tensor:
    B = shape.global_batch
    if cfg.embed_inputs:
        return _t((B, 1), torch.int32)
    return _t((B, 1, cfg.d_model), torch.bfloat16)


def cache_specs(model: Model, shape: ShapeCfg) -> dict:
    """The port's paged cache for ``global_batch`` slots of ``seq_len``
    tokens each, on meta (see the module docstring)."""
    return model.init_cache(shape.global_batch, shape.seq_len, device=META)


def params_specs(model: Model, dtype: torch.dtype = torch.float32) -> dict:
    return model.init(torch.Generator(), device=META, dtype=dtype)


def state_specs(model: Model, optimizer: AdamW) -> TrainState:
    params = params_specs(model)
    return TrainState(params, optimizer.init(params))


def input_specs(cfg: ArchConfig, shape: ShapeCfg, model: Model,
                optimizer: AdamW | None = None) -> dict:
    """All inputs for the step kind of ``shape``: the dry run's entry
    point."""
    if shape.step == "train":
        return {"state": state_specs(model, optimizer or AdamW()),
                "batch": train_batch_specs(cfg, shape)}
    if shape.step == "prefill":
        return {"params": params_specs(model),
                "tokens": prefill_specs(cfg, shape)}
    if shape.step == "decode":
        return {"params": params_specs(model),
                "cache": cache_specs(model, shape),
                "tokens": decode_token_specs(cfg, shape)}
    raise ValueError(shape.step)
