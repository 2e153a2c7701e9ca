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

On a rank grid (``grid``, a ``repro_torch.launch.mesh.RankGrid``, the dry
run's ``counting_grid``) each function gives that rank's inputs: the
batch's ``global_batch / dp`` rows (the whole batch when it does not divide
by dp, as JAX's ``batch_pspecs`` and ``fit_to_mesh`` replicate it), its
shard of the params (``sharding.shard_params``, in the model's expert
layout) and of the AdamW state,
and under ``zero1`` its slice of each moment over the data axis; a
cache holds the rank's KV slots and the recurrent state of its heads
(``Model.init_cache`` under the grid's model group).
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig, ShapeCfg
from repro_torch.models import Model
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import TrainState, rank_state

META = torch.device("meta")


def _t(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def rank_batch(shape: ShapeCfg, grid=None) -> int:
    """The rows of one data-parallel rank: ``global_batch / dp``, or the
    whole batch when it does not divide (replicated over dp; a batch of
    one, whose decode cache's sequence splits over ``data`` instead)."""
    B = shape.global_batch
    dp = 1 if grid is None else grid.dp_size
    return B // dp if B % dp == 0 else B


def train_batch_specs(cfg: ArchConfig, shape: ShapeCfg, grid=None) -> dict:
    B, S = rank_batch(shape, grid), shape.seq_len
    if cfg.embed_inputs:
        inputs = _t((B, S), torch.int32)
    else:
        inputs = _t((B, S, cfg.d_model), torch.bfloat16)
    if cfg.n_codebooks:
        labels = _t((B, S, cfg.n_codebooks), torch.int32)
    else:
        labels = _t((B, S), torch.int32)
    return {"inputs": inputs, "labels": labels}


def prefill_specs(cfg: ArchConfig, shape: ShapeCfg,
                  grid=None) -> torch.Tensor:
    B, S = rank_batch(shape, grid), shape.seq_len
    if cfg.embed_inputs:
        return _t((B, S), torch.int32)
    return _t((B, S, cfg.d_model), torch.bfloat16)


def decode_token_specs(cfg: ArchConfig, shape: ShapeCfg,
                       grid=None) -> torch.Tensor:
    B = rank_batch(shape, grid)
    if cfg.embed_inputs:
        return _t((B, 1), torch.int32)
    return _t((B, 1, cfg.d_model), torch.bfloat16)


def cache_specs(model: Model, shape: ShapeCfg, grid=None) -> dict:
    """The port's paged cache for the rank's slots of ``seq_len`` tokens
    each, on meta (see the module docstring); under ``model.seq_group``
    the rank's pages: its tokens of each sequence."""
    return model.init_cache(rank_batch(shape, grid), shape.seq_len,
                            device=META)


def params_specs(model: Model, dtype: torch.dtype = torch.float32,
                 grid=None) -> dict:
    params = model.init(torch.Generator(), device=META, dtype=dtype)
    if grid is not None and grid.tp > 1:
        from repro_torch.launch.sharding import shard_params
        params = shard_params(params, grid.coords["model"], grid.tp,
                              cfg=model.cfg,
                              shard_experts=model.shard_experts)
    return params


def state_specs(model: Model, optimizer: AdamW, grid=None,
                zero1: bool = False) -> TrainState:
    params = params_specs(model)
    if grid is None:
        return TrainState(params, optimizer.init(params))
    return rank_state(model, optimizer, params, grid, zero1)


def input_specs(cfg: ArchConfig, shape: ShapeCfg, model: Model,
                optimizer: AdamW | None = None, grid=None,
                zero1: bool = False) -> dict:
    """All inputs for the step kind of ``shape`` (a rank's on ``grid``):
    the dry run's entry point."""
    if shape.step == "train":
        return {"state": state_specs(model, optimizer or AdamW(), grid,
                                     zero1),
                "batch": train_batch_specs(cfg, shape, grid)}
    if shape.step == "prefill":
        return {"params": params_specs(model, grid=grid),
                "tokens": prefill_specs(cfg, shape, grid)}
    if shape.step == "decode":
        return {"params": params_specs(model, grid=grid),
                "cache": cache_specs(model, shape, grid),
                "tokens": decode_token_specs(cfg, shape, grid)}
    raise ValueError(shape.step)
