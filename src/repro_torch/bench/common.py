"""Shared helpers of the port's benchmarks (the twin of
``benchmarks/common.py``)."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs import get_config
from repro_torch.core.config import (ENGINE_HW, InstanceCfg, PrefixCacheCfg,
                                     engine_scheduler_cfg)
from repro_torch.profiler.arch_spec import model_spec_from_arch

DENSE_TINY = "llama3.1-8b-tiny"
MOE_TINY = "phimini-moe-tiny"


def engine_matched_instance(name: str, arch: str, *, role: str = "unified",
                            max_batch: int = 4, prefix_cache: bool = False,
                            trace_name: Optional[str] = None) -> InstanceCfg:
    """Sim instance configured to mirror a CPU ServingEngine(max_batch)."""
    spec = model_spec_from_arch(get_config(arch))
    return InstanceCfg(
        name=name, hw=ENGINE_HW, model=spec, n_devices=1, role=role,
        scheduler=engine_scheduler_cfg(max_batch),
        prefix_cache=PrefixCacheCfg(enabled=prefix_cache, block_tokens=16,
                                    capacity_fraction=0.5),
        trace_name=trace_name or arch)


def pct_err(sim: float, real: float) -> float:
    if real is None or sim is None or real == 0:
        return float("nan")
    return 100.0 * abs(sim - real) / abs(real)
