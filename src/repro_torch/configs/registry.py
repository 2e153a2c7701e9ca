"""Registry of the 10 assigned architectures, the paper's own eval models
and the port's own (trinity-mini, which the JAX package lacks).

Each architecture lives in its own ``src/repro/configs/<id>.py`` module; this
registry imports and indexes them by their public arch id (``--arch <id>``).
``<id>-tiny`` resolves to the reduced same-family smoke-test config.
"""
from __future__ import annotations

from repro_torch.configs import (
    chameleon_34b, gemma3_27b, granite_moe_1b_a400m, granite_moe_3b_a800m,
    llama31_8b, musicgen_large, phimini_moe, qwen3_8b, qwen15_32b,
    starcoder2_7b, trinity_mini, xlstm_125m, zamba2_1p2b,
)
from repro_torch.configs.base import ArchConfig

_MODULES = (
    starcoder2_7b, qwen15_32b, gemma3_27b, qwen3_8b, zamba2_1p2b,
    chameleon_34b, granite_moe_3b_a800m, granite_moe_1b_a400m, xlstm_125m,
    musicgen_large, llama31_8b, phimini_moe, trinity_mini,
)

_REGISTRY = {m.CONFIG.name: m.CONFIG for m in _MODULES}

# The 10 assigned architectures (the others are the paper's eval models and
# the port's own).
ASSIGNED = (
    "starcoder2-7b", "qwen1.5-32b", "gemma3-27b", "qwen3-8b", "zamba2-1.2b",
    "chameleon-34b", "granite-moe-3b-a800m", "granite-moe-1b-a400m",
    "xlstm-125m", "musicgen-large",
)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-tiny"):
        return get_config(name[: -len("-tiny")]).tiny()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


#: architectures the port registers and the JAX package does not
PORT_ONLY = ("trinity-mini",)


def list_archs():
    return sorted(_REGISTRY)
