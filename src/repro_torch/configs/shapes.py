"""Assigned input-shape set. Every LM-family arch is paired with all four.

``train_4k`` lowers train_step; ``prefill_32k`` lowers prefill_step;
``decode_32k`` / ``long_500k`` lower serve_step (one new token against a KV
cache of ``seq_len``). ``long_500k`` requires a sub-quadratic arch (see
``ArchConfig.subquadratic`` and DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    step: str                  # train | prefill | decode


TRAIN_4K = ShapeCfg("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeCfg("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeCfg("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeCfg("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeCfg, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def get_shape(name: str) -> ShapeCfg:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in ALL_SHAPES]}")


def cell_is_runnable(arch_subquadratic: bool, shape: ShapeCfg) -> bool:
    """long_500k only runs for sub-quadratic archs (SSM/hybrid/windowed)."""
    if shape.name == "long_500k":
        return arch_subquadratic
    return True
