"""Named hardware-spec registry (jax-free).

A copy of ``repro/hw/specs.py`` with one preset more, ``h100`` (the card
the port serves on; ``serve.driver.device_hw`` gives it the card's own
memory size).

The spec registry answers "what are this device's peak numbers" for the
synthetic-trace generator and the paged KV memory model.  The paper's
single-command integration flow is: pick/define a spec here, then either
run the profiler in measured mode on the real device or let
``repro_torch.hw.synthetic`` derive a trace analytically (``python -m
repro_torch.profiler profile --device <name> ...``).
"""
from __future__ import annotations

import time

from repro_torch.core.config import (CPU_HOST, ENGINE_HW, H100, PIM_DEVICE,
                                     RTX3090, TPU_V5E, TPU_V6E, HardwareSpec)

_REGISTRY = {
    "rtx3090": RTX3090,
    "h100": H100,
    "tpu-v5e": TPU_V5E,
    "tpu-v6e": TPU_V6E,
    "pim": PIM_DEVICE,
    "cpu-host": CPU_HOST,
    "cpu-engine": ENGINE_HW,
}


def get_hw(name: str) -> HardwareSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown hardware {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def register_hw(spec: HardwareSpec) -> HardwareSpec:
    _REGISTRY[spec.name] = spec
    return spec


def known_hw() -> list:
    return sorted(_REGISTRY)


def measured_cpu_spec(flops: float = None) -> HardwareSpec:
    """Calibrate a spec for THIS host CPU with a quick matmul probe."""
    import numpy as np
    if flops is None:
        n = 768
        a = np.random.rand(n, n).astype(np.float32)
        b = np.random.rand(n, n).astype(np.float32)
        a @ b  # warm
        t0 = time.perf_counter()
        reps = 6
        for _ in range(reps):
            a @ b
        dt = (time.perf_counter() - t0) / reps
        flops = 2 * n ** 3 / dt
    return register_hw(HardwareSpec(
        name="cpu-measured", peak_flops=flops, hbm_bw=20e9,
        hbm_capacity=16e9, link_bw=8e9))
