"""Roofline of a counted step against a hardware preset.

The counterpart of ``repro/roofline/analysis.py``.  Three terms per cell,
in seconds, on one device:

  compute    = FLOPs / the preset's peak FLOP/s
  memory     = HBM bytes / the preset's HBM bandwidth
  collective = bytes moved over links / the preset's link bandwidth

The JAX package's constants are a TPU v5e's; here they come from a
``repro_torch.hw.specs`` preset, ``h100`` by default (989 TFLOP/s dense
bf16, 3.35 TB/s, 450 GB/s NVLink a direction), and ``hw=`` takes any
registered one.  The FLOPs, bytes and collective bytes come from
``repro_torch.roofline.counter``.  ``shape_bytes`` and
``collective_bytes`` of the JAX module parse HLO text and have no
counterpart: eager PyTorch has no HLO.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

#: bytes each device moves over links per result byte of a collective over
#: a group of n (ring algorithms), the JAX analyzer's factors
RING_FACTORS = {
    "all-gather": lambda n: (n - 1) / n,
    "all-reduce": lambda n: 2 * (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
}


def ring_factor(kind: str, n: int) -> float:
    return RING_FACTORS[kind](n)


def _spec(hw: str):
    from repro_torch.hw.specs import get_hw
    return get_hw(hw)


def __getattr__(name):
    """``PEAK_FLOPS``, ``HBM_BW`` and ``LINK_BW`` of the default preset,
    the names of the JAX module's constants."""
    attr = {"PEAK_FLOPS": "peak_flops", "HBM_BW": "hbm_bw",
            "LINK_BW": "link_bw"}.get(name)
    if attr is None:
        raise AttributeError(name)
    return getattr(_spec("h100"), attr)


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device FLOPs
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: Dict[str, float]  # per-device collective result bytes
    n_devices: int
    coll_moved: float = 0.0      # ring-factor-scaled per-device bytes
    hw: str = "h100"

    @property
    def t_compute(self) -> float:
        return self.flops / _spec(self.hw).peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / _spec(self.hw).hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_moved / _spec(self.hw).link_bw

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    def summary(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes": dict(self.coll_bytes),
        }


def from_counter(counter, n_devices: int, hw: str = "h100") -> Roofline:
    """The roofline of what ``counter`` saw: the aten ops outside the
    kernels plus each kernel's charged work."""
    return Roofline(flops=counter.flops + counter.kernel_flops,
                    hbm_bytes=counter.hbm_bytes + counter.kernel_bytes,
                    coll_bytes={k: int(v) for k, v in
                                counter.coll_bytes.items()},
                    n_devices=n_devices, coll_moved=counter.coll_moved,
                    hw=hw)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for train;
    2·N·D for inference steps (fwd only). D = tokens processed."""
    n = cfg.active_param_count()
    if shape.step == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.step == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n * tokens
