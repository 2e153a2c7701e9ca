"""Roofline tooling of the port: the operation counter and the roofline
against a hardware preset (``repro/roofline/`` of the JAX package)."""
from repro_torch.roofline.analysis import (RING_FACTORS, Roofline,
                                           model_flops, ring_factor)
from repro_torch.roofline.counter import Counter, kernel_call, trip_count

__all__ = ["Counter", "RING_FACTORS", "Roofline", "kernel_call",
           "model_flops", "ring_factor", "trip_count"]
