"""Kernels: percent of its roofline the prefill attention reaches, over
every flash and paged-extend call in the profiled stretch (the
benchmark's bound of each call against the kernels' device time)."""
from perfbench import readers


def read(run):
    return readers.roofline(run, ("flash", "extend"))
