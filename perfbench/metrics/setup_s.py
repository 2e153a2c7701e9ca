"""Seconds from the process's start to the window's opening: imports, the
card's context, the weights, the kernels' build or load, the warm-up and
the pre-roll of traffic that the window opens on."""


def read(run):
    return run.setup_s
