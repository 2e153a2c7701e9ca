"""Device: percent of the profiled stretch in which no operation ran on
the card."""


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0 or not p.device:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
