"""Runtime: the share of the wall window outside the backend's iterations
(1 - the sum of the ``iter`` events' wall durations over the window),
the host work the runtime's clock leaves out. Percent."""
from perfbench import readers


def read(run):
    its = readers.iters(run)
    if not its or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - sum(e.dur for e in its) / run.window_s)
