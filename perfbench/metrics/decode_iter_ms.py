"""Backend and engine: mean wall time of the window's iterations whose
items are all decode steps."""
from perfbench import readers


def read(run):
    d = [e.dur for e in readers.iters(run) if readers.phases(e) == {"decode"}]
    return 1e3 * sum(d) / len(d) if d else None
