"""Backend and engine: the wall time of the window's iterations that
carry prefill chunks over their prefill tokens, per thousand tokens."""
from perfbench import readers


def read(run):
    dur, tok = 0.0, 0
    for e in readers.iters(run):
        n = sum(t for _, phase, t in e.payload["items"] if phase == "prefill")
        if n:
            dur += e.dur
            tok += n
    return 1e6 * dur / tok if tok else None
