"""Backend and engine: blocking host-device waits per iteration over the
window's iterations: pageable host-to-device copies, reads of device
values and synchronizes, as the program counts them on each ``iter``
event (``Event.host``).  None where the program counts none."""
from perfbench import readers


def read(run):
    counts = [sum(e.host.values()) for e in readers.iters(run)
              if getattr(e, "host", None)]
    return sum(counts) / len(counts) if counts else None
