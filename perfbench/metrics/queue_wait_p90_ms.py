"""Runtime: 90th percentile over the window's requests of the time from
arrival to admission into the running set, on the runtime's clock
(``arrival`` and ``admit`` events)."""
from perfbench import readers


def read(run):
    if run.events is None:
        return None
    mine = {s.req_id for s in run.requests}
    arrive, admit = {}, {}
    for e in run.events:
        if e.req in mine:
            if e.kind == "arrival":
                arrive[e.req] = e.t
            elif e.kind == "admit" and e.req not in admit:
                admit[e.req] = e.t
    waits = [1e3 * (admit[r] - arrive[r]) for r in admit if r in arrive]
    return readers.pct(waits, 90)
