"""Model: device operations (kernels, copies, fills) the host issued per
model call in the profiled stretch: an iteration makes one decode call
for its decode steps and one prefill or extend call for each prefill
chunk, and every operation that starts inside the iteration's span is
its own (each iteration ends in a synchronize)."""
import bisect


def read(run):
    p = run.profile
    if p is None or not p.device or not p.spans \
            or len(p.works) != len(p.spans):
        return None
    calls = sum(any(ph == "decode" for ph, _, _ in work)
                + sum(ph == "prefill" for ph, _, _ in work)
                for work in p.works)
    starts = sorted(d[0] for d in p.device)
    n = sum(bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s)
            for s, e, _ in p.spans)
    return n / calls if calls else None
