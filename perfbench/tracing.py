"""The traced run's capture: ``torch.profiler`` over a stretch of the
window, the harness's own spans around the backend's iterations, and a
record of the kernel calls the model made, reduced to plain lists.

The harness's spans are ``record_function`` ranges named
``perfbench.execute.<decode|prefill|mixed>`` around each
``TorchBackend.execute``; since every iteration ends in a
``torch.cuda.synchronize``, a device operation that starts inside such a
span belongs to that iteration.  The kernel wrappers of
``repro_torch.kernels.ops`` are wrapped while the capture is on, so each
call's shapes, its attention window and its lengths, starts and group
sizes (device tensors, read once the capture ends) are known for the
benchmark's own counts.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

#: device activities that are work the host issued (not annotations)
_DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}

#: kernel families by the function name of the port's CUDA sources
FAMILIES = {
    "flash": re.compile(r"(?<!\w)flash_fwd(_wgmma)?_kernel(?!\w)"),
    "extend": re.compile(r"(?<!\w)(paged_extend_wgmma|paged_fwd)_kernel(?!\w)"),
    "decode": re.compile(r"(?<!\w)paged_decode_split_kernel(?!\w)"),
    "gmm": re.compile(r"(?<!\w)gmm(_wgmma)?_kernel(?!\w)"),
}


@dataclasses.dataclass
class Profile:
    window: Tuple[int, int]                      # ns, profiler clock
    device: List[Tuple[int, int, str]]           # (start, end, name), ns
    spans: List[Tuple[int, int, str]]            # execute spans, ns
    calls: Dict[str, List[dict]]                 # kernel calls by family
    works: List[List[tuple]]                     # per iteration: work items

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        lo, hi = self.window
        out: List[List[int]] = []
        for s, e, _ in sorted(self.device):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def family_seconds(self, family: str) -> Tuple[float, int]:
        pat = FAMILIES[family]
        hits = [e - s for s, e, n in self.device if pat.search(n)]
        return sum(hits) * 1e-9, len(hits)

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for s, e, n in self.device:
            by[n] = by.get(n, 0.0) + (e - s) * 1e-9
        return [[n[:160], t] for n, t in
                sorted(by.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle device time within the window, summed by what the host
        was doing: dispatching inside an iteration of a kind, or the
        runtime's and the harness's work between iterations."""
        lo, hi = self.window
        busy = self.busy_intervals()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        spans = sorted(self.spans)
        starts = [s for s, _, _ in spans]
        by: Dict[str, float] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            label = "between iterations (runtime and harness on the host)"
            j = bisect.bisect_right(starts, mid) - 1
            if j >= 0 and mid < spans[j][1]:
                label = f"inside a {spans[j][2]} iteration (host dispatch)"
            by[label] = by.get(label, 0.0) + (b - a) * 1e-9
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda x: -x[1])[:top]]


class Capture:
    """Profile the serve between ``start()`` and ``stop()``, which the
    harness calls between two iterations."""

    def __init__(self):
        self.prof = None
        self.active = False
        self._calls: Dict[str, List[dict]] = {"flash": [], "extend": [],
                                              "decode": [], "gmm": []}
        self.works: List[List[tuple]] = []
        self._saved = {}
        self._window = None

    # -- the kernel wrappers' calls ---------------------------------------
    def _wrap(self):
        from repro_torch.kernels import ops
        calls = self._calls
        flash, paged, gmm = ops.flash_attention, ops.paged_attention, \
            ops.moe_gmm
        self._saved = {"flash_attention": flash, "paged_attention": paged,
                       "moe_gmm": gmm}

        def flash_w(q, k, v, lengths=None, window=None, return_lse=False):
            calls["flash"].append({"q": tuple(q.shape), "KV": k.shape[2],
                                   "lengths": lengths, "window": window,
                                   "itemsize": q.element_size()})
            return flash(q, k, v, lengths, window, return_lse)

        def paged_w(q, k_pages, v_pages, block_table, lengths, **kw):
            fam = "decode" if q.dim() == 3 else "extend"
            calls[fam].append({"q": tuple(q.shape), "KV": k_pages.shape[2],
                               "page_size": kw.get("page_size"),
                               "lengths": lengths, "start": kw.get("start"),
                               "window": kw.get("window"),
                               "itemsize": q.element_size()})
            return paged(q, k_pages, v_pages, block_table, lengths, **kw)

        def gmm_w(x, w, group_sizes):
            calls["gmm"].append({"x": tuple(x.shape), "w": tuple(w.shape),
                                 "group_sizes": group_sizes,
                                 "itemsize": x.element_size()})
            return gmm(x, w, group_sizes)

        ops.flash_attention, ops.paged_attention, ops.moe_gmm = \
            flash_w, paged_w, gmm_w

    def _unwrap(self):
        from repro_torch.kernels import ops
        for name, fn in self._saved.items():
            setattr(ops, name, fn)

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self):
        """Start and stop the profiler once, in set-up: its first start in
        a process initialises the tracer, which takes seconds."""
        with self._profile():
            torch.zeros(1, device="cuda" if torch.cuda.is_available()
                        else "cpu").add_(1)

    def start(self):
        self.prof = self._profile()
        self.prof.__enter__()
        self._wrap()
        self.active = True
        self._window = torch.profiler.record_function("perfbench.window")
        self._window.__enter__()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.active = False
        self._unwrap()
        self.prof.__exit__(None, None, None)

    def note(self, works: List[tuple]):
        """The work items of one iteration inside the capture."""
        if self.active:
            self.works.append(works)

    # -- reduction ---------------------------------------------------------
    @staticmethod
    def _host(v):
        if v is None:
            return None
        if isinstance(v, torch.Tensor):
            return v.tolist()
        return v

    def reduce(self) -> Profile:
        t0 = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        window = None
        device, spans = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            name = e.name()
            if e.device_type() == cuda:
                kind = getattr(e, "activity_type", None)
                kind = kind() if callable(kind) else None
                if kind is not None and kind not in _DEVICE_KINDS:
                    continue
                if kind is None and name.startswith("perfbench."):
                    continue
                s = e.start_ns()
                device.append((s, s + e.duration_ns(), name))
            elif name.startswith("perfbench."):
                s = e.start_ns()
                if name == "perfbench.window":
                    window = (s, s + e.duration_ns())
                elif name.startswith("perfbench.execute."):
                    spans.append((s, s + e.duration_ns(),
                                  name[len("perfbench.execute."):]))
        if window is None:
            raise RuntimeError("the profile holds no perfbench.window range")
        lo, hi = window
        device = [d for d in device if lo <= d[0] < hi]
        spans = [s for s in spans if lo <= s[0] < hi]
        calls = {fam: [{k: self._host(v) for k, v in c.items()}
                       for c in cs] for fam, cs in self._calls.items()}
        self.reduce_s = time.perf_counter() - t0
        return Profile(window=window, device=device, spans=sorted(spans),
                       calls=calls, works=self.works)
