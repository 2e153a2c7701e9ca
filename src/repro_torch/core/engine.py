"""Discrete-event simulation engine (heapq-based).

Events carry a ``skippable`` flag: an event is skippable when its handler
provably touches only its own component (an isolated instance's iteration
completions).  Everything else — arrivals, KV transfers, failures, scale
events — is a *barrier*.  ``next_barrier_time`` exposes the earliest
pending barrier, which is the horizon the decode fast-forward path must
never cross: between now and that time, no event can change what an
isolated instance would do.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional


class Event:
    __slots__ = ("time", "seq", "fn", "cancelled", "tag", "skippable",
                 "done")

    def __init__(self, time: float, seq: int, fn: Callable, tag: str = "",
                 skippable: bool = False):
        self.time = time
        self.seq = seq
        self.fn = fn
        self.cancelled = False
        self.tag = tag
        self.skippable = skippable
        self.done = False

    def __lt__(self, other):
        return (self.time, self.seq) < (other.time, other.seq)


class EventQueue:
    def __init__(self):
        self._heap = []
        # barrier events only (lazy mirror of _heap; executed/cancelled
        # entries are dropped when next_barrier_time walks past them)
        self._barriers = []
        self._counter = itertools.count()
        self.now = 0.0
        self.n_processed = 0
        self._n_live = 0          # non-cancelled events (O(1) ``empty``)
        self._until: Optional[float] = None   # run(until=...) horizon

    def _push(self, ev: Event) -> Event:
        heapq.heappush(self._heap, ev)
        if not ev.skippable:
            heapq.heappush(self._barriers, ev)
        self._n_live += 1
        return ev

    def schedule(self, delay: float, fn: Callable, tag: str = "",
                 skippable: bool = False) -> Event:
        return self._push(Event(self.now + max(delay, 0.0),
                                next(self._counter), fn, tag, skippable))

    def schedule_at(self, t: float, fn: Callable, tag: str = "",
                    skippable: bool = False) -> Event:
        return self._push(Event(max(t, self.now), next(self._counter), fn,
                                tag, skippable))

    def cancel(self, ev: Event):
        if not ev.cancelled:
            ev.cancelled = True
            self._n_live -= 1

    def next_barrier_time(self) -> float:
        """Earliest pending non-skippable event (inf when none) — capped by
        the active ``run(until=...)`` bound so a fast-forward bulk event
        never outruns the caller's stopping point."""
        b = self._barriers
        while b and (b[0].done or b[0].cancelled):
            heapq.heappop(b)
        t = b[0].time if b else float("inf")
        if self._until is not None:
            t = min(t, self._until)
        return t

    def run(self, until: Optional[float] = None, max_events: int = 50_000_000):
        self._until = until
        while self._heap and self.n_processed < max_events:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            if until is not None and ev.time > until:
                heapq.heappush(self._heap, ev)
                self.now = until
                return
            self._n_live -= 1
            self.now = ev.time
            self.n_processed += 1
            ev.done = True
            ev.fn()

    @property
    def empty(self) -> bool:
        return self._n_live == 0
