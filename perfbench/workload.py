"""The one traffic generator: a traffic file of parameters -> requests.

Reworked from ``repro_torch/workload/sharegpt.py`` and ``arrival.py``
(lognormal lengths, exponential gaps) so that a mix is data only.  A
traffic file (``perfbench/traffic/<name>.json``) gives:

* ``prompt`` and ``output``: ``median``, ``sigma`` (of the log), ``min``
  and ``max`` tokens of a clipped lognormal;
* ``arrival``, one of (``rate`` in requests a second of the runtime's
  virtual clock):

  - ``{"process": "stratified", "rate": r}``: open-loop, exponential
    gaps stratified as the lengths are (below), so each block spans
    exactly ``block / r``: the same load for every seed, with no burst
    from block to block;
  - ``{"process": "gamma", "rate": r, "cv": c}``: open-loop, independent
    gamma gaps of mean ``1 / r`` and coefficient of variation ``c``
    drawn from the seed (``c`` 1 is Poisson, above 1 burstier);
  - ``{"process": "backlog"}``: every request due at t = 0, a queue that
    never empties;
* ``block``: requests come in blocks of this many.  Each block holds the
  same stratified set of lengths (one per quantile stratum), in an order
  drawn from the seed, so every seed offers the same work in another
  order and runs of different seeds spread no wider than runs of one
  seed.

Token ids are drawn uniformly from the model's vocabulary.  Block ``b``
of seed ``s`` is drawn from ``numpy.random.default_rng([s, b])``: the
same seed gives the same requests, whatever else the run does, and a
seed may be any non-negative integer.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Iterator, List, Sequence

import numpy as np


@dataclasses.dataclass
class Req:
    """What the harness hands the program: the attributes the runtime's
    ``submit_workload`` reads."""
    req_id: int
    arrival: float
    prompt_tokens: Sequence[int]
    output_len: int
    model: str = "default"


def lognormal_strata(median: float, sigma: float, lo: int, hi: int,
                     n: int) -> np.ndarray:
    """``n`` lengths, one at the middle quantile of each of ``n`` equal
    strata of a lognormal, rounded and clipped to ``[lo, hi]``."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(int)


def exponential_strata(rate: float, n: int) -> np.ndarray:
    """``n`` gaps, the mean of an exponential of ``rate`` within each of
    ``n`` equal strata of its probability: their mean is exactly
    ``1 / rate``."""
    out = np.empty(n)
    for i in range(n):
        p0, p1 = i / n, (i + 1) / n
        a = (1 - p0) * (1 - math.log(1 - p0))
        b = 0.0 if p1 >= 1 else (1 - p1) * (1 - math.log(1 - p1))
        out[i] = (a - b) / (p1 - p0) / rate
    return out


class Traffic:
    """An endless, seeded stream of requests for one traffic file."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec = spec
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.block = int(spec["block"])
        p, o = spec["prompt"], spec["output"]
        self._prompts = lognormal_strata(p["median"], p["sigma"], p["min"],
                                         p["max"], self.block)
        self._outputs = lognormal_strata(o["median"], o["sigma"], o["min"],
                                         o["max"], self.block)
        arrival = spec["arrival"]
        self.process = arrival["process"]
        if self.process not in ("stratified", "gamma", "backlog"):
            raise ValueError(f"arrival process {self.process!r}: "
                             f"stratified, gamma or backlog")
        self.backlog = self.process == "backlog"
        self._rate = None if self.backlog else float(arrival["rate"])
        self._cv = float(arrival.get("cv", 1.0))
        self._gaps = None if self.process != "stratified" else \
            exponential_strata(self._rate, self.block)
        self._next_block = 0
        self._t = 0.0

    def next_block(self) -> List[Req]:
        b = self._next_block
        self._next_block += 1
        rng = np.random.default_rng([self.seed, b])
        prompts = rng.permutation(self._prompts)
        outputs = rng.permutation(self._outputs)
        gaps = None
        if self.process == "stratified":
            gaps = rng.permutation(self._gaps)
        elif self.process == "gamma":
            shape = 1.0 / self._cv ** 2
            gaps = rng.gamma(shape, 1.0 / (shape * self._rate), self.block)
        out = []
        for i in range(self.block):
            if not self.backlog:
                self._t += float(gaps[i])
            ids = rng.integers(0, self.vocab, size=int(prompts[i]))
            out.append(Req(req_id=b * self.block + i, arrival=self._t,
                           prompt_tokens=ids.tolist(),
                           output_len=int(outputs[i])))
        return out

    def __iter__(self) -> Iterator[Req]:
        while True:
            yield from self.next_block()
