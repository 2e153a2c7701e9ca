"""The traffic generator: seeded, in range, the same work for every seed."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench.workload import Traffic, exponential_strata, lognormal_strata

TRAFFIC = Path(__file__).resolve().parent / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))


def take(spec, seed, n, vocab=1000):
    it = iter(Traffic(spec, seed, vocab))
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    spec = json.loads((TRAFFIC / f"{mix}.json").read_text())
    a, b = take(spec, 2 ** 31 + 7, 40), take(spec, 2 ** 31 + 7, 40)
    assert [(r.arrival, r.output_len, list(r.prompt_tokens)) for r in a] \
        == [(r.arrival, r.output_len, list(r.prompt_tokens)) for r in b]
    c = take(spec, 2 ** 31 + 8, 40)
    assert [list(r.prompt_tokens) for r in a] \
        != [list(r.prompt_tokens) for r in c]


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_in_range_and_fit_the_engine(mix):
    spec = json.loads((TRAFFIC / f"{mix}.json").read_text())
    vocab = 500
    for r in take(spec, 5, 3 * spec["block"], vocab):
        assert spec["prompt"]["min"] <= len(r.prompt_tokens) \
            <= spec["prompt"]["max"]
        assert spec["output"]["min"] <= r.output_len <= spec["output"]["max"]
        assert max(r.prompt_tokens) < vocab and min(r.prompt_tokens) >= 0
        # prompt and output fit a slot: the runtime truncates none
        assert len(r.prompt_tokens) + r.output_len \
            <= spec["engine"]["max_len"] - 1


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_gets_the_same_work(mix):
    spec = json.loads((TRAFFIC / f"{mix}.json").read_text())
    n = spec["block"]
    a, b = take(spec, 1, 2 * n), take(spec, 99, 2 * n)
    for blk in range(2):
        sl = slice(blk * n, (blk + 1) * n)
        assert sorted(len(r.prompt_tokens) for r in a[sl]) \
            == sorted(len(r.prompt_tokens) for r in b[sl])
        assert sorted(r.output_len for r in a[sl]) \
            == sorted(r.output_len for r in b[sl])
    if spec["arrival"]["process"] == "backlog":
        assert all(r.arrival == 0 for r in a + b)
    elif spec["arrival"]["process"] == "stratified":
        # the same set of gaps a block: block ends land together
        assert a[n - 1].arrival == pytest.approx(b[n - 1].arrival)
        assert a[n - 1].arrival == pytest.approx(
            n / spec["arrival"]["rate"])


@pytest.mark.parametrize("cv", [1.0, 3.0])
def test_gamma_arrivals_are_independent_draws(cv):
    spec = json.loads((TRAFFIC / "repo-context.json").read_text())
    spec["arrival"] = {"process": "gamma", "rate": 4.0, "cv": cv}
    n = 2000
    a = take(spec, 2 ** 31 + 11, n, vocab=10)
    assert [r.arrival for r in a] == \
        [r.arrival for r in take(spec, 2 ** 31 + 11, n, vocab=10)]
    gaps = np.diff([0.0] + [r.arrival for r in a])
    assert gaps.mean() == pytest.approx(0.25, rel=0.15)
    assert gaps.std() / gaps.mean() == pytest.approx(cv, rel=0.2)
    # blocks do not all span block / rate: the load comes in bursts
    spans = gaps.reshape(-1, spec["block"]).sum(axis=1)
    assert spans.std() > 0.05 * spans.mean()


def test_unknown_arrival_process():
    spec = json.loads((TRAFFIC / "repo-context.json").read_text())
    spec["arrival"] = {"process": "poisson", "rate": 1.0}
    with pytest.raises(ValueError, match="stratified, gamma or backlog"):
        Traffic(spec, 1, 10)


def test_strata():
    assert exponential_strata(2.0, 16).mean() == pytest.approx(0.5)
    lens = lognormal_strata(1024, 0.4, 512, 3071, 16)
    assert np.median(lens) == pytest.approx(1024, rel=0.05)
    assert lens.min() >= 512 and lens.max() <= 3071
