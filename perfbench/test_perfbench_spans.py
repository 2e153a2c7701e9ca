"""The readers of the program's spans and wait counts (``spans.py``,
``metrics/host_syncs_per_iter.py``): exact interval arithmetic on a
synthetic profile, the split summing to ``device_idle_share``, None
without device operations or spans, the existing readers unchanged on a
profile that carries spans, and the tiny traced CPU cell."""
import dataclasses
import json
import time
from types import SimpleNamespace

import pytest

from perfbench import cells, harness, spans
from perfbench.tracing import Profile

HERE = spans.ROOT / "perfbench"
SEED = 2 ** 31 + 4321


def reader(name):
    return cells._reader(HERE / "metrics" / f"{name}.py")


def synthetic(**kw) -> spans.SpanProfile:
    """A 1,000 ns stretch: the card busy [100, 200), [300, 400), [600,
    700), [850, 900); a decode iteration [50, 500) with its decode call
    [80, 350) and its sync [450, 480); a mixed iteration [550, 800) whose
    prefill chunk [560, 780) holds an extend call [570, 650)."""
    base = dict(
        window=(0, 1000),
        device=[(100, 200, "k0"), (300, 400, "k1"), (600, 700, "k2"),
                (850, 900, "k3")],
        spans=[(50, 500, "decode"), (550, 800, "mixed")],
        calls={"flash": [], "extend": [], "decode": [], "gmm": []},
        works=[[("decode", 1, 10)], [("decode", 1, 11),
                                     ("prefill", 8, 0)]],
        host_spans=spans._depths([
            (60, 450, "backend.decode_step"), (80, 350, "model.decode"),
            (90, 120, "attn.kernel"), (450, 480, "backend.sync"),
            (455, 478, "wait.sync"), (560, 780, "backend.prefill_chunk"),
            (570, 650, "model.extend")]),
        launches=[(65, 1), (95, 2), (200, 3), (600, 4), (700, 5),
                  (520, 6)],
        launched={1: 100, 2: 100, 3: 100, 4: 50, 5: 50, 6: 50})
    base.update(kw)
    return spans.SpanProfile(**base)


def test_idle_split_exact():
    # idle: [0,100) [200,300) [400,600) [700,850) [900,1000)
    # in model calls: [80,100) [200,300) [570,600)
    # in the backend outside them: [60,80) [400,480) [560,570) [700,780)
    # in the iterations outside both: [50,60) [480,500) [550,560)
    #   [780,800); between: [0,50) [500,550) [800,850) [900,1000)
    split = spans.idle_split(synthetic())
    assert split == pytest.approx({
        "idle_in_model_call_share": 15.0, "idle_in_staging_share": 19.0,
        "idle_in_iteration_rest_share": 6.0,
        "idle_between_iterations_share": 25.0}, abs=1e-12)


def test_split_sums_to_device_idle_share():
    p = synthetic()
    idle = reader("device_idle_share")(SimpleNamespace(profile=p))
    assert sum(spans.idle_split(p).values()) == pytest.approx(idle)
    # the harness's between-iterations gaps (midpoints outside its
    # spans) agree here, where no gap straddles an iteration's edge
    p = synthetic(device=[(40, 600, "k"), (800, 900, "k")])
    split = spans.idle_split(p)
    between = dict(p.idle_gaps())[
        "between iterations (runtime and harness on the host)"]
    assert split["idle_in_model_call_share"] + \
        split["idle_in_staging_share"] + \
        split["idle_in_iteration_rest_share"] + 100.0 * between / 1e-6 \
        == pytest.approx(reader("device_idle_share")(
            SimpleNamespace(profile=p)))


def test_none_without_device_operations_or_spans():
    assert spans.idle_split(synthetic(device=[])) is None
    assert spans.idle_split(synthetic(host_spans=[])) is None
    assert spans.decode_dispatch_ms(synthetic(host_spans=[])) is None
    assert spans.host_span_table(synthetic(host_spans=[])) == []


def test_decode_dispatch_and_host_span_table():
    p = synthetic()
    assert spans.decode_dispatch_ms(p) == pytest.approx(270e-6)
    assert [d for *_, d in p.host_spans] == [0, 1, 2, 0, 1, 0, 1]
    rows = {r[0]: r[1:] for r in spans.host_span_table(p)}
    # self ns: decode_step 390 - 270; model.decode 270 - 30; the extend
    # call's 80 inside a chunk of 220; the launch at 520 lies in no span
    want = {"backend.decode_step": [1, 120e-6, 1, 100e-6],
            "model.decode": [1, 240e-6, 1, 100e-6],
            "attn.kernel": [1, 30e-6, 1, 100e-6],
            "backend.sync": [1, 7e-6, 0, 0.0],
            "wait.sync": [1, 23e-6, 0, 0.0],
            "backend.prefill_chunk": [1, 140e-6, 1, 50e-6],
            "model.extend": [1, 80e-6, 1, 50e-6]}
    assert set(rows) == set(want)
    for name, row in want.items():
        assert rows[name] == pytest.approx(row, abs=1e-15), name
    assert list(rows)[0] == "model.decode"
    assert len(spans.host_span_table(p, top=2)) == 2


def test_existing_readers_unchanged_on_a_profile_with_spans():
    """Every reader of the accepted benchmark, and the breakdown, reads a
    profile that carries spans as it reads the same profile without."""
    p = synthetic()
    plain = Profile(**{f.name: getattr(p, f.name)
                       for f in dataclasses.fields(Profile)})
    run = dict(sizes={}, setup_s=1.0, window_s=1.0, wall_open=0.0,
               wall_close=1.0, v_open=0.0, v_close=1.0, requests=[],
               tokens=0)
    for name in ("device_idle_share", "launches_per_model_call",
                 "attn_prefill_roofline"):
        read = reader(name)
        assert read(harness.Run(profile=p, **run)) == \
            read(harness.Run(profile=plain, **run))
    assert p.idle_gaps() == plain.idle_gaps()
    assert p.device_ops() == plain.device_ops()
    assert p.busy_s == plain.busy_s


def test_host_syncs_per_iter_reads_the_iter_events():
    def it(wall, host):
        return SimpleNamespace(kind="iter", wall=wall, host=host)
    run = SimpleNamespace(
        events=[it(0.5, {"h2d": 1, "d2h": 1, "sync": 1}),
                it(0.6, {"h2d": 6, "d2h": 2, "sync": 1}),
                it(5.0, {"h2d": 9, "d2h": 9, "sync": 9}),
                SimpleNamespace(kind="admit", wall=0.7, host=None)],
        wall_open=10.0, wall_close=12.0, rec_t0=10.0)
    read = reader("host_syncs_per_iter")
    assert read(run) == pytest.approx(6.0)
    # a program that counts nothing (its events have no ``host``)
    run.events = [SimpleNamespace(kind="iter", wall=0.5)]
    assert read(run) is None


def test_tiny_traced_cell(tiny_root):
    """The tiny traced CPU cell: the benchmark's run reports
    ``host_syncs_per_iter``; the spans' run a decode call's dispatch and
    the host-span table; with no device operation on the CPU, no idle
    share."""
    cell = cells.load(tiny_root, "dense.backlog")
    out = harness.serve_cell(cell, SEED, 1.0, True, "cpu",
                             time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["metrics"]["host_syncs_per_iter"]["value"] >= 3.0
    got = spans.run(cell, SEED, 1.0, "cpu", time.perf_counter())
    s = got["spans"]
    assert s["decode_dispatch_ms"] > 0 and s["iter_ms"] > 0
    assert not {"idle_in_model_call_share", "idle_in_staging_share"} & set(s)
    names = {r[0] for r in s["host_spans"]}
    assert {"model.decode", "attn.kernel"} <= names
    assert all(r[3] == 0 for r in s["host_spans"])     # no launch on a CPU
    json.dumps(got)
