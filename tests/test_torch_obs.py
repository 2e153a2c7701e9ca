"""Event tracing on the port (``repro_torch.obs``) against the JAX package.

The port's simulator records the JAX simulator's event log, attribution
and Chrome trace on the same workload (both priced by the same analytical
trace); the twins of ``tests/test_obs.py``'s attribution, P/D-segment and
invisibility tests hold on the port; the CLI re-exports a saved log; and
``ServeDriver(recorder=)`` on the port's engine records the same event
kinds, order and request ids as the JAX driver (wall stamps aside).  The
recorder's clock maps each wall stamp onto a ``torch.profiler`` trace, and
an event's wait counts (``host``) round-trip and stay out of its identity.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import repro.core as jcore  # noqa: E402
import repro.obs as jobs  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.cluster import Cluster as JaxCluster  # noqa: E402
from repro.profiler import profile_arch as jax_profile_arch  # noqa: E402
from repro.workload import ShareGPTConfig as JaxShareGPTConfig  # noqa: E402
from repro.workload import generate as jax_generate  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cluster import Cluster  # noqa: E402
from repro_torch.core.config import HardwareSpec, ModelSpec  # noqa: E402
from repro_torch.core.request import FINISHED  # noqa: E402
from repro_torch.obs.events import PD_ADMIT, PD_EXPORT  # noqa: E402
from repro_torch.profiler import (model_spec_from_arch,  # noqa: E402
                                  profile_arch)
from repro_torch.workload import ShareGPTConfig, generate  # noqa: E402
from repro_torch.workload.sharegpt import Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3.1-8b-tiny"


@pytest.fixture(scope="module")
def traces():
    """The analytical tiny trace of each package (equal by the copies)."""
    return {"jax": jax_profile_arch(ARCH, hardware="tpu-v5e",
                                    mode="analytical", tp=1),
            "torch": profile_arch(ARCH, hardware="tpu-v5e",
                                  mode="analytical", tp=1)}


def _inst(core, name="i0", **kw):
    spec = model_spec_from_arch(get_config(ARCH))
    spec = core.ModelSpec(**dataclasses.asdict(spec))
    base = dict(hw=core.config.TPU_V5E, model=spec, n_devices=1,
                scheduler=core.SchedulerCfg(max_batch_size=8,
                                            max_batch_tokens=2048),
                trace_name=ARCH)
    base.update(kw)
    return core.InstanceCfg(name=name, **base)


def _run(pkg, ccfg_fn, reqs, trace=None, traced=True):
    """Simulate on ``pkg`` ("jax" | "torch"): (metrics, cluster, recorder)."""
    core, obs, cluster_cls = (jcore, jobs, JaxCluster) if pkg == "jax" \
        else (tcore, tobs, Cluster)
    reg = None
    if trace is not None:
        reg = core.TraceRegistry()
        reg.register(ARCH, trace)
    rec = obs.EventRecorder() if traced else None
    cl = cluster_cls(ccfg_fn(core), traces=reg, recorder=rec)
    cl.submit_workload([copy.deepcopy(r) for r in reqs])
    return cl.run(), cl, rec


def _workload(pkg, **kw):
    gen, cfg = (jax_generate, JaxShareGPTConfig) if pkg == "jax" \
        else (generate, ShareGPTConfig)
    return gen(cfg(**kw))


def _assert_waterfalls_exact(m, cl):
    attr = m["attribution"]
    reqs = {r.req_id: r for r in cl._all_requests}
    finished = [r for r in cl._all_requests if r.state == FINISHED]
    assert finished and len(attr["requests"]) == len(finished)
    for rid, row in attr["requests"].items():
        r = reqs[rid]
        assert row["total_s"] == r.t_finish - r.arrival
        assert set(row["segments"]) == set(tobs.SEGMENTS)
        assert all(v >= 0.0 for v in row["segments"].values())
        assert sum(row["segments"].values()) == pytest.approx(
            row["total_s"], rel=1e-9, abs=1e-12)
        tl = row["timeline"]
        assert tl[0][0] == r.arrival and tl[-1][1] == r.t_finish
        for (_, a1, _), (b0, _, _) in zip(tl, tl[1:]):
            assert a1 == b0
    return attr


def _segment_totals(attr):
    return {k: sum(r["segments"][k] for r in attr["requests"].values())
            for k in tobs.SEGMENTS}


# --------------------------------------------------------------------------
# the port's simulator records what the JAX simulator records
# --------------------------------------------------------------------------

@pytest.mark.parametrize("router", ["least_loaded", "prefix_aware"])
def test_sim_event_log_attribution_and_trace_equal_jax(traces, router):
    kw = dict(n_requests=20, rate=150.0, vocab=1000, share_fraction=0.8,
              n_conversations=3, mean_prompt=40, max_prompt=80,
              mean_output=30, max_output=60, seed=3)

    def ccfg(core):
        return core.ClusterCfg(
            tuple(_inst(core, f"i{k}",
                        prefix_cache=core.PrefixCacheCfg(enabled=True))
                  for k in range(2)), router=core.RouterCfg(router))
    jm, _, jrec = _run("jax", ccfg, _workload("jax", **kw), traces["jax"])
    tm, _, trec = _run("torch", ccfg, _workload("torch", **kw),
                       traces["torch"])
    assert tm["finished"] == jm["finished"] == 20
    assert [e.to_dict() for e in trec.events] == \
        [e.to_dict() for e in jrec.events]
    assert tm["attribution"] == jm["attribution"]
    # the traces differ only in the schema tag naming their package
    tt, jt = tobs.chrome_trace(trec), jobs.chrome_trace(jrec)
    assert tt["otherData"].pop("schema") == "repro_torch.obs/1"
    assert jt["otherData"].pop("schema") == "repro.obs/1"
    assert tt == jt
    assert trec.series(interval=0.01) == jrec.series(interval=0.01)
    assert tobs.validate_chrome_trace(tobs.chrome_trace(trec)) == []


# --------------------------------------------------------------------------
# twins of tests/test_obs.py
# --------------------------------------------------------------------------

def _pressure_cfg(core):
    model = ModelSpec(name="m", n_layers=2, d_model=64, n_heads=2,
                      n_kv_heads=1, d_head=16, d_ff=128, vocab=1000,
                      param_bytes=1e6)
    hw = HardwareSpec(name="tiny", peak_flops=1e12, hbm_bw=1e11,
                      hbm_capacity=(1e6 + 30 * 16 * model.kv_bytes_per_token)
                      / 0.9 + 1, link_bw=1e9)
    insts = tuple(
        tcore.InstanceCfg(name=f"i{k}", hw=hw, model=model,
                          scheduler=tcore.SchedulerCfg(max_batch_size=8,
                                                       max_batch_tokens=4096),
                          prefix_cache=tcore.PrefixCacheCfg(
                              enabled=True, capacity_fraction=0.1))
        for k in range(2))
    return tcore.ClusterCfg(insts, router=tcore.RouterCfg("least_loaded"))


def test_attribution_sums_to_e2e_under_pressure():
    rng = np.random.default_rng(0)
    reqs = [Request(req_id=i, arrival=0.0,
                    prompt_tokens=rng.integers(0, 1000, 100).tolist(),
                    output_len=250) for i in range(4)]
    m, cl, _ = _run("torch", _pressure_cfg, reqs)
    assert m["finished"] == 4 and m["preemptions"] > 0
    attr = _assert_waterfalls_exact(m, cl)
    tot = _segment_totals(attr)
    assert tot["prefill"] > 0 and tot["decode"] > 0
    assert tot["preempt_redo"] > 0
    tens = attr["tenants"]
    assert sum(t["requests"] for t in tens.values()) == m["finished"]
    for t in tens.values():
        assert t["bottleneck_counts"] and t["dominant"] in tobs.SEGMENTS


def test_attribution_pd_transfer_segment(traces):
    kw = dict(n_requests=16, rate=200.0, vocab=1000, mean_prompt=40,
              max_prompt=80, mean_output=30, max_output=60, seed=7)

    def ccfg(core):
        return core.ClusterCfg((_inst(core, "p0", role="prefill"),
                                _inst(core, "d0", role="decode")),
                               pd_map={"p0": ("d0",)})
    m, cl, rec = _run("torch", ccfg, _workload("torch", **kw),
                      traces["torch"])
    assert m["finished"] == 16
    attr = _assert_waterfalls_exact(m, cl)
    assert _segment_totals(attr)["pd_transfer"] > 0
    exports = [e for e in rec.events if e.kind == PD_EXPORT]
    admits = [e for e in rec.events if e.kind == PD_ADMIT]
    assert len(exports) == len(admits) == 16
    assert {e.inst for e in exports} == {"p0"}
    assert {e.inst for e in admits} == {"d0"}


def test_tracing_is_invisible_to_metrics(traces):
    kw = dict(n_requests=30, rate=150.0, vocab=1000, share_fraction=0.8,
              n_conversations=3, mean_prompt=50, max_prompt=100,
              mean_output=40, max_output=80, seed=11)

    def ccfg(core):
        return core.ClusterCfg(
            tuple(_inst(core, f"i{k}",
                        prefix_cache=core.PrefixCacheCfg(enabled=True))
                  for k in range(2)), router=core.RouterCfg("least_loaded"))
    reqs = _workload("torch", **kw)
    m_off, _, _ = _run("torch", ccfg, reqs, traces["torch"], traced=False)
    m_on, _, rec = _run("torch", ccfg, reqs, traces["torch"])
    assert rec.events
    on, off = dict(m_on), dict(m_off)
    assert on.pop("attribution")
    for d in (on, off):
        d.pop("sim_wall_s")
    i_on, i_off = on.pop("instances"), off.pop("instances")
    assert on == off
    assert i_on == i_off


def test_simulate_trace_path_and_cli_export(traces, tmp_path):
    """``simulate(trace=path)`` writes a valid Chrome trace, and ``python
    -m repro_torch.obs`` re-exports a saved event log and validates it."""
    reqs = _workload("torch", n_requests=10, rate=100.0, vocab=1000,
                     mean_prompt=30, max_prompt=60, mean_output=20,
                     max_output=40, seed=5)
    reg = tcore.TraceRegistry()
    reg.register(ARCH, traces["torch"])
    p = tmp_path / "out.json"
    m = tcore.simulate(tcore.ClusterCfg((_inst(tcore),)), reqs, traces=reg,
                       trace=str(p))
    assert m["finished"] == 10 and "attribution" in m
    assert tobs.validate_chrome_trace(json.loads(p.read_text())) == []
    rec = tobs.EventRecorder()
    tcore.simulate(tcore.ClusterCfg((_inst(tcore),)), reqs, traces=reg,
                   trace=rec)
    log = tmp_path / "events.json"
    rec.save(str(log))
    # each package loads the log
    for recorder in (tobs.EventRecorder, jobs.EventRecorder):
        loaded = recorder.load(str(log))
        assert [e.to_dict() for e in loaded.events] == \
            [e.to_dict() for e in rec.events]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tmp_path / "trace.json"
    for args in (["export", "--events", str(log), "--out", str(out)],
                 ["validate", str(out)]):
        r = subprocess.run([sys.executable, "-m", "repro_torch.obs", *args],
                           capture_output=True, text=True, env=env,
                           timeout=120)
        assert r.returncode == 0, r.stderr
    assert tobs.validate_chrome_trace(json.loads(out.read_text())) == []


# --------------------------------------------------------------------------
# the real engine's events
# --------------------------------------------------------------------------

def test_serve_driver_recorder_matches_jax_driver():
    """One engine each, the same weights and workload (arrivals at 0):
    the port's ``ServeDriver(recorder=)`` records the JAX driver's event
    kinds, order, instances and request ids; every event carries a wall
    stamp; the attribution rollup covers every request and its segments
    sum to each request's e2e on the real axis too."""
    import jax
    from repro.core.config import SchedulerCfg as JaxSchedulerCfg
    from repro.serve import DriverCfg as JaxDriverCfg
    from repro.serve import ServeDriver as JaxServeDriver
    from repro.serve import ServingEngine as JaxServingEngine
    from repro_torch.convert import params_from_numpy
    from repro_torch.serve import DriverCfg, ServeDriver, ServingEngine

    jcfg = dataclasses.replace(jax_get_config(ARCH), compute_dtype="float32",
                               kernels="reference")
    tcfg = dataclasses.replace(get_config(ARCH), compute_dtype="float32")
    sched = dict(max_batch_size=2, max_batch_tokens=64, chunked_prefill=True,
                 prefill_chunk=16)
    kw = dict(n_requests=4, rate=50.0, seed=3, mean_prompt=40, mean_output=5,
              sigma_prompt=0.4, sigma_output=0.3, max_prompt=80,
              max_output=6, share_fraction=0.0)
    jeng = JaxServingEngine(jcfg, max_batch=2, max_len=256, name="e0")
    teng = ServingEngine(
        tcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                       jeng.params)),
        max_batch=2, max_len=256, name="e0", device="cpu")
    recs = {"jax": jobs.EventRecorder(wall_clock=True),
            "torch": tobs.EventRecorder(wall_clock=True)}
    jdrv = JaxServeDriver([jeng], JaxDriverCfg(
        scheduler=JaxSchedulerCfg(**sched)), recorder=recs["jax"])
    tdrv = ServeDriver([teng], DriverCfg(
        scheduler=tcore.SchedulerCfg(**sched)), recorder=recs["torch"])
    runs = {}
    for pkg, drv in (("jax", jdrv), ("torch", tdrv)):
        reqs = _workload(pkg, vocab=jcfg.vocab, **kw)
        for r in reqs:
            r.arrival = 0.0
        runs[pkg] = drv.run(reqs, warmup=False)
    assert runs["torch"]["finished"] == runs["jax"]["finished"] == 4

    def shape(rec):
        return [(e.kind, e.inst, e.req, e.phase) for e in rec.events]
    assert shape(recs["torch"]) == shape(recs["jax"])
    assert all(e.wall is not None for e in recs["torch"].events)
    # each iteration carries its blocking waits, ending in one sync
    for e in recs["torch"].events:
        assert (e.host is not None) == (e.kind == "iter")
        if e.host is not None:
            assert set(e.host) == {"h2d", "d2h", "sync"}
            assert e.host["sync"] == 1 and e.host["h2d"] >= 1
    attr = runs["torch"]["attribution"]
    assert set(attr["requests"]) == {r.req_id for r in tdrv.finished}
    for row in attr["requests"].values():
        assert sum(row["segments"].values()) == pytest.approx(
            row["total_s"], rel=1e-9, abs=1e-12)


# --------------------------------------------------------------------------
# the recorder's clock and the iteration's wait counts
# --------------------------------------------------------------------------

HOST = {"h2d": 6, "d2h": 2, "sync": 1}


def test_epoch_ns_survives_save_load(tmp_path):
    rec = tobs.EventRecorder(wall_clock=True)
    rec.emit(0.5, "iter", inst="e0", dur=0.1, payload={"items": []},
             host=HOST)
    log = tmp_path / "events.json"
    rec.save(str(log))
    back = tobs.EventRecorder.load(str(log))
    assert back.epoch_ns == rec.epoch_ns
    assert back.events[0].host == HOST
    assert back.trace_ns(back.events[0].wall) == \
        rec.trace_ns(rec.events[0].wall)


def test_wall_maps_into_the_profiler_range_around_it():
    """An event emitted inside a ``record_function`` range maps, on the
    profiler's clock, inside that range within a millisecond."""
    from torch.profiler import ProfilerActivity, profile
    rec = tobs.EventRecorder(wall_clock=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("probe.iter"):
            time.sleep(0.001)
            rec.emit(0.0, "iter", inst="e0")
            time.sleep(0.001)
    (r,) = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "probe.iter"]
    at = rec.trace_ns(rec.events[0].wall)
    assert r.start_ns() - 1_000_000 <= at \
        <= r.start_ns() + r.duration_ns() + 1_000_000


def test_event_host_round_trips_and_stays_out_of_key():
    ev = tobs.Event(1.0, "iter", inst="e0", dur=0.5, wall=2.0,
                    payload={"items": [[0, "decode", 1]]}, host=HOST)
    d = ev.to_dict()
    assert d["host"] == HOST
    back = tobs.Event.from_dict(d)
    assert back.host == HOST and back.to_dict() == d
    bare = tobs.Event(1.0, "iter", inst="e0", dur=0.5, wall=3.0,
                      payload={"items": [[0, "decode", 1]]})
    assert bare.key() == ev.key()
    assert "host" not in bare.to_dict()
