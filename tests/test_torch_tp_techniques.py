"""P/D, the prefix store and speculative decoding at tp = 2 in the port.

``repro_torch.launch.mesh.run_ranks`` spawns two gloo ranks once for the
module; each serves, at tp = 2 and f32, on weights drawn by the JAX
package and carried over through numpy (``repro_torch.convert``):

* P/D (a prefill and a decode engine sharing the weights; rank r hands
  off to rank r): tiny llama, tiny phimini-moe (expert parallel), and tiny
  llama with one KV head, which both ranks hold;
* P/D between engines of different tp, 2 -> 1 (the prefill group
  all-gathers every KV head) and 1 -> 2 (each decode rank takes its own
  heads out of the full payload), the tp = 1 engine replicated on both
  ranks, for the same three models; and 2 -> 1 with the prefix store on
  the prefill engine and speculative decoding at k = 3 (replaying one
  acceptance trace) on the decode engine (tiny llama);
* the prefix store walking the device, host and SSD tiers (tiny llama);
* speculative decoding at k = 3 with an unrelated draft, greedy and
  replaying one acceptance trace (tiny llama).

Held to: the ranks alike; the port at tp = 1 (tokens, decisions, P/D
handoff bytes, ``kv_tiers`` counters, ``spec_decode``; a P/D pair of
different tp is the P/D run there); the JAX ``kernels="reference"``
engine at tp = 1 (tokens); the port's and the JAX simulators at each
engine's ``parallelism.tp`` (decisions, where they do not depend on
latencies: P/D at batches of one, the prefix store's phases far apart,
the replayed spec serve with every arrival at 0; a greedy spec serve's
acceptance has no simulated twin).  Tokens and decisions are compared
exactly, and f32 logits that differ in the last bits would show as a
different argmax.  The JAX package's own tp = 2 tests fail in this
repository's runs, so tp = 2 JAX is no reference.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
K = 3
PD = {"p0": ("d0",)}
#: P/D techniques -> the (prefill, decode) engines' tp on the ranks
PD_TP = {"pd": (2, 2), "pd-2to1": (2, 1), "pd-1to2": (1, 2),
         "pd-2to1-prefix-spec": (2, 1)}
TRACE = "tp-techniques-alpha0.6"
ACCEPTANCE = dict(alpha=0.6, k=K, period=64, seed=5)
# name -> (arch, config overrides)
VARIANTS = {"llama": ("llama3.1-8b-tiny", {}),
            "moe": ("phimini-moe-tiny", {}),
            "kv1": ("llama3.1-8b-tiny", {"n_kv_heads": 1})}
# (technique, variant); the JAX engine serves each of the tp = 1 runs but
# kv1 (whose tp = 1 tokens equal the port's, checked beside its handoff
# bytes)
RUNS = (("pd", "llama"), ("pd", "moe"), ("pd", "kv1"), ("prefix", "llama"),
        ("spec-greedy", "llama"), ("spec-replayed", "llama")) + tuple(
    (t, v) for t in ("pd-2to1", "pd-1to2") for v in VARIANTS) + (
    ("pd-2to1-prefix-spec", "llama"),)
ACROSS_TP = tuple(r for r in RUNS if PD_TP.get(r[0], (2, 2)) != (2, 2))


def _ref(run):
    """The run at tp = 1: a P/D pair of different tp is the P/D run."""
    return ("pd", run[1]) if run[0] in ("pd-2to1", "pd-1to2") else run


TP1_RUNS = tuple(r for r in RUNS if _ref(r) == r)
JAX_RUNS = tuple(r for r in TP1_RUNS if r[1] != "kv1")


def _cfg(get_config, variant, **kw):
    arch, over = VARIANTS[variant]
    return dataclasses.replace(get_config(arch), compute_dtype="float32",
                               **over, **kw)


# --------------------------------------------------------------------------
# one workload, scheduler and cache setup a technique, for every side
# --------------------------------------------------------------------------

def _workload(technique, vocab, cls, gen, gen_cfg):
    """Every arrival at 0 (P/D, spec), or two phases far apart (the
    prefix store), so the decisions do not depend on latencies."""
    if "prefix" in technique:
        # phase A fills the store with two 32-token prefixes, phase B hits
        # them after they spilled device -> host -> SSD
        reqs, rid = [], 0
        for arrival, n in ((0.0, 1), (1e6, 2)):
            for g in range(2):
                base = [(g * 977 + j * 13) % vocab for j in range(32)]
                for k in range(n):
                    tail = [(g * 31 + 53 * k + 1 + j + int(arrival > 0))
                            % vocab for j in range(8)]
                    reqs.append(cls(req_id=rid, arrival=arrival,
                                    prompt_tokens=base + tail, output_len=4))
                    rid += 1
        return reqs
    pd = technique in PD_TP
    reqs = gen(gen_cfg(
        n_requests=4 if pd else 6, rate=50.0, vocab=vocab,
        seed=3, mean_prompt=40 if pd else 30,
        mean_output=5 if pd else 8, sigma_prompt=0.4,
        sigma_output=0.3, max_prompt=80 if pd else 60,
        max_output=6 if pd else 10, share_fraction=0.0))
    for r in reqs:
        r.arrival = 0.0
    return reqs


def _sched(technique, cls, engine_cls):
    if technique == "prefix":
        return engine_cls(2)
    if technique in PD_TP:          # batches of one: handoffs land at
        return cls(max_batch_size=1, max_batch_tokens=64,  # latency-set
                   chunked_prefill=True, prefill_chunk=16)  # times
    return cls(max_batch_size=2, max_batch_tokens=64, chunked_prefill=True,
               prefill_chunk=16, decode_tokens=K + 1)


def _tiers(instances):
    """Three device blocks and one host block, spilling on to the SSD:
    phase A's prefixes walk device -> host -> SSD and phase B's hits bring
    them back.  In blocks, so tp = 1 and tp = 2 (whose blocks hold half
    the bytes) walk alike.  Instances without a prefix store keep none."""
    for inst in instances:
        if inst.cache is None:
            continue
        inst.cache.capacity_blocks = 3
        inst.cache.cfg = dataclasses.replace(inst.cache.cfg, ssd_spill=True)
        inst.mem.host.capacity = inst.mem.bytes_per_block


# --------------------------------------------------------------------------
# the port's serve (ranks and tp = 1) and the JAX engine's (tp = 1)
# --------------------------------------------------------------------------

def port_serve(run, job, group=None, device="cpu"):
    """Serve ``run`` = (technique, variant) on the port: what the tests
    compare, and the InstanceCfgs the simulators take."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.config import SchedulerCfg, engine_scheduler_cfg
    from repro_torch.serve import (DriverCfg, ServeDriver, ServingEngine,
                                   SpecDecodeCfg)
    from repro_torch.workload import ShareGPTConfig, generate
    from repro_torch.workload.acceptance import (AcceptanceConfig,
                                                 synthesize_acceptance)
    from repro_torch.workload.sharegpt import Request
    technique, variant = run
    cfg = _cfg(get_config, variant)
    params = params_from_numpy(job["params"][variant])
    kw = dict(max_batch=2, max_len=256, device=device)

    def ranks(tp):
        """An engine at ``tp`` on the ranks: in the group, or (tp = 1)
        replicated with the group as its handle; tp = 1 alone off them."""
        if group is None:
            return dict(tp=1)
        return dict(tp=tp, group=group) if tp > 1 else \
            dict(tp=1, replicas=group)

    def acceptance():
        return synthesize_acceptance(AcceptanceConfig(**ACCEPTANCE),
                                     model=cfg.name)
    pd_map = None
    if technique in PD_TP:
        ptp, dtp = PD_TP[technique]
        spec = SpecDecodeCfg(
            draft=cfg, k=K, acceptance=acceptance(),
            draft_params=params_from_numpy(job["draft"])) \
            if technique == "pd-2to1-prefix-spec" else None
        engines = [ServingEngine(cfg, params, name="p0", role="prefill",
                                 prefix_cache=spec is not None, **kw,
                                 **ranks(ptp)),
                   ServingEngine(cfg, params, name="d0", role="decode",
                                 spec=spec, **kw, **ranks(dtp))]
        pd_map = PD
    elif technique == "prefix":
        engines = [ServingEngine(cfg, params, name="e0", prefix_cache=True,
                                 **kw, **ranks(2))]
    else:
        trace = acceptance() if technique == "spec-replayed" else None
        spec = SpecDecodeCfg(draft=cfg, k=K, acceptance=trace,
                             draft_params=params_from_numpy(job["draft"]))
        engines = [ServingEngine(cfg, params, name="e0", spec=spec, **kw,
                                 **ranks(2))]
    drv = ServeDriver(engines, DriverCfg(scheduler=_sched(
        technique, SchedulerCfg, engine_scheduler_cfg)), pd_map=pd_map)
    if "prefix" in technique:
        _tiers(drv.runtime.instances.values())
    m = drv.run(_workload(technique, cfg.vocab, Request, generate,
                          ShareGPTConfig), warmup=False)
    insts = drv.runtime.instances
    out = {"finished": m["finished"],
           "tokens": {n: dict(i.backend.out_tokens)
                      for n, i in insts.items()},
           "decisions": {n: list(i.decisions) for n, i in insts.items()},
           "icfgs": [i.cfg for i in insts.values()],
           "network_bytes": m.get("network_bytes"),
           "kv_tiers": {n: s["kv_tiers"] for n, s in m["instances"].items()
                        if "kv_tiers" in s},
           "spec_decode": {n: s["spec_decode"]
                           for n, s in m["instances"].items()
                           if "spec_decode" in s}}
    if technique == "prefix":
        out["ssd_dir"] = engines[0].radix._ssd_dir
    if technique in PD_TP:
        out["kv_heads"] = {e.name: e.model.kv_heads() for e in engines}
    return out


def jax_serve(run, job):
    """The JAX ``kernels="reference"`` engine at tp = 1 on the same
    weights: (tokens by instance, decisions by instance, its InstanceCfgs
    for the JAX simulator)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.config import SchedulerCfg, SpecCfg
    from repro.core.config import engine_scheduler_cfg
    from repro.profiler import model_spec_from_arch
    from repro.serve import DriverCfg, ServeDriver, ServingEngine
    from repro.serve import SpecDecodeCfg
    from repro.serve.driver import engine_instance_cfg
    from repro.workload import ShareGPTConfig, generate
    from repro.workload.acceptance import (AcceptanceConfig,
                                           synthesize_acceptance)
    from repro.workload.sharegpt import Request
    technique, variant = run
    cfg = _cfg(get_config, variant, kernels="reference")
    params = jax.tree_util.tree_map(jnp.asarray, job["params"][variant])
    kw = dict(max_batch=2, max_len=256)
    sched = _sched(technique, SchedulerCfg, engine_scheduler_cfg)
    pd_map, spec_cfg, trace = None, None, None
    if technique in ("spec-replayed", "pd-2to1-prefix-spec"):
        from repro.spec import register_acceptance
        trace = synthesize_acceptance(AcceptanceConfig(**ACCEPTANCE),
                                      model=cfg.name)
        register_acceptance(TRACE, trace)
        spec_cfg = SpecCfg(enabled=True, k=K, acceptance_trace=TRACE,
                           draft=model_spec_from_arch(cfg))
    draft = jax.tree_util.tree_map(jnp.asarray, job["draft"])
    spec = SpecDecodeCfg(draft=cfg, k=K, acceptance=trace,
                         draft_params=draft)
    if technique == "pd":
        engines = [ServingEngine(cfg, params, name="p0", role="prefill",
                                 **kw),
                   ServingEngine(cfg, params, name="d0", role="decode",
                                 **kw)]
        pd_map = PD
    elif technique == "pd-2to1-prefix-spec":
        engines = [ServingEngine(cfg, params, name="p0", role="prefill",
                                 prefix_cache=True, **kw),
                   ServingEngine(cfg, params, name="d0", role="decode",
                                 spec=spec, **kw)]
        pd_map = PD
    elif technique == "prefix":
        engines = [ServingEngine(cfg, params, name="e0", prefix_cache=True,
                                 **kw)]
    else:
        engines = [ServingEngine(cfg, params, name="e0", **kw, spec=spec)]
    for e in engines:
        assert not e.paged
    drv = ServeDriver(engines, DriverCfg(scheduler=sched), pd_map=pd_map)
    if "prefix" in technique:
        _tiers(drv.runtime.instances.values())
    m = drv.run(_workload(technique, cfg.vocab, Request, generate,
                          ShareGPTConfig), warmup=False)
    insts = drv.runtime.instances
    icfgs = [engine_instance_cfg(e, sched, spec=spec_cfg if e.spec else None)
             for e in engines]
    return ({n: dict(i.backend.out_tokens) for n, i in insts.items()},
            {n: list(i.decisions) for n, i in insts.items()}, icfgs,
            m["finished"])


def _rank(group, job):
    """One rank: every run on the ranks, then a P/D pair of different tp
    whose tp = 1 engine has no replica handle."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.serve import ServeDriver, ServingEngine
    out = {"rank": group.rank, "runs": {}}
    for run in RUNS:
        out["runs"][run] = port_serve(run, job, group, group.device)
    cfg = _cfg(get_config, "llama")
    params = params_from_numpy(job["params"]["llama"])
    p0 = ServingEngine(cfg, params, max_batch=2, max_len=256, name="p0",
                       role="prefill", device=group.device, tp=group.size,
                       group=group)
    d0 = ServingEngine(cfg, params, max_batch=2, max_len=256, name="d0",
                       role="decode", device=group.device)
    try:
        ServeDriver([p0, d0], pd_map=PD)
    except ValueError as e:
        out["no_handle"] = str(e)
    # the spec step's guard: silent when the ranks agree, raising on every
    # rank when they do not
    group.check_equal([3, 1, -1], "equal values")
    try:
        group.check_equal([group.rank, 1], "rank ids")
    except RuntimeError as e:
        out["parted"] = str(e)
    return out


@pytest.fixture(scope="module")
def jx():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def served(jx):
    """The JAX weights (numpy), the two ranks' serves, the port's tp = 1
    serves and the JAX engine's."""
    from repro.configs import get_config as jax_get_config
    from repro.models import Model as JaxModel
    from repro_torch.launch.mesh import run_ranks

    def draw(variant, seed):
        jm = JaxModel(_cfg(jax_get_config, variant), remat=False)
        return jx.tree_util.tree_map(np.asarray,
                                     jm.init(jx.random.PRNGKey(seed)))
    job = {"params": {v: draw(v, i) for i, v in enumerate(VARIANTS)},
           "draft": draw("llama", 7)}
    ranks = run_ranks(_rank, 2, job, device="cpu", timeout_s=240)
    return {"job": job, "ranks": ranks,
            "tp1": {run: port_serve(run, job) for run in TP1_RUNS},
            "jax": {run: jax_serve(run, job) for run in JAX_RUNS}}


def _sim(pkg, icfgs, technique, vocab, pd_map):
    """The simulator of ``pkg`` (``repro_torch`` or the JAX package's
    ``repro``) on the run's workload: (its metrics, decisions by
    instance)."""
    import importlib
    core = importlib.import_module(f"{pkg}.core")
    cluster = importlib.import_module(f"{pkg}.core.cluster")
    workload = importlib.import_module(f"{pkg}.workload")
    sharegpt = importlib.import_module(f"{pkg}.workload.sharegpt")
    sim = cluster.Cluster(core.ClusterCfg(
        instances=tuple(icfgs), router=core.RouterCfg("round_robin"),
        pd_map=pd_map))
    if "prefix" in technique:
        _tiers(sim.instances.values())
    sim.submit_workload(_workload(technique, vocab, sharegpt.Request,
                                  workload.generate,
                                  workload.ShareGPTConfig))
    m = sim.run()
    return m, {n: list(i.decisions) for n, i in sim.instances.items()}


def _tps(run):
    """Each engine's tp on the ranks."""
    technique = run[0]
    return dict(zip(("p0", "d0"), PD_TP[technique])) \
        if technique in PD_TP else {"e0": 2}


@pytest.mark.parametrize("run", RUNS, ids=["-".join(r) for r in RUNS])
def test_tp2_tokens_and_decisions(served, run):
    """Both ranks emit the same tokens and make the same decisions, equal
    to the port's at tp = 1 and (but kv1) the JAX reference engine's at
    tp = 1; every request finishes."""
    r0, r1 = (r["runs"][run] for r in served["ranks"])
    tp1 = served["tp1"][_ref(run)]
    n = r0["finished"]
    assert n == r1["finished"] == tp1["finished"] > 0
    assert r0["tokens"] == r1["tokens"] == tp1["tokens"]
    assert r0["decisions"] == r1["decisions"] == tp1["decisions"]
    if _ref(run) in served["jax"]:
        jtok, jdec, _, jfin = served["jax"][_ref(run)]
        assert jfin == n
        assert r0["tokens"] == jtok and r0["decisions"] == jdec
    tps = _tps(run)
    for icfg in r0["icfgs"]:
        assert icfg.parallelism.tp == icfg.n_devices == tps[icfg.name]


def _jax_icfgs(served, run, port_icfgs):
    """The JAX engine's InstanceCfgs of the run at tp = 1 (kv1's: tiny
    llama's with kv1's model spec from the JAX profiler), each at the tp
    of the ranks' engine of its name."""
    from repro.configs import get_config
    from repro.core.config import ParallelismCfg
    from repro.profiler import model_spec_from_arch
    technique, variant = _ref(run)
    jrun = (technique, "llama" if variant == "kv1" else variant)
    model = model_spec_from_arch(_cfg(get_config, variant))
    tps = {i.name: i.parallelism.tp for i in port_icfgs}
    return [dataclasses.replace(i, model=model, n_devices=tps[i.name],
                                parallelism=ParallelismCfg(tp=tps[i.name]))
            for i in served["jax"][jrun][2]]


SIM_RUNS = tuple(r for r in RUNS if r[0] != "spec-greedy")


@pytest.mark.parametrize("run", SIM_RUNS,
                         ids=["-".join(r) for r in SIM_RUNS])
def test_tp2_decisions_equal_both_simulators(served, run):
    """The ranks' decisions equal the port's simulator's and the JAX
    simulator's at each engine's ``parallelism.tp`` (a replayed spec
    serve's accepted lengths too)."""
    from repro_torch.configs import get_config
    technique, variant = run
    vocab = _cfg(get_config, variant).vocab
    pd_map = PD if technique in PD_TP else None
    r0 = served["ranks"][0]["runs"][run]
    icfgs = r0["icfgs"]
    if technique in ("spec-replayed", "pd-2to1-prefix-spec"):
        from repro_torch.spec import register_acceptance
        from repro_torch.workload.acceptance import (AcceptanceConfig,
                                                     synthesize_acceptance)
        cfg = _cfg(get_config, variant)
        register_acceptance(TRACE, synthesize_acceptance(
            AcceptanceConfig(**ACCEPTANCE), model=cfg.name))
        icfgs = [dataclasses.replace(i, spec=dataclasses.replace(
            i.spec, acceptance_trace=TRACE)) if i.spec.enabled else i
            for i in icfgs]
    pm, pdec = _sim("repro_torch", icfgs, technique, vocab, pd_map)
    jm, jdec = _sim("repro", _jax_icfgs(served, run, icfgs), technique,
                    vocab, pd_map)
    assert pm["finished"] == jm["finished"] == r0["finished"]
    assert r0["decisions"] == pdec == jdec
    spec = sorted(r0["spec_decode"])
    assert spec == {"spec-replayed": ["e0"],
                    "pd-2to1-prefix-spec": ["d0"]}.get(technique, [])
    for name in spec:
        real = r0["spec_decode"][name]
        for m in (pm, jm):
            sim = m["instances"][name]["spec_decode"]
            assert [e[1:] for e in real["step_timeline"]] == \
                [e[1:] for e in sim["step_timeline"]]
            assert real["accepted_hist"] == sim["accepted_hist"]


PD_RUNS = tuple(r for r in RUNS if r[0] in ("pd", "pd-2to1", "pd-1to2"))


@pytest.mark.parametrize("run", PD_RUNS,
                         ids=[v if t == "pd" else f"{t}-{v}"
                              for t, v in PD_RUNS])
def test_tp2_pd_handoff_bytes_equal_tp1(served, run):
    """The handoffs carry tp = 1's bytes: equal on both ranks and to tp =
    1's payloads, a KV head that both ranks hold (kv1) counted once,
    whether a rank ships its own heads (same tp) or every head (a prefill
    group gathering them, or a replicated tp = 1 prefill engine); each
    tp = 2 engine's pools hold a rank's KV heads, a replica's all."""
    technique, variant = run
    r0, r1 = (r["runs"][run] for r in served["ranks"])
    tp1 = served["tp1"][_ref(run)]
    assert r0["network_bytes"] == r1["network_bytes"] \
        == tp1["network_bytes"]
    assert tp1["network_bytes"]["d0<->p0"] > 0
    # tiny llama and phimini-moe have 2 KV heads: one a rank; kv1's one
    # head is held by both
    KV = 1 if variant == "kv1" else 2
    assert tp1["kv_heads"] == {"p0": KV, "d0": KV}
    want = {n: 1 if tp == 2 else KV for n, tp in _tps(run).items()}
    assert r0["kv_heads"] == r1["kv_heads"] == want


def _assert_kv_tiers_equal_tp1(got, want):
    """Two ranks' KV-tier counters at tp = 2 against tp = 1's (the
    runtime prices a rank's share of a block's bytes, so the transfers'
    bytes are half of tp = 1's); the store walked device -> host -> SSD
    -> device and restored."""
    kv0, kv1 = got
    for key in ("residency_blocks", "hit_tokens", "restored_tokens",
                "restore_events", "tier_moves", "store_residency"):
        assert kv0[key] == kv1[key] == want[key], key
    assert kv0["transfers"] == kv1["transfers"]
    assert {p: t["blocks"] for p, t in kv0["transfers"].items()} == \
        {p: t["blocks"] for p, t in want["transfers"].items()}
    assert {p: 2 * t["bytes"] for p, t in kv0["transfers"].items()} == \
        {p: t["bytes"] for p, t in want["transfers"].items()}
    assert {"device->host", "host->ssd", "ssd->device"} <= \
        set(kv0["transfers"])
    assert kv0["restored_tokens"] > 0 and kv0["tier_moves"] > 0
    assert kv0["tier_move_s"] == kv1["tier_move_s"] > 0


def _assert_spec_decode_equal_tp1(got, want):
    """``spec_decode`` on both ranks equals tp = 1's (the step timeline's
    virtual times aside)."""
    assert want["steps"] > 0
    for sd in got:
        assert set(sd) == set(want)
        for key in want:
            if key == "step_timeline":
                assert [e[1:] for e in sd[key]] == \
                    [e[1:] for e in want[key]]
            else:
                assert sd[key] == want[key], key


def test_tp2_prefix_store_counters_equal_tp1(served):
    """The KV-tier counters equal tp = 1's (the runtime prices a rank's
    share of a block's bytes, so the transfers' bytes are half of tp =
    1's); the store walked device -> host -> SSD -> device and restored;
    each rank spilled into a directory of its own."""
    run = ("prefix", "llama")
    r0, r1 = (r["runs"][run] for r in served["ranks"])
    _assert_kv_tiers_equal_tp1([r["kv_tiers"]["e0"] for r in (r0, r1)],
                               served["tp1"][run]["kv_tiers"]["e0"])
    dirs = [r0["ssd_dir"], r1["ssd_dir"]]
    assert all(dirs) and dirs[0] != dirs[1]


@pytest.mark.parametrize("technique", ["spec-greedy", "spec-replayed"])
def test_tp2_spec_decode_metrics_equal_tp1(served, technique):
    """``spec_decode`` equals tp = 1's on both ranks (the step timeline's
    virtual times aside)."""
    run = (technique, "llama")
    _assert_spec_decode_equal_tp1(
        [r["runs"][run]["spec_decode"]["e0"] for r in served["ranks"]],
        served["tp1"][run]["spec_decode"]["e0"])


def test_pd_across_tp_prefix_store_and_spec_equal_tp1(served):
    """2 -> 1 with the prefix store on the tp = 2 prefill engine and a
    speculating replicated tp = 1 decode engine: the prefill side's
    KV-tier counters and the decode side's ``spec_decode`` equal tp =
    1's on both ranks; only the decode engine speculates."""
    run = ("pd-2to1-prefix-spec", "llama")
    r0, r1 = (r["runs"][run] for r in served["ranks"])
    tp1 = served["tp1"][run]
    assert set(tp1["kv_tiers"]) == set(r0["kv_tiers"]) == {"p0"}
    assert set(tp1["spec_decode"]) == set(r0["spec_decode"]) == {"d0"}
    _assert_kv_tiers_equal_tp1([r["kv_tiers"]["p0"] for r in (r0, r1)],
                               tp1["kv_tiers"]["p0"])
    _assert_spec_decode_equal_tp1([r["spec_decode"]["d0"] for r in (r0, r1)],
                                  tp1["spec_decode"]["d0"])


def test_pd_across_tp_needs_replica_handle(served):
    """A P/D pair of a tp = 2 prefill engine and a tp = 1 decode engine
    built without its replica handle raises ``ValueError`` through
    ``ServeDriver`` on both ranks, before any serve, naming the engine and
    the handle."""
    for r in served["ranks"]:
        msg = r["no_handle"]
        assert "tp=2" in msg and "tp=1" in msg and "'d0'" in msg
        assert "replicas=" in msg


def test_check_equal_raises_on_every_rank(served):
    """``EngineGroup.check_equal`` raises on both ranks when their values
    differ, naming what differs and every rank's values."""
    for r in served["ranks"]:
        assert r["parted"] == ("engine group: the ranks' rank ids differ: "
                               "[[0, 1], [1, 1]]")


def test_serve_cli_tp2_pd_prefix_spec(tmp_path):
    """``--tp 2`` with ``--pd``, ``--prefix-cache`` and ``--spec-k 2`` on
    the CPU: exits 0 (the CLI raises if the ranks' decisions differ) and
    finishes every request, the decode engine speculating."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--tp", "2", "--pd", "--prefix-cache", "--spec-k", "2", "--n", "4",
         "--max-len", "128"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env=env)
    assert res.returncode == 0, res.stderr
    m = json.loads(res.stdout)
    assert m["finished"] == 4
    assert m["instances"]["d0"]["spec_decode"]["steps"] > 0
    assert m["network_bytes"]["d0<->p0"] > 0


def test_owned_kv_heads_cover_each_head_once():
    """Over the ranks the owned KV heads cover every head once, for KV
    heads that divide tp, that do not, and that fewer than tp hold."""
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import kv_heads, owned_kv_heads
    for variant in VARIANTS:
        cfg = _cfg(get_config, variant)
        for tp in (1, 2, 4):
            if cfg.n_heads % tp:
                continue
            owned = []
            for r in range(tp):
                lo, hi = owned_kv_heads(cfg, r, tp)
                klo, khi = kv_heads(cfg, r, tp)
                assert klo <= lo <= hi <= khi
                owned += range(lo, hi)
            assert owned == list(range(cfg.n_kv_heads)), (variant, tp)


def _heads_cfg(KV):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3.1-8b-tiny"), n_heads=8,
                               n_kv_heads=KV)


@pytest.mark.parametrize("KV,tp", [(8, 2), (1, 2), (2, 4)])
def test_gather_take_kv_heads_round_trip(KV, tp):
    """Each rank's heads taken out of a full payload gather back into
    it, bit for bit."""
    from repro_torch.launch.sharding import gather_kv_heads, take_kv_heads
    cfg = _heads_cfg(KV)
    full = torch.randn((2, 32, KV, 16),
                       generator=torch.Generator().manual_seed(KV + tp))
    parts = [take_kv_heads(full, cfg, r, tp) for r in range(tp)]
    assert torch.equal(gather_kv_heads(parts, cfg, tp), full)


@pytest.mark.parametrize("KV,tp", [(8, 2), (1, 2), (2, 4)])
def test_gather_take_kv_heads_each_head_once(KV, tp):
    """A rank takes every head it reads (a shared one included), and the
    gather keeps each head once, in order, whatever the ranks hold."""
    from repro_torch.launch.sharding import (gather_kv_heads, kv_heads,
                                             take_kv_heads)
    cfg = _heads_cfg(KV)
    full = torch.arange(KV, dtype=torch.float32).reshape(1, 1, KV, 1) \
        .expand(3, 4, KV, 2)
    parts = []
    for r in range(tp):
        lo, hi = kv_heads(cfg, r, tp)
        part = take_kv_heads(full, cfg, r, tp)
        assert part[0, 0, :, 0].tolist() == list(range(lo, hi))
        parts.append(part.clone())
    got = gather_kv_heads(parts, cfg, tp)
    assert got.shape == (3, 4, KV, 2)
    assert got[0, 0, :, 0].tolist() == list(range(KV))
