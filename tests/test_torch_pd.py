"""P/D disaggregation on the port against the JAX package.

A prefill engine copies a slot's KV out (``ServingEngine._export_slot``)
and a decode engine restores it into a free slot (``_restore_slot``), both
driven by ``TorchBackend.export_kv``/``import_kv`` under the copied
runtime's P/D orchestration.  Held against the JAX ``kernels="reference"``
engine on the same weights (f32, CPU): the payload, the tokens and the
scheduling decisions; and against the port's own simulator: the same
decisions for a unified and a P/D cluster with every arrival at t = 0.

Every arrival at 0 keeps a unified instance's decisions independent of the
latencies; under P/D the handoffs still land at times set by them, so the
P/D comparisons run batches of one: a decode instance then decodes the
handed-off requests one after another in the order their prefills ended,
whenever each one lands.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.config import SchedulerCfg as JaxSchedulerCfg  # noqa: E402
from repro.core.config import \
    engine_scheduler_cfg as jax_engine_scheduler_cfg  # noqa: E402
from repro.core.request import SimRequest as JaxSimRequest  # noqa: E402
from repro.runtime.backends.jax_engine import JaxBackend  # noqa: E402
from repro.runtime.scheduler import \
    ScheduledWork as JaxScheduledWork  # noqa: E402
from repro.serve import DriverCfg as JaxDriverCfg  # noqa: E402
from repro.serve import ServeDriver as JaxServeDriver  # noqa: E402
from repro.serve import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serve.driver import \
    engine_instance_cfg as jax_engine_instance_cfg  # noqa: E402
from repro.workload import ShareGPTConfig as JaxShareGPTConfig  # noqa: E402
from repro.workload import generate as jax_generate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import ClusterCfg, Cluster, RouterCfg  # noqa: E402
from repro_torch.core.config import (SchedulerCfg,  # noqa: E402
                                     engine_scheduler_cfg)
from repro_torch.core.request import SimRequest  # noqa: E402
from repro_torch.runtime.backends.torch_engine import TorchBackend  # noqa: E402
from repro_torch.runtime.scheduler import ScheduledWork  # noqa: E402
from repro_torch.serve import DriverCfg, ServeDriver, ServingEngine  # noqa: E402
from repro_torch.serve.driver import engine_instance_cfg  # noqa: E402
from repro_torch.workload import ShareGPTConfig, generate  # noqa: E402

ARCH = "llama3.1-8b-tiny"
N = 4
PD = {"p0": ("d0",)}


def _cfgs(arch=ARCH):
    jcfg = dataclasses.replace(jax_get_config(arch), compute_dtype="float32",
                               kernels="reference")
    tcfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    return jcfg, tcfg


def _jax_engine(jcfg, name="p0", role="prefill", params=None):
    eng = JaxServingEngine(jcfg, params, max_batch=2, max_len=256,
                           name=name, role=role)
    assert not eng.paged
    return eng


def _port_engine(tcfg, jeng, name="p0", role="prefill"):
    return ServingEngine(
        tcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                       jeng.params)),
        max_batch=2, max_len=256, name=name, role=role, device="cpu")


def _prompt(vocab, n, seed=5):
    return np.random.default_rng(seed).integers(0, vocab, n).tolist()


@pytest.mark.parametrize("n", [5, 64, 150])
def test_export_payload_matches_jax(n):
    """After one prefill of ``n`` tokens (one page, exactly a page, and
    three pages through two buckets), the port's payload holds the JAX
    engine's rows: same keys, bucket and shapes; the rows of the prompt
    equal within 1e-5 (rows past it are scratch on both sides).  Beside
    them the port tags the KV heads the payload holds: every head here,
    which is what the JAX payload holds."""
    jcfg, tcfg = _cfgs()
    jeng = _jax_engine(jcfg)
    teng = _port_engine(tcfg, jeng)
    toks = _prompt(jcfg.vocab, n)
    jb = JaxBackend(jeng, jax_engine_instance_cfg(jeng))
    tb = TorchBackend(teng, engine_instance_cfg(teng))
    jreq = JaxSimRequest(req_id=0, arrival=0.0, prompt_tokens=toks,
                         output_len=4)
    treq = SimRequest(req_id=0, arrival=0.0, prompt_tokens=toks,
                      output_len=4)
    jb.execute([JaxScheduledWork(jreq, n, "prefill")], 0.0)
    tb.execute([ScheduledWork(treq, n, "prefill")], 0.0)
    jkv = jeng._export_slot(jb._slot[0], n)
    tkv = teng._export_slot(tb._slot[0], n)
    assert tkv["_length"] == jkv["_length"] == n
    assert tkv["_length_bucket"] == jkv["_length_bucket"]
    assert set(tkv) == set(jkv) | {"_kv_heads"}
    KV = tcfg.n_kv_heads
    assert tkv["_kv_heads"] == (0, KV, KV)
    for key in (k for k in jkv if not k.startswith("_")):
        for name in ("k", "v"):
            want = np.asarray(jkv[key][name])
            got = tkv[key][name]
            assert got.device.type == "cpu"
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.numpy()[:, :n], want[:, :n],
                                       rtol=1e-5, atol=1e-5)


def _decode_tokens(backend, req, steps):
    for _ in range(steps):
        backend.execute([ScheduledWork(req, 1, "decode")], 0.0)
    return backend.out_tokens[req.req_id]


@pytest.mark.parametrize("n", [37, 130])
def test_export_restore_decodes_the_same_tokens(n):
    """Prefill on one engine, ``export_kv`` (slot freed, payload on the
    host, its byte count positive), ``import_kv`` into a decode engine
    sharing the weights whose slot was just used and freed, then decode:
    the tokens equal a unified engine's, which never moved its KV."""
    _, tcfg = _cfgs()
    uni = ServingEngine(tcfg, max_batch=2, max_len=256, device="cpu",
                        name="u0")
    pre = ServingEngine(tcfg, uni.params, max_batch=2, max_len=256,
                        device="cpu", name="p0", role="prefill")
    dec = ServingEngine(tcfg, uni.params, max_batch=2, max_len=256,
                        device="cpu", name="d0", role="decode")
    assert dec.params["embed"]["tok"] is uni.params["embed"]["tok"]
    toks = _prompt(tcfg.vocab, n)

    def req():
        return SimRequest(req_id=7, arrival=0.0, prompt_tokens=toks,
                          output_len=8)
    ub = TorchBackend(uni, engine_instance_cfg(uni))
    ureq = req()
    ub.execute([ScheduledWork(ureq, n, "prefill")], 0.0)
    want = list(_decode_tokens(ub, ureq, 6))

    pb = TorchBackend(pre, engine_instance_cfg(pre))
    db = TorchBackend(dec, engine_instance_cfg(dec))
    # the decode engine's slot held another request's KV and was freed
    other = SimRequest(req_id=1, arrival=0.0,
                       prompt_tokens=_prompt(tcfg.vocab, 200, seed=9),
                       output_len=2)
    db.execute([ScheduledWork(other, 200, "prefill")], 0.0)
    db.release(other)
    preq, dreq = req(), req()
    pb.execute([ScheduledWork(preq, n, "prefill")], 0.0)
    free_before = len(pre.slot_free)
    handoff = pb.export_kv(preq)
    assert len(pre.slot_free) == free_before + 1
    assert pb._carry_s > 0
    assert handoff.payload["len"] == n
    assert handoff.payload["first"] == want[0]
    kv = handoff.payload["kv"]
    assert handoff.nbytes == sum(t.nbytes for key, layer in kv.items()
                                 if not key.startswith("_")
                                 for t in layer.values()) > 0
    # the export's wall time rides on the next iteration, once
    carry = pb._carry_s
    assert pb.execute([], 0.0) >= carry
    assert pb._carry_s == 0.0
    db.import_kv(dreq, handoff)
    assert _decode_tokens(db, dreq, 6) == want


def _pd_schedulers(chunked):
    """(JAX, port) schedulers with batches of one (see the docstring)."""
    if chunked:
        kw = dict(max_batch_size=1, max_batch_tokens=64,
                  chunked_prefill=True, prefill_chunk=16)
        return JaxSchedulerCfg(**kw), SchedulerCfg(**kw)
    return jax_engine_scheduler_cfg(1), engine_scheduler_cfg(1)


def _pd_workload(gen, cfg_cls, vocab):
    reqs = gen(cfg_cls(
        n_requests=N, rate=50.0, vocab=vocab, seed=3,
        mean_prompt=40, mean_output=5, sigma_prompt=0.4, sigma_output=0.3,
        max_prompt=80, max_output=6, share_fraction=0.0))
    for r in reqs:
        r.arrival = 0.0
    return reqs


def _drive(drv, reqs):
    res = drv.run(reqs, warmup=False)
    insts = drv.runtime.instances
    return (res, {n: dict(i.backend.out_tokens) for n, i in insts.items()},
            {n: list(i.decisions) for n, i in insts.items()})


@pytest.mark.parametrize("chunked", [False, True])
def test_pd_serve_driver_matches_jax_reference(chunked):
    """``ServeDriver(pd_map=)``: one prefill and one decode engine sharing
    weights; tokens, decisions and finished counts equal the JAX
    driver's under both schedulers, and KV really crossed over."""
    jcfg, tcfg = _cfgs()
    jsched, tsched = _pd_schedulers(chunked)
    jp = _jax_engine(jcfg)
    jd = _jax_engine(jcfg, "d0", "decode", params=jp.params)
    tp = _port_engine(tcfg, jp)
    td = ServingEngine(tcfg, tp.params, max_batch=2, max_len=256,
                       name="d0", role="decode", device="cpu")
    jres, jtok, jdec = _drive(
        JaxServeDriver([jp, jd], JaxDriverCfg(scheduler=jsched), pd_map=PD),
        _pd_workload(jax_generate, JaxShareGPTConfig, jcfg.vocab))
    tres, ttok, tdec = _drive(
        ServeDriver([tp, td], DriverCfg(scheduler=tsched), pd_map=PD),
        _pd_workload(generate, ShareGPTConfig, tcfg.vocab))
    assert tres["finished"] == jres["finished"] == N
    assert tdec == jdec
    assert ttok == jtok
    assert {w[1] for d in tdec["p0"] for w in d} == {"prefill"}
    assert {w[1] for d in tdec["d0"] for w in d} == {"decode"}
    assert all(len(t) >= 2 for t in ttok["d0"].values())


@pytest.mark.parametrize("pd", [False, True])
def test_real_and_sim_make_the_same_decisions(pd):
    """The port's real engine and the port's simulator, one workload with
    every arrival at 0: the same decisions on every instance, unified and
    P/D (the port's twin of ``tests/test_runtime_parity.py``)."""
    _, tcfg = _cfgs()
    sched = _pd_schedulers(True)[1] if pd else SchedulerCfg(
        max_batch_size=2, max_batch_tokens=64, chunked_prefill=True,
        prefill_chunk=16)
    if pd:
        p0 = ServingEngine(tcfg, max_batch=2, max_len=256, name="p0",
                           role="prefill", device="cpu")
        engines = [p0, ServingEngine(tcfg, p0.params, max_batch=2,
                                     max_len=256, name="d0", role="decode",
                                     device="cpu")]
    else:
        engines = [ServingEngine(tcfg, max_batch=2, max_len=256, name="e0",
                                 device="cpu")]
    pd_map = PD if pd else None
    reqs = _pd_workload(generate, ShareGPTConfig, tcfg.vocab)
    real, _, real_dec = _drive(
        ServeDriver(engines, DriverCfg(scheduler=sched), pd_map=pd_map),
        reqs)
    sim = Cluster(ClusterCfg(
        instances=tuple(engine_instance_cfg(e, sched) for e in engines),
        router=RouterCfg("round_robin"), pd_map=pd_map))
    sim.submit_workload(_pd_workload(generate, ShareGPTConfig, tcfg.vocab))
    sres = sim.run()
    assert real["finished"] == sres["finished"] == N
    assert real_dec == {n: list(i.decisions)
                        for n, i in sim.instances.items()}


def test_serve_cli_pd(capsys):
    """``launch/serve.py --pd`` serves every request through a prefill and
    a decode engine."""
    from repro_torch.launch.serve import main
    main(["--pd", "--device", "cpu", "--n", "3", "--max-len", "128"])
    m = json.loads(capsys.readouterr().out)
    assert m["finished"] == 3
    assert set(m["instances"]) == {"p0", "d0"}
