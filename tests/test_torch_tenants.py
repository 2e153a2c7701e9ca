"""The port's tenants and SLO autoscaler against the JAX package's.

``repro_torch.workload.tenants`` and ``repro_torch.runtime.autoscale`` are
copies of the framework-free JAX modules.  The tenant mix must give the
same workload bytes; tenant-tagged requests under ``policy="priority"``
must make the same decisions and per-tenant rollup on the port's engine
(CPU, f32), the port's simulator and the JAX ``kernels="reference"``
engine; and the autoscaler's full loop must equal the JAX simulator's
(``autoscale`` action log and timeline, ``tenants``, decisions), in fast
and exact mode alike.  Equality is exact throughout.
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import ClusterCfg as JaxClusterCfg  # noqa: E402
from repro.core import InstanceCfg as JaxInstanceCfg  # noqa: E402
from repro.core import RouterCfg as JaxRouterCfg  # noqa: E402
from repro.core import SchedulerCfg as JaxSchedulerCfg  # noqa: E402
from repro.core import TenantClass as JaxTenantClass  # noqa: E402
from repro.core import TraceRegistry as JaxTraceRegistry  # noqa: E402
from repro.core.cluster import Cluster as JaxCluster  # noqa: E402
from repro.core.config import TPU_V5E as JAX_TPU_V5E  # noqa: E402
from repro.core.trace import Trace as JaxTrace  # noqa: E402
from repro.profiler import model_spec_from_arch as jax_spec  # noqa: E402
from repro.runtime import AutoscaleCfg as JaxAutoscaleCfg  # noqa: E402
from repro.runtime import SLOAutoscaler as JaxSLOAutoscaler  # noqa: E402
from repro.serve import DriverCfg as JaxDriverCfg  # noqa: E402
from repro.serve import ServeDriver as JaxServeDriver  # noqa: E402
from repro.serve import ServingEngine as JaxServingEngine  # noqa: E402
from repro.workload import tenants as jax_tenants  # noqa: E402
from repro.workload.sharegpt import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import (ClusterCfg, InstanceCfg, RouterCfg,  # noqa: E402
                              SchedulerCfg, TenantClass, TraceRegistry)
from repro_torch.core.cluster import Cluster  # noqa: E402
from repro_torch.core.config import TPU_V5E  # noqa: E402
from repro_torch.core.trace import Trace  # noqa: E402
from repro_torch.profiler import model_spec_from_arch  # noqa: E402
from repro_torch.runtime import AutoscaleCfg, SLOAutoscaler  # noqa: E402
from repro_torch.serve import (DriverCfg, ServeDriver,  # noqa: E402
                               ServingEngine)
from repro_torch.serve.driver import engine_instance_cfg  # noqa: E402
from repro_torch.workload import tenants  # noqa: E402
from repro_torch.workload.sharegpt import Request  # noqa: E402

ARCH = "llama3.1-8b-tiny"


class _Pkg:
    """One package's names, so each scenario is written once."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        self.TenantClass = JaxTenantClass if jax_side else TenantClass
        self.Request = JaxRequest if jax_side else Request
        self.tenants = jax_tenants if jax_side else tenants
        self.SchedulerCfg = JaxSchedulerCfg if jax_side else SchedulerCfg
        self.InstanceCfg = JaxInstanceCfg if jax_side else InstanceCfg
        self.ClusterCfg = JaxClusterCfg if jax_side else ClusterCfg
        self.RouterCfg = JaxRouterCfg if jax_side else RouterCfg
        self.Cluster = JaxCluster if jax_side else Cluster
        self.Trace = JaxTrace if jax_side else Trace
        self.TraceRegistry = JaxTraceRegistry if jax_side else TraceRegistry
        self.TPU_V5E = JAX_TPU_V5E if jax_side else TPU_V5E
        self.spec = jax_spec if jax_side else model_spec_from_arch
        self.get_config = jax_get_config if jax_side else get_config
        self.AutoscaleCfg = JaxAutoscaleCfg if jax_side else AutoscaleCfg
        self.SLOAutoscaler = JaxSLOAutoscaler if jax_side else SLOAutoscaler


JAX, PORT = _Pkg(True), _Pkg(False)


def _mix(pkg, arrival, n=40, seed=3):
    tc = pkg.TenantClass
    ts = pkg.tenants
    return ts.TenantWorkloadCfg(
        tenants=(
            ts.TenantSpec(tc("interactive", priority=10, slo_ttft_ms=500,
                             slo_tpot_ms=10, weight=3.0),
                          rate_share=2.0, mean_prompt=30, max_prompt=60,
                          mean_output=40, max_output=80),
            ts.TenantSpec(tc("batch", priority=0, slo_ttft_ms=10_000,
                             slo_tpot_ms=1000),
                          rate_share=1.0, mean_prompt=60, max_prompt=120,
                          mean_output=120, max_output=240)),
        n_requests=n, rate=100.0, arrival=arrival, seed=seed, vocab=1000)


@pytest.mark.parametrize("arrival", ["poisson", "gamma", "diurnal"])
def test_generate_tenants_bytes_equal_jax(arrival):
    got = tenants.workload_bytes(tenants.generate_tenants(
        _mix(PORT, arrival)))
    want = jax_tenants.workload_bytes(jax_tenants.generate_tenants(
        _mix(JAX, arrival)))
    assert got == want
    assert tenants.apportion(7, [2.0, 1.0, 1.0]) == \
        jax_tenants.apportion(7, [2.0, 1.0, 1.0]) == [3, 2, 2]


def _tenant_requests(pkg, vocab):
    """``tests/test_tenants.py``'s two-tenant workload, every arrival 0."""
    gold = pkg.TenantClass("gold", priority=10, slo_ttft_ms=500.0,
                           slo_tpot_ms=50.0, weight=3.0)
    free = pkg.TenantClass("free", priority=0, slo_ttft_ms=5000.0,
                           slo_tpot_ms=500.0, weight=1.0)
    rng = np.random.default_rng(7)
    reqs = []
    for i in range(6):
        tc = gold if i % 2 else free
        reqs.append(pkg.Request(
            req_id=i, arrival=0.0,
            prompt_tokens=rng.integers(0, vocab, 24 + 8 * i).tolist(),
            output_len=4 + i, tenant=tc.name, priority=tc.priority,
            weight=tc.weight, slo_ttft_ms=tc.slo_ttft_ms,
            slo_tpot_ms=tc.slo_tpot_ms))
    return reqs


def _priority_sched(pkg):
    return pkg.SchedulerCfg(max_batch_size=2, max_batch_tokens=1 << 16,
                            policy="priority", chunked_prefill=False,
                            prefill_exclusive=True)


def test_tenant_parity_sim_vs_real_engine():
    """The twin of ``tests/test_tenants.py::test_tenant_parity_sim_vs_real_
    engine`` on the port's engine (CPU, f32): its decisions and tenant
    rollup equal the port simulator's and the JAX reference engine's, and
    priority ordered its queue."""
    jcfg = dataclasses.replace(jax_get_config(ARCH), compute_dtype="float32",
                               kernels="reference")
    tcfg = dataclasses.replace(get_config(ARCH), compute_dtype="float32")
    jeng = JaxServingEngine(jcfg, max_batch=2, max_len=256, name="e0")
    jdrv = JaxServeDriver([jeng], JaxDriverCfg(scheduler=_priority_sched(JAX)))
    jax_real = jdrv.run(_tenant_requests(JAX, jcfg.vocab), warmup=False)
    jax_dec = {n: list(i.decisions) for n, i in jdrv.runtime.instances.items()}

    eng = ServingEngine(
        tcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                       jeng.params)),
        max_batch=2, max_len=256, name="e0", device="cpu")
    sched = _priority_sched(PORT)
    drv = ServeDriver([eng], DriverCfg(scheduler=sched))
    reqs = _tenant_requests(PORT, tcfg.vocab)
    real = drv.run(reqs, warmup=False)
    real_dec = {n: list(i.decisions) for n, i in drv.runtime.instances.items()}

    sim_cl = Cluster(ClusterCfg(instances=(engine_instance_cfg(eng, sched),),
                                router=RouterCfg("round_robin")))
    sim_cl.submit_workload(_tenant_requests(PORT, tcfg.vocab))
    sim = sim_cl.run()
    sim_dec = {n: list(i.decisions) for n, i in sim_cl.instances.items()}

    assert real_dec == sim_dec == jax_dec
    assert real["finished"] == sim["finished"] == jax_real["finished"] == 6
    for t in ("free", "gold"):
        for m in (real, sim, jax_real):
            assert m["tenants"][t]["submitted"] == 3
            assert m["tenants"][t]["finished"] == 3
    assert real["tenants"].keys() == sim["tenants"].keys() == {"free", "gold"}
    order = []
    for it in real_dec["e0"]:
        for rid, phase, _ in it:
            if phase == "prefill" and rid not in order:
                order.append(rid)
    tail_prio = [reqs[rid].priority for rid in order[1:]]
    assert tail_prio == sorted(tail_prio, reverse=True)


def _slow_trace(pkg):
    """Constant step latencies (``tests/test_fast_path.py``'s), so a queue
    forms and timing never reorders decisions."""
    t = pkg.Trace(model="m", hardware="h", tp=1)
    for b in (1, 2, 4, 8, 16):
        for ctx in (16, 256, 4096):
            t.add("iter", "decode", b, ctx, 0.005)
    for tok in (16, 64, 256, 1024):
        t.add("iter", "prefill", tok, tok, 0.01)
    reg = pkg.TraceRegistry()
    reg.register(ARCH, t)
    return reg


def _autoscale_run(pkg, fast: bool):
    spec = pkg.spec(pkg.get_config(ARCH))
    sched = pkg.SchedulerCfg(max_batch_size=4, max_batch_tokens=512,
                             policy="priority", share_guard_tokens=512)
    inst = pkg.InstanceCfg(name="i0", hw=pkg.TPU_V5E, model=spec,
                           n_devices=1, scheduler=sched, trace_name=ARCH)
    cl = pkg.Cluster(pkg.ClusterCfg((inst,),
                                    router=pkg.RouterCfg("least_loaded")),
                     traces=_slow_trace(pkg), fast_path=fast)
    cl.attach_autoscaler(pkg.SLOAutoscaler(pkg.AutoscaleCfg(
        interval_s=0.5, queue_high=2.0, queue_low=0.5, min_instances=1,
        max_instances=6)))
    wl = pkg.tenants.generate_tenants(_mix(pkg, "diurnal", n=60))
    cl.submit_workload([copy.deepcopy(r) for r in wl])
    m = cl.run()
    return m, {n: list(i.decisions) for n, i in cl.instances.items()}


def test_parity_autoscaler_full_loop():
    """The twin of ``tests/test_fast_path.py::test_parity_autoscaler_full_
    loop``: the port's cluster with ``SLOAutoscaler`` scales out under
    pressure and back in, and equals the JAX cluster in ``autoscale``
    (action log and timeline), ``tenants`` and decisions, in fast and
    exact mode, which equal each other."""
    runs = {(pkg.jax, fast): _autoscale_run(pkg, fast)
            for pkg in (JAX, PORT) for fast in (True, False)}
    m, dec = runs[(False, True)]
    assert m["finished"] == 60
    a = m["autoscale"]
    assert a["n_scale_out"] > 0 and a["n_scale_in"] > 0
    sizes = [n for _, n in a["timeline"]]
    assert max(sizes) > 1 and sizes[-1] < max(sizes)
    for key, (other, other_dec) in runs.items():
        assert other["autoscale"] == a, key
        assert other["tenants"] == m["tenants"], key
        assert other_dec == dec, key
