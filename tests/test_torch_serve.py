"""The port's ``ServeDriver`` against the JAX ``ServeDriver`` end to end.

Same tiny model (the JAX engine's params carried across through numpy),
same workload, f32: the JAX engine runs ``kernels="reference"`` on its
contiguous cache, the port its paged cache on the CPU.  Both must make
identical scheduling decisions, emit identical tokens and finish every
request, under the engine-matched scheduler and under chunked prefill
(which runs prefill, extend and decode), for a dense and a MoE model.
Under a replayed expert-routing trace the port's ``expert_load`` equals
the JAX engine's and the JAX simulator's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.config import SchedulerCfg as JaxSchedulerCfg  # noqa: E402
from repro.core.config import \
    engine_scheduler_cfg as jax_engine_scheduler_cfg  # noqa: E402
from repro.serve import DriverCfg as JaxDriverCfg  # noqa: E402
from repro.serve import ServeDriver as JaxServeDriver  # noqa: E402
from repro.serve import ServingEngine as JaxServingEngine  # noqa: E402
from repro.workload import ShareGPTConfig as JaxShareGPTConfig  # noqa: E402
from repro.workload import generate as jax_generate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.config import (SchedulerCfg,  # noqa: E402
                                     engine_scheduler_cfg)
from repro_torch.serve import DriverCfg, ServeDriver, ServingEngine  # noqa: E402
from repro_torch.workload import ShareGPTConfig, generate  # noqa: E402

ARCH = "llama3.1-8b-tiny"
MOE_ARCH = "phimini-moe-tiny"
N = 4


def _workload(gen, cfg_cls, vocab, seed=3):
    reqs = gen(cfg_cls(
        n_requests=N, rate=50.0, vocab=vocab, seed=seed,
        mean_prompt=40, mean_output=5, sigma_prompt=0.4, sigma_output=0.3,
        max_prompt=80, max_output=6, share_fraction=0.0))
    for r in reqs:
        r.arrival = 0.0
    return reqs


def _run(drv, reqs, name="e0"):
    res = drv.run(reqs, warmup=False)
    inst = drv.runtime.instances[name]
    return res, dict(inst.backend.out_tokens), list(inst.decisions)


def _schedulers(chunked):
    if chunked:
        kw = dict(max_batch_size=2, max_batch_tokens=64,
                  chunked_prefill=True, prefill_chunk=16)
        return JaxSchedulerCfg(**kw), SchedulerCfg(**kw)
    return jax_engine_scheduler_cfg(2), engine_scheduler_cfg(2)


def _engines(arch, jax_routing=None, routing=None):
    """The JAX reference engine and the port's on the CPU, same params."""
    jcfg = dataclasses.replace(jax_get_config(arch), compute_dtype="float32",
                               kernels="reference")
    tcfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    jeng = JaxServingEngine(jcfg, max_batch=2, max_len=256, name="e0",
                            routing=jax_routing)
    assert not jeng.paged
    teng = ServingEngine(
        tcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                       jeng.params)),
        max_batch=2, max_len=256, name="e0", device="cpu", routing=routing)
    return jeng, teng


def _matches_jax(arch, chunked):
    jsched, tsched = _schedulers(chunked)
    jeng, teng = _engines(arch)
    jdrv = JaxServeDriver([jeng], JaxDriverCfg(scheduler=jsched))
    tdrv = ServeDriver([teng], DriverCfg(scheduler=tsched))
    jres, jtok, jdec = _run(jdrv, _workload(jax_generate, JaxShareGPTConfig,
                                            jeng.cfg.vocab))
    tres, ttok, tdec = _run(tdrv, _workload(generate, ShareGPTConfig,
                                            teng.cfg.vocab))
    assert jres["finished"] == tres["finished"] == N
    assert tdec == jdec
    assert ttok == jtok
    phases = {w[1] for d in tdec for w in d}
    assert phases == {"prefill", "decode"}


@pytest.mark.parametrize("chunked", [False, True])
def test_serve_driver_matches_jax_reference(chunked):
    _matches_jax(ARCH, chunked)


@pytest.mark.parametrize("chunked", [False, True])
def test_moe_serve_driver_matches_jax_reference(chunked):
    _matches_jax(MOE_ARCH, chunked)


@pytest.mark.parametrize("chunked", [False, True])
def test_expert_load_parity_with_jax_engine_and_sim(chunked):
    """One replayed zipf trace (the port's copy of the generator gives the
    same bytes), three runs: the port's engine, the JAX engine and the
    JAX simulator report the same per-layer expert counts, tokens, drops
    and imbalance (``tests/test_expert_routing.py``'s parity, held by the
    port)."""
    from repro.core import ClusterCfg, MoECfg, RouterCfg
    from repro.core.cluster import Cluster
    from repro.moe import moe_layer_count, register_routing
    from repro.serve.driver import engine_instance_cfg as jax_icfg
    from repro.workload.expert_skew import SkewConfig as JaxSkew
    from repro.workload.expert_skew import synthesize_routing as jax_synth
    from repro_torch.core.config import MoECfg as TorchMoECfg
    from repro_torch.moe import register_routing as torch_register
    from repro_torch.runtime.backends.torch_engine import TorchBackend
    from repro_torch.serve.driver import engine_instance_cfg
    from repro_torch.workload.expert_skew import (SkewConfig,
                                                  synthesize_routing)

    cfg = jax_get_config(MOE_ARCH)
    L, E, k = moe_layer_count(cfg), cfg.moe.n_experts, cfg.moe.top_k
    skew = dict(kind="zipf", zipf_a=1.4, period=128, seed=7)
    jtrace = jax_synth(L, E, k, JaxSkew(**skew), model=cfg.name)
    ttrace = synthesize_routing(L, E, k, SkewConfig(**skew), model=cfg.name)
    assert ttrace.to_json() == jtrace.to_json()
    register_routing("port-parity-zipf", jtrace)
    torch_register("port-parity-zipf", ttrace)
    jsched, tsched = _schedulers(chunked)
    jeng, teng = _engines(MOE_ARCH, jax_routing=jtrace, routing=ttrace)
    # an instance config may name the trace the engine replays
    TorchBackend(teng, engine_instance_cfg(teng, tsched, moe=TorchMoECfg(
        routing_trace="port-parity-zipf")))
    tdrv = ServeDriver([teng], DriverCfg(scheduler=tsched))
    jdrv = JaxServeDriver([jeng], JaxDriverCfg(scheduler=jsched))
    tres, ttok, tdec = _run(tdrv, _workload(generate, ShareGPTConfig,
                                            cfg.vocab))
    jres, jtok, jdec = _run(jdrv, _workload(jax_generate, JaxShareGPTConfig,
                                            cfg.vocab))
    sim = Cluster(ClusterCfg(
        instances=(jax_icfg(jeng, jsched,
                            moe=MoECfg(routing_trace="port-parity-zipf")),),
        router=RouterCfg("round_robin")))
    sim.submit_workload(_workload(jax_generate, JaxShareGPTConfig,
                                  cfg.vocab))
    sres = sim.run()
    assert tres["finished"] == jres["finished"] == sres["finished"] == N
    assert ttok == jtok and tdec == jdec
    t = tres["instances"]["e0"]["expert_load"]
    for other in (jres, sres):
        o = other["instances"]["e0"]["expert_load"]
        assert t["counts"] == o["counts"]
        for key in ("tokens", "dropped", "routed", "hot_expert"):
            assert t[key] == o[key], key
        assert t["imbalance"] == pytest.approx(o["imbalance"])
        assert t["per_layer_imbalance"] == pytest.approx(
            o["per_layer_imbalance"])
    assert t["tokens"] > 0
    assert np.asarray(t["counts"]).sum() == t["tokens"] * k * L
    assert tres["expert_load"]["counts"] == t["counts"]


def test_backend_rejects_unreplayed_cfg_trace():
    """A cfg-named routing trace the engine does not replay, or a
    different one, fails loudly, as on the JAX backend."""
    from repro_torch.core.config import MoECfg
    from repro_torch.moe import moe_layer_count, register_routing
    from repro_torch.runtime.backends.torch_engine import TorchBackend
    from repro_torch.serve.driver import engine_instance_cfg
    from repro_torch.workload.expert_skew import (SkewConfig,
                                                  synthesize_routing)
    cfg = get_config(MOE_ARCH)

    def trace(seed):
        return synthesize_routing(moe_layer_count(cfg), cfg.moe.n_experts,
                                  cfg.moe.top_k, SkewConfig(seed=seed),
                                  model=cfg.name)
    register_routing("port-unreplayed", trace(7))
    icfg = engine_instance_cfg(
        ServingEngine(cfg, max_batch=2, max_len=64, device="cpu"),
        moe=MoECfg(routing_trace="port-unreplayed"))
    with pytest.raises(ValueError, match="replays no trace"):
        TorchBackend(ServingEngine(cfg, max_batch=2, max_len=64,
                                   device="cpu"), icfg)
    with pytest.raises(ValueError, match="different trace"):
        TorchBackend(ServingEngine(cfg, max_batch=2, max_len=64,
                                   device="cpu", routing=trace(99)), icfg)
