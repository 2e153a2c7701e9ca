"""The port's simulator against the JAX package's.

``repro_torch.core.simulate`` runs the copied runtime over the copied
``SimBackend`` and ``PerfModel``: the same code on the same floats, so on
the Fig. 2 configurations (S(D), S(M) under a replayed zipf routing trace,
M(D), PD(D) and S(D)+PC) the metrics equal the JAX package's (``==``,
the simulator's own wall time aside) and every instance makes the same
decisions, with the fast path on and off.
"""
import dataclasses
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.common import \
    engine_matched_instance as jax_instance  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import ClusterCfg as JaxClusterCfg  # noqa: E402
from repro.core import MoECfg as JaxMoECfg  # noqa: E402
from repro.core import NetworkCfg as JaxNetworkCfg  # noqa: E402
from repro.core import RouterCfg as JaxRouterCfg  # noqa: E402
from repro.core import TraceRegistry as JaxTraceRegistry  # noqa: E402
from repro.core.cluster import Cluster as JaxCluster  # noqa: E402
from repro.hw import get_hw as jax_get_hw  # noqa: E402
from repro.hw import synthetic_trace as jax_synthetic_trace  # noqa: E402
from repro.moe import register_routing as jax_register  # noqa: E402
from repro.profiler.arch_spec import \
    model_spec_from_arch as jax_spec  # noqa: E402
from repro.workload import ShareGPTConfig as JaxShareGPTConfig  # noqa: E402
from repro.workload import generate as jax_generate  # noqa: E402
from repro.workload.expert_skew import SkewConfig as JaxSkew  # noqa: E402
from repro.workload.expert_skew import \
    synthesize_routing as jax_synth  # noqa: E402
from repro_torch.bench.common import (DENSE_TINY, MOE_TINY,  # noqa: E402
                                      engine_matched_instance)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ClusterCfg, MoECfg, NetworkCfg,  # noqa: E402
                              RouterCfg, TraceRegistry, simulate)
from repro_torch.core.cluster import Cluster  # noqa: E402
from repro_torch.hw import get_hw, synthetic_trace  # noqa: E402
from repro_torch.moe import moe_layer_count, register_routing  # noqa: E402
from repro_torch.profiler.arch_spec import model_spec_from_arch  # noqa: E402
from repro_torch.workload import ShareGPTConfig, generate  # noqa: E402
from repro_torch.workload.expert_skew import (SkewConfig,  # noqa: E402
                                              synthesize_routing)

CONFIGS = ("S(D)", "S(M)", "M(D)", "PD(D)", "S(D)+PC")
ROUTING = "port-sim-parity-zipf"


def _workload(gen, cfg_cls, vocab, share):
    """``benchmarks/fig2_fidelity.py``'s workload."""
    return gen(cfg_cls(
        n_requests=36, rate=8.0, vocab=vocab, seed=7, mean_prompt=90,
        mean_output=24, sigma_prompt=0.6, sigma_output=0.5, max_prompt=230,
        max_output=40, share_fraction=share, n_conversations=4))


def _cluster(config, arch, make, cluster_cls, net, router, moe_cls):
    """``benchmarks/fig2_fidelity.py``'s sim cluster of ``config``, built
    from one package's classes; S(M) replays the zipf trace."""
    pc = config.endswith("PC")
    if config.startswith("S"):
        insts = (make("e0", arch, prefix_cache=pc),)
        pd = None
    elif config.startswith("M"):
        insts = (make("e0", arch), make("e1", arch))
        pd = None
    else:
        insts = (make("p0", arch, role="prefill"),
                 make("d0", arch, role="decode"))
        pd = {"p0": ("d0",)}
    if config == "S(M)":
        insts = tuple(dataclasses.replace(i, moe=moe_cls(
            routing_trace=ROUTING)) for i in insts)
    return cluster_cls(instances=insts, router=router("round_robin"),
                       network=net(inter_instance_bw=16e9), pd_map=pd)


def _register_routing():
    cfg = get_config(MOE_TINY)
    args = (moe_layer_count(cfg), cfg.moe.n_experts, cfg.moe.top_k)
    skew = dict(kind="zipf", zipf_a=1.4, period=128, seed=7)
    jax_register(ROUTING, jax_synth(*args, JaxSkew(**skew),
                                    model=cfg.name))
    register_routing(ROUTING, synthesize_routing(*args, SkewConfig(**skew),
                                                 model=cfg.name))


def _strip(m):
    return {k: v for k, v in m.items() if k != "sim_wall_s"}


@pytest.mark.parametrize("fast_path", [True, False])
@pytest.mark.parametrize("config", CONFIGS)
def test_simulate_equals_jax(config, fast_path):
    arch = MOE_TINY if config.endswith("(M)") else DENSE_TINY
    _register_routing()
    jreg, treg = JaxTraceRegistry(), TraceRegistry()
    jreg.register(arch, jax_synthetic_trace(
        jax_get_hw("rtx3090"), jax_spec(jax_get_config(arch))).to_trace())
    treg.register(arch, synthetic_trace(
        get_hw("rtx3090"), model_spec_from_arch(get_config(arch)))
        .to_trace())
    share = 0.6 if config.endswith("PC") else 0.0
    vocab = get_config(arch).vocab
    jcfg = _cluster(config, arch, jax_instance, JaxClusterCfg,
                    JaxNetworkCfg, JaxRouterCfg, JaxMoECfg)
    tcfg = _cluster(config, arch, engine_matched_instance, ClusterCfg,
                    NetworkCfg, RouterCfg, MoECfg)
    jsim = JaxCluster(jcfg, traces=jreg, fast_path=fast_path)
    tsim = Cluster(tcfg, traces=treg, fast_path=fast_path)
    jsim.submit_workload(_workload(jax_generate, JaxShareGPTConfig, vocab,
                                   share))
    tsim.submit_workload(_workload(generate, ShareGPTConfig, vocab, share))
    jm, tm = jsim.run(), tsim.run()
    assert tm["finished"] == jm["finished"] == 36
    assert _strip(tm) == _strip(jm)
    assert {n: i.decisions for n, i in tsim.instances.items()} == \
        {n: i.decisions for n, i in jsim.instances.items()}
    if config == "S(M)":
        assert tm["expert_load"]["tokens"] > 0
    if config == "PD(D)":
        assert sum(tm["network_bytes"].values()) > 0
    if config.endswith("PC"):
        assert tm["instances"]["e0"]["prefix_cache"]["hits"] > 0
    # the module-level entry point runs the same cluster
    again = simulate(tcfg, _workload(generate, ShareGPTConfig, vocab, share),
                     traces=treg, fast_path=fast_path)
    assert _strip(again) == _strip(tm)


def test_simulate_refuses_what_is_not_ported(tmp_path):
    """Event tracing and speculative decoding were refused until ``obs/``
    and ``spec/`` were copied: ``simulate(trace=path)`` now writes a valid
    Chrome trace, and what the simulator still refuses is the JAX one's
    refusal: speculative decoding that names no acceptance trace."""
    import json
    from repro_torch.core import InstanceCfg, SpecCfg
    from repro_torch.core.config import H100
    from repro_torch.obs import validate_chrome_trace
    spec = model_spec_from_arch(get_config(DENSE_TINY))
    reqs = _workload(generate, ShareGPTConfig, get_config(DENSE_TINY).vocab,
                     0.0)
    plain = ClusterCfg(instances=(InstanceCfg(name="i0", hw=H100,
                                              model=spec),))
    out = tmp_path / "events.json"
    m = simulate(plain, reqs, trace=str(out))
    assert m["finished"] == len(reqs) and "attribution" in m
    assert validate_chrome_trace(json.loads(out.read_text())) == []
    specced = ClusterCfg(instances=(InstanceCfg(
        name="i0", hw=H100, model=spec, spec=SpecCfg(enabled=True)),))
    with pytest.raises(ValueError, match="acceptance_trace"):
        simulate(specced, reqs)
