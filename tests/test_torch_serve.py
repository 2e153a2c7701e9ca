"""The port's ``ServeDriver`` against the JAX ``ServeDriver`` end to end.

Same tiny model (the JAX engine's params carried across through numpy),
same workload, f32: the JAX engine runs ``kernels="reference"`` on its
contiguous cache, the port its paged cache on the CPU.  Both must make
identical scheduling decisions, emit identical tokens and finish every
request, under the engine-matched scheduler and under chunked prefill
(which runs prefill, extend and decode).
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


@pytest.mark.parametrize("chunked", [False, True])
def test_serve_driver_matches_jax_reference(chunked):
    jcfg = dataclasses.replace(jax_get_config(ARCH), compute_dtype="float32",
                               kernels="reference")
    tcfg = dataclasses.replace(get_config(ARCH), compute_dtype="float32")
    if chunked:
        kw = dict(max_batch_size=2, max_batch_tokens=64,
                  chunked_prefill=True, prefill_chunk=16)
        jsched, tsched = JaxSchedulerCfg(**kw), SchedulerCfg(**kw)
    else:
        jsched, tsched = jax_engine_scheduler_cfg(2), engine_scheduler_cfg(2)

    jeng = JaxServingEngine(jcfg, max_batch=2, max_len=256, name="e0")
    assert not jeng.paged
    teng = ServingEngine(
        tcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                       jeng.params)),
        max_batch=2, max_len=256, name="e0", device="cpu")
    jdrv = JaxServeDriver([jeng], JaxDriverCfg(scheduler=jsched))
    tdrv = ServeDriver([teng], DriverCfg(scheduler=tsched))
    jres, jtok, jdec = _run(jdrv, _workload(jax_generate, JaxShareGPTConfig,
                                            jcfg.vocab))
    tres, ttok, tdec = _run(tdrv, _workload(generate, ShareGPTConfig,
                                            tcfg.vocab))
    assert jres["finished"] == tres["finished"] == N
    assert tdec == jdec
    assert ttok == jtok
    phases = {w[1] for d in tdec for w in d}
    assert phases == {"prefill", "decode"}
