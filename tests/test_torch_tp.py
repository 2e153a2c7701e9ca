"""Tensor-parallel serving in the port: two gloo ranks on the CPU.

``repro_torch.launch.mesh.run_ranks`` spawns two ranks once for the module
(a ``FileStore`` rendezvous under a temporary directory, a timeout on the
join), each a process with its own shard.  Against the same weights (the
JAX engine's, through numpy, norms and biases perturbed so no zero-init
term hides) at f32:

* ``shard_params`` cut into two shards and concatenated back gives every
  leaf of both tiny models;
* tp = 2 prefill and decode logits equal tp = 1's on the port and the JAX
  ``kernels="reference"`` engine's at tp = 1 within 1e-5 (relative plus
  absolute), for llama3.1-8b-tiny, the same with one KV head (each rank
  keeps it), phimini-moe-tiny under expert parallelism (E4 -> E2 a rank)
  and with three experts (tensor parallelism inside each expert);
* a served workload makes the same decisions on both ranks, equal to the
  port simulator's at ``parallelism.tp == 2``, and the same tokens as
  tp = 1.

The JAX package's own tp = 2 tests are not used as the reference: they
fail in this repository's test runs.  JAX is imported inside the tests,
so the card-only test here runs where JAX is absent (``-m cuda``).
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
TOL = dict(rtol=1e-5, atol=1e-5)
# (name, arch, config overrides)
VARIANTS = (("llama", "llama3.1-8b-tiny", {}),
            ("llama-kv1", "llama3.1-8b-tiny", {"n_kv_heads": 1}),
            ("moe-ep", "phimini-moe-tiny", {}),
            ("moe-e3", "phimini-moe-tiny", {"n_experts": 3}))
PROMPTS = (16, 11)                    # slot 0 and slot 1 prompt lengths


def _cfg(get_config, arch, over, **kw):
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32",
                              **kw)
    if "n_experts" in over:
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=over["n_experts"]))
    return dataclasses.replace(cfg, **over)


def _noisy(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _noisy(v, rng, path + (k,)) for k, v in tree.items()}
    if any("norm" in k for k in path) or path[-1] in ("bq", "bk", "bv"):
        return (tree + 0.1 * rng.standard_normal(tree.shape)
                ).astype(tree.dtype)
    return tree


def _inputs(vocab):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, (1, n)).astype(np.int32)
               for n in PROMPTS]
    steps = rng.integers(0, vocab, (2, 2, 1)).astype(np.int32)
    return prompts, steps


def port_logits(eng, vocab):
    """Prefill both slots (bucket 16), then two decode steps: the list
    of logits arrays."""
    prompts, steps = _inputs(vocab)
    out = []
    for slot, p in enumerate(prompts):
        pad = np.zeros((1, 16), np.int32)
        pad[0, :p.shape[1]] = p
        logits, c1 = eng.model.prefill(
            eng.params, eng.tensor(pad), lengths=eng.tensor([p.shape[1]]))
        eng._write_slot_from_prefill(slot, c1, p.shape[1])
        out.append(logits.cpu().numpy())
    for tok in steps:
        for slot in range(2):
            eng.ensure_capacity(slot, int(eng.cache["lengths"][slot]) + 1)
        logits, eng.cache = eng.model.decode(eng.params, eng.cache,
                                             eng.tensor(tok))
        out.append(logits.cpu().numpy())
    return out


def _jax_logits(eng, vocab):
    """The same calls on the JAX reference engine (contiguous cache)."""
    import jax.numpy as jnp
    prompts, steps = _inputs(vocab)
    out = []
    for slot, p in enumerate(prompts):
        pad = np.zeros((1, 16), np.int32)
        pad[0, :p.shape[1]] = p
        logits, c1 = eng._jit_prefill(eng.params, jnp.asarray(pad),
                                      lengths=jnp.asarray([p.shape[1]]))
        eng._write_slot_from_prefill(slot, c1, p.shape[1])
        out.append(np.asarray(logits))
    for tok in steps:
        logits, eng.cache = eng._jit_decode(eng.params, eng.cache,
                                            jnp.asarray(tok))
        out.append(np.asarray(logits))
    return out


def _serve_requests(vocab):
    from repro_torch.workload import ShareGPTConfig, generate
    reqs = generate(ShareGPTConfig(
        n_requests=6, rate=50.0, vocab=vocab, seed=3, mean_prompt=40,
        mean_output=6, sigma_prompt=0.4, sigma_output=0.3, max_prompt=90,
        max_output=8, share_fraction=0.0))
    for r in reqs:
        r.arrival = 0.0    # decisions must not depend on latencies
    return reqs


def _scheduler():
    from repro_torch.core.config import SchedulerCfg
    return SchedulerCfg(max_batch_size=2, max_batch_tokens=64,
                        chunked_prefill=True, prefill_chunk=16)


def port_serve(cfg, params, group=None, device="cpu"):
    """Serve the workload: (tokens, decisions, finished, InstanceCfg)."""
    from repro_torch.serve import DriverCfg, ServeDriver, ServingEngine
    from repro_torch.serve.driver import engine_instance_cfg
    tp = 1 if group is None else group.size
    eng = ServingEngine(cfg, params, max_batch=2, max_len=256, name="e0",
                        device=device, tp=tp, group=group)
    drv = ServeDriver([eng], DriverCfg(scheduler=_scheduler()))
    m = drv.run(_serve_requests(cfg.vocab), warmup=False)
    inst = drv.runtime.instances["e0"]
    return (dict(inst.backend.out_tokens), list(inst.decisions),
            m["finished"], engine_instance_cfg(eng, _scheduler()))


def _tp_rank(group, job):
    """One rank: every variant's logits, and the two serves."""
    from repro_torch.configs import get_config
    from repro_torch.serve import ServingEngine
    out = {"rank": group.rank, "backend": group.backend, "logits": {},
           "serve": {}}
    for name, arch, over in VARIANTS:
        cfg = _cfg(get_config, arch, over)
        eng = ServingEngine(cfg, job["params"][name], max_batch=2,
                            max_len=128, tp=group.size, group=group)
        out["logits"][name] = port_logits(eng, cfg.vocab)
        out.setdefault("kv_heads", {})[name] = \
            eng.cache["stage0"]["k_pages"].shape[-2]
    for name in ("llama", "moe-ep"):
        arch = dict((n, a) for n, a, _ in VARIANTS)[name]
        cfg = _cfg(get_config, arch, {})
        out["serve"][name] = port_serve(cfg, job["params"][name], group,
                                        group.device)
    return out


def _jax_engine_and_params(name, arch, over):
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.serve import ServingEngine as JaxServingEngine
    jcfg = _cfg(jax_get_config, arch, over, kernels="reference")
    seed = [v[0] for v in VARIANTS].index(name)
    jeng = JaxServingEngine(jcfg, max_batch=2, max_len=128, seed=seed)
    np_params = _noisy(jax.tree_util.tree_map(np.asarray, jeng.params),
                       np.random.default_rng(11))
    jeng.params = jax.tree_util.tree_map(jax.numpy.asarray, np_params)
    return jeng, np_params


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """Two gloo ranks, one spawn for the module; the JAX engines and the
    numpy params they share with the port."""
    from repro_torch.launch.mesh import run_ranks
    jax_engines, params = {}, {}
    for name, arch, over in VARIANTS:
        jax_engines[name], params[name] = _jax_engine_and_params(name, arch,
                                                                 over)
    ranks = run_ranks(_tp_rank, 2, {"params": params}, device="cpu",
                      timeout_s=240)
    return {"ranks": ranks, "jax": jax_engines, "params": params}


@pytest.mark.parametrize("name,arch,over", VARIANTS)
def test_shard_params_concatenate_back(name, arch, over):
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import shard_params
    from repro_torch.models import Model
    cfg = _cfg(get_config, arch, over)
    full = Model(cfg).init(torch.Generator().manual_seed(0))
    shards = [shard_params(full, r, 2, cfg=cfg) for r in range(2)]

    def walk(f, s0, s1, path):
        if isinstance(f, dict):
            for k in f:
                walk(f[k], s0[k], s1[k], path + (k,))
            return
        if s0.shape == f.shape:          # replicated (or one KV head each)
            assert torch.equal(s0, f) and torch.equal(s1, f), path
            return
        dim = next(i for i, (a, b) in enumerate(zip(s0.shape, f.shape))
                   if a != b)
        assert torch.equal(torch.cat([s0, s1], dim=dim), f), path
        assert s0.untyped_storage().data_ptr() != \
            f.untyped_storage().data_ptr(), path
    walk(full, *shards, ())
    np_full = {"head": {"w": full["head"]["w"].numpy()}}
    np_shard = shard_params(np_full, 1, 2, cfg=cfg)["head"]["w"]
    assert isinstance(np_shard, np.ndarray) and np_shard.flags.c_contiguous
    assert np.array_equal(np_shard, np_full["head"]["w"][:, 128:])


@pytest.mark.parametrize("name", [v[0] for v in VARIANTS])
def test_tp2_logits_equal_tp1_and_jax(tp2, name):
    """f32: tp = 2 prefill and decode logits equal tp = 1 on the port and
    the JAX reference engine at tp = 1 within 1e-5; both ranks hold the
    same full logits."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.serve import ServingEngine
    arch, over = {v[0]: v[1:] for v in VARIANTS}[name]
    cfg = _cfg(get_config, arch, over)
    eng = ServingEngine(cfg, params_from_numpy(tp2["params"][name]),
                        max_batch=2, max_len=128, device="cpu")
    want = port_logits(eng, cfg.vocab)
    jax_want = _jax_logits(tp2["jax"][name], cfg.vocab)
    r0, r1 = (r["logits"][name] for r in tp2["ranks"])
    assert len(r0) == len(want) == len(jax_want) == 4
    for got, other, w, jw in zip(r0, r1, want, jax_want):
        assert np.array_equal(got, other)
        np.testing.assert_allclose(got, w, **TOL)
        np.testing.assert_allclose(got, jw, **TOL)
    # each rank's pools hold only the KV heads its query heads read
    kv = {r["rank"]: r["kv_heads"][name] for r in tp2["ranks"]}
    assert kv == {0: 1, 1: 1}


@pytest.mark.parametrize("name", ["llama", "moe-ep"])
def test_tp2_decisions_equal_ranks_and_sim(tp2, name):
    """Both ranks make the same decisions, equal to the port simulator's
    at ``parallelism.tp == 2``; the tokens equal tp = 1's."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import ClusterCfg, RouterCfg
    from repro_torch.core.cluster import Cluster
    arch = {v[0]: v[1] for v in VARIANTS}[name]
    cfg = _cfg(get_config, arch, {})
    (tok0, dec0, fin0, icfg), (tok1, dec1, fin1, _) = \
        (r["serve"][name] for r in tp2["ranks"])
    assert fin0 == fin1 == 6
    assert dec0 == dec1 and tok0 == tok1
    assert icfg.parallelism.tp == 2 and icfg.n_devices == 2
    sim = Cluster(ClusterCfg(instances=(icfg,),
                             router=RouterCfg("round_robin")))
    sim.submit_workload(_serve_requests(cfg.vocab))
    assert sim.run()["finished"] == 6
    assert list(sim.instances["e0"].decisions) == dec0
    tok_tp1, dec_tp1, _, _ = port_serve(
        cfg, params_from_numpy(tp2["params"][name]))
    assert tok0 == tok_tp1 and dec0 == dec_tp1
    assert all(r["backend"] == "gloo" for r in tp2["ranks"])


def _cli(module, args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", f"repro_torch.{module}",
                           *args], capture_output=True, text=True,
                          timeout=300, cwd=cwd, env=env)


def test_serve_cli_tp2_on_the_cpu(tmp_path):
    res = _cli("launch.serve", ["--tp", "2", "--device", "cpu", "--n", "4",
                                "--chunked-prefill"], tmp_path)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout)["finished"] == 4


def test_measured_profile_tp_1_2(tmp_path, capsys):
    """A measured CPU profile at ``--tp 1,2`` writes both grids on the
    same buckets, each point positive."""
    from repro_torch.hw import HardwareRegistry
    from repro_torch.profiler.__main__ import main
    out = tmp_path / "cpu.json"
    summary = main(["profile", "--device", "cpu-engine", "--engine-device",
                    "cpu", "--arch", "llama3.1-8b-tiny", "--tp", "1,2",
                    "--max-batch", "2", "--max-len", "128", "--reps", "1",
                    "--prefill-buckets", "16,32", "--decode-ctxs", "32",
                    "--extend-ctxs", "16", "--extend-suffixes", "16",
                    "--out", str(out)])
    capsys.readouterr()
    hwt = HardwareRegistry().load_file(str(out))
    assert summary["tp_degrees"] == hwt.tp_degrees() == [1, 2]

    def keys(tp):
        return sorted((p.op, p.phase, p.tokens, p.context)
                      for p in hwt.grid(tp))
    assert keys(1) == keys(2) and len(keys(1)) > 0
    assert all(p.latency_s > 0 for tp in (1, 2) for p in hwt.grid(tp))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _card_rank(group, params):
    from repro_torch.configs import get_config
    from repro_torch.serve import ServingEngine
    cfg = _cfg(get_config, "llama3.1-8b-tiny", {})
    eng = ServingEngine(cfg, params, max_batch=2, max_len=128,
                        tp=group.size, group=group)
    return group.backend, str(eng.device), port_logits(eng, cfg.vocab)


@pytest.mark.cuda
def test_tp2_two_ranks_on_one_card(card):
    """Two ranks sharing the card over gloo (CUDA tensors through the
    collectives): f32 logits equal tp = 1 on the card within 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import Model
    from repro_torch.serve import ServingEngine
    cfg = _cfg(get_config, "llama3.1-8b-tiny", {})
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    want = port_logits(ServingEngine(cfg, params, max_batch=2, max_len=128,
                                     device=card), cfg.vocab)
    ranks = run_ranks(_card_rank, 2, params, device="cuda",
                      devices=["cuda:0", "cuda:0"], timeout_s=300)
    for backend, dev, got in ranks:
        assert backend == "gloo" and dev == "cuda:0"
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
