"""Speculative decoding on the port against the JAX package.

``Model.verify`` (extend returning every position's logits) against the
JAX model on the same params (f32, the tolerance of
``tests/test_torch_model.py``); the port's engine (draft engine, batched
verify, accept, roll back) against vanilla greedy decode, against the
port's simulator on one acceptance trace, and against the JAX
``kernels="reference"`` engine on the same target and draft weights (same
tokens, decisions and ``spec_decode`` metrics, greedy and replayed); the
copied ``spec/`` and ``workload/acceptance.py`` give the JAX package's
bytes; the bad configurations fail as in JAX.  Card only (``-m cuda``):
the verify shape of the paged extend kernel against its plain version.

The JAX side is imported inside the tests that need it, so the card tests
run on a machine without JAX.
"""
import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ClusterCfg, RouterCfg, SpecCfg  # noqa: E402
from repro_torch.core.cluster import Cluster  # noqa: E402
from repro_torch.core.config import SchedulerCfg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.profiler import model_spec_from_arch  # noqa: E402
from repro_torch.serve import (DriverCfg, ServeDriver,  # noqa: E402
                               ServingEngine, SpecDecodeCfg)
from repro_torch.serve.driver import engine_instance_cfg  # noqa: E402
from repro_torch.spec import (AcceptanceTrace,  # noqa: E402
                              register_acceptance)
from repro_torch.workload import ShareGPTConfig, generate  # noqa: E402
from repro_torch.workload.acceptance import (  # noqa: E402
    AcceptanceConfig, synthesize_acceptance)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3.1-8b-tiny"
K = 3
TOL = dict(rtol=2e-5, atol=2e-5)


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _workload(vocab, n=5, seed=3, mean_output=8, gen=generate,
              cfg_cls=ShareGPTConfig):
    reqs = gen(cfg_cls(
        n_requests=n, rate=50.0, vocab=vocab, seed=seed,
        mean_prompt=30, mean_output=mean_output, sigma_prompt=0.4,
        sigma_output=0.3, max_prompt=60, max_output=10,
        share_fraction=0.0))
    for r in reqs:
        r.arrival = 0.0     # decisions must not depend on latencies
    return reqs


def _sched(decode_tokens=1, cls=SchedulerCfg):
    return cls(max_batch_size=2, max_batch_tokens=64, chunked_prefill=True,
               prefill_chunk=16, decode_tokens=decode_tokens)


# --------------------------------------------------------------------------
# Model.verify against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, "phimini-moe-tiny"])
def test_verify_logits_match_jax(arch):
    """A prefill, then one verify of S = 4 tokens per row from ragged
    starts (one crossing a 16-token page, one with a pad tail): the logits
    at every position equal the JAX model's, and the cache lengths are the
    starts plus the real tokens."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import Model as JaxModel
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import Model

    jcfg = _f32(jax_get_config(arch))
    tcfg = _f32(get_config(arch))
    rng = np.random.default_rng(21)
    jm = JaxModel(jcfg, remat=False)
    np_params = jax.tree_util.tree_map(np.asarray,
                                       jm.init(jax.random.PRNGKey(2)))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tm = Model(tcfg, page_size=16)
    tp = params_from_numpy(np_params)

    B, S, max_len = 2, 32, 96
    lengths = np.array([14, 21], np.int32)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    _, cj = jm.prefill(jp, jnp.asarray(tokens), lengths=jnp.asarray(lengths))
    _, ct = tm.prefill(tp, torch.from_numpy(tokens),
                       lengths=torch.from_numpy(lengths))
    big = jm.init_cache(B, max_len)
    for key in cj:
        if key != "lengths":
            big[key] = {n: big[key][n].at[:, :, :S].set(cj[key][n])
                        for n in ("k", "v")}
    big["lengths"] = jnp.asarray(lengths)
    paged = tm.init_cache(B, max_len)
    maxp, n_pages = tm.page_geometry(B, max_len)
    table = torch.from_numpy(rng.permutation(n_pages - 1)[: B * maxp]
                             .reshape(B, maxp).astype(np.int32))
    paged["block_table"] = table
    pos = torch.arange(S)
    for key, stage in paged.items():
        if key in ("lengths", "block_table"):
            continue
        for b in range(B):
            page = table[b, pos // 16].long()
            stage["k_pages"][:, page, pos % 16] = ct[key]["k"][:, b]
            stage["v_pages"][:, page, pos % 16] = ct[key]["v"][:, b]
    paged["lengths"] = torch.from_numpy(lengths)

    n_new = np.array([4, 2], np.int32)
    vt = rng.integers(0, jcfg.vocab, (B, 4)).astype(np.int32)
    lj, nj = jm.verify(jp, big, jnp.asarray(vt), jnp.asarray(n_new))
    lt, nt = tm.verify(tp, paged, torch.from_numpy(vt),
                       torch.from_numpy(n_new))
    assert tuple(lt.shape) == (B, 4, tcfg.padded_vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert nt["lengths"].tolist() == np.asarray(nj["lengths"]).tolist() \
        == (lengths + n_new).tolist()
    # extend's logits are verify's at each row's last real token
    le, _ = tm.extend(tp, dict(paged, lengths=torch.from_numpy(lengths)),
                      torch.from_numpy(vt), torch.from_numpy(n_new))
    for b in range(B):
        np.testing.assert_allclose(le[b, 0].numpy(),
                                   lt[b, n_new[b] - 1].numpy(), **TOL)


# --------------------------------------------------------------------------
# greedy losslessness and sim/real parity on the port
# --------------------------------------------------------------------------

def _serve(cfg, reqs, spec, sched=None, max_len=256, params=None):
    eng = ServingEngine(cfg, params, max_batch=2, max_len=max_len, name="e0",
                        seed=0, spec=spec, device="cpu")
    sched = sched or _sched((spec.k + 1) if spec else 1)
    drv = ServeDriver([eng], DriverCfg(scheduler=sched))
    m = drv.run([copy.deepcopy(r) for r in reqs], warmup=False)
    be = drv.runtime.instances["e0"].backend
    return m, {rid: list(t) for rid, t in be.out_tokens.items()}, be, drv


def test_greedy_losslessness_real_engine():
    """Speculative decode emits vanilla greedy decode's tokens exactly,
    with a perfect draft (the target's own weights: every proposal
    accepted) and with an unrelated one (almost none), in f32."""
    cfg = _f32(get_config(ARCH))
    reqs = _workload(cfg.vocab)
    m0, vanilla, _, _ = _serve(cfg, reqs, None)
    m1, perfect, be1, _ = _serve(cfg, reqs,
                                 SpecDecodeCfg(draft=cfg, k=K, draft_seed=0))
    m2, unrelated, be2, _ = _serve(cfg, reqs,
                                   SpecDecodeCfg(draft=cfg, k=K,
                                                 draft_seed=7))
    assert m0["finished"] == m1["finished"] == m2["finished"] == len(reqs)
    assert vanilla == perfect == unrelated
    for r in reqs:
        assert len(vanilla[r.req_id]) == r.output_len
    sd1 = be1.spec_tracker.metrics()
    sd2 = be2.spec_tracker.metrics()
    assert sd1["acceptance_rate"] == 1.0
    assert sd2["acceptance_rate"] < 0.2
    assert sd1["steps"] < sd2["steps"]
    assert sd2["wasted_draft_tokens"] > sd1["wasted_draft_tokens"]


def _parity_pair(name, alpha, seed, reqs, max_len=256):
    cfg = get_config(ARCH)
    trace = synthesize_acceptance(
        AcceptanceConfig(alpha=alpha, k=K, period=64, seed=seed),
        model=cfg.name)
    register_acceptance(name, trace)
    sched = _sched(K + 1)
    m, toks, be, drv = _serve(
        cfg, reqs, SpecDecodeCfg(draft=cfg, k=K, acceptance=trace,
                                 draft_seed=7), sched, max_len=max_len)
    icfg = engine_instance_cfg(
        drv.runtime.instances["e0"].backend.eng, sched,
        spec=SpecCfg(enabled=True, k=K, acceptance_trace=name,
                     draft=model_spec_from_arch(cfg)))
    sim = Cluster(ClusterCfg(instances=(icfg,),
                             router=RouterCfg("round_robin")))
    sim.submit_workload([copy.deepcopy(r) for r in reqs])
    return m, toks, drv, sim.run(), sim


@pytest.mark.parametrize("tail", [False, True])
def test_sim_real_spec_decode_parity(tail):
    """One acceptance trace, the port's engine and the port's simulator:
    the same per-step accepted counts, ``spec_decode`` rollups and
    decisions.  ``tail``: outputs of 1 to 4 tokens with k = 3, so every
    step is clamped near the output budget on both sides."""
    cfg = get_config(ARCH)
    if tail:
        reqs = _workload(cfg.vocab, n=6, seed=13, mean_output=2)
        for r in reqs:
            r.output_len = min(r.output_len, 4)
    else:
        reqs = _workload(cfg.vocab, n=6)
    real, toks, drv, sim, sim_cluster = _parity_pair(
        f"port-parity-{tail}", 0.9 if tail else 0.6, 8 if tail else 5,
        reqs, max_len=128 if tail else 256)
    assert real["finished"] == sim["finished"] == len(reqs)
    r = real["instances"]["e0"]["spec_decode"]
    s = sim["instances"]["e0"]["spec_decode"]
    assert r["steps"] == s["steps"] > 0
    for key in ("k", "proposed_tokens", "accepted_tokens",
                "emitted_tokens", "acceptance_rate", "mean_accepted_len",
                "wasted_draft_tokens", "accepted_hist"):
        assert r[key] == s[key], key
    assert [(p, a) for _, p, a in r["step_timeline"]] == \
        [(p, a) for _, p, a in s["step_timeline"]]
    assert list(drv.runtime.instances["e0"].decisions) == \
        list(sim_cluster.instances["e0"].decisions)
    for req in reqs:
        assert len(toks[req.req_id]) == req.output_len
    if tail:
        assert r["proposed_tokens"] < r["steps"] * K
    else:
        assert r["emitted_tokens"] > r["steps"]
        dec = [w for it in sim_cluster.instances["e0"].decisions
               for w in it if w[1] == "decode"]
        assert dec and all(t == K + 1 for _, _, t in dec)


# --------------------------------------------------------------------------
# the port's engine against the JAX engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("replayed", [False, True])
def test_spec_engine_matches_jax_engine(replayed):
    """The JAX ``kernels="reference"`` engine and the port's on the same
    target and draft weights (f32), greedy acceptance or one replayed
    trace: the same tokens, decisions and ``spec_decode`` metrics."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.core.config import SchedulerCfg as JaxSchedulerCfg
    from repro.serve import DriverCfg as JaxDriverCfg
    from repro.serve import ServeDriver as JaxServeDriver
    from repro.serve import ServingEngine as JaxServingEngine
    from repro.serve import SpecDecodeCfg as JaxSpecDecodeCfg
    from repro.workload import ShareGPTConfig as JaxShareGPTConfig
    from repro.workload import generate as jax_generate
    from repro.workload.acceptance import \
        AcceptanceConfig as JaxAcceptanceConfig
    from repro.workload.acceptance import \
        synthesize_acceptance as jax_synthesize
    from repro_torch.convert import params_from_numpy

    jcfg = dataclasses.replace(jax_get_config(ARCH), compute_dtype="float32",
                               kernels="reference")
    tcfg = _f32(get_config(ARCH))
    acc = dict(alpha=0.6, k=K, period=64, seed=5)
    jtrace = jax_synthesize(JaxAcceptanceConfig(**acc), model=jcfg.name) \
        if replayed else None
    ttrace = synthesize_acceptance(AcceptanceConfig(**acc),
                                   model=tcfg.name) if replayed else None
    jeng = JaxServingEngine(jcfg, max_batch=2, max_len=256, name="e0",
                            spec=JaxSpecDecodeCfg(draft=jcfg, k=K,
                                                  draft_seed=7,
                                                  acceptance=jtrace))
    assert not jeng.paged

    def numpy_params(p):
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, p))
    teng = ServingEngine(
        tcfg, numpy_params(jeng.params), max_batch=2, max_len=256,
        name="e0", device="cpu",
        spec=SpecDecodeCfg(draft=tcfg, k=K, acceptance=ttrace,
                           draft_params=numpy_params(jeng.draft.params)))
    jdrv = JaxServeDriver([jeng], JaxDriverCfg(
        scheduler=_sched(K + 1, JaxSchedulerCfg)))
    tdrv = ServeDriver([teng], DriverCfg(scheduler=_sched(K + 1)))
    jres = jdrv.run(_workload(jcfg.vocab, n=6, gen=jax_generate,
                              cfg_cls=JaxShareGPTConfig), warmup=False)
    tres = tdrv.run(_workload(tcfg.vocab, n=6), warmup=False)
    assert jres["finished"] == tres["finished"] == 6
    jb = jdrv.runtime.instances["e0"].backend
    tb = tdrv.runtime.instances["e0"].backend
    assert tb.out_tokens == jb.out_tokens
    assert list(tdrv.runtime.instances["e0"].decisions) == \
        list(jdrv.runtime.instances["e0"].decisions)
    j = jres["instances"]["e0"]["spec_decode"]
    t = tres["instances"]["e0"]["spec_decode"]
    assert set(t) == set(j)
    for key in j:
        if key == "step_timeline":     # (virtual time, position, accepted)
            assert [e[1:] for e in t[key]] == [e[1:] for e in j[key]]
        else:
            assert t[key] == j[key], key
    assert t["steps"] > 0
    if not replayed:                   # an unrelated draft, greedy
        assert t["acceptance_rate"] < 0.5


def test_samplers():
    """``accept_length`` counts the leading matches; ``temperature``
    draws from an explicit generator (the same seed, the same tokens) and
    at a temperature near 0 is the greedy pick over the real vocab."""
    from repro_torch.serve import accept_length, greedy, temperature
    d = np.array([[1, 2, 3], [1, 9, 3], [7, 2, 3]])
    t = np.array([[1, 2, 3, 4], [1, 2, 3, 4], [1, 2, 3, 4]])
    assert accept_length(d, t).tolist() == [3, 1, 0]
    logits = torch.randn((2, 3, 40), generator=torch.Generator()
                         .manual_seed(0))
    draws = [temperature(logits, 32, torch.Generator().manual_seed(5))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert draws[0].dtype == torch.int32 and tuple(draws[0].shape) == (2, 3)
    assert bool((draws[0] < 32).all())
    cold = temperature(logits, 32, torch.Generator().manual_seed(6),
                       temp=1e-6)
    assert torch.equal(cold, greedy(logits, 32))


# --------------------------------------------------------------------------
# the copied artifacts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(alpha=0.7, k=4, period=32, jitter=0.1, seed=3),
    dict(alpha=0.6, k=4, period=256, jitter=0.0, seed=0),
    dict(alpha=1.0, k=2, period=8, jitter=0.0, seed=1)])
def test_acceptance_trace_bytes_match_jax(kw, tmp_path):
    """The port's copies synthesize the JAX package's bytes, each package
    loads the other's file, and both draw the same acceptance."""
    pytest.importorskip("jax")
    from repro.spec import AcceptanceTrace as JaxTrace
    from repro.workload.acceptance import AcceptanceConfig as JaxConfig
    from repro.workload.acceptance import synthesize_acceptance as jax_synth
    j = jax_synth(JaxConfig(**kw), model="m", draft="d")
    t = synthesize_acceptance(AcceptanceConfig(**kw), model="m", draft="d")
    pj = j.save(str(tmp_path / "j.json"))
    pt = t.save(str(tmp_path / "t.json"))
    assert open(pj, "rb").read() == open(pt, "rb").read()
    assert AcceptanceTrace.load(pj).to_json() == j.to_json()
    assert JaxTrace.load(pt).to_json() == t.to_json()
    draws = [(p, s) for p in (0, 1, 31, 200) for s in range(20)]
    assert [t.accepted_for(p, s) for p, s in draws] == \
        [j.accepted_for(p, s) for p, s in draws]


@pytest.mark.parametrize("args", [
    ["record-acceptance", "--arch", ARCH, "--mode", "synthetic",
     "--alpha", "0.65", "--k", "3"],
    ["profile", "--device", "tpu-v6e", "--mode", "synthetic", "--arch",
     ARCH, "--spec"]])
def test_cli_acceptance_trace_equals_jax(args, tmp_path):
    """``record-acceptance`` and ``profile --spec`` in synthetic mode
    write the JAX CLI's acceptance-trace bytes."""
    pytest.importorskip("jax")
    outs = {}
    for pkg in ("repro", "repro_torch"):
        d = tmp_path / pkg
        d.mkdir()
        res = subprocess.run(
            [sys.executable, "-m", f"{pkg}.profiler", *args], cwd=d,
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        assert res.returncode == 0, res.stderr
        acc = sorted(d.rglob("*.acceptance.json"))
        assert len(acc) == 1
        outs[pkg] = acc[0].read_bytes()
    assert outs["repro_torch"] == outs["repro"]


# --------------------------------------------------------------------------
# bad configurations
# --------------------------------------------------------------------------

def test_engine_rejects_bad_spec_configs():
    cfg = get_config(ARCH)
    kw = dict(max_batch=2, max_len=64, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(cfg, spec=SpecDecodeCfg(
            draft=dataclasses.replace(cfg, vocab=128), k=2), **kw)
    with pytest.raises(ValueError, match="k must be"):
        ServingEngine(cfg, spec=SpecDecodeCfg(draft=cfg, k=0), **kw)
    t = synthesize_acceptance(AcceptanceConfig(alpha=0.5, k=2, period=16))
    with pytest.raises(ValueError, match="k="):
        ServingEngine(cfg, spec=SpecDecodeCfg(draft=cfg, k=4, acceptance=t),
                      **kw)
    moe = get_config("phimini-moe-tiny")
    with pytest.raises(ValueError, match="cannot be combined"):
        ServingEngine(moe, routing=lambda *a, **k: None,
                      spec=SpecDecodeCfg(draft=moe, k=2), **kw)


def test_backend_rejects_unreplayed_acceptance_trace():
    from repro_torch.runtime.backends.torch_engine import TorchBackend
    cfg = get_config(ARCH)
    register_acceptance("port-unreplayed-acc", synthesize_acceptance(
        AcceptanceConfig(alpha=0.5, k=K, period=16)))
    named = SpecCfg(enabled=True, k=K, acceptance_trace="port-unreplayed-acc")
    kw = dict(max_batch=2, max_len=64, device="cpu")
    eng = ServingEngine(cfg, **kw)
    with pytest.raises(ValueError, match="no draft"):
        TorchBackend(eng, engine_instance_cfg(eng, _sched(K + 1),
                                              spec=named))
    eng2 = ServingEngine(cfg, spec=SpecDecodeCfg(draft=cfg, k=K), **kw)
    with pytest.raises(ValueError, match="replays no trace"):
        TorchBackend(eng2, engine_instance_cfg(eng2, _sched(K + 1),
                                               spec=named))
    other = synthesize_acceptance(AcceptanceConfig(alpha=0.9, k=K,
                                                   period=16, seed=9))
    eng3 = ServingEngine(cfg, spec=SpecDecodeCfg(draft=cfg, k=K,
                                                 acceptance=other), **kw)
    with pytest.raises(ValueError, match="different trace"):
        TorchBackend(eng3, engine_instance_cfg(eng3, _sched(K + 1),
                                               spec=named))
    icfg = dataclasses.replace(engine_instance_cfg(eng2, _sched(K + 1)),
                               scheduler=_sched(1))
    with pytest.raises(ValueError, match="decode_tokens"):
        TorchBackend(eng2, icfg)


@pytest.mark.parametrize("what", ["acceptance_trace", "decode_tokens"])
def test_sim_spec_refusals(what):
    from repro_torch.core import InstanceCfg
    from repro_torch.core.config import TPU_V6E
    from repro_torch.runtime.backends.sim import SimBackend
    register_acceptance("port-dt-acc", synthesize_acceptance(
        AcceptanceConfig(alpha=0.5, k=K, period=16)))
    model = model_spec_from_arch(get_config(ARCH))
    if what == "acceptance_trace":
        icfg = InstanceCfg(name="i0", hw=TPU_V6E, model=model,
                           scheduler=SchedulerCfg(decode_tokens=K + 1),
                           spec=SpecCfg(enabled=True, k=K))
    else:
        icfg = InstanceCfg(name="i0", hw=TPU_V6E, model=model,
                           spec=SpecCfg(enabled=True, k=K,
                                        acceptance_trace="port-dt-acc"))
    with pytest.raises(ValueError, match=what):
        SimBackend(icfg)


# --------------------------------------------------------------------------
# card: the verify shape of the paged extend kernel
# --------------------------------------------------------------------------

@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_verify_shape_extend_kernel_matches_plain(sm90, dtype, tol):
    """llama3.1-8b's verify at k = 4 on a full batch: B8 S5 H32 KV8 dh128
    ps64, ragged starts 1..2043 with one on a page edge and one slot
    verifying fewer than S tokens; every real row against the plain
    version."""
    gen = torch.Generator(device=sm90).manual_seed(3)
    B, S, H, KV, dh, ps, maxp = 8, 5, 32, 8, 128, 64, 32
    P = B * maxp + 1
    q = torch.randn((B, S, H, dh), generator=gen, device=sm90).to(dtype)
    kp = torch.randn((P, ps, KV, dh), generator=gen, device=sm90).to(dtype)
    vp = torch.randn((P, ps, KV, dh), generator=gen, device=sm90).to(dtype)
    table = torch.randperm(P - 1, generator=gen, device=sm90)[
        :B * maxp].reshape(B, maxp).to(torch.int32)
    start = torch.tensor([1, 63, 64, 300, 777, 1024, 1500, 2043],
                         dtype=torch.int32, device=sm90)
    n_new = torch.tensor([5, 5, 5, 5, 2, 5, 5, 5], dtype=torch.int32,
                         device=sm90)
    lengths = start + n_new
    got = ops.paged_attention(q, kp, vp, table, lengths, page_size=ps,
                              start=start).float()
    want = ops.paged_attention_plain(q, kp, vp, table, lengths,
                                     page_size=ps, start=start).float()
    for b in range(B):
        n = int(n_new[b])
        err = (got[b, :n] - want[b, :n]).abs()
        assert bool((err <= tol + tol * want[b, :n].abs()).all()), \
            float(err.max())
