"""Tensor parallelism when the query heads do not divide tp: GSPMD's padded
head layout in the port, gloo ranks on the CPU against the JAX package.

Rank r holds query heads ``[min(r·c, H), min((r+1)·c, H))``, c = ceil(H /
tp), and its KV heads as KV slots (``launch/sharding.py``).  Without a
spawn, for every assigned arch and tp in {2, 3, 4, 8, 16}: every query
head lies on exactly one rank, each slot list reads KV head h // G of
each of its rank's query heads, the owned KV heads partition the KV heads,
and a payload round-trips through the slots.

``repro_torch.launch.mesh.run_ranks`` spawns three ranks and four ranks
once for the module (each serves, then trains on a (1, tp) grid made over
its world), and six ranks for one (2, 3) grid.  Tiny f32 variants, the
weights drawn by the JAX package (norms and biases perturbed so no
zero-init term hides):

* ``sc``: starcoder2-7b-tiny at starcoder2-7b's 36 query heads and 4 KV
  heads (G 9): at tp = 3 rank 0 reads KV 0 with nine heads and KV 1 with
  three (slots [0, 0, 0, 1], G 3), rank 1 [1, 2] (G 6), rank 2 [2, 3, 3,
  3]; KV 1 and KV 2 are each read by two ranks whose sets overlap;
* ``sc-empty``: 6 query heads and 2 KV heads (G 3): at tp = 4 ranks 0-2
  hold two heads each (rank 1 one on each KV head) and rank 3 none;
* ``qwen``: qwen1.5-32b-tiny at 10 heads, MHA with QKV biases: 4, 4, 2 a
  rank at tp = 3 and 3, 3, 3, 1 at tp = 4 (RoPE at theta 1e4, see
  ``VARIANTS``);
* ``granite``: granite-moe-3b-a800m-tiny at 6 query heads, 2 KV heads and
  four experts: at tp = 4 one expert a rank and rank 3 without heads.

Held to: logits (two prefills, two decode steps) equal to the port's at
tp = 1 and the JAX ``kernels="reference"`` engine's at tp = 1 within
1e-5, on every rank; served tokens equal to the port's at tp = 1 and the
JAX engine's (unified and P/D), decisions equal to both simulators' at
each engine's ``parallelism.tp``; at tp = 3 P/D 3 -> 1 and 1 -> 3 (the
handoff's bytes tp = 1's), the prefix store over three tiers (its
counters tp = 1's) and speculative decoding (``spec_decode`` tp = 1's);
two AdamW steps on (1, 3), (1, 4) and (2, 3) grids equal to JAX's
one-device step at ``test_torch_grid.py``'s tolerances.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
LR, STEPS, B, S = 1e-2, 2, 4, 16
K = 3
TRACE = "heads-alpha0.6"
ACCEPTANCE = dict(alpha=0.6, k=K, period=64, seed=5)
PD = {"p0": ("d0",)}
# name -> (arch, config overrides)
VARIANTS = {
    "sc": ("starcoder2-7b-tiny", dict(n_heads=36, n_kv_heads=4, d_ff=192)),
    "sc-empty": ("starcoder2-7b-tiny", dict(n_heads=6, n_kv_heads=2,
                                            d_ff=192)),
    # rope_theta 1e4: at qwen's 1e6, d_head 16 and 16 positions half of
    # RoPE's pairs barely turn, so bk's gradient there is f32 rounding and
    # Adam's first step takes its sign (the port at tp = 1 already
    # differs from JAX on 24 of bk's 160 entries)
    "qwen": ("qwen1.5-32b-tiny", dict(n_heads=10, n_kv_heads=10, d_ff=192,
                                      rope_theta=1e4)),
    "granite": ("granite-moe-3b-a800m-tiny", dict(n_heads=6, n_kv_heads=2)),
}
# tp -> what its spawn runs: logits, serves (technique, variant), (1, tp)
# training
SPAWNS = {
    3: {"logits": ("sc", "qwen"),
        "serve": (("unified", "sc"), ("pd-3to1", "sc"), ("pd-1to3", "sc"),
                  ("prefix", "sc"), ("spec", "sc")),
        "train": ("sc", "qwen")},
    4: {"logits": ("sc-empty", "qwen", "granite"),
        "serve": (("unified", "sc-empty"), ("unified", "granite")),
        "train": ("sc-empty", "qwen", "granite")},
}
#: the (2, 3) grid's case, in a spawn of its own
GRID23 = "sc"
SERVES = tuple((tp, run) for tp, s in SPAWNS.items() for run in s["serve"])


def _cfg(get, variant):
    arch, over = VARIANTS[variant]
    return dataclasses.replace(get(arch), compute_dtype="float32", **over)


# ---------------------------------------------------------------- layout
LAYOUT = [(a, tp) for a in ASSIGNED for tp in (2, 3, 4, 8, 16)]


@pytest.mark.parametrize("arch,tp", LAYOUT,
                         ids=[f"{a}-tp{tp}" for a, tp in LAYOUT])
def test_padded_layout_and_slots(arch, tp):
    """Every query head on exactly one rank, ceil(H / tp) a rank from rank
    0 (GSPMD's padded layout); each rank's slots read KV head h // G of
    each of its query heads with one group size; the owned KV heads
    partition the KV heads; the slots round-trip a payload."""
    cfg = get_config(arch)
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G, c = H // KV, math.ceil(H / tp)
    heads, owned = [], []
    for r in range(tp):
        lo, hi = sharding.query_heads(cfg, r, tp)
        assert (lo, hi) == (min(r * c, H), min((r + 1) * c, H))
        heads += range(lo, hi)
        slots = sharding.kv_slots(cfg, r, tp)
        klo, khi = sharding.kv_heads(cfg, r, tp)
        if hi == lo:
            assert slots == () and klo == khi
            continue
        g = (hi - lo) // len(slots)
        assert g * len(slots) == hi - lo
        assert [slots[i // g] for i in range(hi - lo)] == \
            [h // G for h in range(lo, hi)]
        assert sorted(set(slots)) == list(range(klo, khi))
        olo, ohi = sharding.owned_kv_heads(cfg, r, tp)
        assert klo <= olo <= ohi <= khi
        owned += range(olo, ohi)
        t = torch.arange(khi - klo, dtype=torch.float32).reshape(
            1, 1, -1, 1) + klo
        got = sharding.to_slots(t, cfg, r, tp)
        assert got[0, 0, :, 0].tolist() == list(slots)
        assert torch.equal(sharding.from_slots(got, cfg, r, tp), t)
    assert heads == list(range(H))
    assert owned == list(range(KV))
    readers = dict(sharding.shared_kv_heads(cfg, tp))
    for k in range(KV):
        rs = [r for r in range(tp)
              if k in sharding.kv_slots(cfg, r, tp)]
        assert readers.get(k, tuple(rs)) == tuple(rs)
        assert (k in readers) == (len(rs) > 1)


def test_starcoder2_tp3_slots_and_reader_sets():
    """The issue's worked case: starcoder2-7b at tp = 3."""
    cfg = get_config("starcoder2-7b")
    assert [sharding.kv_slots(cfg, r, 3) for r in range(3)] == \
        [(0, 0, 0, 1), (1, 2), (2, 3, 3, 3)]
    assert sharding.shared_kv_heads(cfg, 3) == ((1, (0, 1)), (2, (1, 2)))
    assert sharding.unsupported(cfg, 3) is None
    assert "d_ff 128" in sharding.unsupported(get_config(
        "starcoder2-7b-tiny"), 3)


# --------------------------------------------------------- the ranks' side
def _noisy(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _noisy(v, rng, path + (k,)) for k, v in tree.items()}
    if any("norm" in k for k in path) or path[-1] in ("bq", "bk", "bv"):
        return (tree + 0.1 * rng.standard_normal(tree.shape)
                ).astype(tree.dtype)
    return tree


def _logit_inputs(vocab):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, (1, n)).astype(np.int32)
               for n in (16, 11)]
    return prompts, rng.integers(0, vocab, (2, 2, 1)).astype(np.int32)


def port_logits(eng, vocab):
    """Prefill two slots (bucket 16), then two decode steps: the logits."""
    prompts, steps = _logit_inputs(vocab)
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


def _requests(technique, vocab, cls, gen, gen_cfg):
    """Every arrival at 0 (unified, P/D, spec), or two phases far apart
    (the prefix store: phase A's two prefixes spill to the SSD, phase B
    hits them), so the decisions do not depend on latencies."""
    if technique == "prefix":
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
    pd = technique.startswith("pd")
    reqs = gen(gen_cfg(
        n_requests=4 if pd else 6, rate=50.0, vocab=vocab, seed=3,
        mean_prompt=40 if pd else 30, mean_output=5 if pd else 8,
        sigma_prompt=0.4, sigma_output=0.3, max_prompt=80 if pd else 60,
        max_output=6 if pd else 10, share_fraction=0.0))
    for r in reqs:
        r.arrival = 0.0
    return reqs


def _sched(technique, cls, engine_cls):
    if technique == "prefix":
        return engine_cls(2)
    if technique.startswith("pd"):      # batches of one: the handoffs
        return cls(max_batch_size=1, max_batch_tokens=64,  # land at
                   chunked_prefill=True, prefill_chunk=16)  # latency times
    return cls(max_batch_size=2, max_batch_tokens=64, chunked_prefill=True,
               prefill_chunk=16,
               decode_tokens=K + 1 if technique == "spec" else 1)


def _tiers(instances):
    """Three device blocks and one host block, spilling on to the SSD, in
    blocks, so every tp walks alike (``test_torch_tp_techniques.py``)."""
    for inst in instances:
        if inst.cache is None:
            continue
        inst.cache.capacity_blocks = 3
        inst.cache.cfg = dataclasses.replace(inst.cache.cfg, ssd_spill=True)
        inst.mem.host.capacity = inst.mem.bytes_per_block


def _engine_tps(technique, tp):
    """Each engine's tp on the ranks."""
    if technique == "pd-3to1":
        return {"p0": tp, "d0": 1}
    if technique == "pd-1to3":
        return {"p0": 1, "d0": tp}
    if technique.startswith("pd"):
        return {"p0": tp, "d0": tp}
    return {"e0": tp}


def port_serve(technique, variant, job, group=None, device="cpu"):
    """Serve on the port (at tp = 1 without ``group``): what the tests
    compare and the InstanceCfgs the simulators take."""
    from repro_torch.configs import get_config as get
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.config import SchedulerCfg, engine_scheduler_cfg
    from repro_torch.serve import (DriverCfg, ServeDriver, ServingEngine,
                                   SpecDecodeCfg)
    from repro_torch.serve.driver import engine_instance_cfg
    from repro_torch.workload import ShareGPTConfig, generate
    from repro_torch.workload.acceptance import (AcceptanceConfig,
                                                 synthesize_acceptance)
    from repro_torch.workload.sharegpt import Request
    cfg = _cfg(get, variant)
    params = params_from_numpy(job["params"][variant])
    kw = dict(max_batch=2, max_len=256, device=device)
    tps = _engine_tps(technique, 1 if group is None else group.size)

    def at(tp):
        if group is None:
            return dict(tp=1)
        return dict(tp=tp, group=group) if tp > 1 else \
            dict(tp=1, replicas=group)
    spec = None
    if technique == "spec":
        spec = SpecDecodeCfg(
            draft=cfg, k=K, draft_params=params_from_numpy(job["draft"]),
            acceptance=synthesize_acceptance(AcceptanceConfig(**ACCEPTANCE),
                                             model=cfg.name))
    if technique.startswith("pd"):
        engines = [ServingEngine(cfg, params, name="p0", role="prefill",
                                 **kw, **at(tps["p0"])),
                   ServingEngine(cfg, params, name="d0", role="decode",
                                 **kw, **at(tps["d0"]))]
    else:
        engines = [ServingEngine(cfg, params, name="e0", spec=spec,
                                 prefix_cache=technique == "prefix", **kw,
                                 **at(tps["e0"]))]
    sched = _sched(technique, SchedulerCfg, engine_scheduler_cfg)
    drv = ServeDriver(engines, DriverCfg(scheduler=sched),
                      pd_map=PD if technique.startswith("pd") else None)
    if technique == "prefix":
        _tiers(drv.runtime.instances.values())
    m = drv.run(_requests(technique, cfg.vocab, Request, generate,
                          ShareGPTConfig), warmup=False)
    insts = drv.runtime.instances
    return {"finished": m["finished"],
            "tokens": {n: dict(i.backend.out_tokens)
                       for n, i in insts.items()},
            "decisions": {n: list(i.decisions) for n, i in insts.items()},
            "icfgs": [engine_instance_cfg(e, sched) for e in engines],
            "network_bytes": m.get("network_bytes"),
            "kv_tiers": {n: s["kv_tiers"] for n, s in m["instances"].items()
                         if "kv_tiers" in s},
            "spec_decode": {n: s["spec_decode"]
                            for n, s in m["instances"].items()
                            if "spec_decode" in s},
            "slots": {e.name: e.model.kv_heads() for e in engines}}


def _train(grid, job, names):
    """Two AdamW steps of each case on ``grid``: per-step metrics and the
    rank's params (numpy, by leaf path)."""
    from repro_torch.configs import get_config as get
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.sharding import shard_batch
    from repro_torch.models import Model
    from repro_torch.train import AdamW, TrainStepConfig, make_train_step
    from repro_torch.train.train_step import rank_state
    from repro_torch.train.tree import leaves
    out = {}
    for name in names:
        cfg = _cfg(get, name)
        model = Model(cfg, **grid.model_kw())
        opt = AdamW(lr=LR)
        state = rank_state(model, opt, params_from_numpy(
            job["params"][name]), grid)
        step = make_train_step(model, opt, TrainStepConfig(), grid=grid)
        mets = []
        for batch in job["batches"][name]:
            mine = shard_batch({k: torch.from_numpy(v)
                                for k, v in batch.items()},
                               grid.dp_rank, grid.dp_size)
            state, met = step(state, mine)
            mets.append({k: float(v) for k, v in met.items()})
        out[name] = {"metrics": mets, "params": [
            t.detach().numpy() for t in leaves(state.params)]}
    return out


def _rank(group, job):
    """One rank of a spawn: the logits, the serves, then two training
    steps on a (1, tp) grid made over the spawn's world."""
    from repro_torch.configs import get_config as get
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import grid_mesh, grid_on_world
    from repro_torch.serve import ServingEngine
    spawn = SPAWNS[group.size]
    out = {"rank": group.rank, "logits": {}, "serve": {}}
    for name in spawn["logits"]:
        cfg = _cfg(get, name)
        eng = ServingEngine(cfg, params_from_numpy(job["params"][name]),
                            max_batch=2, max_len=128, tp=group.size,
                            group=group, device=group.device)
        out["logits"][name] = port_logits(eng, cfg.vocab)
    for run in spawn["serve"]:
        out["serve"][run] = port_serve(*run, job, group, group.device)
    grid = grid_on_world(grid_mesh(1, group.size), group.rank, group.device,
                         group.backend)
    out["train"] = _train(grid, job, spawn["train"])
    return out


def _grid_rank(grid, job):
    return {"coords": grid.coords, "train": _train(grid, job, (GRID23,))}


# ------------------------------------------------------ the JAX package's
def _jax_params_and_steps(name):
    """The JAX weights (numpy, perturbed), two batches and the JAX
    one-device train step's metrics and final params on them."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import Model as JaxModel
    from repro.train import AdamW as JaxAdamW
    from repro.train import TrainStepConfig as JaxStepCfg
    from repro.train import make_train_step as jax_make_step
    from repro.train.train_step import TrainState as JaxTrainState
    cfg = _cfg(jget, name)
    jm = JaxModel(cfg)
    seed = list(VARIANTS).index(name)
    params = _noisy(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed))),
        np.random.default_rng(seed + 11))
    rng = np.random.default_rng(10 + seed)
    batches = [{k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
                for k in ("inputs", "labels")} for _ in range(STEPS)]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = JaxTrainState(jp, JaxAdamW(lr=LR).init(jp))
    step = jax.jit(jax_make_step(jm, JaxAdamW(lr=LR), JaxStepCfg()))
    mets = []
    for b in batches:
        js, met = step(js, {k: jnp.asarray(v) for k, v in b.items()})
        mets.append({k: float(v) for k, v in met.items()})
    return params, batches, mets, [np.asarray(x) for x in
                                   jax.tree_util.tree_leaves(js.params)]


def _jax_engine(variant, params, **kw):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.serve import ServingEngine as JaxServingEngine
    cfg = dataclasses.replace(_cfg(jget, variant), kernels="reference")
    return JaxServingEngine(cfg, jax.tree_util.tree_map(jnp.asarray, params),
                            **kw)


def _jax_logits(name, params):
    """``port_logits``' calls on the JAX reference engine."""
    import jax.numpy as jnp
    eng = _jax_engine(name, params, max_batch=2, max_len=128)
    prompts, steps = _logit_inputs(eng.cfg.vocab)
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


def _jax_serve_tokens(technique, variant, params):
    """The JAX reference engine's tokens by instance at tp = 1 (unified,
    or P/D: a pair of different tp is P/D at tp = 1)."""
    from repro.core.config import SchedulerCfg, engine_scheduler_cfg
    from repro.serve import DriverCfg, ServeDriver
    from repro.workload import ShareGPTConfig, generate
    from repro.workload.sharegpt import Request
    kw = dict(max_batch=2, max_len=256)
    if technique.startswith("pd"):
        engines = [_jax_engine(variant, params, name="p0", role="prefill",
                               **kw),
                   _jax_engine(variant, params, name="d0", role="decode",
                               **kw)]
    else:
        engines = [_jax_engine(variant, params, name="e0", **kw)]
    drv = ServeDriver(engines, DriverCfg(scheduler=_sched(
        technique, SchedulerCfg, engine_scheduler_cfg)),
        pd_map=PD if technique.startswith("pd") else None)
    drv.run(_requests(technique, engines[0].cfg.vocab, Request, generate,
                      ShareGPTConfig), warmup=False)
    return {n: dict(i.backend.out_tokens)
            for n, i in drv.runtime.instances.items()}


@pytest.fixture(scope="module")
def jax_side():
    """Each variant's JAX weights, batches and one-device steps, and the
    spec serve's draft weights (the same geometry as ``sc``, another
    draw)."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import Model as JaxModel
    draft = JaxModel(_cfg(jget, "sc")).init(jax.random.PRNGKey(7))
    return {"runs": {name: _jax_params_and_steps(name) for name in VARIANTS},
            "draft": jax.tree_util.tree_map(np.asarray, draft)}


def _job(jax_side, names):
    runs = jax_side["runs"]
    return {"params": {n: runs[n][0] for n in names},
            "batches": {n: runs[n][1] for n in names},
            "draft": jax_side["draft"]}


@pytest.fixture(scope="module")
def spawns(jax_side):
    """The three- and four-rank spawns and the six-rank (2, 3) grid."""
    from repro_torch.launch.mesh import run_ranks
    out = {tp: run_ranks(_rank, tp, _job(jax_side, VARIANTS), device="cpu",
                         timeout_s=400) for tp in SPAWNS}
    out[(2, 3)] = run_ranks(_grid_rank, 3, _job(jax_side, (GRID23,)), dp=2,
                            device="cpu", timeout_s=300)
    return out


# ------------------------------------------------------------- serving
LOGITS = tuple((tp, n) for tp, s in SPAWNS.items() for n in s["logits"])


@pytest.mark.parametrize("tp,name", LOGITS,
                         ids=[f"tp{tp}-{n}" for tp, n in LOGITS])
def test_logits_equal_tp1_and_jax(spawns, jax_side, tp, name):
    """f32: every rank's prefill and decode logits equal the port's at tp
    = 1 and the JAX reference engine's at tp = 1 within 1e-5."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.serve import ServingEngine
    cfg = _cfg(get_config, name)
    params = jax_side["runs"][name][0]
    want = port_logits(ServingEngine(cfg, params_from_numpy(params),
                                     max_batch=2, max_len=128,
                                     device="cpu"), cfg.vocab)
    jwant = _jax_logits(name, params)
    for r in spawns[tp]:
        got = r["logits"][name]
        assert len(got) == len(want) == len(jwant) == 4
        for g, w, jw in zip(got, want, jwant):
            np.testing.assert_allclose(g, w, **TOL)
            np.testing.assert_allclose(g, jw, **TOL)


@pytest.fixture(scope="module")
def tp1(jax_side):
    """The port's serves at tp = 1 (a P/D pair of different tp: P/D)."""
    out = {}
    for _, (technique, name) in SERVES:
        ref = "pd" if technique.startswith("pd") else technique
        if (ref, name) not in out:
            out[(ref, name)] = port_serve(ref, name, _job(jax_side,
                                                          VARIANTS))
    return out


def _ref(run):
    technique, name = run
    return ("pd" if technique.startswith("pd") else technique), name


@pytest.mark.parametrize("tp,run", SERVES,
                         ids=[f"tp{tp}-{t}-{n}" for tp, (t, n) in SERVES])
def test_serve_tokens_equal_tp1_and_jax(spawns, tp1, jax_side, tp, run):
    """Every rank emits the same tokens and makes the same decisions as
    the port at tp = 1; unified and P/D serves' tokens equal the JAX
    reference engine's; every engine's pools hold its rank's KV slots."""
    technique, name = run
    want = tp1[_ref(run)]
    cfg = _cfg(get_config, name)
    for r in spawns[tp]:
        got = r["serve"][run]
        assert got["finished"] == want["finished"] > 0
        assert got["tokens"] == want["tokens"]
        assert got["decisions"] == want["decisions"]
        slots = {n: len(sharding.kv_slots(cfg, r["rank"], t)) if t > 1
                 else cfg.n_kv_heads
                 for n, t in _engine_tps(technique, tp).items()}
        assert got["slots"] == slots
    if technique in ("unified", "pd-3to1", "pd-1to3"):
        assert want["tokens"] == _jax_serve_tokens(technique, name,
                                                   jax_side["runs"][name][0])


def _to_jax(obj):
    """A port config dataclass as the JAX package's (same names and
    fields)."""
    import repro.core.config as jc
    if dataclasses.is_dataclass(obj):
        return getattr(jc, type(obj).__name__)(**{
            f.name: _to_jax(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(_to_jax(x) for x in obj)
    return obj


def _simulate(pkg, icfgs, technique, vocab):
    import importlib
    core = importlib.import_module(f"{pkg}.core")
    cluster = importlib.import_module(f"{pkg}.core.cluster")
    workload = importlib.import_module(f"{pkg}.workload")
    sharegpt = importlib.import_module(f"{pkg}.workload.sharegpt")
    sim = cluster.Cluster(core.ClusterCfg(
        instances=tuple(icfgs), router=core.RouterCfg("round_robin"),
        pd_map=PD if technique.startswith("pd") else None))
    if technique == "prefix":
        _tiers(sim.instances.values())
    sim.submit_workload(_requests(technique, vocab, sharegpt.Request,
                                  workload.generate,
                                  workload.ShareGPTConfig))
    m = sim.run()
    return m, {n: list(i.decisions) for n, i in sim.instances.items()}


@pytest.mark.parametrize("tp,run", SERVES,
                         ids=[f"tp{tp}-{t}-{n}" for tp, (t, n) in SERVES])
def test_serve_decisions_equal_both_simulators(spawns, tp, run):
    """The ranks' decisions equal the port's and the JAX simulators' at
    each engine's ``parallelism.tp`` (a replayed spec serve's accepted
    lengths too)."""
    from repro.spec import register_acceptance as jax_register
    from repro.workload.acceptance import AcceptanceConfig as JaxAccCfg
    from repro.workload.acceptance import \
        synthesize_acceptance as jax_synth
    from repro_torch.spec import register_acceptance
    from repro_torch.workload.acceptance import (AcceptanceConfig,
                                                 synthesize_acceptance)
    technique, name = run
    cfg = _cfg(get_config, name)
    r0 = spawns[tp][0]["serve"][run]
    icfgs = r0["icfgs"]
    tps = _engine_tps(technique, tp)
    assert {i.name: (i.parallelism.tp, i.n_devices) for i in icfgs} == \
        {n: (t, t) for n, t in tps.items()}
    if technique == "spec":
        register_acceptance(TRACE, synthesize_acceptance(
            AcceptanceConfig(**ACCEPTANCE), model=cfg.name))
        jax_register(TRACE, jax_synth(JaxAccCfg(**ACCEPTANCE),
                                      model=cfg.name))
        icfgs = [dataclasses.replace(i, spec=dataclasses.replace(
            i.spec, acceptance_trace=TRACE)) for i in icfgs]
    pm, pdec = _simulate("repro_torch", icfgs, technique, cfg.vocab)
    jm, jdec = _simulate("repro", [_to_jax(i) for i in icfgs], technique,
                         cfg.vocab)
    assert pm["finished"] == jm["finished"] == r0["finished"]
    assert r0["decisions"] == pdec == jdec
    if technique == "spec":
        real = r0["spec_decode"]["e0"]
        for m in (pm, jm):
            sim = m["instances"]["e0"]["spec_decode"]
            assert [e[1:] for e in real["step_timeline"]] == \
                [e[1:] for e in sim["step_timeline"]]
            assert real["accepted_hist"] == sim["accepted_hist"]


@pytest.mark.parametrize("technique", ["pd-3to1", "pd-1to3"])
def test_pd_across_tp_ships_tp1_bytes(spawns, tp1, technique):
    """3 -> 1 (the prefill group gathers its ranks' owned heads, padded to
    the most any rank owns) and 1 -> 3 (each decode rank takes its heads
    and repeats a straddled one into its slots): every handoff carries tp
    = 1's bytes, on every rank."""
    want = tp1[("pd", "sc")]["network_bytes"]
    assert want["d0<->p0"] > 0
    for r in spawns[3]:
        assert r["serve"][(technique, "sc")]["network_bytes"] == want


def test_prefix_store_counters_equal_tp1(spawns, tp1):
    """The KV-tier counters at tp = 3 equal tp = 1's (the runtime prices
    a rank's third of a block's bytes); the store walked device -> host ->
    SSD -> device and restored."""
    want = tp1[("prefix", "sc")]["kv_tiers"]["e0"]
    for r in spawns[3]:
        got = r["serve"][("prefix", "sc")]["kv_tiers"]["e0"]
        for key in ("residency_blocks", "hit_tokens", "restored_tokens",
                    "restore_events", "tier_moves", "store_residency"):
            assert got[key] == want[key], key
        assert {p: t["blocks"] for p, t in got["transfers"].items()} == \
            {p: t["blocks"] for p, t in want["transfers"].items()}
        for p, t in got["transfers"].items():
            assert 3 * t["bytes"] == pytest.approx(
                want["transfers"][p]["bytes"], rel=1e-12)
        assert {"device->host", "host->ssd", "ssd->device"} <= \
            set(got["transfers"])
        assert got["restored_tokens"] > 0


def test_spec_decode_metrics_equal_tp1(spawns, tp1):
    want = tp1[("spec", "sc")]["spec_decode"]["e0"]
    assert want["steps"] > 0
    for r in spawns[3]:
        got = r["serve"][("spec", "sc")]["spec_decode"]["e0"]
        assert set(got) == set(want)
        for key in want:
            if key == "step_timeline":
                assert [e[1:] for e in got[key]] == \
                    [e[1:] for e in want[key]]
            else:
                assert got[key] == want[key], key


# ------------------------------------------------------------- training
def _assert_params(got, want, lr, steps):
    """``test_torch_train.py``'s rule: entries Adam makes ill-conditioned
    (at most one, or 1 in 1000, of a leaf) within 2 * lr * steps, every
    other entry within rtol 1e-4, atol 1e-5."""
    for i, (a, b) in enumerate(zip(got, want)):
        off = ~np.isclose(a, b, **TRAIN_TOL)
        assert off.sum() <= max(1, a.size // 1000), (i, int(off.sum()),
                                                      a.size)
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr * steps,
                                   err_msg=f"leaf {i}")


def _check_training(ranks, name, dp, tp, jax_side):
    from repro_torch.train.tree import leaves, unflatten
    from repro_torch.models import Model
    _, _, jmets, jparams = jax_side["runs"][name]
    cfg = _cfg(get_config, name)
    for r in ranks:
        for got, want in zip(r["train"][name]["metrics"], jmets):
            for k in ("loss", "loss_total", "aux_loss", "grad_norm", "lr",
                      "tokens"):
                np.testing.assert_allclose(got[k], want[k], **TRAIN_TOL,
                                           err_msg=f"{name} {k}")
    template = Model(cfg).init(torch.Generator(), device="meta")
    rows = []
    for d in range(dp):
        parts = []
        for t in range(tp):
            flat = ranks[d * tp + t]["train"][name]["params"]
            shard = sharding.shard_params(template, t, tp, cfg=cfg)
            parts.append(unflatten(shard, [torch.from_numpy(a)
                                           for a in flat]))
        rows.append([x.numpy() for x in leaves(
            sharding.gather_params(parts, cfg, tp))])
    for row in rows[1:]:
        for a, b in zip(row, rows[0]):
            np.testing.assert_array_equal(a, b)
    _assert_params(rows[0], jparams, LR, STEPS)


TRAIN = tuple((tp, n) for tp, s in SPAWNS.items() for n in s["train"])


@pytest.mark.parametrize("tp,name", TRAIN,
                         ids=[f"1x{tp}-{n}" for tp, n in TRAIN])
def test_training_matches_jax(spawns, jax_side, tp, name):
    """Two steps on a (1, tp) grid: loss, aux loss, grad norm on every
    rank and the params gathered to the JAX layout equal JAX's one-device
    step (the shared KV heads' gradients summed over their reader sets,
    an empty rank's empty leaves harmless)."""
    _check_training(spawns[tp], name, 1, tp, jax_side)


def test_training_2x3_matches_jax(spawns, jax_side):
    """A (2, 3) grid: the reader groups made for both data rows; both
    rows' params equal and equal to JAX's one-device step."""
    ranks = spawns[(2, 3)]
    assert [r["coords"] for r in ranks] == [
        {"data": d, "model": m} for d in range(2) for m in range(3)]
    _check_training(ranks, GRID23, 2, 3, jax_side)


def test_serve_cli_refuses_only_what_unsupported_names(tmp_path):
    """``launch.serve --tp`` takes any tp the heads give; it refuses,
    before any rank starts, a tp that ``sharding.unsupported`` names: tiny
    starcoder2's d_ff of 128 at tp = 3."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "starcoder2-7b-tiny", "--tp", "3", "--n", "2"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert res.returncode != 0
    assert "--tp 3" in res.stderr and "d_ff 128" in res.stderr
    assert "query heads" not in res.stderr
