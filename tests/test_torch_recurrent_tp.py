"""Tensor parallelism of the recurrent stages (Mamba2, the zamba
superblock, mLSTM, sLSTM) in the port: gloo ranks on the CPU against the
port at tp = 1, the JAX ``Model`` and JAX's one-device train step.

Rank r holds the heads ``[min(r·c, nh), min((r+1)·c, nh))``, c = ceil(nh /
tp), of every recurrent block (``launch/sharding.py``), GSPMD's padded
layout; a rank may hold none.  Without a spawn: shard -> gather round
trips of the params (strided leaves included) and of the recurrent state
at tp 2, 3, 4 and 8, each rank's state shapes equal to its model's
``init_cache``; the widths ``sharding.unsupported`` refuses; the dry run's
recurrent cells at the JAX study's 16x16 and 2x16x16 meshes; the sLSTM
loop's backward bytes (O(S), not O(S²)) and its gradients against
``jax.grad``.

``repro_torch.launch.mesh.run_ranks`` spawns 2, 3, 4 and 8 ranks once for
the module.  Tiny f32 variants, the weights drawn by the JAX package
(norms, conv and gate biases perturbed so no zero-init term hides):

* ``z``: zamba2-1.2b-tiny: 8 Mamba heads and 4 attention heads, at tp = 2
  and 4;
* ``z3``: the same with ``d_ff`` 96, at tp = 3: Mamba heads 3 / 3 / 2,
  attention heads 2 / 2 / 0;
* ``x``: xlstm-125m-tiny at ``d_model`` 48 (sLSTM width 64), 4 heads: one a
  rank at tp = 4, ranks 4-7 without heads at tp = 8.

Held to: prefill, extend (zamba2) and decode logits on every rank equal to
the port's at tp = 1 and the JAX ``Model``'s within 1e-5; served tokens
equal to the port's at tp = 1 and to per-request JAX ``Model`` calls (the
JAX engine is no oracle for recurrent state, ``test_torch_recurrent.py``),
decisions equal to both simulators' at each engine's ``parallelism.tp``;
P/D 2 -> 2, 2 -> 1 and 1 -> 2 (zamba2), its tokens and handoff bytes tp =
1's; two AdamW steps on (1, 2), (1, 3), (1, 4) and (2, 2) grids (the last
with ZeRO-1 off and on) against JAX's one-device step: losses and grad
norms at ``test_torch_grid.py``'s tolerances, the first moments (the
completed gradients) at ``test_torch_train.py``'s gradient rule against
the port at tp = 1 (and JAX's within its zamba2 share), the params after
step 2 at ``test_torch_train.py``'s count rule against both, on the
entries whose gradient lies above its rounding floor (``_assert_params``).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
LR, STEPS, B, S = 1e-2, 2, 4, 16
PD = {"p0": ("d0",)}
MAX_LEN = 96
# name -> (arch, config overrides)
VARIANTS = {
    "z": ("zamba2-1.2b-tiny", {}),
    "z3": ("zamba2-1.2b-tiny", dict(d_ff=96)),
    "x": ("xlstm-125m-tiny", dict(d_model=48)),
}
# tp -> what its spawn runs: logits, serves (technique, variant), (1, tp)
# training, (2, 2) training (ZeRO-1 off and on)
SPAWNS = {
    2: {"logits": ("z",),
        "serve": (("unified", "z"), ("pd-2to2", "z"), ("pd-2to1", "z"),
                  ("pd-1to2", "z")),
        "train": ("z", "x")},
    3: {"logits": ("z3",), "serve": (("unified", "z3"),), "train": ("z3",)},
    4: {"logits": ("z", "x"), "serve": (("unified", "z"), ("unified", "x")),
        "train": ("z", "x"), "grid22": ("z", "x")},
    8: {"logits": ("x",), "serve": (("unified", "x"),)},
}
SERVES = tuple((tp, run) for tp, s in SPAWNS.items() for run in s["serve"])


def _cfg(get, variant):
    arch, over = VARIANTS[variant]
    return dataclasses.replace(get(arch), compute_dtype="float32", **over)


def _zamba(name):
    return VARIANTS[name][0].startswith("zamba")


# ---------------------------------------------------------------- layout
ROUND = [(n, tp) for n in VARIANTS for tp in (2, 3, 4, 8)]
#: what ``unsupported`` names where the widths do not split
REFUSED = {("z", 3): "d_ff 128", ("x", 3): "feed-forward width 64"}


@pytest.mark.parametrize("name,tp", ROUND,
                         ids=[f"{n}-tp{tp}" for n, tp in ROUND])
def test_shard_gather_round_trip(name, tp):
    """Every rank's params (strided leaves included) gather back to the
    whole bitwise; the recurrent blocks' heads lie on one rank each, in
    the padded layout; each rank's part of a whole state equals its
    model's ``init_cache`` shapes and the parts gather back bitwise."""
    from repro_torch.models import Model
    from repro_torch.train.tree import leaves
    cfg = _cfg(get_config, name)
    why = sharding.unsupported(cfg, tp)
    if (name, tp) in REFUSED:
        assert REFUSED[(name, tp)] in why
        return
    assert why is None
    full = Model(cfg).init(torch.Generator().manual_seed(0))
    parts = [sharding.shard_params(full, r, tp, cfg=cfg) for r in range(tp)]
    got = sharding.gather_params(parts, cfg, tp)
    for a, b in zip(leaves(got), leaves(full)):
        assert torch.equal(a, b)
    blocks = ("mamba",) if _zamba(name) else ("mlstm", "slstm")
    nh = sharding.mamba_dims(cfg.d_model, cfg.ssm)[1] if _zamba(name) else cfg.n_heads
    c = -(-nh // tp)
    for block in blocks:
        heads = []
        for r in range(tp):
            lo, hi = sharding.recurrent_heads(cfg, r, tp, block)
            assert (lo, hi) == (min(r * c, nh), min((r + 1) * c, nh))
            heads += range(lo, hi)
        assert heads == list(range(nh))
    whole = Model(cfg).init_cache(2, 32)
    gen = torch.Generator().manual_seed(1)
    for _, _, t, _ in Model(cfg).state_leaves(whole):
        t.copy_(torch.randn(t.shape, generator=gen))
    for key, name_, t, ax in Model(cfg).state_leaves(whole):
        ranks = []
        for r in range(tp):
            g = types.SimpleNamespace(rank=r, size=tp)
            mine = Model(cfg, group=g)
            want = [u for k, n_, u, _ in mine.state_leaves(
                mine.init_cache(2, 32)) if (k, n_) == (key, name_)][0]
            part = sharding.take_state(t, cfg, name_, r, tp)
            assert part.shape == want.shape, (name_, r)
            ranks.append(part)
        assert torch.equal(sharding.gather_state(ranks, cfg, name_, tp), t)


def test_unsupported_names_what_does_not_split():
    """xlstm-125m's sLSTM width 1024 splits over 2, 4 and 16, not 3; the
    JAX tiny config's 85 over none; zamba2's shared block's ``d_ff``."""
    x = get_config("xlstm-125m")
    for tp in (2, 4, 16):
        assert sharding.unsupported(x, tp) is None
    assert "feed-forward width 1024" in sharding.unsupported(x, 3)
    assert "width 85" in sharding.unsupported(get_config("xlstm-125m-tiny"),
                                              2)
    assert "d_ff 128" in sharding.unsupported(
        get_config("zamba2-1.2b-tiny"), 3)
    assert sharding.unsupported(get_config("zamba2-1.2b"), 16) is None


# --------------------------------------------------------- the ranks' side
def _logit_inputs(vocab):
    rng = np.random.default_rng(5)
    return {"toks": rng.integers(0, vocab, (2, 16)).astype(np.int32),
            "lengths": np.array([11, 16], np.int32),
            "ext": rng.integers(0, vocab, (2, 16)).astype(np.int32),
            "n_new": np.array([9, 16], np.int32),
            "dec": rng.integers(0, vocab, (2, 2, 1)).astype(np.int32)}


def _port_cache(model, c1, lengths):
    """A prefill cache scattered through a permuted block table, its state
    copied in, as the engine does slot by slot."""
    Bc = len(lengths)
    cache = model.init_cache(Bc, MAX_LEN)
    maxp, _ = model.page_geometry(Bc, MAX_LEN)
    table = torch.randperm(Bc * maxp, generator=torch.Generator()
                           .manual_seed(3)).reshape(Bc, maxp).int()
    cache["block_table"] = table
    ps = model.page_size
    for (_, pools), (_, kv) in zip(model.attention_caches(cache),
                                   model.attention_caches(c1)):
        pos = torch.arange(kv["k"].shape[2])
        for b in range(Bc):
            page = table[b, pos // ps].long()
            pools["k_pages"][:, page, pos % ps] = kv["k"][:, b]
            pools["v_pages"][:, page, pos % ps] = kv["v"][:, b]
    for (_, _, t, _), (_, _, one, _) in zip(model.state_leaves(cache),
                                            model.state_leaves(c1)):
        t.copy_(one)
    cache["lengths"] = torch.tensor(lengths, dtype=torch.int32)
    return cache


def port_logits(name, params_np, group=None):
    """Prefill two rows (one with a pad tail), extend them (zamba2), two
    decode steps: the logits (at tp = 1 without ``group``)."""
    from repro_torch.configs import get_config as get
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import Model
    cfg = _cfg(get, name)
    params = params_from_numpy(params_np)
    if group is not None:
        params = sharding.shard_params(params, group.rank, group.size,
                                       cfg=cfg)
    model = Model(cfg, page_size=16, group=group)
    inp = {k: torch.from_numpy(v) for k, v in
           _logit_inputs(cfg.vocab).items()}
    out = []
    with torch.no_grad():
        logits, c1 = model.prefill(params, inp["toks"],
                                   lengths=inp["lengths"])
        out.append(logits)
        cache = _port_cache(model, c1, inp["lengths"].tolist())
        if _zamba(name):
            logits, cache = model.extend(params, cache, inp["ext"],
                                         inp["n_new"])
            out.append(logits)
        for tok in inp["dec"]:
            logits, cache = model.decode(params, cache, tok)
            out.append(logits)
    return [o.numpy() for o in out]


def _requests(technique, vocab, gen, gen_cfg):
    """Every arrival at 0, so the decisions depend on no latency."""
    pd = technique.startswith("pd")
    reqs = gen(gen_cfg(
        n_requests=4 if pd else 6, rate=50.0, vocab=vocab, seed=3,
        mean_prompt=40 if pd else 30, mean_output=5 if pd else 8,
        sigma_prompt=0.4, sigma_output=0.3, max_prompt=60,
        max_output=6 if pd else 10, share_fraction=0.0))
    for r in reqs:
        r.arrival = 0.0
    return reqs


def _sched(technique, name, cls, engine_cls):
    """zamba2 in 16-token chunks (a slot sits mid-prefill through the
    others' decodes; P/D in batches of one, so the handoffs land at
    latency-set times); xLSTM, which has no extend, whole prompts."""
    if technique.startswith("pd"):
        return cls(max_batch_size=1, max_batch_tokens=64,
                   chunked_prefill=True, prefill_chunk=16)
    if not _zamba(name):
        return engine_cls(2)
    return cls(max_batch_size=2, max_batch_tokens=64, chunked_prefill=True,
               prefill_chunk=16)


def _engine_tps(technique, tp):
    if technique == "pd-2to1":
        return {"p0": tp, "d0": 1}
    if technique == "pd-1to2":
        return {"p0": 1, "d0": tp}
    if technique.startswith("pd"):
        return {"p0": tp, "d0": tp}
    return {"e0": tp}


def port_serve(technique, name, job, group=None, device="cpu"):
    """Serve on the port (at tp = 1 without ``group``): tokens, decisions,
    the InstanceCfgs the simulators take, the handoff bytes and every
    engine's state leaf shapes."""
    from repro_torch.configs import get_config as get
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.config import SchedulerCfg, engine_scheduler_cfg
    from repro_torch.serve import DriverCfg, ServeDriver, ServingEngine
    from repro_torch.serve.driver import engine_instance_cfg
    from repro_torch.workload import ShareGPTConfig, generate
    cfg = _cfg(get, name)
    params = params_from_numpy(job["params"][name])
    kw = dict(max_batch=2, max_len=128, device=device)
    tps = _engine_tps(technique, 1 if group is None else group.size)

    def at(tp):
        if group is None:
            return dict(tp=1)
        return dict(tp=tp, group=group) if tp > 1 else \
            dict(tp=1, replicas=group)
    if technique.startswith("pd"):
        engines = [ServingEngine(cfg, params, name="p0", role="prefill",
                                 **kw, **at(tps["p0"])),
                   ServingEngine(cfg, params, name="d0", role="decode",
                                 **kw, **at(tps["d0"]))]
    else:
        engines = [ServingEngine(cfg, params, name="e0", **kw,
                                 **at(tps["e0"]))]
    shipped = []
    if technique.startswith("pd"):      # the first handoff's state leaves
        p0, export = engines[0], engines[0]._export_slot

        def record(*a, **k):
            out = export(*a, **k)
            if not shipped:
                leaves = p0.model.state_leaves(p0.cache)
                shipped.append({
                    "tag": out.get("_state_rank"),
                    "shapes": [tuple(out[key][n].shape)
                               for key, n, _, _ in leaves],
                    "own": [tuple(t.select(ax, 0).shape)
                            for _, _, t, ax in leaves]})
            return out
        p0._export_slot = record
    sched = _sched(technique, name, SchedulerCfg, engine_scheduler_cfg)
    drv = ServeDriver(engines, DriverCfg(scheduler=sched),
                      pd_map=PD if technique.startswith("pd") else None)
    m = drv.run(_requests(technique, cfg.vocab, generate, ShareGPTConfig),
                warmup=False)
    insts = drv.runtime.instances
    return {"finished": m["finished"],
            "tokens": {n: dict(i.backend.out_tokens)
                       for n, i in insts.items()},
            "decisions": {n: list(i.decisions) for n, i in insts.items()},
            "icfgs": [engine_instance_cfg(e, sched) for e in engines],
            "network_bytes": m.get("network_bytes"),
            "shipped": shipped[0] if shipped else None,
            "state": {e.name: [tuple(t.shape) for _, _, t, _ in
                               e.model.state_leaves(e.cache)]
                      for e in engines}}


def _train(grid, job, names, zero1=False):
    """Two AdamW steps of each case on ``grid``: per-step metrics, the
    rank's first moments after step 1 (its ZeRO-1 slice under ``zero1``)
    and its params after step 2 (numpy, by leaf)."""
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
            job["params"][name]), grid, zero1)
        step = make_train_step(model, opt, TrainStepConfig(), grid=grid,
                               zero1=zero1)
        mets, mu = [], None
        for batch in job["batches"][name]:
            mine = shard_batch({k: torch.from_numpy(v)
                                for k, v in batch.items()},
                               grid.dp_rank, grid.dp_size)
            state, met = step(state, mine)
            mets.append({k: float(v) for k, v in met.items()})
            if mu is None:
                mu = [t.detach().clone().numpy()
                      for t in leaves(state.opt.mu)]
        out[name] = {"metrics": mets, "mu": mu, "params": [
            t.detach().numpy() for t in leaves(state.params)]}
    return out


def _rank(group, job):
    """One rank of a spawn: the logits, the serves, then two training
    steps on a (1, tp) grid, and at tp = 4 on a (2, 2) grid, made over the
    spawn's world."""
    from repro_torch.launch.mesh import grid_mesh, grid_on_world
    spawn = SPAWNS[group.size]
    out = {"rank": group.rank,
           "logits": {n: port_logits(n, job["params"][n], group)
                      for n in spawn["logits"]},
           "serve": {run: port_serve(*run, job, group, group.device)
                     for run in spawn["serve"]}}
    if spawn.get("train"):
        grid = grid_on_world(grid_mesh(1, group.size), group.rank,
                             group.device, group.backend)
        out["train"] = _train(grid, job, spawn["train"])
    if spawn.get("grid22"):
        grid = grid_on_world(grid_mesh(2, 2), group.rank, group.device,
                             group.backend)
        out["coords"] = grid.coords
        out["grid22"] = {z1: _train(grid, job, spawn["grid22"], z1)
                         for z1 in (False, True)}
    return out


# ------------------------------------------------------ the JAX package's
def _noisy(tree, rng):
    """Zero-init scales and biases get noise, so a term that is zero at
    init cannot hide a missing one."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _noisy(v, rng)
        elif "norm" in k or k in ("conv_b", "b_gates", "f_bias"):
            out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


def _jax_params_and_steps(name):
    """The JAX weights (numpy, perturbed), two batches and the JAX
    one-device train step's metrics, first moments after step 1 and final
    params on them."""
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
    mets, mu = [], None
    for b in batches:
        js, met = step(js, {k: jnp.asarray(v) for k, v in b.items()})
        mets.append({k: float(v) for k, v in met.items()})
        if mu is None:
            mu = [np.asarray(x) for x in jax.tree_util.tree_leaves(js.opt.mu)]
    return params, batches, mets, {"mu": mu, "params": [
        np.asarray(x) for x in jax.tree_util.tree_leaves(js.params)]}


def _jax_model(name):
    from repro.configs import get_config as jget
    from repro.models import Model as JaxModel
    return JaxModel(dataclasses.replace(_cfg(jget, name),
                                        kernels="reference"), remat=False)


def _jax_cache(jm, c1, Bc, lengths):
    """A JAX prefill cache inside a contiguous ``MAX_LEN`` cache."""
    import jax.numpy as jnp

    def put(big, small, attn):
        if isinstance(big, dict):
            return {k: put(big[k], small[k], attn or k == "attn")
                    for k in big}
        return big.at[:, :, :small.shape[2]].set(small) if attn else small
    big = jm.init_cache(Bc, MAX_LEN)
    out = {k: put(big[k], c1[k], False) for k in big if k != "lengths"}
    out["lengths"] = jnp.asarray(lengths, jnp.int32)
    return out


def _jax_logits(name, params):
    """``port_logits``' calls on the JAX ``Model``."""
    import jax
    import jax.numpy as jnp
    jm = _jax_model(name)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    inp = _logit_inputs(jm.cfg.vocab)
    logits, c1 = jm.prefill(jp, jnp.asarray(inp["toks"]),
                            lengths=jnp.asarray(inp["lengths"]))
    out = [np.asarray(logits)]
    cache = _jax_cache(jm, c1, 2, inp["lengths"])
    if _zamba(name):
        logits, cache = jm.extend(jp, cache, jnp.asarray(inp["ext"]),
                                  jnp.asarray(inp["n_new"]))
        out.append(np.asarray(logits))
    for tok in inp["dec"]:
        logits, cache = jm.decode(jp, cache, jnp.asarray(tok))
        out.append(np.asarray(logits))
    return out


def _bucket(n, lo=16):
    b = lo
    while b < n:
        b *= 2
    return b


def _oracle(name, params, reqs, decisions):
    """Each request's tokens from jitted JAX ``Model`` calls on its own
    contiguous B = 1 cache: ``prefill`` on the first chunk's bucket,
    ``extend`` for each further chunk (bucketed, as the engine pads it),
    then greedy ``decode``.  The chunk plan is read from the decisions."""
    import jax
    import jax.numpy as jnp
    jm = _jax_model(name)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    prefill, extend, decode = (jax.jit(f) for f in
                               (jm.prefill, jm.extend, jm.decode))
    vocab = jm.cfg.vocab
    plan = {}
    for it in decisions:
        for rid, phase, n in it:
            if phase == "prefill":
                plan.setdefault(rid, []).append(n)
    out = {}
    for r in reqs:
        toks = list(r.prompt_tokens)
        chunks = plan[r.req_id]
        assert sum(chunks) == len(toks)

        def padded(a, b):
            pad = np.zeros((1, _bucket(b - a)), np.int32)
            pad[0, :b - a] = toks[a:b]
            return jnp.asarray(pad)
        n = chunks[0]
        logits, c1 = prefill(jp, padded(0, n),
                             lengths=jnp.asarray([n], jnp.int32))
        cache = _jax_cache(jm, c1, 1, [n])
        for c in chunks[1:]:
            logits, cache = extend(jp, cache, padded(n, n + c),
                                   jnp.asarray([c], jnp.int32))
            n += c
        tok = int(np.argmax(np.asarray(logits)[0, 0, :vocab]))
        got = [tok]
        while len(got) < r.output_len:
            logits, cache = decode(jp, cache,
                                   jnp.asarray([[tok]], jnp.int32))
            tok = int(np.argmax(np.asarray(logits)[0, 0, :vocab]))
            got.append(tok)
        out[r.req_id] = got
    return out


@pytest.fixture(scope="module")
def jax_side():
    """Each variant's JAX weights, batches and one-device steps."""
    pytest.importorskip("jax")
    return {name: _jax_params_and_steps(name) for name in VARIANTS}


def _job(jax_side):
    return {"params": {n: r[0] for n, r in jax_side.items()},
            "batches": {n: r[1] for n, r in jax_side.items()}}


@pytest.fixture(scope="module")
def spawns(jax_side):
    from repro_torch.launch.mesh import run_ranks
    return {tp: run_ranks(_rank, tp, _job(jax_side), device="cpu",
                          timeout_s=400) for tp in SPAWNS}


# ------------------------------------------------------------- serving
LOGITS = tuple((tp, n) for tp, s in SPAWNS.items() for n in s["logits"])


@pytest.mark.parametrize("tp,name", LOGITS,
                         ids=[f"tp{tp}-{n}" for tp, n in LOGITS])
def test_logits_equal_tp1_and_jax(spawns, jax_side, tp, name):
    """f32: every rank's prefill, extend (zamba2) and decode logits equal
    the port's at tp = 1 and the JAX ``Model``'s within 1e-5."""
    params = jax_side[name][0]
    want = port_logits(name, params)
    jwant = _jax_logits(name, params)
    assert len(want) == len(jwant) == (4 if _zamba(name) else 3)
    for r in spawns[tp]:
        got = r["logits"][name]
        assert len(got) == len(want)
        for g, w, jw in zip(got, want, jwant):
            np.testing.assert_allclose(g, w, **TOL)
            np.testing.assert_allclose(g, jw, **TOL)


@pytest.fixture(scope="module")
def tp1(jax_side):
    """The port's serves at tp = 1 (a P/D pair of any tp: P/D)."""
    out = {}
    for _, (technique, name) in SERVES:
        ref = "pd" if technique.startswith("pd") else technique
        if (ref, name) not in out:
            out[(ref, name)] = port_serve(ref, name, _job(jax_side))
    return out


def _ref(run):
    technique, name = run
    return ("pd" if technique.startswith("pd") else technique), name


@pytest.mark.parametrize("tp,run", SERVES,
                         ids=[f"tp{tp}-{t}-{n}" for tp, (t, n) in SERVES])
def test_serve_tokens_equal_tp1_and_oracle(spawns, tp1, jax_side, tp, run):
    """Every rank emits the same tokens and makes the same decisions as
    the port at tp = 1, the tokens those of per-request JAX ``Model``
    calls; every engine's state holds its rank's heads."""
    from repro_torch.models import Model
    from repro_torch.workload import ShareGPTConfig, generate
    technique, name = run
    want = tp1[_ref(run)]
    cfg = _cfg(get_config, name)
    for r in spawns[tp]:
        got = r["serve"][run]
        assert got["finished"] == want["finished"] > 0
        assert got["tokens"] == want["tokens"]
        assert got["decisions"] == want["decisions"]
        for eng, t in _engine_tps(technique, tp).items():
            g = types.SimpleNamespace(rank=r["rank"], size=t) \
                if t > 1 else None
            m = Model(cfg, group=g)
            assert got["state"][eng] == [tuple(x.shape) for _, _, x, _ in
                                         m.state_leaves(m.init_cache(2, 128))]
    prefill = "p0" if technique.startswith("pd") else "e0"
    last = "d0" if technique.startswith("pd") else "e0"
    reqs = _requests(technique, cfg.vocab, generate, ShareGPTConfig)
    assert want["tokens"][last] == _oracle(
        name, jax_side[name][0], reqs, want["decisions"][prefill])


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
    sim = cluster.Cluster(core.ClusterCfg(
        instances=tuple(icfgs), router=core.RouterCfg("round_robin"),
        pd_map=PD if technique.startswith("pd") else None))
    sim.submit_workload(_requests(technique, vocab, workload.generate,
                                  workload.ShareGPTConfig))
    m = sim.run()
    return m, {n: list(i.decisions) for n, i in sim.instances.items()}


@pytest.mark.parametrize("tp,run", SERVES,
                         ids=[f"tp{tp}-{t}-{n}" for tp, (t, n) in SERVES])
def test_serve_decisions_equal_both_simulators(spawns, tp, run):
    """The ranks' decisions equal the port's and the JAX simulators' at
    each engine's ``parallelism.tp``."""
    technique, name = run
    cfg = _cfg(get_config, name)
    r0 = spawns[tp][0]["serve"][run]
    icfgs = r0["icfgs"]
    assert {i.name: (i.parallelism.tp, i.n_devices) for i in icfgs} == \
        {n: (t, t) for n, t in _engine_tps(technique, tp).items()}
    pm, pdec = _simulate("repro_torch", icfgs, technique, cfg.vocab)
    jm, jdec = _simulate("repro", [_to_jax(i) for i in icfgs], technique,
                         cfg.vocab)
    assert pm["finished"] == jm["finished"] == r0["finished"]
    assert r0["decisions"] == pdec == jdec


@pytest.mark.parametrize("technique", ["pd-2to2", "pd-2to1", "pd-1to2"])
def test_pd_across_tp_ships_tp1_bytes(spawns, tp1, technique):
    """Every handoff counts tp = 1's bytes on every rank: the K/V heads
    and recurrent state entries each rank owns summed.  Between engines of
    the same tp each rank ships its own state part (tagged with its rank),
    between engines of different tp the whole state (gathered by a tp = 2
    prefill group, taken apart by a tp = 2 decode group)."""
    want = tp1[("pd", "z")]["network_bytes"]
    whole = tp1[("pd", "z")]["shipped"]
    assert want["d0<->p0"] > 0 and whole["tag"] is None
    for r in spawns[2]:
        got = r["serve"][(technique, "z")]
        assert got["network_bytes"] == want
        if technique == "pd-2to2":
            assert got["shipped"]["tag"] == (r["rank"], 2)
            assert got["shipped"]["shapes"] == got["shipped"]["own"] != \
                whole["shapes"]
        else:
            assert got["shipped"]["tag"] is None
            assert got["shipped"]["shapes"] == whole["shapes"]


def test_restore_refuses_another_ranks_state():
    """A payload of one rank's recurrent state part does not restore into
    an engine that is not that rank (here a tp = 1 engine)."""
    from repro_torch.models import Model
    from repro_torch.serve import ServingEngine
    cfg = _cfg(get_config, "z")
    eng = ServingEngine(cfg, Model(cfg).init(torch.Generator().manual_seed(0)),
                        max_batch=2, max_len=64, device="cpu")
    eng.ensure_capacity(0, 8)
    payload = eng._export_slot(0, 8)
    eng._restore_slot(1, payload, 8)            # whole: restores
    payload["_state_rank"] = (1, 2)
    with pytest.raises(ValueError, match="state part"):
        eng._restore_slot(1, payload, 8)


# ------------------------------------------------------------- training
#: the moments' atol as a share of the leaf's largest |entry| against
#: the port at tp = 1: ``test_torch_train.py``'s gradient rule (1e-5 for
#: zamba2, whose SSD sums exponentials of cumulative decays in another
#: order: its ranks' all-reduces move the embedding's gradient by up to
#: 3e-6 of its largest); against JAX its zamba2 share for both families
#: (on these batches the port at tp = 1 differs from JAX by up to 2.7e-6
#: of a leaf's largest first moment for ``x``, 3.7e-6 for ``z``)
GRAD_ATOL = {"z": 1e-5, "z3": 1e-5, "x": 1e-6}
JAX_GRAD_ATOL = 1e-5


def _gathered(ranks, key, name, dp, tp, what="params", zero1=False):
    """Each data row's ``what`` ("params", or "mu": the first moments after
    step 1, each data rank's ZeRO-1 slice put back on its dim) gathered
    to the JAX layout."""
    from repro_torch.models import Model
    from repro_torch.train.tree import leaves, unflatten
    cfg = _cfg(get_config, name)
    template = Model(cfg).init(torch.Generator(), device="meta")
    rows = []
    for d in range(dp if not (zero1 and what == "mu") else 1):
        parts = []
        for t in range(tp):
            shard = sharding.shard_params(template, t, tp, cfg=cfg)
            if zero1 and what == "mu":      # the data ranks' slices
                plans = sharding.leaf_plan(shard, cfg, tp, t, dp, True)
                cols = [key(ranks[r * tp + t])[name][what]
                        for r in range(dp)]
                flat = [a[0] if p.zero1_dim is None else
                        np.concatenate(a, axis=p.zero1_dim)
                        for a, p in zip(zip(*cols), plans)]
            else:
                flat = key(ranks[d * tp + t])[name][what]
            parts.append(unflatten(shard, [torch.from_numpy(a)
                                           for a in flat]))
        rows.append([x.numpy() for x in leaves(
            sharding.gather_params(parts, cfg, tp))])
    return rows


def _check_training(ranks, key, name, dp, tp, jax_side, tp1, zero1=False):
    """Every rank's loss, grad norm, lr and token count at both steps
    equal JAX's within TRAIN_TOL; the first moments after step 1 (0.1
    times the clipped gradient, completed over the grid) equal the port's
    at tp = 1 within rtol 1e-4 and ``GRAD_ATOL`` of their leaf's largest
    entry, and JAX's within rtol 1e-4 and ``JAX_GRAD_ATOL``; every data
    row's params after step 2 are equal, and equal the port's at tp = 1
    and JAX's by ``_assert_params``, on at least half of the entries
    (60-63 % for zamba2, 70 % against JAX and 96 % against tp = 1 for
    xLSTM on these batches; the rest every entry within 2 · lr ·
    steps)."""
    _, _, jmets, jstate = jax_side[name]
    for r in ranks:
        got = key(r)[name]["metrics"]
        assert len(got) == len(jmets) == STEPS
        for g, w in zip(got, jmets):
            for k in ("loss", "loss_total", "grad_norm", "lr", "tokens"):
                np.testing.assert_allclose(g[k], w[k], **TRAIN_TOL,
                                           err_msg=f"{name} {k}")
    mu = _gathered(ranks, key, name, dp, tp, "mu", zero1)[0]
    for want, share, who in ((tp1[name]["mu"], GRAD_ATOL[name], "tp = 1"),
                             (jstate["mu"], JAX_GRAD_ATOL, "JAX")):
        for i, (a, b) in enumerate(zip(mu, want)):
            top = float(np.abs(b).max()) if b.size else 0.0
            np.testing.assert_allclose(
                a, b, rtol=1e-4, atol=share * top,
                err_msg=f"{name}: moment of leaf {i} against {who}")
    rows = _gathered(ranks, key, name, dp, tp)
    for row in rows[1:]:
        for a, b in zip(row, rows[0]):
            np.testing.assert_array_equal(a, b)
    for ref, who, share in ((tp1[name], "tp = 1", GRAD_ATOL[name]),
                            (jstate, "JAX", JAX_GRAD_ATOL)):
        held = _assert_params(rows[0], ref["params"], ref["mu"], share,
                              f"{name} against {who}")
        assert held >= 0.5, (name, who, held)
    return rows[0]


def _assert_params(got, want, want_mu, share, what):
    """``test_torch_train.py``'s rule on the params after two steps (at
    most one, or 1 in 1000, of a leaf's entries outside TRAIN_TOL, every
    entry within 2 · lr · steps), held on the entries whose reference
    first moment after step 1 is exactly zero or at least ``share · lr ·
    steps / atol`` of its leaf's largest.  Adam divides each entry's step by its own
    gradient, so the gradient's rounding floor (``share`` of the leaf's
    largest, the moments' rule above) becomes a params error of about lr
    · share · top / |g| a step: under that floor it exceeds TRAIN_TOL's
    atol whatever the code (the sLSTM's input-gate bias, whose gradient
    its stabilizer absorbs, lies far under it).  Returns the share of
    the entries held."""
    scale = share * LR * STEPS / TRAIN_TOL["atol"]
    held = total = 0
    for i, (a, b, m) in enumerate(zip(got, want, want_mu)):
        keep = (m == 0) | (np.abs(m) >= scale * (
            float(np.abs(m).max()) if m.size else 0.0))
        off = keep & ~np.isclose(a, b, **TRAIN_TOL)
        assert off.sum() <= max(1, a.size // 1000), \
            (what, i, int(off.sum()), int(keep.sum()), a.size)
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR * STEPS,
                                   err_msg=f"{what}: leaf {i}")
        held += int(keep.sum())
        total += a.size
    return held / total


TRAIN = tuple((tp, n) for tp, s in SPAWNS.items()
              for n in s.get("train", ()))


@pytest.fixture(scope="module")
def tp1_moments(jax_side):
    """The port's first moments after one step at tp = 1, by variant."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import Model
    from repro_torch.train import (AdamW, TrainState, TrainStepConfig,
                                   make_train_step)
    from repro_torch.train.tree import leaves
    out = {}
    for name, (params, batches, _, _) in jax_side.items():
        p = params_from_numpy(params)
        opt = AdamW(lr=LR)
        step = make_train_step(Model(_cfg(get_config, name)), opt,
                               TrainStepConfig())
        st, mu = TrainState(p, opt.init(p)), None
        for b in batches:
            st, _ = step(st, {k: torch.from_numpy(v) for k, v in b.items()})
            if mu is None:
                mu = [t.detach().clone().numpy() for t in leaves(st.opt.mu)]
        out[name] = {"mu": mu, "params": [t.detach().numpy()
                                          for t in leaves(st.params)]}
    return out


@pytest.mark.parametrize("tp,name", TRAIN,
                         ids=[f"1x{tp}-{n}" for tp, n in TRAIN])
def test_training_matches_jax(spawns, jax_side, tp1_moments, tp, name):
    """Two steps on a (1, tp) grid against JAX's one-device step
    (``_check_training``): the replicated leaves a rank reads in part
    summed over the model group, the strided ones gathered back."""
    _check_training(spawns[tp], lambda r: r["train"], name, 1, tp,
                    jax_side, tp1_moments)


GRID22 = tuple((n, z1) for n in SPAWNS[4]["grid22"] for z1 in (False, True))


@pytest.mark.parametrize("name,zero1", GRID22,
                         ids=[f"2x2-{n}-zero1{int(z)}" for n, z in GRID22])
def test_training_2x2_matches_jax(spawns, jax_side, tp1_moments, name,
                                  zero1):
    """A (2, 2) grid against JAX's one-device step (``_check_training``;
    both data rows' params equal); ZeRO-1's params bitwise equal to those
    without, its moments sliced over data."""
    ranks = spawns[4]
    assert [r["coords"] for r in ranks] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]
    got = _check_training(ranks, lambda r: r["grid22"][zero1], name, 2, 2,
                          jax_side, tp1_moments, zero1)
    if zero1:
        plain = _gathered(ranks, lambda r: r["grid22"][False], name, 2,
                          2)[0]
        for a, b in zip(got, plain):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- dry run
MESHES = (("16x16", dict(dp=16, tp=16)), ("2x16x16", dict(multi_pod=True)))
DRY = tuple((a, m) for a in ("zamba2-1.2b", "xlstm-125m") for m in MESHES)


@pytest.mark.parametrize("arch,mesh", DRY,
                         ids=[f"{a}-{m[0]}" for a, m in DRY])
def test_dryrun_recurrent_cells_at_jax_meshes(arch, mesh):
    """The serve cells of the recurrent families count at the JAX study's
    meshes: decode_32k sharded over the model axis (its collectives there),
    long_500k's batch of one as JAX splits it: zamba2's shared attention
    cache over data (the combine's collectives there), xLSTM's state
    replicated over data (nothing to split)."""
    from repro_torch.launch import dryrun
    rec = dryrun.lower_cell(arch, "decode_32k", **mesh[1])
    assert rec["status"] == "ok", rec
    assert rec["collective_bytes_by_axis"]["model"]["all-reduce"] > 0
    if arch == "xlstm-125m":
        assert "xLSTM heads" in rec["note"]
        assert rec["collective_bytes_by_axis"]["model"]["all-gather"] > 0
    else:
        assert rec["kernels"]["paged_attention_decode"]["launches"] > 0
    rec = dryrun.lower_cell(arch, "long_500k", **mesh[1])
    assert rec["status"] == "ok" and "batch_replicated" not in rec, rec
    if arch == "xlstm-125m":
        assert "no attention cache to split over data" in rec["note"]
    else:
        assert rec["collective_bytes_by_axis"]["data"]["all-reduce"] > 0


def test_slstm_backward_bytes_linear_in_seq():
    """One view a step of the sLSTM's gate projection: xlstm-125m's
    train_4k at (16, 1) counts 5.98e12 bytes a rank; indexing the
    projection inside the loop counted 8.51e13 (each step's backward wrote
    a zero gradient of the whole (B, S, 4d) projection).  FLOPs do not
    change."""
    from repro_torch.launch import dryrun
    rec = dryrun.lower_cell("xlstm-125m", "train_4k", dp=16)
    assert rec["status"] == "ok"
    assert rec["roofline"]["hbm_bytes_per_device"] < 8.5e12
    assert rec["roofline"]["t_compute_s"] == pytest.approx(
        0.10548931985938119, rel=1e-9)


def test_slstm_gradients_match_jax():
    """The sLSTM's output and every gradient (input and params) equal
    ``jax.grad`` of the JAX block within 1e-5."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import xlstm as jxl
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import xlstm as txl
    d, nh, eps = 48, 4, 1e-5
    p = _noisy(jax.tree_util.tree_map(np.asarray, jxl.init_slstm(
        jax.random.PRNGKey(3), d, nh)), np.random.default_rng(4))
    x = np.random.default_rng(5).standard_normal((2, 9, d)).astype(
        np.float32)
    w = np.random.default_rng(6).standard_normal((2, 9, d)).astype(
        np.float32)

    def jloss(p, x):
        return (jxl.slstm_forward(p, x, nh, eps) * w).sum()
    jg = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tp_ = params_from_numpy(p)
    for t in tp_.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = (txl.slstm_forward(tp_, tx, nh, eps) * torch.from_numpy(w)).sum()
    np.testing.assert_allclose(float(loss), float(jloss(p, x)), **TOL)
    names = sorted(tp_)
    grads = torch.autograd.grad(loss, [tp_[n] for n in names] + [tx])
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[0][n]), **TOL,
                                   err_msg=n)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jg[1]), **TOL)
