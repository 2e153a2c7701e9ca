"""``shard_experts`` in the port: the MoE experts whole on the model ranks in
GSPMD's padded layout, the tokens carried to them by all-to-all; gloo ranks
on the CPU against the port's one process and the JAX package.

Under ``shard_experts`` rank r of tp holds experts ``sharding.
expert_range(E, r, tp)`` (ceil(E / tp) a rank from rank 0), takes its
share of the tokens, sends its kept entries to their experts' ranks in
static blocks by one all-to-all, gets the outputs back by another, combines
its own tokens and all-gathers them over the model group
(``models/moe.py``).

Without a spawn: the padded expert layout (``expert_range``; the shard and
gather round trip; the leaf plan: an expert leaf has no model-axis
gradient sum and counts once in the norm), ``unsupported`` with and
without the flag, one-device FLOPs against JAX's HLO analyzer on
``Model(shard_experts=True)`` under a 1×1 ``("data", "model")`` mesh, and
the dry run's records at the JAX study's 16×16 mesh.

``repro_torch.launch.mesh.run_ranks`` spawns four gloo ranks once for the
module; grids of two and three ranks lie on the world's first ranks
(``grid_on_world``):

* ``moe_ffn`` layers (f32, random weights) at tp = 2, 3 and 4 and on a
  (2, 2) grid: E = 4 at tp = 3 (2, 2, 0: a rank holds no expert), E = 10
  top-4 at tp = 4 (3, 3, 3, 1), T below tp and not dividing it, capacity
  factors low enough to drop, a routing hook that repeats experts within a
  token, a ``valid`` mask; outputs, aux loss and gradients against the
  port's tp = 1 on the whole batch, the buffer each rank feeds the grouped
  matmul and its group sizes exactly equal to tp = 1's rows of the rank's
  experts (the same drops), and on the (2, 2) grid to today's
  expert-parallel path on the same experts;
* ``Model`` logits of tiny granite-moe variants (2 layers) at (1, 3) and
  (1, 4), and a prefill plus decode at (1, 3) whose batch of two leaves
  rank 2 without tokens, against the port's tp = 1 and JAX's one-device
  ``Model(shard_experts=True)``;
* two AdamW steps with ZeRO-1 on (1, 3) and (2, 2) grids (the latter
  dropping entries) against the port's tp = 1 and JAX's one-device step;
* a decode step's collective bytes by axis and kind on real ranks against
  ``dryrun.lower_cell(..., shard_experts=True)``'s meta count.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
WORLD, PAGE, MAX_LEN = 4, 16, 64
LR, TRAIN_STEPS, TRAIN_B, TRAIN_S = 1e-2, 2, 4, 16
D, F = 8, 6
#: moe_ffn cases: name -> (E, top_k, tokens a data rank, grid (dp, tp),
#: capacity factor, routing hook, valid mask)
LAYER = {
    "e4-tp3": (4, 2, 10, (1, 3), 1.25, False, False),
    "e4-tp3-drop": (4, 2, 12, (1, 3), 0.5, False, False),
    "e4-tp3-valid": (4, 2, 11, (1, 3), 0.5, False, True),
    "e10-tp4": (10, 4, 7, (1, 4), 1.25, False, False),
    "e10-tp4-T2": (10, 4, 2, (1, 4), 1.25, False, False),
    "e10-tp4-T3-drop": (10, 4, 3, (1, 4), 0.3, False, False),
    "e10-tp4-hook": (10, 4, 9, (1, 4), 1.0, True, True),
    "e3-tp2-hook": (3, 2, 5, (1, 2), 0.8, True, False),
    "e4-dp2-drop": (4, 2, 12, (2, 2), 0.5, False, False),
    "e5-dp2-valid": (5, 2, 9, (2, 2), 0.7, False, True),
}
#: Model variants of granite-moe-3b-a800m-tiny (2 layers, f32):
#: name -> MoE overrides
VARIANTS = {
    "g4": {},                                          # 2, 2, 0 at tp 3
    "g10": {"n_experts": 10, "top_k": 4},              # 3, 3, 3, 1 at tp 4
    "g5-drop": {"n_experts": 5, "capacity_factor": 0.5},   # 3, 2 at tp 2
}
LOGITS = (("g4", (1, 3)), ("g10", (1, 4)))
DECODE = ("g4", (1, 3))
TRAIN = (("g4", (1, 3)), ("g5-drop", (2, 2)))
#: the counted decode: B = decode_32k's 128 rows at (1, 3)
COUNT_ARCH, COUNT_TP, COUNT_B = "granite-moe-3b-a800m-tiny", 3, 128
GRIDS = ((1, 2), (1, 3), (1, 4), (2, 2))


def _cfg(get, name):
    cfg = get("granite-moe-3b-a800m-tiny")
    cfg = dataclasses.replace(
        cfg, compute_dtype="float32", n_layers=2,
        stages=(dataclasses.replace(cfg.stages[0], n_layers=2),),
        moe=dataclasses.replace(cfg.moe, **VARIANTS[name]))
    return cfg


# ----------------------------------------------------- without a spawn
@pytest.mark.parametrize("E,tp,want", [
    (40, 16, [3] * 13 + [1, 0, 0]), (40, 3, [14, 14, 12]),
    (4, 3, [2, 2, 0]), (10, 4, [3, 3, 3, 1]), (16, 4, [4] * 4)])
def test_expert_range_is_the_padded_layout(E, tp, want):
    got = [sharding.expert_range(E, r, tp) for r in range(tp)]
    assert [hi - lo for lo, hi in got] == want
    assert got[0][0] == 0 and all(a[1] == b[0] for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("E,tp", [(10, 3), (10, 4), (4, 3), (40, 16),
                                  (3, 4)])
def test_shard_gather_round_trip_padded_experts(E, tp):
    """Each rank's expert leaves are its whole experts (``(0, d, f)`` past
    them); ``gather_params`` restores the JAX layout bitwise."""
    cfg = dataclasses.replace(_cfg(get_config, "g4"), moe=dataclasses.replace(
        get_config("granite-moe-3b-a800m-tiny").moe, n_experts=E))
    from repro_torch.models import Model
    params = Model(cfg).init(torch.Generator().manual_seed(E + tp))
    parts = [sharding.shard_params(params, r, tp, cfg=cfg,
                                   shard_experts=True) for r in range(tp)]
    for r, part in enumerate(parts):
        lo, hi = sharding.expert_range(E, r, tp)
        for name in ("w_gate", "w_up", "w_down"):
            got = part["stage0"]["moe"][name]
            want = params["stage0"]["moe"][name][:, lo:hi]
            assert got.shape == want.shape
            assert torch.equal(got, want)
    back = sharding.gather_params(parts, cfg, tp, shard_experts=True)
    from repro_torch.train.tree import leaves
    for a, b in zip(leaves(back), leaves(params)):
        assert torch.equal(a, b)


def test_leaf_plan_keeps_expert_grads_on_their_rank():
    """Under the flag an expert leaf ``(L, E, d, f)`` is split on its
    expert dim (the rank's own experts), has no model-axis gradient sum,
    counts in the norm as the rank's part, and ZeRO-1 splits another dim;
    without it, E = 4 and d_expert 32 do not split over tp = 3."""
    cfg = _cfg(get_config, "g4")
    from repro_torch.models import Model
    params = Model(cfg).init(torch.Generator(), device="meta")
    for rank in range(3):
        mine = sharding.shard_params(params, rank, 3, cfg=cfg,
                                     shard_experts=True)
        plans = {p.path[-1]: p for p in sharding.leaf_plan(
            mine, cfg, 3, rank, data=2, zero1=True, shard_experts=True)
            if "moe" in p.path}
        for name in ("w_gate", "w_up", "w_down"):
            p = plans[name]
            assert p.split and p.grad_sum is None and p.norm == "model"
            assert sharding.model_dim(p.path, 4, cfg, 3, True) == 1
            assert p.zero1_dim not in (None, 1)
        assert not plans["router"].split
    assert sharding.unsupported(cfg, 3) is not None


@pytest.mark.parametrize("E,d_expert,tp", [(10, 30, 4), (40, 510, 16),
                                           (5, 7, 2)])
def test_unsupported_needs_no_split_under_shard_experts(E, d_expert, tp):
    base = get_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, n_experts=E, d_expert=d_expert))
    why = sharding.unsupported(cfg, tp)
    assert why is not None and "experts do not split" in why
    assert sharding.unsupported(cfg, tp, shard_experts=True) is None


def test_one_device_flops_match_hlo_under_the_hint():
    """B4 S64 prefill of ``Model(shard_experts=True)`` on one device: the
    hint changes nothing (no group), and the FLOPs equal JAX's HLO
    analyzer's on its hinted model under a 1×1 mesh, to the unit."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import Model as JaxModel
    from repro.roofline.hlo_analyzer import HloAnalyzer
    from repro_torch.launch import dryrun
    from repro_torch.models import Model
    arch = "granite-moe-1b-a400m-tiny"
    jm = JaxModel(jget(arch), remat=False, shard_experts=True)
    jparams = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    with _mesh(jax):
        compiled = jax.jit(jm.prefill).lower(
            jparams, jax.ShapeDtypeStruct((4, 64), jnp.int32)).compile()
    want = HloAnalyzer(compiled.as_text()).analyze().flops
    tm = Model(get_config(arch), remat=False, shard_experts=True)
    c, _, _ = dryrun.count_step(tm, "prefill", {
        "params": tm.init(torch.Generator().manual_seed(0)),
        "tokens": torch.zeros((4, 64), dtype=torch.int32)})
    assert c.flops + sum(k.plain_flops for k in c.kernels.values()) == want
    assert not c.coll_bytes


def test_dryrun_train_4k_counts_all_to_all_at_16x16():
    """granite-moe-1b-a400m's ``train_4k`` at 16×16 with ZeRO-1 (the JAX
    study's hill-climb cell, at 2 microbatches rather than 8 to keep the
    test short; ``tools/dryrun_shard_experts.py`` counts the 8):
    ``status: ok``, the model axis's all-to-all bytes by formula (two
    all-to-alls a MoE layer forward, two backward, two in each layer's
    recompute), less all-reduce than without the hint (none of the MoE
    output), and the note naming rank 0's experts."""
    from repro_torch.configs import get_shape
    from repro_torch.core.expert import expert_capacity
    from repro_torch.launch import dryrun
    arch, mb = "granite-moe-1b-a400m", 2
    cfg = get_config(arch)
    rec = dryrun.lower_cell(arch, "train_4k", dp=16, tp=16, zero1=True,
                            microbatches=mb, shard_experts=True)
    base = dryrun.lower_cell(arch, "train_4k", dp=16, tp=16, zero1=True,
                             microbatches=mb)
    assert rec["status"] == base["status"] == "ok"
    assert rec["shard_experts"] is True and base["shard_experts"] is False
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    shape = get_shape("train_4k")
    T = shape.global_batch // 16 // mb * shape.seq_len
    C = expert_capacity(T * 16, k, E, cfg.moe.capacity_factor)
    n_s = min(C, -(-T // 16))
    lo, hi = sharding.expert_range(E, 0, 16)
    layers = _moe_layers(cfg)
    # bf16 activations: 2 bytes; forward, recompute, backward: 3 of each
    one = (16 * (hi - lo) * n_s + E * n_s) * cfg.d_model * 2
    a2a = rec["collective_bytes_by_axis"]["model"]["all-to-all"]
    assert a2a == mb * 3 * layers * one
    assert "all-to-all" not in base["collective_bytes_by_axis"]["model"]
    assert rec["collective_bytes_by_axis"]["model"]["all-reduce"] < \
        base["collective_bytes_by_axis"]["model"]["all-reduce"]
    assert f"experts {lo}-{hi - 1}" in rec["note"]


def _moe_layers(cfg):
    return sum(st.n_layers for st in cfg.stages if st.kind == "attn_moe")


def _mesh(jax):
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


# ------------------------------------------------------------ the layer
def _hook(logits, *, positions, layer, top_k, valid=None):
    """A forced routing that repeats an expert within some tokens, its
    combine weights the router's softmax over the chosen experts."""
    E = logits.shape[-1]
    p = positions.long()
    idx = torch.stack([(p * (j + 1) + j) % E for j in range(top_k)], dim=1)
    w = torch.softmax(logits.gather(1, idx), dim=-1)
    return idx.to(torch.int32), w, torch.zeros((), device=logits.device)


def _layer_inputs(name):
    E, _, T, (dp, _), _, _, valid = LAYER[name]
    rng = np.random.default_rng(sorted(LAYER).index(name))
    params = {"router": rng.standard_normal((D, E)),
              "w_gate": 0.3 * rng.standard_normal((E, D, F)),
              "w_up": 0.3 * rng.standard_normal((E, D, F)),
              "w_down": 0.3 * rng.standard_normal((E, F, D))}
    return {"x": rng.standard_normal((dp * T, D)).astype(np.float32),
            "params": {a: b.astype(np.float32) for a, b in params.items()},
            "valid": (rng.random(dp * T) < 0.7) if valid else None}


class _Spy:
    """Records the first grouped-matmul input of each ``moe_ffn`` call
    (the gate's: the dispatched buffer) and its group sizes."""

    def __enter__(self):
        import repro_torch.models.moe as moe
        self.moe, self.orig, self.got = moe, moe.grouped_matmul, []

        def spy(x, w, gs):
            self.got.append((x.detach().clone().numpy(),
                             gs.detach().clone().numpy()))
            return self.orig(x, w, gs)
        moe.grouped_matmul = spy
        return self

    def __exit__(self, *exc):
        self.moe.grouped_matmul = self.orig


def run_layer(name, inp, group=None, dp_group=None, shard_experts=False,
              dp_rank=0):
    """One ``moe_ffn`` call on the data rank's rows and its backward of
    ``sum(y²) + aux``: y, aux, x's gradient, the params' gradients, the
    dispatched buffer and group sizes (None where no grouped matmul ran)."""
    from repro_torch.models.moe import moe_ffn
    E, k, T, (dp, _), cf, hook, _ = LAYER[name]
    n = T if dp_group is not None else dp * T
    lo = dp_rank * n
    x = torch.from_numpy(inp["x"][lo:lo + n]).requires_grad_(True)
    params = inp["params"]
    if group is not None:
        params = sharding.shard_params(
            {"moe": params}, group.rank, group.size,
            cfg=_layer_cfg(E, k), shard_experts=shard_experts)["moe"]
    params = {a: torch.from_numpy(np.array(b)).requires_grad_(True)
              for a, b in params.items()}
    valid = None if inp["valid"] is None else \
        torch.from_numpy(inp["valid"][lo:lo + n])
    with _Spy() as spy:
        y, aux = moe_ffn(x, params, top_k=k, capacity_factor=cf,
                         router_fn=_hook if hook else None,
                         positions=torch.arange(lo, lo + n), valid=valid,
                         group=group, dp_group=dp_group,
                         shard_experts=shard_experts)
    (y.square().sum() + aux).backward()
    grads = {a: (torch.zeros_like(b) if b.grad is None else b.grad).numpy()
             for a, b in params.items()}
    return {"y": y.detach().numpy(), "aux": float(aux.detach()),
            "gx": x.grad.numpy(), "grads": grads,
            "buf": spy.got[0] if spy.got else None}


def _layer_cfg(E, k):
    """A config whose expert layout ``shard_params`` reads (a MoE layer's
    leaves under ``moe``)."""
    base = get_config("granite-moe-3b-a800m-tiny")
    return dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, n_experts=E, top_k=k, d_expert=F))


# ------------------------------------------------------------ the model
def _batches(vocab, seed=21):
    rng = np.random.default_rng(seed)
    return [{k: rng.integers(0, vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)
             for k in ("inputs", "labels")} for _ in range(TRAIN_STEPS)]


def _decode_inputs(vocab):
    rng = np.random.default_rng(9)
    return {"toks": rng.integers(0, vocab, (2, 16)).astype(np.int32),
            "lengths": np.array([16, 11], np.int32),
            "dec": rng.integers(0, vocab, (3, 2, 1)).astype(np.int32)}


def _shard(params, cfg, group):
    from repro_torch.convert import params_from_numpy
    params = params_from_numpy(params)
    if group is None:
        return params
    return sharding.shard_params(params, group.rank, group.size, cfg=cfg,
                                 shard_experts=True)


def port_logits(name, params_np, toks, group=None):
    from repro_torch.models import Model
    cfg = _cfg(get_config, name)
    model = Model(cfg, group=group, shard_experts=True)
    with torch.no_grad():
        logits, aux = model.forward(_shard(params_np, cfg, group),
                                    torch.from_numpy(toks))
    return logits.numpy(), float(aux)


def port_decode(name, params_np, inp, group=None):
    """A prefill of two rows (16 and 11 tokens) and three decode steps of
    the two rows (T = 2: below tp = 3): every call's logits."""
    from repro_torch.models import Model
    cfg = _cfg(get_config, name)
    params = _shard(params_np, cfg, group)
    model = Model(cfg, page_size=PAGE, group=group, shard_experts=True)
    out = []
    with torch.no_grad():
        logits, c1 = model.prefill(params, torch.from_numpy(inp["toks"]),
                                   lengths=torch.from_numpy(inp["lengths"]))
        out.append(logits.numpy())
        cache = model.init_cache(2, MAX_LEN)
        for (_, pools), (_, kv) in zip(model.attention_caches(cache),
                                       model.attention_caches(c1)):
            pos = torch.arange(kv["k"].shape[2])
            for b in range(2):
                page = cache["block_table"][b, pos // PAGE].long()
                pools["k_pages"][:, page, pos % PAGE] = kv["k"][:, b]
                pools["v_pages"][:, page, pos % PAGE] = kv["v"][:, b]
        cache["lengths"] = torch.from_numpy(inp["lengths"].copy())
        for tok in inp["dec"]:
            logits, cache = model.decode(params, cache,
                                         torch.from_numpy(tok))
            out.append(logits.numpy())
    return out


def port_train(name, params_np, batches, grid=None):
    """Two AdamW steps (ZeRO-1 on a grid): per-step metrics, the first
    moments after step 1 (whole over the data axis) and the params after
    step 2, by leaf, the rank's."""
    from repro_torch.models import Model
    from repro_torch.train import AdamW, TrainStepConfig, make_train_step
    from repro_torch.train.train_step import TrainState, rank_state
    from repro_torch.train.tree import leaves
    cfg = _cfg(get_config, name)
    kw = {} if grid is None else grid.model_kw()
    model = Model(cfg, shard_experts=True, **kw)
    opt = AdamW(lr=LR)
    from repro_torch.convert import params_from_numpy
    full = params_from_numpy(params_np)
    if grid is None:
        state = TrainState(full, opt.init(full))
    else:
        state = rank_state(model, opt, full, grid, True)
    step = make_train_step(model, opt, TrainStepConfig(), grid=grid,
                           zero1=grid is not None)
    mets, mu = [], None
    for batch in batches:
        mine = {k: torch.from_numpy(v) for k, v in batch.items()}
        if grid is not None:
            mine = sharding.shard_batch(mine, grid.dp_rank, grid.dp_size)
        state, met = step(state, mine)
        mets.append({k: float(v) for k, v in met.items()})
        if mu is None:
            mu = _whole_moments(state, cfg, grid)
    return {"metrics": mets, "mu": mu,
            "params": [t.detach().numpy() for t in leaves(state.params)],
            "mu_shapes": [tuple(t.shape) for t in leaves(state.opt.mu)]}


def _whole_moments(state, cfg, grid):
    """The rank's first moments, each ZeRO-1 slice all-gathered over the
    data axis."""
    from repro_torch.train.tree import leaves
    mus = [t.detach().clone() for t in leaves(state.opt.mu)]
    if grid is None:
        return [t.numpy() for t in mus]
    data = grid.mesh.shape["data"]
    plans = sharding.leaf_plan(state.params, cfg, grid.tp,
                               grid.coords["model"], data, True, True)
    out = []
    for t, p in zip(mus, plans):
        if data > 1 and p.zero1_dim is not None:
            t = grid.data.all_gather_dim(t, p.zero1_dim)
        out.append(t.numpy())
    return out


def _count_decode(group):
    """A decode of ``COUNT_B`` rows under a counter on real ranks: the
    collective result bytes by axis and kind (the cache is short: no
    collective reads its length)."""
    from repro_torch.launch import dryrun
    from repro_torch.models import Model
    cfg = get_config(COUNT_ARCH)
    model = Model(cfg, group=group, shard_experts=True)
    params = sharding.shard_params(
        model.init(torch.Generator().manual_seed(0)), group.rank,
        group.size, cfg=cfg, shard_experts=True)
    cache = model.init_cache(COUNT_B, MAX_LEN)
    cache["lengths"] = torch.full((COUNT_B,), 9, dtype=torch.int32)
    c, _, _ = dryrun.count_step(model, "decode", {
        "params": params, "cache": cache,
        "tokens": torch.zeros((COUNT_B, 1), dtype=torch.int32)})
    return {a: {k: int(v) for k, v in d.items()}
            for a, d in c.coll_by_axis.items()}


def _rank(group, job):
    """One rank of the module's spawn of four: each grid (made over the
    world in order; the ranks past a grid's size hold none of it) and what
    it runs."""
    from repro_torch.launch.mesh import grid_mesh, grid_on_world
    grids = {g: grid_on_world(grid_mesh(*g), group.rank, group.device,
                              group.backend) for g in GRIDS}
    out = {"layer": {}, "ep": {}, "logits": {}, "train": {}}
    for name, (E, _, _, g, _, hook, _) in LAYER.items():
        grid = grids[g]
        if grid is None:
            continue
        dpg = grid.dp if grid.dp_size > 1 else None
        args = (name, job["layer"][name], grid.model, dpg)
        out["layer"][name] = run_layer(*args, shard_experts=True,
                                       dp_rank=grid.dp_rank)
        if E % grid.tp == 0 and not hook:
            out["ep"][name] = run_layer(*args, dp_rank=grid.dp_rank)
    for name, g in LOGITS:
        if grids[g] is not None:
            out["logits"][name] = port_logits(name, job["params"][name],
                                              job["toks"], grids[g].model)
    if grids[DECODE[1]] is not None:
        out["decode"] = port_decode(DECODE[0], job["params"][DECODE[0]],
                                    job["decode"], grids[DECODE[1]].model)
    for name, g in TRAIN:
        grid = grids[g]
        if grid is not None:
            out["train"][name] = dict(port_train(
                name, job["params"][name], job["batches"], grid),
                coords=grid.coords)
    count = grids[(1, COUNT_TP)]
    if count is not None:
        out["count"] = _count_decode(count.model)
    return out


# ------------------------------------------------------ the JAX package's
def _noisy(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _noisy(v, rng)
        elif "norm" in k:
            out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


def _jax_side(name, toks, batches):
    """Weights of a variant (drawn by the JAX package) and JAX's
    one-device ``Model(shard_experts=True)`` under a 1×1 mesh: forward
    logits and aux, and two AdamW steps (metrics, first moments after step
    1, params after step 2)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import Model as JaxModel
    from repro.train import AdamW as JaxAdamW
    from repro.train import TrainStepConfig as JaxStepCfg
    from repro.train import make_train_step as jax_make_step
    from repro.train.train_step import TrainState as JaxTrainState
    seed = list(VARIANTS).index(name)
    jm = JaxModel(dataclasses.replace(_cfg(jget, name), kernels="reference"),
                  shard_experts=True)
    params = _noisy(jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed))),
        np.random.default_rng(seed + 11))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    out = {"params": params}
    with _mesh(jax):
        logits, aux = jax.jit(jm.forward)(jp, jnp.asarray(toks))
        out["logits"] = (np.asarray(logits), float(aux))
        if any(n == name for n, _ in TRAIN):
            js = JaxTrainState(jp, JaxAdamW(lr=LR).init(jp))
            step = jax.jit(jax_make_step(jm, JaxAdamW(lr=LR), JaxStepCfg()))
            mets, mu = [], None
            for b in batches:
                js, met = step(js, {k: jnp.asarray(v) for k, v in b.items()})
                mets.append({k: float(v) for k, v in met.items()})
                if mu is None:
                    mu = [np.asarray(x)
                          for x in jax.tree_util.tree_leaves(js.opt.mu)]
            out["train"] = {"metrics": mets, "mu": mu, "params": [
                np.asarray(x) for x in jax.tree_util.tree_leaves(js.params)]}
    return out


@pytest.fixture(scope="module")
def side():
    """Inputs, the JAX package's outputs and the port's tp = 1."""
    pytest.importorskip("jax")
    vocab = get_config("granite-moe-3b-a800m-tiny").vocab
    toks = np.random.default_rng(5).integers(0, vocab, (2, 12)).astype(
        np.int32)
    batches = _batches(vocab)
    decode = _decode_inputs(vocab)
    jx = {n: _jax_side(n, toks, batches) for n in VARIANTS}
    params = {n: jx[n]["params"] for n in VARIANTS}
    layer = {n: _layer_inputs(n) for n in LAYER}
    return {
        "job": {"params": params, "toks": toks, "batches": batches,
                "decode": decode, "layer": layer},
        "jax": jx,
        "layer": {n: run_layer(n, layer[n]) for n in LAYER},
        "logits": {n: port_logits(n, params[n], toks) for n, _ in LOGITS},
        "decode": port_decode(DECODE[0], params[DECODE[0]], decode),
        "train": {n: port_train(n, params[n], batches) for n, _ in TRAIN},
    }


@pytest.fixture(scope="module")
def spawn(side):
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(_rank, WORLD, side["job"], device="cpu",
                     timeout_s=600)


def _ranks(spawn, g):
    return spawn[:g[0] * g[1]]


# -------------------------------------------------------------- checks
@pytest.mark.parametrize("name", LAYER)
def test_layer_equals_tp1(spawn, side, name):
    """``moe_ffn`` under ``shard_experts``: every model rank's output (its
    data rank's rows) and aux equal tp = 1's on the whole batch within
    1e-5, the gradients of x (the data rank's rows), the router (summed
    over the data ranks) and the rank's experts (likewise) too."""
    E, _, T, g, _, _, _ = LAYER[name]
    dp, tp = g
    want = side["layer"][name]
    router = 0
    experts = {a: 0 for a in ("w_gate", "w_up", "w_down")}
    for r, rank in enumerate(_ranks(spawn, g)):
        d, m = divmod(r, tp)
        got = rank["layer"][name]
        rows = slice(d * T, (d + 1) * T) if dp > 1 else slice(None)
        np.testing.assert_allclose(got["y"], want["y"][rows], **TOL)
        np.testing.assert_allclose(got["aux"], want["aux"], **TOL)
        np.testing.assert_allclose(got["gx"], want["gx"][rows], **TOL)
        if m == 0:
            router = router + got["grads"]["router"]
        lo, hi = sharding.expert_range(E, m, tp)
        for a in experts:
            assert got["grads"][a].shape[0] == hi - lo
            if d == 0:
                experts[a] = experts[a] + np.pad(
                    got["grads"][a], [(lo, E - hi), (0, 0), (0, 0)])
            else:
                experts[a][lo:hi] += got["grads"][a]
    np.testing.assert_allclose(router, want["grads"]["router"], **TOL)
    for a in experts:
        np.testing.assert_allclose(experts[a], want["grads"][a], **TOL)


@pytest.mark.parametrize("name", LAYER)
def test_layer_buffer_is_the_expert_parallel_buffer(spawn, side, name):
    """The buffer each rank feeds the grouped matmul and its group sizes
    equal, bitwise, tp = 1's rows of the rank's experts: on one data rank
    the same buffer rows; on the (2, 2) grid each data rank's kept entries
    of an expert are tp = 1's after the lower data ranks', and where E
    divides tp the buffer is today's expert-parallel path's on the same
    experts, row for row.  The same entries kept at the same slots: the
    same drops.  A rank with no expert launches nothing."""
    E, _, _, g, _, _, _ = LAYER[name]
    dp, tp = g
    buf, gs = side["layer"][name]["buf"]
    ranks = _ranks(spawn, g)
    for m in range(tp):
        lo, hi = sharding.expert_range(E, m, tp)
        off = np.zeros(hi - lo, np.int64)
        for d in range(dp):
            rank = ranks[d * tp + m]
            got = rank["layer"][name]["buf"]
            if hi == lo:
                assert got is None
                continue
            if dp == 1:
                np.testing.assert_array_equal(got[0], buf[lo:hi])
                np.testing.assert_array_equal(got[1], gs[lo:hi])
                continue
            if name in rank["ep"]:
                want = rank["ep"][name]["buf"]
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
            for e, n in enumerate(got[1]):
                np.testing.assert_array_equal(
                    got[0][e, :n], buf[lo + e, off[e]:off[e] + n])
                assert not got[0][e, n:].any()
            off += got[1]
        if dp > 1 and hi > lo:
            np.testing.assert_array_equal(off, gs[lo:hi])


def test_layer_cases_drop_and_leave_ranks_empty(side):
    """The cases reach what they name: entries dropped where the capacity
    factor is low, T below tp, a rank with no expert."""
    for name, (E, k, T, g, _, _, valid) in LAYER.items():
        _, gs = side["layer"][name]["buf"]
        routed = T * g[0] * k
        if valid:
            routed = int(side["job"]["layer"][name]["valid"].sum()) * k
        if "drop" in name:
            assert gs.sum() < routed, name
    assert any(T < g[1] for _, _, T, g, *_ in LAYER.values())
    assert any(sharding.expert_range(E, g[1] - 1, g[1])[0] ==
               sharding.expert_range(E, g[1] - 1, g[1])[1]
               for E, _, _, g, *_ in LAYER.values())


@pytest.mark.parametrize("name,g", LOGITS,
                         ids=[f"{g[0]}x{g[1]}-{n}" for n, g in LOGITS])
def test_model_logits_equal_tp1_and_jax(spawn, side, name, g):
    """``Model(shard_experts=True)`` forward at (1, 3) (2, 2, 0 experts)
    and (1, 4) (3, 3, 3, 1): logits and aux equal the port's tp = 1 and
    JAX's one-device hinted model within 1e-5."""
    want, aux = side["logits"][name]
    jwant, jaux = side["jax"][name]["logits"]
    for r in _ranks(spawn, g):
        got, gaux = r["logits"][name]
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, jwant, **TOL)
        np.testing.assert_allclose(gaux, aux, **TOL)
        np.testing.assert_allclose(gaux, jaux, **TOL)


def test_model_decode_below_tp_equals_tp1(spawn, side):
    """A prefill of two rows and three decode steps at (1, 3): a decode
    step's two tokens leave rank 2 with none (and no expert); every call's
    logits equal the port's tp = 1 within 1e-5."""
    want = side["decode"]
    for r in _ranks(spawn, DECODE[1]):
        assert len(r["decode"]) == len(want) == 4
        for a, b in zip(r["decode"], want):
            np.testing.assert_allclose(a, b, **TOL)


def _gathered(ranks, name, dp, tp, what):
    from repro_torch.models import Model
    from repro_torch.train.tree import leaves, unflatten
    cfg = _cfg(get_config, name)
    template = Model(cfg).init(torch.Generator(), device="meta")
    rows = []
    for d in range(dp):
        parts = [unflatten(sharding.shard_params(
            template, t, tp, cfg=cfg, shard_experts=True),
            [torch.from_numpy(a) for a in ranks[d * tp + t][what]])
            for t in range(tp)]
        rows.append([x.numpy() for x in leaves(
            sharding.gather_params(parts, cfg, tp, shard_experts=True))])
    return rows


def _assert_params(got, want, want_mu):
    """``test_torch_train.py``'s count rule on the params after two steps,
    on the entries whose reference first moment is 0 or at least 1e-5 ·
    lr · steps / atol of its leaf's largest (below, Adam's step amplifies
    the gradient's rounding floor); every entry within 2 · lr · steps."""
    scale = 1e-5 * LR * TRAIN_STEPS / TRAIN_TOL["atol"]
    held = total = 0
    for i, (a, b, m) in enumerate(zip(got, want, want_mu)):
        keep = (m == 0) | (np.abs(m) >= scale * (
            float(np.abs(m).max()) if m.size else 0.0))
        off = keep & ~np.isclose(a, b, **TRAIN_TOL)
        assert off.sum() <= max(1, a.size // 1000), (i, int(off.sum()))
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR * TRAIN_STEPS)
        held += int(keep.sum())
        total += a.size
    return held / total


@pytest.mark.parametrize("name,g", TRAIN,
                         ids=[f"{g[0]}x{g[1]}-{n}" for n, g in TRAIN])
def test_training_matches_tp1_and_jax(spawn, side, name, g):
    """Two AdamW steps with ZeRO-1 on a grid against the port's tp = 1 and
    JAX's one-device hinted step: losses, aux and grad norms within
    TRAIN_TOL, the first moments (the gradients) gathered within rtol 1e-4
    and 1e-5 of a leaf's largest, every data row's params equal and held
    by ``_assert_params``; at (2, 2) the moments split over data."""
    dp, tp = g
    ranks = [r["train"][name] for r in _ranks(spawn, g)]
    for want in (side["train"][name], side["jax"][name]["train"]):
        for r in ranks:
            for a, b in zip(r["metrics"], want["metrics"]):
                for k in ("loss", "loss_total", "aux_loss", "grad_norm",
                          "tokens"):
                    np.testing.assert_allclose(a[k], b[k], **TRAIN_TOL,
                                               err_msg=f"{name} {k}")
        mu = _gathered(ranks, name, dp, tp, "mu")[0]
        for i, (a, b) in enumerate(zip(mu, want["mu"])):
            top = float(np.abs(b).max()) if b.size else 0.0
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * top,
                                       err_msg=f"{name}: moment {i}")
        rows = _gathered(ranks, name, dp, tp, "params")
        for row in rows[1:]:
            for a, b in zip(row, rows[0]):
                np.testing.assert_array_equal(a, b)
        assert _assert_params(rows[0], want["params"], want["mu"]) >= 0.5
    split = [tuple(a) != tuple(b) for a, b in zip(
        ranks[0]["mu_shapes"], _rank0_shapes(name, tp))]
    assert any(split) == (dp > 1)


def _rank0_shapes(name, tp):
    """Rank 0's param leaf shapes under the flag (its moments without
    ZeRO-1)."""
    from repro_torch.models import Model
    from repro_torch.train.tree import leaves
    cfg = _cfg(get_config, name)
    shard = sharding.shard_params(
        Model(cfg).init(torch.Generator(), device="meta"), 0, tp, cfg=cfg,
        shard_experts=True)
    return [t.shape for t in leaves(shard)]


def test_meta_count_equals_real_ranks(spawn):
    """``lower_cell(..., shard_experts=True)`` of decode_32k at (1, 3):
    the model axis's collective bytes by kind (two all-to-alls and the
    tokens' all-gather a MoE layer among them) equal what rank 0 of three
    real gloo ranks records on the same rows."""
    from repro_torch.launch import dryrun
    rec = dryrun.lower_cell(COUNT_ARCH, "decode_32k", tp=COUNT_TP,
                            shard_experts=True)
    assert rec["status"] == "ok" and rec["shard_experts"] is True
    got = spawn[0]["count"]
    assert got == rec["collective_bytes_by_axis"]
    # every rank's by formula: its experts' blocks from every rank, then
    # every expert's block back (bf16, n_s rows an expert, each MoE layer)
    cfg = get_config(COUNT_ARCH)
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    from repro_torch.core.expert import expert_capacity
    C = expert_capacity(COUNT_B, k, E, cfg.moe.capacity_factor)
    n_s = min(C, -(-COUNT_B // COUNT_TP))
    for rank, r in enumerate(spawn[:COUNT_TP]):
        lo, hi = sharding.expert_range(E, rank, COUNT_TP)
        assert r["count"]["model"]["all-to-all"] == _moe_layers(cfg) * (
            COUNT_TP * (hi - lo) + E) * n_s * cfg.d_model * 2
        assert {a: b for a, b in r["count"]["model"].items()
                if a != "all-to-all"} == {a: b for a, b in got["model"].items()
                                          if a != "all-to-all"}
