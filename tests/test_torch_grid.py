"""Training on a rank grid in the port: gloo ranks on the CPU against the
JAX package's single-device step.

``repro_torch.launch.mesh.run_ranks`` spawns each grid once for the
module, (2, 1), (1, 2) and (2, 2) (data, model), and the (2, 1) spawn also
makes the (2, 1, 1) (pod, data, model) grid over its world
(``grid_on_world``: pod folds into data parallelism, and ZeRO-1 splits
over data only, which has one rank there), and every rank trains
each case of its grid for two steps from the same numpy params and batches
as the JAX package's ``make_train_step`` on one device and the whole batch
(f32, norms and biases perturbed so no zero-init term hides).  Against it,
at ``test_torch_train.py``'s tolerances (rtol 1e-4, atol 1e-5, params under
its count rule): loss, loss_total, the MoE aux loss, grad_norm, and the
params gathered back to the JAX layout (``sharding.gather_params``), every
data-parallel rank's equal.  The cases:

* llama3.1-8b-tiny at (2, 1), (1, 2) and (2, 2), ZeRO-1 off and on (on:
  params bitwise equal to off);
* phimini-moe-tiny at (1, 2) under expert parallelism (E4 -> E2 a rank),
  with three experts (tensor parallelism inside each), and at (2, 1) with a
  capacity factor of 0.5, so entries drop and the global slot offsets
  decide which;
* one KV head shared by both ranks at (1, 2), with ``qk_norm`` and QKV
  biases (their gradients summed over the ranks);
* phimini-moe-tiny at (2, 1) at its own capacity factor, where the whole
  batch's capacity is past a rank's tokens (each expert's rows a rank:
  the rank's tokens);
* two microbatches at dp = 2 with loss weights uneven across the ranks;
  ``grad_compress`` at dp = 2;
* llama3.1-8b-tiny at (2, 1, 1), ZeRO-1 off and on.

Without a spawn: each rank's state leaf shapes at the JAX study's 16×16 and
2×16×16 meshes for every supported assigned arch against JAX's
``fit_to_mesh(state_pspecs(..., zero1))`` on a stand-in mesh, the two
deviations listed by leaf (a shared KV head's projections keep whole heads
where GSPMD splits ``d_head``; query heads that do not divide 16 split as
whole heads in GSPMD's padded layout, where GSPMD splits ``H * d_head``
evenly, and xlstm-125m's four heads split as whole heads); the
unsupported cells' status and reasons (widths that do not split); a (2,
2) counting grid's collective bytes by formula for a tiny train step,
and a (1, 3) one's with the all-reduces of the shared KV heads'
gradients over their readers.  ``tests/test_torch_heads.py`` trains on
(1, 3), (1, 4) and (2, 3) grids with query heads that do not divide tp,
``tests/test_torch_recurrent_tp.py`` the recurrent families on (1, 2),
(1, 3), (1, 4) and (2, 2) grids.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import ShapeCfg, get_config  # noqa: E402
from repro_torch.launch import dryrun, sharding, specs  # noqa: E402
from repro_torch.launch.mesh import (counting_grid, grid_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import Model  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
LR, STEPS, B, S = 1e-2, 2, 4, 16
# name -> (arch, config overrides, step config, ZeRO-1, uneven weights)
CASES = {
    "llama": ("llama3.1-8b-tiny", {}, {}, False, False),
    "llama-zero1": ("llama3.1-8b-tiny", {}, {}, True, False),
    "llama-mb2": ("llama3.1-8b-tiny", {}, {"microbatches": 2}, False, True),
    "llama-compress": ("llama3.1-8b-tiny", {}, {"grad_compress": True},
                       False, False),
    "llama-kv1": ("llama3.1-8b-tiny", {"n_kv_heads": 1, "qk_norm": True,
                                       "qkv_bias": True}, {}, False, False),
    "moe-ep": ("phimini-moe-tiny", {}, {}, False, False),
    "moe-e3": ("phimini-moe-tiny", {"n_experts": 3}, {}, False, False),
    "moe-drop": ("phimini-moe-tiny", {"capacity_factor": 0.5}, {}, False,
                 False),
}
GRIDS = {
    (2, 1): ("llama", "llama-zero1", "llama-mb2", "llama-compress",
             "moe-drop", "moe-ep"),
    (1, 2): ("llama", "llama-zero1", "moe-ep", "moe-e3", "llama-kv1"),
    (2, 2): ("llama", "llama-zero1"),
}
#: (pod, data, model), trained in the (2, 1) spawn
POD_GRID, POD_CASES = (2, 1, 1), ("llama", "llama-zero1")


def _cfg(get, name):
    arch, over, _, _, _ = CASES[name]
    cfg = dataclasses.replace(get(arch), compute_dtype="float32")
    moe = {k: over[k] for k in ("n_experts", "capacity_factor") if k in over}
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return dataclasses.replace(cfg, **{k: v for k, v in over.items()
                                       if k not in moe})


def _noisy(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _noisy(v, rng, path + (k,)) for k, v in tree.items()}
    if any("norm" in k for k in path) or path[-1] in ("bq", "bk", "bv"):
        return (tree + 0.1 * rng.standard_normal(tree.shape)
                ).astype(tree.dtype)
    return tree


def _batches(cfg, uneven, seed=10):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        b = {"inputs": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        if uneven:
            # rows 0 and 2 (data rank 0 of each microbatch) weigh little
            w = np.ones((B, S), np.float32)
            w[0, 3:] = 0.0
            w[2, 1:] = 0.0
            w[1] *= 2.0
            b["weights"] = w
        out.append(b)
    return out


def _grid_rank(grid, job):
    """One rank: every case of its grid, two steps each; then, if the job
    names them, the pod grid's cases over the same world."""
    from repro_torch.launch.mesh import MeshShape, grid_on_world
    out = {"coords": grid.coords, "cases": _train_cases(grid, job,
                                                         job["cases"])}
    if job.get("pod"):
        pod = grid_on_world(MeshShape(("pod", "data", "model"), POD_GRID),
                            grid.rank, grid.device, grid.backend)
        assert pod.dp.axis == "pod+data" and pod.dp_size == 2
        out["pod"] = {"coords": pod.coords,
                      "cases": _train_cases(pod, job, job["pod"])}
    return out


def _train_cases(grid, job, names):
    from repro_torch.configs import get_config as get
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.launch.sharding import shard_batch
    from repro_torch.train import AdamW, TrainStepConfig, make_train_step
    from repro_torch.train.train_step import rank_state
    out = {}
    for name in names:
        cfg = _cfg(get, name)
        _, _, step_kw, zero1, _ = CASES[name]
        model = Model(cfg, **grid.model_kw())
        opt = AdamW(lr=LR)
        full = params_from_numpy(job["params"][name])
        state = rank_state(model, opt, full, grid, zero1)
        # JAX's config form: the grid's data-parallel axes named
        step = make_train_step(model, opt, TrainStepConfig(
            dp_axes=dp_axes(grid.mesh), **step_kw), grid=grid, zero1=zero1)
        mets = []
        for batch in job["batches"][name]:
            mine = shard_batch({k: torch.from_numpy(v)
                                for k, v in batch.items()},
                               grid.dp_rank, grid.dp_size,
                               step_kw.get("microbatches", 1))
            state, met = step(state, mine)
            mets.append({k: float(v) for k, v in met.items()})
        out[name] = {"metrics": mets,
                     "params": {"/".join(p.path): t.detach().numpy()
                                for p, t in zip(sharding.leaf_plan(
                                    state.params, cfg, grid.tp, 0),
                                    leaves(state.params))},
                     "mu_shapes": [tuple(t.shape)
                                   for t in leaves(state.opt.mu)]}
    return out


def _jax_run(name):
    """The JAX package's single-device step on the whole batch: (numpy
    params, the per-step metrics, the final params)."""
    from repro.configs import get_config as jget
    from repro.models import Model as JaxModel
    from repro.train import AdamW as JaxAdamW
    from repro.train import TrainStepConfig as JaxStepCfg
    from repro.train import make_train_step as jax_make_step
    from repro.train.train_step import TrainState as JaxTrainState
    cfg = _cfg(jget, name)
    _, _, step_kw, _, uneven = CASES[name]
    jm = JaxModel(cfg)
    rng = np.random.default_rng(4)
    np_params = _noisy(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(4))), rng)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    js = JaxTrainState(jp, JaxAdamW(lr=LR).init(jp))
    step = jax.jit(jax_make_step(jm, JaxAdamW(lr=LR), JaxStepCfg(**step_kw)))
    batches = _batches(cfg, uneven)
    mets = []
    for b in batches:
        js, met = step(js, {k: jnp.asarray(v) for k, v in b.items()})
        mets.append({k: float(v) for k, v in met.items()})
    return np_params, batches, mets, js.params


@pytest.fixture(scope="module")
def jax_runs():
    return {name: _jax_run(name) for name in CASES}


def _spawn(grid, jax_runs):
    from repro_torch.launch.mesh import run_ranks
    names = GRIDS[grid]
    job = {"cases": names,
           "params": {n: jax_runs[n][0] for n in names},
           "batches": {n: jax_runs[n][1] for n in names}}
    if grid == (2, 1):
        job["pod"] = POD_CASES
    dp, tp = grid
    return run_ranks(_grid_rank, tp, job, dp=dp, device="cpu",
                     timeout_s=300)


@pytest.fixture(scope="module")
def grid21(jax_runs):
    return _spawn((2, 1), jax_runs)


@pytest.fixture(scope="module")
def grid12(jax_runs):
    return _spawn((1, 2), jax_runs)


@pytest.fixture(scope="module")
def grid22(jax_runs):
    return _spawn((2, 2), jax_runs)


def _assert_params(got, want, lr, steps):
    """``test_torch_train.py``'s rule: entries Adam makes ill-conditioned
    (at most one, or 1 in 1000, of a leaf) within 2 * lr * steps, every
    other entry within rtol 1e-4, atol 1e-5."""
    for i, (a, b) in enumerate(zip(got, want)):
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-5)
        assert off.sum() <= max(1, a.size // 1000), (i, int(off.sum()),
                                                      a.size)
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr * steps,
                                   err_msg=f"leaf {i}")


def _gathered(ranks, name, dp, tp):
    """Each data-parallel row's params gathered over its model ranks, in
    the JAX layout, as a flat list in ``leaves`` order."""
    from repro_torch.configs import get_config as get
    cfg = _cfg(get, name)
    rows = []
    for d in range(dp):
        parts = []
        for t in range(tp):
            flat = ranks[d * tp + t]["cases"][name]["params"]
            tree = {}
            for path, arr in flat.items():
                node = tree
                keys = path.split("/")
                for k in keys[:-1]:
                    node = node.setdefault(k, {})
                node[keys[-1]] = torch.from_numpy(arr)
            parts.append(tree)
        rows.append([t.numpy() for t in leaves(
            sharding.gather_params(parts, cfg, tp))])
    return rows


def _check(ranks, grid, name, jax_runs):
    dp, tp = grid
    _, _, jmets, jparams = jax_runs[name]
    for r in ranks:
        for got, want in zip(r["cases"][name]["metrics"], jmets):
            for k in ("loss", "loss_total", "aux_loss", "grad_norm", "lr",
                      "tokens"):
                np.testing.assert_allclose(got[k], want[k], **TOL,
                                           err_msg=f"{name} {grid} {k}")
    rows = _gathered(ranks, name, dp, tp)
    for row in rows[1:]:
        for a, b in zip(row, rows[0]):
            np.testing.assert_array_equal(a, b)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jparams)]
    _assert_params(rows[0], want, LR, STEPS)
    return rows[0]


@pytest.mark.parametrize("name", GRIDS[(2, 1)])
def test_dp2_matches_jax(grid21, jax_runs, name):
    _check(grid21, (2, 1), name, jax_runs)


@pytest.mark.parametrize("name", GRIDS[(1, 2)])
def test_tp2_matches_jax(grid12, jax_runs, name):
    _check(grid12, (1, 2), name, jax_runs)


@pytest.mark.parametrize("name", GRIDS[(2, 2)])
def test_dp2_tp2_matches_jax(grid22, jax_runs, name):
    _check(grid22, (2, 2), name, jax_runs)


@pytest.mark.parametrize("grid", [(2, 1), (1, 2), (2, 2)])
def test_zero1_params_bitwise_and_moments_split(grid, request, jax_runs):
    ranks = request.getfixturevalue(
        {(2, 1): "grid21", (1, 2): "grid12", (2, 2): "grid22"}[grid])
    dp, tp = grid
    on = _gathered(ranks, "llama-zero1", dp, tp)
    off = _gathered(ranks, "llama", dp, tp)
    for a, b in zip(on[0], off[0]):
        np.testing.assert_array_equal(a, b)
    shapes_on = ranks[0]["cases"]["llama-zero1"]["mu_shapes"]
    shapes_off = ranks[0]["cases"]["llama"]["mu_shapes"]
    split = [a != b for a, b in zip(shapes_on, shapes_off)]
    assert any(split) == (dp > 1)
    for a, b in zip(shapes_on, shapes_off):
        assert int(np.prod(a)) * (dp if a != b else 1) == int(np.prod(b))


@pytest.mark.parametrize("name", POD_CASES)
def test_pod_grid_matches_jax(grid21, jax_runs, name):
    """(2, 1, 1) (pod, data, model): the gradient's group is pod and data
    folded, and matches JAX's one-device step as (2, 1) does."""
    pods = [r["pod"] for r in grid21]
    assert [r["coords"] for r in pods] == [
        {"pod": p, "data": 0, "model": 0} for p in range(2)]
    _check(pods, (2, 1), name, jax_runs)


def test_pod_grid_zero1_splits_over_data_only(grid21):
    """JAX's ZeRO-1 rule shards the moments over ``data``, never over
    ``pod``: with one data rank a pod, ZeRO-1 splits nothing and leaves the
    params bitwise those without it."""
    pods = [r["pod"] for r in grid21]
    on = _gathered(pods, "llama-zero1", 2, 1)
    off = _gathered(pods, "llama", 2, 1)
    for a, b in zip(on[0], off[0]):
        np.testing.assert_array_equal(a, b)
    assert pods[0]["cases"]["llama-zero1"]["mu_shapes"] == \
        pods[0]["cases"]["llama"]["mu_shapes"]


def test_moe_expert_rows_a_rank_under_dp():
    """Under data parallelism each expert holds min(C, T) rows a rank, C
    the whole batch's capacity and T the rank's tokens: at (4, 1) on meta
    phimini-moe-tiny's capacity is past a rank's 16 tokens, and every
    grouped-matmul launch is charged for E * 16 rows (the (2, 1) ``moe-ep``
    case checks the values against JAX)."""
    from repro_torch.core.expert import expert_capacity
    cfg = get_config("phimini-moe-tiny")
    m = cfg.moe
    grid = counting_grid(grid_mesh(4, 1))
    model = Model(cfg, **grid.model_kw())
    inputs = specs.input_specs(cfg, ShapeCfg("t", S, B, "train"), model,
                               grid=grid)
    c, _, _ = dryrun.count_step(model, "train", inputs, grid=grid)
    T = (B // 4) * S
    C = expert_capacity(B * S, m.top_k, m.n_experts, m.capacity_factor)
    assert C > T
    k = c.kernels["moe_gmm"]
    assert k.launches > 0
    assert k.flops == k.launches * 2 * m.n_experts * T * cfg.d_model \
        * m.d_expert
    assert C > (B // 2) * S          # so it binds at (2, 1) too


def test_moe_drops_entries_at_dp2(jax_runs, monkeypatch):
    """The low capacity factor really drops entries: in the port's forward
    on the whole first batch, some layer routes more entries to an expert
    than the whole batch's capacity (so the slot offsets of the lower
    data-parallel rank decide the drops)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.expert import expert_capacity
    from repro_torch.models import moe
    cfg = _cfg(get_config, "moe-drop")
    seen = []
    plain = moe.router_topk

    def record(*a, **k):
        out = plain(*a, **k)
        seen.append(np.bincount(out[0].reshape(-1).numpy(),
                                minlength=cfg.moe.n_experts))
        return out
    monkeypatch.setattr(moe, "router_topk", record)
    batch = jax_runs["moe-drop"][1][0]
    with torch.no_grad():
        Model(cfg, remat=False).forward(
            params_from_numpy(jax_runs["moe-drop"][0]),
            torch.from_numpy(batch["inputs"]))
    C = expert_capacity(B * S, cfg.moe.top_k, cfg.moe.n_experts,
                        cfg.moe.capacity_factor)
    assert len(seen) == sum(st.n_layers for st in cfg.stages
                            if st.kind == "attn_moe")
    assert max(int(c.max()) for c in seen) > C


# ------------------------------------------------- the JAX study's meshes
class FakeMesh:
    """Duck-typed JAX mesh: axis names and extents, no devices (as
    ``tests/test_sharding.py``'s)."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(shape, dtype=object)
        self.shape = dict(zip(axes, shape))


#: the per-rank leaves where the port deviates from GSPMD, by arch: a KV
#: head that several ranks read keeps its whole ``d_head`` on each (JAX
#: splits ``KV * d_head`` columns over 16), and where the query heads do
#: not divide 16 rank 0 holds ceil(H / 16) whole heads of ``wq``/``bq``/
#: ``wo`` (JAX splits ``H * d_head`` evenly, across head boundaries)
DEVIATIONS = {"qwen3-8b": ("wk", "wv"), "chameleon-34b": ("wk", "wv"),
              "granite-moe-1b-a400m": ("wk", "wv"),
              "starcoder2-7b": ("wq", "wk", "wv", "wo"),
              "qwen1.5-32b": ("wq", "wk", "wv", "wo", "bq", "bk", "bv"),
              "granite-moe-3b-a800m": ("wq", "wk", "wv", "wo"),
              # four xLSTM heads over 16: rank 0 holds one head whole of
              # the mLSTM's w_up (its x_in and z halves), w_q, w_k, w_v,
              # w_down and of the sLSTM's w_gates (each gate); the sLSTM
              # FFN's w_up / w_down split evenly, as JAX's
              "xlstm-125m": ("w_up", "w_q", "w_k", "w_v", "w_down",
                             "w_gates")}
SUPPORTED = ("gemma3-27b", "qwen3-8b", "chameleon-34b",
             "granite-moe-1b-a400m", "musicgen-large", "starcoder2-7b",
             "qwen1.5-32b", "granite-moe-3b-a800m", "zamba2-1.2b",
             "xlstm-125m")
#: arch -> (tp, what ``unsupported`` names)
UNSUPPORTED = {"xlstm-125m": (3, "feed-forward width 1024"),
               "zamba2-1.2b-tiny": (3, "d_ff 128")}


def _jax_rank_shapes(arch, multi_pod, zero1):
    from repro.configs import get_config as jget
    from repro.launch import sharding as jshd
    from repro.launch.specs import state_specs as jstate_specs
    from repro.models import Model as JaxModel
    from repro.train import AdamW as JaxAdamW
    mesh = FakeMesh(*((((2, 16, 16), ("pod", "data", "model"))) if multi_pod
                      else ((16, 16), ("data", "model"))))
    st = jstate_specs(JaxModel(jget(arch)), JaxAdamW())
    sp = jshd.fit_to_mesh(jshd.state_pspecs(st, zero1=zero1), st, mesh)

    def per_rank(spec, leaf):
        dims = tuple(spec) + (None,) * (leaf.ndim - len(tuple(spec)))
        out = []
        for n, e in zip(leaf.shape, dims):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            out.append(n // int(np.prod([mesh.shape[a] for a in axes])))
        return tuple(out)
    from jax.sharding import PartitionSpec as P
    shapes = jax.tree_util.tree_map(per_rank, sp, st,
                                    is_leaf=lambda x: isinstance(x, P))
    return jax.tree_util.tree_leaves_with_path(
        shapes, is_leaf=lambda x: isinstance(x, tuple) and not hasattr(
            x, "_fields") and all(isinstance(i, int) for i in x))


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", SUPPORTED)
def test_rank_state_shapes_match_jax_meshes(arch, multi_pod, zero1):
    from repro_torch.train import AdamW
    cfg = get_config(arch)
    grid = counting_grid(make_production_mesh(multi_pod=multi_pod))
    model = Model(cfg, **grid.model_kw())
    st = specs.state_specs(model, AdamW(), grid, zero1)
    got = [tuple(t.shape) for t in leaves(st)]
    want = _jax_rank_shapes(arch, multi_pod, zero1)
    assert len(got) == len(want)
    dev = DEVIATIONS.get(arch, ())
    # rank 0's width along the model dim: its query heads, or the KV heads
    # they read, whole
    qlo, qhi = sharding.query_heads(cfg, 0, 16)
    klo, khi = sharding.kv_heads(cfg, 0, 16)
    width = {n: (khi - klo if n in ("wk", "wv", "bk", "bv") else qhi - qlo)
             * cfg.d_head for n in dev}
    if arch == "xlstm-125m":      # one head of 2d (mLSTM), d / 4 (sLSTM)
        hd = 2 * cfg.d_model // cfg.n_heads
        width = {"w_up": 2 * hd, "w_q": hd, "w_k": hd, "w_v": hd,
                 "w_down": hd, "w_gates": 4 * cfg.d_model // cfg.n_heads}
    seen = set()
    for g, (path, w) in zip(got, want):
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        if g == w:
            continue
        where = jax.tree_util.keystr(path)
        assert name in dev, f"{arch}: {where} {g} != {w}"
        diff = [i for i, (a, b) in enumerate(zip(g, w)) if a != b]
        assert len(g) == len(w) and len(diff) == 1, where
        # the one dim that differs is the model dim; under ZeRO-1 a moment
        # is further split on another dim, the same on both sides
        assert g[diff[0]] == width[name], (where, g, w)
        seen.add(name)
    assert seen == set(dev)


def test_unsupported_cells_status_and_reasons():
    """What still refuses on a grid: a width that does not split over tp
    (the sLSTM's 1024 over 3, a tiny ``d_ff`` of 128 over 3); the same
    archs count at tp 16 and on one rank."""
    for arch, (tp, why) in UNSUPPORTED.items():
        for dp in (1, 2):
            rec = dryrun.lower_cell(arch, "train_4k", dp=dp, tp=tp)
            assert rec["status"] == "unsupported", (arch, rec)
            assert why in rec["reason"], rec["reason"]
            assert "stages" not in rec["reason"]
    rec = dryrun.lower_cell("xlstm-125m", "decode_32k", dp=16, tp=16)
    assert rec["status"] == "ok" and "xLSTM heads" in rec["note"]
    assert dryrun.lower_cell("xlstm-125m", "decode_32k", dp=16)["status"] \
        == "ok"


def test_counting_grid_collective_bytes_by_formula():
    """A tiny llama train step at (2, 2) with ZeRO-1, rank 0 on meta, remat
    on, bf16 activations.  Model axis: per layer two all-reduces of the
    hidden state forward (attention, MLP), one in the recompute (the
    attention's: non-reentrant checkpointing stops recomputing once it has
    the tensors the backward saved, before the MLP's) and two of their
    inputs' gradients backward; the embedding's one and the head input's
    gradient; the head's gather of the vocab; the global norm's one f32.
    Data axis: the loss's weighted sum and weight sum (f32 scalars), every
    gradient leaf (f32), and under ZeRO-1 the gather of every leaf that has
    a split dim."""
    cfg = get_config("llama3.1-8b-tiny")
    grid = counting_grid(grid_mesh(2, 2))
    model = Model(cfg, **grid.model_kw())
    shape = ShapeCfg("t", S, B, "train")
    inputs = specs.input_specs(cfg, shape, model, grid=grid, zero1=True)
    params = inputs["state"].params
    c, _, _ = dryrun.count_step(model, "train", inputs, grid=grid,
                                zero1=True)
    rows, d, act = (B // 2) * S, cfg.d_model, 2
    L = sum(st.n_layers for st in cfg.stages)
    hidden = rows * d * act
    assert c.coll_by_axis["model"] == {
        "all-reduce": 5 * L * hidden + 2 * hidden + 4,
        "all-gather": rows * cfg.padded_vocab * act}
    plans = sharding.leaf_plan(params, cfg, 2, 0, 2, zero1=True)
    grads = sum(t.numel() * 4 for t in leaves(params))
    gathered = sum(t.numel() * 4 for t, p in zip(leaves(params), plans)
                   if p.zero1_dim is not None)
    assert gathered > 0
    assert c.coll_by_axis["data"] == {"all-reduce": 4 + 4 + grads,
                                      "all-gather": gathered}


def test_counting_grid_reader_groups_by_formula():
    """A tiny train step on a (1, 3) grid, rank 1 on meta, at
    starcoder2-7b's 36 query heads and 4 KV heads: rank 1's twelve query
    heads read KV 1 (with rank 0) and KV 2 (with rank 2).  Model axis:
    five all-reduces of the hidden state a layer (as at (2, 2); the padded
    vocab of 256 does not split over 3, so the embedding and the head stay
    whole and add none), the global norm's one f32, and each shared
    head's columns of the ``wk`` and ``wv`` gradients (f32) over its two
    readers."""
    cfg = dataclasses.replace(get_config("starcoder2-7b-tiny"), n_heads=36,
                              n_kv_heads=4, d_ff=192)
    grid = counting_grid(grid_mesh(1, 3), rank=1)
    model = Model(cfg, **grid.model_kw())
    inputs = specs.input_specs(cfg, ShapeCfg("t", S, B, "train"), model,
                               grid=grid)
    plans = sharding.leaf_plan(inputs["state"].params, cfg, 3, 1)
    dh = cfg.d_head
    kv = {p.path[-1]: p.kv_shared for p in plans if p.grad_sum == "kv"}
    assert kv == {n: ((1, 0, dh), (2, dh, 2 * dh)) for n in ("wk", "wv")}
    # rank 1 owns KV 2 only: KV 1 counts in the norm on rank 0
    assert {p.path[-1]: p.norm_cols for p in plans
            if p.path[-1] in ("wk", "wv")} == {"wk": ((dh, 2 * dh),),
                                                "wv": ((dh, 2 * dh),)}
    c, _, _ = dryrun.count_step(model, "train", inputs, grid=grid)
    L = sum(st.n_layers for st in cfg.stages)
    d, act = cfg.d_model, 2
    hidden = B * S * d * act
    shared = 2 * 2 * L * d * dh * 4
    assert c.coll_by_axis == {"model": {
        "all-reduce": 5 * L * hidden + 4 + shared}}
