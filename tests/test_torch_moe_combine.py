"""The MoE combine in JAX's order (``repro_torch.models.moe.combine``).

JAX combines with ``jnp.zeros((T, d)).at[tok_of].add(contrib)``
(``repro/models/moe.py``), which XLA:CPU runs update by update in index
order: each token's entries added one after another in ascending sorted
position, rounding in the compute dtype after each add.  The port adds them
in that order (``entries_by_token`` and ``combine``), with no float atomics,
so its combine equals JAX's bitwise in f32 and bf16 and repeats on the card.
"Bitwise" reads -0 and +0 as one value: JAX's sum starts from +0, the
port's from the first product.

CPU: inputs drawn once with numpy go through both packages.
* The helper against JAX's scatter-add over the same sorted entries, at
  top-k 1, 2, 4 and 8, f32 and bf16, with capacity drops and invalid rows;
  ``index_add_``, the port's combine before, misses it in bf16 at top-8.
* ``moe_ffn`` in bf16 at granite-moe-3b's published 40 experts and top-8:
  its output equals JAX's ``moe_ffn`` run on the port's own routing and
  expert rows (a routing hook and a stand-in for the grouped matmul on the
  JAX side), gated and GELU, with drops and a validity mask.
* ``moe_ffn`` at 40 experts top-8 against JAX's in f32 within
  ``tests/test_torch_moe.py``'s tolerances, and its gradients against
  ``jax.grad`` within ``tests/test_torch_moe_bwd.py``'s.
* No float ``index_add_``, ``scatter_add_`` or accumulating ``index_put_``
  on ``moe_ffn``'s forward path, other than counts of whole numbers.
* Under ``shard_experts`` on three gloo ranks (``run_ranks``, as
  ``tests/test_torch_shard_experts.py`` spawns them), bf16 at 40 experts
  top-8: every rank's output equals tp = 1's bitwise.

Card (``-m cuda``, skips without compute capability 9.0): two bf16 top-8
``moe_ffn`` forward and backward calls give bitwise the same output and
gradients.  JAX is imported lazily (the module fixture ``jx``), so the card
test runs on a machine without it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.models import moe  # noqa: E402

#: ``tests/test_torch_moe.py``'s and ``tests/test_torch_moe_bwd.py``'s
F32 = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-5, atol=1e-5)
#: granite-moe-3b-a800m's published expert count and top-k
E40, K8 = 40, 8
SE_TP = 3


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    return jax, jnp, jmoe


def _tdt(dtype):
    return getattr(torch, dtype)


def _same(a, b):
    """Bitwise equal as numbers: f32 views, -0 read as +0, no NaN."""
    a = np.asarray(a, np.float32) + np.float32(0)
    b = np.asarray(b, np.float32) + np.float32(0)
    assert not np.isnan(a).any() and not np.isnan(b).any()
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


# ------------------------------------------------------------ the helper
def _entries(seed, T, E, k, cf, d):
    """A random top-k routing of T tokens (distinct experts a token, a
    third of the rows invalid) sorted as ``moe_ffn`` sorts it: the token
    of each sorted entry, the entries' rows and weights (0 where dropped,
    as both packages weight a dropped entry)."""
    rng = np.random.default_rng(seed)
    flat = np.stack([rng.permutation(E)[:k] for _ in range(T)]).reshape(-1)
    valid = np.repeat(rng.random(T) > 1 / 3, k)
    sort_e = np.where(valid, flat, E)
    order = np.argsort(sort_e, kind="stable")
    s_sorted = sort_e[order]
    counts = np.bincount(sort_e, minlength=E + 1)
    pos_in_e = np.arange(T * k) - (np.cumsum(counts) - counts)[s_sorted]
    C = max(1, int(round(T * k * cf / E)))
    keep = (pos_in_e < C) & (s_sorted < E)
    rows = rng.standard_normal((T * k, d)).astype(np.float32)
    w = (rng.random(T * k) * keep).astype(np.float32)
    return order // k, rows, w, keep


def _jax_combine(jnp, tok_of, rows, w, T, dtype):
    """``repro/models/moe.py``'s combine lines on given sorted entries."""
    gathered = jnp.asarray(rows).astype(dtype)
    contrib = gathered * jnp.asarray(w).astype(dtype)[:, None]
    y = jnp.zeros((T, rows.shape[1]), dtype).at[jnp.asarray(tok_of)].add(
        contrib)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_combine_equals_jax_scatter_add(jx, k, dtype):
    _, jnp, _ = jx
    T, E, d = 48, E40, 64
    tok_of, rows, w, keep = _entries(k, T, E, k, 0.6, d)
    assert not keep.all() and keep.any()          # drops and invalid rows
    want = _jax_combine(jnp, tok_of, rows, w, T, dtype)
    t = torch.from_numpy(tok_of)
    pos = moe.entries_by_token(t, k)
    assert bool((pos.view(T, k).diff(dim=1) > 0).all())
    assert torch.equal(t[pos], torch.arange(T).repeat_interleave(k))
    got = moe.combine(torch.from_numpy(rows).to(_tdt(dtype))[pos],
                      torch.from_numpy(w).to(_tdt(dtype))[pos], k)
    assert got.dtype == _tdt(dtype) and got.is_contiguous()
    assert _same(got.float().numpy(), want)
    # a slice of the tokens, as a rank combines its own under shard_experts
    lo, n = 5, 17
    part = moe.entries_by_token(t, k, lo, n)
    got = moe.combine(torch.from_numpy(rows).to(_tdt(dtype))[part],
                      torch.from_numpy(w).to(_tdt(dtype))[part], k)
    assert _same(got.float().numpy(), want[lo:lo + n])


def test_index_add_misses_jax_in_bf16_at_top8(jx):
    """The combine before: atomics-free on the CPU, but its sum is not
    JAX's in bf16 at top-8."""
    _, jnp, _ = jx
    T, d = 48, 64
    tok_of, rows, w, _ = _entries(8, T, E40, K8, 0.6, d)
    want = _jax_combine(jnp, tok_of, rows, w, T, "bfloat16")
    contrib = torch.from_numpy(rows).bfloat16() \
        * torch.from_numpy(w).bfloat16()[:, None]
    old = torch.zeros((T, d), dtype=torch.bfloat16).index_add_(
        0, torch.from_numpy(tok_of), contrib)
    assert not _same(old.float().numpy(), want)


# ------------------------------------------------------------- the layer
def _layer(seed, T, d, de, E, gated):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, E)),
         "w_gate": rng.standard_normal((E, d, de)) * 0.3,
         "w_up": rng.standard_normal((E, d, de)) * 0.3,
         "w_down": rng.standard_normal((E, de, d)) * 0.3}
    if not gated:
        del p["w_gate"]
    x = rng.standard_normal((T, d))
    return x.astype(np.float32), {n: v.astype(np.float32)
                                  for n, v in p.items()}


#: (gated, capacity factor, valid mask): granite's factor, one that drops
LAYER_CASES = [(True, 1.25, False), (False, 1.25, False),
               (True, 0.5, True), (False, 0.5, True)]


@pytest.mark.parametrize("gated,cf,masked", LAYER_CASES)
def test_moe_ffn_bf16_top8_is_jax_combine_of_its_rows(jx, monkeypatch,
                                                     gated, cf, masked):
    """JAX's ``moe_ffn`` (Pallas backend) given the port's routing through
    a hook and the port's expert rows in place of its last grouped matmul
    adds them into bitwise the port's output."""
    _, jnp, jmoe = jx
    import repro.kernels
    from repro.core.expert import expert_capacity
    T, d, de = 24, 32, 16
    x, p = _layer(31, T, d, de, E40, gated)
    valid = np.random.default_rng(32).random(T) > 0.25 if masked else None
    tx = torch.from_numpy(x).bfloat16()
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    tv = None if valid is None else torch.from_numpy(valid)
    seen = []
    ffn = moe._expert_ffn

    def spy(*a, **kw):
        out = ffn(*a, **kw)
        seen.append(out.detach().clone())
        return out
    monkeypatch.setattr(moe, "_expert_ffn", spy)
    y, _ = moe.moe_ffn(tx, tp, top_k=K8, capacity_factor=cf, gated=gated,
                       valid=tv)
    idx, cw, _ = moe.router_topk(tx, tp["router"], K8)
    out_e = seen[0].float().numpy()                      # (E, n, d)
    C = expert_capacity(T, K8, E40, cf)
    rows = np.zeros((E40, C, d), np.float32)
    rows[:, :out_e.shape[1]] = out_e[:, :C]

    def fake_gmm(h, w, gs, **_):
        if w.shape[1:] == (de, d):                       # the down product
            return jnp.asarray(rows).astype(h.dtype)
        return jnp.zeros(h.shape[:2] + (w.shape[2],), h.dtype)
    monkeypatch.setattr(repro.kernels, "moe_gmm", fake_gmm)

    def hook(logits, **_):
        return (jnp.asarray(idx.numpy()), jnp.asarray(cw.numpy()),
                jnp.zeros((), jnp.float32))
    yj, _ = jmoe.moe_ffn(
        jnp.asarray(x).astype(jnp.bfloat16),
        {n: jnp.asarray(v) for n, v in p.items()}, top_k=K8,
        capacity_factor=cf, gated=gated, router_fn=hook,
        positions=jnp.arange(T), valid=None if valid is None
        else jnp.asarray(valid), backend="pallas")
    assert y.dtype == torch.bfloat16
    if cf < 1:                                           # entries dropped
        assert int(torch.bincount(idx.reshape(-1).long()).max()) > C
    assert _same(y.float().numpy(), np.asarray(yj.astype(jnp.float32)))


@pytest.mark.parametrize("gated,cf,masked", LAYER_CASES)
def test_moe_ffn_top8_matches_jax(jx, gated, cf, masked):
    """f32 at 40 experts top-8: output and aux within 2e-5, and the
    gradients of sum(y * r) + aux to x, the router and every expert weight
    within 1e-5 of ``jax.grad`` (reference backend)."""
    jax, jnp, jmoe = jx
    T, d, de = 24, 32, 16
    x, p = _layer(41, T, d, de, E40, gated)
    rng = np.random.default_rng(42)
    r = rng.standard_normal((T, d)).astype(np.float32)
    valid = rng.random(T) > 0.25 if masked else None
    kw = dict(top_k=K8, capacity_factor=cf, gated=gated)
    jkw = dict(kw, valid=None if valid is None else jnp.asarray(valid))

    def jloss(xa, pa):
        y, aux = jmoe.moe_ffn(xa, pa, backend="reference", **jkw)
        return jnp.sum(y * jnp.asarray(r)) + aux, (y, aux)

    (_, (yj, aj)), (gx_j, gp_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()})
    xt = torch.from_numpy(x).requires_grad_()
    pt = {n: torch.from_numpy(v).requires_grad_() for n, v in p.items()}
    y, aux = moe.moe_ffn(xt, pt, valid=None if valid is None
                         else torch.from_numpy(valid), **kw)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj), **F32)
    np.testing.assert_allclose(float(aux.detach()), float(aj), **F32)
    loss = torch.sum(y * torch.from_numpy(r)) + aux
    names = sorted(pt)
    grads = torch.autograd.grad(loss, [xt] + [pt[n] for n in names])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_j), **GRAD)
    for n, g in zip(names, grads[1:]):
        assert g.abs().max() > 0, n
        np.testing.assert_allclose(g.numpy(), np.asarray(gp_j[n]),
                                   err_msg=n, **GRAD)


def test_forward_accumulates_no_floats_but_whole_counts():
    """Every float ``index_add_``, ``scatter_add_`` or accumulating
    ``index_put_`` that a bf16 top-8 ``moe_ffn`` call (with a mask and
    drops) dispatches adds whole numbers, exact in any order: the router's
    expert counts; the combine dispatches none."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__.rstrip("_")
            if name in ("index_add", "scatter_add", "index_put"):
                self_t = args[0]
                src = args[3] if name != "index_put" else args[2]
                acc = name != "index_put" or (
                    len(args) > 3 and args[3]) or kwargs.get("accumulate")
                if acc and self_t.is_floating_point():
                    seen.append((name, bool((src == src.round()).all())))
            return func(*args, **(kwargs or {}))
    x, p = _layer(51, 24, 32, 16, E40, True)
    valid = torch.from_numpy(np.random.default_rng(52).random(24) > 0.25)
    with Watch():
        moe.moe_ffn(torch.from_numpy(x).bfloat16(),
                    {n: torch.from_numpy(v) for n, v in p.items()},
                    top_k=K8, capacity_factor=0.5, valid=valid)
    assert seen and all(whole for _, whole in seen), seen


# ------------------------------------------------- shard_experts, ranks
def _se_cfg():
    """A config whose expert layout ``shard_params`` reads (the layer's
    leaves under ``moe``) at 40 experts top-8."""
    from repro_torch.configs import get_config
    base = get_config("granite-moe-3b-a800m-tiny")
    return dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, n_experts=E40, top_k=K8, d_expert=16))


#: name -> (tokens, capacity factor, valid mask): tokens dividing tp and
#: not, below tp, drops
SE_CASES = {"t12": (12, 1.25, False), "t10-drop": (10, 0.5, True),
            "t2": (2, 1.25, False)}


def _se_inputs(name):
    T, _, masked = SE_CASES[name]
    x, p = _layer(61 + sorted(SE_CASES).index(name), T, 32, 16, E40, True)
    valid = np.random.default_rng(62).random(T) > 0.25 if masked else None
    return {"x": x, "params": p, "valid": valid}


def _se_layer(name, inp, group=None):
    """One bf16 ``moe_ffn`` call (under ``shard_experts`` with a group):
    its output as f32 numpy."""
    from repro_torch.launch import sharding
    _, cf, _ = SE_CASES[name]
    params = inp["params"]
    if group is not None:
        params = sharding.shard_params({"moe": params}, group.rank,
                                       group.size, cfg=_se_cfg(),
                                       shard_experts=True)["moe"]
    params = {n: torch.from_numpy(np.array(v)) for n, v in params.items()}
    valid = None if inp["valid"] is None else torch.from_numpy(inp["valid"])
    y, _ = moe.moe_ffn(torch.from_numpy(inp["x"]).bfloat16(), params,
                       top_k=K8, capacity_factor=cf, valid=valid,
                       group=group, shard_experts=group is not None)
    return y.float().numpy()


def _se_rank(group, job):
    return {name: _se_layer(name, inp, group) for name, inp in job.items()}


@pytest.fixture(scope="module")
def se_ranks():
    from repro_torch.launch.mesh import run_ranks
    job = {name: _se_inputs(name) for name in SE_CASES}
    want = {name: _se_layer(name, inp) for name, inp in job.items()}
    return want, run_ranks(_se_rank, SE_TP, job, device="cpu",
                           timeout_s=300)


@pytest.mark.parametrize("name", SE_CASES)
def test_shard_experts_combine_equals_tp1_bitwise(se_ranks, name):
    """bf16, 40 experts top-8 over 3 ranks (14, 14 and 12 experts): each
    rank combines its own tokens in tp = 1's order, so the gathered output
    equals tp = 1's bitwise on every rank."""
    want, ranks = se_ranks
    for r in ranks:
        assert _same(r[name], want[name]), name


# ----------------------------------------------------------------- card
@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [True, False])
def test_bf16_top8_forward_backward_repeat_on_card(sm90, gated):
    """Two bf16 top-8 calls over 40 experts (capacity drops) on the card,
    through the grouped matmul and its backward kernel: output, aux and
    every gradient bitwise equal."""
    from repro_torch.kernels import ops
    x, p = _layer(71, 512, 256, 128, E40, gated)
    r = torch.from_numpy(np.random.default_rng(72).standard_normal(
        (512, 256)).astype(np.float32)).to(sm90, torch.bfloat16)

    def run():
        xt = torch.from_numpy(x).to(sm90, torch.bfloat16).requires_grad_()
        pt = {n: torch.from_numpy(v).to(sm90).requires_grad_()
              for n, v in p.items()}
        y, aux = moe.moe_ffn(xt, pt, top_k=K8, capacity_factor=1.0,
                             gated=gated)
        ((y * r).float().sum() + aux).backward()
        return [y.detach(), aux.detach(), xt.grad] + [pt[n].grad
                                                      for n in sorted(pt)]
    ops.reset_launch_counts()
    a, b = run(), run()
    torch.cuda.synchronize()
    assert ops.launch_counts()["moe_gmm"] > 0
    assert ops.launch_counts()["moe_gmm_bwd"] > 0
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert all(bool(torch.isfinite(u.float()).all()) for u in a)
