"""The port's training path against the JAX package's.

Inputs and params are drawn once with numpy and handed to both packages
(params through ``repro_torch.convert``; every norm scale and bias gets
numpy noise first, so a term that is zero at init cannot hide).  Models run
``compute_dtype="float32"`` on the CPU, where attention is the flash
function's plain versions and the MoE layers the grouped matmul's plain
version.  Tolerances (f32, the two sum in other orders): logits, loss and
aux rtol 1e-4, atol 1e-5; gradients rtol 1e-4, atol 1e-6 times the leaf's
largest |gradient| (a leaf's small entries are sums that cancel; 1e-5 for
zamba2, whose SSD sums exponentials of cumulative decays in another order);
AdamW rtol 1e-5, atol 1e-7; train steps rtol 1e-4, atol 1e-5 on losses and
params, except the entries Adam makes ill-conditioned (``_assert_params``).
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.train import AdamW as JaxAdamW  # noqa: E402
from repro.train import TrainStepConfig as JaxStepCfg  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import cosine_schedule as jax_cosine  # noqa: E402
from repro.train import make_train_step as jax_make_step  # noqa: E402
from repro.train.train_step import TrainState as JaxTrainState  # noqa: E402
from repro.workload import datasets as jdata  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.layers import rmsnorm, rmsnorm_ct16  # noqa: E402
from repro_torch.train import (AdamW, TrainStepConfig,  # noqa: E402
                               cosine_schedule, global_norm, init_state,
                               make_train_step)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402
from repro_torch.train.train_step import compress  # noqa: E402
from repro_torch.workload import datasets  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = [a + "-tiny" for a in ASSIGNED] + ["llama3.1-8b-tiny",
                                           "phimini-moe-tiny"]


def _noisy(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _noisy(v, rng, path + (k,)) for k, v in tree.items()}
    if any("norm" in k for k in path) or path[-1] in ("bq", "bk", "bv"):
        return (tree + 0.1 * rng.standard_normal(tree.shape)
                ).astype(tree.dtype)
    return tree


def _pair(arch, seed=4, vocab=None, **model_kw):
    """(JAX model, port model, numpy params) on one f32 config."""
    kw = dict(compute_dtype="float32")
    if vocab is not None:
        kw["vocab"] = vocab
    jcfg = dataclasses.replace(jax_get_config(arch), **kw)
    tcfg = dataclasses.replace(get_config(arch), **kw)
    jm = JaxModel(jcfg, **model_kw)
    tm = Model(tcfg, **model_kw)
    rng = np.random.default_rng(seed)
    np_params = _noisy(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed))), rng)
    return jm, tm, np_params


def _batch(cfg, rng, B=2, S=24):
    """inputs/labels as numpy: ids, or (B,S,d) embeddings and (B,S,nc)
    labels for a model on precomputed embeddings with codebook heads."""
    if cfg.embed_inputs:
        inputs = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    else:
        inputs = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    lshape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    labels = rng.integers(0, cfg.vocab, lshape).astype(np.int32)
    return {"inputs": inputs, "labels": labels}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _flat_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


#: gradient atol as a share of the leaf's largest |gradient|
GRAD_ATOL = {"zamba2-1.2b-tiny": 1e-5}


def _assert_grads(got, want, name):
    share = GRAD_ATOL.get(name, 1e-6)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=share * scale,
                                   err_msg=f"{name}: leaf {i}")


def _assert_params(got, want, lr, steps):
    """Params after ``steps`` AdamW steps.  Adam divides by sqrt(nu) +
    1e-8, so an entry whose gradient sits within a few eps of zero moves by
    up to ~lr a step whatever its last bits: such entries (at most one,
    or 1 in 1000, of a leaf) are held to 2 * lr * steps, every other entry
    to rtol 1e-4, atol 1e-5."""
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-5)
        assert off.sum() <= max(1, a.size // 1000), (i, int(off.sum()),
                                                      a.size)
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr * steps,
                                   err_msg=f"leaf {i}")


# ------------------------------------------------------------- rmsnorm_ct16

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_ct16_output_and_gradient_dtype(dtype):
    """Same output as ``rmsnorm``; the input's gradient comes back in the
    input's dtype; in f32, value and gradient equal the JAX function's."""
    rng = np.random.default_rng(0)
    xn = rng.standard_normal((2, 5, 16)).astype(np.float32)
    sn = (0.1 * rng.standard_normal(16)).astype(np.float32)
    gn = rng.standard_normal((2, 5, 16)).astype(np.float32)
    x = torch.from_numpy(xn).to(dtype).requires_grad_()
    scale = torch.from_numpy(sn)
    y = rmsnorm_ct16(x, scale)
    assert y.dtype == dtype
    torch.testing.assert_close(y, rmsnorm(x.detach(), scale), rtol=0,
                               atol=0)
    y.backward(torch.from_numpy(gn).to(dtype))
    assert x.grad.dtype == dtype
    if dtype == torch.float32:
        yj, vjp = jax.vjp(lambda a: jlayers.rmsnorm_ct16(a, sn),
                          jnp.asarray(xn))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj),
                                   **TOL)
        np.testing.assert_allclose(x.grad.numpy(),
                                   np.asarray(vjp(jnp.asarray(gn))[0]),
                                   **TOL)


# ------------------------------------------------ Model.forward / loss_fn

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch):
    """Logits, loss and aux, and every gradient leaf with remat on, for
    every tiny assigned config (musicgen on embeddings with its codebook
    heads) plus llama3.1-8b and phimini-moe."""
    jm, tm, np_params = _pair(arch, remat=True)
    rng = np.random.default_rng(5)
    batch = _batch(jm.cfg, rng)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params)
    for p in leaves(tp):
        p.requires_grad_(True)

    lj, aj = jm.forward(jp, jnp.asarray(batch["inputs"]))
    lt, at = tm.forward(tp, torch.from_numpy(batch["inputs"]))
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(float(at), float(aj), **TOL)

    (tot_j, mj), gj = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, _j(batch))
    tot_t, mt = tm.loss_fn(tp, _t(batch))
    for k in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), **TOL)
    np.testing.assert_allclose(float(tot_t), float(tot_j), **TOL)
    if tm.cfg.moe is not None:
        assert float(mt["aux_loss"]) > 0
    gt = torch.autograd.grad(tot_t, leaves(tp))
    _assert_grads(gt, _flat_np(gj), arch)


@pytest.mark.parametrize("arch", ["llama3.1-8b-tiny", "phimini-moe-tiny",
                                  "gemma3-27b-tiny", "zamba2-1.2b-tiny"])
def test_grads_without_remat_match_jax(arch):
    jm, tm, np_params = _pair(arch, remat=False)
    batch = _batch(jm.cfg, np.random.default_rng(6))
    _, gj = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, np_params), _j(batch))
    tp = params_from_numpy(np_params)
    for p in leaves(tp):
        p.requires_grad_(True)
    tot, _ = tm.loss_fn(tp, _t(batch))
    _assert_grads(torch.autograd.grad(tot, leaves(tp)), _flat_np(gj), arch)


def test_fuse_qkv_and_norm_ct16_match_jax():
    """qwen3-8b-tiny with the fused QKV projection (its params carry
    across unchanged) and the compute-dtype cotangent boundary."""
    jm, tm, np_params = _pair("qwen3-8b-tiny", fuse_qkv=True, norm_ct16=True)
    assert "wqkv" in np_params["stage0"]["attn"]
    cfg = tm.cfg
    init = tm.init(torch.Generator().manual_seed(0))
    assert tuple(init["stage0"]["attn"]["wqkv"].shape) == (
        cfg.stages[0].n_layers, cfg.d_model,
        (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head)
    batch = _batch(jm.cfg, np.random.default_rng(7))
    (tot_j, _), gj = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, np_params), _j(batch))
    tp = params_from_numpy(np_params)
    for p in leaves(tp):
        p.requires_grad_(True)
    tot, _ = tm.loss_fn(tp, _t(batch))
    np.testing.assert_allclose(float(tot), float(tot_j), **TOL)
    _assert_grads(torch.autograd.grad(tot, leaves(tp)), _flat_np(gj),
                  "qwen3 fused")


def test_loss_weights_and_padded_vocab():
    """``weights`` masks tokens; the softmax runs over the padded vocab
    (a vocab of 250 pads to 256)."""
    jm, tm, np_params = _pair("starcoder2-7b-tiny", vocab=250)
    assert tm.cfg.padded_vocab > tm.cfg.vocab
    rng = np.random.default_rng(8)
    batch = _batch(jm.cfg, rng)
    batch["weights"] = (rng.random(batch["labels"].shape) < 0.6).astype(
        np.float32)
    tot_j, mj = jm.loss_fn(jax.tree_util.tree_map(jnp.asarray, np_params),
                           _j(batch))
    tot_t, mt = tm.loss_fn(params_from_numpy(np_params), _t(batch))
    np.testing.assert_allclose(float(tot_t), float(tot_j), **TOL)
    assert float(mt["tokens"]) == float(mj["tokens"]) == \
        batch["weights"].sum()


# ------------------------------------------------------------------ AdamW

def _tree(rng):
    return {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                  "b": rng.standard_normal((3,)).astype(np.float32)},
            "z": rng.standard_normal((2, 2, 5)).astype(np.float32)}


def test_adamw_and_cosine_schedule_match_jax():
    rng = np.random.default_rng(9)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(4)]
    grads[2]["z"] *= 50.0           # one step above the clip norm
    jopt = JaxAdamW(lr=jax_cosine(1e-2, 2, 6))
    topt = AdamW(lr=cosine_schedule(1e-2, 2, 6))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = params_from_numpy(params)
    ts = topt.init(tp)
    for g in grads:
        jp, js, jmet = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   js, jp)
        tp, ts, tmet = topt.update(params_from_numpy(g), ts, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-6)
    assert int(ts.step) == int(js.step) == 4
    for name, t, j in (("params", tp, jp), ("mu", ts.mu, js.mu),
                       ("nu", ts.nu, js.nu)):
        for a, b in zip(leaves(t), _flat_np(j)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-7,
                                       err_msg=name)
    for s in range(8):
        np.testing.assert_allclose(
            float(cosine_schedule(3e-3, 3, 7)(torch.tensor(s))),
            float(jax_cosine(3e-3, 3, 7)(jnp.asarray(s))), rtol=1e-6)
    np.testing.assert_allclose(
        float(global_norm(params_from_numpy(params))),
        float(jnp.sqrt(sum(jnp.sum(jnp.square(x)) for x in
                           jax.tree_util.tree_leaves(params)))), rtol=1e-6)


def test_adamw_minimizes_quadratic():
    """``tests/test_properties.py``'s convex quadratic, on the port."""
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(120):
        g = {"w": 2 * params["w"]}
        params, state, _ = opt.update(g, state, params)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


# ------------------------------------------------------------- train step

def _jax_state(jm, np_params):
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    return JaxTrainState(jp, JaxAdamW(lr=1e-2).init(jp))


def _data(cfg, n, B=4, S=16, seed=10):
    rng = np.random.default_rng(seed)
    return [_batch(cfg, rng, B, S) for _ in range(n)]


@pytest.mark.parametrize("arch", ["llama3.1-8b-tiny", "phimini-moe-tiny"])
@pytest.mark.parametrize("step_cfg", [
    dict(), dict(microbatches=2), dict(grad_compress=True)],
    ids=["plain", "microbatches2", "grad_compress"])
def test_train_step_three_steps_match_jax(step_cfg, arch):
    """Three steps; phimini-moe's expert FFN trains through the grouped
    matmul's autograd Function (its plain forward and backward here)."""
    jm, tm, np_params = _pair(arch)
    jstep = jax.jit(jax_make_step(jm, JaxAdamW(lr=1e-2),
                                  JaxStepCfg(**step_cfg)))
    tstep = make_train_step(tm, AdamW(lr=1e-2), TrainStepConfig(**step_cfg))
    js = _jax_state(jm, np_params)
    ts = train_state_from_numpy(np_params, *[jax.tree_util.tree_map(
        np.zeros_like, np_params)] * 2, 0)
    for batch in _data(jm.cfg, 3):
        js, jmet = jstep(js, _j(batch))
        ts, tmet = tstep(ts, _t(batch))
        for k in ("loss", "loss_total", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       **TOL, err_msg=k)
    _assert_params(leaves(ts.params), _flat_np(js.params), 1e-2, 3)


def _jax_compress(x):
    """``repro/train/train_step.py``'s per-leaf int8 round trip (a closure
    there), restated in jnp."""
    x32 = jnp.asarray(x, jnp.float32)
    scale = jnp.maximum(jnp.max(jnp.abs(x32)), 1e-12) / 127.0
    xi = jnp.clip(jnp.round(x32 / scale), -127, 127).astype(jnp.int8)
    return np.asarray(xi.astype(jnp.float32) * scale)


@pytest.mark.parametrize("ties", [False, True])
def test_grad_compress_is_the_jax_round_trip(ties):
    """Per-leaf int8 absmax quantization equals JAX's.  Both round half to
    even, so exact ties agree (``ties``: |max| = 127/16, every value a
    multiple of 1/32); where last-bit differences upstream put a value on
    different sides of a tie, the two differ by one quantization step of
    the leaf, which bounds the difference in every case."""
    rng = np.random.default_rng(11)
    if ties:
        x = rng.integers(-254, 255, (64, 33)).astype(np.float32) / 32.0
        x[0, 0] = 127.0 / 16.0
    else:
        x = rng.standard_normal((64, 33)).astype(np.float32)
    got = compress(torch.from_numpy(x)).numpy()
    want = _jax_compress(x)
    step = np.abs(x).max() / 127.0
    assert (np.abs(got - want) <= step * (1 + 1e-6)).all()
    np.testing.assert_array_equal(got, want)


def test_dp_axes_refuses():
    """``dp_axes`` needs the rank's grid (``make_train_step(grid=)``) and
    must name the grid's data-parallel axes; on a (2, 1) counting grid the
    step runs (rank 0 on meta: its rows, the gradient summed over data).
    ``tests/test_torch_grid.py`` holds the grids to the JAX package."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import counting_grid, grid_mesh
    tm = Model(get_config("llama3.1-8b-tiny"))
    with pytest.raises(ValueError, match="dp_axes.*grid"):
        make_train_step(tm, AdamW(), TrainStepConfig(dp_axes=("data",)))
    grid = counting_grid(grid_mesh(2, 1))
    gm = Model(get_config("llama3.1-8b-tiny"), **grid.model_kw())
    with pytest.raises(ValueError, match="dp_axes"):
        make_train_step(gm, AdamW(), TrainStepConfig(dp_axes=("pod",)),
                        grid=grid)
    cfg = gm.cfg
    inputs = specs.input_specs(cfg, ShapeCfg("t", 16, 4, "train"), gm,
                               grid=grid)
    assert inputs["batch"]["inputs"].shape == (2, 16)
    c, _, (state, met) = dryrun.count_step(gm, "train", inputs, grid=grid)
    assert set(c.coll_by_axis) == {"data"}
    assert met["loss"].device.type == "meta"


# ----------------------------------------------------------- checkpoints

def _tiny_state(arch="llama3.1-8b-tiny"):
    tm = Model(dataclasses.replace(get_config(arch),
                                   compute_dtype="float32"))
    opt = AdamW(lr=1e-2)
    return tm, opt, init_state(tm, opt, torch.Generator().manual_seed(1))


def test_checkpoint_round_trip_and_retention(tmp_path):
    tm, opt, state = _tiny_state()
    step = make_train_step(tm, opt)
    batches = _data(tm.cfg, 5)
    for i, b in enumerate(batches[:4]):
        state, _ = step(state, _t(b))
        ckpt.save(str(tmp_path), i + 1, state)
    assert ckpt.all_steps(str(tmp_path)) == [2, 3, 4]       # keep = 3
    assert ckpt.latest_step(str(tmp_path)) == 4
    man = json.loads((tmp_path / "step_0000000004" / "manifest.json")
                     .read_text())
    assert man["step"] == 4 and man["n_leaves"] == len(leaves(state))
    fresh = init_state(tm, opt, torch.Generator().manual_seed(2))
    back = ckpt.restore(str(tmp_path), 4, fresh)
    assert int(back.opt.step) == 4
    for a, b in zip(leaves(back), leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach())
    # resume: the restored state trains on exactly as the original
    s1, m1 = step(state, _t(batches[4]))
    s2, m2 = step(back, _t(batches[4]))
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(leaves(s1.params), leaves(s2.params)):
        assert torch.equal(a.detach(), b.detach())
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 4, {"w": torch.zeros(2)})


def test_checkpoints_cross_packages(tmp_path):
    """A JAX-written checkpoint restores into the port's TrainState and
    trains on as JAX does; a port-written one restores in JAX."""
    jm, tm, np_params = _pair("llama3.1-8b-tiny")
    jstep = jax.jit(jax_make_step(jm, JaxAdamW(lr=1e-2)))
    js = _jax_state(jm, np_params)
    batches = _data(jm.cfg, 4)
    for b in batches[:2]:
        js, _ = jstep(js, _j(b))
    jckpt.save(str(tmp_path / "j"), 2, js)
    tstep = make_train_step(tm, AdamW(lr=1e-2))
    like = init_state(tm, AdamW(lr=1e-2), torch.Generator().manual_seed(0))
    ts = ckpt.restore(str(tmp_path / "j"), 2, like)
    assert int(ts.opt.step) == 2
    for b in batches[2:]:
        js, jmet = jstep(js, _j(b))
        ts, tmet = tstep(ts, _t(b))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   **TOL)
    _assert_params(leaves(ts), _flat_np(js), 1e-2, 2)
    ckpt.save(str(tmp_path / "t"), 4, ts)
    back = jckpt.restore(str(tmp_path / "t"), 4, js)
    for a, b in zip(_flat_np(back), leaves(ts)):
        np.testing.assert_array_equal(a, b.detach().numpy())


# ------------------------------------------------------------ data, CLI

@pytest.mark.parametrize("kw", [dict(vocab=4096, batch=4, seq_len=64),
                                dict(vocab=97, batch=3, seq_len=33, seed=5,
                                     motif_len=3, n_motifs=7)])
def test_token_batches_byte_identical(kw):
    a = jdata.token_batches(jdata.DataConfig(**kw))
    b = datasets.token_batches(datasets.DataConfig(**kw))
    for _ in range(3):
        x, y = next(a), next(b)
        for k in ("inputs", "labels"):
            assert x[k].dtype == y[k].dtype
            assert x[k].tobytes() == y[k].tobytes()


def test_trainer_cli_and_resume(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU: the loss falls;
    a run resumed from its step-3 checkpoint ends where the uninterrupted
    run does, bit for bit."""
    from repro_torch.launch import train as cli
    a = str(tmp_path / "a")
    argv = ["--arch", "demo-10m", "--device", "cpu", "--steps", "6",
            "--batch", "4", "--seq", "32", "--ckpt-every", "3",
            "--ckpt-dir", a]
    cli.main(argv)
    assert "done: 6 steps" in capsys.readouterr().out
    assert ckpt.all_steps(a) == [3, 6]
    b = str(tmp_path / "b")
    os.makedirs(b)
    shutil.copytree(os.path.join(a, "step_0000000003"),
                    os.path.join(b, "step_0000000003"))
    out = cli.train("demo-10m", steps=6, batch=4, seq=32, ckpt_dir=b,
                    ckpt_every=3, resume=True, device="cpu",
                    log=lambda s: None)
    assert out["start"] == 3 and len(out["losses"]) == 3
    full = ckpt.restore(a, 6, out["state"])
    for x, y in zip(leaves(full), leaves(out["state"])):
        assert torch.equal(x.detach(), y.detach())


def test_trainer_needs_cuda_unless_told_cpu(monkeypatch):
    from repro_torch.launch import train as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.train("demo-10m", steps=1)


def test_moe_training_on_cuda_refuses_by_name():
    """The kernel wrapper ``ops.moe_gmm`` is not differentiable: a direct
    CUDA call that needs a gradient raises, naming the differentiable entry
    (no output without a grad_fn, no plain fallback); MoE trains through
    ``models.moe.grouped_matmul``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import ops
    with FakeTensorMode():
        x = torch.empty(4, 8, 32, device="cuda", requires_grad=True)
        w = torch.empty(4, 32, 16, device="cuda")
        gs = torch.zeros(4, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="models.moe.grouped_matmul"):
            ops.moe_gmm(x, w, gs)
        with pytest.raises(RuntimeError, match="ops.moe_gmm_bwd"):
            ops.moe_gmm(x.detach(), w.requires_grad_(), gs)
    assert ops.launch_counts()["moe_gmm"] == 0
