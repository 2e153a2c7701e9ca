"""Training the MoE layer: the grouped matmul's backward and its autograd
Function against the JAX package.

CPU: inputs drawn once with numpy go through the JAX function and through
the port.  ``ops.moe_gmm_bwd_plain`` is held to ``jax.vjp`` of
``repro/kernels/ref.py:moe_gmm_ref`` (f32, rtol 1e-5, atol 1e-6: the two
sum in other orders), with ragged group sizes (0, partial, full) and
nonzero rows past every size in both x and dy; ``models.moe.
grouped_matmul``'s gradients to autograd through the plain forward; and a
whole ``moe_ffn`` layer's x, router and expert gradients (gated and GELU, a
capacity factor low enough to drop entries) to ``jax.grad`` of
``repro/models/moe.py:moe_ffn`` on its reference backend.

Card (``-m cuda``, skips without compute capability 9.0): the backward
kernels against their plain version, in f32 (1e-4) and bf16 (2e-2), bitwise
over two launches, dx's rows past a group exactly 0 and NaN in x's and
dy's rows past a group taking no part.  JAX is imported lazily, so the card
test runs on a machine without it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.models import moe as jmoe
    return jax, jnp, jref, jmoe


def _case(seed, E, C, d, f, gs):
    """x, w, dy (f32, garbage in rows past each size) and int32 sizes."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32)
    dy = rng.standard_normal((E, C, f)).astype(np.float32)
    for e, n in enumerate(gs):
        x[e, n:] = 5.0 + rng.standard_normal((C - n, d))
        dy[e, n:] = -7.0 + rng.standard_normal((C - n, f))
    return x, w, dy, np.asarray(gs, np.int32)


# (E, C, d, f, group sizes): empty, partial and full groups; C and widths
# off the kernels' tiles
BWD_CASES = [
    (3, 5, 16, 8, (0, 3, 5)),
    (4, 12, 24, 40, (12, 0, 7, 1)),
    (2, 9, 13, 7, (9, 4)),
    (5, 20, 32, 16, (0, 0, 20, 19, 2)),
]


@pytest.mark.parametrize("E,C,d,f,gs", BWD_CASES)
def test_bwd_plain_matches_jax_vjp(jx, E, C, d, f, gs):
    jax, jnp, jref, _ = jx
    x, w, dy, g = _case(1, E, C, d, f, gs)
    _, vjp = jax.vjp(lambda a, b: jref.moe_gmm_ref(a, b, jnp.asarray(g)),
                     jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(dy))
    dx, dw = ops.moe_gmm_bwd_plain(*map(torch.from_numpy, (x, w)),
                                   torch.from_numpy(g),
                                   torch.from_numpy(dy))
    assert dx.dtype == dw.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), **F32)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), **F32)
    for e, n in enumerate(gs):
        assert not dx[e, n:].any()                 # rows past a group: 0
    # the CPU call is the plain version: no launch is counted
    ops.reset_launch_counts()
    assert all(torch.equal(a, b) for a, b in zip(
        (dx, dw), ops.moe_gmm_bwd(*map(torch.from_numpy, (x, w)),
                                  torch.from_numpy(g),
                                  torch.from_numpy(dy))))
    assert ops.launch_counts()["moe_gmm_bwd"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,d,f,gs", BWD_CASES[:2])
def test_grouped_matmul_grads_match_autograd_of_plain(monkeypatch, dtype, E,
                                                      C, d, f, gs):
    """The Function's forward is ``ops.moe_gmm``, its backward one
    ``ops.moe_gmm_bwd`` call; both equal autograd through the plain
    forward's einsum."""
    x, w, dy, g = _case(2, E, C, d, f, gs)
    calls = []
    real = ops.moe_gmm_bwd

    def recorded(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(ops, "moe_gmm_bwd", recorded)
    gt = torch.from_numpy(g)
    cot = torch.from_numpy(dy).to(dtype)
    got, want = [], []
    for fn, out in ((moe.grouped_matmul, got), (ops.moe_gmm_plain, want)):
        xt = torch.from_numpy(x).to(dtype).requires_grad_()
        wt = torch.from_numpy(w).to(dtype).requires_grad_()
        y = fn(xt, wt, gt)
        out.extend([y, *torch.autograd.grad(y, (xt, wt), cot)])
    assert got[0].grad_fn is not None and len(calls) == 1
    tol = F32 if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.detach(), b.detach(), **tol)


def test_grouped_matmul_without_grad_is_the_kernel_wrapper():
    x, w, _, g = _case(3, 2, 4, 8, 8, (4, 1))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    gt = torch.from_numpy(g)
    with torch.no_grad():
        y = moe.grouped_matmul(xt, wt, gt)
    assert y.grad_fn is None
    assert torch.equal(y, ops.moe_gmm(xt.detach(), wt.detach(), gt))
    plain = moe.grouped_matmul(xt.detach(), wt.detach(), gt)
    assert plain.grad_fn is None and torch.equal(plain, y)


def _ffn_params(seed, d, de, E):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, E)),
         "w_gate": rng.standard_normal((E, d, de)) * 0.3,
         "w_up": rng.standard_normal((E, d, de)) * 0.3,
         "w_down": rng.standard_normal((E, de, d)) * 0.3}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("gated", [True, False])
def test_moe_ffn_grads_match_jax(jx, gated):
    """A tiny layer at capacity factor 0.5 (C = 5 for 20 tokens top-2 over
    4 experts, so entries drop): the loss sum(y * r) + aux, its gradient
    to x, the router and every expert weight against ``jax.grad``."""
    jax, jnp, _, jmoe = jx
    rng = np.random.default_rng(11)
    T, d, de, E, k, cf = 20, 16, 8, 4, 2, 0.5
    x = rng.standard_normal((T, d)).astype(np.float32)
    r = rng.standard_normal((T, d)).astype(np.float32)
    p = _ffn_params(12, d, de, E)
    if not gated:
        del p["w_gate"]
    kw = dict(top_k=k, capacity_factor=cf, gated=gated)

    def jloss(xa, pa):
        y, aux = jmoe.moe_ffn(xa, pa, backend="reference", **kw)
        return jnp.sum(y * jnp.asarray(r)) + aux

    gx_j, gp_j = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()})
    xt = torch.from_numpy(x).requires_grad_()
    pt = {n: torch.from_numpy(v).requires_grad_() for n, v in p.items()}
    y, aux = moe.moe_ffn(xt, pt, **kw)
    loss = torch.sum(y * torch.from_numpy(r)) + aux
    names = sorted(pt)
    grads = torch.autograd.grad(loss, [xt] + [pt[n] for n in names])
    # entries really dropped: an expert is routed more than C entries
    C = int(round(T * k * cf / E))
    ti, _, _ = moe.router_topk(xt.detach(), pt["router"].detach(), k)
    assert int(torch.bincount(ti.reshape(-1).long()).max()) > C
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_j),
                               rtol=1e-5, atol=1e-5)
    for n, gt in zip(names, grads[1:]):
        assert gt.abs().max() > 0, n
        np.testing.assert_allclose(gt.numpy(), np.asarray(gp_j[n]),
                                   rtol=1e-5, atol=1e-5, err_msg=n)


def test_bwd_cuda_call_reaches_the_kernel_library_or_raises(monkeypatch,
                                                            tmp_path):
    """A CUDA tensor in ``moe_gmm_bwd`` goes to the kernel library, never
    to the plain version: with no compiler it raises the build error, and
    a shape, dtype or layout the kernel does not take raises before that."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import build
    from repro_torch.kernels import moe_gmm as gm

    def no_nvcc():
        raise build.KernelBuildError("nvcc not found")

    def plain_must_not_run(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(gm, "moe_gmm_bwd_plain", plain_must_not_run)
    ops.reset_launch_counts()
    with FakeTensorMode():
        x = torch.empty(4, 8, 32, device="cuda")
        w = torch.empty(4, 32, 16, device="cuda")
        dy = torch.empty(4, 8, 16, device="cuda")
        gs = torch.zeros(4, dtype=torch.int32, device="cuda")
        with pytest.raises(build.KernelBuildError):
            ops.moe_gmm_bwd(x, w, gs, dy)
        with pytest.raises(TypeError):
            ops.moe_gmm_bwd(x.half(), w.half(), gs, dy.half())
        with pytest.raises(ValueError, match="dy must be"):
            ops.moe_gmm_bwd(x, w, gs, torch.empty(4, 4, 16, device="cuda"))
        with pytest.raises(ValueError, match="dy must be"):
            ops.moe_gmm_bwd(x, w, gs, torch.empty(
                4, 8, 16, device="cuda", dtype=torch.bfloat16))
        with pytest.raises(ValueError, match="contiguous"):
            ops.moe_gmm_bwd(x, w, gs, torch.empty_strided(
                (4, 8, 16), (128, 1, 8), device="cuda"))
        with pytest.raises(ValueError, match="int32"):
            ops.moe_gmm_bwd(x, w, gs.long(), dy)
    assert ops.launch_counts()["moe_gmm_bwd"] == 0


def test_backward_is_registered_with_its_counterpart():
    source, replaces = ops.KERNELS["moe_gmm_bwd"]
    assert source == ops.KERNELS["moe_gmm"][0]
    assert replaces == "src/repro/models/moe.py:125"
    assert "moe_gmm_bwd" in ops.launch_counts()


# ---------- the CUDA kernels vs their plain version (card only) ----------

@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# f32: the kernels sum in other orders than the plain version; bf16: inputs
# and outputs round to 8 mantissa bits; |got - want| <= tol + tol * |want|
CUDA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,d,f,gs", [
    (6, 65, 64, 128, (0, 1, 63, 64, 65, 30)),    # sizes around a K stage
    (3, 130, 72, 200, (130, 129, 0)),            # partial d and f tiles
    (2, 9, 20, 13, (9, 4)),                      # widths off 8: no TMA
    (16, 320, 4096, 960, None),                  # phimini-moe training
    # the persistent grid: granite-moe-3b's training shape (E40 top-8,
    # C = 512); one expert of 1024 rows, fewer tiles than SMs; every group
    # 0 (every tile skipped, dw all zero); groups at the edges of the
    # 128-row tiles
    (40, 512, 1536, 512, None),
    (1, 1024, 256, 384, (1024,)),
    (4, 64, 128, 192, (0, 0, 0, 0)),
    (3, 320, 256, 192, (127, 128, 129)),
])
def test_bwd_kernel_matches_plain(sm90, dtype, E, C, d, f, gs):
    rng = np.random.default_rng(21)
    if gs is None:
        gs = rng.integers(0, C + 1, E)
    x, w, dy, g = _case(22, E, C, d, f, gs)
    for e, n in enumerate(gs):
        x[e, n:] = np.nan                        # rows past a group: any
        dy[e, n:] = np.nan                       # data takes no part
    xt, wt, dyt = (torch.from_numpy(a).to(sm90, dtype) for a in (x, w, dy))
    gt = torch.from_numpy(g).to(sm90)
    ops.reset_launch_counts()
    got = ops.moe_gmm_bwd(xt, wt, gt, dyt)
    again = ops.moe_gmm_bwd(xt, wt, gt, dyt)
    torch.cuda.synchronize()
    assert ops.launch_counts()["moe_gmm_bwd"] == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ops.moe_gmm_bwd_plain(xt, wt, gt, dyt)
    tol = CUDA_TOL[dtype]
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        assert bool(((a - b).abs() <= tol + tol * b.abs()).all())
    past = torch.arange(C, device=sm90)[None, :] >= gt[:, None]
    assert not got[0][past].any()
    if not any(gs):                              # no row: dw exactly 0
        assert not got[1].any()
