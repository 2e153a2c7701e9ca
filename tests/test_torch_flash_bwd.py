"""Training attention: the port's flash forward (with its log-sum-exp) and
backward against the JAX package's ``repro/models/flash.py``.

CPU: inputs drawn once with numpy go through the JAX function
(``_fwd_scan`` for out and lse, ``jax.vjp`` of ``flash_attention`` for the
gradients, at a ``bkv`` below S so its scan walks several key blocks) and
through the port (the plain versions, and autograd through
``repro_torch.models.flash.flash_attention``), in f32 within rtol 1e-4,
atol 1e-5: the two sum in other orders.  Cases cover G = 1, 3 and 4,
``window``, and ragged ``lengths`` with ``dout`` zero on rows past a
length (those rows' outputs are unspecified in both packages).

Card (``-m cuda``, skips without compute capability 9.0): the forward's
``lse`` and the backward kernel's dq, dk, dv against their plain versions,
in f32 and bf16, and two launches giving the same bits.  JAX is imported
lazily, so the card tests run on a machine without it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.flash import flash_attention  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)

# (B, S, H, KV, dh, lengths, window, bkv)
CASES = [
    (2, 32, 4, 4, 16, None, None, 8),          # G = 1
    (2, 48, 6, 2, 16, None, None, 16),         # G = 3
    (2, 32, 8, 2, 32, None, 7, 8),             # G = 4, a window
    (3, 40, 4, 1, 16, (40, 17, 1), None, 8),   # ragged lengths
    (2, 64, 6, 2, 32, (64, 29), 24, 16),       # lengths and a window
]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import flash as jflash
    return jax, jnp, jflash


def _inputs(seed, B, S, H, KV, dh, lengths):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    do = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    if lengths is not None:
        for b, n in enumerate(lengths):
            do[b, n:] = 0.0            # rows past a length carry no loss
    return q, k, v, do


def _valid_rows(a, lengths):
    if lengths is None:
        return a
    return np.concatenate([a[b, :n].reshape(-1) for b, n in
                           enumerate(lengths)])


@pytest.mark.parametrize("B,S,H,KV,dh,lengths,window,bkv", CASES)
def test_forward_and_lse_match_jax(jx, B, S, H, KV, dh, lengths, window,
                                   bkv):
    jax, jnp, jflash = jx
    q, k, v, _ = _inputs(1, B, S, H, KV, dh, lengths)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    out_j, lse_j = jflash._fwd_scan(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jl, window, bkv, False)
    tl = None if lengths is None else torch.tensor(lengths,
                                                   dtype=torch.int32)
    out_t, lse_t = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                       tl, window, return_lse=True)
    assert tuple(lse_t.shape) == (B, H, S) and lse_t.dtype == torch.float32
    lse_j = np.asarray(lse_j).reshape(B, H, S)
    np.testing.assert_allclose(
        _valid_rows(out_t.numpy(), lengths),
        _valid_rows(np.asarray(out_j), lengths), **TOL)
    np.testing.assert_allclose(
        _valid_rows(lse_t.numpy().transpose(0, 2, 1), lengths),
        _valid_rows(lse_j.transpose(0, 2, 1), lengths), **TOL)


@pytest.mark.parametrize("B,S,H,KV,dh,lengths,window,bkv", CASES)
def test_gradients_match_jax_vjp(jx, B, S, H, KV, dh, lengths, window, bkv):
    jax, jnp, jflash = jx
    q, k, v, do = _inputs(2, B, S, H, KV, dh, lengths)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    # the JAX model hands the window over as an array (a traced int32)
    jw = None if window is None else jnp.int32(window)
    _, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(
        a, b, c, jl, jw, bkv), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tl = None if lengths is None else torch.tensor(lengths,
                                                   dtype=torch.int32)
    out = flash_attention(tq, tk, tv, tl, window)
    out.backward(torch.from_numpy(do))
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), w, err_msg=f"d{name}",
                                   **TOL)


def test_backward_plain_matches_jax_flash_bwd(jx):
    """The plain backward alone, on the JAX forward's own residuals."""
    jax, jnp, jflash = jx
    B, S, H, KV, dh = 2, 48, 8, 2, 16
    lengths, window = (48, 30), 20
    q, k, v, do = _inputs(3, B, S, H, KV, dh, lengths)
    jl = jnp.asarray(lengths, jnp.int32)
    out_j, res = jflash._flash_fwd(*map(jnp.asarray, (q, k, v)), jl,
                                   jnp.int32(window), 16, False)
    dq, dk, dv, _, _ = jflash._flash_bwd(16, False, res, jnp.asarray(do))
    lse = torch.from_numpy(np.asarray(res[4]).reshape(B, H, S))
    got = ops.flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v, np.asarray(out_j))), lse,
        torch.from_numpy(do), torch.tensor(lengths, dtype=torch.int32),
        window)
    for name, g, w in zip("qkv", got, (dq, dk, dv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   err_msg=f"d{name}", **TOL)


def test_no_grad_keeps_no_lse_and_counts_no_launch():
    """Without a gradient the function is the plain forward; CPU calls
    never touch the launch counters."""
    ops.reset_launch_counts()
    q, k, v, _ = map(torch.from_numpy, _inputs(4, 1, 16, 4, 2, 16, None))
    with torch.no_grad():
        out = flash_attention(q, k, v)
    assert out.grad_fn is None
    torch.testing.assert_close(out, ops.flash_attention(q, k, v))
    qg = q.clone().requires_grad_()
    assert flash_attention(qg, k, v).grad_fn is not None
    assert not any(ops.launch_counts().values())


def test_bwd_cuda_call_without_library_raises(monkeypatch, tmp_path):
    """A CUDA tensor reaches the backward kernel or raises: with no
    compiler the wrapper raises the build error, a call the kernel cannot
    take raises before that, and the plain version never runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    def no_nvcc():
        raise build.KernelBuildError("nvcc not found")

    def plain_must_not_run(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", plain_must_not_run)
    ops.reset_launch_counts()
    with FakeTensorMode():
        q = torch.empty(1, 16, 4, 16, device="cuda")
        kv = torch.empty(1, 16, 2, 16, device="cuda")
        lse = torch.empty(1, 4, 16, device="cuda")
        with pytest.raises(build.KernelBuildError):
            ops.flash_attention_bwd(q, kv, kv, q, lse, q)
        with pytest.raises(ValueError, match="lse"):
            ops.flash_attention_bwd(q, kv, kv, q,
                                    torch.empty(1, 4, 8, device="cuda"), q)
        with pytest.raises(ValueError, match="dout"):
            ops.flash_attention_bwd(q, kv, kv, q, lse, torch.empty(
                1, 16, 4, 16, device="cuda", dtype=torch.bfloat16))
    assert ops.launch_counts()["flash_attention_bwd"] == 0


# ------------------------------------------------------------------ card

@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels need compute capability 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs()
    assert bool((err <= tol + tol * want.abs()).all()), float(err.max())


# (B, S, H, KV, dh, lengths, window)
CARD_CASES = [
    (2, 128, 12, 4, 64, None, None),            # demo-110m's heads
    (1, 100, 8, 2, 32, None, None),             # S not a tile multiple
    (2, 96, 4, 4, 16, (96, 41), 30),            # G = 1, ragged, window
    (1, 256, 32, 8, 128, (200,), 64),           # llama3.1-8b's heads
    # the edges of the bf16 kernels' 64-row tiles
    (2, 65, 12, 4, 64, None, None),             # S = 65
    (1, 129, 32, 8, 128, (100,), None),         # S = 129, ragged
    (2, 256, 8, 2, 32, (256, 190), 64),         # a window of exactly 64
    (2, 129, 6, 2, 16, (129, 64), None),        # G = 3 at dh 16
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,dh,lengths,window", CARD_CASES)
def test_bwd_kernel_matches_plain(sm90, dtype, B, S, H, KV, dh, lengths,
                                  window):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    gen = torch.Generator(device=sm90).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=sm90).to(dtype)
    q, k, v, do = rnd(B, S, H, dh), rnd(B, S, KV, dh), rnd(B, S, KV, dh), \
        rnd(B, S, H, dh)
    n = [S] * B if lengths is None else list(lengths)
    for b in range(B):
        do[b, n[b]:] = 0
    lt = torch.tensor(n, dtype=torch.int32, device=sm90)
    out, lse = ops.flash_attention(q, k, v, lt, window, return_lse=True)
    pout, plse = ops.flash_attention_plain(q, k, v, lt, window,
                                           return_lse=True)
    for b in range(B):
        _close(lse[b, :, :n[b]], plse[b, :, :n[b]], tol)
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, lt, window)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, lt, window)
    want = ops.flash_attention_bwd_plain(q, k, v, out, lse, do, lt, window)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        _close(g, w, tol)
