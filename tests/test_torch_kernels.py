"""The port's kernels.

CPU: the plain versions (what the wrappers run for CPU tensors) against the
JAX package's oracles (``repro/kernels/ref.py``) on the shapes of
``tests/test_kernel_backends.py`` and the sweeps of ``tests/test_kernels.py``,
in f32 within 2e-5, over the rows an engine reads.  Inputs are drawn once
with numpy and handed to both sides.

Card (``-m cuda``, skips without compute capability 9.0): each CUDA kernel
against its plain version on the same inputs (the grouped matmul's CPU
checks against JAX are in ``tests/test_torch_moe.py``).  These tests import no JAX,
so they run on a machine that has none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import ops  # noqa: E402

F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _jax_ref():
    pytest.importorskip("jax")
    from repro.kernels import ref
    return ref


def _normal(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


def _flash_case(seed, B, S, H, KV, dh):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (B, S, H, dh)), _normal(rng, (B, S, KV, dh)),
            _normal(rng, (B, S, KV, dh)))


def _paged_case(seed, B, S, H, KV, dh, ps, maxp, P):
    rng = np.random.default_rng(seed)
    q = _normal(rng, (B, H, dh) if S is None else (B, S, H, dh))
    kp = _normal(rng, (P, ps, KV, dh))
    vp = _normal(rng, (P, ps, KV, dh))
    table = rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32)
    return q, kp, vp, table


def _flash_both(q, k, v, lengths=None, window=None):
    import jax.numpy as jnp
    ref = _jax_ref()
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tl = None if lengths is None else torch.from_numpy(lengths)
    got = ops.flash_attention(*t, tl, window).numpy()
    want = np.asarray(ref.flash_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)),
        lengths=None if lengths is None else jnp.asarray(lengths),
        window=window))
    return got, want


def _paged_both(q, kp, vp, table, lengths, ps, start=None, window=None):
    import jax.numpy as jnp
    ref = _jax_ref()
    got = ops.paged_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, lengths)),
        page_size=ps, window=window,
        start=None if start is None else torch.from_numpy(start)).numpy()
    want = np.asarray(ref.paged_attention_ref(
        *(jnp.asarray(a) for a in (q, kp, vp, table, lengths)),
        page_size=ps, window=window,
        start=None if start is None else jnp.asarray(start)))
    return got, want


# ---------- plain versions vs the JAX oracles (CPU) ----------

@pytest.mark.parametrize("window", [None, 24])
def test_flash_gqa_lengths_window(window):
    q, k, v = _flash_case(0, 2, 64, 8, 2, 32)
    lengths = np.array([64, 29], np.int32)
    got, want = _flash_both(q, k, v, lengths, window)
    # rows past a sequence's length are unspecified: compare what an
    # engine reads
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **F32_TOL)


@pytest.mark.parametrize("S,H,KV,dh", [
    (64, 4, 4, 16), (128, 4, 2, 32), (256, 8, 2, 16), (64, 2, 1, 64)])
def test_flash_sweep(S, H, KV, dh):
    got, want = _flash_both(*_flash_case(1, 2, S, H, KV, dh))
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_paged_decode_ragged_page_boundaries():
    H, KV, dh, ps, maxp, B = 4, 2, 16, 16, 4, 4
    q, kp, vp, table = _paged_case(2, B, None, H, KV, dh, ps, maxp,
                                   B * maxp + 1)
    # 1, exactly one page, one page + 1, and the full table
    lengths = np.array([1, ps, ps + 1, maxp * ps], np.int32)
    got, want = _paged_both(q, kp, vp, table, lengths, ps)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("window", [None, 7])
def test_paged_extend_crossing_pages(window):
    H, KV, dh, ps, maxp, S, B = 4, 2, 16, 8, 6, 12, 3
    q, kp, vp, table = _paged_case(3, B, S, H, KV, dh, ps, maxp,
                                   B * maxp + 1)
    # chunks starting mid-page, on a boundary, and at zero
    start = np.array([ps - 3, ps, 0], np.int32)
    lengths = start + S
    got, want = _paged_both(q, kp, vp, table, lengths, ps, start, window)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("B,H,KV,dh,ps,maxp", [
    (2, 4, 2, 16, 16, 4), (3, 8, 4, 32, 8, 6), (1, 2, 1, 64, 32, 3)])
def test_paged_decode_sweep(B, H, KV, dh, ps, maxp):
    q, kp, vp, table = _paged_case(4, B, None, H, KV, dh, ps, maxp,
                                   B * maxp + 2)
    lengths = np.array([(i % maxp) * ps + ps // 2 + 1 for i in range(B)],
                       np.int32)
    got, want = _paged_both(q, kp, vp, table, lengths, ps)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_launch_counters_ignore_cpu_calls():
    ops.reset_launch_counts()
    q, k, v = _flash_case(5, 1, 16, 2, 1, 16)
    ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert set(ops.launch_counts()) == set(ops.KERNELS)
    assert not any(ops.launch_counts().values())


# ---------- CUDA kernels vs their plain versions (card only) ----------

@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# f32 kernels sum in another order than the plain version: 1e-4; bf16
# inputs and output round to 8 bits of mantissa: 2e-2, compared in f32
CUDA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,KV,dh,window", [
    (64, 8, 2, 32, None), (64, 8, 2, 32, 24), (128, 4, 2, 16, None),
    (256, 32, 8, 128, None), (512, 32, 8, 128, 100)])
def test_flash_kernel_matches_plain(sm90, dtype, S, H, KV, dh, window):
    q, k, v = (torch.from_numpy(a).to(sm90, dtype)
               for a in _flash_case(6, 2, S, H, KV, dh))
    lengths = torch.tensor([S, S // 2 - 3], dtype=torch.int32, device=sm90)
    got = ops.flash_attention(q, k, v, lengths, window).float()
    want = ops.flash_attention_plain(q, k, v, lengths, window).float()
    for b, n in enumerate(lengths.tolist()):
        err = (got[b, :n] - want[b, :n]).abs().max().item()
        assert err <= CUDA_TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,KV,dh,ps,maxp,window", [
    (None, 4, 2, 16, 16, 4, None), (12, 4, 2, 16, 8, 6, 7),
    (None, 32, 8, 128, 64, 32, None), (256, 32, 8, 128, 64, 32, None)])
def test_paged_kernel_matches_plain(sm90, dtype, S, H, KV, dh, ps, maxp,
                                    window):
    B = 3
    q, kp, vp, table = (torch.from_numpy(a).to(sm90)
                        for a in _paged_case(7, B, S, H, KV, dh, ps, maxp,
                                             B * maxp + 1))
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    if S is None:
        lengths = torch.tensor([1, ps, maxp * ps], dtype=torch.int32,
                               device=sm90)
        start = None
    else:
        start = torch.tensor([ps - 3, ps, 0], dtype=torch.int32,
                             device=sm90)
        lengths = start + S
    got = ops.paged_attention(q, kp, vp, table, lengths, page_size=ps,
                              start=start, window=window).float()
    want = ops.paged_attention_plain(q, kp, vp, table, lengths,
                                     page_size=ps, start=start,
                                     window=window).float()
    err = (got - want).abs().max().item()
    assert err <= CUDA_TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,d,f,gs", [
    (4, 64, 32, 16, None), (8, 128, 16, 64, None), (2, 32, 128, 8, None),
    (4, 48, 32, 24, (48, 0, 5, 17)),
    # the serving path: decode and a 256-token chunk of phimini-moe
    (16, 1, 4096, 960, None), (16, 40, 4096, 960, None),
    (16, 40, 960, 4096, None)])
def test_moe_gmm_kernel_matches_plain(sm90, dtype, E, C, d, f, gs):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_normal(rng, (E, C, d))).to(sm90, dtype)
    # fan-in scaled weights, as the model's: outputs of unit scale, so the
    # f32 sums over d = 4096 in two orders stay within 1e-4 of each other
    w = torch.from_numpy(_normal(rng, (E, d, f)) * d ** -0.5).to(sm90,
                                                                 dtype)
    if gs is None:
        gs = rng.integers(0, C + 1, E)
    gs = torch.tensor(gs, dtype=torch.int32, device=sm90)
    got = ops.moe_gmm(x, w, gs).float()
    want = ops.moe_gmm_plain(x, w, gs).float()
    tol = CUDA_TOL[dtype]
    assert bool(((got - want).abs() <= tol + tol * want.abs()).all())
    rows = torch.arange(C, device=sm90)[None, :] >= gs[:, None]
    assert not got[rows].any()             # rows past a group: exactly 0
