"""The port's kernels.

CPU: the plain versions (what the wrappers run for CPU tensors) against the
JAX package's oracles (``repro/kernels/ref.py``) on the shapes of
``tests/test_kernel_backends.py`` and the sweeps of ``tests/test_kernels.py``,
in f32 within 2e-5, over the rows an engine reads.  Inputs are drawn once
with numpy and handed to both sides.

CPU, no JAX: the serve profiler's kernel classes over every kernel the
CUDA sources define.

Card (``-m cuda``, skips without compute capability 9.0): each CUDA kernel
against its plain version on the same inputs (the grouped matmul's CPU
checks against JAX are in ``tests/test_torch_moe.py``), including the bf16
tensor-core kernels' own paths, and two launches giving the same bits.
These tests import no JAX, so they run on a machine that has none.
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


@pytest.mark.parametrize("window,H,KV,ps,S", [
    pytest.param(None, 4, 2, 8, 12, id="None"),
    pytest.param(7, 4, 2, 8, 12, id="7"),
    # the bf16 extend kernel's group packing: 21 tokens x 3 heads and
    # 7 tokens x 9 heads per 64 rows, one row left over
    pytest.param(None, 6, 2, 8, 12, id="G3"),
    pytest.param(5, 9, 1, 16, 12, id="G9-window"),
    # the engine's page size, chunks from a mid-page start
    pytest.param(None, 4, 2, 64, 40, id="ps64-mid-page"),
])
def test_paged_extend_crossing_pages(window, H, KV, ps, S):
    dh, B = 16, 3
    maxp = max(6, -(-(ps + S) // ps) + 1)
    q, kp, vp, table = _paged_case(3, B, S, H, KV, dh, ps, maxp,
                                   B * maxp + 1)
    # chunks starting mid-page, on a boundary, and at zero
    start = np.array([ps - 3, ps, 0], np.int32)
    lengths = start + S
    got, want = _paged_both(q, kp, vp, table, lengths, ps, start, window)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("B,H,KV,dh,ps,maxp,window", [
    pytest.param(2, 4, 2, 16, 16, 4, None, id="2-4-2-16-16-4"),
    pytest.param(3, 8, 4, 32, 8, 6, None, id="3-8-4-32-8-6"),
    pytest.param(1, 2, 1, 64, 32, 3, None, id="1-2-1-64-32-3"),
    # groups of 3 and 9 query heads per kv-head
    pytest.param(3, 6, 2, 16, 16, 4, None, id="G3"),
    pytest.param(2, 9, 1, 32, 8, 6, None, id="G9"),
    # lengths over 20-odd pages, a window whose edge falls mid-page
    pytest.param(3, 8, 2, 16, 8, 24, 50, id="many-pages-window"),
])
def test_paged_decode_sweep(B, H, KV, dh, ps, maxp, window):
    q, kp, vp, table = _paged_case(4, B, None, H, KV, dh, ps, maxp,
                                   B * maxp + 2)
    if window is None:
        lengths = [(i % maxp) * ps + ps // 2 + 1 for i in range(B)]
    else:
        lengths = [maxp * ps - 7 * i - 3 for i in range(B)]
    lengths = np.array(lengths, np.int32)
    got, want = _paged_both(q, kp, vp, table, lengths, ps, window=window)
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


# the bf16 kernels' own paths (tensor cores): partial and empty tiles, the
# non-TMA loads, long d in few blocks, head dims 16 to 128, windows, lengths
# that end inside a tile; and both dtypes' kernels give the same bits twice

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,KV,dh,lengths,window", [
    (64, 4, 2, 16, (64, 37), None), (96, 4, 1, 32, (96, 50), 17),
    (130, 2, 2, 64, (130, 65), None), (200, 8, 2, 128, (200, 129), 64),
    (256, 32, 8, 128, (256, 100), None), (16, 32, 8, 128, (16, 9), None)])
def test_flash_tensor_core_paths(sm90, dtype, S, H, KV, dh, lengths,
                                 window):
    q, k, v = (torch.from_numpy(a).to(sm90, dtype)
               for a in _flash_case(9, 2, S, H, KV, dh))
    lt = torch.tensor(lengths, dtype=torch.int32, device=sm90)
    got = ops.flash_attention(q, k, v, lt, window)
    assert torch.equal(got, ops.flash_attention(q, k, v, lt, window))
    want = ops.flash_attention_plain(q, k, v, lt, window).float()
    tol = CUDA_TOL[dtype]
    for b, n in enumerate(lengths):
        g, w = got[b, :n].float(), want[b, :n]
        assert bool(((g - w).abs() <= tol + tol * w.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,d,f,gs", [
    (3, 5, 64, 64, (5, 0, 2)),            # C not a multiple of 8, empty
    (2, 13, 128, 32, (13, 13)),           # full groups
    (4, 100, 256, 64, (100, 64, 65, 0)),  # C over one N tile of 64
    (2, 130, 64, 16, (130, 1)),           # three N tiles
    (2, 5, 512, 64, (5, 3)),              # few blocks, 4 ring laps
    (1, 1, 4096, 64, (1,)),               # one block walks d = 4096
    (3, 9, 64, 8, None), (3, 9, 64, 24, None),   # narrow, ragged f
    (3, 7, 20, 13, None), (2, 6, 24, 40, None)])  # no TMA; d 24
def test_moe_gmm_tensor_core_paths(sm90, dtype, E, C, d, f, gs):
    rng = np.random.default_rng(10)
    x = torch.from_numpy(_normal(rng, (E, C, d))).to(sm90, dtype)
    w = torch.from_numpy(_normal(rng, (E, d, f)) * d ** -0.5).to(sm90,
                                                                 dtype)
    if gs is None:
        gs = rng.integers(0, C + 1, E)
    gs = torch.tensor(gs, dtype=torch.int32, device=sm90)
    got = ops.moe_gmm(x, w, gs)
    assert torch.equal(got, ops.moe_gmm(x, w, gs))
    got = got.float()
    want = ops.moe_gmm_plain(x, w, gs).float()
    tol = CUDA_TOL[dtype]
    assert bool(((got - want).abs() <= tol + tol * want.abs()).all())
    rows = torch.arange(C, device=sm90)[None, :] >= gs[:, None]
    assert not got[rows].any()


# the paged kernels' own paths: the split-KV decode with one, several and
# all splits holding keys, lengths of 1, one page and one page + 1, a
# window whose edge falls inside a split, the unscheduled full slot
# (length == maxp * ps + 1: finite, not compared), groups of 1 to 9 query
# heads per kv-head; the bf16 tensor-core extend (and the f32 FMA one) at
# the same groups and page sizes 8 to 64; both give the same bits twice

def _paged_card_case(sm90, dtype, seed, B, S, H, KV, dh, ps, maxp):
    q, kp, vp, table = (torch.from_numpy(a).to(sm90)
                        for a in _paged_case(seed, B, S, H, KV, dh, ps, maxp,
                                             B * maxp + 1))
    return q.to(dtype), kp.to(dtype), vp.to(dtype), table


def _assert_close(got, want, tol):
    got, want = got.float(), want.float()
    assert bool(((got - want).abs() <= tol + tol * want.abs()).all()), \
        (got - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,dh,ps,maxp,lengths,window", [
    (4, 4, 16, 8, 12, (1, 8, 9, 96), None),
    (8, 4, 32, 16, 8, (1, 16, 17, 128, 129), None),
    (6, 2, 64, 16, 10, (40, 100, 160), 37),
    (32, 8, 128, 64, 32, (1, 64, 65, 700, 2048, 2049), None),
    (16, 2, 128, 64, 8, (300, 512), 100),
    (9, 1, 128, 16, 24, (5, 200, 384), 150),
    (18, 2, 64, 8, 40, (320, 33), 77)])
def test_paged_split_decode_paths(sm90, dtype, H, KV, dh, ps, maxp, lengths,
                                  window):
    B = len(lengths)
    q, kp, vp, table = _paged_card_case(sm90, dtype, 11, B, None, H, KV, dh,
                                        ps, maxp)
    lt = torch.tensor(lengths, dtype=torch.int32, device=sm90)
    got = ops.paged_attention(q, kp, vp, table, lt, page_size=ps,
                              window=window)
    assert torch.equal(got, ops.paged_attention(q, kp, vp, table, lt,
                                                page_size=ps, window=window))
    want = ops.paged_attention_plain(q, kp, vp, table, lt, page_size=ps,
                                     window=window)
    for b, n in enumerate(lengths):
        if n > maxp * ps:                  # an unscheduled full slot
            assert bool(torch.isfinite(got[b].float()).all())
        else:
            _assert_close(got[b], want[b], CUDA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_refuses_large_groups(sm90, dtype):
    """Decode carries at most 16 query heads per kv-head: 17 raises, and
    nothing is launched."""
    ops.reset_launch_counts()
    q, kp, vp, table = _paged_card_case(sm90, dtype, 13, 2, None, 34, 2, 16,
                                        8, 4)
    lt = torch.tensor([5, 32], dtype=torch.int32, device=sm90)
    with pytest.raises(ValueError, match="at most 16"):
        ops.paged_attention(q, kp, vp, table, lt, page_size=8)
    assert not any(ops.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,KV,dh,ps,maxp,start,window", [
    (12, 6, 2, 16, 8, 6, (5, 8, 0), None),
    (12, 9, 1, 32, 16, 4, (13, 16, 0), 7),
    (256, 32, 8, 128, 64, 32, (293, 0, 61), None),
    (100, 36, 4, 128, 64, 8, (29, 64, 0), 50),
    (70, 8, 8, 64, 32, 6, (3, 32, 100), None),
    (40, 16, 2, 32, 16, 10, (0, 77, 120), 33)])
def test_paged_extend_tensor_core_paths(sm90, dtype, S, H, KV, dh, ps, maxp,
                                        start, window):
    B = len(start)
    q, kp, vp, table = _paged_card_case(sm90, dtype, 12, B, S, H, KV, dh, ps,
                                        maxp)
    st = torch.tensor(start, dtype=torch.int32, device=sm90)
    lt = st + S
    got = ops.paged_attention(q, kp, vp, table, lt, page_size=ps, start=st,
                              window=window)
    assert torch.equal(got, ops.paged_attention(
        q, kp, vp, table, lt, page_size=ps, start=st, window=window))
    want = ops.paged_attention_plain(q, kp, vp, table, lt, page_size=ps,
                                     start=st, window=window)
    _assert_close(got, want, CUDA_TOL[dtype])


# ---------- the profiler's kernel classes (CPU) ----------

def _kernel_symbols():
    """(kernel name, source file) for every __global__ in csrc/."""
    import re
    from pathlib import Path
    csrc = Path(ops.__file__).resolve().parent / "csrc"
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                     r"(\w+)\s*\(")
    return [(name, p.stem) for p in sorted(csrc.glob("*.cu"))
            for name in pat.findall(p.read_text())]


def test_profiler_classifies_every_port_kernel():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / \
        "profile_torch_serve.py"
    spec = importlib.util.spec_from_file_location("profile_torch_serve",
                                                  path)
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    want = {"flash_attention": "flash_attention (port)",
            "paged_attention": "paged_attention (port)",
            "moe_gmm": "moe_gmm (port)",
            "flash_attention_bwd": "flash_attention_bwd (port)",
            "rope": "rope (port)"}
    symbols = _kernel_symbols()
    names = {n for n, _ in symbols}
    assert {"flash_fwd_kernel", "flash_fwd_wgmma_kernel", "paged_fwd_kernel",
            "paged_decode_split_kernel", "paged_extend_wgmma_kernel",
            "gmm_kernel", "gmm_wgmma_kernel", "flash_bwd_delta_kernel",
            "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
            "flash_bwd_dkdv_wgmma_kernel",
            "flash_bwd_dq_wgmma_kernel", "gmm_dw_kernel",
            "gmm_dx_wgmma_kernel", "gmm_dw_wgmma_kernel",
            "rope_qk_kernel"} <= names
    for name, src in symbols:
        ns = "repro_gmm" if src == "moe_gmm" else "repro_attn"
        # the grouped matmul backward's kernels have their own class (its
        # f32 dx runs the forward's FMA kernel)
        cls = "moe_gmm_bwd (port)" if name.startswith(("gmm_dx", "gmm_dw")) \
            else want[src]
        for shown in (f"void {ns}::{name}<128>(int const*, float*)",
                      f"_ZN{len(ns)}{ns}{len(name)}{name}ILi128EEEvPKiPf"):
            assert prof._kernel_class(shown) == cls, shown
    assert prof._kernel_class(
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"
    ) == "matmul (cuBLAS)"
    assert prof._kernel_class("void at::native::vectorized_elementwise_"
                              "kernel<4, ...>") == "other"


def test_gmm_bwd_time_splits_by_kernel_name():
    """``tools/gmm_bwd_time.py`` (and phase 3 through it) splits a profiled
    backward into dx and dw by kernel name, for this file's kernels and
    for the earlier build whose dx ran on the forward's kernel."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "gmm_bwd_time.py"
    spec = importlib.util.spec_from_file_location("gmm_bwd_time", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    names = {n for n, _ in _kernel_symbols()}
    assert {"gmm_dx_wgmma_kernel", "gmm_dw_wgmma_kernel"} <= names
    for name, part in (("gmm_dx_wgmma_kernel", "dx"),
                       ("gmm_wgmma_kernel", "dx"),
                       ("gmm_dw_wgmma_kernel", "dw")):
        for shown in (f"void repro_gmm::{name}<128, true>(int const*)",
                      f"_ZN9repro_gmm{len(name)}{name}ILi128ELb1EEEvPKi"):
            assert tool.kernel_part(shown) == part, shown
    assert tool.kernel_part("void at::native::vectorized_elementwise_"
                            "kernel<4, ...>") == "other"
