"""The benchmark's counts against hand-worked shapes, and against the
bounds of the kernel table in PERF.md (its rows' bound column, ms)."""
import pytest
import torch

from perfbench import counts, readers
from perfbench.tracing import Capture


def ms(work):
    return 1e3 * counts.bound_s(*work)


def test_flash_by_hand():
    # 4 tokens, one head of width 2: 10 causal pairs
    flops, nbytes = counts.flash_prefill([4], H=1, KV=1, dh=2, itemsize=2)
    assert flops == 4 * 1 * 2 * 10
    assert nbytes == (2 * 4 * 2 + 2 * 4 * 2) * 2 + 4


def test_extend_by_hand():
    # 2 new tokens after 3 cached: pairs 4 + 5; context 5 in 2 pages of 4
    flops, nbytes = counts.paged_extend([3], [2], H=2, KV=1, dh=4,
                                        page_size=4, itemsize=2)
    assert flops == 4 * 2 * 4 * 9
    assert nbytes == (2 * 2 * 2 * 4 + 2 * 5 * 1 * 4) * 2 + 4 * 2 + 8


def test_decode_by_hand():
    flops, nbytes = counts.paged_decode([5, 1], H=2, KV=1, dh=4,
                                        page_size=4, itemsize=2)
    assert flops == 4 * 2 * 4 * 6
    assert nbytes == (2 * 2 * 2 * 4 + 2 * 6 * 4) * 2 + 4 * 3 + 4 * 2


def test_moe_gmm_by_hand():
    # 3 experts, one empty: its weights are not read
    flops, nbytes = counts.moe_gmm(3, 4, d=8, f=2, group_sizes=[4, 0, 9],
                                   itemsize=2)
    assert flops == 2 * 8 * 8 * 2
    assert nbytes == (2 * 8 * 2 + 8 * 8 + 3 * 4 * 2) * 2 + 12


@pytest.mark.parametrize("row, work, bound_ms", [
    ("flash B1 S256 H32 KV8 dh128",
     counts.flash_prefill([256], 32, 8, 128), 0.0016),
    ("extend B1 S256 from 293",
     counts.paged_extend([293], [256], 32, 8, 128, 64), 0.0019),
    ("moe_gmm gate/up E16 C40 d4096 f960, 508 rows",
     counts.moe_gmm(16, 40, 4096, 960, [32] * 15 + [28]), 0.0392),
    ("moe_gmm down E16 C40 d960 f4096, 508 rows",
     counts.moe_gmm(16, 40, 960, 4096, [32] * 15 + [28]), 0.0394),
])
def test_perf_table_bounds(row, work, bound_ms):
    assert round(ms(work), 4) == bound_ms, row


def test_model_flops_by_hand():
    sizes = {"n_layers": 2, "d_model": 4, "n_heads": 2, "n_kv_heads": 1,
             "d_head": 2, "d_ff": 8, "vocab": 10, "mlp_gated": False}
    w = counts.matmul_params(sizes)
    assert w["layer"] == 4 * (2 + 2) * 2 + 2 * 2 * 4 + 2 * 4 * 8
    assert w["head"] == 40
    # a chunk of 3 from 0 (1 logit), a decode at position 5
    got = counts.model_flops(sizes, [(0, 3, 1), (5, 1, 1)])
    want = 2 * 4 * w["layer"] * 2 + 4 * 2 * 2 * (6 + 6) * 2 + 2 * 2 * 40
    assert got == want
    moe = dict(sizes, moe={"n_experts": 4, "top_k": 2, "d_expert": 3})
    assert counts.matmul_params(moe)["layer"] == \
        4 * (2 + 2) * 2 + 2 * 2 * 4 + 4 * 4 + 2 * 3 * 4 * 3


# rows of (start, new tokens): a first chunk, chunks after a cached
# prefix, a decode-sized one; the widest context is 49
STARTS, NEWS = [0, 3, 17, 40], [11, 7, 30, 9]
WIDEST = max(s + n for s, n in zip(STARTS, NEWS))


def brute(start, n, window, page_size):
    """(visible pairs, keys seen, pages of those keys) of n queries at
    start ... start + n - 1, a query at p seeing key j iff j <= p and
    p - j < window."""
    seen = [(p, j) for p in range(start, start + n) for j in range(p + 1)
            if window is None or p - j < window]
    keys = {j for _, j in seen}
    return len(seen), len(keys), len({j // page_size for j in keys})


@pytest.mark.parametrize("window", [5, WIDEST, 2 ** 30, None])
def test_windowed_counts_against_brute_force(window):
    H, KV, dh, P, it = 4, 2, 8, 8, 2
    pairs = [brute(s, n, window, P) for s, n in zip(STARTS, NEWS)]
    # flash: one row a chunk from position 0, every key seen by a query
    flops, nbytes = counts.flash_prefill(NEWS, H, KV, dh, it, window)
    assert flops == sum(4 * H * dh * brute(0, n, window, P)[0]
                        for n in NEWS)
    assert nbytes == counts.flash_prefill(NEWS, H, KV, dh, it)[1]
    flops, nbytes = counts.paged_extend(STARTS, NEWS, H, KV, dh, P, it,
                                        window)
    assert flops == sum(4 * H * dh * p for p, _, _ in pairs)
    assert nbytes == (2 * sum(NEWS) * H * dh
                      + 2 * sum(k for _, k, _ in pairs) * KV * dh) * it \
        + 4 * sum(g for _, _, g in pairs) + 8 * len(STARTS)
    lengths = [s + n for s, n in zip(STARTS, NEWS)]
    last = [brute(n - 1, 1, window, P) for n in lengths]
    flops, nbytes = counts.paged_decode(lengths, H, KV, dh, P, it, window)
    assert flops == sum(4 * H * dh * p for p, _, _ in last)
    assert nbytes == (2 * len(lengths) * H * dh
                      + 2 * sum(k for _, k, _ in last) * KV * dh) * it \
        + 4 * sum(g for _, _, g in last) + 4 * len(lengths)
    if window is None or window >= WIDEST:
        # as wide as the context: full causal, today's count
        assert counts.paged_extend(STARTS, NEWS, H, KV, dh, P, it, window) \
            == counts.paged_extend(STARTS, NEWS, H, KV, dh, P, it)
    else:
        assert counts.paged_extend(STARTS, NEWS, H, KV, dh, P, it, window) \
            < counts.paged_extend(STARTS, NEWS, H, KV, dh, P, it)


def test_capture_records_each_calls_window():
    """The traced run's record of a flash, a decode and an extend call
    keeps its window, and the readers count a prefill call inside it."""
    from repro_torch.kernels import ops
    cap = Capture()
    cap._wrap()
    try:
        q, kv = torch.randn(1, 12, 4, 8), torch.randn(1, 12, 2, 8)
        ops.flash_attention(q, kv, kv, None, 5)
        pages = torch.randn(4, 8, 2, 8)
        table = torch.arange(2, dtype=torch.int32)[None]
        n = torch.tensor([12], dtype=torch.int32)
        ops.paged_attention(torch.randn(1, 4, 8), pages, pages, table, n,
                            page_size=8, window=5)
        ops.paged_attention(torch.randn(1, 3, 4, 8), pages, pages, table, n,
                            page_size=8, window=5,
                            start=torch.tensor([9], dtype=torch.int32))
    finally:
        cap._unwrap()
    assert [c["window"] for c in cap._calls["decode"]] == [5]
    want = {"flash": counts.flash_prefill([12], 4, 2, 8, 4, window=5),
            "extend": counts.paged_extend([9], [3], 4, 2, 8, 8, 4,
                                          window=5)}
    for fam, work in want.items():
        (call,) = cap._calls[fam]
        call = {k: Capture._host(v) for k, v in call.items()}
        assert call["window"] == 5
        assert readers.call_work(fam, call) == work
        assert work[0] < readers.call_work(fam, dict(call, window=None))[0]
