"""The benchmark's counts against hand-worked shapes, and against the
bounds of the kernel table in PERF.md (its rows' bound column, ms)."""
import pytest

from perfbench import counts


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
