"""The sequence-sharded decode cache and the fused QKV projection at tp > 1
in the port: gloo ranks on the CPU against the port's one process and the
JAX package.

A decode cache's sequence splits as JAX's ``cache_pspecs`` splits it
(``RankGrid.seq_group``): a batch of one over the ``data`` axis (every
``long_500k`` cell), a larger batch over ``model`` under
``seq_shard_cache``.  Each rank holds tokens ``sharding.seq_range`` of
every sequence, its paged decode returns the log-sum-exp beside its
output, and ``collectives.combine_lse`` merges the ranks' parts.

Without a spawn: the plain decode's log-sum-exp against a direct one over
the scaled scores (windows, rows with no key, groups of 1 to 9); the
cache's pages to a rank and back; the fused leaf's shard and gather round
trip and its leaf plan; the dry run's ``long_500k``, ``seq_shard_cache``
and ``fuse_qkv`` cells at the JAX study's meshes.

``repro_torch.launch.mesh.run_ranks`` spawns four gloo ranks once for the
module; grids of two and three ranks lie on the world's first ranks
(``grid_on_world``).  Tiny f32 configs, the weights drawn by the JAX
package:

* ``combine_lse`` over four key ranges (some empty, all but one empty)
  equal to the whole within 1e-6;
* batch-1 decodes of llama3.1-8b-tiny, gemma3-27b-tiny cut to two layers
  (a windowed one and a global one) and zamba2-1.2b-tiny on (2, 1), (4,
  1) and (2, 2) grids, from contexts of 10 tokens (ranks past them
  empty) and 45 (the tail crosses a rank boundary during the steps):
  every step's logits equal the port's one process and JAX's
  ``Model.decode`` on the contiguous cache within 1e-5;
* B4 decodes under ``seq_shard_cache``: llama3.1-8b-tiny at (1, 2) and a
  padded-head config (5 query heads on one KV head) at (1, 3);
* ``fuse_qkv``: qwen3-8b-tiny and the padded config at tp = 2 and 3,
  prefill and decode logits against the port's tp = 1 and JAX's fused
  model; two AdamW steps of qwen3-8b-tiny on a (1, 2) grid and of the
  padded config on a (2, 2) grid (its KV head shared by both model ranks)
  against JAX's one-device ``fuse_qkv=True`` step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ref import (paged_attention_ref,  # noqa: E402
                                     paged_decode_lse_ref)
from repro_torch.launch import sharding  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
MAX_LEN, PAGE, STEPS, WORLD = 96, 16, 6, 4
LR, TRAIN_STEPS, TRAIN_B, TRAIN_S = 1e-2, 2, 4, 16
# name -> (arch, config overrides, layers or None)
VARIANTS = {
    "llama": ("llama3.1-8b-tiny", {}, None),
    "gemma": ("gemma3-27b-tiny", {}, 2),
    "zamba": ("zamba2-1.2b-tiny", {}, None),
    "qwen3": ("qwen3-8b-tiny", dict(d_ff=96), None),
    "padded": ("qwen3-8b-tiny", dict(n_heads=5, n_kv_heads=1, d_ff=96),
               None),
}
FUSED = ("qwen3", "padded")
#: batch-1 decodes: grid (dp, tp) x variant x context
BATCH1 = tuple((g, n, ctx) for g in ((2, 1), (4, 1), (2, 2))
               for n in ("llama", "gemma", "zamba") for ctx in (10, 45))
#: B4 decodes under seq_shard_cache: (grid, variant)
SEQ_MODEL = (((1, 2), "llama"), ((1, 3), "padded"))
SEQ_MODEL_LENS = (10, 45, 30, 60)
#: fused logits at tp, and the fused train steps' grids
FUSED_LOGITS = tuple((tp, n) for n in FUSED for tp in (2, 3))
FUSED_TRAIN = ((("qwen3"), (1, 2)), (("padded"), (2, 2)))
GRIDS = ((2, 1), (4, 1), (2, 2), (1, 2), (1, 3))


def _cfg(get, name):
    arch, over, layers = VARIANTS[name]
    cfg = dataclasses.replace(get(arch), compute_dtype="float32", **over)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers, stages=(
            dataclasses.replace(cfg.stages[0], n_layers=layers),))
    return cfg


# ------------------------------------------------ the plain decode's lse
def _direct(q, kp, vp, table, lengths, starts, window, ps):
    """Row by row: the scaled scores of the visible keys, their
    log-sum-exp and the softmax-weighted values."""
    B, H, dh = q.shape
    KV = kp.shape[2]
    G = H // KV
    out = torch.zeros(B, H, dh, dtype=torch.float64)
    lse = torch.full((B, H), float("-inf"), dtype=torch.float64)
    for b in range(B):
        keys = [j for j in range(int(lengths[b]))
                if j <= starts[b] and (window is None
                                       or starts[b] - j < window)]
        if not keys:
            continue
        pos = torch.tensor(keys)
        pages = table[b, pos // ps].long()
        k = kp[pages, pos % ps].double()            # (n, KV, dh)
        v = vp[pages, pos % ps].double()
        for h in range(H):
            s = k[:, h // G] @ q[b, h].double() * dh ** -0.5
            lse[b, h] = torch.logsumexp(s, 0)
            out[b, h] = torch.softmax(s, 0) @ v[:, h // G]
    return out, lse


@pytest.mark.parametrize("G", range(1, 10))
def test_plain_decode_lse_matches_direct(G):
    """``paged_decode_lse_ref`` (the plain version the kernel is held to):
    its lse equals a direct log-sum-exp of the scaled scores, its output
    ``paged_attention_ref``'s (within 1e-6), over windows, queries before, inside and
    past the keys (a rank's local positions) and rows with no visible key
    (output 0, lse -inf), at G query heads a KV head."""
    gen = torch.Generator().manual_seed(G)
    B, KV, dh, ps, maxp = 6, 2, 16, 4, 5
    H = G * KV
    P = B * maxp + 1
    q = torch.randn(B, H, dh, generator=gen)
    kp = torch.randn(P, ps, KV, dh, generator=gen)
    vp = torch.randn(P, ps, KV, dh, generator=gen)
    table = torch.randperm(B * maxp, generator=gen).reshape(B, maxp).int()
    lengths = torch.tensor([20, 0, 13, 7, 20, 9], dtype=torch.int32)
    starts = torch.tensor([19, 5, -2, 30, 11, 8], dtype=torch.int32)
    for window in (None, 3, 8):
        out, lse = paged_decode_lse_ref(q, kp, vp, table, lengths,
                                        page_size=ps, start=starts,
                                        window=window)
        want, wlse = _direct(q, kp, vp, table, lengths, starts.tolist(),
                             window, ps)
        empty = torch.isinf(wlse)
        assert torch.equal(torch.isinf(lse), empty)
        assert bool(empty[1].all()) and bool(empty[2].all())
        assert not bool(out[empty].any())
        np.testing.assert_allclose(lse[~empty].numpy(),
                                   wlse[~empty].numpy(), rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_allclose(out.double().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
        full = paged_attention_ref(q, kp, vp, table, lengths, page_size=ps,
                                   start=starts, window=window)
        live = ~empty.all(dim=1)
        np.testing.assert_allclose(out[live].numpy(), full[live].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_seq_pages_round_trip_and_ranges():
    """Every rank's tokens of a cache (``seq_range``: ceil(S / n) a rank
    from rank 0) moved to its pages and gathered back, bitwise."""
    gen = torch.Generator().manual_seed(0)
    B, S, ps, L = 3, 90, 16, 2
    maxp = -(-S // ps)
    pool = torch.randn(L, B * maxp + 1, ps, 2, 8, generator=gen)
    table = torch.randperm(B * maxp, generator=gen).reshape(B, maxp).int()
    for n in (2, 3, 4):
        c = -(-S // n)
        parts = []
        for r in range(n):
            lo, hi = sharding.seq_range(S, r, n)
            assert (lo, hi) == (min(r * c, S), min((r + 1) * c, S))
            mp = -(-(hi - lo) // ps)
            t = torch.arange(B * mp, dtype=torch.int32).reshape(B, mp)
            part = torch.zeros(L, B * mp + 1, ps, 2, 8)
            sharding.take_seq_pages(pool, table, part, t, lo, hi, ps)
            parts.append((part, t, lo, hi))
        back = torch.zeros_like(pool)
        sharding.gather_seq_pages(parts, back, table, ps)
        pos = torch.arange(S)
        idx = table[:, pos // ps].long()
        assert torch.equal(back[:, idx, pos % ps], pool[:, idx, pos % ps])


# ------------------------------------------------------- fused: layout
@pytest.mark.parametrize("name,tp", [(n, tp) for n in FUSED
                                     for tp in (2, 3)])
def test_fused_shard_gather_round_trip(name, tp):
    """The fused ``wqkv`` splits strided (each rank: its query heads'
    columns, then its KV heads' K and V columns) and gathers back bitwise;
    ``unsupported`` names no reason."""
    from repro_torch.models import Model
    from repro_torch.train.tree import leaves
    cfg = _cfg(get_config, name)
    assert sharding.unsupported(cfg, tp, fuse_qkv=True) is None
    full = Model(cfg, fuse_qkv=True).init(torch.Generator().manual_seed(0))
    parts = [sharding.shard_params(full, r, tp, cfg=cfg) for r in range(tp)]
    dh = cfg.d_head
    for r, p in enumerate(parts):
        qlo, qhi = sharding.query_heads(cfg, r, tp)
        klo, khi = sharding.kv_heads(cfg, r, tp)
        w = full["stage0"]["attn"]["wqkv"]
        H, KV = cfg.n_heads, cfg.n_kv_heads
        want = torch.cat([w[..., qlo * dh:qhi * dh],
                          w[..., (H + klo) * dh:(H + khi) * dh],
                          w[..., (H + KV + klo) * dh:(H + KV + khi) * dh]],
                         dim=-1)
        assert torch.equal(p["stage0"]["attn"]["wqkv"], want)
    got = sharding.gather_params(parts, cfg, tp)
    for a, b in zip(leaves(got), leaves(full)):
        assert torch.equal(a, b)


def test_fused_leaf_plan_sums_only_kv_columns():
    """The padded config at tp = 3 (query heads 2 / 2 / 1, one KV head
    read by every rank): the fused leaf's gradient is summed over the
    readers on its K and V columns only, never its query columns, and the
    global norm counts the query columns and the owned KV head's."""
    from repro_torch.models import Model
    cfg = _cfg(get_config, "padded")
    full = Model(cfg, fuse_qkv=True).init(torch.Generator(), device="meta")
    dh = cfg.d_head
    assert sharding.shared_kv_heads(cfg, 3) == ((0, (0, 1, 2)),)
    for r, hq in enumerate((2, 2, 1)):
        shard = sharding.shard_params(full, r, 3, cfg=cfg)
        plan = {p.path[-1]: p for p in sharding.leaf_plan(shard, cfg, 3, r)}
        fused = plan["wqkv"]
        assert fused.grad_sum == "kv"
        assert fused.kv_shared == ((0, hq * dh, (hq + 1) * dh),
                                   (0, (hq + 1) * dh, (hq + 2) * dh))
        assert fused.norm == "model"
        assert fused.norm_cols == (None if r == 0 else ((0, hq * dh),))


# ------------------------------------------------------------ dry run
MESHES = (("16x16", dict(dp=16, tp=16)), ("2x16x16", dict(multi_pod=True)))
LONG = tuple((a, m) for a in ("gemma3-27b", "zamba2-1.2b") for m in MESHES)
#: each arch's need (argument + temp bytes) before the split (PERF.md)
LONG_BEFORE = {"gemma3-27b": 23.93e9, "zamba2-1.2b": 1.96e9}


def _combine_bytes(cfg, layers, H):
    """The combine's result bytes a decode step: per attention layer an
    all-reduce (max) of B·H·4 and one (sum) of B·H·(dh + 1)·4, B = 1."""
    return layers * H * (cfg.d_head + 2) * 4


@pytest.mark.parametrize("arch,mesh", LONG,
                         ids=[f"{a}-{m[0]}" for a, m in LONG])
def test_dryrun_long_500k_splits_the_sequence_over_data(arch, mesh):
    """``long_500k``'s batch of one splits its cache's sequence 16 ways
    over ``data`` (the pod axis a replica): no ``batch_replicated``, the
    rank's KV pool 1/16 of the whole sequence's (up to the scratch
    pages), the combine's bytes on ``data`` by formula, and the need
    under 9 GB (gemma3-27b) and under dp = 1's (zamba2-1.2b)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import counting_grid, make_production_mesh
    from repro_torch.models import Model
    rec = dryrun.lower_cell(arch, "long_500k", **mesh[1])
    assert rec["status"] == "ok" and "batch_replicated" not in rec, rec
    assert "splits over data (16 ranks, 32768 of 524288" in rec["note"]
    cfg = get_config(arch)
    grid = counting_grid(make_production_mesh(
        multi_pod=mesh[1].get("multi_pod", False)))
    tp = grid.tp
    H = sharding.query_heads(cfg, 0, tp)[1]
    layers = sum(st.n_layers for st in cfg.stages
                 if st.kind in ("attn_mlp", "zamba_super"))
    assert rec["collective_bytes_by_axis"]["data"] == {
        "all-reduce": _combine_bytes(cfg, layers, H)}
    mem = rec["memory"]
    need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert need < (9e9 if arch == "gemma3-27b" else LONG_BEFORE[arch])
    # the rank's pools against dp = 1's of the same rank's heads
    kw = dict(group=grid.model)
    whole = Model(cfg, **kw).init_cache(1, 524288, device="meta")
    mine = Model(cfg, seq_group=grid.seq_group(1), **kw).init_cache(
        1, 524288, device="meta")
    pools = [(a["k_pages"], b["k_pages"]) for (_, a), (_, b) in zip(
        Model(cfg, **kw).attention_caches(mine),
        Model(cfg, **kw).attention_caches(whole))]
    for a, b in pools:
        assert a.shape[1] - 2 == (b.shape[1] - 2) // 16      # + scratch
        assert a.shape[2:] == b.shape[2:]


def test_dryrun_xlstm_long_500k_has_nothing_to_split():
    """xlstm-125m has no attention cache: its batch of one keeps its
    recurrent state split by heads over model and replicated over data,
    as in JAX, and the record says so."""
    from repro_torch.launch import dryrun
    rec = dryrun.lower_cell("xlstm-125m", "long_500k", dp=16, tp=16)
    assert rec["status"] == "ok" and "batch_replicated" not in rec, rec
    assert "no attention cache to split over data" in rec["note"]
    assert "data" not in rec["collective_bytes_by_axis"]


def test_dryrun_seq_shard_cache_decode_32k():
    """``seq_shard_cache=True``: decode_32k's 8 rows a rank hold every KV
    head for 32768 / 16 tokens, the query heads are all-gathered and the
    combine runs on ``model``; without it the heads split as before."""
    from repro_torch.launch import dryrun
    cfg = get_config("llama3.1-8b")
    plain = dryrun.lower_cell("llama3.1-8b", "decode_32k", dp=16, tp=16)
    rec = dryrun.lower_cell("llama3.1-8b", "decode_32k", dp=16, tp=16,
                            seq_shard_cache=True)
    assert rec["status"] == plain["status"] == "ok"
    assert "splits over model (16 ranks, 2048 of 32768 tokens a rank, " \
           "every KV head)" in rec["note"]
    assert "note" not in plain
    model = rec["collective_bytes_by_axis"]["model"]
    L, B, H = cfg.n_layers, 8, cfg.n_heads
    # per layer: each rank's 2 query heads and its one KV head's K and V
    # gathered over 16 ranks (bf16 activations), then the combine over
    # all 32 heads
    gather = L * 16 * B * cfg.d_head * 2 * (2 + 1 + 1)
    assert model["all-gather"] - plain["collective_bytes_by_axis"][
        "model"]["all-gather"] == gather
    assert model["all-reduce"] - plain["collective_bytes_by_axis"][
        "model"]["all-reduce"] == L * B * H * (cfg.d_head + 2) * 4
    assert rec["kernels"]["paged_attention_decode"]["launches"] == L
    from repro_torch.launch.mesh import counting_grid, grid_mesh
    from repro_torch.models import Model
    grid = counting_grid(grid_mesh(16, 16))
    model = Model(cfg, group=grid.model, seq_group=grid.seq_group(B, True))
    cache = model.init_cache(B, 32768, device="meta")
    pool = model.attention_caches(cache)[0][1]["k_pages"]
    assert cache["seq_range"] == (0, 2048)
    assert pool.shape == (L, B * 2048 // 64 + B + 1, 64, cfg.n_kv_heads,
                          cfg.d_head)


def test_dryrun_fuse_qkv_at_16x16():
    """qwen3-8b with the fused projection counts at 16×16."""
    from repro_torch.launch import dryrun
    for shape in ("decode_32k", "train_4k"):
        rec = dryrun.lower_cell("qwen3-8b", shape, dp=16, tp=16,
                                fuse_qkv=True)
        assert rec["status"] == "ok" and rec["fuse_qkv"], rec


# --------------------------------------------------------- the ranks' side
def _contexts(vocab, name, B, lens, seed):
    """Prompts padded to 64 tokens (pad tails past ``lens``) and each
    step's token."""
    rng = np.random.default_rng(seed)
    S = 64
    return {"toks": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "lengths": np.array(lens, np.int32),
            "dec": rng.integers(0, vocab, (STEPS, B, 1)).astype(np.int32)}


def _scatter(model, c1, lengths, table_seed=3):
    """A prefill cache scattered into ``model``'s pools through a
    permuted block table, its recurrent state copied in."""
    Bc = len(lengths)
    cache = model.init_cache(Bc, MAX_LEN)
    maxp, _ = model.page_geometry(Bc, MAX_LEN)
    table = torch.randperm(Bc * maxp, generator=torch.Generator()
                           .manual_seed(table_seed)).reshape(Bc, maxp).int()
    cache["block_table"] = table
    for (_, pools), (_, kv) in zip(model.attention_caches(cache),
                                   model.attention_caches(c1)):
        pos = torch.arange(kv["k"].shape[2])
        for b in range(Bc):
            page = table[b, pos // PAGE].long()
            pools["k_pages"][:, page, pos % PAGE] = kv["k"][:, b]
            pools["v_pages"][:, page, pos % PAGE] = kv["v"][:, b]
    for (_, _, t, _), (_, _, one, _) in zip(model.state_leaves(cache),
                                            model.state_leaves(c1)):
        t.copy_(one)
    cache["lengths"] = torch.tensor(lengths, dtype=torch.int32)
    return cache


def _to_rank(model, whole, full):
    """``full`` (``whole``'s cache) moved to ``model``'s sequence range."""
    Bc = full["lengths"].shape[0]
    cache = model.init_cache(Bc, MAX_LEN)
    mp = cache["block_table"].shape[1]
    cache["block_table"] = torch.arange(Bc * mp, dtype=torch.int32).reshape(
        Bc, mp)
    lo, hi = cache["seq_range"]
    for (_, mine), (_, src) in zip(model.attention_caches(cache),
                                   whole.attention_caches(full)):
        for k in mine:
            sharding.take_seq_pages(src[k], full["block_table"], mine[k],
                                    cache["block_table"], lo, hi, PAGE)
    for (_, _, t, _), (_, _, one, _) in zip(model.state_leaves(cache),
                                            whole.state_leaves(full)):
        t.copy_(one)
    cache["lengths"] = full["lengths"].clone()
    return cache


def port_decode(name, params_np, inp, group=None, seq_group=None,
                prefill_group=None):
    """Prefill on ``Model(group=prefill_group)`` (the whole model's heads
    without it), scatter its cache, move it to the rank's sequence range
    under ``seq_group``, then ``STEPS`` decode steps with fixed tokens:
    every step's logits (at tp = 1 and whole sequences without groups)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import Model
    cfg = _cfg(get_config, name)
    full_params = params_from_numpy(params_np)
    params = full_params
    if group is not None:
        params = sharding.shard_params(full_params, group.rank, group.size,
                                       cfg=cfg)
    pre_params = params if prefill_group is group else full_params
    whole = Model(cfg, page_size=PAGE, group=prefill_group)
    toks = torch.from_numpy(inp["toks"])
    lens = torch.from_numpy(inp["lengths"])
    with torch.no_grad():
        _, c1 = whole.prefill(pre_params, toks, lengths=lens)
        cache = _scatter(whole, c1, inp["lengths"].tolist())
        model = Model(cfg, page_size=PAGE, group=group, seq_group=seq_group)
        if seq_group is not None:
            cache = _to_rank(model, whole, cache)
        out = []
        for tok in inp["dec"]:
            logits, cache = model.decode(params, cache,
                                         torch.from_numpy(tok))
            out.append(logits.numpy())
    return out


def port_fused_logits(name, params_np, group=None):
    """Fused QKV: a prefill of two rows (16 and 11 tokens), two decode
    steps; the logits of each call."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import Model
    cfg = _cfg(get_config, name)
    params = params_from_numpy(params_np)
    if group is not None:
        params = sharding.shard_params(params, group.rank, group.size,
                                       cfg=cfg)
    model = Model(cfg, page_size=PAGE, group=group, fuse_qkv=True)
    inp = _fused_inputs(cfg.vocab)
    out = []
    with torch.no_grad():
        logits, c1 = model.prefill(params, torch.from_numpy(inp["toks"]),
                                   lengths=torch.from_numpy(inp["lengths"]))
        out.append(logits.numpy())
        cache = _scatter(model, c1, inp["lengths"].tolist())
        for tok in inp["dec"]:
            logits, cache = model.decode(params, cache,
                                         torch.from_numpy(tok))
            out.append(logits.numpy())
    return out


def _fused_inputs(vocab):
    rng = np.random.default_rng(9)
    return {"toks": rng.integers(0, vocab, (2, 16)).astype(np.int32),
            "lengths": np.array([16, 11], np.int32),
            "dec": rng.integers(0, vocab, (2, 2, 1)).astype(np.int32)}


def _combine_case(group, case):
    """Every rank's plain decode with its lse over its key range of one
    whole cache, combined: the whole cache's output and the merged
    result."""
    from repro_torch.launch.collectives import combine_lse
    gen = torch.Generator().manual_seed(case)
    B, H, KV, dh, ps = 4, 6, 2, 16, 4
    S = 64
    maxp = S // ps
    q = torch.randn(B, H, dh, generator=gen)
    kp = torch.randn(B * maxp + 1, ps, KV, dh, generator=gen)
    vp = torch.randn(B * maxp + 1, ps, KV, dh, generator=gen)
    table = torch.randperm(B * maxp, generator=gen).reshape(B, maxp).int()
    # case 0: the keys split over every rank; 1: rows shorter than some
    # ranks' ranges, a window (empty ranges); 2: every row inside rank 0's
    # range (every range but one empty)
    lengths = {0: [64, 60, 33, 50], 1: [5, 20, 40, 1], 2: [16, 3, 9, 12]}[
        case]
    lt = torch.tensor(lengths, dtype=torch.int32)
    window = None if case != 1 else 12
    whole = paged_attention_ref(q, kp, vp, table, lt, page_size=ps,
                                window=window)
    lo, hi = sharding.seq_range(S, group.rank, group.size)
    mp = -(-(hi - lo) // ps)
    mine = torch.arange(B * mp, dtype=torch.int32).reshape(B, mp)
    pk = torch.zeros(1, B * mp + 1, ps, KV, dh)
    pv = torch.zeros(1, B * mp + 1, ps, KV, dh)
    sharding.take_seq_pages(kp[None], table, pk, mine, lo, hi, ps)
    sharding.take_seq_pages(vp[None], table, pv, mine, lo, hi, ps)
    local = torch.clamp(lt - lo, 0, hi - lo).to(torch.int32)
    out, lse = paged_decode_lse_ref(q, pk[0], pv[0], mine, local,
                                    page_size=ps, start=lt - 1 - lo,
                                    window=window)
    return whole.numpy(), combine_lse(out, lse, group).numpy(), \
        int(torch.isinf(lse).all(dim=1).sum())


def _train(grid, job, name):
    """Two AdamW steps of ``name`` with the fused projection on ``grid``:
    per-step metrics, the rank's first moments after step 1 and its
    params after step 2 (numpy, by leaf)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.sharding import shard_batch
    from repro_torch.models import Model
    from repro_torch.train import AdamW, TrainStepConfig, make_train_step
    from repro_torch.train.train_step import rank_state
    from repro_torch.train.tree import leaves
    cfg = _cfg(get_config, name)
    model = Model(cfg, fuse_qkv=True, **grid.model_kw())
    opt = AdamW(lr=LR)
    state = rank_state(model, opt, params_from_numpy(
        job["fused_params"][name]), grid, False)
    step = make_train_step(model, opt, TrainStepConfig(), grid=grid)
    mets, mu = [], None
    for batch in job["batches"][name]:
        mine = shard_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                           grid.dp_rank, grid.dp_size)
        state, met = step(state, mine)
        mets.append({k: float(v) for k, v in met.items()})
        if mu is None:
            mu = [t.detach().clone().numpy() for t in leaves(state.opt.mu)]
    return {"metrics": mets, "mu": mu,
            "params": [t.detach().numpy() for t in leaves(state.params)]}


def _rank(group, job):
    """One rank of the module's spawn of four: the combines, then each
    grid (made over the world in order; the ranks past a grid's size hold
    none of it) and what it runs."""
    from repro_torch.launch.mesh import grid_mesh, grid_on_world
    out = {"rank": group.rank,
           "combine": [_combine_case(group, c) for c in range(3)]}
    grids = {g: grid_on_world(grid_mesh(*g), group.rank, group.device,
                              group.backend) for g in GRIDS}
    out["batch1"] = {}
    for g, name, ctx in BATCH1:
        grid = grids[g]
        if grid is None:
            continue
        gm = grid.model if grid.tp > 1 else None
        out["batch1"][(g, name, ctx)] = port_decode(
            name, job["params"][name], job["batch1"][(name, ctx)], gm,
            grid.seq_group(1), prefill_group=gm)
    out["seq_model"] = {}
    for g, name in SEQ_MODEL:
        grid = grids[g]
        if grid is None:
            continue
        out["seq_model"][(g, name)] = port_decode(
            name, job["params"][name], job["b4"][name], grid.model,
            grid.seq_group(len(SEQ_MODEL_LENS), True))
    out["fused"] = {}
    for tp, name in FUSED_LOGITS:
        grid = grids[(1, tp)]
        if grid is not None:
            out["fused"][(tp, name)] = port_fused_logits(
                name, job["fused_params"][name], grid.model)
    out["train"] = {}
    for name, g in FUSED_TRAIN:
        if grids[g] is not None:
            out["train"][(name, g)] = dict(_train(grids[g], job, name),
                                           coords=grids[g].coords)
    return out


# ------------------------------------------------------ the JAX package's
def _noisy(tree, rng):
    """Zero-init norm scales get noise, so a term that is zero at init
    cannot hide a missing one."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _noisy(v, rng)
        elif "norm" in k:
            out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


_JAX = {}


def _jax_model(name, fuse_qkv=False):
    """The JAX ``Model`` of a variant (reference kernels) and its jitted
    ``init``, ``prefill`` and ``decode``, made once."""
    import jax
    key = (name, fuse_qkv)
    if key not in _JAX:
        from repro.configs import get_config as jget
        from repro.models import Model as JaxModel
        jm = JaxModel(dataclasses.replace(_cfg(jget, name),
                                          kernels="reference"),
                      remat=False, fuse_qkv=fuse_qkv)
        _JAX[key] = (jm, jax.jit(jm.init), jax.jit(jm.prefill),
                     jax.jit(jm.decode))
    return _JAX[key]


def _jax_params(name, fuse_qkv=False):
    import jax
    seed = list(VARIANTS).index(name) + (10 if fuse_qkv else 0)
    return _noisy(jax.tree_util.tree_map(
        np.asarray, _jax_model(name, fuse_qkv)[1](
            jax.random.PRNGKey(seed))), np.random.default_rng(seed + 11))


def _jax_cache(jm, c1, lengths):
    """A JAX prefill cache inside a contiguous ``MAX_LEN`` cache."""
    import jax.numpy as jnp

    def put(big, small, name):
        if isinstance(big, dict):
            return {k: put(big[k], small[k], k) for k in big}
        if name in ("k", "v"):
            return big.at[:, :, :small.shape[2]].set(small)
        return small
    big = jm.init_cache(len(lengths), MAX_LEN)
    out = {k: put(big[k], c1[k], k) for k in big if k != "lengths"}
    out["lengths"] = jnp.asarray(lengths, jnp.int32)
    return out


def _jax_decode(name, params, inp):
    """``port_decode``'s calls on the JAX ``Model`` (contiguous cache)."""
    import jax
    import jax.numpy as jnp
    jm, _, prefill, decode = _jax_model(name)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    _, c1 = prefill(jp, jnp.asarray(inp["toks"]),
                    lengths=jnp.asarray(inp["lengths"]))
    cache = _jax_cache(jm, c1, inp["lengths"])
    out = []
    for tok in inp["dec"]:
        logits, cache = decode(jp, cache, jnp.asarray(tok))
        out.append(np.asarray(logits))
    return out


def _jax_fused_logits(name, params):
    import jax
    import jax.numpy as jnp
    jm, _, prefill, decode = _jax_model(name, fuse_qkv=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    inp = _fused_inputs(jm.cfg.vocab)
    logits, c1 = prefill(jp, jnp.asarray(inp["toks"]),
                         lengths=jnp.asarray(inp["lengths"]))
    out = [np.asarray(logits)]
    cache = _jax_cache(jm, c1, inp["lengths"])
    for tok in inp["dec"]:
        logits, cache = decode(jp, cache, jnp.asarray(tok))
        out.append(np.asarray(logits))
    return out


def _jax_train(name, params, batches):
    """JAX's one-device ``fuse_qkv=True`` step: metrics, first moments
    after step 1, final params."""
    import jax
    import jax.numpy as jnp
    from repro.train import AdamW as JaxAdamW
    from repro.train import TrainStepConfig as JaxStepCfg
    from repro.train import make_train_step as jax_make_step
    from repro.train.train_step import TrainState as JaxTrainState
    jm = _jax_model(name, fuse_qkv=True)[0]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = JaxTrainState(jp, JaxAdamW(lr=LR).init(jp))
    step = jax.jit(jax_make_step(jm, JaxAdamW(lr=LR), JaxStepCfg()))
    mets, mu = [], None
    for b in batches:
        js, met = step(js, {k: jnp.asarray(v) for k, v in b.items()})
        mets.append({k: float(v) for k, v in met.items()})
        if mu is None:
            mu = [np.asarray(x) for x in jax.tree_util.tree_leaves(js.opt.mu)]
    return {"metrics": mets, "mu": mu, "params": [
        np.asarray(x) for x in jax.tree_util.tree_leaves(js.params)]}


@pytest.fixture(scope="module")
def jax_side():
    """Weights, inputs and the JAX package's outputs of every case."""
    pytest.importorskip("jax")
    params = {n: _jax_params(n) for n in ("llama", "gemma", "zamba",
                                          "padded")}
    fused = {n: _jax_params(n, fuse_qkv=True) for n in FUSED}
    vocab = get_config("llama3.1-8b-tiny").vocab
    batch1 = {(n, ctx): _contexts(vocab, n, 1, (ctx,), ctx)
              for n in ("llama", "gemma", "zamba") for ctx in (10, 45)}
    b4 = {n: _contexts(vocab, n, 4, SEQ_MODEL_LENS, 7)
          for _, n in SEQ_MODEL}
    rng = np.random.default_rng(21)
    batches = {n: [{k: rng.integers(0, vocab, (TRAIN_B, TRAIN_S)).astype(
        np.int32) for k in ("inputs", "labels")} for _ in range(TRAIN_STEPS)]
        for n in FUSED}
    return {
        "job": {"params": params, "fused_params": fused, "batch1": batch1,
                "b4": b4, "batches": batches},
        "batch1": {k: _jax_decode(k[0], params[k[0]], v)
                   for k, v in batch1.items()},
        "b4": {n: _jax_decode(n, params[n], v) for n, v in b4.items()},
        "fused": {n: _jax_fused_logits(n, fused[n]) for n in FUSED},
        "train": {n: _jax_train(n, fused[n], batches[n]) for n in FUSED},
    }


@pytest.fixture(scope="module")
def spawn(jax_side):
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(_rank, WORLD, jax_side["job"], device="cpu",
                     timeout_s=600)


# -------------------------------------------------------------- checks
@pytest.mark.parametrize("case", range(3), ids=["split", "empty-ranges",
                                                "one-range"])
def test_combine_lse_equals_whole(spawn, case):
    """Four key ranges' partial decodes merged by ``combine_lse`` equal the
    whole cache's within 1e-6 on every rank, empty ranges (lse -inf)
    weighing nothing."""
    for r in spawn:
        whole, got, n_empty = r["combine"][case]
        np.testing.assert_allclose(got, whole, rtol=1e-6, atol=1e-6)
    assert sum(r["combine"][case][2] for r in spawn) > 0 or case == 0


@pytest.mark.parametrize("g,name,ctx", BATCH1,
                         ids=[f"{g[0]}x{g[1]}-{n}-ctx{c}"
                              for g, n, c in BATCH1])
def test_batch1_decode_over_data_equals_one_process_and_jax(
        spawn, jax_side, g, name, ctx):
    """A batch of one, its cache's sequence over the data ranks (and its
    heads over the model ranks at (2, 2)): every step's logits on every
    rank equal the port's one process and JAX's ``Model.decode`` within
    1e-5, whether ranks start empty (a 10-token context) or the tail
    crosses a rank boundary during the steps (45)."""
    inp = jax_side["job"]["batch1"][(name, ctx)]
    want = port_decode(name, jax_side["job"]["params"][name], inp)
    jwant = jax_side["batch1"][(name, ctx)]
    assert len(want) == len(jwant) == STEPS
    for r in spawn[:g[0] * g[1]]:
        got = r["batch1"][(g, name, ctx)]
        for a, b, c in zip(got, want, jwant):
            np.testing.assert_allclose(a, b, **TOL)
            np.testing.assert_allclose(a, c, **TOL)


@pytest.mark.parametrize("g,name", SEQ_MODEL,
                         ids=[f"{g[0]}x{g[1]}-{n}" for g, n in SEQ_MODEL])
def test_seq_shard_cache_decode_equals_tp1_and_jax(spawn, jax_side, g,
                                                   name):
    """``seq_shard_cache``: B4 over the model ranks (every KV head on every
    rank, the query heads gathered, each rank keeping its own after the
    combine; 5 heads over 3 ranks in the padded layout) equals the port's
    tp = 1 and JAX's within 1e-5."""
    inp = jax_side["job"]["b4"][name]
    want = port_decode(name, jax_side["job"]["params"][name], inp)
    for r in spawn[:g[1]]:
        got = r["seq_model"][(g, name)]
        for a, b, c in zip(got, want, jax_side["b4"][name]):
            np.testing.assert_allclose(a, b, **TOL)
            np.testing.assert_allclose(a, c, **TOL)


@pytest.mark.parametrize("tp,name", FUSED_LOGITS,
                         ids=[f"tp{tp}-{n}" for tp, n in FUSED_LOGITS])
def test_fused_qkv_logits_equal_tp1_and_jax(spawn, jax_side, tp, name):
    """The fused projection at tp (strided shards; the padded config's 5
    heads as 3 / 2 and 2 / 2 / 1 on one shared KV head): prefill and
    decode logits equal the port's tp = 1 and JAX's fused model within
    1e-5."""
    params = jax_side["job"]["fused_params"][name]
    want = port_fused_logits(name, params)
    for r in spawn[:tp]:
        for a, b, c in zip(r["fused"][(tp, name)], want,
                           jax_side["fused"][name]):
            np.testing.assert_allclose(a, b, **TOL)
            np.testing.assert_allclose(a, c, **TOL)


def _gathered(ranks, name, dp, tp, what):
    from repro_torch.models import Model
    from repro_torch.train.tree import leaves, unflatten
    cfg = _cfg(get_config, name)
    template = Model(cfg, fuse_qkv=True).init(torch.Generator(),
                                              device="meta")
    rows = []
    for d in range(dp):
        parts = [unflatten(sharding.shard_params(template, t, tp, cfg=cfg),
                           [torch.from_numpy(a)
                            for a in ranks[d * tp + t][what]])
                 for t in range(tp)]
        rows.append([x.numpy() for x in leaves(
            sharding.gather_params(parts, cfg, tp))])
    return rows


def _assert_params(got, want, want_mu, share):
    """``test_torch_train.py``'s count rule on the params after two steps,
    held on the entries whose reference first moment is 0 or at least
    ``share · lr · steps / atol`` of its leaf's largest (below, Adam's
    step amplifies the gradient's rounding floor); every entry within 2 ·
    lr · steps.  Returns the share of the entries held."""
    scale = share * LR * TRAIN_STEPS / TRAIN_TOL["atol"]
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


@pytest.mark.parametrize("name,g", FUSED_TRAIN,
                         ids=[f"{g[0]}x{g[1]}-{n}" for n, g in FUSED_TRAIN])
def test_fused_qkv_training_matches_jax(spawn, jax_side, name, g):
    """Two AdamW steps with the fused projection on a grid against JAX's
    one-device ``fuse_qkv=True`` step: losses and grad norms within
    TRAIN_TOL, the first moments gathered within rtol 1e-4 and 1e-5 of a
    leaf's largest, every data row's params equal and held by
    ``_assert_params``.  At (2, 2) the padded config's one KV head is read
    by both model ranks: only the fused leaf's K and V columns are summed
    over them."""
    dp, tp = g
    ranks = [r["train"][(name, g)] for r in spawn[:dp * tp]]
    want = jax_side["train"][name]
    for r in ranks:
        for a, b in zip(r["metrics"], want["metrics"]):
            for k in ("loss", "loss_total", "grad_norm", "lr", "tokens"):
                np.testing.assert_allclose(a[k], b[k], **TRAIN_TOL,
                                           err_msg=f"{name} {k}")
    mu = _gathered(ranks, name, dp, tp, "mu")[0]
    for i, (a, b) in enumerate(zip(mu, want["mu"])):
        top = float(np.abs(b).max()) if b.size else 0.0
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * top,
                                   err_msg=f"{name}: moment of leaf {i}")
    rows = _gathered(ranks, name, dp, tp, "params")
    for row in rows[1:]:
        for a, b in zip(row, rows[0]):
            np.testing.assert_array_equal(a, b)
    assert _assert_params(rows[0], want["params"], want["mu"], 1e-5) >= 0.5
