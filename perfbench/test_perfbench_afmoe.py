"""The afmoe family (``reference/afmoe.py``) against the program at a tiny
size on the CPU: a dense local layer, a local MoE layer and a global MoE
layer, prompts longer than the window, prefill, extend and decode through
the paged cache against the reference's full forward; the family's
weights in the program's layout; its FLOP count against the program's
parameter count; a tiny cell served and judged with it; and, on the card,
the fp8 control failing the real cell where the program passes."""
import gc
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from perfbench import cells, harness
from perfbench.conftest import TINY_ENGINE, TINY_LENGTHS
from perfbench.test_perfbench_control import fails
from perfbench.test_perfbench_faults import altered_token
from perfbench.test_perfbench_family import write_pages

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
AFMOE = {"name": "afmoe", "reference": "perfbench/reference/afmoe.py"}
SEED = 2 ** 31 + 3737
WINDOW = 8
#: layer 0 dense and local, 1 MoE and local, 2 MoE and global (2 % 3 == 2)
TINY = {"n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
        "d_head": 16, "d_ff": 96, "vocab": 256, "rope_theta": 10000.0,
        "norm_eps": 1e-5, "mlp_gated": True, "qk_norm": True,
        "sliding_window": WINDOW, "rope_local_only": True,
        "attn_out_gate": True, "sandwich_norm": True,
        "embed_multiplier": 8.0,
        "moe": {"n_experts": 8, "top_k": 2, "d_expert": 32,
                "capacity_factor": 4.0, "n_shared_experts": 1,
                "score_func": "sigmoid", "route_scale": 2.826},
        "stages": [{"kind": "attn_mlp", "n_layers": 1,
                    "local_global_period": 3},
                   {"kind": "attn_moe", "n_layers": 2,
                    "local_global_period": 3}]}
#: the program's float32 logits against the reference's, over the largest:
#: both compute in float32, in other orders (flash and paged attention
#: against blocks of dense softmax, the grouped matmul against one expert
#: at a time), which reads ~1e-7; a wrong window, position or routing
#: reads 1e-2 and more
TOL = 1e-5
#: float32 serving against the float32 reference: a served token lies at
#: most this far below the reference's best (rounding reads ~1e-6)
LIMITS = {"max_logit_gap": 1e-3, "sample_tokens": 400,
          "sample_requests": 40}


def tiny_config(**sizes):
    return {"name": "tiny-afmoe", "arch": "trinity-mini",
            "dtype": "float32", "reference": AFMOE["reference"],
            "sizes": dict(TINY, **sizes)}


def tiny(**sizes):
    fam = cells.family(ROOT, AFMOE)
    config = tiny_config(**sizes)
    cfg = harness.arch_config(config, fam)
    return fam, cfg, harness.sizes_of(config, cfg)


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tuple(tree.shape), tree.dtype


def test_the_configuration_reaches_the_program_as_written():
    fam, cfg, _ = tiny()
    assert cfg.name == "tiny-afmoe" and fam.covers(cfg) is None
    assert [(s.kind, s.n_layers, s.local_global_period)
            for s in cfg.stages] == [("attn_mlp", 1, 3), ("attn_moe", 2, 3)]
    assert (cfg.moe.score_func, cfg.moe.route_scale,
            cfg.moe.n_shared_experts) == ("sigmoid", 2.826, 1)
    assert cfg.rope_local_only and cfg.attn_out_gate and cfg.sandwich_norm
    assert cfg.embed_multiplier == 8.0


@pytest.mark.parametrize("change, word", [
    ({"moe": dict(TINY["moe"], capacity_factor=1.25)}, "dropped"),
    ({"moe": dict(TINY["moe"], score_func="softmax")}, "sigmoid"),
    ({"sandwich_norm": False}, "sandwich"),
    ({"rope_local_only": False}, "RoPE"),
])
def test_what_the_family_does_not_compute_is_refused(change, word):
    fam = cells.family(ROOT, AFMOE)
    with pytest.raises(ValueError, match=word):
        harness.arch_config(tiny_config(**change), fam)


def test_the_decoder_family_refuses_trinity():
    config = json.loads((HERE / "configs" / "trinity-mini.json")
                        .read_text())
    decoder = cells.family(ROOT, {"name": "d", "reference":
                                  "perfbench/reference/decoder.py"})
    with pytest.raises(ValueError, match="trinity-mini"):
        harness.arch_config(config, decoder)
    cfg = harness.arch_config(config, cells.family(ROOT, config))
    assert cfg.param_count() == 26_123_966_208


def test_weights_are_the_programs_layout():
    """Every leaf the program's ``Model.init`` draws, with its shape; the
    norms and the expert bias in float32, the rest in the served type."""
    from repro_torch.models import Model
    fam, cfg, sizes = tiny()
    drawn = fam.make_params(sizes, 7, "cpu", torch.bfloat16)
    init = Model(cfg).init(torch.Generator(), device="meta",
                           dtype=torch.bfloat16)
    got, want = list(leaves(drawn)), list(leaves(init))
    assert [(n, s) for n, s, _ in got] == [(n, s) for n, s, _ in want]
    for n, _, dtype in got:
        f32 = "norm" in n or n.endswith("expert_bias")
        assert dtype == (torch.float32 if f32 else torch.bfloat16), n


def test_model_flops_count_every_weight_a_token_meets():
    """Outside attention, 2 FLOPs a weight a token: the program's active
    parameters less the embedding, the norms and the expert bias (the head
    counted for the logits only), for trinity-mini; attention over the
    window on local layers, every earlier key on global ones."""
    config = json.loads((HERE / "configs" / "trinity-mini.json").read_text())
    fam = cells.family(ROOT, config)
    cfg = harness.arch_config(config, fam)
    sizes = harness.sizes_of(config, cfg)
    d, L, V, E = cfg.d_model, cfg.n_layers, cfg.vocab, cfg.moe.n_experts
    n_moe = cfg.stages[1].n_layers
    weights = cfg.active_param_count() - V * d - 4 * d * L - d - E * n_moe
    head = V * d
    per_key = 4 * cfg.n_heads * cfg.d_head
    # one decode token at 5,000: 24 local layers see 2,048 keys, 8 global
    # layers 5,001
    want = 2.0 * (weights - head) + 2.0 * head \
        + per_key * (24 * 2048 + 8 * 5001)
    assert fam.model_flops(sizes, [(5000, 1, 1)]) == want
    # a first chunk of 2,048 from 0 fits the window: causal everywhere
    pairs = 2048 * 2049 // 2
    want = 2.0 * 2048 * (weights - head) + 2.0 * head + per_key * 32 * pairs
    assert fam.model_flops(sizes, [(0, 2048, 1)]) == want


def serve_steps(model, params, g, lengths, S, max_len, n_new, V):
    """Prefill (flash) of prompts padded to ``S``, one chunk of extend of
    ``n_new`` tokens a row and three decode steps through a shuffled paged
    cache: the program's logits (B, 5, V) and, per row, the sequence and
    the positions that produced them."""
    B = len(lengths)
    lengths = torch.tensor(lengths, dtype=torch.int32)
    tokens = torch.randint(0, V, (B, S), generator=g)
    seqs = [tokens[b, :int(lengths[b])].tolist() for b in range(B)]
    got, want = [], [[int(n) - 1] for n in lengths]
    logits, prefill = model.prefill(params, tokens, lengths=lengths)
    got.append(logits[:, 0, :V])
    cache = model.init_cache(B, max_len)
    maxp, n_pages = model.page_geometry(B, max_len)
    table = torch.randperm(n_pages - 1, generator=g)[:B * maxp] \
        .reshape(B, maxp).to(torch.int32)
    cache["block_table"] = table
    write_pages(cache, prefill, table, model.page_size, S)
    cache["lengths"] = lengths.clone()
    chunk = torch.randint(0, V, (B, max(n_new)), generator=g)
    logits, cache = model.extend(params, cache, chunk,
                                 torch.tensor(n_new, dtype=torch.int32))
    got.append(logits[:, 0, :V])
    for b in range(B):
        seqs[b] += chunk[b, :n_new[b]].tolist()
        want[b].append(len(seqs[b]) - 1)
    for _ in range(3):
        step = torch.randint(0, V, (B, 1), generator=g)
        logits, cache = model.decode(params, cache, step)
        got.append(logits[:, 0, :V])
        for b in range(B):
            seqs[b].append(int(step[b, 0]))
            want[b].append(len(seqs[b]) - 1)
    return torch.stack(got, dim=1), seqs, want


def test_program_matches_the_reference():
    """Prefill (flash), a chunk of extend and three decode steps through
    the paged cache, past the window, against the reference's full
    forward at every position they produce.  The expert bias is drawn
    large here, so that it moves selections: the reference without it
    differs, as it does without the window."""
    from repro_torch.models import Model
    fam, cfg, sizes = tiny()
    params = fam.make_params(sizes, SEED, "cpu", torch.float32)
    g = torch.Generator().manual_seed(3)
    params["stage1"]["moe"]["expert_bias"] = torch.randn(
        (2, 8), generator=g) * 0.2
    model = Model(cfg, page_size=8)
    with torch.no_grad():
        program, seqs, want = serve_steps(model, params, g, [13, 20], 24,
                                          64, [6, 4], cfg.vocab)
        ref = fam.logits_at(params, sizes, seqs, want)
        wide = fam.logits_at(params, dict(sizes, sliding_window=10 ** 6),
                             seqs, want)
        unbiased = {**params, "stage1": {**params["stage1"], "moe": {
            **params["stage1"]["moe"],
            "expert_bias": torch.zeros((2, 8))}}}
        plain = fam.logits_at(unbiased, sizes, seqs, want)
    for b in range(2):
        scale = ref[b].abs().max()
        assert (program[b] - ref[b]).abs().max() <= TOL * scale
        assert (program[b] - wide[b]).abs().max() > 1e-3 * scale
        assert (program[b] - plain[b]).abs().max() > 1e-3 * scale


def test_program_matches_the_reference_at_the_cells_window():
    """The cell's window (2,048) and pages (16) at tiny widths: a prompt
    past the window, extends that cross it, and decode steps whose first
    visible key sits mid-page (row 0) and on either side of a page's
    start (row 1: keys from 15, 16 and 17), against the reference.  A
    window one page wider or narrower reads far outside the tolerance."""
    from repro_torch.models import Model
    W, page = 2048, 16
    fam, cfg, sizes = tiny(sliding_window=W)
    params = fam.make_params(sizes, SEED, "cpu", torch.float32)
    g = torch.Generator().manual_seed(5)
    model = Model(cfg, page_size=page)
    with torch.no_grad():
        program, seqs, want = serve_steps(model, params, g, [2060, 1990],
                                          2060, 2112, [40, 72], cfg.vocab)
        assert [w[2:] for w in want] == [[2100, 2101, 2102],
                                         [2062, 2063, 2064]]
        ref = fam.logits_at(params, sizes, seqs, want)
        shifted = [fam.logits_at(params, dict(sizes, sliding_window=w),
                                 seqs, want) for w in (W - page, W + page)]
    for b in range(2):
        scale = ref[b].abs().max()
        assert (program[b] - ref[b]).abs().max() <= TOL * scale
        for other in shifted:
            # the prefill of row 1 (1,990 tokens) sees no window
            assert (program[b, 1:] - other[b][1:]).abs().amax(-1).min() \
                > 10 * TOL * scale


def test_fp8_control_moves_every_projection():
    """The control's logits differ from the float32 reference's, and the
    reference repeats itself bit for bit."""
    fam, _, sizes = tiny()
    params = fam.make_params(sizes, SEED, "cpu", torch.float32)
    seqs, want = [list(range(5, 40))], [list(range(10, 35))]
    a = fam.logits_at(params, sizes, seqs, want)[0]
    b = fam.logits_at(params, sizes, seqs, want)[0]
    low = fam.logits_at(params, sizes, seqs, want, quantize="fp8")[0]
    assert torch.equal(a, b)
    assert (low - a).abs().max() > 1e-3 * a.abs().max()


@pytest.fixture
def afmoe_tree(tmp_path):
    """A copy of the benchmark's tree with a tiny afmoe cell added as
    files and entries alone."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    perf = tmp_path / "perfbench"
    (perf / "configs" / "tiny-afmoe.json").write_text(
        json.dumps(tiny_config()))
    (perf / "traffic" / "tiny-afmoe.json").write_text(json.dumps({
        "engine": TINY_ENGINE, **TINY_LENGTHS,
        "arrival": {"process": "backlog"}, "block": 8, "warm_s": 0.2}))
    (perf / "limits" / "afmoe.backlog.json").write_text(json.dumps(LIMITS))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-afmoe", "source": "tiny",
                             "file": "perfbench/configs/tiny-afmoe.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "afmoe.backlog",
                               "config": "tiny-afmoe",
                               "traffic": "tiny-afmoe", "chips": 1,
                               "why": "tiny"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_tiny_cell_is_served_and_judged_with_the_family(afmoe_tree,
                                                        monkeypatch):
    """The harness serves the tiny afmoe cell through the program's normal
    path and judges it with the family: correct; not correct with a token
    altered where it is produced."""
    cell = cells.load(afmoe_tree, "afmoe.backlog")
    assert cell.family.__file__ == str(afmoe_tree / "perfbench" /
                                       "reference" / "afmoe.py")
    out = harness.serve_cell(cell, SEED, 1.0, False, "cpu",
                             time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    altered_token(monkeypatch)
    out = harness.serve_cell(cell, SEED, 1.0, False, "cpu",
                             time.perf_counter())
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
def test_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its own size")
    from perfbench.calibrate import readings
    cell = cells.load(ROOT, "trinity-mini.mixed-batch")
    for seed in (11, 12, 13):
        r = readings(cell, seed, 8.0, "cuda")
        assert not fails(cell.limits, r["program"]), seed
        assert fails(cell.limits, r["control"]), seed
        del r
        gc.collect()
        torch.cuda.empty_cache()

