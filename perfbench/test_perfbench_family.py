"""A configuration's family (``reference/``): the decoder family draws,
computes and counts what it did before it became one, bit for bit; a
configuration its family does not cover is refused with the family's
reason; and a family with QK norm and a local:global window is added as
files alone, in a copy of the benchmark's tree, where the program's
prefill, extend and decode through the paged cache agree with its
reference and the comparison decides ``correct`` with it."""
import dataclasses
import hashlib
import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from perfbench import cells, counts, harness
from perfbench.conftest import TINY_ENGINE, TINY_LENGTHS, TINY_SIZES
from perfbench.test_perfbench_faults import altered_token

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DECODER = {"name": "decoder", "reference": "perfbench/reference/decoder.py"}

# --------------------------------------------------------------------------
# the decoder family against the values recorded before it became one
# --------------------------------------------------------------------------

#: sha256 of every leaf of the draws (``digest``), by config, dtype, seed
PARAMS = {
    "tiny-dense/float32/7":
        "d618f042bd676cabb74210bbde80e869151ae246dd071a1f01ef34a7409d73e4",
    "tiny-dense/float32/8589934597":
        "80fc03bb2157101fad871e312b8fb2bf0904f8301a928e722806513452fb87db",
    "tiny-dense/bfloat16/7":
        "1484e7b69d5ebc61af1c864411d49a7e1eb9e0546fa823ef66be7e39a79fa92b",
    "tiny-dense/bfloat16/8589934597":
        "a30ee1d4391ef507ce38cf10d4af23e5c7af4be60fc05f9ab5f2717b8585c2fb",
    "tiny-moe/float32/7":
        "a4ce341eae4e8caedbad7a90eba2231bd01b08c3337da55feec4c503a6b7f1d8",
    "tiny-moe/float32/8589934597":
        "df803ee9cecda66ec873870072541fa3d5c2c0b4e6667a4b8e2560d2ac7467a5",
    "tiny-moe/bfloat16/7":
        "02b4f750f7bdfd43458b3835db3b1fec53b8e6f70dea9c529e628a7bd7d687d6",
    "tiny-moe/bfloat16/8589934597":
        "ea27a82a2eea33b0b020fe32755d89b9e7b6384e95b3f6b4765cfb6b1008d913",
}
#: sha256 of the reference's logits at the test's positions, float32 and fp8
LOGITS = {
    "tiny-dense/None":
        "85b43ac00012bfdd4cc09b9d38f13e049d964b2ce894bdcc0b1b8765b04fe88e",
    "tiny-dense/fp8":
        "f7a574a6c067f5b4f4f588b0c98b00cffd4ddf385c8df128515c078708839c4c",
    "tiny-moe/None":
        "f31543acc781299f52d48acf5f7c10936f21c247e9c6f699d51e84746d09c812",
    "tiny-moe/fp8":
        "cca2da31b5f0f9ef0c13ae872477ae892c8863452503ee66f1d084cf6a332265",
}
CHUNKS = [(0, 37, 1), (37, 16, 1), (53, 1, 1), (2047, 1, 1), (0, 2048, 1)]
STARCODER = {"n_layers": 32, "d_model": 4608, "n_heads": 36,
             "n_kv_heads": 4, "d_head": 128, "d_ff": 18432, "vocab": 49152,
             "mlp_gated": False}
FLOPS = {"tiny-dense": (CHUNKS, 1317427712.0),
         "tiny-moe": (CHUNKS, 1285125632.0),
         "starcoder2-7b": ([(0, 2048, 1), (2048, 1791, 1), (3838, 1, 1),
                            (100, 1, 1)], 57709043122176.0)}
#: the window-less counts: (function, arguments, (FLOPs, bytes))
COUNTS = {
    "flash": (counts.flash_prefill, ([37, 1, 2048], 36, 4, 128),
              (38686556160, 42721292)),
    "flash4": (counts.flash_prefill, ([5, 300], 4, 2, 16, 4),
               (11562240, 234248)),
    "extend": (counts.paged_extend,
               ([0, 293, 2048], [256, 256, 1791], 36, 4, 128, 64),
               (99781705728, 51960124)),
    "extend4": (counts.paged_extend, ([3, 17], [2, 30], 4, 2, 16, 16, 4),
                (251904, 29728)),
    "decode": (counts.paged_decode, ([1, 64, 65, 3839], 36, 4, 128, 64),
               (73156608, 8202512)),
    "decode4": (counts.paged_decode, ([5, 17], 4, 2, 16, 16, 4),
                (5632, 6676)),
}


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def digest(tensors) -> str:
    h = hashlib.sha256()
    for name, t in tensors:
        t = t.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def tiny(name):
    arch, sizes = TINY_SIZES[name]
    config = {"name": name, "arch": arch, "dtype": "float32",
              "sizes": sizes}
    fam = cells.family(ROOT, DECODER)
    return fam, harness.sizes_of(config, harness.arch_config(config, fam))


@pytest.mark.parametrize("case", sorted(PARAMS))
def test_weight_draws_equal_the_parents(case):
    name, dtype, seed = case.split("/")
    fam, sizes = tiny(name)
    params = fam.make_params(sizes, int(seed), "cpu", getattr(torch, dtype))
    assert digest(leaves(params)) == PARAMS[case]


@pytest.mark.parametrize("case", sorted(LOGITS))
def test_reference_logits_equal_the_parents(case):
    name, quantize = case.split("/")
    fam, sizes = tiny(name)
    params = fam.make_params(sizes, 2 ** 31 + 99, "cpu", torch.float32)
    g = torch.Generator().manual_seed(5)
    seqs = [torch.randint(0, sizes["vocab"], (n,), generator=g).tolist()
            for n in (37, 9, 64)]
    want = [range(0, 37, 3), [0, 8], range(40, 64)]
    out = fam.logits_at(params, sizes, seqs, want,
                        quantize=None if quantize == "None" else quantize)
    assert digest((str(i), t) for i, t in enumerate(out)) == LOGITS[case]


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_model_flops_equal_the_parents(name):
    chunks, want = FLOPS[name]
    sizes = STARCODER if name == "starcoder2-7b" else tiny(name)[1]
    assert cells.family(ROOT, DECODER).model_flops(sizes, chunks) == want


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_windowless_counts_equal_the_parents(name):
    fn, args, want = COUNTS[name]
    assert fn(*args) == want
    assert fn(*args, window=None) == want
    assert fn(*args, window=2 ** 30) == want


# --------------------------------------------------------------------------
# what the harness refuses
# --------------------------------------------------------------------------

def starcoder(**sizes):
    config = json.loads((HERE / "configs" / "starcoder2-7b.json").read_text())
    config["sizes"].update(sizes)
    return config, cells.family(ROOT, config)


def test_a_window_the_family_lacks_is_refused_with_its_reason():
    config, fam = starcoder(sliding_window=4096)
    cfg = dataclasses.replace(harness.arch_config(*starcoder()),
                              sliding_window=4096)
    reason = fam.covers(cfg)
    assert reason and "window" in reason
    with pytest.raises(ValueError, match=re.escape(f"starcoder2-7b: "
                                                   f"{reason}")):
        harness.arch_config(config, fam)


def test_leading_dense_layers_and_shared_experts_reach_the_family():
    """Two stages and a shared expert become the program's ``ArchConfig``
    as the file states them; the decoder family refuses them."""
    config, fam = starcoder(
        n_layers=5, mlp_gated=True,
        moe={"n_experts": 8, "top_k": 2, "d_expert": 64,
             "n_shared_experts": 1},
        stages=[{"kind": "attn_mlp", "n_layers": 2},
                {"kind": "attn_moe", "n_layers": 3}])
    seen = []

    class Recorder:
        @staticmethod
        def covers(cfg):
            seen.append(cfg)
            return fam.covers(cfg)

    with pytest.raises(ValueError, match="one stage .* shared expert"):
        harness.arch_config(config, Recorder)
    cfg = seen[0]
    assert [(s.kind, s.n_layers) for s in cfg.stages] == \
        [("attn_mlp", 2), ("attn_moe", 3)]
    assert cfg.moe.n_shared_experts == 1 and cfg.moe.capacity_factor == 1.25


@pytest.mark.parametrize("sizes, named", [
    ({"n_layer": 2}, "n_layer"),
    ({"moe": {"n_experts": 4, "top_k": 2, "d_expert": 8,
              "score_fn": "sigmoid"}}, "score_fn"),
    ({"stages": [{"kind": "attn_mlp", "n_layers": 32, "period": 2}]},
     "period"),
    ({"name": "other"}, "name"),
])
def test_an_unknown_key_is_refused_by_name(sizes, named):
    config, fam = starcoder(**sizes)
    with pytest.raises(ValueError, match=named):
        harness.arch_config(config, fam)


def test_stages_that_miss_n_layers_are_refused():
    config, fam = starcoder(stages=[{"kind": "attn_mlp", "n_layers": 30}])
    with pytest.raises(ValueError, match="add up"):
        harness.arch_config(config, fam)


def test_a_configuration_without_a_family_is_refused():
    with pytest.raises(ValueError, match="perfbench/reference"):
        cells.family(ROOT, {"name": "x", "reference": "perfbench/check.py"})
    with pytest.raises(ValueError, match="perfbench/reference"):
        cells.family(ROOT, {"name": "x"})


# --------------------------------------------------------------------------
# a family added as files alone
# --------------------------------------------------------------------------

#: the family module the test adds: QK norm, a SwiGLU MLP and a
#: local:global window, in any number of attention + MLP stages
FAMILY = '''"""Attention with QK norm and a local:global sliding window, then a
SwiGLU MLP, in stages of attention + MLP layers (the program's gemma3
layout)."""
import torch
import torch.nn.functional as F

from perfbench import counts
from perfbench.reference.decoder import (Linear, causal_attention,
                                         no_tf32, rmsnorm, rope, rope_tables)
from perfbench.weights import dense, norm


def windows(sizes):
    """Each stage's layers' windows: None on a global layer."""
    out = []
    for st in sizes["stages"]:
        P = st.get("local_global_period", 0)
        out.append([sizes["sliding_window"] if P and li % P != P - 1
                    else None for li in range(st["n_layers"])])
    return out


def covers(cfg):
    if (cfg.moe is not None or not cfg.mlp_gated or not cfg.qk_norm
            or cfg.qkv_bias or cfg.tie_embeddings or cfg.n_codebooks
            or not cfg.embed_inputs
            or any(st.kind != "attn_mlp" for st in cfg.stages)):
        return "this family covers QK-norm attention + SwiGLU MLP stages"
    return None


def make_params(sizes, seed, device, dtype=torch.bfloat16):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    d, H, KV, dh = (sizes[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                       "d_head"))
    ff, Vp = sizes["d_ff"], sizes["padded_vocab"]
    params = {"embed": {"tok": torch.randn((Vp, d), generator=gen,
                                           dtype=dtype, device=device)}}
    for i, st in enumerate(sizes["stages"]):
        L = st["n_layers"]
        params[f"stage{i}"] = {
            "norm1": norm(gen, (L, d), device),
            "attn": {"wq": dense(gen, (L, d, H * dh), dtype, device),
                     "wk": dense(gen, (L, d, KV * dh), dtype, device),
                     "wv": dense(gen, (L, d, KV * dh), dtype, device),
                     "wo": dense(gen, (L, H * dh, d), dtype, device),
                     "q_norm": norm(gen, (L, dh), device),
                     "k_norm": norm(gen, (L, dh), device)},
            "norm2": norm(gen, (L, d), device),
            "mlp": {"w_gate": dense(gen, (L, d, ff), dtype, device),
                    "w_up": dense(gen, (L, d, ff), dtype, device),
                    "w_down": dense(gen, (L, ff, d), dtype, device)}}
    params["final_norm"] = norm(gen, (d,), device)
    params["head"] = {"w": dense(gen, (d, Vp), dtype, device)}
    return params


def logits_at(params, sizes, seqs, want, *, quantize=None, device=None):
    dev = torch.device(device) if device is not None else \\
        params["final_norm"].device
    no_tf32(dev)
    lin = Linear(quantize)
    H, KV, dh = sizes["n_heads"], sizes["n_kv_heads"], sizes["d_head"]
    eps = sizes["norm_eps"]
    xs = [params["embed"]["tok"][torch.as_tensor(list(s), device=dev)]
          .float() for s in seqs]
    cos, sin = rope_tables(max(len(s) for s in seqs), dh,
                           float(sizes["rope_theta"]), dev)
    for i, wins in enumerate(windows(sizes)):
        st = params[f"stage{i}"]
        a, m = st["attn"], st["mlp"]
        for li, window in enumerate(wins):
            wq, wk, wv, wo = (lin.weight(a[n][li])
                              for n in ("wq", "wk", "wv", "wo"))
            wg, wu, wd = (lin.weight(m[n][li])
                          for n in ("w_gate", "w_up", "w_down"))
            for j, x in enumerate(xs):
                S = x.shape[0]
                h = rmsnorm(x, st["norm1"][li], eps)
                q = rmsnorm(lin(h, wq).view(S, H, dh), a["q_norm"][li], eps)
                k = rmsnorm(lin(h, wk).view(S, KV, dh), a["k_norm"][li], eps)
                v = lin(h, wv).view(S, KV, dh)
                att = causal_attention(rope(q, cos, sin), rope(k, cos, sin),
                                       v, window=window)
                x = x + lin(att, wo)
                h = rmsnorm(x, st["norm2"][li], eps)
                xs[j] = x + lin(F.silu(lin(h, wg)) * lin(h, wu), wd)
    head = params["head"]["w"][:, :sizes["vocab"]].float()
    return [rmsnorm(x[torch.as_tensor(list(p), device=dev)],
                    params["final_norm"], eps) @ head
            for x, p in zip(xs, want)]


def model_flops(sizes, chunks):
    d, H, KV, dh = (sizes[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                       "d_head"))
    layer = d * (H + 2 * KV) * dh + H * dh * d + 3 * d * sizes["d_ff"]
    total = 0.0
    for start, n, logits in chunks:
        for wins in windows(sizes):
            for window in wins:
                total += 2.0 * n * layer + 4.0 * H * dh \\
                    * counts.window_pairs(start, n, window)
        total += 2.0 * logits * d * sizes["vocab"]
    return total
'''

WINDOW = 8
QKW_SIZES = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
             "d_head": 16, "d_ff": 128, "vocab": 256, "rope_theta": 10000.0,
             "norm_eps": 1e-6, "mlp_gated": True, "qk_norm": True,
             "sliding_window": WINDOW,
             "stages": [{"kind": "attn_mlp", "n_layers": 2,
                         "local_global_period": 2}]}
#: float32 serving against the float32 reference: a served token lies at
#: most this far below the reference's best (rounding reads ~1e-6)
QKW_LIMITS = {"max_logit_gap": 1e-3, "sample_tokens": 400,
              "sample_requests": 40}
#: the program's logits against the family's, over the largest
TOL = 1e-5
SEED = 2 ** 31 + 4242


def snapshot(tree: Path) -> dict:
    """Size, modification time and bytes of every file under ``tree`` but
    the interpreter's ``__pycache__``."""
    return {p.relative_to(tree): (p.stat().st_size, p.stat().st_mtime_ns,
                                  hashlib.sha256(p.read_bytes()).digest())
            for p in sorted(tree.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def family_tree(tmp_path):
    """A copy of the benchmark's tree with a family, a configuration, a
    mix and a cell's limits added as files and entries alone."""
    before = snapshot(HERE)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    perf = tmp_path / "perfbench"
    (perf / "reference" / "qk_window.py").write_text(FAMILY)
    (perf / "configs" / "tiny-qk-window.json").write_text(json.dumps({
        "name": "tiny-qk-window", "arch": "gemma3-27b", "dtype": "float32",
        "reference": "perfbench/reference/qk_window.py",
        "sizes": QKW_SIZES}))
    (perf / "traffic" / "tiny-qkw.json").write_text(json.dumps({
        "engine": TINY_ENGINE, **TINY_LENGTHS,
        "arrival": {"process": "stratified", "rate": 20.0}, "block": 8,
        "warm_s": 0.2}))
    (perf / "limits" / "qkw.open.json").write_text(json.dumps(QKW_LIMITS))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-qk-window", "source": "tiny",
                             "file": "perfbench/configs/tiny-qk-window.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "qkw.open",
                               "config": "tiny-qk-window",
                               "traffic": "tiny-qkw", "chips": 1,
                               "why": "tiny"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    yield tmp_path
    assert snapshot(HERE) == before, "a file of perfbench/ was written"


def write_pages(cache, prefill, table, page_size, S):
    """Scatter a prefill's contiguous K/V through the block table."""
    pos = torch.arange(S)
    for key, stage in cache.items():
        if not key.startswith("stage"):
            continue
        for b in range(table.shape[0]):
            page = table[b, pos // page_size].long()
            stage["k_pages"][:, page, pos % page_size] = \
                prefill[key]["k"][:, b]
            stage["v_pages"][:, page, pos % page_size] = \
                prefill[key]["v"][:, b]


def test_family_added_as_files_matches_the_program(family_tree):
    """Prefill (flash), a chunk of extend and three decode steps through
    the paged cache, the windowed layer's window crossed, against the
    family's reference at every position they produce."""
    from repro_torch.models import Model
    cell = cells.load(family_tree, "qkw.open")
    assert cell.family.__file__ == str(family_tree / "perfbench" /
                                       "reference" / "qk_window.py")
    cfg = harness.arch_config(cell.config, cell.family)
    assert cfg.qk_norm and cfg.sliding_window == WINDOW
    assert cfg.stages[0].local_global_period == 2
    sizes = harness.sizes_of(cell.config, cfg)
    params = cell.family.make_params(sizes, SEED, "cpu", torch.float32)
    model = Model(cfg, page_size=8)
    g = torch.Generator().manual_seed(3)
    B, S, max_len, V = 2, 24, 64, cfg.vocab
    lengths = torch.tensor([13, 20], dtype=torch.int32)
    tokens = torch.randint(0, V, (B, S), generator=g)
    seqs = [tokens[b, :int(lengths[b])].tolist() for b in range(B)]
    got, want = [], [[int(n) - 1] for n in lengths]
    with torch.no_grad():
        logits, prefill = model.prefill(params, tokens, lengths=lengths)
        got.append(logits[:, 0, :V])
        cache = model.init_cache(B, max_len)
        maxp, n_pages = model.page_geometry(B, max_len)
        table = torch.randperm(n_pages - 1, generator=g)[:B * maxp] \
            .reshape(B, maxp).to(torch.int32)
        cache["block_table"] = table
        write_pages(cache, prefill, table, model.page_size, S)
        cache["lengths"] = lengths.clone()
        chunk = torch.randint(0, V, (B, 6), generator=g)
        n_new = torch.tensor([6, 4], dtype=torch.int32)
        logits, cache = model.extend(params, cache, chunk, n_new)
        got.append(logits[:, 0, :V])
        for b in range(B):
            seqs[b] += chunk[b, :int(n_new[b])].tolist()
            want[b].append(len(seqs[b]) - 1)
        for _ in range(3):
            step = torch.randint(0, V, (B, 1), generator=g)
            logits, cache = model.decode(params, cache, step)
            got.append(logits[:, 0, :V])
            for b in range(B):
                seqs[b].append(int(step[b, 0]))
                want[b].append(len(seqs[b]) - 1)
        ref = cell.family.logits_at(params, sizes, seqs, want)
        # the same layers with no window: the window is what they share
        wide = cell.family.logits_at(
            params, dict(sizes, sliding_window=10 ** 6), seqs, want)
    program = torch.stack(got, dim=1)            # (B, positions, V)
    for b in range(B):
        scale = ref[b].abs().max()
        assert (program[b] - ref[b]).abs().max() <= TOL * scale
        assert (program[b] - wide[b]).abs().max() > 1e-3 * scale


def test_family_added_as_files_decides_correct(family_tree, monkeypatch):
    """The harness serves the new cell and judges it with the new family:
    correct, and not correct with a token altered where it is produced."""
    cell = cells.load(family_tree, "qkw.open")
    out = harness.serve_cell(cell, SEED, 1.0, False, "cpu",
                             time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["max_logit_gap"]["value"] <= QKW_LIMITS[
        "max_logit_gap"]
    altered_token(monkeypatch)
    out = harness.serve_cell(cell, SEED, 1.0, False, "cpu",
                             time.perf_counter())
    assert not out["correct"], out["checks"]
    assert out["checks"]["max_logit_gap"]["value"] > QKW_LIMITS[
        "max_logit_gap"]
