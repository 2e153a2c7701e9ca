"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``launch/specs.py``, ``roofline/``) against the JAX package's, on the CPU.

* The meta param and AdamW-state trees equal ``jax.eval_shape``'s for every
  assigned arch at full width and every tiny config (keys, shapes, dtypes).
* ``model_flops`` equals the JAX function on every cell.
* The counter's FLOPs over a CPU run (the aten ops outside the kernel
  wrappers plus the plain versions that run inside them) equal the JAX
  HLO analyzer's: exactly for prefill and decode, and for a train step
  with remat (see ``test_counter_matches_hlo_train``).
* Outside the kernel calls, a meta run counts what a CPU run counts, FLOPs
  and bytes; the kernels' charges are their work-count functions.
* The counter's own cases by hand, the trip-count scope against the full
  sLSTM loop, the collectives at tp = 2, the plain attentions and
  ``Model(attn_impl=...)`` against JAX, the CLI, and the JAX report
  reading the port's records.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.configs import (ALL_SHAPES, ASSIGNED, ShapeCfg,  # noqa: E402
                                 get_config, get_shape)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import CountingGroup  # noqa: E402
from repro_torch.launch.sharding import shard_params  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.roofline import Counter, analysis  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = [a + "-tiny" for a in ASSIGNED]


# ---------------------------------------------------------------- specs
def _port_tree(tree, path=()):
    """{path: (shape, dtype name)} of a nested dict / NamedTuple tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_tree(v, path + (str(k),)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_port_tree(getattr(tree, k), path + (k,)))
        return out
    return {"/".join(path): (tuple(tree.shape),
                             str(tree.dtype).replace("torch.", ""))}


def _jax_tree(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _jax_params(arch):
    from repro.models import Model as JaxModel
    jm = JaxModel(jax_get_config(arch))
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", list(ASSIGNED) + TINY)
def test_params_specs_match_jax(arch):
    got = specs.params_specs(Model(get_config(arch)))
    assert all(t.device.type == "meta" for t in _leaves(got))
    assert _port_tree(got) == _jax_tree(_jax_params(arch))


@pytest.mark.parametrize("arch", list(ASSIGNED) + TINY)
def test_state_specs_match_jax(arch):
    from repro.train.optimizer import AdamW as JaxAdamW
    got = specs.state_specs(Model(get_config(arch)), AdamW())
    assert all(t.device.type == "meta" for t in _leaves(got))
    params = _jax_params(arch)
    want = {"params": _jax_tree(params),
            "opt": _jax_tree(jax.eval_shape(JaxAdamW().init, params))}
    tree = _port_tree(got)
    for part, w in want.items():
        have = {k[len(part) + 1:]: v for k, v in tree.items()
                if k.startswith(part + "/")}
        assert have == w, part


def _leaves(tree):
    from repro_torch.train.tree import leaves
    return leaves(tree)


def test_input_specs_shapes():
    """Batch, prefill tokens, decode tokens (ids or bf16 embeddings) and
    the paged cache, all on meta, shaped as the JAX specs."""
    from repro.launch import specs as jspecs
    for arch in ("llama3.1-8b", "musicgen-large"):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for shape in ALL_SHAPES:
            pairs = [(specs.train_batch_specs(cfg, shape),
                      jspecs.train_batch_specs(jcfg, shape)),
                     (specs.prefill_specs(cfg, shape),
                      jspecs.prefill_specs(jcfg, shape)),
                     (specs.decode_token_specs(cfg, shape),
                      jspecs.decode_token_specs(jcfg, shape))]
            for got, want in pairs:
                assert _port_tree({"x": got}) == _jax_tree({"x": want})
    m = Model(get_config("llama3.1-8b"))
    cache = specs.cache_specs(m, get_shape("decode_32k"))
    maxp, n_pages = m.page_geometry(128, 32768)
    assert cache["block_table"].shape == (128, maxp)
    assert cache["stage0"]["k_pages"].shape == (32, n_pages, 64, 8, 128)
    assert cache["stage0"]["k_pages"].device.type == "meta"


@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_match_jax(arch):
    from repro.configs import get_shape as jax_get_shape
    from repro.roofline.analysis import model_flops as jax_model_flops
    for shape in ALL_SHAPES:
        assert analysis.model_flops(get_config(arch), shape) == \
            jax_model_flops(jax_get_config(arch), jax_get_shape(shape.name))


def test_roofline_terms_and_h100_constants():
    r = analysis.Roofline(flops=989e12, hbm_bytes=6.7e12,
                          coll_bytes={"all-reduce": 100}, n_devices=2,
                          coll_moved=900e9)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 2.0, 2.0)
    assert r.bottleneck == "memory"
    assert set(r.summary()) == {
        "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
        "flops_per_device", "hbm_bytes_per_device", "collective_bytes"}
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    assert analysis.Roofline(1e12, 0, {}, 1, hw="tpu-v5e").t_compute == \
        pytest.approx(1e12 / 197e12)
    assert analysis.ring_factor("all-gather", 4) == 0.75
    assert analysis.ring_factor("all-reduce", 4) == 1.5
    assert analysis.ring_factor("all-to-all", 2) == 0.5


# ------------------------------------------------------- counter by hand
def test_counter_matmul_view_and_in_place_by_hand():
    a = torch.randn(8, 16)
    b = torch.randn(16, 4)
    with Counter() as c:
        c.arguments(a, b)
        y = a @ b
        assert (c.flops, c.hbm_bytes) == (2 * 8 * 16 * 4,
                                          4 * (8 * 16 + 16 * 4 + 8 * 4))
        assert c.live == 4 * (8 * 16 + 16 * 4 + 8 * 4)
        before = (c.flops, c.hbm_bytes, c.live)
        v = y.view(4, 8).t()
        assert (c.flops, c.hbm_bytes, c.live) == before     # views: 0
        y.add_(1.0)                     # reads and writes y, no new storage
        assert c.hbm_bytes == before[1] + 2 * 4 * 8 * 4
        assert c.live == before[2]
        mem = c.memory((y, v))
    assert mem["argument_size_in_bytes"] == 4 * (8 * 16 + 16 * 4)
    assert mem["output_size_in_bytes"] == 4 * 8 * 4
    assert mem["alias_size_in_bytes"] == 0
    assert mem["temp_size_in_bytes"] == 4 * 8 * 4


def test_counter_alias_and_free():
    """An in-place update of an argument aliases it; a temporary freed
    inside the step counts toward the peak only."""
    p = torch.zeros(1000)
    with Counter() as c:
        c.arguments(p)
        t = p * 2.0                      # 4000 bytes, freed below
        p.add_(t)
        del t
        mem = c.memory(p)
    assert mem == {"argument_size_in_bytes": 4000,
                   "output_size_in_bytes": 4000,
                   "temp_size_in_bytes": 4000,
                   "alias_size_in_bytes": 4000, "peak_bytes": 8000}


# ------------------------------------------------- against the analyzer
def _jax_flops(fn, *args):
    from repro.roofline.hlo_analyzer import HloAnalyzer
    compiled = jax.jit(fn).lower(*args).compile()
    return HloAnalyzer(compiled.as_text()).analyze().flops


def _cpu_flops(counter):
    """The CPU run's FLOPs: outside the wrappers and the plain versions
    that ran inside them (the kernels' own charges are not aten ops)."""
    return counter.flops + sum(k.plain_flops
                               for k in counter.kernels.values())


def _models(arch):
    from repro.models import Model as JaxModel
    jm = JaxModel(jax_get_config(arch), remat=False)
    jparams = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    tm = Model(get_config(arch), remat=False)
    return jm, jparams, tm, tm.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ["llama3.1-8b-tiny",
                                  "granite-moe-1b-a400m-tiny"])
def test_counter_matches_hlo_prefill(arch):
    """B4 S64 prefill, as ``tests/test_integration.py``'s dry-run smoke:
    the same FLOPs to the unit."""
    jm, jparams, tm, params = _models(arch)
    want = _jax_flops(jm.prefill, jparams,
                      jax.ShapeDtypeStruct((4, 64), jnp.int32))
    toks = torch.zeros((4, 64), dtype=torch.int32)
    c, _, _ = dryrun.count_step(tm, "prefill",
                                {"params": params, "tokens": toks})
    assert _cpu_flops(c) == want
    assert c.kernels["flash_attention"].launches == \
        sum(st.n_layers for st in get_config(arch).stages)


@pytest.mark.parametrize("arch", ["llama3.1-8b-tiny",
                                  "granite-moe-1b-a400m-tiny"])
def test_counter_matches_hlo_decode(arch):
    """B4 decode at max_len 64: the JAX decode attends its contiguous
    cache of 64 rows; the port's plain paged version gathers the slot's
    table of 4 pages of 16 rows, the same 64, so the FLOPs are equal to
    the unit."""
    jm, jparams, tm, params = _models(arch)
    tm = Model(get_config(arch), remat=False, page_size=16)
    jcache = jax.eval_shape(lambda: jm.init_cache(4, 64))
    want = _jax_flops(jm.decode, jparams, jcache,
                      jax.ShapeDtypeStruct((4, 1), jnp.int32))
    cache = tm.init_cache(4, 64)
    cache["lengths"] = torch.full((4,), 40, dtype=torch.int32)
    c, _, _ = dryrun.count_step(tm, "decode", {
        "params": params, "cache": cache,
        "tokens": torch.zeros((4, 1), dtype=torch.int32)})
    assert _cpu_flops(c) == want


@pytest.mark.parametrize("arch", ["llama3.1-8b-tiny",
                                  "granite-moe-1b-a400m-tiny"])
def test_counter_matches_hlo_train(arch):
    """One AdamW step with remat at B2 S32.  Both sides recompute each
    layer's forward in the backward (JAX's ``jax.checkpoint`` with
    ``nothing_saveable``, the port's ``torch.utils.checkpoint``), and
    both FLOP counts hold the recompute.  They differ by exactly one
    attention score product a layer, 2·B·H·S²·dh: the backward's first
    product (S = QKᵀ, recomputed per key block) is the recomputed
    forward's first product on the same operands, and XLA merges the two
    (common subexpression elimination) where eager PyTorch runs both."""
    from repro.models import Model as JaxModel
    from repro.train.optimizer import AdamW as JaxAdamW
    from repro.train.train_step import TrainStepConfig as JaxCfg
    from repro.train.train_step import TrainState as JaxState
    from repro.train.train_step import make_train_step as jax_step
    jm = JaxModel(jax_get_config(arch))
    jparams = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    jstate = JaxState(jparams, jax.eval_shape(JaxAdamW().init, jparams))
    B, S = 2, 32
    batch = {"inputs": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    want = _jax_flops(jax_step(jm, JaxAdamW(), JaxCfg()), jstate, batch)
    cfg = get_config(arch)
    tm = Model(cfg)
    c, _, _ = dryrun.count_step(tm, "train",
                                _step_inputs(tm, "train", "cpu", B=B, S=S))
    layers = sum(st.n_layers for st in cfg.stages)
    assert _cpu_flops(c) - want == \
        layers * 2 * B * cfg.n_heads * S * S * cfg.d_head


# ------------------------------------------------ meta against the CPU
_STEPS = [("llama3.1-8b-tiny", "prefill"), ("llama3.1-8b-tiny", "decode"),
          ("llama3.1-8b-tiny", "extend"), ("llama3.1-8b-tiny", "train"),
          ("granite-moe-1b-a400m-tiny", "prefill"),
          ("granite-moe-1b-a400m-tiny", "decode"),
          ("granite-moe-1b-a400m-tiny", "train"),
          ("zamba2-1.2b-tiny", "prefill"), ("zamba2-1.2b-tiny", "decode"),
          ("zamba2-1.2b-tiny", "train"), ("xlstm-125m-tiny", "prefill"),
          ("xlstm-125m-tiny", "train"), ("musicgen-large-tiny", "prefill"),
          ("musicgen-large-tiny", "train"), ("gemma3-27b-tiny", "prefill")]


#: steps where torch's meta kernel of an op gives its output other strides
#: than the CPU kernel does, so a later reshape copies on one side only:
#: ``softplus_backward`` (Mamba2's dt) follows its second operand's layout
#: on meta and its first's on the CPU (28,672 bytes of 177.5 MB here)
_META_STRIDES = {("zamba2-1.2b-tiny", "train")}


def _step_inputs(model, step, device, B=2, S=32, max_len=64):
    """The same step's inputs on ``device``: f32 params, and for decode
    and extend a cache holding ``max_len - S`` tokens a slot through an
    identity block table (the meta charges assume every table full, so
    the CPU data fills them too)."""
    cfg = model.cfg
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, device=device)
    if cfg.embed_inputs:
        toks = torch.zeros((B, 1 if step == "decode" else S),
                           dtype=torch.int32, device=device)
    else:
        toks = torch.zeros((B, 1 if step == "decode" else S, cfg.d_model),
                           dtype=torch.bfloat16, device=device)
    if step == "train":
        labels = torch.zeros((B, S) + ((cfg.n_codebooks,)
                                       if cfg.n_codebooks else ()),
                             dtype=torch.int32, device=device)
        from repro_torch.train.train_step import TrainState
        return {"state": TrainState(params, AdamW().init(params)),
                "batch": {"inputs": toks, "labels": labels}}
    if step == "prefill":
        return {"params": params, "tokens": toks}
    cache = model.init_cache(B, max_len, device=device)
    maxp, _ = model.page_geometry(B, max_len)
    if device == "cpu":
        cache["block_table"] = torch.arange(
            B * maxp, dtype=torch.int32).reshape(B, maxp)
        cache["lengths"] = torch.full(
            (B,), max_len - (1 if step == "decode" else S),
            dtype=torch.int32)
    return {"params": params, "cache": cache, "tokens": toks}


@pytest.mark.parametrize("arch,step", _STEPS)
def test_meta_counts_what_the_cpu_counts_outside_kernels(arch, step):
    """Every loop iteration runs on both sides (no trip count), so the
    ops outside the kernel calls are the same ops: equal FLOPs and bytes.
    The attention kernels' charges are equal too (the CPU reads lengths
    that fill the tables, as meta assumes); the grouped matmul's are its
    work function at full groups on meta and at the routed groups on the
    CPU.  Arguments are equal but for the decode workspace, which the meta
    branch allocates as the card does and which persists."""
    model = Model(get_config(arch), page_size=16)
    cm, mm, _ = dryrun.count_step(model, step,
                                  _step_inputs(model, step, "meta"),
                                  trip_counts=False)
    from repro_torch.kernels import paged_attention as pa
    ws = sum(t.untyped_storage().nbytes()
             for t in pa._SCRATCH.get(torch.device("meta"), ())) \
        if step == "decode" else 0
    cc, mc, _ = dryrun.count_step(model, step,
                                  _step_inputs(model, step, "cpu"))
    assert cm.flops == cc.flops
    if (arch, step) in _META_STRIDES:
        assert cm.hbm_bytes == pytest.approx(cc.hbm_bytes, rel=1e-3)
    else:
        assert cm.hbm_bytes == cc.hbm_bytes
    assert cm.coll_bytes == cc.coll_bytes == {}
    assert cm.launches() == cc.launches()
    for name, k in cm.kernels.items():
        got = (k.flops, k.bytes)
        want = (cc.kernels[name].flops, cc.kernels[name].bytes)
        if name.startswith("moe_gmm"):
            assert got >= want
        else:
            assert got == want, name
    assert mm["argument_size_in_bytes"] - ws == mc["argument_size_in_bytes"]
    assert all(k.plain_flops == 0 for k in cm.kernels.values())
    n_attn = sum(st.n_layers for st in model.cfg.stages
                 if st.kind in ("attn_mlp", "attn_moe"))
    if step == "prefill" and n_attn:
        assert cm.kernels["flash_attention"].launches == n_attn


def test_meta_charges_are_the_work_functions():
    """Each wrapper on meta charges its work function at the shapes it
    was given (full lengths, full tables, full expert groups), predicts
    one launch and returns the kernel's output shapes, allocating its
    scratch."""
    meta = torch.device("meta")
    bf = torch.bfloat16
    B, S, H, KV, dh = 2, 128, 8, 2, 64
    q = torch.empty(B, S, H, dh, dtype=bf, device=meta)
    k = torch.empty(B, S, KV, dh, dtype=bf, device=meta)
    with Counter() as c:
        out, lse = ops.flash_attention(q, k, k, return_lse=True)
        dq, dk, dv = ops.flash_attention_bwd(q, k, k, out, lse, out)
        pages = torch.empty(2 * 4 + 3, 32, KV, dh, dtype=bf, device=meta)
        table = torch.empty(B, 4, dtype=torch.int32, device=meta)
        lens = torch.empty(B, dtype=torch.int32, device=meta)
        dec = ops.paged_attention(q[:, 0], pages, pages, table, lens,
                                  page_size=32)
        ext = ops.paged_attention(q[:, :16], pages, pages, table, lens,
                                  page_size=32, start=lens)
        x = torch.empty(4, 10, 64, dtype=bf, device=meta)
        w = torch.empty(4, 64, 32, dtype=bf, device=meta)
        gs = torch.empty(4, dtype=torch.int32, device=meta)
        y = ops.moe_gmm(x, w, gs)
        gx, gw = ops.moe_gmm_bwd(x, w, gs, y)
    assert (out.shape, lse.shape, lse.dtype) == (q.shape, (B, H, S),
                                                 torch.float32)
    assert (dq.shape, dk.shape, dec.shape, ext.shape, y.shape, gx.shape,
            gw.shape) == (q.shape, k.shape, (B, H, dh), (B, 16, H, dh),
                          (4, 10, 32), x.shape, w.shape)
    pairs = B * S * (S + 1) // 2
    want = {
        "flash_attention": ops.flash_attention_work(B, S, H, KV, dh, 2,
                                                    pairs, lse=True),
        "flash_attention_bwd": ops.flash_attention_bwd_work(
            B, S, H, KV, dh, 2, pairs),
        "paged_attention_decode": ops.paged_decode_work(
            B, H, KV, dh, 2, 8, B * 128),
        "paged_attention_extend": ops.paged_extend_work(
            B, 16, H, KV, dh, 2, 8, B * 128,
            B * sum(112 + s + 1 for s in range(16))),
        "moe_gmm": ops.moe_gmm_work(4, 10, 64, 32, 2, 40, 4),
        "moe_gmm_bwd": ops.moe_gmm_bwd_work(4, 10, 64, 32, 2, 40, 4),
    }
    assert {n: (k.launches, k.flops, k.bytes)
            for n, k in c.kernels.items()} == \
        {n: (1,) + tuple(float(x) for x in w) for n, w in want.items()}
    assert c.flops == 0
    # the decode workspace: B * KV tickets and B * KV * splits * G * (dh +
    # 2) floats, 2 pages a split
    from repro_torch.kernels import paged_attention as pa
    tickets, ws = pa._SCRATCH[meta]
    assert (tickets.numel(), ws.numel()) == (B * KV,
                                             B * KV * 2 * 4 * (dh + 2))
    assert pa.decode_pages_per_split() == 2


def test_work_functions_match_the_bounds_they_replace():
    """The work functions give the numbers ``chip_smoke.py``'s phase 3
    computed inline before them, at its shapes."""
    lens = (97, 180, 333, 512, 640, 781, 900, 1056)
    assert ops.flash_attention_work(1, 256, 32, 8, 128, 2,
                                    256 * 257 // 2) == \
        (4 * (256 * 257 // 2) * 32 * 128,
         2 * 256 * 32 * 128 * 2 + (2 * 256 * 8 * 128) * 2 + 4)
    rows = sum(lens)
    assert ops.paged_decode_work(8, 32, 8, 128, 2, 8 * 32, rows) == \
        (4 * rows * 32 * 128,
         rows * 8 * 128 * 2 * 2 + 2 * 8 * 32 * 128 * 2 + 256 * 4 + 8 * 4)
    assert ops.paged_work([n - 1 for n in lens], 1, lens, None) == \
        (rows, rows)
    pairs = sum(293 + s + 1 for s in range(256))
    assert ops.paged_work([293], 256, [293 + 256], None) == (549, pairs)
    assert ops.paged_extend_work(1, 256, 32, 8, 128, 2, 32, 549, pairs) == \
        (4 * pairs * 32 * 128,
         549 * 8 * 128 * 2 * 2 + 2 * 256 * 32 * 128 * 2 + 32 * 4 + 8)
    assert ops.moe_gmm_work(16, 40, 4096, 960, 2, 508, 16) == \
        (2 * 508 * 4096 * 960,
         16 * 4096 * 960 * 2 + 508 * 4096 * 2 + 16 * 40 * 960 * 2 + 16 * 4)
    assert ops.moe_gmm_bwd_work(16, 320, 960, 4096, 2, 4096, 16) == \
        (4 * 4096 * 960 * 4096,
         16 * 960 * 4096 * 2 + 4096 * (960 + 4096) * 2
         + (16 * 320 * 960 + 16 * 960 * 4096) * 2 + 16 * 4)
    assert ops.flash_attention_bwd_work(2, 1024, 32, 8, 128, 2,
                                        2 * 1024 * 1025 // 2) == \
        (10 * 128 * 2 * 32 * (1024 * 1025 // 2),
         (4 * 2 * 1024 * 32 * 128 + 2 * 2 * 1024 * 8 * 128
          + 2 * 2 * 1024 * 8 * 128) * 2 + 2 * 32 * 1024 * 4)
    # a window and ragged lengths: pairs by brute force
    S, L, W = 50, 37, 9
    brute = sum(1 for i in range(S) for j in range(S)
                if j <= i and j < L and i - j < W)
    assert ops.causal_pairs(S, [L], W) == brute


def test_trip_count_equals_the_full_sltm_loop():
    """Tiny xLSTM on meta: one sLSTM iteration charged S - 1 times against
    all S iterations run.  Prefill: FLOPs, bytes and memory equal exactly.
    Train (remat): FLOPs exactly; bytes within 1% and the peak within 10%,
    because what the autograd engine adds between one iteration's backward
    nodes (the sum of a state's two gradients) is charged once, not S - 1
    times, and the counted iteration's carried state is kept once an
    iteration under autograd where only the next iteration's backward
    keeps it in the loop."""
    cfg = get_config("xlstm-125m-tiny")
    for step in ("prefill", "train"):
        shape = ShapeCfg("t", 64, 2, step)
        got = []
        for trip in (True, False):
            model = Model(cfg)
            c, mem, _ = dryrun.count_step(
                model, step, specs.input_specs(cfg, shape, model),
                trip_counts=trip)
            got.append((c.flops, c.hbm_bytes, mem))
        (f1, b1, m1), (f0, b0, m0) = got
        assert f1 == f0
        if step == "prefill":
            assert (b1, m1) == (b0, m0)
        else:
            assert b1 == pytest.approx(b0, rel=1e-2)
            assert m1["peak_bytes"] == pytest.approx(m0["peak_bytes"],
                                                     rel=0.1)


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_tp2_collectives_by_formula(step):
    """Tiny llama at tp = 2 on meta, rank 0's shard: the embedding's
    all-reduce of the rank's rows' lookup, two all-reduces of the hidden
    state a layer (attention and MLP outputs) and the head's all-gather of
    the vocab shards."""
    cfg = get_config("llama3.1-8b-tiny")
    model = Model(cfg, group=CountingGroup(0, 2), page_size=16)
    B, S = 2, 32
    inputs = _step_inputs(model, step, "meta", B=B, S=S)
    inputs["params"] = shard_params(inputs["params"], 0, 2, cfg=cfg)
    c, _, out = dryrun.count_step(model, step, inputs)
    rows = B * (S if step == "prefill" else 1)
    L = sum(st.n_layers for st in cfg.stages)
    act = 2  # bf16 compute
    assert c.coll_bytes == {"all-reduce": (2 * L + 1) * rows * cfg.d_model
                            * act,
                            "all-gather": B * cfg.padded_vocab * act}
    assert c.coll_moved == pytest.approx(
        2 * (2 - 1) / 2 * c.coll_bytes["all-reduce"]
        + (2 - 1) / 2 * c.coll_bytes["all-gather"])
    assert out[0].shape == (B, 1, cfg.padded_vocab)


def test_lower_cell_tp2_and_train_refusal():
    """A tp = 2 decode (the embedding's all-reduce beside the layers'), a
    train cell at tp = 2 (counted now: its gradients' model-axis sums and
    the vocab gather), a train cell whose query heads do not divide tp
    (counted now), and what still refuses: a cell the port cannot shard is
    ``unsupported`` with its reason, never an error."""
    rec = dryrun.lower_cell("llama3.1-8b", "decode_32k", tp=2)
    assert rec["status"] == "ok" and rec["mesh"] == [1, 2]
    assert rec["n_devices"] == 2
    assert rec["roofline"]["t_collective_s"] > 0
    assert rec["roofline"]["collective_bytes"]["all-reduce"] == \
        (2 * 32 + 1) * 128 * 4096 * 2
    rec = dryrun.lower_cell("llama3.1-8b-tiny", "train_4k", tp=2,
                            microbatches=8)
    assert rec["status"] == "ok" and rec["mesh"] == [1, 2]
    assert set(rec["collective_bytes_by_axis"]) == {"model"}
    assert rec["collective_bytes_by_axis"]["model"]["all-gather"] > 0
    # 36 query heads over 16 ranks: GSPMD's padded layout, rank 0's three
    # heads on KV 0, which ranks 1 and 2 read too
    rec = dryrun.lower_cell("starcoder2-7b", "train_4k", tp=16)
    assert rec["status"] == "ok" and rec["mesh"] == [1, 16]
    assert "padded layout" in rec["note"] and "rank 0" in rec["note"]
    assert rec["kernels"]["flash_attention"]["launches"] == 64
    assert rec["collective_bytes_by_axis"]["model"]["all-reduce"] > 0
    rec = dryrun.lower_cell("xlstm-125m", "train_4k", tp=3)
    assert rec["status"] == "unsupported"
    assert "feed-forward width 1024" in rec["reason"]


# ---------------------------------------------------- plain attentions
def _qkv(rng, B, S, H, KV, dh):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh))]


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("bkv", [16, 64])
def test_chunked_attention_matches_jax(window, bkv):
    from repro.models.layers import chunked_attention as jax_chunked
    from repro_torch.models.layers import chunked_attention
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 64, 8, 2, 16)
    lengths = np.array([64, 41], np.int32)
    want = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       lengths=jnp.asarray(lengths), window=window, bkv=bkv)
    got = chunked_attention(*map(torch.from_numpy, (q, k, v)),
                            lengths=torch.from_numpy(lengths),
                            window=window, bkv=bkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bkv,S", [(8, 64), (16, 64), (64, 64)])
def test_folded_causal_attention_matches_jax(bkv, S):
    from repro.models.layers import folded_causal_attention as jax_folded
    from repro_torch.models.layers import folded_causal_attention
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, S, 8, 2, 16)
    lengths = np.array([S, 45], np.int32)
    want = jax_folded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      lengths=jnp.asarray(lengths), bkv=bkv)
    got = folded_causal_attention(*map(torch.from_numpy, (q, k, v)),
                                  lengths=torch.from_numpy(lengths), bkv=bkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["llama3.1-8b-tiny", "gemma3-27b-tiny",
                                  "granite-moe-1b-a400m-tiny"])
@pytest.mark.parametrize("impl", ["chunked", "folded"])
def test_model_attn_impl_matches_jax(arch, impl):
    """Prefill and training-forward logits of ``Model(attn_impl=impl)``
    against the JAX ``Model``'s on the same f32 params (2e-5, the model
    tests' tolerance); gemma3's windowed layers take chunked under
    folded, as in JAX."""
    from repro.models import Model as JaxModel
    from repro_torch.convert import params_from_numpy
    jcfg = dataclasses.replace(jax_get_config(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    jm = JaxModel(jcfg, attn_impl=impl, remat=False)
    np_params = jax.tree_util.tree_map(np.asarray,
                                       jm.init(jax.random.PRNGKey(2)))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tm = Model(tcfg, attn_impl=impl, remat=False)
    tp = params_from_numpy(np_params)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (2, 32)).astype(np.int32)
    lj, _ = jm.prefill(jp, jnp.asarray(toks))
    lt, _ = tm.prefill(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=2e-5,
                               atol=2e-5)
    fj, _ = jm.forward(jp, jnp.asarray(toks))
    with torch.no_grad():
        ft, _ = tm.forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=2e-5,
                               atol=2e-5)


def test_model_rejects_unknown_attn_impl():
    with pytest.raises(ValueError, match="attn_impl"):
        Model(get_config("llama3.1-8b-tiny"), attn_impl="banded")


# ------------------------------------------------------ CLI and report
def test_cli_writes_records_and_skips_done(tmp_path, capsys):
    out = tmp_path / "r.jsonl"
    argv = ["--arch", "xlstm-125m", "--shape", "decode_32k", "--out",
            str(out)]
    dryrun.main(argv)
    dryrun.main(["--arch", "llama3.1-8b", "--shape", "long_500k", "--out",
                 str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["ok", "skipped"]
    rec = recs[0]
    for key in ("arch", "shape", "multi_pod", "mesh", "n_devices",
                "status", "attn_impl", "microbatches", "variant", "memory",
                "roofline", "model_flops_global", "model_flops_per_device",
                "useful_flops_frac", "hw", "trace_s", "compile_s", "fits",
                "kernels"):
        assert key in rec, key
    assert rec["compile_s"] is None and rec["fits"] is True
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes",
                                  "alias_size_in_bytes"}
    capsys.readouterr()
    dryrun.main(argv + ["--skip-done"])
    assert "skip (done)" in capsys.readouterr().out
    assert len(out.read_text().splitlines()) == 2


def test_port_records_pass_through_the_jax_report(tmp_path):
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import roofline_report
    finally:
        sys.path.remove(str(ROOT))
    rec = dryrun.lower_cell("qwen3-8b", "decode_32k")
    path = tmp_path / "r.jsonl"
    path.write_text(json.dumps(rec) + "\n")
    rows = roofline_report.table(roofline_report.load(str(path)))
    assert len(rows) == 1
    row = rows[0]
    roof = rec["roofline"]
    assert (row["arch"], row["shape"], row["bottleneck"]) == \
        ("qwen3-8b", "decode_32k", roof["bottleneck"])
    assert row["t_memory_s"] == roof["t_memory_s"]
    assert row["temp_gb"] == rec["memory"]["temp_size_in_bytes"] / 1e9
    assert row["useful_flops_frac"] == rec["useful_flops_frac"]
