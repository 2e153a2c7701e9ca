"""The port's ``Model`` against the JAX ``Model`` on the same params.

The JAX params go through numpy into ``repro_torch.convert``; every norm
scale and bias gets numpy noise first, so a term that is zero at init
cannot hide a missing one.  The JAX side runs ``kernels="reference"`` with
its contiguous cache; the port runs its paged cache through a permuted
block table of 16-token pages.  Prefill, extend and decode logits must
agree in f32 within 2e-5, for dense and for MoE stages (the MoE layers run
the grouped matmul's plain version; every row routes, pad tails included,
as in JAX without a routing hook), and for musicgen on precomputed
embeddings with its codebook heads (no negative-token sentinel there).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import Model  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
# (arch, layers): gemma3's tiny config has one (local) layer; the two-layer
# variant adds a global layer to its local:global interleave
ARCHS = [("llama3.1-8b-tiny", None), ("qwen3-8b-tiny", None),
         ("qwen1.5-32b-tiny", None), ("gemma3-27b-tiny", None),
         ("gemma3-27b-tiny", 2), ("starcoder2-7b-tiny", None),
         ("phimini-moe-tiny", None), ("granite-moe-1b-a400m-tiny", None),
         ("musicgen-large-tiny", None)]
# granite runs at its published routing (32 experts top-8) and head dim 64
# over the tiny widths: top-k > 2 adds more than two expert outputs per row
_WIDTHS = {"granite-moe-1b-a400m-tiny": dict(d_head=64, n_experts=32,
                                             top_k=8)}


def _with_layers(cfg, layers):
    w = _WIDTHS.get(cfg.name)
    if w is not None:
        cfg = dataclasses.replace(
            cfg, d_head=w["d_head"],
            moe=dataclasses.replace(cfg.moe, n_experts=w["n_experts"],
                                    top_k=w["top_k"]))
    if layers is None:
        return cfg
    return dataclasses.replace(
        cfg, n_layers=layers,
        stages=(dataclasses.replace(cfg.stages[0], n_layers=layers),))


def _noisy(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _noisy(v, rng, path + (k,)) for k, v in tree.items()}
    if any("norm" in k for k in path) or path[-1] in ("bq", "bk", "bv"):
        return (tree + 0.1 * rng.standard_normal(tree.shape)
                ).astype(tree.dtype)
    return tree


def _inputs(cfg, rng, B, S):
    """Token ids, or (B, S, d) f32 embeddings for a model that reads
    precomputed embeddings."""
    if cfg.embed_inputs:
        return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _write_prefill(cache, c1, table, ps, S):
    """Scatter a contiguous prefill cache through the block table."""
    pos = torch.arange(S)
    for key, stage in cache.items():
        if key in ("lengths", "block_table"):
            continue
        for b in range(table.shape[0]):
            page = table[b, pos // ps].long()
            stage["k_pages"][:, page, pos % ps] = c1[key]["k"][:, b]
            stage["v_pages"][:, page, pos % ps] = c1[key]["v"][:, b]


@pytest.mark.parametrize("arch,layers", ARCHS)
def test_prefill_extend_decode_logits_match_jax(arch, layers):
    jcfg = _with_layers(dataclasses.replace(jax_get_config(arch),
                                            compute_dtype="float32"), layers)
    tcfg = _with_layers(dataclasses.replace(get_config(arch),
                                            compute_dtype="float32"), layers)
    rng = np.random.default_rng(11)
    jm = JaxModel(jcfg, remat=False)
    np_params = _noisy(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(4))), rng)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tm = Model(tcfg, page_size=16)
    tp = params_from_numpy(np_params)

    B, S, max_len = 2, 32, 96
    lengths = np.array([13, 20], np.int32)
    tokens = _inputs(jcfg, rng, B, S)

    # prefill
    lj, cj = jm.prefill(jp, jnp.asarray(tokens), lengths=jnp.asarray(lengths))
    lt, ct = tm.prefill(tp, torch.from_numpy(tokens),
                        lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)

    # the caches those calls produced, at max_len
    big = jm.init_cache(B, max_len)
    for key in cj:
        if key != "lengths":
            big[key] = {n: big[key][n].at[:, :, :S].set(cj[key][n])
                        for n in ("k", "v")}
    big["lengths"] = jnp.asarray(lengths)
    paged = tm.init_cache(B, max_len)
    maxp, n_pages = tm.page_geometry(B, max_len)
    table = torch.from_numpy(
        rng.permutation(n_pages - 1)[: B * maxp].reshape(B, maxp)
        .astype(np.int32))
    paged["block_table"] = table
    _write_prefill(paged, ct, table, tm.page_size, S)
    paged["lengths"] = torch.from_numpy(lengths)

    # extend: a chunk crossing a page, one row with a pad tail
    S2 = 16
    n_new = np.array([16, 9], np.int32)
    tok2 = _inputs(jcfg, rng, B, S2)
    lj, big = jm.extend(jp, big, jnp.asarray(tok2), jnp.asarray(n_new))
    lt, paged = tm.extend(tp, paged, torch.from_numpy(tok2),
                          torch.from_numpy(n_new))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_array_equal(paged["lengths"].numpy(),
                                  np.asarray(big["lengths"]))

    # decode: three steps, the second with row 1 unscheduled (sentinel)
    for step in range(3):
        tok = _inputs(jcfg, rng, B, 1)
        if step == 1 and jcfg.embed_inputs:
            tok[1, 0] = -1
        lj, big = jm.decode(jp, big, jnp.asarray(tok))
        lt, paged = tm.decode(tp, paged, torch.from_numpy(tok))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_serving_engine_refuses_musicgen():
    """The Model runs musicgen (above); the serving engine, like the JAX
    one, takes token ids only and refuses it by name."""
    from repro_torch.serve import ServingEngine
    with pytest.raises(NotImplementedError, match="serving musicgen-large"):
        ServingEngine(get_config("musicgen-large-tiny"), device="cpu",
                      max_batch=2, max_len=64)


@pytest.mark.parametrize("arch", ["zamba2-1.2b-tiny", "xlstm-125m-tiny"])
def test_recurrent_models_build_and_prefill(arch):
    """The recurrent and hybrid families build from their configs and run
    one prefill on the CPU, in the config's bf16 and in f32, to finite
    logits and a cache holding their recurrent state."""
    from repro_torch.models.transformer import cast_params, torch_dtype
    for cfg in (get_config(arch),
                dataclasses.replace(get_config(arch),
                                    compute_dtype="float32")):
        m = Model(cfg)
        params = cast_params(m.init(torch.Generator().manual_seed(0)),
                             torch_dtype(cfg.compute_dtype))
        logits, cache = m.prefill(params,
                                  torch.arange(20, dtype=torch.int32)[None])
        assert tuple(logits.shape) == (1, 1, cfg.padded_vocab)
        assert bool(torch.isfinite(logits.float()).all())
        assert m.state_leaves(cache)


def test_writes_past_the_table_land_on_scratch():
    """A full slot's decode write and an extend's pad tail past the table
    go to the scratch page and leave every allocated page untouched."""
    cfg = dataclasses.replace(get_config("llama3.1-8b-tiny"),
                              compute_dtype="float32")
    tm = Model(cfg, page_size=16)
    params = tm.init(torch.Generator().manual_seed(0))
    B, max_len = 2, 32
    cache = tm.init_cache(B, max_len)
    maxp, n_pages = tm.page_geometry(B, max_len)
    cache["block_table"] = torch.arange(B * maxp, dtype=torch.int32) \
        .reshape(B, maxp)
    for stage in (v for k, v in cache.items() if k.startswith("stage")):
        stage["k_pages"].normal_(generator=torch.Generator().manual_seed(1))
    pools = cache["stage0"]["k_pages"]
    before = pools[:, :-1].clone()
    cache["lengths"] = torch.tensor([max_len, 3], dtype=torch.int32)
    tok = torch.tensor([[5], [-1]], dtype=torch.int32)
    _, cache = tm.decode(params, cache, tok)       # row 0 is full
    assert torch.equal(pools[:, :2], before[:, :2])   # row 0's pages
    before = pools[:, :-1].clone()
    cache["lengths"] = torch.tensor([max_len - 4, 0], dtype=torch.int32)
    sub = {**cache, "lengths": cache["lengths"][:1],
           "block_table": cache["block_table"][:1]}
    tm.extend(params, sub, torch.ones((1, 16), dtype=torch.int32),
              torch.tensor([4], dtype=torch.int32))   # pad tail past 32
    changed = (pools[:, :-1] != before).flatten(2).any(-1).any(0)
    # only row 0's last page (positions 28..31) was written
    assert changed.nonzero().flatten().tolist() == [1]


def test_free_slots_read_back_their_own_kv():
    """A decode writes a free slot's K/V (length 0) on that slot's own
    scratch page and reads back exactly that, as the JAX model's
    contiguous cache does: two free slots with different tokens give the
    logits each gives alone (with one shared scratch page the second
    write would win for both)."""
    cfg = dataclasses.replace(get_config("llama3.1-8b-tiny"),
                              compute_dtype="float32")
    tm = Model(cfg, page_size=16)
    params = tm.init(torch.Generator().manual_seed(0))
    toks = torch.tensor([[7], [9], [3]], dtype=torch.int32)
    both, _ = tm.decode(params, tm.init_cache(3, 32), toks)
    for b in range(3):
        alone, _ = tm.decode(params, tm.init_cache(1, 32), toks[b:b + 1])
        torch.testing.assert_close(both[b], alone[0], rtol=1e-5, atol=1e-5)
