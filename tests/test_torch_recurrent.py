"""The recurrent and hybrid families on the port against the JAX package.

Mamba2/SSD, xLSTM and the zamba superblock, at the tiny configs, f32, on
the CPU.  Inputs are drawn with numpy from a seed and JAX params reach the
port through ``convert.params_from_numpy``.

* Per function: ``ssd_chunked``, ``mamba_forward`` (fresh and continued),
  ``mamba_decode``, ``mlstm_forward``/``mlstm_decode`` and
  ``slstm_forward``/``slstm_decode`` equal JAX's outputs and states within
  1e-5 (abs and rel).
* Per model: the port's ``Model.prefill``, ``extend`` (zamba2) and
  ``decode`` equal the JAX ``Model``'s logits and caches within 1e-4, pad
  tails included; the port's decode leaves a sentinel row's state as it
  was; xLSTM ``extend`` raises in both.
* Engine: the port's decisions equal the JAX engine's; its tokens equal a
  per-request oracle of JAX ``Model`` calls on a contiguous B = 1 cache
  (prefill on the engine's bucket, extend for each further chunk, greedy
  decode), also under chunked prefill with slots mid-prefill while others
  decode (the JAX engine cannot run that, so the decisions there are held
  to the JAX simulator's); P/D emits the unified serve's tokens.
* The JAX engine's recurrent-state faults, pinned: its zamba2 tokens
  (unified and P/D) differ from the oracle, and chunked prefill raises.
* The refusals: the prefix store and spec decoding; tp = 2 serves both
  families on two gloo ranks with tp = 1's tokens and decisions, and the
  CLI serves zamba2 at ``--tp 2`` (``test_torch_recurrent_tp.py`` holds
  tensor parallelism to the JAX package).
* Card (``-m cuda``): the three attention kernels at zamba2's shapes (dh
  64, one query head per kv-head) against their plain versions.  Only the
  card test runs without JAX, which every other test imports lazily.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import mamba2 as tmb  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402

ZAMBA, XLSTM = "zamba2-1.2b-tiny", "xlstm-125m-tiny"
FN_TOL = dict(rtol=1e-5, atol=1e-5)
# a model call chains the blocks' f32 sums in other orders than JAX's
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
N = 5


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces, imported here and not at the top, so the
    card test runs where there is no JAX."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import Model as JaxModel
    from repro.models import mamba2 as jmb
    from repro.models import xlstm as jxl
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jax_get_config,
                                 Model=JaxModel, mb=jmb, xl=jxl)


def _np(jx, tree):
    return jx.jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def _closetree(got, want, tol):
    for k in want:
        if isinstance(want[k], dict):
            _closetree(got[k], want[k], tol)
        else:
            _close(got[k], want[k], tol)


def _f32(jx, arch):
    return (dataclasses.replace(jx.get_config(arch), compute_dtype="float32",
                                kernels="reference"),
            dataclasses.replace(get_config(arch), compute_dtype="float32"))


# --------------------------------------------------------------------------
# per function
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [8, 21])
def test_ssd_chunked_matches_jax(jx, s, with_h0):
    """A whole number of chunks and a padded tail, from zero or from a
    given state."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 8, 16, 16
    xs = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = (-0.5 * np.abs(rng.standard_normal((b, s, h)))).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if with_h0 else None
    yj, hj = jx.mb.ssd_chunked(*map(jx.jnp.asarray, (xs, a, B, C)), 8,
                               h0=None if h0 is None else jx.jnp.asarray(h0))
    yt, ht = tmb.ssd_chunked(*map(torch.from_numpy, (xs, a, B, C)), 8,
                             h0=None if h0 is None else torch.from_numpy(h0))
    _close(yt, yj, FN_TOL)
    _close(ht, hj, FN_TOL)


def _noisy(tree, rng):
    """Zero-init scales and biases get noise, so a term that is zero at
    init cannot hide a missing one."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _noisy(v, rng)
        elif "norm" in k or k in ("conv_b", "b_gates", "f_bias"):
            out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


def _block_params(jx, init, *args):
    rng = np.random.default_rng(1)
    pn = _noisy(_np(jx, init(jx.jax.random.PRNGKey(2), *args)), rng)
    return jx.jax.tree_util.tree_map(jx.jnp.asarray, pn), \
        params_from_numpy(pn)


def test_mamba_forward_continue_and_decode_match_jax(jx):
    """A fresh prefill of 19 tokens (chunk 8: a padded tail), a continued
    chunk of 7 from its state, then one decode step."""
    jcfg, tcfg = _f32(jx, ZAMBA)
    jp, tp = _block_params(jx, jx.mb.init_mamba, jcfg.d_model, jcfg.ssm)
    rng = np.random.default_rng(3)
    st_j = st_t = None
    for S in (19, 7):
        x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
        oj, st_j = jx.mb.mamba_forward(jp, jx.jnp.asarray(x), jcfg,
                                       state=st_j, return_state=True)
        ot, st_t = tmb.mamba_forward(tp, torch.from_numpy(x), tcfg,
                                     state=st_t, return_state=True)
        _close(ot, oj, FN_TOL)
        _closetree(st_t, st_j, FN_TOL)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    oj, sj = jx.mb.mamba_decode(jp, jx.jnp.asarray(x), jcfg, st_j)
    ot, stt = tmb.mamba_decode(tp, torch.from_numpy(x), tcfg, st_t)
    _close(ot, oj, FN_TOL)
    _closetree(stt, sj, FN_TOL)


def test_mamba_short_first_chunk_matches_jax(jx):
    """A chunk shorter than the conv's window pads the window's front."""
    jcfg, tcfg = _f32(jx, ZAMBA)
    jp, tp = _block_params(jx, jx.mb.init_mamba, jcfg.d_model, jcfg.ssm)
    x = np.random.default_rng(4).standard_normal(
        (1, 2, jcfg.d_model)).astype(np.float32)
    oj, sj = jx.mb.mamba_forward(jp, jx.jnp.asarray(x), jcfg,
                                 return_state=True)
    ot, st = tmb.mamba_forward(tp, torch.from_numpy(x), tcfg,
                               return_state=True)
    _close(ot, oj, FN_TOL)
    _closetree(st, sj, FN_TOL)


@pytest.mark.parametrize("S", [8, 21])
def test_mlstm_forward_and_decode_match_jax(jx, S):
    """The chunked prefill (chunk 8: whole chunks, then a padded tail),
    its exact final state, and one decode step from it."""
    jcfg, _ = _f32(jx, XLSTM)
    d, nh = jcfg.d_model, jcfg.n_heads
    jp, tp = _block_params(jx, jx.xl.init_mlstm, d, nh)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    oj, sj = jx.xl.mlstm_forward(jp, jx.jnp.asarray(x), nh, 1e-5,
                                 return_state=True, chunk=8)
    ot, st = txl.mlstm_forward(tp, torch.from_numpy(x), nh, 1e-5,
                               return_state=True, chunk=8)
    _close(ot, oj, FN_TOL)
    _closetree(st, sj, FN_TOL)
    x = rng.standard_normal((2, 1, d)).astype(np.float32)
    oj, sj = jx.xl.mlstm_decode(jp, jx.jnp.asarray(x), nh, 1e-5, sj)
    ot, st = txl.mlstm_decode(tp, torch.from_numpy(x), nh, 1e-5, st)
    _close(ot, oj, FN_TOL)
    _closetree(st, sj, FN_TOL)


def test_slstm_forward_and_decode_match_jax(jx):
    """The time loop from a fresh state, then from its own final state,
    then one decode step."""
    jcfg, _ = _f32(jx, XLSTM)
    d, nh = jcfg.d_model, jcfg.n_heads
    jp, tp = _block_params(jx, jx.xl.init_slstm, d, nh)
    rng = np.random.default_rng(6)
    sj = st = None
    for S in (13, 5):
        x = rng.standard_normal((2, S, d)).astype(np.float32)
        oj, sj = jx.xl.slstm_forward(jp, jx.jnp.asarray(x), nh, 1e-5,
                                     state=sj, return_state=True)
        ot, st = txl.slstm_forward(tp, torch.from_numpy(x), nh, 1e-5,
                                   state=st, return_state=True)
        _close(ot, oj, FN_TOL)
        _closetree(st, sj, FN_TOL)
    x = rng.standard_normal((2, 1, d)).astype(np.float32)
    oj, sj = jx.xl.slstm_decode(jp, jx.jnp.asarray(x), nh, 1e-5, sj)
    ot, st = txl.slstm_decode(tp, torch.from_numpy(x), nh, 1e-5, st)
    _close(ot, oj, FN_TOL)
    _closetree(st, sj, FN_TOL)


# --------------------------------------------------------------------------
# per model
# --------------------------------------------------------------------------

def _models(jx, arch, noisy=True):
    """(JAX model, its params, port model, its params), the same values."""
    jcfg, tcfg = _f32(jx, arch)
    jm = jx.Model(jcfg, remat=False)
    pn = _np(jx, jm.init(jx.jax.random.PRNGKey(4)))
    if noisy:
        pn = _noisy(pn, np.random.default_rng(11))
    return (jm, jx.jax.tree_util.tree_map(jx.jnp.asarray, pn),
            Model(tcfg, page_size=16), params_from_numpy(pn))


def _jax_leaf(tree, key, name):
    t = tree[key]
    for part in name.split("."):
        t = t[part]
    return t


def _states_match(tm, tcache, jcache, rows=None):
    for key, name, t, ax in tm.state_leaves(tcache):
        want = np.asarray(_jax_leaf(jcache, key, name))
        got = t.numpy()
        if rows is not None:
            got, want = got.take(rows, ax), want.take(rows, ax)
        np.testing.assert_allclose(got, want, **MODEL_TOL,
                                   err_msg=f"{key}.{name}")


def _jax_cache(jx, jm, c1, B, max_len, lengths):
    """A JAX prefill cache inside a contiguous ``max_len`` cache."""
    def put(big, small, attn):
        if isinstance(big, dict):
            return {k: put(big[k], small[k], attn or k == "attn")
                    for k in big}
        return big.at[:, :, :small.shape[2]].set(small) if attn else small
    big = jm.init_cache(B, max_len)
    out = {k: put(big[k], c1[k], False) for k in big if k != "lengths"}
    out["lengths"] = jx.jnp.asarray(lengths)
    return out


def _port_cache(tm, c1, B, max_len, lengths):
    """A port prefill cache scattered through a permuted block table, its
    state copied in, as the engine does slot by slot."""
    cache = tm.init_cache(B, max_len)
    maxp, _ = tm.page_geometry(B, max_len)
    table = torch.randperm(B * maxp, generator=torch.Generator()
                           .manual_seed(3)).reshape(B, maxp).int()
    cache["block_table"] = table
    ps = tm.page_size
    for (_, pools), (_, kv) in zip(tm.attention_caches(cache),
                                   tm.attention_caches(c1)):
        pos = torch.arange(kv["k"].shape[2])
        for b in range(B):
            page = table[b, pos // ps].long()
            pools["k_pages"][:, page, pos % ps] = kv["k"][:, b]
            pools["v_pages"][:, page, pos % ps] = kv["v"][:, b]
    for (_, _, t, _), (_, _, one, _) in zip(tm.state_leaves(cache),
                                            tm.state_leaves(c1)):
        t.copy_(one)
    cache["lengths"] = torch.tensor(lengths, dtype=torch.int32)
    return cache


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_model_prefill_extend_decode_match_jax(jx, arch):
    """Prefill (row 0 a bucket's pad tail past its length), extend
    (zamba2: a padded row again), two decode steps: logits and caches equal
    JAX's.  A third step with row 1 on the sentinel token: the logits
    still equal, row 0's state equals JAX's, and row 1's state is what it
    was (JAX advances it)."""
    jm, jp, tm, tp = _models(jx, arch)
    jnp = jx.jnp
    rng = np.random.default_rng(12)
    B, S, max_len = 2, 32, 96
    lengths = np.array([13, 32], np.int32)
    toks = rng.integers(0, tm.cfg.vocab, (B, S)).astype(np.int32)
    lj, cj = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lengths))
    lt, ct = tm.prefill(tp, torch.from_numpy(toks),
                        lengths=torch.from_numpy(lengths))
    _close(lt, lj, MODEL_TOL)
    _states_match(tm, ct, cj)
    for key, kv in tm.attention_caches(ct):
        _closetree(kv, cj[key]["attn"], MODEL_TOL)
    big = _jax_cache(jx, jm, cj, B, max_len, lengths)
    paged = _port_cache(tm, ct, B, max_len, lengths)

    if arch == ZAMBA:
        n_new = np.array([9, 16], np.int32)
        t2 = rng.integers(0, tm.cfg.vocab, (B, 16)).astype(np.int32)
        lj, big = jm.extend(jp, big, jnp.asarray(t2), jnp.asarray(n_new))
        lt, paged = tm.extend(tp, paged, torch.from_numpy(t2),
                              torch.from_numpy(n_new))
        _close(lt, lj, MODEL_TOL)
        _states_match(tm, paged, big)
        np.testing.assert_array_equal(paged["lengths"].numpy(),
                                      np.asarray(big["lengths"]))

    for step in range(3):
        tok = rng.integers(0, tm.cfg.vocab, (B, 1)).astype(np.int32)
        if step == 2:
            tok[1, 0] = -1
            before = [t.clone() for _, _, t, _ in tm.state_leaves(paged)]
        lj, big = jm.decode(jp, big, jnp.asarray(tok))
        lt, paged = tm.decode(tp, paged, torch.from_numpy(tok))
        _close(lt, lj, MODEL_TOL)
        _states_match(tm, paged, big, rows=None if step < 2 else [0])
    for (_, name, t, ax), old in zip(tm.state_leaves(paged), before):
        assert torch.equal(t.select(ax, 1), old.select(ax, 1)), name
        assert not torch.equal(t.select(ax, 0), old.select(ax, 0)), name


def test_xlstm_extend_raises_in_both(jx):
    jm, jp, tm, tp = _models(jx, XLSTM, noisy=False)
    toks = np.zeros((1, 16), np.int32)
    _, cj = jm.prefill(jp, jx.jnp.asarray(toks))
    _, ct = tm.prefill(tp, torch.from_numpy(toks))
    big = _jax_cache(jx, jm, cj, 1, 64, [16])
    paged = _port_cache(tm, ct, 1, 64, [16])
    with pytest.raises(NotImplementedError) as je:
        jm.extend(jp, big, jx.jnp.asarray(toks))
    with pytest.raises(NotImplementedError) as te:
        tm.extend(tp, paged, torch.from_numpy(toks))
    assert str(te.value) == str(je.value)


def test_f32_params_survive_the_cast(jx):
    """The decay, skip and recurrent weights the blocks read in f32 stay
    f32 in a bf16 engine, as norm scales do; numpy's dtypes survive the
    conversion."""
    from repro_torch.models.transformer import cast_params
    for arch in (ZAMBA, XLSTM):
        jcfg = jx.get_config(arch)
        pn = _np(jx, jx.Model(jcfg).init(jx.jax.random.PRNGKey(0)))
        tp = params_from_numpy(pn)
        jx.jax.tree_util.tree_map(
            lambda a, t: (a.dtype == np.float32 and t.dtype == torch.float32)
            or pytest.fail("dtype"), pn, tp)
        cast = cast_params(tp, torch.bfloat16)
        kept = {"A_log", "dt_bias", "D", "r_gates"}

        def walk(tree, path=()):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    f32 = k in kept or any("norm" in p for p in path + (k,))
                    assert v.dtype == (torch.float32 if f32
                                       else torch.bfloat16), path + (k,)
        walk(cast)


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

def _bucket(n, lo=16):
    b = lo
    while b < n:
        b *= 2
    return b


def _requests(gen, cfg_cls, vocab, seed=3):
    """N requests of varied prompt lengths (5 to 80), every arrival at t =
    0, so the decisions depend on no latency."""
    reqs = gen(cfg_cls(
        n_requests=N, rate=50.0, vocab=vocab, seed=seed, mean_prompt=40,
        mean_output=6, sigma_prompt=0.6, sigma_output=0.3, max_prompt=80,
        max_output=7, share_fraction=0.0))
    for r in reqs:
        r.arrival = 0.0
    return reqs


def _jax_engine(jx, arch, name="e0", role="unified", params=None, batch=3):
    from repro.serve import ServingEngine as JaxServingEngine
    jcfg, _ = _f32(jx, arch)
    return JaxServingEngine(jcfg, params, max_batch=batch, max_len=256,
                            name=name, role=role)


def _port_engine(jx, arch, params, name="e0", role="unified", batch=3):
    from repro_torch.serve import ServingEngine
    _, tcfg = _f32(jx, arch)
    if not isinstance(params, dict) or "embed" not in params \
            or not isinstance(params["embed"]["tok"], torch.Tensor):
        params = params_from_numpy(_np(jx, params))
    return ServingEngine(tcfg, params, max_batch=batch, max_len=256,
                         name=name, role=role, device="cpu")


def _run(drv, reqs):
    """(metrics, tokens by instance, decisions by instance)."""
    m = drv.run(reqs, warmup=False)
    insts = drv.runtime.instances
    return (m, {n: dict(i.backend.out_tokens) for n, i in insts.items()},
            {n: list(i.decisions) for n, i in insts.items()})


def _oracle(jx, jeng, reqs, decisions, max_len=256):
    """Each request's tokens from JAX ``Model`` calls (jitted, on the JAX
    engine's params) on its own contiguous B = 1 cache: ``prefill`` on the
    first chunk's bucket, ``extend`` for each further chunk (bucketed, as
    the engine pads it), then greedy ``decode`` one token at a time.  The
    chunk plan is read from the decisions."""
    jnp = jx.jnp
    jm, jp = jeng.model, jeng.params
    vocab = jm.cfg.vocab
    plan = {}
    for it in decisions:
        for rid, phase, n in it:
            if phase == "prefill":
                plan.setdefault(rid, []).append(n)
    out = {}
    for r in reqs:
        toks = list(r.prompt_tokens)
        chunks = plan[r.req_id]
        assert sum(chunks) == len(toks)

        def padded(a, b):
            pad = np.zeros((1, _bucket(b - a)), np.int32)
            pad[0, :b - a] = toks[a:b]
            return jnp.asarray(pad)
        n = chunks[0]
        logits, c1 = jeng._jit_prefill(jp, padded(0, n),
                                       lengths=jnp.asarray([n], jnp.int32))
        cache = _jax_cache(jx, jm, c1, 1, max_len, [n])
        for c in chunks[1:]:
            logits, cache = jeng._jit_extend(jp, cache, padded(n, n + c),
                                             jnp.asarray([c], jnp.int32))
            n += c
        tok = int(np.argmax(np.asarray(logits)[0, 0, :vocab]))
        got = [tok]
        while len(got) < r.output_len:
            logits, cache = jeng._jit_decode(
                jp, cache, jnp.asarray([[tok]], jnp.int32))
            tok = int(np.argmax(np.asarray(logits)[0, 0, :vocab]))
            got.append(tok)
        out[r.req_id] = got
    return out


def _jax_requests(jx, vocab):
    from repro.workload import ShareGPTConfig as JaxShareGPTConfig
    from repro.workload import generate as jax_generate
    return _requests(jax_generate, JaxShareGPTConfig, vocab)


def _port_requests(vocab):
    from repro_torch.workload import ShareGPTConfig, generate
    return _requests(generate, ShareGPTConfig, vocab)


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_unified_serve_decisions_match_jax_engine(jx, arch):
    """The engine-matched scheduler, batch 3: the port's decisions equal
    the JAX engine's, its tokens equal the JAX Model oracle, every request
    finishes."""
    from repro.core.config import engine_scheduler_cfg as jax_sched
    from repro.serve import DriverCfg as JaxDriverCfg
    from repro.serve import ServeDriver as JaxServeDriver
    from repro_torch.core.config import engine_scheduler_cfg
    from repro_torch.serve import DriverCfg, ServeDriver
    jeng = _jax_engine(jx, arch)
    teng = _port_engine(jx, arch, jeng.params)
    _, _, jdec = _run(JaxServeDriver([jeng], JaxDriverCfg(
        scheduler=jax_sched(3))), _jax_requests(jx, jeng.cfg.vocab))
    reqs = _port_requests(teng.cfg.vocab)
    m, toks, tdec = _run(ServeDriver([teng], DriverCfg(
        scheduler=engine_scheduler_cfg(3))),
        [dataclasses.replace(r) for r in reqs])
    assert m["finished"] == N
    assert tdec == jdec
    assert toks["e0"] == _oracle(jx, jeng, reqs, tdec["e0"])


def _chunked(arch, sched_cls):
    # xLSTM has no extend: its chunks and budget hold whole prompts
    n = 16 if arch == ZAMBA else 128
    return sched_cls(max_batch_size=3, max_batch_tokens=max(64, n),
                     chunked_prefill=True, prefill_chunk=n)


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_chunked_serve_matches_oracle_and_simulator(jx, arch):
    """Chunked prefill, batch 3: zamba2's prompts arrive in 16-token
    chunks, so a slot sits mid-prefill through decodes of the others (the
    decode runs first in an iteration, so its full-buffer pass meets that
    slot's state).  Tokens equal the JAX Model oracle; decisions equal the
    JAX simulator's and the port simulator's (the JAX engine raises
    here)."""
    from repro.core import ClusterCfg as JaxClusterCfg
    from repro.core import RouterCfg as JaxRouterCfg
    from repro.core.cluster import Cluster as JaxCluster
    from repro.core.config import SchedulerCfg as JaxSchedulerCfg
    from repro.serve.driver import engine_instance_cfg as jax_icfg
    from repro_torch.core import Cluster, ClusterCfg, RouterCfg
    from repro_torch.core.config import SchedulerCfg
    from repro_torch.serve import DriverCfg, ServeDriver
    from repro_torch.serve.driver import engine_instance_cfg
    jeng = _jax_engine(jx, arch)
    teng = _port_engine(jx, arch, jeng.params)
    reqs = _port_requests(teng.cfg.vocab)
    sched = _chunked(arch, SchedulerCfg)
    m, toks, tdec = _run(ServeDriver([teng], DriverCfg(scheduler=sched)),
                         [dataclasses.replace(r) for r in reqs])
    assert m["finished"] == N
    dec = tdec["e0"]
    if arch == ZAMBA:
        done, mid = {}, False
        for it in dec:
            decoding = any(p == "decode" for _, p, _ in it)
            for rid, p, n in it:
                if p == "prefill":
                    mid |= decoding and 0 < done.get(rid, 0)
                    done[rid] = done.get(rid, 0) + n
        assert mid, "no slot sat mid-prefill through a decode"
    assert toks["e0"] == _oracle(jx, jeng, reqs, dec)
    jsim = JaxCluster(JaxClusterCfg(
        instances=(jax_icfg(jeng, _chunked(arch, JaxSchedulerCfg)),),
        router=JaxRouterCfg("round_robin")))
    jsim.submit_workload(_jax_requests(jx, jeng.cfg.vocab))
    assert jsim.run()["finished"] == N
    tsim = Cluster(ClusterCfg(instances=(engine_instance_cfg(teng, sched),),
                              router=RouterCfg("round_robin")))
    tsim.submit_workload([dataclasses.replace(r) for r in reqs])
    assert tsim.run()["finished"] == N
    assert dec == list(jsim.instances["e0"].decisions) \
        == list(tsim.instances["e0"].decisions)


def _pd_drivers(jx, arch, params, jax_side=False):
    """(unified driver, P/D driver) at batch 1 on one set of weights."""
    if jax_side:
        from repro.core.config import engine_scheduler_cfg as sched
        from repro.serve import DriverCfg, ServeDriver

        def eng(name, role):
            return _jax_engine(jx, arch, name, role, params, batch=1)
    else:
        from repro_torch.core.config import engine_scheduler_cfg as sched
        from repro_torch.serve import DriverCfg, ServeDriver

        def eng(name, role):
            return _port_engine(jx, arch, params, name, role, batch=1)
    uni = ServeDriver([eng("e0", "unified")], DriverCfg(scheduler=sched(1)))
    pd = ServeDriver([eng("p0", "prefill"), eng("d0", "decode")],
                     DriverCfg(scheduler=sched(1)), pd_map={"p0": ("d0",)})
    return uni, pd


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_pd_serve_emits_the_unified_tokens(jx, arch):
    """One prefill and one decode engine (batches of one): the handoff
    carries the slot's recurrent state beside its K/V, and the decode
    engine emits the unified serve's tokens, which equal the oracle."""
    jeng = _jax_engine(jx, arch, batch=1)
    tparams = params_from_numpy(_np(jx, jeng.params))
    uni, pd = _pd_drivers(jx, arch, tparams)
    reqs = _port_requests(jeng.cfg.vocab)
    mu, utoks, udec = _run(uni, [dataclasses.replace(r) for r in reqs])
    mp, ptoks, _ = _run(pd, [dataclasses.replace(r) for r in reqs])
    assert mu["finished"] == mp["finished"] == N
    # the decode engine's record starts with the first token handed over
    assert ptoks["d0"] == utoks["e0"]
    assert utoks["e0"] == _oracle(jx, jeng, reqs, udec["e0"])


def test_jax_engine_recurrent_faults_pinned(jx):
    """The JAX engine is no oracle for zamba2's state: its unified and P/D
    tokens differ from the JAX Model oracle (the superblock's state is not
    written back on prefill, and its P/D handoff slices the inner-layer
    axis), and chunked prefill raises (the subcache slices that axis too).
    If the JAX package is repaired, this test fails and is updated to say
    so."""
    from repro.core.config import SchedulerCfg as JaxSchedulerCfg
    from repro.serve import DriverCfg, ServeDriver
    jeng = _jax_engine(jx, ZAMBA, batch=1)
    uni, pd = _pd_drivers(jx, ZAMBA, jeng.params, jax_side=True)
    reqs = _jax_requests(jx, jeng.cfg.vocab)
    mu, utoks, udec = _run(uni, [dataclasses.replace(r) for r in reqs])
    mp, ptoks, _ = _run(pd, [dataclasses.replace(r) for r in reqs])
    assert mu["finished"] == mp["finished"] == N
    want = _oracle(jx, jeng, reqs, udec["e0"])
    assert utoks["e0"] != want
    assert ptoks["d0"] != want
    chunked = ServeDriver([_jax_engine(jx, ZAMBA)], DriverCfg(
        scheduler=_chunked(ZAMBA, JaxSchedulerCfg)))
    with pytest.raises(TypeError):
        chunked.run([dataclasses.replace(r) for r in reqs], warmup=False)


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
@pytest.mark.parametrize("what", ["prefix_cache", "spec"])
def test_recurrent_refusals(arch, what):
    from repro_torch.serve import ServingEngine, SpecDecodeCfg
    cfg = get_config(arch)
    kw = {"prefix_cache": dict(prefix_cache=True),
          "spec": dict(spec=SpecDecodeCfg(draft=cfg, k=2))}[what]
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        ServingEngine(cfg, max_batch=2, max_len=64, device="cpu", **kw)


def _tp_cfg(arch):
    """f32; xlstm-125m-tiny's sLSTM width of 85 splits over no tp, so the
    xLSTM serves at d_model 48 (width 64)."""
    over = dict(d_model=48) if arch == XLSTM else {}
    return dataclasses.replace(get_config(arch), compute_dtype="float32",
                               **over)


def _tp_serve(arch, params, group=None):
    """The engine-matched scheduler, batch 3, at tp = 1 or over
    ``group``: (finished, tokens, decisions)."""
    from repro_torch.core.config import engine_scheduler_cfg
    from repro_torch.serve import DriverCfg, ServeDriver, ServingEngine
    cfg = _tp_cfg(arch)
    kw = {} if group is None else dict(tp=group.size, group=group)
    eng = ServingEngine(cfg, params_from_numpy(params), max_batch=3,
                        max_len=256, device="cpu", **kw)
    m, toks, dec = _run(ServeDriver([eng], DriverCfg(
        scheduler=engine_scheduler_cfg(3))), _port_requests(cfg.vocab))
    return m["finished"], toks, dec


def _tp_serve_rank(group, job):
    return {arch: _tp_serve(arch, params, group)
            for arch, params in job.items()}


@pytest.fixture(scope="module")
def tp2_serves():
    """Both families served on two gloo ranks, and at tp = 1, from one
    draw of the weights (numpy)."""
    from repro_torch.launch.mesh import run_ranks
    job = {}
    for i, arch in enumerate((ZAMBA, XLSTM)):
        p = Model(_tp_cfg(arch)).init(torch.Generator().manual_seed(i))
        job[arch] = _np_tree(p)
    ranks = run_ranks(_tp_serve_rank, 2, job, device="cpu", timeout_s=300)
    return ranks, {arch: _tp_serve(arch, p) for arch, p in job.items()}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_recurrent_tp2_serves(tp2_serves, arch):
    """tp = 2 serves the recurrent families (ROADMAP queue 1 item 7 no
    longer holds it back): every rank finishes every request with the
    tokens and decisions of tp = 1."""
    ranks, tp1 = tp2_serves
    assert tp1[arch][0] == N
    for r in ranks:
        assert r[arch] == tp1[arch]


def test_cli_serves_tp2_on_a_recurrent_model(tmp_path):
    """``launch.serve --tp 2`` serves zamba2-1.2b-tiny on two ranks; with
    xlstm-125m-tiny it refuses before any rank starts, naming the sLSTM's
    width that does not split."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))

    def cli(arch):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             "cpu", "--arch", arch, "--tp", "2", "--n", "3"],
            capture_output=True, text=True, timeout=300, cwd=tmp_path,
            env=env)
    res = cli(ZAMBA)
    assert res.returncode == 0, res.stderr[-2000:]
    out = res.stdout
    assert json.loads(out[out.index("{"):])["finished"] == 3
    res = cli(XLSTM)
    assert res.returncode != 0
    assert "--tp 2" in res.stderr and "width 85" in res.stderr


def test_engine_slot_state_round_trip():
    """A released slot gets fresh state; an export carries the state
    leaves with the batch axis removed, and a restore into another slot
    puts them back bit for bit."""
    from repro_torch.serve import ServingEngine
    cfg = dataclasses.replace(get_config(ZAMBA), compute_dtype="float32")
    eng = ServingEngine(cfg, max_batch=3, max_len=64, device="cpu")
    fresh = [t.select(ax, 0).clone()
             for _, _, t, ax in eng.model.state_leaves(eng.cache)]
    toks = torch.randint(0, cfg.vocab, (1, 32), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    _, c1 = eng.model.prefill(eng.params, toks)
    eng._write_slot_from_prefill(1, c1, 32)
    payload = eng._export_slot(1, 32)
    names = {(k, n) for k, n, _, _ in eng.model.state_leaves(eng.cache)}
    assert {(k, n) for k in payload if not k.startswith("_")
            for n in payload[k] if n not in ("k", "v")} == names
    for key, name, t, ax in eng.model.state_leaves(eng.cache):
        assert payload[key][name].shape == t.select(ax, 1).shape
    eng._restore_slot(2, payload, 32)
    eng._release_slot(1)
    for (key, name, t, ax), f in zip(eng.model.state_leaves(eng.cache),
                                     fresh):
        assert torch.equal(t.select(ax, 1), f), name
        assert torch.equal(t.select(ax, 2), payload[key][name]), name
        assert not torch.equal(t.select(ax, 2), f), name


# --------------------------------------------------------------------------
# card
# --------------------------------------------------------------------------

@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_at_zamba_shapes(sm90, dtype):
    """zamba2-1.2b's shared attention: H32 KV32 dh64 (one query head per
    kv-head), pages of 64.  Flash at a 256-token chunk, paged decode over
    ragged lengths, paged extend of 256 from a ragged start across page
    edges, each against its plain version (f32 1e-4, bf16 2e-2)."""
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    gen = torch.Generator(device=sm90).manual_seed(0)
    H = KV = 32
    dh, ps, maxp, B = 64, 64, 32, 8

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=sm90).to(dtype)

    def check(got, want):
        err = (got.float() - want.float()).abs()
        assert bool((err <= tol + tol * want.float().abs()).all()), \
            err.max().item()
    S = 256
    q, k, v = rand(1, S, H, dh), rand(1, S, KV, dh), rand(1, S, KV, dh)
    lt = torch.tensor([S - 37], dtype=torch.int32, device=sm90)
    check(ops.flash_attention(q, k, v, lt)[:, :S - 37],
          ops.flash_attention_plain(q, k, v, lt)[:, :S - 37])
    P = B * maxp + 1
    kp, vp = rand(P, ps, KV, dh), rand(P, ps, KV, dh)
    table = torch.randperm(P - 1, generator=gen, device=sm90)[
        :B * maxp].reshape(B, maxp).int()
    lens = torch.tensor([1, 64, 65, 300, 777, 1024, 1500, 2048],
                        dtype=torch.int32, device=sm90)
    qd = rand(B, H, dh)
    check(ops.paged_attention(qd, kp, vp, table, lens, page_size=ps),
          ops.paged_attention_plain(qd, kp, vp, table, lens, page_size=ps))
    st = torch.tensor([293], dtype=torch.int32, device=sm90)
    qe = rand(1, S, H, dh)
    n = 200
    got = ops.paged_attention(qe, kp, vp, table[:1], st + n, page_size=ps,
                              start=st)
    want = ops.paged_attention_plain(qe, kp, vp, table[:1], st + n,
                                     page_size=ps, start=st)
    check(got[:, :n], want[:, :n])
