"""The port's MoE path against the JAX package's, on the CPU.

Inputs are drawn once with numpy and handed to both sides.  The grouped
matmul's plain version is held against the JAX oracle
(``repro/kernels/ref.py:moe_gmm_ref``) and the interpret-mode Pallas
kernel (``repro.kernels.ops.moe_gmm``) with the tolerances of
``tests/test_kernels.py``; the router, the MoE FFN (gated and GELU, with
and without a validity mask, with capacity drops), the three routing hooks
and the routing recorder against their JAX twins, in f32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.moe import hooks as jax_hooks  # noqa: E402
from repro.moe.trace import ExpertRoutingTrace as JaxTrace  # noqa: E402
from repro.workload.expert_skew import SkewConfig as JaxSkew  # noqa: E402
from repro.workload.expert_skew import \
    synthesize_routing as jax_synthesize  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.moe import hooks  # noqa: E402
from repro_torch.moe.trace import ExpertRoutingTrace  # noqa: E402
from repro_torch.workload.expert_skew import (SkewConfig,  # noqa: E402
                                              synthesize_routing)

F32 = dict(rtol=2e-5, atol=2e-5)
TOLS = {"float32": F32, "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TIGHT = dict(rtol=1e-6, atol=1e-6)


def _both(a, dtype="float32"):
    """One numpy array as (jax array, torch tensor) of ``dtype``: bf16
    rounds the same f32 values to nearest-even on both sides."""
    j = jnp.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------- the grouped matmul ----------

def _gmm_case(seed, E, C, d, f, gs=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = rng.standard_normal((E, d, f)).astype(np.float32)
    if gs is None:
        gs = rng.integers(0, C + 1, E)
    return x, w, np.asarray(gs, np.int32)


def _check_gmm(x, w, gs, dtype, bc):
    jx, tx = _both(x, dtype)
    jw, tw = _both(w, dtype)
    got = ops.moe_gmm(tx, tw, torch.from_numpy(gs))
    assert got.dtype == tx.dtype and got.shape == (x.shape[0], x.shape[1],
                                                   w.shape[2])
    want = jax_ref.moe_gmm_ref(jx, jw, jnp.asarray(gs))
    pallas = jax_ops.moe_gmm(jx, jw, jnp.asarray(gs), bc=bc,
                             interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])
    np.testing.assert_allclose(_np(got), _np(pallas), **TOLS[dtype])
    for e, n in enumerate(gs):                 # rows past a group: exactly 0
        assert not _np(got)[e, n:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", [
    (4, 64, 32, 16), (8, 128, 16, 64), (2, 32, 128, 8),
    # phimini-moe's capacities, batch-8 decode to a 256-token chunk
    *((16, C, 64, 24) for C in (1, 2, 5, 10, 20, 40))])
def test_moe_gmm_plain_matches_jax_sweep(E, C, d, f, dtype):
    _check_gmm(*_gmm_case(2, E, C, d, f), dtype, bc=32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_plain_matches_jax_zero_and_uneven_groups(dtype):
    # full, empty, tiny, partial
    _check_gmm(*_gmm_case(3, 4, 48, 32, 24, gs=[48, 0, 5, 17]), dtype,
               bc=16)


# ---------- the router ----------

@pytest.mark.parametrize("ties", [False, True])
def test_router_topk_matches_jax(ties):
    rng = np.random.default_rng(5)
    T, d, E, k = 24, 16, 8, 2
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = rng.standard_normal((d, E)).astype(np.float32)
    if ties:
        # experts 2 and 5 copy expert 1, expert 6 copies 0: exact ties in
        # the logits, broken toward the lower index by both sides
        w[:, 2] = w[:, 5] = w[:, 1]
        w[:, 6] = w[:, 0]
        x[:4] = 0.0                       # all-equal rows: every expert ties
    jx, tx = _both(x)
    jw, tw = _both(w)
    ji, jc, ja = jax_moe.router_topk(jx, jw, k)
    ti, tc, ta = moe.router_topk(tx, tw, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TIGHT)
    np.testing.assert_allclose(float(ta), float(ja), **TIGHT)
    if ties:
        assert ti[:4].tolist() == [[0, 1]] * 4


# ---------- the MoE FFN ----------

def _ffn_params(seed, d=16, de=8, E=4, skew=0.0):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, E)),
         "w_gate": rng.standard_normal((E, d, de)) * 0.3,
         "w_up": rng.standard_normal((E, d, de)) * 0.3,
         "w_down": rng.standard_normal((E, de, d)) * 0.3}
    p["router"][0, 0] += skew      # with x[:, 0] > 0, expert 0 is wanted
    return {k: v.astype(np.float32) for k, v in p.items()}


def _ffn_both(p, x, *, top_k, gated, valid=None, hook_pair=None,
              positions=None):
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jkw = dict(top_k=top_k, gated=gated)
    tkw = dict(top_k=top_k, gated=gated)
    if valid is not None:
        jkw["valid"] = jnp.asarray(valid)
        tkw["valid"] = torch.from_numpy(np.asarray(valid))
    if hook_pair is not None:
        jkw.update(router_fn=hook_pair[0], positions=jnp.asarray(positions))
        tkw.update(router_fn=hook_pair[1],
                   positions=torch.from_numpy(positions))
    yj, aj = jax_moe.moe_ffn(jnp.asarray(x), jp, **jkw)
    yt, at = moe.moe_ffn(torch.from_numpy(x), tp, **tkw)
    return np.asarray(yj), yt.numpy(), float(aj), float(at)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("skew", [0.0, 4.0])
def test_moe_ffn_matches_jax(gated, masked, skew):
    """Gated and GELU; every row routed (``valid=None``, as the model runs
    without a hook) or a mask; a skewed router overflows expert 0's
    capacity, so some entries are dropped."""
    rng = np.random.default_rng(7)
    T, d = 20, 16
    x = rng.standard_normal((T, d)).astype(np.float32)
    x[:, 0] = 3.0
    valid = (rng.random(T) > 0.3) if masked else None
    p = _ffn_params(8, d=d, skew=skew)
    yj, yt, aj, at = _ffn_both(p, x, top_k=2, gated=gated, valid=valid)
    np.testing.assert_allclose(yt, yj, **F32)
    np.testing.assert_allclose(at, aj, **TIGHT)
    if skew:
        # the skew really dropped entries: C = round(20*2*1.25/4) = 12
        ti, _, _ = moe.router_topk(torch.from_numpy(x),
                                   torch.from_numpy(p["router"]), 2)
        assert int((ti == 0).sum()) > 12


def _replay_pair(E, k, table):
    t = np.asarray(table, np.int32)
    return (jax_hooks.make_replay_hook(JaxTrace(
                model="m", n_experts=E, top_k=k, layers=[t])),
            hooks.make_replay_hook(ExpertRoutingTrace(
                model="m", n_experts=E, top_k=k, layers=[t.copy()])))


def test_invalid_rows_never_consume_expert_capacity():
    """The port's twin of ``test_expert_routing.py``'s case: under forced
    replay, invalid rows on the same experts as the real rows must not
    take their capacity, and come out 0; the port equals JAX on both."""
    E, k, d = 4, 2, 16
    p = _ffn_params(0, d=d)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, d)).astype(np.float32)
    pos = np.arange(4)
    # C = round(4*2*1.25/4) = 3: two invalid rows forced onto the real
    # rows' experts {0,1} would push a real entry past C
    yj, ym, _, _ = _ffn_both(p, x, top_k=k, gated=True,
                             valid=np.array([False, False, True, True]),
                             hook_pair=_replay_pair(E, k, [[0, 1]] * 4),
                             positions=pos)
    # the same T (same capacity), every row valid, extra rows elsewhere
    _, yref, _, _ = _ffn_both(
        p, x, top_k=k, gated=True, valid=np.ones(4, bool),
        hook_pair=_replay_pair(E, k, [[2, 3], [2, 3], [0, 1], [0, 1]]),
        positions=pos)
    np.testing.assert_allclose(ym, yj, **F32)
    np.testing.assert_allclose(ym[2:], yref[2:], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ym[:2], 0.0)


# ---------- the routing hooks ----------

def _trace_pair(seed=7, zipf_a=1.4, period=32, L=2, E=8, k=2):
    kw = dict(kind="zipf", zipf_a=zipf_a, period=period, seed=seed)
    return (jax_synthesize(L, E, k, JaxSkew(**kw), model="m"),
            synthesize_routing(L, E, k, SkewConfig(**kw), model="m"))


def test_replay_hook_matches_jax():
    jt, tt = _trace_pair()
    assert tt.to_json() == jt.to_json()
    pos = np.array([0, 5, 31, 32, 77])          # wraps mod period
    logits = np.zeros((5, 8), np.float32)
    for layer in (0, 1):
        ji, jw, ja = jax_hooks.make_replay_hook(jt)(
            jnp.asarray(logits), positions=jnp.asarray(pos), layer=layer,
            top_k=2)
        ti, tw, ta = hooks.make_replay_hook(tt)(
            torch.from_numpy(logits), positions=torch.from_numpy(pos),
            layer=layer, top_k=2)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert float(ta) == float(ja) == 0.0


def test_bias_hook_matches_jax():
    jt, tt = _trace_pair(zipf_a=2.5, period=64)
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((64, 8)).astype(np.float32)
    for layer in (0, 1):
        ji, jw, _ = jax_hooks.make_bias_hook(jt, strength=3.0)(
            jnp.asarray(logits), positions=jnp.arange(64), layer=layer,
            top_k=2)
        ti, tw, _ = hooks.make_bias_hook(tt, strength=3.0)(
            torch.from_numpy(logits), positions=torch.arange(64),
            layer=layer, top_k=2)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TIGHT)


def test_recording_hook_matches_jax():
    """Both hooks route like the learned router and tap the same
    histogram; a disabled recorder is not called at all on the port."""
    from repro.moe.record import RoutingRecorder as JaxRecorder
    from repro_torch.moe.record import RoutingRecorder
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((12, 8)).astype(np.float32)
    pos = np.arange(12) * 3
    valid = np.arange(12) % 4 != 0
    jrec, trec = JaxRecorder(2, 8, 2, period=16), RoutingRecorder(2, 8, 2,
                                                                  period=16)
    ji, jw, _ = jax_hooks.make_recording_hook(jrec)(
        jnp.asarray(logits), positions=jnp.asarray(pos), layer=1, top_k=2,
        valid=jnp.asarray(valid))
    ti, tw, _ = hooks.make_recording_hook(trec)(
        torch.from_numpy(logits), positions=torch.from_numpy(pos), layer=1,
        top_k=2, valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TIGHT)
    np.testing.assert_array_equal(trec.hist, jrec.hist)
    assert trec.hist.sum() == valid.sum() * 2

    class Off:
        enabled = False

        def tap(self, *a):
            raise AssertionError("tap called while disabled")
    hooks.make_recording_hook(Off())(
        torch.from_numpy(logits), positions=torch.from_numpy(pos), layer=0,
        top_k=2)


def test_recorder_histograms_match_jax_on_a_served_workload():
    """The port's analog of ``test_recording_counts_exactly_the_workload_
    tokens``: the same tiny MoE model (JAX params carried across), served
    with chunked prefill while a slot stays free and decodes overlap other
    requests' chunks, records the same histogram on both engines, and it
    counts exactly the workload's tokens.  Arrivals are all at 0, so both
    engines run the same batches: near-tied router logits could otherwise
    flip in the last bit between batch shapes."""
    from repro.configs import get_config as jax_get_config
    from repro.core.config import SchedulerCfg as JaxSchedulerCfg
    from repro.moe.record import RoutingRecorder as JaxRecorder
    from repro.moe.trace import moe_layer_count
    from repro.serve import DriverCfg as JaxDriverCfg
    from repro.serve import ServeDriver as JaxServeDriver
    from repro.serve import ServingEngine as JaxServingEngine
    from repro.workload import ShareGPTConfig as JaxShareGPTConfig
    from repro.workload import generate as jax_generate
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.config import SchedulerCfg
    from repro_torch.moe.record import RoutingRecorder
    from repro_torch.serve import DriverCfg, ServeDriver, ServingEngine
    from repro_torch.workload import ShareGPTConfig, generate

    arch = "granite-moe-1b-a400m-tiny"
    jcfg = dataclasses.replace(jax_get_config(arch), compute_dtype="float32",
                               kernels="reference")
    tcfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    L, E, k = moe_layer_count(jcfg), jcfg.moe.n_experts, jcfg.moe.top_k
    sched = dict(max_batch_size=4, max_batch_tokens=32,
                 chunked_prefill=True, prefill_chunk=16)
    wl = dict(n_requests=3, rate=50.0, vocab=jcfg.vocab, seed=2,
              mean_prompt=30, mean_output=10, max_prompt=60, max_output=12,
              share_fraction=0.0)
    hists = {}
    for side in ("jax", "torch"):
        if side == "jax":
            rec = JaxRecorder(L, E, k, period=64)
            eng = JaxServingEngine(jcfg, max_batch=4, max_len=128,
                                   name="r0",
                                   routing=jax_hooks.make_recording_hook(
                                       rec))
            params = jax.tree_util.tree_map(np.asarray, eng.params)
            drv = JaxServeDriver([eng], JaxDriverCfg(
                scheduler=JaxSchedulerCfg(**sched)))
            reqs = jax_generate(JaxShareGPTConfig(**wl))
        else:
            rec = RoutingRecorder(L, E, k, period=64)
            eng = ServingEngine(tcfg, params_from_numpy(params),
                                max_batch=4, max_len=128, name="r0",
                                routing=hooks.make_recording_hook(rec),
                                device="cpu")
            drv = ServeDriver([eng], DriverCfg(
                scheduler=SchedulerCfg(**sched)))
            reqs = generate(ShareGPTConfig(**wl))
        for r in reqs:       # decisions must not follow the wall clock
            r.arrival = 0.0
        rec.enabled = False
        drv.runtime.warmup()
        rec.enabled = True
        drv.runtime.submit_workload(reqs)
        drv.runtime.run()
        hists[side] = rec.hist
    rows = sum(r.prompt_len + r.output_len - 1 for r in reqs)
    assert int(hists["torch"].sum()) == rows * k * L
    np.testing.assert_array_equal(hists["torch"], hists["jax"])


def test_record_routing_on_the_cpu():
    from repro_torch.configs import get_config
    from repro_torch.moe.record import record_routing
    from repro_torch.moe.trace import moe_layer_count
    cfg = get_config("phimini-moe-tiny")
    t = record_routing("phimini-moe-tiny", n_requests=2, max_len=128,
                       period=32, mean_prompt=20, mean_output=4,
                       device="cpu")
    assert (t.n_layers, t.n_experts, t.top_k) == (
        moe_layer_count(cfg), cfg.moe.n_experts, cfg.moe.top_k)
    assert t.meta["source"] == "recorded" and t.meta["observations"] > 0
    assert t.period == 32
