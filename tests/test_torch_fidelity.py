"""The port's Fig. 2 twin (``repro_torch.bench.fig2_fidelity``), quick and
tiny on the CPU.

It profiles each tiny arch through the port's real engine, then serves and
simulates S(D), S(M), M(D), PD(D) and S(D)+PC.  Only structure is
checked: every request finishes on both sides, the metrics are finite, the
P/D handoff moved bytes on both sides, and each request's attribution sums
to its e2e latency on both sides.  No timing ratio is gated: the real side is
wall-clock timed and this machine's CPU may be shared (the JAX package's
``test_engine_vs_sim_fidelity_smoke`` fails for that reason), so the
errors are measured on the card by ``chip_smoke.py`` and recorded in
``PERF.md``.
"""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.bench import fig2_fidelity  # noqa: E402


def test_fig2_twin_runs_every_config_on_the_cpu():
    out = fig2_fidelity.run(device="cpu", n_requests=6, kernels=True,
                            reps=1)
    rows = {r["config"]: r for r in out["rows"]}
    assert list(rows) == list(fig2_fidelity.CONFIGS)
    for config, r in rows.items():
        assert r["real_finished"] == r["sim_finished"] == r["n"] == 6
        for key, v in r.items():
            if isinstance(v, float):
                assert math.isfinite(v), (config, key)
        for side in ("real", "sim"):
            assert r[f"{side}_tput"] > 0 and r[f"{side}_tpot_ms"] > 0
            assert (r[f"{side}_handoff_bytes"] > 0) == (config == "PD(D)")
            # each request's attribution partitions its e2e latency
            assert r[f"{side}_attr_requests"] == 6
            assert r[f"{side}_attr_max_gap_s"] <= 1e-9
            assert r[f"{side}_segments"]["prefill"] > 0
            assert ("e0" in r[f"{side}_kv_tiers"]) == (config == "S(D)+PC")
    for key in ("mean_err_pct", "max_err_pct", "ttft_mean_err_pct"):
        assert math.isfinite(out[key])
    attribution = out["kernel_attribution"]
    assert set(attribution) == {fig2_fidelity.DENSE_TINY,
                                fig2_fidelity.MOE_TINY}
    for rows_ in attribution.values():
        assert rows_ and all(
            sum(r["share"].values()) == pytest.approx(1.0) for r in rows_)


def test_prefix_cache_config_waits_for_the_radix_store():
    """S(D)+PC builds one engine with the real radix prefix store (it
    waited for the store, which is ported now)."""
    from repro_torch.serve import RealRadixCache
    engines, pd = fig2_fidelity.make_engines(
        "S(D)+PC", fig2_fidelity.DENSE_TINY, device="cpu", max_batch=2,
        max_len=64)
    assert pd is None and [e.name for e in engines] == ["e0"]
    assert isinstance(engines[0].radix, RealRadixCache)
