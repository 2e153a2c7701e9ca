"""The port's hardware-trace layer and perf model against the JAX package.

``repro_torch.hw`` and ``repro_torch.core.perfmodel`` are copies of the
JAX package's: synthetic artifacts come out byte for byte the same,
artifacts written by either package load in the other, and the perf model
prices the same batches to the same floats in each of its tiers.  The
port adds one spec preset, ``h100``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.config import InstanceCfg as JaxInstanceCfg  # noqa: E402
from repro.core.config import SchedulerCfg as JaxSchedulerCfg  # noqa: E402
from repro.core.perfmodel import BatchItem as JaxBatchItem  # noqa: E402
from repro.core.perfmodel import PerfModel as JaxPerfModel  # noqa: E402
from repro.core.trace import OpPoint as JaxOpPoint  # noqa: E402
from repro.hw import HardwareRegistry as JaxRegistry  # noqa: E402
from repro.hw import get_hw as jax_get_hw  # noqa: E402
from repro.hw import synthetic_trace as jax_synthetic_trace  # noqa: E402
from repro.profiler.arch_spec import \
    model_spec_from_arch as jax_spec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ClusterCfg, InstanceCfg, RouterCfg,  # noqa: E402
                              SchedulerCfg, simulate)
from repro_torch.core.config import H100  # noqa: E402
from repro_torch.core.perfmodel import BatchItem, PerfModel  # noqa: E402
from repro_torch.core.trace import OpPoint  # noqa: E402
from repro_torch.hw import (HardwareRegistry, HardwareTrace,  # noqa: E402
                            get_hw, synthetic_trace)
from repro_torch.hw.trace import kern_op  # noqa: E402
from repro_torch.profiler.arch_spec import model_spec_from_arch  # noqa: E402
from repro_torch.workload import ShareGPTConfig, generate  # noqa: E402

ARCHS = ("llama3.1-8b-tiny", "phimini-moe-tiny")


def _specs(arch):
    return jax_spec(jax_get_config(arch)), \
        model_spec_from_arch(get_config(arch))


@pytest.mark.parametrize("tp", [(1,), (1, 2)], ids=["tp1", "tp1,2"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("device", ["rtx3090", "tpu-v6e", "pim"])
def test_synthetic_trace_bytes_equal_jax(tmp_path, device, arch, tp):
    jm, tm = _specs(arch)
    assert dataclasses.asdict(get_hw(device)) == \
        dataclasses.asdict(jax_get_hw(device))
    jp = jax_synthetic_trace(jax_get_hw(device), jm, tp=tp).save(
        str(tmp_path / "jax.json"))
    tp_ = synthetic_trace(get_hw(device), tm, tp=tp).save(
        str(tmp_path / "port.json"))
    assert open(tp_, "rb").read() == open(jp, "rb").read()


def _v1_v2_files(tmp_path):
    """The legacy artifacts ``tests/test_hw_trace.py`` builds: hwtrace/1
    (top-level tp + points) and hwtrace/2 (grids without kernels)."""
    from repro.core.config import RTX3090
    from repro.core.config import ModelSpec as JaxModelSpec
    model = JaxModelSpec(name="tiny", n_layers=4, d_model=256, n_heads=4,
                         n_kv_heads=2, d_head=64, d_ff=1024, vocab=1024)
    src = jax_synthetic_trace(RTX3090, model)
    pts = [dataclasses.asdict(p) for p in src.points]
    common = {"device": src.device, "model": src.model,
              "interconnect": dataclasses.asdict(src.interconnect),
              "spec": dataclasses.asdict(src.spec), "meta": src.meta}
    v1 = tmp_path / "v1.json"
    v1.write_text(json.dumps({"schema": "hwtrace/1", "tp": 1,
                              "points": pts, **common}))
    v2 = tmp_path / "v2.json"
    v2.write_text(json.dumps({"schema": "hwtrace/2",
                              "grids": [{"tp": 1, "points": pts}],
                              **common}))
    return src, [v1, v2]


def test_jax_written_artifacts_load_in_the_port(tmp_path):
    """A runtime trace the JAX package measured (with kernel rows), and the
    hwtrace/1 and /2 files of the JAX tests, load in the port's registry
    with the same points; the port's re-save loads back in JAX."""
    from repro.profiler.kernel_profiler import kernel_points
    from repro.profiler.runtime_profiler import runtime_trace
    arch = ARCHS[0]
    jt = runtime_trace(arch, max_batch=2, max_len=128,
                       prefill_buckets=(16, 32), decode_ctxs=(32,),
                       extend_ctxs=(16,), extend_suffixes=(16,), reps=1)
    jt.points.extend(kernel_points(arch, "reference", max_batch=2,
                                   max_len=128, prefill_buckets=(16,),
                                   decode_ctxs=(32,), reps=1))
    src, legacy = _v1_v2_files(tmp_path)
    files = [jt.save(str(tmp_path / "jax-runtime.json"))] + legacy
    for path, want in zip(files, [jt, src, src]):
        got = HardwareRegistry().load_file(str(path))
        assert got.device == want.device and got.model == want.model
        assert [dataclasses.astuple(p) for p in got.points] == \
            [dataclasses.astuple(p) for p in want.points]
        assert dataclasses.asdict(got.spec) == dataclasses.asdict(want.spec)
        back = got.save(str(tmp_path / "port-resave.json"))
        again = JaxRegistry().load_file(back)
        assert [dataclasses.astuple(p) for p in again.points] == \
            [dataclasses.astuple(p) for p in want.points]
    assert HardwareTrace.load(files[0]).kernel_backends() == ["reference"]


def _batches(item):
    return {
        "prefill": [item(tokens=128, context=128, phase="prefill")],
        "extend": [item(tokens=48, context=300, phase="prefill", start=252,
                        completes=True)],
        "decode": [item(tokens=1, context=200, phase="decode")
                   for _ in range(4)],
        "mixed": [item(tokens=48, context=300, phase="prefill", start=252,
                       completes=True),
                  item(tokens=64, context=64, phase="prefill"),
                  item(tokens=1, context=80, phase="decode")],
    }


def _tier_points(tier, arch):
    """(op, phase, tokens, context, latency) rows of one pricing tier."""
    rng = np.random.default_rng(0)
    jm, _ = _specs(arch)
    if tier == "op":
        return [(p.op, p.phase, p.tokens, p.context, p.latency_s)
                for p in jax_synthetic_trace(jax_get_hw("tpu-v6e"),
                                             jm).points]
    rows = []
    if tier == "iter":
        for P in (16, 64, 256):
            rows += [("iter", "prefill", P, P), ("kv_export", "prefill", P, P)]
        for c in (64, 256, 512):
            rows += [("extend", "prefill", 64, c)]
            rows += [("iter", "decode", b, c) for b in (1, 2, 4)]
    else:      # kernel rows of two backends; the test pins one
        ffn = "moe_gmm" if jm.is_moe else "mlp"
        for bk in ("pallas", "reference"):
            for kn in ("attention", ffn, "head"):
                rows += [(kern_op(bk, kn), "prefill", T, T)
                         for T in (16, 64, 256)]
                rows += [(kern_op(bk, kn), "decode", b, c)
                         for b in (1, 4) for c in (64, 256)]
    return [r + (float(rng.uniform(1e-4, 1e-2)),) for r in rows]


@pytest.mark.parametrize("role", ["unified", "prefill"])
@pytest.mark.parametrize("tier", ["iter", "kernel", "op"])
@pytest.mark.parametrize("arch", ARCHS)
def test_perfmodel_prices_equal_jax(arch, tier, role):
    """Prefill, extend, decode and mixed batches priced by the port's
    ``PerfModel`` equal (==) the JAX package's, at the iteration, kernel
    (label pinned to one backend's rows) and op tiers."""
    from repro.core.trace import Trace as JaxTrace
    from repro_torch.core.trace import Trace
    jm, tm = _specs(arch)
    pts = _tier_points(tier, arch)
    jt = JaxTrace(model=arch, hardware="x", tp=1,
                  points=[JaxOpPoint(*p) for p in pts])
    tt = Trace(model=arch, hardware="x", tp=1,
               points=[OpPoint(*p) for p in pts])
    pin = "pallas" if tier == "kernel" else None
    sched = dict(max_batch_size=4, decode_pad_to=4)
    jcfg = JaxInstanceCfg(name="i0", hw=jax_get_hw("tpu-v6e"), model=jm,
                          role=role, kernel_backend=pin,
                          scheduler=JaxSchedulerCfg(**sched))
    tcfg = InstanceCfg(name="i0", hw=get_hw("tpu-v6e"), model=tm, role=role,
                       kernel_backend=pin, scheduler=SchedulerCfg(**sched))
    jpm, tpm = JaxPerfModel(jcfg, trace=jt), PerfModel(tcfg, trace=tt)
    for name, jb in _batches(JaxBatchItem).items():
        want = jpm.iteration_latency(jb)
        got = tpm.iteration_latency(_batches(BatchItem)[name])
        assert got.total_s == want.total_s > 0, name
        assert got.breakdown == want.breakdown, name
        if tier == "kernel":
            assert got.breakdown["kernel_backend"] == "pallas"
    assert tpm.pricing_deterministic() == jpm.pricing_deterministic()


def test_kernel_tier_prefers_cuda_rows():
    """Unpinned, the port prices with ``kern:cuda:*`` rows when a trace
    holds them beside ``reference`` rows (the JAX package would take its
    ``pallas`` rows); a trace with only ``pallas`` rows reaches the kernel
    tier here when pinned."""
    from repro_torch.core.trace import Trace
    _, tm = _specs(ARCHS[0])
    rows = []
    for bk, lat in (("cuda", 1e-4), ("reference", 5e-4), ("pallas", 9e-4)):
        for kn in ("attention", "mlp", "head"):
            rows += [OpPoint(kern_op(bk, kn), "decode", b, c, lat)
                     for b in (1, 4) for c in (64, 256)]
    batch = [BatchItem(tokens=1, context=100, phase="decode")]
    for pin, want in ((None, "cuda"), ("pallas", "pallas"),
                      ("reference", "reference")):
        cfg = InstanceCfg(name="i0", hw=H100, model=tm, kernel_backend=pin)
        cost = PerfModel(cfg, trace=Trace(model="m", hardware="h", tp=1,
                                          points=list(rows)))
        assert cost.iteration_latency(batch).breakdown[
            "kernel_backend"] == want
    only_pallas = [p for p in rows if "pallas" in p.op]
    cfg = InstanceCfg(name="i0", hw=H100, model=tm)
    assert PerfModel(cfg, trace=Trace(
        model="m", hardware="h", tp=1, points=only_pallas))._kernel_backend() \
        is None


def test_h100_resolves_to_a_synthetic_trace_and_prices(monkeypatch):
    """``hw_name="h100"`` resolves through the port's registry to a
    synthetic trace carrying the preset, and a cluster of it serves; the
    engine-side spec on a card is the same preset with the card's own
    memory size."""
    from repro_torch.serve.driver import device_hw
    _, tm = _specs(ARCHS[0])
    assert get_hw("h100") == H100
    assert (H100.peak_flops, H100.hbm_bw, H100.hbm_capacity, H100.link_bw,
            H100.host_bw) == (989e12, 3.35e12, 80e9, 450e9, 64e9)
    hwt = HardwareRegistry().resolve("h100", tm)
    assert hwt.meta["mode"] == "synthetic" and hwt.spec == H100
    lat = PerfModel(InstanceCfg(name="i0", hw=H100, model=tm),
                    trace=hwt.to_trace()).iteration_latency(
        [BatchItem(tokens=64, context=64, phase="prefill")]).total_s
    assert lat > 0
    reqs = generate(ShareGPTConfig(n_requests=6, rate=20.0, seed=1,
                                   vocab=get_config(ARCHS[0]).vocab))
    m = simulate(ClusterCfg(
        instances=(InstanceCfg(name="i0", hw=None, model=tm,
                               hw_name="h100"),),
        router=RouterCfg("round_robin", model_affinity=False)), reqs)
    assert m["finished"] == 6
    assert m["instances"]["i0"]["hw"] == "h100"

    class Props:
        total_memory = 85_520_000_000
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    spec = device_hw(torch.device("cuda"))
    assert spec == dataclasses.replace(H100, hbm_capacity=85_520_000_000.0)
