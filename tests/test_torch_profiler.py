"""The port's profilers and profiler CLI against the JAX package's.

On the CPU at tiny size: the runtime profiler (through ``TorchBackend``),
the kernel sweep's ``reference`` rows and the measured operator profiler
emit the same point keys as the JAX profilers given the same arguments,
every latency positive; the analytical operator trace, the synthetic
``profile`` artifact and a synthetic routing trace equal the JAX
package's.  A ``cuda`` kernel sweep needs the card and raises here.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
DENSE, MOE = "llama3.1-8b-tiny", "phimini-moe-tiny"
GRID = dict(max_batch=2, max_len=128, prefill_buckets=(16, 32),
            decode_ctxs=(32, 64), reps=1)
RUNTIME_GRID = dict(GRID, extend_ctxs=(16, 32), extend_suffixes=(16,))


def _keys(points):
    return sorted((p.op, p.phase, p.tokens, p.context) for p in points)


def _positive(points):
    return all(p.latency_s > 0 for p in points)


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_runtime_trace_keys_equal_jax(arch):
    from repro.profiler.runtime_profiler import runtime_trace as jax_trace
    from repro_torch.core.config import ENGINE_HW
    from repro_torch.profiler.runtime_profiler import runtime_trace
    want = jax_trace(arch, **RUNTIME_GRID)
    got = runtime_trace(arch, engine_device="cpu", **RUNTIME_GRID)
    assert _keys(got.points) == _keys(want.points)
    assert _positive(got.points)
    assert {p.op for p in got.points} == {"iter", "extend", "kv_export"}
    assert got.spec == ENGINE_HW and got.device == "cpu-engine"
    assert got.meta["n_points"] == len(got.points)


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_kernel_reference_keys_equal_jax(arch):
    from repro.profiler.kernel_profiler import kernel_points as jax_points
    from repro_torch.profiler.kernel_profiler import kernel_points
    want = jax_points(arch, "reference", **GRID)
    got = kernel_points(arch, "reference", device="cpu", **GRID)
    assert _keys(got) == _keys(want)
    assert _positive(got)
    kinds = {p.op for p in got}
    assert ("kern:reference:moe_gmm" in kinds) == (arch == MOE)


def test_cuda_kernel_sweep_on_the_cpu_raises():
    """On CPU tensors the wrappers would run their plain versions, which
    must never be labelled as the kernels."""
    from repro_torch.profiler.kernel_profiler import kernel_points
    with pytest.raises(ValueError, match="needs the card"):
        kernel_points(DENSE, "cuda", device="cpu", **GRID)
    with pytest.raises(ValueError, match="must be one of"):
        kernel_points(DENSE, "pallas", device="cpu", **GRID)


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_measured_operator_trace_keys_equal_jax(arch):
    from repro.profiler.operator_profiler import profile_arch as jax_profile
    from repro_torch.profiler import profile_arch
    grid = dict(token_grid=(1, 8), ctx_grid=(64,))
    want = jax_profile(arch, **grid)
    got = profile_arch(arch, device="cpu", **grid)
    assert _keys(got.points) == _keys(want.points)
    assert _positive(got.points)
    assert got.meta["mode"] == want.meta["mode"] == "measured"


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_analytical_operator_trace_equals_jax(arch):
    from repro.profiler.operator_profiler import profile_arch as jax_profile
    from repro_torch.profiler import profile_arch
    want = jax_profile(arch, hardware="tpu-v6e", mode="analytical")
    got = profile_arch(arch, hardware="tpu-v6e", mode="analytical")
    assert [tuple(vars(p).values()) for p in got.points] == \
        [tuple(vars(p).values()) for p in want.points]


def _cli(pkg, args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", f"{pkg}.profiler", *args],
                          capture_output=True, text=True, timeout=300,
                          cwd=cwd, env=env)


def test_cli_synthetic_profile_equals_jax(tmp_path):
    """``profile --device rtx3090`` (synthetic, tp 1 and 2) writes the
    JAX CLI's artifact bytes and summary (the paths aside)."""
    outs = {}
    for pkg in ("repro", "repro_torch"):
        out = tmp_path / f"{pkg}.json"
        res = _cli(pkg, ["profile", "--device", "rtx3090", "--arch", DENSE,
                         "--tp", "1,2", "--out", str(out)], tmp_path)
        assert res.returncode == 0, res.stderr
        summary = json.loads(res.stdout)
        assert summary.pop("trace") == str(out)
        outs[pkg] = (out.read_bytes(), summary)
    assert outs["repro_torch"] == outs["repro"]


def test_cli_synthetic_routing_equals_jax(tmp_path):
    outs = {}
    for pkg in ("repro", "repro_torch"):
        out = tmp_path / f"{pkg}.routing.json"
        res = _cli(pkg, ["record-routing", "--arch", MOE, "--mode",
                         "synthetic", "--zipf-a", "1.3", "--out", str(out)],
                   tmp_path)
        assert res.returncode == 0, res.stderr
        outs[pkg] = out.read_bytes()
    assert outs["repro_torch"] == outs["repro"]


# rank 0's view of a two-rank engine group: building the engines and the
# driver's guard run no collective, so no other rank is needed; the tp = 1
# engine lacks its replica handle
_PD_ACROSS_TP = """
import torch
from repro_torch.configs import get_config
from repro_torch.launch.mesh import EngineGroup
from repro_torch.serve import ServeDriver, ServingEngine
cfg = get_config("llama3.1-8b-tiny")
group = EngineGroup(rank=0, size=2, device=torch.device("cpu"),
                    backend="gloo")
p0 = ServingEngine(cfg, max_batch=2, max_len=128, name="p0",
                   role="prefill", device="cpu", tp=2, group=group)
d0 = ServingEngine(cfg, max_batch=2, max_len=128, name="d0",
                   role="decode", device="cpu")
ServeDriver([p0, d0], pd_map={"p0": ("d0",)})
"""


@pytest.mark.parametrize("module,args,want", [
    ("profiler", ["profile", "--device", "h100", "--mode", "measured",
                  "--tp", "1,2"], "too few cards"),
    ("profiler", ["profile", "--device", "cpu-engine", "--engine-device",
                  "cpu", "--tp", "0"], ">= 1"),
    (None, ["-c", _PD_ACROSS_TP], "pass replicas="),
])
def test_cli_refuses_what_is_not_ported(tmp_path, module, args, want):
    """A measured ``--tp`` past the visible cards refuses, naming both
    counts; ``--tp 0`` refuses; a P/D pair of different tp whose tp = 1
    engine lacks its replica handle raises through ``ServeDriver`` (the
    serve CLI has one ``--tp``), naming the engine and the handle.
    Nothing is written."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = ["-m", f"repro_torch.{module}"] if module else []
    res = subprocess.run([sys.executable, *cmd, *args],
                         capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, env=env)
    assert res.returncode != 0
    if want == "too few cards":
        want = (f"tp=2 runs 2 ranks on 2 cuda devices, but "
                f"{torch.cuda.device_count()} are visible")
    elif want == "pass replicas=":
        want = "the tp = 1 engine 'd0' runs on every rank"
        assert "replicas=<the rank's EngineGroup>" in res.stderr
    assert want in res.stderr
    assert not list(tmp_path.iterdir())


def test_cli_measured_profile_in_process(tmp_path, capsys):
    """``main`` is callable in process (``chip_smoke.py`` drives it so):
    a measured CPU profile with the reference kernel sweep and the grid
    flags writes an artifact the port's registry loads, with its points
    at the requested buckets."""
    from repro_torch.hw import HardwareRegistry
    from repro_torch.profiler.__main__ import main
    out = tmp_path / "cpu.json"
    summary = main(["profile", "--device", "cpu-engine", "--engine-device",
                    "cpu", "--arch", MOE, "--kernels", "reference",
                    "--max-batch", "2", "--max-len", "128", "--reps", "1",
                    "--prefill-buckets", "16,64", "--decode-ctxs", "32",
                    "--extend-ctxs", "32", "--extend-suffixes", "16",
                    "--out", str(out)])
    assert json.loads(capsys.readouterr().out) == summary
    hwt = HardwareRegistry().load_file(str(out))
    assert summary["n_points"] == len(hwt.points) > 0
    assert hwt.kernel_backends() == ["reference"]
    assert {(p.tokens, p.context) for p in hwt.points
            if p.op == "iter" and p.phase == "prefill"} == {(16, 16),
                                                            (64, 64)}
    assert {(p.tokens, p.context) for p in hwt.points
            if p.op == "extend"} == {(16, 48)}


@pytest.mark.parametrize("label", ["cpu-engine", "cpu-measured", "local"])
def test_card_run_never_carries_a_cpu_label(label):
    """A CPU label on an artifact measured on the card would price a CPU
    instance with the card's times: the label defaults to ``h100`` there,
    and a CPU label is refused before any engine is built."""
    from repro_torch.profiler import profile_arch
    from repro_torch.profiler.runtime_profiler import (measured_label,
                                                       runtime_trace)
    card, cpu = torch.device("cuda"), torch.device("cpu")
    assert measured_label(None, card, "cpu-engine") == "h100"
    assert measured_label(None, cpu, "cpu-engine") == "cpu-engine"
    assert measured_label(label, cpu, "cpu-engine") == label
    assert measured_label("h100", card, "cpu-engine") == "h100"
    with pytest.raises(ValueError, match="names a CPU"):
        measured_label(label, card, "cpu-engine")
    with pytest.raises(ValueError, match="names a CPU"):
        runtime_trace(DENSE, device=label, engine_device="cuda")
    with pytest.raises(ValueError, match="names a CPU"):
        profile_arch(DENSE, hardware=label, device="cuda")


def test_cli_cpu_label_measures_on_the_cpu(tmp_path, capsys):
    """``profile --device cpu-engine`` (measured by ``--mode auto``) and
    ``ops`` with a CPU label run the engine on the CPU unless
    ``--engine-device`` says otherwise, so their CPU labels hold CPU
    times; a card engine under a CPU label is refused."""
    from repro_torch.hw import HardwareRegistry
    from repro_torch.profiler.__main__ import main
    out = tmp_path / "cpu.json"
    summary = main(["profile", "--device", "cpu-engine", "--arch", DENSE,
                    "--max-batch", "2", "--max-len", "128", "--reps", "1",
                    "--prefill-buckets", "16", "--decode-ctxs", "32",
                    "--extend-ctxs", "16", "--extend-suffixes", "16",
                    "--out", str(out)])
    hwt = HardwareRegistry().load_file(str(out))
    assert summary["engine_device"] == hwt.meta["engine_device"] == "cpu"
    assert hwt.device == "cpu-engine"
    ops_out = tmp_path / "ops.json"
    summary = main(["ops", "--arch", DENSE, "--hw", "cpu-measured",
                    "--out", str(ops_out)])
    assert summary["mode"] == "measured"
    assert json.loads(ops_out.read_text())["hardware"] == "cpu-measured"
    with pytest.raises(ValueError, match="names a CPU"):
        main(["profile", "--device", "local", "--engine-device", "cuda",
              "--arch", DENSE, "--out", str(tmp_path / "no.json")])
    capsys.readouterr()


@pytest.mark.parametrize("module", [
    "repro_torch.runtime.backends.torch_engine",
    "repro_torch.profiler.runtime_profiler",
    "repro_torch.runtime.scheduler",
    "repro_torch.core.config",
    "repro_torch.hw",
    "repro_torch.bench.fig2_fidelity",
])
def test_module_imports_cold(module):
    """Each module imports first in a fresh interpreter (the backend did
    not: it imported ``serve``, whose driver imports the backend back)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", f"import {module}"],
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert res.returncode == 0, res.stderr
