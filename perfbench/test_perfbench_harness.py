"""The harness end to end on the CPU at a tiny size: each kind of cell
runs and comes out correct, with the metrics its role reports; without a
card the command refuses; without the program it fails."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench import cells, harness

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SEED = 2 ** 31 + 12345


def run_cell(root, workload, trace=0, seconds=1.0, seed=SEED):
    cell = cells.load(root, workload)
    return harness.serve_cell(cell, seed, seconds, bool(trace), "cpu",
                              time.perf_counter())


@pytest.mark.parametrize("workload", ["dense.open", "moe.open",
                                      "dense.backlog"])
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_runs_correct(tiny_root, workload, trace):
    out = run_cell(tiny_root, workload, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    cell = cells.load(tiny_root, workload)
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    else:
        # the CPU's profile holds no device operation: the device's
        # metrics are left out, never 0
        assert "device_idle_share" not in out["metrics"]
        assert out["device"]["window_s"] > 0
    assert list(out)[-1] == "checks"
    assert {"max_logit_gap", "unfinished", "short_outputs"} \
        <= set(out["checks"])
    json.dumps(out)


def test_refuses_without_a_card(capsys):
    rc = harness.main(["--workload", "starcoder2-7b.repo-batch", "--seed",
                       "1", "--seconds", "1", "--trace", "0"], root=ROOT,
                      t_start=time.perf_counter())
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "needs 1 CUDA" in out.err


def test_refuses_with_jax_loaded(tiny_root, monkeypatch, capsys):
    """A run whose process holds JAX or the JAX package once the window
    has closed prints no result."""
    monkeypatch.setitem(sys.modules, "jax", sys.modules.get("jax", sys))
    rc = harness.main(["--workload", "dense.open", "--seed", "3",
                       "--seconds", "0.5", "--trace", "0"], root=tiny_root,
                      t_start=time.perf_counter(), device="cpu",
                      look_for_chip=False)
    out = capsys.readouterr()
    assert rc != 0 and "{" not in out.out
    assert "jax" in out.err.splitlines()[-1]


def test_fails_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and perfbench/ fails with
    no result line (the program's package is missing)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path[:0] = ['.']\n"
            "from pathlib import Path\n"
            "from perfbench.harness import main\n"
            "sys.exit(main(['--workload', 'starcoder2-7b.repo-batch', '--seed', "
            "'1', '--seconds', '1', '--trace', '0'], root=Path('.'), "
            "t_start=time.perf_counter(), device='cpu', "
            "look_for_chip=False))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "repro_torch" in p.stderr
