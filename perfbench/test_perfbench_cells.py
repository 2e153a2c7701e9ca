"""A configuration, a traffic mix, a cell's limits and a per-layer metric
are added as files and entries alone: the harness finds them by name and
runs them."""
import json
import shutil
import time
from pathlib import Path

import pytest

from perfbench import cells, harness

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = cells.load(ROOT, w["name"])
        names = {m["name"] for m in cell.end_to_end + cell.per_layer}
        assert set(cell.readers) == names
        assert "setup_s" in names
        # every per-layer metric's end-to-end metric is reported here
        e2e = {m["name"] for m in cell.end_to_end}
        assert all(m["moves"] in e2e for m in cell.per_layer)
        cfg = harness.arch_config(cell.config, cell.family)
        assert cfg.n_layers == cell.config["sizes"]["n_layers"]


def test_a_cell_added_as_files(tiny_root):
    perf = tiny_root / "perfbench"
    # a copy of the readers, so a new one can be added beside them
    (perf / "metrics").unlink()
    shutil.copytree(HERE / "metrics", perf / "metrics")
    (perf / "metrics" / "requests_in_window.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    mix = json.loads((perf / "traffic" / "tiny-open.json").read_text())
    mix["arrival"]["rate"] = 10.0
    mix["prompt"]["median"] = 16
    (perf / "traffic" / "tiny-slow.json").write_text(json.dumps(mix))
    cfg = json.loads((perf / "configs" / "tiny-dense.json").read_text())
    cfg["name"] = "tiny-dense-3"
    cfg["sizes"]["n_layers"] = 3
    (perf / "configs" / "tiny-dense-3.json").write_text(json.dumps(cfg))
    shutil.copy(perf / "limits" / "dense.open.json",
                perf / "limits" / "dense3.slow.json")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-dense-3", "source": "tiny",
                             "file": "perfbench/configs/tiny-dense-3.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "dense3.slow",
                               "config": "tiny-dense-3",
                               "traffic": "tiny-slow", "chips": 1,
                               "why": "tiny"})
    bench["per_layer"].append({"name": "requests_in_window", "unit": "n",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "runtime", "moves": "tpot_p50_ms",
                               "workloads": ["dense3.slow"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load(tiny_root, "dense3.slow")
    assert cell.config["sizes"]["n_layers"] == 3
    assert cell.traffic["arrival"]["rate"] == 10.0
    out = harness.serve_cell(cell, 41, 1.0, True, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["metrics"]["requests_in_window"]["value"] == \
        out["attempted"] > 0
    # the metric is not the other cells'
    assert "requests_in_window" not in cells.load(tiny_root,
                                                  "dense.open").readers


def test_split_metrics_share_their_first_parts_reader():
    """``mfu.offline`` has no reader of its own and is read by its name's
    first part's, ``metrics/mfu.py``, in every cell that reports it."""
    files = {}
    for w in ("starcoder2-7b.repo-batch", "starcoder2-7b.offline-batch"):
        for name, fn in cells.load(ROOT, w).readers.items():
            files.setdefault(name, set()).add(
                Path(fn.__code__.co_filename))
    assert files["mfu.offline"] == {HERE / "metrics" / "mfu.py"}
    assert files["output_tok_s"] == {HERE / "metrics" / "output_tok_s.py"}


def test_unknown_cell():
    with pytest.raises(KeyError, match="no workload"):
        cells.load(ROOT, "nope")
