"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; the configuration's
entry names its file, whose ``reference`` names its family's module
under ``perfbench/reference/`` (its seeded weights, plain reference and
FLOP count: ``reference/__init__.py``), the mix is
``perfbench/traffic/<traffic>.json``,
the limits that decide ``correct`` are ``perfbench/limits/<cell>.json``,
and every metric is a reader ``perfbench/metrics/<name>.py`` with a
function ``read(run)`` that returns a number, or None where the run holds
nothing for it to read.  A metric split by the end-to-end metric it moves
(``mfu.offline``) without a reader of its own takes the
one of its name's first part (``metrics/mfu.py``).  A metric belongs to a cell when it lists the
cell under ``workloads``, or lists none.  So a later change adds a
configuration with its family, a mix or a metric as files and entries
alone.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

#: what a family module exports (``reference/__init__.py``)
FAMILY = ("covers", "make_params", "logits_at", "model_flops")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable]
    family: ModuleType


def _module(prefix: str, path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader(path: Path) -> Callable:
    return _module("perfbench_metric_", path).read


def family(root: Path, config: dict) -> ModuleType:
    """The family module the configuration names under ``reference``."""
    rel = config.get("reference")
    if rel is None or Path(rel).parts[:2] != ("perfbench", "reference") \
            or ".." in Path(rel).parts:
        raise ValueError(f"{config.get('name')}: reference {rel!r} names no "
                         f"module under perfbench/reference/")
    mod = _module("perfbench_family_", Path(root) / rel)
    missing = [n for n in FAMILY if not callable(getattr(mod, n, None))]
    if missing:
        raise ValueError(f"{config.get('name')}: {rel} has no "
                         f"{', '.join(missing)}")
    return mod


def _reader_path(metrics: Path, name: str) -> Path:
    own = metrics / f"{name}.py"
    return own if own.exists() else metrics / f"{name.split('.')[0]}.py"


def _mine(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads(
        (root / "perfbench" / "limits" / f"{workload}.json").read_text())
    e2e = _mine(bench["end_to_end"], workload)
    per_layer = _mine(bench["per_layer"], workload)
    readers = {m["name"]: _reader(_reader_path(root / "perfbench" / "metrics",
                                               m["name"]))
               for m in e2e + per_layer}
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, readers=readers,
                family=family(root, config))
