"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, its projections in float8, comes
out not correct where the program comes out correct.  On the CPU at a
tiny size for the dense family (its tiny MoE model's control does not
separate; PERF.md), and on the card at each cell's own size."""
from pathlib import Path

import pytest
import torch

from perfbench import cells
from perfbench.calibrate import readings

ROOT = Path(__file__).resolve().parents[1]


def fails(spec, g) -> bool:
    read = {"max_logit_gap": g.max(), "mean_logit_gap": g.mean(),
            "median_logit_gap": g.float().median()}
    return any(float(read[k]) > spec[k] for k in read if k in spec)


@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
@pytest.mark.parametrize("workload", ["dense.open", "dense.backlog"])
def test_control_fails_where_the_program_passes(tiny_root, workload, seed):
    cell = cells.load(tiny_root, workload)
    r = readings(cell, seed, 1.0, "cpu")
    program, control = r["program"], r["control"]
    spec = cell.limits
    assert not fails(spec, program)
    assert fails(spec, control)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["starcoder2-7b.repo-batch",
                                      "starcoder2-7b.offline-batch"])
def test_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own size")
    cell = cells.load(ROOT, workload)
    spec = cell.limits
    for seed in (11, 12, 13):
        r = readings(cell, seed, 8.0, "cuda")
        assert not fails(spec, r["program"]), seed
        assert fails(spec, r["control"]), seed
