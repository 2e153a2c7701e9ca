"""What the harness's process and its reference load: never JAX, flax or
the JAX package (``repro``: compared as a whole top-level name, since the
port's ``repro_torch`` begins with it); the reference and the comparison
nothing of the program."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro"}


def loaded(code: str, cwd) -> set:
    p = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    code = (f"import sys, json, time\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            f"from pathlib import Path\n"
            f"from perfbench.conftest import write_tiny\n"
            f"from perfbench import cells, harness\n"
            f"import torch; torch.set_num_threads(1)\n"
            f"root = write_tiny(Path({str(tmp_path)!r}))\n"
            f"for w, t in (('moe.open', 1), ('dense.backlog', 0)):\n"
            f"    harness.serve_cell(cells.load(root, w), 5, 0.5, bool(t),\n"
            f"                       'cpu', time.perf_counter())\n"
            f"print(json.dumps(sorted({{m.split('.')[0] "
            f"for m in sys.modules}})))\n")
    names = loaded(code, ROOT)
    assert "repro_torch" in names and "perfbench" in names
    assert not names & BANNED, names & BANNED


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys, json\n"
            f"sys.path[:0] = [{str(ROOT)!r}]\n"
            f"import perfbench.reference.decoder, perfbench.check\n"
            f"import perfbench.counts, perfbench.workload, perfbench.weights\n"
            f"print(json.dumps(sorted({{m.split('.')[0] "
            f"for m in sys.modules}})))\n")
    names = loaded(code, ROOT)
    assert "repro_torch" not in names
    assert not names & BANNED
