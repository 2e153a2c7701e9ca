"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run it from the root of a checkout on a machine with the cards the cell
asks for.  It keeps every build and kernel cache of the program inside
the checkout (``build/``), at fixed paths.  See ``harness.py``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment():
    cache = ROOT / "build" / "perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


if __name__ == "__main__":
    _environment()
    from perfbench.harness import main
    sys.exit(main(root=ROOT, t_start=T_START))
