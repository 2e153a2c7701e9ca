"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
NVIDIA H100: serving cells driven as data (``BENCHMARK.json``,
``configs/``, ``traffic/``, ``metrics/``), the harness that runs them
(``run.py``, ``harness.py``), the benchmark's own counts (``counts.py``)
and the plain reference that decides ``correct`` (``reference/``)."""
