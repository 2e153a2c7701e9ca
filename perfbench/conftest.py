"""The ``cuda`` marker, and a throwaway benchmark of tiny cells for the
CPU tests: ``BENCHMARK.json``, configuration and traffic files in a
temporary root, the real metric readers and families beside them."""
import json
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent

TINY_SIZES = {
    "tiny-dense": ("starcoder2-7b", {
        "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
        "d_head": 16, "d_ff": 128, "vocab": 256, "rope_theta": 100000.0,
        "norm_eps": 1e-5, "mlp_gated": False}),
    "tiny-moe": ("phimini-moe", {
        "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
        "d_head": 16, "d_ff": 32, "vocab": 256, "rope_theta": 10000.0,
        "norm_eps": 1e-5, "mlp_gated": True,
        "moe": {"n_experts": 4, "top_k": 2, "d_expert": 32,
                "capacity_factor": 2.0}}),
}

#: the tiny bf16 cells' limits on the CPU, set from the readings in
#: PERF.md: the dense model's widest and mean gap; the MoE model's widest
#: only (at this size its control does not separate: its cell's number is
#: read on the card)
TINY_LIMITS = {"tiny-dense": {"max_logit_gap": 0.05,
                              "mean_logit_gap": 0.0008},
               "tiny-moe": {"max_logit_gap": 1.5}}
TINY_SAMPLE = {"sample_tokens": 400, "sample_requests": 40}

TINY_ENGINE = {"max_batch": 8, "max_len": 128, "prefill_chunk": 32,
               "max_batch_tokens": 40}
TINY_LENGTHS = {"prompt": {"median": 24, "sigma": 0.5, "min": 8, "max": 60},
                "output": {"median": 24, "sigma": 0.5, "min": 8, "max": 48}}

TINY_CELLS = {"dense.open": ("tiny-dense", "tiny-open"),
              "moe.open": ("tiny-moe", "tiny-open"),
              "dense.backlog": ("tiny-dense", "tiny-backlog")}
#: the real cells' roles, for the metrics' ``workloads`` lists
ROLE = {"starcoder2-7b.repo-batch": "dense.backlog",
        "starcoder2-7b.offline-batch": "dense.backlog"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips elsewhere (run with "
        "`-m cuda` on the card)")


def write_tiny(root: Path, dtype: str = "bfloat16") -> Path:
    (root / "perfbench" / "configs").mkdir(parents=True)
    (root / "perfbench" / "traffic").mkdir(parents=True)
    (root / "perfbench" / "limits").mkdir(parents=True)
    (root / "perfbench" / "metrics").symlink_to(HERE / "metrics")
    (root / "perfbench" / "reference").symlink_to(HERE / "reference")
    for name, (arch, sizes) in TINY_SIZES.items():
        (root / "perfbench" / "configs" / f"{name}.json").write_text(
            json.dumps({"name": name, "arch": arch, "dtype": dtype,
                        "reference": "perfbench/reference/decoder.py",
                        "sizes": sizes}))
    for name, arrival in (("tiny-open", {"process": "stratified",
                                         "rate": 20.0}),
                          ("tiny-backlog", {"process": "backlog"})):
        (root / "perfbench" / "traffic" / f"{name}.json").write_text(
            json.dumps({"engine": TINY_ENGINE, **TINY_LENGTHS,
                        "arrival": arrival, "block": 8, "warm_s": 0.2}))
    for cell, (config, _) in TINY_CELLS.items():
        (root / "perfbench" / "limits" / f"{cell}.json").write_text(
            json.dumps(dict(TINY_LIMITS[config], **TINY_SAMPLE)))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "source": "tiny",
                         "file": f"perfbench/configs/{n}.json",
                         "reduced": [], "why": "tiny"} for n in TINY_SIZES]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                           "why": "tiny"}
                          for n, (c, t) in TINY_CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [ROLE[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_tiny(tmp_path)


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny runs are a few small ops each: one thread, so that the
    test workers sharing the machine do not oversubscribe it."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
