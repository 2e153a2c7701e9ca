"""The port stands alone: it imports neither JAX nor the JAX package, runs
on the card unless asked for the CPU, never trades a kernel for its plain
version on a CUDA tensor, and its copies of the framework-free layers
agree with the originals."""
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
#: the training modules, which the checks below must reach
TRAINING_MODULES = ("repro_torch.models.flash", "repro_torch.train.optimizer",
                    "repro_torch.train.train_step",
                    "repro_torch.train.checkpoint", "repro_torch.train.tree",
                    "repro_torch.launch.train",
                    "repro_torch.workload.datasets")
#: the dry run and the roofline, which the checks below must reach too
DRYRUN_MODULES = ("repro_torch.launch.dryrun", "repro_torch.launch.specs",
                  "repro_torch.roofline", "repro_torch.roofline.analysis",
                  "repro_torch.roofline.counter")


def test_port_and_chip_smoke_import_no_jax():
    """The port, chip_smoke.py and the backward timing tool it imports."""
    code = f"""
import importlib, json, pkgutil, sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r},
                {str(ROOT / 'tools')!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
import gmm_bwd_time
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(json.dumps({{"n": len(names), "names": names, "bad": bad}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] > 30
    assert set(TRAINING_MODULES + DRYRUN_MODULES) <= set(res["names"])
    assert res["bad"] == []


def test_port_sources_name_no_jax():
    pat = re.compile(r"import jax|from jax|\brepro\.")
    sources = sorted(PORT.rglob("*.py"))
    rel = {str(p.relative_to(PORT)) for p in sources}
    for mod in TRAINING_MODULES + DRYRUN_MODULES:   # covered, too
        path = mod.replace("repro_torch.", "").replace(".", "/")
        assert path + ".py" in rel or path + "/__init__.py" in rel, mod
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in sources
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line)]
    assert hits == []


def test_engine_needs_cuda_unless_told_cpu(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.serve import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(get_config("llama3.1-8b-tiny"))
    eng = ServingEngine(get_config("llama3.1-8b-tiny"), device="cpu",
                        max_batch=2, max_len=64)
    assert eng.device.type == "cpu"


@pytest.mark.parametrize("what", ["prefix_cache", "tp", "spec"])
def test_engine_refuses_unported_options(what):
    """``tp`` above 1 needs an engine group (one process a rank) and
    raises ``ValueError`` without one; the prefix store and speculative
    decoding are ported: ``prefix_cache=True`` builds an engine with a
    ``RealRadixCache``, and a bad ``SpecDecodeCfg`` raises the JAX engine's
    ``ValueError``."""
    from repro_torch.configs import get_config
    from repro_torch.serve import (RealRadixCache, ServingEngine,
                                   SpecDecodeCfg)
    cfg = get_config("llama3.1-8b-tiny")
    kw = dict(device="cpu", max_batch=2, max_len=64)
    if what == "tp":
        with pytest.raises(ValueError, match="tp=2 needs an engine group"):
            ServingEngine(cfg, tp=2, **kw)
    elif what == "prefix_cache":
        eng = ServingEngine(cfg, prefix_cache=True, **kw)
        assert isinstance(eng.radix, RealRadixCache)
        assert eng.radix.device == eng.device
    else:
        with pytest.raises(ValueError, match="k must be >= 1"):
            ServingEngine(cfg, spec=SpecDecodeCfg(draft=cfg, k=0), **kw)


def test_cuda_call_without_kernel_library_raises(monkeypatch, tmp_path):
    """A CUDA tensor must reach the kernel or raise: with no library and
    no compiler the wrappers raise and never run the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    def no_nvcc():
        raise build.KernelBuildError("nvcc not found")

    def plain_must_not_run(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(fa, "flash_attention_plain", plain_must_not_run)
    monkeypatch.setattr(pa, "paged_attention_plain", plain_must_not_run)
    with FakeTensorMode():
        q = torch.empty(1, 16, 4, 16, device="cuda")
        kv = torch.empty(1, 16, 2, 16, device="cuda")
        with pytest.raises(build.KernelBuildError):
            ops.flash_attention(q, kv, kv)
        pages = torch.empty(3, 8, 2, 16, device="cuda")
        table = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
        lengths = torch.ones(2, dtype=torch.int32, device="cuda")
        with pytest.raises(build.KernelBuildError):
            ops.paged_attention(torch.empty(2, 3, 4, 16, device="cuda"),
                                pages, pages, table, lengths, page_size=8,
                                start=torch.zeros(2, dtype=torch.int32,
                                                  device="cuda"))
    assert not any(ops.launch_counts().values())


def test_paged_attention_refuses_what_its_kernel_cannot_take(monkeypatch,
                                                             tmp_path):
    """The mode and dtype pick one paged kernel; a CUDA extend call that
    kernel cannot take raises before any library is built, and nothing
    else runs: bf16 extend needs a page size that is a multiple of 8 (and
    at most 64 query heads per kv-head); f32 extend takes any.  What they
    take reaches the library.  (Decode's refusal is a card test: a fake
    CUDA tensor cannot be indexed without CUDA.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import paged_attention as pa

    def no_nvcc():
        raise build.KernelBuildError("nvcc not found")

    def plain_must_not_run(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(pa, "paged_attention_plain", plain_must_not_run)
    ops.reset_launch_counts()
    with FakeTensorMode():
        def extend(H, KV, ps, dtype):
            pages = torch.empty(3, ps, KV, 16, device="cuda", dtype=dtype)
            return ops.paged_attention(
                torch.empty(2, 3, H, 16, device="cuda", dtype=dtype), pages,
                pages, torch.zeros(2, 2, dtype=torch.int32, device="cuda"),
                torch.ones(2, dtype=torch.int32, device="cuda"),
                page_size=ps,
                start=torch.zeros(2, dtype=torch.int32, device="cuda"))

        with pytest.raises(ValueError, match="multiple of 8"):
            extend(4, 2, 12, torch.bfloat16)
        with pytest.raises(ValueError, match="at most 64"):
            extend(130, 2, 8, torch.bfloat16)
        for args in ((4, 2, 12, torch.float32),    # f32 extend: FMA kernel
                     (130, 2, 12, torch.float32),
                     (34, 2, 8, torch.bfloat16)):  # 17 heads a kv-head
            with pytest.raises(build.KernelBuildError):
                extend(*args)
    assert not any(ops.launch_counts().values())


def test_moe_gmm_on_cuda_reaches_the_kernel_library_or_raises(monkeypatch,
                                                              tmp_path):
    """A CUDA tensor in ``moe_gmm`` goes to the kernel library, never to
    the plain version: with no compiler it raises the build error, and a
    shape, dtype or layout the kernel does not take raises before that."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import moe_gmm as gm

    def no_nvcc():
        raise build.KernelBuildError("nvcc not found")

    def plain_must_not_run(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(gm, "moe_gmm_plain", plain_must_not_run)
    ops.reset_launch_counts()
    with FakeTensorMode():
        x = torch.empty(4, 8, 32, device="cuda")
        w = torch.empty(4, 32, 16, device="cuda")
        gs = torch.zeros(4, dtype=torch.int32, device="cuda")
        with pytest.raises(build.KernelBuildError):
            ops.moe_gmm(x, w, gs)
        with pytest.raises(TypeError):
            ops.moe_gmm(x.half(), w.half(), gs)
        with pytest.raises(ValueError, match="int32"):
            ops.moe_gmm(x, w, gs.long())
        with pytest.raises(ValueError, match="does not match"):
            ops.moe_gmm(x, torch.empty(4, 16, 16, device="cuda"), gs)
        with pytest.raises(ValueError, match="contiguous"):
            ops.moe_gmm(torch.empty_strided((4, 8, 32), (256, 1, 8),
                                            device="cuda"), w, gs)
    assert ops.launch_counts()["moe_gmm"] == 0


def test_copied_routing_trace_bytes_match(tmp_path):
    """The port's copies of ``moe/trace.py`` and ``expert_skew.py`` give
    the JAX package's trace bytes, and each loads the other's file."""
    from repro.moe.trace import ExpertRoutingTrace as JaxTrace
    from repro.workload.expert_skew import SkewConfig as JaxSkew
    from repro.workload.expert_skew import synthesize_routing as jax_synth
    from repro_torch.moe import ExpertRoutingTrace
    from repro_torch.workload.expert_skew import (SkewConfig,
                                                  synthesize_routing)
    for i, kw in enumerate((dict(kind="zipf", zipf_a=1.4, period=128,
                                 seed=7),
                            dict(kind="uniform", period=64, seed=1),
                            dict(kind="correlated", period=32, seed=3))):
        j = jax_synth(3, 16, 2, JaxSkew(**kw), model="m")
        t = synthesize_routing(3, 16, 2, SkewConfig(**kw), model="m")
        assert t.to_json() == j.to_json()
        assert ExpertRoutingTrace.load(j.save(
            str(tmp_path / f"j{i}.json"))).to_json() == j.to_json()
        assert JaxTrace.load(t.save(
            str(tmp_path / f"t{i}.json"))).to_json() == t.to_json()


def test_cuda_call_the_kernel_does_not_take_raises():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import ops
    with FakeTensorMode():
        q = torch.empty(1, 16, 4, 24, device="cuda")       # head dim 24
        kv = torch.empty(1, 16, 2, 24, device="cuda")
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_attention(q, kv, kv)
        q = torch.empty(1, 16, 4, 16, device="cuda", dtype=torch.float16)
        kv = torch.empty(1, 16, 2, 16, device="cuda", dtype=torch.float16)
        with pytest.raises(TypeError):
            ops.flash_attention(q, kv, kv)


def _arch_names():
    from repro.configs import list_archs
    return list_archs()


def _port_only_at_defaults(port, jax_cfg, where):
    """The port's config has every field of the JAX package's, equal to
    it, and every field the JAX package lacks sits at its default."""
    jax_fields = {f.name for f in dataclasses.fields(jax_cfg)}
    port_fields = {f.name for f in dataclasses.fields(port)}
    assert jax_fields <= port_fields, (where, jax_fields - port_fields)
    for f in dataclasses.fields(port):
        value = getattr(port, f.name)
        if f.name not in jax_fields:
            assert value == f.default, (where, f.name, value)
            continue
        want = getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(value) and dataclasses.is_dataclass(want):
            _port_only_at_defaults(value, want, f"{where}.{f.name}")
        elif isinstance(value, tuple) and value and \
                dataclasses.is_dataclass(value[0]):
            assert len(value) == len(want), (where, f.name)
            for i, (v, w) in enumerate(zip(value, want)):
                _port_only_at_defaults(v, w, f"{where}.{f.name}[{i}]")
        else:
            assert value == want, (where, f.name, value, want)


@pytest.mark.parametrize("tiny", [False, True])
def test_copied_configs_match(tiny):
    """Every JAX architecture is registered in the port with every field
    the JAX config has equal, and the port's own fields at their defaults;
    the port's own architectures are named (``registry.PORT_ONLY``)."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config, list_archs
    from repro_torch.configs.registry import PORT_ONLY
    assert PORT_ONLY == ("trinity-mini",)
    assert sorted(_arch_names() + list(PORT_ONLY)) == list_archs()
    for name in _arch_names():
        n = name + "-tiny" if tiny else name
        _port_only_at_defaults(get_config(n), jax_get_config(n), n)


def test_copied_workload_generator_matches():
    from repro.workload import ShareGPTConfig as JaxCfg
    from repro.workload import generate as jax_generate
    from repro_torch.workload import ShareGPTConfig, generate

    def key(reqs):
        return [(r.req_id, r.arrival, list(r.prompt_tokens), r.output_len)
                for r in reqs]
    for seed in (0, 3):
        kw = dict(n_requests=12, rate=5.0, seed=seed, vocab=1000,
                  max_prompt=300)
        assert key(generate(ShareGPTConfig(**kw))) == \
            key(jax_generate(JaxCfg(**kw)))
