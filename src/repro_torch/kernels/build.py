"""Build the CUDA kernels with ``nvcc`` into shared libraries and load them
with ctypes.

Each ``csrc/<name>.cu`` becomes ``lib<name>.so`` under
``build/repro_torch_kernels/<hash>/`` at the repository root, where the hash
covers every source in ``csrc/`` and the compiler flags: an edit rebuilds,
an unchanged tree reuses what is there.  ``build_all`` starts one ``nvcc``
per source at once and waits for all of them.  The libraries have a plain
C interface (no PyTorch headers), so a build takes seconds.  The
tensor-core kernels find libcuda's TMA descriptor encoder with
``dlsym`` at run time, so nothing links against libcuda (``-ldl`` only).
Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
SOURCES = ("flash_attention", "flash_attention_bwd", "paged_attention",
           "moe_gmm", "rope")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-ldl",)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME, "
                           "/usr/local/cuda): the CUDA kernels cannot be "
                           "built on this machine")


def build_all() -> Dict[str, Path]:
    """Compile every missing library in parallel; return name -> path.
    The compiler's report (``-Xptxas -v``) is kept as ``<name>.log``."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {name: out / f"lib{name}.so" for name in SOURCES}
    todo = [n for n in SOURCES if not paths[n].is_file()]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu"), *LINK_FLAGS]
        log = open(out / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), log, tmp)
    failed = []
    for name, (proc, log, tmp) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, paths[name])   # atomic: readers never see half
    if failed:
        logs = "\n".join((out / f"{n}.log").read_text() for n in failed)
        raise KernelBuildError(f"nvcc failed for {failed}:\n{logs}")
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build_all()[name]))
        return lib
