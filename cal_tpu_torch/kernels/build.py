"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in ``cal_tpu_torch/csrc/`` becomes its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), compiled
for Hopper (``sm_90a``) into ``build/cal_tpu_torch_kernels/`` beside the
package.  ``build_all()`` starts one nvcc per source, all at once; ``load``
builds a single library on first use.  A library is rebuilt when its source
is newer.  Nothing here runs at import time, so machines without nvcc import
the package fine.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cal_tpu_torch_kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(SRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _paths(name: str) -> tuple[str, str]:
    return (os.path.join(SRC_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def _start(name: str) -> tuple[subprocess.Popen, str, str]:
    src, lib = _paths(name)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def build_all(names: list[str] | None = None) -> dict:
    """Compile every stale source in parallel; returns {name: {seconds,
    log}} for what was built (the log holds ptxas' register and shared
    memory report).  Raises on the first failed build."""
    names = sources() if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names if _stale(n)}
    report = {}
    for name, (proc, tmp, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, lib)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = _libs[name] = ctypes.CDLL(_paths(name)[1])
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
