"""Build and load the port's hand-written CUDA kernels.

Each source under ops/csrc/ compiles with nvcc, for Hopper (sm_90a), into a
shared library with a plain C interface that ctypes loads; no PyTorch
headers are involved, so a build takes seconds. Libraries land in
ops/_build/ (git-ignored) at first use and are rebuilt when the source is
newer. `build_all` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("flash_attention_fwd.cu",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build with the CUDA toolkit")
    return found


def _lib_path(source: str) -> str:
    return os.path.join(BUILD_DIR, "lib" + os.path.splitext(source)[0] + ".so")


def _stale(source: str) -> bool:
    so = _lib_path(source)
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(
        os.path.join(CSRC_DIR, source))


def _start(source: str, verbose: bool) -> tuple[subprocess.Popen, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = _lib_path(source) + f".{os.getpid()}.tmp"
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-o", tmp, os.path.join(CSRC_DIR, source)]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp


def _finish(source: str, proc: subprocess.Popen, tmp: str) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{out}")
    os.replace(tmp, _lib_path(source))  # atomic: a reader never sees half a library
    return out


def build_all(force: bool = False, verbose: bool = False) -> dict:
    """Compile every stale (or, with force, every) source concurrently.
    -> {source: {"seconds": wall time, "log": nvcc output}}."""
    t0 = time.perf_counter()
    jobs = {s: _start(s, verbose) for s in SOURCES if force or _stale(s)}
    report = {}
    for s, (proc, tmp) in jobs.items():
        log = _finish(s, proc, tmp)
        report[s] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        if _stale(source):
            _finish(source, *_start(source, verbose=False))
        lib = _LIBS[source] = ctypes.CDLL(_lib_path(source))
    return lib
