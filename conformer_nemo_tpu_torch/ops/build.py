"""Build and load the port's hand-written CUDA kernels.

Each source under ops/csrc/ compiles with nvcc, for Hopper (sm_90a), into a
shared library with a plain C interface that ctypes loads; no PyTorch
headers are involved, so a build takes seconds. Libraries land in
ops/_build/ (git-ignored) at first use and are rebuilt when the source (or
a shared header in csrc/) is newer. `build_all` starts one nvcc per source,
all at once.

Each kernel wrapper counts its launches in a `LaunchCount` registered here
under the kernel's name, so a caller can show that a path went through the
kernels (`launch_counts`, `reset_launch_counts`).

The host libraries (data/csrc/: the FLAC decoder, the Ogg/Vorbis and
Ogg/Opus shims, the CTC beam decoder with its KenLM readers, and the edit
distance) build here too, with the host compiler, into the same directory
(`host_library`, `build_host_all`), and are rebuilt when the source or one
of the headers it includes is newer. A shim links against the system codec library by
full path, so no development headers are needed; a missing system library
raises, naming it, when the shim is first asked for. A failed build raises
with the compiler's output; nothing remembers a failure.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "flash_attention_f32.cu",
           "ctc_loss.cu", "rnnt_lattice.cu", "rnnt_joint.cu", "rnnt_joint_f32.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper

_LIBS: dict[str, ctypes.CDLL] = {}


class LaunchCount:
    """Launches of one kernel: the total and per shape key (under a lock:
    a model may run in several threads at once)."""

    def __init__(self, name: str):
        self.name = name
        self.total = 0
        self.by_shape: dict[tuple, int] = {}
        self._lock = threading.Lock()

    def add(self, shape: tuple) -> None:
        with self._lock:
            self.total += 1
            self.by_shape[shape] = self.by_shape.get(shape, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.total = 0
            self.by_shape.clear()


_COUNTS: dict[str, LaunchCount] = {}


def launch_count(name: str) -> LaunchCount:
    """The registered counter of kernel `name` (created at first use)."""
    return _COUNTS.setdefault(name, LaunchCount(name))


def launch_counts() -> dict[str, int]:
    """{kernel name: launches since the last reset}."""
    return {name: c.total for name, c in _COUNTS.items()}


def reset_launch_counts() -> None:
    for c in _COUNTS.values():
        c.reset()


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
    if not os.path.exists(so):
        return True
    deps = [source] + [f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")]
    return os.path.getmtime(so) < max(os.path.getmtime(os.path.join(CSRC_DIR, f)) for f in deps)


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


HOST_CSRC_DIR = os.path.join(os.path.dirname(_HERE), "data", "csrc")
# host library -> (source in data/csrc, compiler and flags, system libraries it
# links, the headers in data/csrc it includes)
HOST_LIBS = {
    "flac_decoder": ("flac_decoder.cpp", ("g++", "-O3", "-std=c++17"), (), ()),
    "ogg_mem": ("ogg_mem.c", ("gcc", "-O2"), ("libvorbisfile",), ()),
    "opus_mem": ("opus_mem.c", ("gcc", "-O2"), ("libopus", "libogg"), ()),
    "ctc_beam": ("ctc_beam.cpp", ("g++", "-O3", "-std=c++17"), (),
                 ("kenlm_probing.h", "kenlm_trie.h")),
    "edit_distance": ("edit_distance.cpp", ("g++", "-O3", "-std=c++17"), (), ()),
}
_SYSTEM_LIB_DIRS = ("/usr/lib/x86_64-linux-gnu", "/lib/x86_64-linux-gnu", "/usr/lib64", "/lib64",
                    "/usr/lib", "/usr/local/lib")
# loader worker threads reach a library's first build at once: one build at a time
_HOST_LOCK = threading.Lock()
_HOST_LIBS: dict[str, ctypes.CDLL] = {}


class MissingSystemLibrary(RuntimeError):
    """A system codec library that a host library links against is absent."""


def find_system_library(stem: str) -> str | None:
    """Full path of a versioned runtime library (`stem`.so*), or None; hosts
    often ship no unversioned development symlink."""
    for d in _SYSTEM_LIB_DIRS:
        hits = sorted(glob.glob(os.path.join(d, f"{stem}.so*")))
        if hits:
            return hits[0]
    return None


def _host_lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _build_host(name: str, force: bool) -> bool:
    """Compile host library `name` if stale (or forced); -> whether it
    compiled. Raises MissingSystemLibrary, or RuntimeError with the
    compiler's output."""
    source, compiler, stems, headers = HOST_LIBS[name]
    deps = [(stem, find_system_library(stem)) for stem in stems]
    missing = [stem for stem, path in deps if path is None]
    if missing:
        raise MissingSystemLibrary(
            f"{name} needs the system librar{'ies' if len(missing) > 1 else 'y'} "
            f"{', '.join(missing)}, which this host does not have")
    src, so = os.path.join(HOST_CSRC_DIR, source), _host_lib_path(name)
    newest = max(os.path.getmtime(os.path.join(HOST_CSRC_DIR, f)) for f in (source, *headers))
    if not force and os.path.exists(so) and os.path.getmtime(so) >= newest:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([*compiler, "-shared", "-fPIC", src, *[p for _, p in deps],
                               "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler[0]} failed for {source}:\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: another process never loads half a library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return True


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library `name` (a key of HOST_LIBS), built first if needed."""
    with _HOST_LOCK:
        lib = _HOST_LIBS.get(name)
        if lib is None:
            _build_host(name, force=False)
            lib = _HOST_LIBS[name] = ctypes.CDLL(_host_lib_path(name))
        return lib


def build_host_all(force: bool = False) -> dict:
    """Compile every host library. -> {name: {"seconds"} or {"missing": message}}
    (a host without a codec's system library still builds the others)."""
    report = {}
    with _HOST_LOCK:
        for name in HOST_LIBS:
            t0 = time.perf_counter()
            try:
                _build_host(name, force)
            except MissingSystemLibrary as e:
                report[name] = {"missing": str(e)}
                continue
            report[name] = {"seconds": time.perf_counter() - t0}
    return report
