"""Build and load the package's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface; it is compiled with
`nvcc` for Hopper (`sm_90a`) into `ms_slam_tpu_torch/_build/lib<name>.so`
at first use and loaded with ctypes; it is built again when it or a header
of `csrc/` that it includes is newer than the library. `-Xptxas -v` is on,
and what the compiler said (registers, shared memory, spills per kernel) is
kept in `build_log`. Nothing here runs at import: the CPU tests import
every module on a machine without `nvcc`.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()        # one build per library, whatever thread
build_log: dict[str, str] = {}      # name -> nvcc's output of this process's build


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def sources(name: str) -> list[str]:
    """csrc/<name>.cu and the headers of csrc/ it includes with `#include
    "..."`, and theirs, each once."""
    out = [os.path.join(_CSRC, f"{name}.cu")]
    for path in out:
        with open(path) as f:
            for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(),
                                  re.M):
                head = os.path.join(_CSRC, inc)
                if head not in out:
                    out.append(head)
    return out


def stale(lib: str, srcs: list[str]) -> bool:
    """True when lib is missing or older than any of srcs."""
    return not os.path.exists(lib) or os.path.getmtime(lib) < max(
        os.path.getmtime(s) for s in srcs)


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless an up-to-date library exists (newer
    than the source and every header it includes); returns the library
    path. The library is written under a temporary name and renamed, so a
    concurrent loader never sees a partial file."""
    src = os.path.join(_CSRC, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    if not stale(lib, sources(name)):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        build_log[name] = done.stdout + done.stderr
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{build_log[name]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built on first use (under a
    lock: a prefetch worker and the main thread may both be first)."""
    with _load_lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name))
        return _loaded[name]
