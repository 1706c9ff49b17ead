"""Build, load and bind the package's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface; it is compiled with
`nvcc` for Hopper (`sm_90a`) into `ms_slam_tpu_torch/_build/lib<name>.so`
at first use and loaded with ctypes; it is built again when it or a header
of `csrc/` that it includes is newer than the library. `-Xptxas -v` is on,
and what the compiler said (registers, shared memory, spills per kernel) is
kept in `build_log`. `build` also compiles the host runtime with g++.

An `Entry` binds one `extern "C" int` entry point by the parameter names
of its C declaration, checks each tensor against its C type, launches and
counts the launch in `calls`; `takes_plain` is the wrappers' device rule.
Nothing here runs at import: the CPU tests import every module on a
machine without `nvcc`.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import os
import re
import shutil
import subprocess
import tempfile
import threading

import torch

from ..utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()        # one build per library, whatever thread
build_log: dict[str, str] = {}      # name -> compiler output of this process

# an entry point's name -> its launches; a wrapper's name -> the calls that
# took its plain version. One lock: a prefetch worker thread and the main
# thread may launch at once.
calls: collections.Counter = collections.Counter()
_calls_lock = threading.Lock()


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


def build(name: str, *, src: str | None = None, lib: str | None = None,
          command=None, libs=()) -> str:
    """Compile csrc/<name>.cu with nvcc (or `src` with `command`, the
    compiler and its flags, and the link line's `libs`) into
    _build/lib<name>.so (or `lib`) unless the library is newer than the
    source and every header it includes; returns its path. It is written
    under a temporary name and renamed, so a concurrent loader never sees
    a partial file."""
    srcs = sources(name) if src is None else [src]
    lib = lib or os.path.join(BUILD_DIR, f"lib{name}.so")
    if not stale(lib, srcs):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib))
    os.close(fd)
    try:
        command = command or [_nvcc(), *NVCC_FLAGS]
        done = subprocess.run([*command, "-o", tmp, srcs[0], *libs],
                              capture_output=True, text=True)
        build_log[name] = done.stdout + done.stderr
        if done.returncode != 0:
            raise RuntimeError(f"{command[0]} failed on {srcs[0]}:\n"
                               f"{build_log[name]}")
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


def count(key: str) -> None:
    with _calls_lock:
        calls[key] += 1


def takes_plain(device: torch.device, wrapper: str, what: str = "") -> bool:
    """The hand kernels' device rule: True for a CPU device (the wrapper
    takes its plain version, counted under its name), False for a CUDA one
    (it launches the kernel); raises ValueError naming `what` otherwise."""
    if device.type == "cpu":
        count(wrapper)
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"no {what or wrapper} for device {device}")


# C type -> the dtype a pointer takes or a scalar's ctypes type
_TYPES = {"float*": torch.float32, "__nv_bfloat16*": torch.bfloat16,
          "int*": torch.int32, "uint8_t*": torch.bool,
          "int": ctypes.c_int, "float": ctypes.c_float}


def signature(path: str, entry: str) -> tuple[tuple[str, str], ...]:
    """(C type, name) of each parameter of `extern "C" int <entry>(...)` in
    the source at path; a type not in `_TYPES` but `void* stream` raises."""
    with open(path) as f:
        src = f.read()
    m = re.search(rf'extern\s+"C"\s+int\s+{entry}\s*\(([^)]*)\)', src)
    if m is None:
        raise ValueError(f'no extern "C" int {entry}(...) in {path}')
    params = []
    for p in filter(None, (p.strip() for p in m.group(1).split(","))):
        d = re.fullmatch(r"(?:const\s+)?(\w+)\s*(\*?)\s*(\w+)", p)
        typed = d and (d[1] + d[2], d[3])
        if not d or (typed[0] not in _TYPES and typed != ("void*", "stream")):
            raise ValueError(f"{entry}: no binding for `{p}` (takes "
                             f"{sorted(_TYPES)} and void* stream)")
        params.append(typed)
    return tuple(params)


class Entry:
    """The entry point `name` of csrc/<lib>.cu, its parameters read from
    its C declaration at first use. `optional` names the pointers that may
    be None (null); every other parameter but the stream must be given."""

    def __init__(self, lib: str, name: str, optional=()):
        self.lib, self.name = lib, name
        self.optional = frozenset(optional)
        self._fn = None

    @functools.cached_property
    def params(self) -> tuple[tuple[str, str], ...]:
        return signature(os.path.join(_CSRC, f"{self.lib}.cu"), self.name)

    @functools.cached_property
    def _plan(self) -> tuple:
        """(name, dtype or ctypes type or None for the stream, whether it is
        a tensor) of each parameter, and the names a call gives."""
        plan = tuple((name, _TYPES.get(ctype), ctype in _TYPES
                      and ctype.endswith("*")) for ctype, name in self.params)
        return plan, frozenset(n for n, kind, _ in plan if kind is not None)

    def bind(self, fn):
        """fn (a ctypes function of this C interface) with its argtypes and
        restype set from the declaration."""
        fn.argtypes = [ctypes.c_void_p if t.endswith("*") else _TYPES[t]
                       for t, _ in self.params]
        fn.restype = ctypes.c_int
        return fn

    def fn(self):
        """The bound entry point, its library built and loaded on first use
        (a System on the card calls it in its set-up, not in a frame)."""
        if self._fn is None:
            self._fn = self.bind(getattr(load(self.lib), self.name))
        return self._fn

    def args(self, device: torch.device, /, **given) -> tuple:
        """The C arguments in declaration order. A pointer takes an input
        as (tensor, shape), which must be contiguous, of its C type's
        dtype and that shape on `device`, or a tensor the wrapper allocated
        (its dtype is checked); a scalar is converted to its C type (an int
        must fit one). Raises ValueError naming the parameter. The tuple
        holds addresses only: the caller keeps the tensors alive."""
        plan, names = self._plan
        if given.keys() != names:
            raise TypeError(f"{self.name} takes {sorted(names)}, got "
                            f"{sorted(given)}")
        out = []
        for name, kind, tensor in plan:
            v = given.get(name)
            if tensor:
                if v.__class__ is tuple:
                    t, shape = v
                    if t.dtype != kind or t.device != device \
                            or not t.is_contiguous() or t.shape != shape:
                        raise ValueError(
                            f"{name} must be a contiguous {shape} {kind} "
                            f"tensor on {device}, got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
                    out.append(t.data_ptr())
                elif v is not None:
                    if v.dtype != kind:
                        raise ValueError(f"{name} must be {kind}: {v.dtype}")
                    out.append(v.data_ptr())
                elif name in self.optional:
                    out.append(None)
                else:
                    raise ValueError(f"{name} must be a tensor: "
                                     f"{self.name} takes no null {name}")
            elif kind is ctypes.c_int:
                v = int(v)
                if not -2 ** 31 <= v < 2 ** 31:
                    raise ValueError(f"{name} must fit a C int, got {v}")
                out.append(v)
            elif kind is ctypes.c_float:
                out.append(float(v))
            else:
                out.append(torch.cuda.current_stream(device).cuda_stream
                           if device.type == "cuda" else None)
        return tuple(out)

    def __call__(self, device: torch.device, /, timing=None, span=None,
                 **given) -> None:
        """Check the arguments (`args`), launch on `device`'s current
        stream and count the launch; given a `Timing`, the launch is the
        span `span`. Raises RuntimeError on a CUDA error."""
        args = self.args(device, **given)
        fn = self.fn()
        with trace.span(timing, span):
            rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {rc}")
        count(self.name)
