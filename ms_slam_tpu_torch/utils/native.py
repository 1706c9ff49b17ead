"""ctypes bindings and on-demand build of the native host runtime
(`csrc/msslam_runtime.cpp`): a threaded decode/rectify prefetch pipeline,
remap, and VmRSS telemetry.

Port of `ms_slam_tpu/utils/native.py` with one difference: the library is
built from the port's own copy of the source into
`ms_slam_tpu_torch/_build/libmsslam_runtime.so` by `ops._native.build`
(the kernels' build, with g++), never into the source tree. This is host
code, not a kernel: where `g++` or libpng/libjpeg is missing,
`available()` is False and the dataset readers decode with cv2 instead,
as in the reference.
"""
from __future__ import annotations

import ctypes
import os
from functools import lru_cache

import numpy as np

from ..ops import _native

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "msslam_runtime.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_LIB = os.path.join(BUILD_DIR, "libmsslam_runtime.so")


def _build() -> str:
    """Compile the runtime unless an up-to-date library exists; returns its
    path."""
    return _native.build(
        "msslam_runtime", src=_SRC, lib=_LIB, command=[
            "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"],
        libs=["-lpng", "-ljpeg", "-lz", "-lpthread"])


@lru_cache()
def _load():
    """(library, None), or (None, why it could not be built or loaded); the
    outcome is kept for the process, so a missing compiler costs one try."""
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, RuntimeError) as e:    # no g++, no libpng/libjpeg
        return None, e
    lib.msslam_pipeline_create.restype = ctypes.c_void_p
    lib.msslam_pipeline_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.msslam_pipeline_next.restype = ctypes.c_int
    lib.msslam_pipeline_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p]
    lib.msslam_pipeline_destroy.restype = None
    lib.msslam_pipeline_destroy.argtypes = [ctypes.c_void_p]
    lib.msslam_decode_gray.restype = ctypes.c_int
    lib.msslam_decode_gray.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int]
    lib.msslam_remap.restype = None
    lib.msslam_remap.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.msslam_vmrss_kb.restype = ctypes.c_long
    lib.msslam_vmrss_kb.argtypes = []
    return lib, None


def _lib():
    lib, err = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {err}") from err
    return lib


def available() -> bool:
    return _load()[0] is not None


def vmrss_mb() -> float:
    return _lib().msslam_vmrss_kb() / 1024.0


def decode_gray(path: str, w: int, h: int) -> np.ndarray:
    out = np.empty((h, w), np.uint8)
    rc = _lib().msslam_decode_gray(path.encode(),
                                   out.ctypes.data_as(ctypes.c_void_p), w, h)
    if rc != 0:
        raise IOError(f"decode failed: {path}")
    return out


def remap(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray):
    """Bilinear remap of a uint8 image by per-pixel source coordinates (0
    outside the image)."""
    src = np.ascontiguousarray(src, np.uint8)
    h, w = src.shape
    map_x = np.ascontiguousarray(map_x, np.float32)
    map_y = np.ascontiguousarray(map_y, np.float32)
    if map_x.shape != (h, w) or map_y.shape != (h, w):
        raise ValueError(f"maps {map_x.shape}, {map_y.shape} for an image "
                         f"of {(h, w)}")
    dst = np.empty_like(src)
    _lib().msslam_remap(src.ctypes.data_as(ctypes.c_void_p), w, h,
                        map_x.ctypes.data_as(ctypes.c_void_p),
                        map_y.ctypes.data_as(ctypes.c_void_p),
                        dst.ctypes.data_as(ctypes.c_void_p))
    return dst


class PrefetchPipeline:
    """In-order prefetching stereo/mono frame source backed by the native
    worker pool (decode and optional rectification off the tracking
    thread)."""

    def __init__(self, paths_l, paths_r=None, width=0, height=0,
                 depth=8, n_workers=4, rect_maps=None):
        self._h = None
        self.n = len(paths_l)
        self.w, self.h = width, height
        self.stereo = paths_r is not None
        if self.stereo and len(paths_r) != self.n:
            raise ValueError(f"{self.n} left and {len(paths_r)} right paths")
        self._pl = (ctypes.c_char_p * self.n)(
            *[p.encode() for p in paths_l])
        self._pr = None
        if self.stereo:
            self._pr = (ctypes.c_char_p * self.n)(
                *[p.encode() for p in paths_r])
        self._rm = None
        rm_arg = None
        if rect_maps is not None:
            self._rm = np.ascontiguousarray(rect_maps, np.float32)
            if self._rm.shape != (4, height, width):
                raise ValueError(f"rect_maps {self._rm.shape} != "
                                 f"{(4, height, width)}")
            rm_arg = self._rm.ctypes.data_as(ctypes.c_void_p)
        self._lib = _lib()          # kept for close() at interpreter exit
        self._h = self._lib.msslam_pipeline_create(
            self._pl, self._pr, self.n, width, height, depth, n_workers,
            rm_arg)
        self._i = 0

    def __len__(self):
        return self.n

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= self.n:
            raise StopIteration
        out_l = np.empty((self.h, self.w), np.uint8)
        out_r = np.empty((self.h, self.w), np.uint8) if self.stereo else None
        rc = self._lib.msslam_pipeline_next(
            self._h, out_l.ctypes.data_as(ctypes.c_void_p),
            out_r.ctypes.data_as(ctypes.c_void_p) if self.stereo else None)
        if rc != 0:
            raise StopIteration
        self._i += 1
        return (out_l, out_r) if self.stereo else out_l

    def close(self):
        if self._h:
            self._lib.msslam_pipeline_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
