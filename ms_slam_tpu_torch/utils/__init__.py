"""Numpy-only host utilities of the reference, loaded by file path.

`ms_slam_tpu/utils/synth.py` (rendered test worlds) and
`ms_slam_tpu/utils/evaluate.py` (ATE) import only numpy, but importing
them as `ms_slam_tpu.utils.*` runs `ms_slam_tpu/__init__.py`, which imports
jax (ms_slam_tpu/__init__.py:22). This loader executes the two files
directly, so the port reuses them without jax and without a copy.
"""
from __future__ import annotations

import importlib.util
import os
import sys

_REF_UTILS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "ms_slam_tpu", "utils")


def _load(name: str):
    mod_name = f"ms_slam_tpu_torch.utils._ref_{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = os.path.join(_REF_UTILS, f"{name}.py")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def __getattr__(name):
    if name in ("synth", "evaluate"):
        return _load(name)
    raise AttributeError(name)
