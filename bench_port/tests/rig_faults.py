"""The fault of the TUM-VI walk cell, beside `faults.py`'s: "right rows
off" gives every frame of an unrectified pair no right keypoint (its
`FrameData.right` all -1), so that no keyframe stores one and no solver has
a right-camera row: the program as it was before the right camera became a
factor, whose map loses its scale. Importing this module adds it to
`faults.FAULTS`, so that `faults.plant` takes it by name;
`read_rig_faults.py` plants it for a whole run. A run of the benchmark
never loads this module.
"""
from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import faults  # noqa: E402


def _right_rows_off(setattr):
    """Every stereo-fisheye frame comes back with its right keypoints at
    -1 (the frontend's matching, depths and gates as they were)."""
    from ms_slam_tpu_torch.pipeline import system
    orig = system.process_stereo_fisheye

    def no_right(*a, **k):
        fr = orig(*a, **k)
        return fr._replace(right=torch.full_like(fr.right, -1.0))

    setattr(system, "process_stereo_fisheye", no_right)


faults.FAULTS["right_rows_off"] = _right_rows_off
