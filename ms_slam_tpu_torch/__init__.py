"""MS-SLAM on PyTorch and CUDA: the stereo visual main path of `ms_slam_tpu`,
with sliding-window sparsification and relocalization, ported to one NVIDIA
H100.

The JAX package `ms_slam_tpu` is the reference; this package mirrors its
module paths, public names, argument order and array layouts, and is held
against it by the parity tests in `tests/test_torch_*.py`. It never imports
`jax` or `ms_slam_tpu` (the JAX package's `__init__` imports jax), so it runs
on a machine that has only PyTorch.

Plain tensor code is PyTorch; the one TPU (Pallas) kernel on the path, the
keypoint patch gather, is a hand-written CUDA kernel
(`csrc/patch_gather.cu`, wrapper `ops.orb.extract_patches_canvas`).

Layer map:
  ops/       geometry, features, matching, pose and bundle adjustment, the
             sparsification selector, PnP
  models/    fixed-capacity map pools (MapState) + numpy state conversion,
             the BoW vocabulary and keyframe database
  pipeline/  frontend, tracking, local mapping, sparsification, loop
             closing, System
  parallel/  the global BA sharded over a mesh of devices (dist_ba)
  utils/     settings files, checkpoints, dataset readers, the native
             prefetch runtime, the viewer, rendered worlds, evaluation
  examples/  the CLI drivers (`python -m ms_slam_tpu_torch.examples.<name>`)
"""

__version__ = "0.1.0"

import torch as _torch

# The reference forces true f32 matmuls (ms_slam_tpu/__init__.py:28): the
# pose and BA normal equations diverge at reduced precision. TF32 keeps
# ~3 decimal digits, so it stays off for matmuls and convolutions alike.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
