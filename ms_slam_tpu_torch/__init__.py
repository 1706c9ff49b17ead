"""MS-SLAM on PyTorch and CUDA: the stereo visual main path of `ms_slam_tpu`
ported to one NVIDIA H100.

The JAX package `ms_slam_tpu` is the reference; this package mirrors its
module paths, public names, argument order and array layouts, and is held
against it by the parity tests in `tests/test_torch_*.py`. It never imports
`jax` or `ms_slam_tpu` (the JAX package's `__init__` imports jax), so it runs
on a machine that has only PyTorch.

Plain tensor code is PyTorch; the one TPU (Pallas) kernel on the path, the
keypoint patch gather, is a hand-written CUDA kernel
(`csrc/patch_gather.cu`, wrapper `ops.orb.extract_patches_canvas`).

Layer map:
  ops/       geometry, features, matching, pose and bundle adjustment
  models/    fixed-capacity map pools (MapState) + numpy state conversion
  pipeline/  frontend, tracking, local mapping, System facade
  utils/     by-path loader for the reference's numpy-only utilities
"""

__version__ = "0.1.0"

import torch as _torch

# The reference forces true f32 matmuls (ms_slam_tpu/__init__.py:28): the
# pose and BA normal equations diverge at reduced precision. TF32 keeps
# ~3 decimal digits, so it stays off for matmuls and convolutions alike.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
