"""The least time the card could take for the patch-gather kernel
(`ms_slam_tpu_torch/csrc/patch_gather.cu`), counted as `chip_smoke.py`'s
phase 3 counts it: every input byte read once and the output written once,
at the H100's HBM bandwidth (the kernel does no arithmetic, so bytes bound
it). The count depends only on the call's shapes, whatever implements the
gather."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W limit
H100_HBM_BYTES_PER_S = 3.35e12

PATCH = 45                      # (2 * 22 + 1) raw patch side, float32 out


def patch_gather_bytes(canvas_shape, canvas_itemsize: int,
                       n_keypoints: int) -> int:
    """Bytes of one call: the (B, H, Wc) canvas in its own type, three int32
    index vectors of n, and the (n, 45, 45) float32 patches written."""
    B, H, Wc = canvas_shape
    return (canvas_itemsize * B * H * Wc + 4 * 3 * n_keypoints
            + 4 * n_keypoints * PATCH * PATCH)


def bound_seconds(n_bytes: int) -> float:
    return n_bytes / H100_HBM_BYTES_PER_S
