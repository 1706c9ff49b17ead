"""Batched 256-bit Hamming distance.

Port of `ms_slam_tpu/ops/hamming.py`. Descriptors are (N,8) int32 tensors
holding the same bits as the reference's uint32 words (torch's CUDA
support for uint32 bitwise ops is thin). The all-pairs distance is a ±1
f32 matmul: <da, db> = 256 - 2*hamming(a, b), exact in f32 for 256 bits
with TF32 off (set in the package `__init__`).
"""
from __future__ import annotations

import torch

N_BITS = 256


def _shifts(device):
    return torch.arange(32, dtype=torch.int32, device=device)


def unpack_pm1(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N,8) int32 -> (N,256) ±1 in `dtype` (bit=1 -> +1, bit=0 -> -1).
    The arithmetic shift of a negative word only smears the sign into the
    high bits, which `& 1` discards."""
    n = packed.shape[0]
    bits = (packed[:, :, None] >> _shifts(packed.device)) & 1
    return (2 * bits.reshape(n, N_BITS) - 1).to(dtype)


def hamming_matrix(packed_a: torch.Tensor, packed_b: torch.Tensor) -> torch.Tensor:
    """(N,8),(M,8) int32 -> (N,M) int32 Hamming distances."""
    dot = unpack_pm1(packed_a) @ unpack_pm1(packed_b).T
    return ((N_BITS - dot) * 0.5).to(torch.int32)


def hamming_pop(packed_a: torch.Tensor, packed_b: torch.Tensor) -> torch.Tensor:
    """Aligned rows: (...,8),(...,8) -> (...,) int32."""
    x = torch.bitwise_xor(packed_a, packed_b)
    bits = (x[..., None] >> _shifts(x.device)) & 1
    return bits.sum(dim=(-1, -2)).to(torch.int32)
