"""Robust loss weights for iteratively reweighted Gauss-Newton.

Port of `ms_slam_tpu/ops/robust.py`: Huber (the kernel the pose and BA
solvers use), Cauchy and Tukey.
"""
from __future__ import annotations

import torch

# chi2 95% quantiles used as Huber deltas^2 / outlier gates
CHI2_2DOF = 5.991
CHI2_3DOF = 7.815


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight for Huber loss given squared error chi2 and delta^2."""
    chi2 = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / chi2))


def cauchy_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight for the Cauchy loss."""
    return 1.0 / (1.0 + chi2 / delta2)


def tukey_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight for Tukey's biweight: (1 - chi2/delta2)^2 inside, 0
    beyond."""
    r = chi2 / delta2
    return torch.where(r <= 1.0, (1.0 - r) ** 2, torch.zeros_like(r))
