"""Huber reweighting for iteratively reweighted Gauss-Newton — a PyTorch
copy of the JAX package's `optim/robust.py`."""

from __future__ import annotations

import math

import torch

CHI2_MONO = 5.991  # 95% chi2, 2 dof
CHI2_STEREO = 7.815  # 95% chi2, 3 dof


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """w = 1 for chi2 <= delta^2, delta / sqrt(chi2) beyond."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-18))
    delta = math.sqrt(delta2)
    return torch.where(chi2 <= delta2, torch.ones_like(e), delta / e)


def huber_rho(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """Huber cost rho(chi2), for the LM accept test."""
    delta = math.sqrt(delta2)
    e = torch.sqrt(torch.clamp(chi2, min=0.0))
    return torch.where(chi2 <= delta2, chi2, 2.0 * delta * e - delta2)
