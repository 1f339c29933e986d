"""Epipolar geometry — a PyTorch copy of the JAX package's
`geometry/epipolar.py`: essential and fundamental matrices from poses,
point-to-epiline and Sampson distances."""

from __future__ import annotations

import torch

from vi_slam_tpu_torch.lie import so3
from vi_slam_tpu_torch.lie.se3 import SE3


def essential_from_relative(T12: SE3) -> torch.Tensor:
    """E = [t]_x R for the transform taking frame-2 coordinates to
    frame-1 coordinates."""
    return so3.hat(T12.t) @ T12.R


def _inv3(K: torch.Tensor) -> torch.Tensor:
    # inv_ex: no error check, so no host sync on the card
    return torch.linalg.inv_ex(K)[0]


def fundamental_from_poses(T1w: SE3, T2w: SE3, K1: torch.Tensor, K2: torch.Tensor
                           ) -> torch.Tensor:
    """F12 with x1^T F12 x2 = 0 for pixel correspondences."""
    E = essential_from_relative(T1w.compose(T2w.inverse()))
    return _inv3(K1).transpose(-1, -2) @ E @ _inv3(K2)


def _homog(uv: torch.Tensor) -> torch.Tensor:
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


def epiline_distance_sq(F12: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor
                        ) -> torch.Tensor:
    """Squared distance from x1 to the epipolar line of x2 (broadcast
    pairwise for (N, 1, 2) and (1, M, 2) inputs)."""
    x1, x2 = _homog(uv1), _homog(uv2)
    line = torch.einsum("ij,...j->...i", F12, x2)
    num = torch.sum(x1 * line, dim=-1) ** 2
    den = line[..., 0] ** 2 + line[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def sampson_distance_sq(F: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor
                        ) -> torch.Tensor:
    """First-order geometric (Sampson) error of each correspondence."""
    x1, x2 = _homog(uv1), _homog(uv2)
    Fx2 = torch.einsum("ij,...j->...i", F, x2)
    Ftx1 = torch.einsum("ji,...j->...i", F, x1)
    num = torch.sum(x1 * Fx2, dim=-1) ** 2
    den = Fx2[..., 0] ** 2 + Fx2[..., 1] ** 2 + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)
