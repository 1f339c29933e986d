"""Batched two-view triangulation — a PyTorch copy of the JAX package's
`geometry/triangulate.py`.

The DLT system is solved as an inhomogeneous 3x3 least-squares problem
(w fixed to 1): the normal equations are inverted in closed form, so no
LAPACK call runs in the batch.
"""

from __future__ import annotations

import torch

from vi_slam_tpu_torch.lie.se3 import SE3


def _solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve through the adjugate (closed form)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    x = (c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]) * inv_det
    y = (c10 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]) * inv_det
    z = (c20 * b[..., 0] + c21 * b[..., 1] + c22 * b[..., 2]) * inv_det
    return torch.stack([x, y, z], dim=-1)


def triangulate_dlt(T1: SE3, T2: SE3, bearing1: torch.Tensor, bearing2: torch.Tensor
                    ) -> torch.Tensor:
    """World points (..., 3) from two world->camera poses and unit-depth
    bearings (..., 3) with z == 1."""

    def rows(T: SE3, bearing):
        R, t = T.R, T.t
        x = bearing[..., 0:1]
        y = bearing[..., 1:2]
        r0 = x * R[..., 2, :] - R[..., 0, :]
        r1 = y * R[..., 2, :] - R[..., 1, :]
        b0 = -(x[..., 0] * t[..., 2] - t[..., 0])
        b1 = -(y[..., 0] * t[..., 2] - t[..., 1])
        return r0, r1, b0, b1

    a0, a1, c0, c1 = rows(T1, bearing1)
    a2, a3, c2, c3 = rows(T2, bearing2)
    A = torch.stack([a0, a1, a2, a3], dim=-2)  # (..., 4, 3)
    b = torch.stack([c0, c1, c2, c3], dim=-1)  # (..., 4)
    AtA = A.transpose(-1, -2) @ A
    Atb = (A.transpose(-1, -2) @ b[..., None])[..., 0]
    return _solve3x3(AtA, Atb)


def parallax_cos(T1: SE3, T2: SE3, xw: torch.Tensor) -> torch.Tensor:
    """Cosine of the parallax angle between the two rays to each point."""
    r1 = xw - T1.inverse().t
    r2 = xw - T2.inverse().t
    n1 = torch.sqrt(torch.sum(r1 * r1, dim=-1))
    n2 = torch.sqrt(torch.sum(r2 * r2, dim=-1))
    return torch.sum(r1 * r2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)


def depths(T: SE3, xw: torch.Tensor) -> torch.Tensor:
    """z-depth of world points in the camera frame of T."""
    return T.apply(xw)[..., 2]
