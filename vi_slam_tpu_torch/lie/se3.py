"""SE(3) rigid transforms as (R, t) pairs — a PyTorch copy of the JAX
package's `lie/se3.py`.

`T = (R, t)` maps points by `R @ x + t`; camera poses are Tcw
(world -> camera). Tangent layout is [rho (translation), phi (rotation)].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vi_slam_tpu_torch.lie import so3


def _mv(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., 3, 3) x (..., 3) -> (..., 3)."""
    return (R @ x[..., None])[..., 0]


class SE3(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device="cpu") -> "SE3":
        R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone()
        t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
        return SE3(R, t)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Transform points (..., 3)."""
        return _mv(self.R, x) + self.t

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: (R1 R2, R1 t2 + t1)."""
        return SE3(self.R @ other.R, self.apply(other.t))

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -_mv(Rt, self.t))


def exp(xi: torch.Tensor) -> SE3:
    """Exponential map of xi = [rho, phi] (..., 6)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return SE3(so3.exp(phi), _mv(so3.left_jacobian(phi), rho))


def log(T: SE3) -> torch.Tensor:
    phi = so3.log(T.R)
    rho = _mv(so3.inverse_right_jacobian(-phi), T.t)
    return torch.cat([rho, phi], dim=-1)


def retract_left(T: SE3, xi: torch.Tensor) -> SE3:
    """exp(xi) ∘ T, the pose-optimization update."""
    dT = exp(xi)
    return SE3(so3.normalize(dT.R @ T.R), dT.apply(T.t))


def left_jacobian_inverse(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6, 6) inverse of SE(3)'s left Jacobian at xi = [rho, phi]:
    log(exp(d) exp(xi)) ~ xi + J^-1 d. Blocks [[Jl^-1, -Jl^-1 Q Jl^-1],
    [0, Jl^-1]] with Jl the SO(3) left Jacobian of phi and Q(rho, phi)
    its translational coupling (Taylor-guarded near zero)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    t2 = torch.sum(phi * phi, dim=-1)
    small = t2 < 1e-6
    s2 = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(s2)
    sn, cs = torch.sin(t), torch.cos(t)
    c1 = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - sn) / (s2 * t))
    c2 = torch.where(small, 1.0 / 24.0 - t2 / 720.0, (s2 + 2.0 * cs - 2.0) / (2.0 * s2 * s2))
    c3 = torch.where(small, 1.0 / 120.0 - t2 / 2520.0,
                     (2.0 * t - 3.0 * sn + t * cs) / (2.0 * s2 * s2 * t))
    P, Rh = so3.hat(phi), so3.hat(rho)
    PR, RP = P @ Rh, Rh @ P
    PRP = PR @ P
    Q = (0.5 * Rh + c1[..., None, None] * (PR + RP + PRP)
         + c2[..., None, None] * (P @ PR + RP @ P - 3.0 * PRP)
         + c3[..., None, None] * (PRP @ P + P @ PRP))
    Ji = so3.inverse_right_jacobian(-phi)
    out = torch.zeros((*xi.shape[:-1], 6, 6), dtype=xi.dtype, device=xi.device)
    out[..., :3, :3] = Ji
    out[..., 3:, 3:] = Ji
    out[..., :3, 3:] = -Ji @ Q @ Ji
    return out
