"""SO(3): hat/vee, exp/log, Jacobians — a PyTorch copy of the JAX
package's `lie/so3.py`, batched over leading dims.

Conventions: rotation matrices act on column vectors; tangent vectors are
in the body frame for the right-Jacobian formulas.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(M: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)


def _sin_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3),
    Taylor-guarded near zero; theta2 = |w|^2."""
    small = theta2 < _EPS
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (t - torch.sin(t)) / (t2 * t))
    return A, B, C


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: tangent (..., 3) -> rotation matrix (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sin_coeffs(theta2)
    W = hat(w)
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def log(R: torch.Tensor) -> torch.Tensor:
    """Log map (..., 3, 3) -> (..., 3), stable up to theta < pi, with the
    near-pi branch of the reference."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    small = cos_theta > 1.0 - 1e-4
    cos_safe = torch.clamp(cos_theta, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_safe)
    w_vee = vee(R - R.transpose(-1, -2)) * 0.5
    sin_theta = torch.sin(theta)
    near_pi = cos_theta < -1.0 + 2e-6
    theta_pi = math.pi - torch.sqrt(torch.clamp(2.0 * (1.0 + cos_theta), min=0.0))
    theta = torch.where(near_pi, theta_pi, theta)
    safe_sin = torch.where(small | near_pi, torch.ones_like(sin_theta), sin_theta)
    c = 1.0 - cos_theta
    scale_small = 1.0 + c / 3.0 + 7.0 * c * c / 90.0
    scale = torch.where(small, scale_small, theta / safe_sin)
    w_generic = w_vee * scale[..., None]
    Bm = (R + R.transpose(-1, -2)) * 0.5
    diag = torch.stack([Bm[..., 0, 0], Bm[..., 1, 1], Bm[..., 2, 2]], dim=-1)
    axis2 = torch.clamp(
        (diag - cos_theta[..., None])
        / torch.clamp(1.0 - cos_theta[..., None], min=1e-12),
        0.0,
        1.0,
    )
    axis_abs = torch.sqrt(axis2)
    s01, s02, s12 = Bm[..., 0, 1], Bm[..., 0, 2], Bm[..., 1, 2]
    one = torch.ones_like(axis_abs[..., 0])

    def sgn(x):
        return torch.where(x >= 0, one, -one)

    ax_x = torch.stack([one, sgn(s01), sgn(s02)], dim=-1)
    ax_y = torch.stack([sgn(s01), one, sgn(s12)], dim=-1)
    ax_z = torch.stack([sgn(s02), sgn(s12), one], dim=-1)
    anchor = torch.argmax(axis_abs, dim=-1)
    signs = torch.where(
        (anchor == 0)[..., None], ax_x,
        torch.where((anchor == 1)[..., None], ax_y, ax_z),
    )
    axis = axis_abs * signs
    flip = torch.sum(axis * w_vee, dim=-1) < 0
    axis = torch.where(flip[..., None], -axis, axis)
    w_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """J_l(w): exp(w + dw) ~ exp(J_l dw) exp(w)."""
    theta2 = torch.sum(w * w, dim=-1)
    _, B, C = _sin_coeffs(theta2)
    W = hat(w)
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """J_r(w) = J_l(-w)."""
    return left_jacobian(-w)


def inverse_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of the right Jacobian."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    k = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / t2 - (1.0 + torch.cos(t)) / (2.0 * t * torch.sin(t)),
    )
    W = hat(w)
    return _eye_like(W) + 0.5 * W + k[..., None, None] * (W @ W)


def normalize(R: torch.Tensor) -> torch.Tensor:
    """One Newton step of symmetric orthogonalization, R (3I - R^T R) / 2."""
    RtR = R.transpose(-1, -2) @ R
    return R @ (1.5 * _eye_like(R) - 0.5 * RtR)
