"""Sim(3) similarity transforms (R, t, s) — a PyTorch copy of the JAX
package's `lie/sim3.py`, batched over leading dims.

A Sim3 maps x -> s * R @ x + t. Tangent layout: [rho (3), phi (3),
sigma (1)] with sigma = log-scale. Loop corrections are solved over Sim3
(monocular scale drift) or over its SE3 subgroup (stereo).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vi_slam_tpu_torch.lie import so3

_EPS = 1e-8


def _mv(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (R @ x[..., None])[..., 0]


class Sim3(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)
    s: torch.Tensor  # (...,)

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device="cpu") -> "Sim3":
        return Sim3(
            torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone(),
            torch.zeros((*batch_shape, 3), dtype=dtype, device=device),
            torch.ones(batch_shape, dtype=dtype, device=device),
        )

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.s[..., None] * _mv(self.R, x) + self.t

    def compose(self, other: "Sim3") -> "Sim3":
        return Sim3(self.R @ other.R, self.apply(other.t), self.s * other.s)

    def inverse(self) -> "Sim3":
        Rt = self.R.transpose(-1, -2)
        s_inv = 1.0 / self.s
        return Sim3(Rt, -s_inv[..., None] * _mv(Rt, self.t), s_inv)

    def index(self, i) -> "Sim3":
        """The transforms at batch index (or index tensor) `i`."""
        return Sim3(self.R[i], self.t[i], self.s[i])


def exp(xi: torch.Tensor) -> Sim3:
    """Sim(3) exponential of xi = [rho, phi, sigma] (..., 7)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    W = _sim3_V(phi, sigma)
    return Sim3(so3.exp(phi), _mv(W, rho), torch.exp(sigma))


def log(S: Sim3) -> torch.Tensor:
    phi = so3.log(S.R)
    sigma = torch.log(S.s)
    Winv = torch.linalg.inv_ex(_sim3_V(phi, sigma))[0]  # no host sync for the check
    rho = _mv(Winv, S.t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def _sim3_V(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The W matrix coupling translation with rotation and scale in the
    Sim3 exponential (closed form with the reference's small-angle and
    small-sigma branches)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    s = torch.exp(sigma)
    W_hat = so3.hat(phi)
    W2 = W_hat @ W_hat
    I = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W_hat.shape)
    one = torch.ones_like(sigma)

    sigma_small = torch.abs(sigma) < 1e-5
    theta_small = theta2 < _EPS
    sg = torch.where(sigma_small, one, sigma)
    th = torch.where(theta_small, torch.ones_like(theta), theta)

    A = torch.where(sigma_small, 1.0 + 0.5 * sigma, (s - 1.0) / sg)
    sin_t, cos_t = torch.sin(th), torch.cos(th)
    denom = sg * sg + th * th
    a_gen = (s * sin_t * sg + (1.0 - s * cos_t) * th) / (th * denom)
    b_gen = (A - ((s * cos_t - 1.0) * sg + s * sin_t * th) / denom) / torch.where(
        theta_small, torch.ones_like(theta2), theta2
    )
    a_sig0 = torch.where(theta_small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / (th * th))
    b_sig0 = torch.where(theta_small, 1.0 / 6.0 - theta2 / 120.0, (th - sin_t) / (th * th * th))
    a_th0 = torch.where(
        sigma_small, 0.5 + sigma / 6.0,
        ((sg - 1.0) * s + 1.0) / torch.where(sigma_small, one, sg * sg),
    )
    b_th0 = torch.where(
        sigma_small, 1.0 / 6.0 + sigma / 24.0,
        (s * (0.5 * sg * sg - sg + 1.0) - 1.0) / torch.where(sigma_small, one, sg * sg * sg),
    )
    a = torch.where(sigma_small, a_sig0, torch.where(theta_small, a_th0, a_gen))
    b = torch.where(sigma_small, b_sig0, torch.where(theta_small, b_th0, b_gen))
    return A[..., None, None] * I + a[..., None, None] * W_hat + b[..., None, None] * W2
