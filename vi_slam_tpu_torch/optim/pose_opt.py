"""Motion-only pose optimization — a PyTorch copy of the JAX package's
`optim/pose_opt.py::pose_optimize`: `rounds` rounds of `iters` Gauss-Newton
steps over one SE3 pose against fixed world points, Huber weights in the
first rounds, chi2 re-classification of inliers after every round."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from vi_slam_tpu_torch.cameras import pinhole
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.lie import se3, so3
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.optim import robust


class PoseObs(NamedTuple):
    """Fixed-capacity reprojection observations of one frame.

    xw: (N, 3) world points; uvr: (N, 3) measured (u, v, u_right);
    stereo: (N,) bool, third row active; sigma2: (N,) variance;
    valid: (N,) bool.
    """

    xw: torch.Tensor
    uvr: torch.Tensor
    stereo: torch.Tensor
    sigma2: torch.Tensor
    valid: torch.Tensor


def _residual_jac(cam: CameraParams, T: SE3, obs: PoseObs):
    """Residuals (N, 3), Jacobians wrt the left-perturbation tangent
    (N, 3, 6) and per-row masks (N, 3)."""
    pc = T.apply(obs.xw)
    r = pinhole.stereo_project(cam, pc) - obs.uvr
    Jpc = pinhole.stereo_project_jac(cam, pc)
    I = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*pc.shape[:-1], 3, 3)
    J = Jpc @ torch.cat([I, -so3.hat(pc)], dim=-1)
    row_mask = torch.stack(
        [obs.valid, obs.valid, obs.valid & obs.stereo], dim=-1
    ).to(r.dtype)
    behind = pc[..., 2] < 0.05
    row_mask = row_mask * (~behind[..., None]).to(r.dtype)
    return r, J, row_mask


def _chi2(r: torch.Tensor, row_mask: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    return torch.sum(r * r * row_mask, dim=-1) / sigma2


def pose_optimize(cam: CameraParams, T_init: SE3, obs: PoseObs, rounds: int = 4,
                  iters: int = 10, use_huber_rounds: int = 2
                  ) -> Tuple[SE3, torch.Tensor, torch.Tensor]:
    """Returns (T_opt, inlier mask, number of inliers). Runs without a
    host sync: a step whose update is not finite is dropped on the
    device."""
    chi2_th = torch.where(
        obs.stereo, torch.full_like(obs.sigma2, robust.CHI2_STEREO),
        torch.full_like(obs.sigma2, robust.CHI2_MONO),
    )
    w_base = 1.0 / obs.sigma2
    eye6 = torch.eye(6, dtype=obs.xw.dtype, device=obs.xw.device)
    T = T_init
    inlier = obs.valid
    for rnd in range(rounds):
        use_huber = rnd < use_huber_rounds
        for _ in range(iters):
            r, J, row_mask = _residual_jac(cam, T, obs)
            row_mask = row_mask * inlier[:, None].to(r.dtype)
            w = w_base
            if use_huber:
                chi2 = _chi2(r, row_mask, obs.sigma2)
                w = w_base * robust.huber_weight(chi2 / chi2_th, 1.0)
            Jm = J * row_mask[..., None]
            rm = r * row_mask
            Jw = Jm * w[:, None, None]
            H = torch.einsum("nki,nkj->ij", Jw, Jm)
            g = torch.einsum("nki,nk->i", Jw, rm)
            damp = 1e-6 * torch.trace(H) / 6.0 + 1e-9
            dx = -torch.linalg.solve_ex(H + damp * eye6, g).result
            dx = torch.where(torch.all(torch.isfinite(dx)), dx, torch.zeros_like(dx))
            T = se3.retract_left(T, dx)
        r, J, row_mask = _residual_jac(cam, T, obs)
        chi2 = _chi2(r, row_mask, obs.sigma2)
        inlier = obs.valid & (chi2 <= chi2_th) & (row_mask[:, 0] > 0)
    return T, inlier, torch.sum(inlier)
