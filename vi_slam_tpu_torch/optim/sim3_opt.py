"""Relative Sim3 refinement between two keyframes from matched points — a
PyTorch copy of the JAX package's `optim/sim3_opt.py::optimize_sim3`.

Gauss-Newton over one left-perturbed Sim3 with both edge directions (the
points of keyframe 2 projected into keyframe 1 and back), Huber weights
(delta^2 = 10) and a cheirality mask at each linearization; the Jacobian
is forward-mode autodiff of the weighted residuals, as in the reference.
`iters1` steps on all valid pairs, a chi2 < 10 inlier refresh, `iters2`
more steps on the inliers, and a last refresh.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd

from vi_slam_tpu_torch.cameras import pinhole
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.lie import sim3 as sim3_m
from vi_slam_tpu_torch.lie.sim3 import Sim3


class Sim3OptResult(NamedTuple):
    S12: Sim3
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor


def _residuals(cam1, cam2, S12: Sim3, x1, x2, uv1, uv2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and inverse reprojection residuals, each (N, 2)."""
    r1 = pinhole.project(cam1, S12.apply(x2)) - uv1
    r2 = pinhole.project(cam2, S12.inverse().apply(x1)) - uv2
    return r1, r2


def optimize_sim3(cam1: CameraParams, cam2: CameraParams, S12_init: Sim3, x1: torch.Tensor,
                  x2: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
                  sigma2_1: torch.Tensor, sigma2_2: torch.Tensor, iters1: int = 5,
                  iters2: int = 10, fix_scale: bool = False) -> Sim3OptResult:
    """Refine S12 (keyframe-2 camera -> keyframe-1 camera) from matched
    camera-frame points x1/x2 (N, 3) and their pixels uv1/uv2 (N, 2)."""
    th2 = 10.0
    dt = x1.dtype
    dev = x1.device
    eye7 = torch.eye(7, dtype=dt, device=dev)
    s1 = torch.clamp(sigma2_1, min=1e-9)
    s2 = torch.clamp(sigma2_2, min=1e-9)

    def tangent_apply(xi, S):
        return sim3_m.exp(xi).compose(S)

    def gn_step(S: Sim3, mask: torch.Tensor) -> Sim3:
        r1_0, r2_0 = _residuals(cam1, cam2, S, x1, x2, uv1, uv2)
        chei = ((S.apply(x2)[..., 2] > 0.1) & (S.inverse().apply(x1)[..., 2] > 0.1)).to(dt)
        c1 = torch.sum(r1_0 * r1_0, dim=-1) / s1
        c2 = torch.sum(r2_0 * r2_0, dim=-1) / s2
        h1 = torch.clamp(torch.sqrt(th2 / torch.clamp(c1, min=1e-12)), max=1.0)
        h2 = torch.clamp(torch.sqrt(th2 / torch.clamp(c2, min=1e-12)), max=1.0)
        sw1 = torch.sqrt(mask * chei * h1 / s1)[:, None]
        sw2 = torch.sqrt(mask * chei * h2 / s2)[:, None]

        # the tangent has a batch dimension of 1: 0-dim scalars under
        # torch.func promote Python constants to float64
        S1 = Sim3(S.R[None], S.t[None], S.s[None])

        def flat_res(xi):
            r1, r2 = _residuals(cam1, cam2, tangent_apply(xi, S1), x1, x2, uv1, uv2)
            return torch.cat([r1 * sw1, r2 * sw2], dim=0).reshape(-1)

        zero = torch.zeros((1, 7), dtype=dt, device=dev)
        J = jacfwd(flat_res)(zero)[:, 0]  # (4N, 7)
        r = flat_res(zero)
        H = J.T @ J
        b = -J.T @ r
        if fix_scale:
            H = H.clone()
            H[6, :] = 0.0
            H[:, 6] = 0.0
            H[6, 6] = 1.0
            b = b.clone()
            b[6] = 0.0
        xi = torch.linalg.solve_ex(H + 1e-6 * eye7, b[:, None])[0][:, 0]
        return tangent_apply(xi, S)

    def chi2_mask(S: Sim3) -> torch.Tensor:
        r1, r2 = _residuals(cam1, cam2, S, x1, x2, uv1, uv2)
        c1 = torch.sum(r1 * r1, dim=-1) / s1
        c2 = torch.sum(r2 * r2, dim=-1) / s2
        return valid & (c1 < th2) & (c2 < th2)

    S = S12_init
    mask = valid.to(dt)
    for _ in range(iters1):
        S = gn_step(S, mask)
    mask = chi2_mask(S).to(dt)
    for _ in range(iters2):
        S = gn_step(S, mask)
    inl = chi2_mask(S)
    return Sim3OptResult(S12=S, inliers=inl, n_inliers=torch.sum(inl))
