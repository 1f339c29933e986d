"""Batched PnP RANSAC for relocalization — a PyTorch copy of the JAX
package's `optim/pnp.py::pnp_ransac`.

The minimal solver is a 6-point DLT pose: the null vector of a 12x12
system (one SVD per hypothesis, all hypotheses at once), its rotation
block projected onto SO(3), the sign chosen so that most points lie in
front. Inliers are an (H, N) chi2 matrix; the best hypothesis is refit by
a weighted DLT over its inliers, kept when it has at least as many.

The samples come from a draw function (`utils/sampling.py`), so a test
can hand the solver the reference's own draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vi_slam_tpu_torch.cameras import pinhole
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.utils.sampling import DrawFn


class PnPResult(NamedTuple):
    T_cw: SE3
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # ()
    ok: torch.Tensor  # () bool


def _dlt_rows(xw: torch.Tensor, xn: torch.Tensor):
    """Homogeneous points (..., S, 4) and the (..., 2S, 12) DLT system."""
    Xh = torch.cat([xw, torch.ones_like(xw[..., :1])], dim=-1)
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -xn[..., 0:1] * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], dim=-1)
    return Xh, torch.cat([r1, r2], dim=-2)


def _pose_from_null(P: torch.Tensor, Xh: torch.Tensor, w: torch.Tensor) -> SE3:
    """P (..., 3, 4) up to scale and sign -> SE3: the sign that puts the
    (weighted) majority of points in front, the rotation block projected
    onto SO(3), the translation divided by the mean singular value."""
    depths = (Xh @ P[..., 2, :, None])[..., 0]
    sign = torch.where(torch.sum(torch.sign(depths) * w, dim=-1) >= 0, 1.0, -1.0)
    P = P * sign[..., None, None]
    U, s, Vt = torch.linalg.svd(P[..., :3])
    det = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1))
    t = P[..., 3] / torch.clamp(torch.sum(s, dim=-1) / 3.0, min=1e-12)[..., None]
    return SE3(U @ D @ Vt, t)


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the smallest singular value, as a
    (..., 3, 4) matrix."""
    Vt = torch.linalg.svd(A, full_matrices=False)[2]
    return Vt[..., -1, :].reshape(*A.shape[:-2], 3, 4)


def pnp_ransac_core(cam: CameraParams, xw: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                    sigma2: torch.Tensor, idx: torch.Tensor, chi2_th: float = 5.991,
                    min_inliers: int = 12) -> PnPResult:
    """P6P RANSAC over given (H, 6) samples: xw (N, 3) world points,
    uv (N, 2) pixels, sigma2 (N,) pyramid variances."""
    dt = xw.dtype
    xn = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], dim=-1)
    idx = idx.long()
    Xh_s, A = _dlt_rows(xw[idx], xn[idx])
    T = _pose_from_null(_null_vector(A), Xh_s, torch.ones_like(Xh_s[..., 0]))

    def count(R, t):
        pc = (xw @ R.transpose(-1, -2)) + t[..., None, :]
        e2 = torch.sum((pinhole.project(cam, pc) - uv) ** 2, dim=-1) / torch.clamp(sigma2, min=1e-9)
        return valid & (pc[..., 2] > 0.05) & (e2 < chi2_th)

    inl = count(T.R, T.t)
    best = torch.argmax(torch.sum(inl, dim=-1))
    best_inl = inl[best]
    wi = best_inl.to(dt)
    Xh, A = _dlt_rows(xw, xn)
    A = A * torch.cat([wi, wi])[:, None]
    T_ref = _pose_from_null(_null_vector(A), Xh, wi)
    inl_ref = count(T_ref.R, T_ref.t)
    better = torch.sum(inl_ref) >= torch.sum(best_inl)
    T_out = SE3(torch.where(better, T_ref.R, T.R[best]), torch.where(better, T_ref.t, T.t[best]))
    inl_out = torch.where(better, inl_ref, best_inl)
    n = torch.sum(inl_out)
    return PnPResult(T_cw=T_out, inliers=inl_out, n_inliers=n, ok=n >= min_inliers)


def pnp_ransac(cam: CameraParams, xw, uv, valid, sigma2, draw: DrawFn, n_hyp: int = 256,
               sample_size: int = 6, chi2_th: float = 5.991, min_inliers: int = 12) -> PnPResult:
    """Batched P6P RANSAC with samples from `draw`."""
    idx = draw(valid, n_hyp, sample_size)
    return pnp_ransac_core(cam, xw, uv, valid, sigma2, idx, chi2_th, min_inliers)
