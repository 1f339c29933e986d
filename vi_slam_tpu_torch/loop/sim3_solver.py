"""Sim3/SE3 between matched 3D point sets: Horn's closed form and a batched
RANSAC — a PyTorch copy of the JAX package's `loop/sim3_solver.py`.

All hypotheses are solved at once: one weighted Horn fit (a 3x3 SVD) per
sampled triple, then an (H, N) inlier matrix from the reprojections into
both keyframes, the best hypothesis by inlier count, and one refit on its
inliers that is kept when it has at least as many.

The reference draws the triples inside its jitted RANSAC with
`jax.random.choice(key, N, (H, 3), p=valid / n_valid)`. Here the draw is
a separate step (`utils/sampling.py`, on a `torch.Generator`) and the
core (`sim3_ransac_core`) takes the index array, so a test can hand it
the reference's own draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vi_slam_tpu_torch.cameras import pinhole
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.lie.sim3 import Sim3
from vi_slam_tpu_torch.utils.sampling import DrawFn


class Sim3RansacResult(NamedTuple):
    S12: Sim3  # maps frame-2 camera coordinates to frame-1 camera coordinates
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int64


def horn_sim3(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor,
              fix_scale: bool = False) -> Sim3:
    """Weighted closed-form S12 minimizing ||x1 - S12(x2)||^2, batched
    over the leading dims of w: x1, x2 (N, 3), w (..., N). Rotation by
    SVD of the cross-covariance with the reflection fixed; scale
    sqrt(var1 / var2), or 1 with fix_scale."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    c1 = (w @ x1) / wsum[..., None]
    c2 = (w @ x2) / wsum[..., None]
    d1 = x1 - c1[..., None, :]
    d2 = x2 - c2[..., None, :]
    M = torch.einsum("...n,...ni,...nj->...ij", w, d1, d2)
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1))
    R = U @ D @ Vt
    var1 = torch.sum(w[..., None] * d1 * d1, dim=(-1, -2)) / wsum
    var2 = torch.sum(w[..., None] * d2 * d2, dim=(-1, -2)) / wsum
    s = torch.sqrt(torch.clamp(var1, min=1e-12) / torch.clamp(var2, min=1e-12))
    if fix_scale:
        s = torch.ones_like(s)
    t = c1 - s[..., None] * (R @ c2[..., None])[..., 0]
    return Sim3(R=R, t=t, s=s)


def _reproj_sq_err(cam: CameraParams, x_cam: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    err = torch.sum((pinhole.project(cam, x_cam) - uv) ** 2, dim=-1)
    return torch.where(x_cam[..., 2] <= 0.1, torch.full_like(err, 1e12), err)


def _batch_apply(S: Sim3, x: torch.Tensor) -> torch.Tensor:
    """Apply a batch of transforms (H,) to one point set (N, 3) -> (H, N, 3)."""
    return S.s[..., None, None] * (x @ S.R.transpose(-1, -2)) + S.t[..., None, :]


def _count_inliers(cam1, cam2, S: Sim3, x1, x2, uv1, uv2, valid, sigma2_1, sigma2_2):
    e1 = _reproj_sq_err(cam1, _batch_apply(S, x2), uv1)
    e2 = _reproj_sq_err(cam2, _batch_apply(S.inverse(), x1), uv2)
    return valid & (e1 < 9.210 * sigma2_1) & (e2 < 9.210 * sigma2_2)


def sim3_ransac_core(cam1: CameraParams, cam2: CameraParams, x1: torch.Tensor,
                     x2: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                     valid: torch.Tensor, sigma2_1: torch.Tensor, sigma2_2: torch.Tensor,
                     idx: torch.Tensor, fix_scale: bool = False) -> Sim3RansacResult:
    """RANSAC over given (H, 3) sample triples. x1/x2 (N, 3) matched points
    in the two keyframes' camera frames, uv1/uv2 (N, 2) their pixels,
    sigma2_* the pyramid variances (gate 9.210 sigma2 in both images)."""
    H, N = idx.shape[0], x1.shape[0]
    w_valid = valid.to(x1.dtype)
    w = torch.zeros((H, N), dtype=x1.dtype, device=x1.device)
    w.scatter_(1, idx.long(), 1.0)
    S = horn_sim3(x1, x2, w * w_valid, fix_scale=fix_scale)
    inl = _count_inliers(cam1, cam2, S, x1, x2, uv1, uv2, valid, sigma2_1, sigma2_2)
    best = torch.argmax(torch.sum(inl, dim=-1))
    best_inl = inl[best]
    S_ref = horn_sim3(x1, x2, best_inl.to(x1.dtype), fix_scale=fix_scale)
    inl_ref = _count_inliers(cam1, cam2, Sim3(S_ref.R[None], S_ref.t[None], S_ref.s[None]),
                             x1, x2, uv1, uv2, valid, sigma2_1, sigma2_2)[0]
    better = torch.sum(inl_ref) >= torch.sum(best_inl)
    S_out = Sim3(
        R=torch.where(better, S_ref.R, S.R[best]),
        t=torch.where(better, S_ref.t, S.t[best]),
        s=torch.where(better, S_ref.s, S.s[best]),
    )
    inl_out = torch.where(better, inl_ref, best_inl)
    return Sim3RansacResult(S12=S_out, inliers=inl_out, n_inliers=torch.sum(inl_out))


def sim3_ransac(cam1: CameraParams, cam2: CameraParams, x1, x2, uv1, uv2, valid, sigma2_1,
                sigma2_2, draw: DrawFn, n_hyp: int = 128,
                fix_scale: bool = False) -> Sim3RansacResult:
    """Batched Sim3 RANSAC with triples from `draw` (`utils/sampling.py`)."""
    idx = draw(valid, n_hyp, 3)
    return sim3_ransac_core(cam1, cam2, x1, x2, uv1, uv2, valid, sigma2_1, sigma2_2, idx,
                            fix_scale=fix_scale)
