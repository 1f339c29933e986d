"""Bundle adjustment with an explicit Schur complement over the landmark
blocks — a PyTorch copy of the JAX package's `optim/local_ba.py`: the
dense assembly of local BA over a covisibility window, and the scatter
assembly of whole-map (global) BA.

Observations are grouped per landmark in (M, P) slots with masks. Each
landmark's 3x3 block is inverted. With assembly="dense" the camera-camera
coupling goes through the per-landmark matrix U (M, K, 6, 3), so the
reduced camera system S = H_cc - sum_m U H_pp^-1 U^T is a few batched
products; assembly="scatter" adds per-observation-pair 6x6 blocks into
(K, K, 6, 6) instead, which keeps the memory O(K^2 + M P^2) at map scale.
Fixed cameras get zero rows and columns and an identity diagonal. The
6K x 6K reduced system is a dense solve. Iterations are Levenberg-Marquardt with
accept/reject on the robust cost, or damped Gauss-Newton; the accept
decision stays on the device, so a run never waits for the host.

All of it runs in float32 with TF32 off (`utils/device.py`), as the
reference's solver paths do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vi_slam_tpu_torch.cameras import pinhole
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.lie import se3, so3
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.optim import robust
from vi_slam_tpu_torch.utils.numerics import lu3_pivots


class BAProblem(NamedTuple):
    """Static-shape BA problem.

    poses: SE3 with batch (K,), world->camera; fixed: (K,) bool, cameras
    held constant; points: (M, 3) world points; point_valid: (M,) bool;
    obs_cam: (M, P) int32 camera of each observation slot; obs_uvr:
    (M, P, 3) measured (u, v, u_right); obs_stereo: (M, P) bool;
    obs_sigma2: (M, P); obs_mask: (M, P) bool.
    """

    poses: SE3
    fixed: torch.Tensor
    points: torch.Tensor
    point_valid: torch.Tensor
    obs_cam: torch.Tensor
    obs_uvr: torch.Tensor
    obs_stereo: torch.Tensor
    obs_sigma2: torch.Tensor
    obs_mask: torch.Tensor


class BAResult(NamedTuple):
    poses: SE3
    points: torch.Tensor
    obs_inlier: torch.Tensor  # (M, P) chi2 gate at the final state
    cost: torch.Tensor  # (iters + 1,) robust cost history


def _residuals(cam: CameraParams, poses: SE3, points: torch.Tensor, prob: BAProblem):
    """r (M, P, 3), J_cam (M, P, 3, 6), J_pt (M, P, 3, 3), row_mask (M, P, 3).
    The reference picks each observation's pose by a one-hot product,
    which gives the gathered values exactly."""
    cam_idx = prob.obs_cam.long()
    Rk = poses.R[cam_idx]
    tk = poses.t[cam_idx]
    pc = (Rk @ points[:, None, :, None])[..., 0] + tk
    r = pinhole.stereo_project(cam, pc) - prob.obs_uvr
    Jpc = pinhole.stereo_project_jac(cam, pc)
    I = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*pc.shape[:-1], 3, 3)
    J_cam = Jpc @ torch.cat([I, -so3.hat(pc)], dim=-1)
    J_pt = Jpc @ Rk
    base = prob.obs_mask & prob.point_valid[:, None] & ~(pc[..., 2] < 0.05)
    row_mask = torch.stack([base, base, base & prob.obs_stereo], dim=-1).to(r.dtype)
    return r, J_cam, J_pt, row_mask


def _robust_cost_and_weights(r, row_mask, prob: BAProblem, use_huber: bool):
    chi2 = torch.sum(r * r * row_mask, dim=-1) / prob.obs_sigma2
    delta2 = torch.where(prob.obs_stereo, robust.CHI2_STEREO, robust.CHI2_MONO).to(r.dtype)
    first_row = row_mask[..., 0] > 0
    if use_huber:
        w = robust.huber_weight(chi2 / delta2, 1.0) / prob.obs_sigma2
        cost = torch.sum(robust.huber_rho(chi2 / delta2, 1.0) * delta2 * first_row)
    else:
        w = 1.0 / prob.obs_sigma2
        cost = torch.sum(chi2 * first_row)
    return chi2, w, cost


def _landmark_inverses(Hpp: torch.Tensor, lam: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """(Hpp + lam I + 1e-9 I)^-1 per landmark, zero for a landmark without
    observations. The reference inverts with jnp.linalg.inv, whose rows
    are non-finite where its float32 LU meets a zero pivot (a far point
    with one or two observations). That is mirrored: the NaN then spreads
    through S, a sum over the landmarks, so the step keeps the cameras
    (dxc's isfinite guard) and that landmark."""
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    Hpp_d = Hpp + lam * eye3 + 1e-9 * eye3
    Hpp_inv = torch.linalg.inv_ex(Hpp_d)[0]  # inv_ex: no host sync for the error check
    singular = torch.any(lu3_pivots(Hpp_d) == 0, dim=-1)
    Hpp_inv = torch.where(singular[:, None, None], torch.full_like(Hpp_inv, float("nan")), Hpp_inv)
    has_obs = torch.sum(row_mask[..., 0], dim=1) > 0
    return torch.where(has_obs[:, None, None], Hpp_inv, torch.zeros_like(Hpp_inv))


def _visual_reduced_system(cam: CameraParams, poses: SE3, points: torch.Tensor,
                           prob: BAProblem, lam: torch.Tensor, use_huber: bool):
    """Schur-reduce the landmark blocks. Returns (S (K, K, 6, 6) reduced
    camera system with the H_cc diagonal, b (K, 6) reduced gradient,
    U (M, K, 6, 3), Hpp_inv (M, 3, 3), bp (M, 3))."""
    K = poses.t.shape[0]
    r, J_cam, J_pt, row_mask = _residuals(cam, poses, points, prob)
    _, w, _ = _robust_cost_and_weights(r, row_mask, prob, use_huber)
    Jc = J_cam * row_mask[..., None]
    Jp = J_pt * row_mask[..., None]
    rm = r * row_mask

    Hpp = torch.einsum("mpki,mpkj,mp->mij", Jp, Jp, w)
    bp = torch.einsum("mpki,mpk,mp->mi", Jp, rm, w)
    Wcp = torch.einsum("mpki,mpkj,mp->mpij", Jc, Jp, w)
    Hcc_obs = torch.einsum("mpki,mpkj,mp->mpij", Jc, Jc, w)
    bc_obs = torch.einsum("mpki,mpk,mp->mpi", Jc, rm, w)

    # one-hot products, as the reference assembles: deterministic on the
    # card, where a float scatter-add is not (a comparison, not F.one_hot,
    # which checks its input's range on the host)
    cams = torch.arange(K, dtype=prob.obs_cam.dtype, device=r.device)
    onehot = (prob.obs_cam[..., None] == cams).to(r.dtype)
    Hcc_diag = torch.einsum("mpk,mpij->kij", onehot, Hcc_obs)
    bc = torch.einsum("mpk,mpi->ki", onehot, bc_obs)
    U = torch.einsum("mpk,mpij->mkij", onehot, Wcp)

    Hpp_inv = _landmark_inverses(Hpp, lam, row_mask)

    Y = torch.einsum("mkis,msj->mkij", U, Hpp_inv)
    S_red = torch.einsum("mkis,mljs->klij", Y, U)
    b_red_corr = torch.einsum("mkis,ms->ki", Y, bp)
    S = -S_red
    ar = torch.arange(K, device=r.device)
    S[ar, ar] += Hcc_diag
    return S, bc - b_red_corr, U, Hpp_inv, bp


def back_substitute_points(U, Hpp_inv, bp, dxc):
    """Landmark updates from the camera updates: dxp = Hpp^-1 (-bp - U^T dxc)."""
    Ut_dxc = torch.einsum("mkis,ki->ms", U, dxc)
    dxp = torch.einsum("mij,mj->mi", Hpp_inv, -bp - Ut_dxc)
    return torch.where(torch.isfinite(dxp), dxp, torch.zeros_like(dxp))


def _visual_reduced_system_scatter(cam: CameraParams, poses: SE3, points: torch.Tensor,
                                   prob: BAProblem, lam: torch.Tensor, use_huber: bool):
    """Schur reduction with scatter-add assembly, for whole-map problems.
    Returns (S, b, Wcp (M, P, 6, 3), Hpp_inv, bp, cidx (M, P))."""
    K = poses.t.shape[0]
    M, P = prob.obs_cam.shape
    r, J_cam, J_pt, row_mask = _residuals(cam, poses, points, prob)
    _, w, _ = _robust_cost_and_weights(r, row_mask, prob, use_huber)
    Jc = J_cam * row_mask[..., None]
    Jp = J_pt * row_mask[..., None]
    rm = r * row_mask

    Hpp = torch.einsum("mpki,mpkj,mp->mij", Jp, Jp, w)
    bp = torch.einsum("mpki,mpk,mp->mi", Jp, rm, w)
    Wcp = torch.einsum("mpki,mpkj,mp->mpij", Jc, Jp, w)
    Hcc_obs = torch.einsum("mpki,mpkj,mp->mpij", Jc, Jc, w)
    bc_obs = torch.einsum("mpki,mpk,mp->mpi", Jc, rm, w)

    # masked observations carry all-zero blocks, so clipped indices add
    # nothing (a NaN inverse still reaches camera 0, as in the reference)
    cidx = torch.clamp(prob.obs_cam.long(), 0, K - 1)
    flat = cidx.reshape(-1)
    dt = r.dtype
    Hcc_diag = torch.zeros((K, 6, 6), dtype=dt, device=r.device).index_add_(
        0, flat, Hcc_obs.reshape(-1, 6, 6))
    bc = torch.zeros((K, 6), dtype=dt, device=r.device).index_add_(0, flat, bc_obs.reshape(-1, 6))
    Hpp_inv = _landmark_inverses(Hpp, lam, row_mask)

    Y = torch.einsum("mpis,mst->mpit", Wcp, Hpp_inv)
    S_red = torch.zeros((K * K, 6, 6), dtype=dt, device=r.device)
    b_corr = torch.zeros((K, 6), dtype=dt, device=r.device)
    for p in range(P):
        for q in range(P):
            S_red.index_add_(0, cidx[:, p] * K + cidx[:, q],
                             torch.einsum("mis,mjs->mij", Y[:, p], Wcp[:, q]))
        b_corr.index_add_(0, cidx[:, p], torch.einsum("mis,ms->mi", Y[:, p], bp))
    S = -S_red.reshape(K, K, 6, 6)
    ar = torch.arange(K, device=r.device)
    S[ar, ar] += Hcc_diag
    return S, bc - b_corr, Wcp, Hpp_inv, bp, cidx


def back_substitute_points_scatter(Wcp, Hpp_inv, bp, dxc, cidx):
    """Landmark updates without U: each observation's camera update is
    gathered and contracted per landmark."""
    Ut_dxc = torch.einsum("mpis,mpi->ms", Wcp, dxc[cidx])
    dxp = torch.einsum("mij,mj->mi", Hpp_inv, -bp - Ut_dxc)
    return torch.where(torch.isfinite(dxp), dxp, torch.zeros_like(dxp))


def _build_and_solve(cam: CameraParams, poses: SE3, points: torch.Tensor, prob: BAProblem,
                     lam: torch.Tensor, use_huber: bool, assembly: str = "dense"):
    """One LM system build and Schur solve: (dxc (K, 6), dxp (M, 3))."""
    K = poses.t.shape[0]
    if assembly == "scatter":
        S, b, Wcp, Hpp_inv, bp, cidx = _visual_reduced_system_scatter(
            cam, poses, points, prob, lam, use_huber)
    else:
        S, b, U, Hpp_inv, bp = _visual_reduced_system(cam, poses, points, prob, lam, use_huber)
    dt = S.dtype
    eye6 = torch.eye(6, dtype=dt, device=S.device)
    ar = torch.arange(K, device=S.device)
    S[ar, ar] += lam * eye6
    # fixed cameras: zero rows and columns, identity diagonal, zero rhs
    free = (~prob.fixed).to(dt)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S[ar, ar] += (1.0 - free)[:, None, None] * eye6
    b = b * free[:, None]
    S_dense = S.transpose(1, 2).reshape(K * 6, K * 6)
    # a plain dense solve; solve_ex skips the error check's host sync
    dxc = -torch.linalg.solve_ex(S_dense, b.reshape(K * 6, 1))[0].reshape(K, 6)
    dxc = torch.where(torch.isfinite(dxc), dxc, torch.zeros_like(dxc))
    if assembly == "scatter":
        return dxc, back_substitute_points_scatter(Wcp, Hpp_inv, bp, dxc, cidx)
    return dxc, back_substitute_points(U, Hpp_inv, bp, dxc)


def _ba_core(cam: CameraParams, prob: BAProblem, iters: int, use_huber: bool, lam0: float,
             strategy: str = "lm", assembly: str = "dense",
             guard_in_front: bool = False) -> BAResult:
    """The LM (or damped Gauss-Newton) loop; `iters` steps, unrolled.

    An observation whose point is not in front of its camera (depth below
    0.05) drops out of the cost, so a step that moves points behind the
    cameras lowers the cost. Where the problem has a gauge that such a
    step can follow (a monocular map's scale, with one keyframe fixed),
    float32 rounding can make LM take it, and the map comes out mirrored
    behind its cameras with no observation left (ROADMAP H13). With
    `guard_in_front` (the monocular pipeline's BAs) an LM step is accepted
    only if it keeps every observation that is in the cost; the JAX
    package has no such rule, and the other pipelines keep its LM as it
    is."""
    dt = prob.points.dtype
    dev = prob.points.device

    def cost_at(poses, points):
        """(cost, number of observations in the cost, counted only with
        the guard)."""
        r, _, _, row_mask = _residuals(cam, poses, points, prob)
        cost = _robust_cost_and_weights(r, row_mask, prob, use_huber)[2]
        return cost, torch.sum(row_mask[..., 0]) if guard_in_front else None

    poses, points = prob.poses, prob.points
    costs = []
    if strategy == "gn":
        # damped GN without the accept/reject cost pass
        cost = torch.zeros((), dtype=dt, device=dev)
        lam = torch.full((), max(lam0, 1e-3), dtype=dt, device=dev)
        init_cost = cost
        for _ in range(iters):
            dxc, dxp = _build_and_solve(cam, poses, points, prob, lam, use_huber, assembly)
            poses = se3.retract_left(poses, dxc)
            points = points + dxp
            costs.append(cost)
    else:
        lam = torch.full((), lam0, dtype=dt, device=dev)
        cost, n_obs = cost_at(poses, points)
        init_cost = cost
        for _ in range(iters):
            dxc, dxp = _build_and_solve(cam, poses, points, prob, lam, use_huber, assembly)
            cand_poses = se3.retract_left(poses, dxc)
            cand_points = points + dxp
            cand_cost, cand_n_obs = cost_at(cand_poses, cand_points)
            accept = cand_cost < cost
            if guard_in_front:
                accept = accept & (cand_n_obs >= n_obs)
                n_obs = torch.where(accept, cand_n_obs, n_obs)
            poses = SE3(torch.where(accept, cand_poses.R, poses.R),
                        torch.where(accept, cand_poses.t, poses.t))
            points = torch.where(accept, cand_points, points)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e4)
            cost = torch.where(accept, cand_cost, cost)
            costs.append(cost)
    poses = SE3(so3.normalize(poses.R), poses.t)

    # final chi2 gate
    r, _, _, row_mask = _residuals(cam, poses, points, prob)
    chi2 = torch.sum(r * r * row_mask, dim=-1) / prob.obs_sigma2
    th = torch.where(prob.obs_stereo, robust.CHI2_STEREO, robust.CHI2_MONO).to(dt)
    inlier = (chi2 <= th) & (row_mask[..., 0] > 0)
    return BAResult(poses=poses, points=points, obs_inlier=inlier,
                    cost=torch.stack([init_cost] + costs))


def bundle_adjust(cam: CameraParams, prob: BAProblem, iters: int = 10, use_huber: bool = True,
                  lam0: float = 1e-4, assembly: str = "dense",
                  guard_in_front: bool = False) -> BAResult:
    """Levenberg-Marquardt bundle adjustment over poses and points; fixed
    cameras and invalid points and observations are masked out. Use
    assembly="scatter" for whole-map problems; `guard_in_front`: see
    `_ba_core`."""
    return _ba_core(cam, prob, iters, use_huber, lam0, assembly=assembly,
                    guard_in_front=guard_in_front)
