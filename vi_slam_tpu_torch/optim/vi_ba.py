"""Visual-inertial sliding-window bundle adjustment — a PyTorch copy of the
JAX package's `optim/vi_ba.py`.

Each keyframe carries a 15-wide state [pose (6) | vel (3) | bg (3) |
ba (3)]. Landmarks are Schur-eliminated as in visual BA
(`local_ba._visual_reduced_system`), and their reduced 6x6 camera
coupling lands in the pose block of the 15-wide system. Consecutive
window slots are joined by a preintegrated inertial edge, whose 9x24
Jacobian is analytic (`pose_inertial.inertial_residual_jac`, batched over
the edges; the reference's forward-mode autodiff gives the same to
float32 rounding), and by the bias random walks. The dense
(15K)^2 system is solved in one piece; iterations are Levenberg-Marquardt
with the accept decision on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.imu import preintegration as pre
from vi_slam_tpu_torch.lie import se3, so3
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.optim.local_ba import (
    BAProblem, _residuals, _robust_cost_and_weights, _visual_reduced_system,
    back_substitute_points,
)
from vi_slam_tpu_torch.optim.pose_inertial import inertial_residual_jac

D = 15  # per-keyframe state width


class VIBAProblem(NamedTuple):
    """The visual problem (Tcw poses) and the inertial chain between
    consecutive window slots (k, k+1)."""

    visual: BAProblem
    vel: torch.Tensor  # (K, 3) world-frame body velocity
    bg: torch.Tensor  # (K, 3)
    ba: torch.Tensor  # (K, 3)
    preint: pre.Preintegrated  # stacked (K-1,)
    inertial_valid: torch.Tensor  # (K-1,) bool
    gravity: torch.Tensor  # (3,) world gravity vector
    walk_info_g: torch.Tensor  # (K-1,) bias random-walk precisions
    walk_info_a: torch.Tensor  # (K-1,)
    R_bc: torch.Tensor  # (3, 3) camera -> body
    t_bc: torch.Tensor  # (3,)


class VIBAResult(NamedTuple):
    poses: SE3
    points: torch.Tensor
    vel: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    cost: torch.Tensor


def _edge_residuals(prob: VIBAProblem, poses: SE3):
    """(K-1, 9) residuals of the inertial edges and their (K-1, 9, 24)
    Jacobians in [xi_i, dv_i, dbg_i, dba_i, xi_j, dv_j]."""
    return inertial_residual_jac(
        prob.preint, SE3(poses.R[:-1], poses.t[:-1]), prob.vel[:-1], prob.bg[:-1],
        prob.ba[:-1], SE3(poses.R[1:], poses.t[1:]), prob.vel[1:], prob.gravity, prob.R_bc,
        prob.t_bc)


def _inertial_cost(prob: VIBAProblem, poses: SE3, r: torch.Tensor, info: torch.Tensor):
    w = prob.inertial_valid.to(r.dtype)
    cost = torch.sum(torch.einsum("es,est,et->e", r, info, r) * w)
    for b, wb in ((prob.bg, prob.walk_info_g * w), (prob.ba, prob.walk_info_a * w)):
        rb = b[1:] - b[:-1]
        cost = cost + torch.sum(wb * torch.sum(rb * rb, dim=-1))
    return cost


def _inertial_system(prob: VIBAProblem, poses: SE3):
    """The inertial and bias random-walk terms as a (K, K, 15, 15) Hessian
    and (K, 15) gradient; returns (H, g, cost)."""
    K = poses.t.shape[0]
    dtype = poses.t.dtype
    dev = poses.t.device
    E = K - 1
    r, J = _edge_residuals(prob, poses)
    info = pre.information(prob.preint)
    w = prob.inertial_valid.to(dtype)
    JtI = torch.einsum("eri,ers->eis", J, info)
    H_e = torch.einsum("eis,esj,e->eij", JtI, J, w)
    g_e = torch.einsum("eis,es,e->ei", JtI, r, w)
    cost = _inertial_cost(prob, poses, r, info)

    H = torch.zeros((K, K, D, D), dtype=dtype, device=dev)
    g = torch.zeros((K, D), dtype=dtype, device=dev)
    e = torch.arange(E, device=dev)
    Hij = H_e[:, 0:15, 15:24]
    H[e, e] += H_e[:, 0:15, 0:15]
    H[e, e + 1, :, 0:9] += Hij
    H[e + 1, e, 0:9, :] += Hij.transpose(-1, -2)
    H[e + 1, e + 1, 0:9, 0:9] += H_e[:, 15:24, 15:24]
    g[e] += g_e[:, 0:15]
    g[e + 1, 0:9] += g_e[:, 15:24]
    I3 = torch.eye(3, dtype=dtype, device=dev)
    for b, wb, off in ((prob.bg, prob.walk_info_g * w, 9), (prob.ba, prob.walk_info_a * w, 12)):
        rb = b[1:] - b[:-1]
        sl = slice(off, off + 3)
        WI = wb[:, None, None] * I3
        H[e, e, sl, sl] += WI
        H[e + 1, e + 1, sl, sl] += WI
        H[e, e + 1, sl, sl] += -WI
        H[e + 1, e, sl, sl] += -WI
        g[e, sl] += -wb[:, None] * rb
        g[e + 1, sl] += wb[:, None] * rb
    return H, g, cost


def _vi_cost(cam, prob: VIBAProblem, poses: SE3, points, use_huber: bool):
    r, _, _, row_mask = _residuals(cam, poses, points, prob.visual)
    c_vis = _robust_cost_and_weights(r, row_mask, prob.visual, use_huber)[2]
    r_in = _edge_residuals(prob, poses)[0]
    return c_vis + _inertial_cost(prob, poses, r_in, pre.information(prob.preint))


def _vi_build_and_solve(cam, prob: VIBAProblem, poses: SE3, points, lam, use_huber: bool):
    K = poses.t.shape[0]
    dtype = poses.t.dtype
    dev = poses.t.device
    S6, b6, U, Hpp_inv, bp = _visual_reduced_system(cam, poses, points, prob.visual, lam,
                                                    use_huber)
    H, g, _ = _inertial_system(prob, poses)
    H[:, :, 0:6, 0:6] += S6
    g[:, 0:6] += b6
    kk = torch.arange(K, device=dev)
    eye = torch.eye(D, dtype=dtype, device=dev)
    H[kk, kk] += lam * eye
    free = (~prob.visual.fixed).to(dtype)
    H = H * free[:, None, None, None] * free[None, :, None, None]
    H[kk, kk] += (1.0 - free)[:, None, None] * eye
    g = g * free[:, None]
    Hd = H.transpose(1, 2).reshape(K * D, K * D)
    dx = -torch.linalg.solve_ex(Hd, g.reshape(K * D, 1))[0].reshape(K, D)
    dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
    return dx, back_substitute_points(U, Hpp_inv, bp, dx[:, 0:6])


def vi_bundle_adjust(cam: CameraParams, prob: VIBAProblem, iters: int = 8,
                     use_huber: bool = True, lam0: float = 1e-4) -> VIBAResult:
    """Levenberg-Marquardt over the window's poses, velocities, biases and
    points; `iters` steps, unrolled."""
    poses, points = prob.visual.poses, prob.visual.points
    vel, bg, ba = prob.vel, prob.bg, prob.ba
    cost = _vi_cost(cam, prob, poses, points, use_huber)
    lam = torch.tensor(lam0, dtype=points.dtype, device=points.device)
    costs = [cost]
    for _ in range(iters):
        p = prob._replace(vel=vel, bg=bg, ba=ba)
        dx, dxp = _vi_build_and_solve(cam, p, poses, points, lam, use_huber)
        cand_poses = se3.retract_left(poses, dx[:, 0:6])
        cand_points = points + dxp
        cand = (vel + dx[:, 6:9], bg + dx[:, 9:12], ba + dx[:, 12:15])
        cand_cost = _vi_cost(cam, prob._replace(vel=cand[0], bg=cand[1], ba=cand[2]),
                             cand_poses, cand_points, use_huber)
        accept = cand_cost < cost
        sel = lambda a, b: torch.where(accept, a, b)
        poses = SE3(sel(cand_poses.R, poses.R), sel(cand_poses.t, poses.t))
        points = sel(cand_points, points)
        vel, bg, ba = sel(cand[0], vel), sel(cand[1], bg), sel(cand[2], ba)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e4)
        cost = torch.where(accept, cand_cost, cost)
        costs.append(cost)
    return VIBAResult(poses=SE3(so3.normalize(poses.R), poses.t), points=points, vel=vel,
                      bg=bg, ba=ba, cost=torch.stack(costs))

