"""Per-frame visual-inertial pose optimization — a PyTorch copy of the JAX
package's `optim/pose_inertial.py`.

`pose_inertial_prior_optimize` is the tracking solve of the inertial
pipeline: the previous frame's state [pose, velocity, gyro bias, accel
bias] under its marginal prior and the current frame's state under the
visual observations, joined by one preintegrated inertial edge and the
bias random walks. After the Gauss-Newton rounds the previous state is
Schur-marginalized out, which gives the next frame's prior.
`pose_inertial_optimize` is the smaller solve of the current pose and
velocity alone against a fixed previous state.

The visual block reuses `pose_opt`'s residuals and Jacobians. The
reference linearizes the inertial and prior residuals by forward-mode
autodiff at the zero tangent; the tracking solve here uses their
analytic Jacobians (`inertial_residual_jac`, `se3.left_jacobian_inverse`),
equal to the autodiff ones to float32 rounding and a few hundred small
ops fewer per step, which on the card are the step's time. The smaller
`pose_inertial_optimize` keeps forward-mode autodiff (one pass over a
batch of the basis directions). Nothing here waits for the host: a
non-finite step is dropped on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jvp

from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.imu import preintegration as pre
from vi_slam_tpu_torch.lie import se3, so3
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.optim import robust
from vi_slam_tpu_torch.optim.pose_opt import PoseObs, _chi2, _residual_jac


def _mv(R, x):
    return (R @ x[..., None])[..., 0]


def body_from_cam(T_cw: SE3, R_bc: torch.Tensor, t_bc: torch.Tensor):
    """World-frame body rotation and position (Rwb, pwb) of a camera pose
    Tcw, with T_bc mapping camera-frame points to the body frame
    (batched over the pose)."""
    R_bw = R_bc @ T_cw.R
    t_bw = _mv(R_bc, T_cw.t) + t_bc
    Rwb = R_bw.transpose(-1, -2)
    return Rwb, -_mv(Rwb, t_bw)


def inertial_residual_jac(preint: pre.Preintegrated, T1: SE3, v1, bg1, ba1, T2: SE3, v2,
                          gravity_w, R_bc, t_bc) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inertial residual between two camera states (batched over
    leading dimensions) and its Jacobian (..., 9, 24) with respect to the
    tangent [xi1 (6), dv1, dbg1, dba1 | xi2 (6), dv2], poses perturbed on
    the left as `se3.retract_left` does (which also normalizes the
    rotations: the residual is taken there): the derivatives of the
    residual in the body states (Forster et al.), chained through the
    camera-to-body transform."""
    T1 = SE3(so3.normalize(T1.R), T1.t)
    T2 = SE3(so3.normalize(T2.R), T2.t)
    R1, p1 = body_from_cam(T1, R_bc, t_bc)
    R2, p2 = body_from_cam(T2, R_bc, t_bc)
    dR, dV, dP = pre.delta_with_bias(preint, bg1, ba1)
    dt = preint.dt[..., None]
    R1t = R1.transpose(-1, -2)
    eR = so3.log(dR.transpose(-1, -2) @ R1t @ R2)
    wv = v2 - v1 - gravity_w * dt
    wp = p2 - p1 - v1 * dt - 0.5 * gravity_w * dt * dt
    r = torch.cat([eR, _mv(R1t, wv) - dV, _mv(R1t, wp) - dP], dim=-1)
    Jri = so3.inverse_right_jacobian(eR)
    # body rotation: R_wb' = R_wb Exp(-R_bc phi); body position:
    # p_wb' = p_wb - R_cw^T (rho + hat(R_bc^T t_bc) phi)
    u_hat = so3.hat(_mv(R_bc.transpose(-1, -2), t_bc))
    Rc1t, Rc2t = T1.R.transpose(-1, -2), T2.R.transpose(-1, -2)
    dbg = _mv(preint.JRg, bg1 - preint.bias_gyro)
    Z = torch.zeros_like(R1t)
    dt3 = dt[..., None]
    R1tRc1t, R1tRc2t = R1t @ Rc1t, R1t @ Rc2t
    rows = [
        [Z, -(-Jri @ R2.transpose(-1, -2) @ R1) @ R_bc, Z,
         -Jri @ so3.exp(eR).transpose(-1, -2) @ so3.right_jacobian(dbg) @ preint.JRg, Z,
         Z, -Jri @ R_bc, Z],
        [Z, -so3.hat(_mv(R1t, wv)) @ R_bc, -R1t, -preint.JVg, -preint.JVa, Z, Z, R1t],
        [R1tRc1t, -so3.hat(_mv(R1t, wp)) @ R_bc + R1tRc1t @ u_hat, -R1t * dt3, -preint.JPg,
         -preint.JPa, -R1tRc2t, -R1tRc2t @ u_hat, Z],
    ]
    return r, torch.cat([torch.cat(row, dim=-1) for row in rows], dim=-2)


def _jac(f, n: int, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f(0), df/dd at 0) for f of a (B, n) batch of tangents returning
    (B, m): one forward-mode pass over the batch of the n basis
    directions, each at the zero tangent."""
    zero = torch.zeros((n, n), dtype=like.dtype, device=like.device)
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    r, dr = jvp(f, (zero,), (eye,))
    return r[0], dr.T


def _huber_w(obs: PoseObs, chi2: torch.Tensor, use_huber: bool) -> torch.Tensor:
    w = 1.0 / obs.sigma2
    if use_huber:
        delta2 = torch.where(obs.stereo, torch.full_like(chi2, robust.CHI2_STEREO),
                             torch.full_like(chi2, robust.CHI2_MONO))
        w = w * robust.huber_weight(chi2 / delta2, 1.0)
    return w


def _visual_block(cam, T: SE3, obs: PoseObs, inlier: torch.Tensor, use_huber: bool):
    r, J, row_mask = _residual_jac(cam, T, obs)
    row_mask = row_mask * inlier[:, None].to(r.dtype)
    w = _huber_w(obs, _chi2(r, row_mask, obs.sigma2), use_huber)
    Jm = J * row_mask[..., None]
    rm = r * row_mask
    return (torch.einsum("nki,nkj,n->ij", Jm, Jm, w), torch.einsum("nki,nk,n->i", Jm, rm, w))


def _reclassify(cam, T: SE3, obs: PoseObs, chi2_th: torch.Tensor) -> torch.Tensor:
    r, _, row_mask = _residual_jac(cam, T, obs)
    chi2 = _chi2(r, row_mask, obs.sigma2)
    return obs.valid & (chi2 <= chi2_th) & (row_mask[:, 0] > 0)


def _solve_step(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    n = H.shape[0]
    damp = 1e-6 * torch.trace(H) / n + 1e-9
    dx = -torch.linalg.solve_ex(H + damp * torch.eye(n, dtype=H.dtype, device=H.device),
                                g[:, None])[0][:, 0]
    return torch.where(torch.all(torch.isfinite(dx)), dx, torch.zeros_like(dx))


def pose_inertial_optimize(cam: CameraParams, T_init: SE3, v_init: torch.Tensor, obs: PoseObs,
                           preint: pre.Preintegrated, R1, v1, p1, bg, ba, gravity_w, R_bc, t_bc,
                           rounds: int = 3, iters: int = 6):
    """The current pose and velocity against the visual observations and
    one inertial edge from a fixed previous body state (R1, v1, p1).
    Returns (T_opt, v_opt, inlier mask, number of inliers)."""
    info9 = pre.information(preint)
    chi2_th = torch.where(obs.stereo, torch.full_like(obs.sigma2, robust.CHI2_STEREO),
                          torch.full_like(obs.sigma2, robust.CHI2_MONO))

    def inertial_res(d, T: SE3, v):
        Tc = se3.retract_left(T, d[..., 0:6])
        R2, p2 = body_from_cam(Tc, R_bc, t_bc)
        return pre.inertial_residual(preint, R1, v1, p1, R2, v + d[..., 6:9], p2, bg, ba,
                                     gravity_w)

    T, v, inlier = T_init, v_init, obs.valid
    for rnd in range(rounds):
        for _ in range(iters):
            H = torch.zeros((9, 9), dtype=v.dtype, device=v.device)
            g = torch.zeros((9,), dtype=v.dtype, device=v.device)
            Hv, gv = _visual_block(cam, T, obs, inlier, rnd < 2)
            H[:6, :6] = Hv
            g[:6] = gv
            r_in, J_in = _jac(lambda d: inertial_res(d, T, v), 9, v)
            H = H + J_in.T @ info9 @ J_in
            g = g + J_in.T @ info9 @ r_in
            dx = _solve_step(H, g)
            T, v = se3.retract_left(T, dx[0:6]), v + dx[6:9]
        inlier = _reclassify(cam, T, obs, chi2_th)
    return T, v, inlier, torch.sum(inlier)


class MarginalPrior(NamedTuple):
    """A 15-dim marginal prior on a frame state: information and its
    linearization point."""

    H: torch.Tensor  # (15, 15)
    R: torch.Tensor  # (3, 3) Tcw rotation
    t: torch.Tensor  # (3,)
    vel: torch.Tensor  # (3,)
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)


def initial_prior(T: SE3, vel, bg, ba, dtype=torch.float32) -> MarginalPrior:
    """The prior seeded at a freshly initialized state: pose pinned by
    the visual solve, velocity moderately, biases strongly."""
    dev = T.R.device
    d = torch.tensor([1e3] * 6 + [1e2] * 3 + [1e4] * 6, dtype=dtype, device=dev)
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    return MarginalPrior(H=torch.diag(d), R=T.R, t=T.t, vel=as_t(vel), bg=as_t(bg), ba=as_t(ba))


def pose_inertial_prior_optimize(cam: CameraParams, prior: MarginalPrior, T1_init: SE3,
                                 v1_init, bg1_init, ba1_init, T2_init: SE3, v2_init,
                                 obs: PoseObs, preint: pre.Preintegrated, gravity_w, R_bc, t_bc,
                                 walk_info_g, walk_info_a, rounds: int = 2, iters: int = 5):
    """Both frame states move: the previous [pose, vel, bg, ba] under its
    marginal prior, the current under the visual observations, joined by
    the inertial edge (biases of the previous state) and the bias random
    walks. Tangent (30,): [xi1 dv1 dbg1 dba1 | xi2 dv2 dbg2 dba2].
    Returns (T2, v2, bg2, ba2, next prior, inlier mask, number of
    inliers)."""
    dtype = T2_init.t.dtype
    dev = T2_init.t.device
    info9 = pre.information(preint)
    chi2_th = torch.where(obs.stereo, torch.full_like(obs.sigma2, robust.CHI2_STEREO),
                          torch.full_like(obs.sigma2, robust.CHI2_MONO))
    prior_T_inv = SE3(prior.R, prior.t).inverse()
    I3 = torch.eye(3, dtype=dtype, device=dev)
    J_p = torch.zeros((15, 30), dtype=dtype, device=dev)  # the prior's Jacobian
    J_p[6:15, 6:15] = torch.eye(9, dtype=dtype, device=dev)
    zeros96 = torch.zeros((9, 6), dtype=dtype, device=dev)

    def build_system(st, inlier, use_huber):
        H = torch.zeros((30, 30), dtype=dtype, device=dev)
        g = torch.zeros((30,), dtype=dtype, device=dev)
        Hv, gv = _visual_block(cam, st[4], obs, inlier, use_huber)
        H[15:21, 15:21] += Hv
        g[15:21] += gv
        T1, v1, bg1, ba1, T2, v2 = st[:6]
        r_i, J_i = inertial_residual_jac(preint, T1, v1, bg1, ba1, T2, v2, gravity_w, R_bc, t_bc)
        J_i = torch.cat([J_i, zeros96], dim=-1)  # bg2, ba2 do not enter
        H = H + J_i.T @ info9 @ J_i
        g = g + J_i.T @ info9 @ r_i
        bg1, ba1, bg2, ba2 = st[2], st[3], st[6], st[7]
        for a, b, wi in ((9, 24, walk_info_g), (12, 27, walk_info_a)):
            Iw = I3 * wi
            H[a:a + 3, a:a + 3] += Iw
            H[b:b + 3, b:b + 3] += Iw
            H[a:a + 3, b:b + 3] += -Iw
            H[b:b + 3, a:a + 3] += -Iw
        r_bg = bg2 - bg1
        r_ba = ba2 - ba1
        g[24:27] += walk_info_g * r_bg
        g[9:12] += -walk_info_g * r_bg
        g[27:30] += walk_info_a * r_ba
        g[12:15] += -walk_info_a * r_ba
        # the prior, at the rotation retract_left(T1, 0) normalizes to
        r_pose = se3.log(SE3(so3.normalize(T1.R), T1.t).compose(prior_T_inv))
        r_p = torch.cat([r_pose, v1 - prior.vel, bg1 - prior.bg, ba1 - prior.ba])
        J_p[0:6, 0:6] = se3.left_jacobian_inverse(r_pose)
        H = H + J_p.T @ prior.H @ J_p
        g = g + J_p.T @ prior.H @ r_p
        return H, g

    def retract(st, dx):
        T1, v1, bg1, ba1, T2, v2, bg2, ba2 = st
        return (se3.retract_left(T1, dx[0:6]), v1 + dx[6:9], bg1 + dx[9:12], ba1 + dx[12:15],
                se3.retract_left(T2, dx[15:21]), v2 + dx[21:24], bg2 + dx[24:27],
                ba2 + dx[27:30])

    st = (T1_init, v1_init, bg1_init, ba1_init, T2_init, v2_init, bg1_init, ba1_init)
    inlier = obs.valid
    for rnd in range(rounds):
        for _ in range(iters):
            H, g = build_system(st, inlier, rnd < 1)
            st = retract(st, _solve_step(H, g))
        inlier = _reclassify(cam, st[4], obs, chi2_th)

    # marginalize state 1 out of the converged system: the next prior
    H, _ = build_system(st, inlier, False)
    H11 = H[0:15, 0:15] + 1e-6 * torch.eye(15, dtype=dtype, device=dev)
    H12 = H[0:15, 15:30]
    H_marg = H[15:30, 15:30] - H12.T @ torch.linalg.solve_ex(H11, H12)[0]
    H_marg = 0.5 * (H_marg + H_marg.T)
    T2, v2, bg2, ba2 = st[4], st[5], st[6], st[7]
    prior_next = MarginalPrior(H=H_marg, R=T2.R, t=T2.t, vel=v2, bg=bg2, ba=ba2)
    return T2, v2, bg2, ba2, prior_next, inlier, torch.sum(inlier)


def predict_camera_pose(preint: pre.Preintegrated, T_last_cw: SE3, v1, bg, ba, gravity_w,
                        R_bc, t_bc) -> Tuple[SE3, torch.Tensor]:
    """IMU dead reckoning: the previous body state through the deltas;
    returns the predicted camera Tcw and body velocity."""
    R1, p1 = body_from_cam(T_last_cw, R_bc, t_bc)
    dR, dV, dP = pre.delta_with_bias(preint, bg, ba)
    dt = preint.dt
    R2 = R1 @ dR
    v2 = v1 + gravity_w * dt + _mv(R1, dV)
    p2 = p1 + v1 * dt + 0.5 * gravity_w * dt * dt + _mv(R1, dP)
    R_bw = R2.transpose(-1, -2)
    t_bw = -_mv(R_bw, p2)
    R_cb = R_bc.transpose(-1, -2)
    t_cb = -_mv(R_cb, t_bc)
    return SE3(so3.normalize(R_cb @ R_bw), _mv(R_cb, t_bw) + t_cb), v2
