"""IMU initialization — a PyTorch copy of the JAX package's
`optim/inertial_init.py`: with the visual poses held fixed, estimate the
gravity direction (2 DoF around a seed rotation), the log-scale (when
`optimize_scale`), shared gyro and accel biases under priors, and one
velocity per keyframe, from the preintegrated chain.

One damped least-squares problem over the flat parameters
[theta_g (2), log_s (1), bg (3), ba (3), vel (3K)], with the Jacobian of
the whitened residual by forward-mode autodiff (one pass over a batch of
the basis directions). Each step solves the
column-scaled Jacobian stacked on the damping rows by least squares,
computed as the reference's `jnp.linalg.lstsq` computes it: an SVD with
the singular values below eps * max(m, n) of the largest dropped.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jvp

from vi_slam_tpu_torch.imu import preintegration as pre
from vi_slam_tpu_torch.lie import so3


class InertialInit(NamedTuple):
    Rwg: torch.Tensor  # (3, 3) gravity-aligning rotation: g_world = Rwg @ g0
    scale: torch.Tensor  # ()
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    vel: torch.Tensor  # (K, 3)
    cost: torch.Tensor  # (iters + 1,)


def lstsq_svd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares of A x = b (b (m,)) through the SVD,
    dropping singular values below eps * max(m, n) times the largest."""
    m, n = A.shape
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    rcond = torch.finfo(A.dtype).eps * max(m, n)
    keep = s >= rcond * s[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), torch.zeros_like(s))
    return Vh.T @ (s_inv * (U.T @ b))


def _align_z(dirG: torch.Tensor) -> torch.Tensor:
    """The rotation taking (0, 0, -1) onto the unit vector dirG."""
    g0_hat = torch.tensor([0.0, 0.0, -1.0], dtype=dirG.dtype, device=dirG.device)
    vaxis = torch.linalg.cross(g0_hat, dirG)
    s = torch.linalg.vector_norm(vaxis)
    c = torch.dot(g0_hat, dirG)
    axis = vaxis / torch.clamp(s, min=1e-9)
    eye = torch.eye(3, dtype=dirG.dtype, device=dirG.device)
    return torch.where(s > 1e-6, so3.exp(axis * torch.atan2(s, c)), eye)


def inertial_init(Rwb: torch.Tensor, pwb: torch.Tensor, preint: pre.Preintegrated,
                  valid: torch.Tensor, prior_g: float = 1e2, prior_a: float = 1e6,
                  iters: int = 20, optimize_scale: bool = True,
                  gravity_mag: float = pre.GRAVITY, Rwg0: Optional[torch.Tensor] = None
                  ) -> InertialInit:
    """(Rwg, s, bg, ba, velocities) against fixed body poses Rwb (K, 3, 3),
    pwb (K, 3) and the (K-1,) chain with its edge mask. `Rwg0` seeds the
    gravity rotation."""
    K = Rwb.shape[0]
    dtype = pwb.dtype
    dev = pwb.device
    g0 = torch.tensor([0.0, 0.0, -gravity_mag], dtype=dtype, device=dev)
    if Rwg0 is None:
        Rwg0 = torch.eye(3, dtype=dtype, device=dev)
    dt = torch.clamp(preint.dt, min=1e-3)
    v_guess = (pwb[1:] - pwb[:-1]) / dt[:, None]
    v0 = torch.cat([v_guess, v_guess[-1:]], dim=0)
    log_s0 = torch.zeros((), dtype=dtype, device=dev)
    w = valid.to(dtype)

    if optimize_scale:
        # a closed-form linear seed of (s, g, v): with the rotations fixed
        # the preintegration constraints are linear in them
        E = K - 1
        n_lin = 4 + 3 * K
        r1dP = (Rwb[:-1] @ preint.dP[..., None])[..., 0]
        r1dV = (Rwb[:-1] @ preint.dV[..., None])[..., 0]
        I3 = torch.eye(3, dtype=dtype, device=dev)
        rows_A, rows_b = [], []
        for k in range(E):
            Ap = torch.zeros((3, n_lin), dtype=dtype, device=dev)
            Ap[:, 0] = pwb[k + 1] - pwb[k]
            Ap[:, 1:4] = -0.5 * dt[k] * dt[k] * I3
            Ap[:, 4 + 3 * k:7 + 3 * k] = -dt[k] * I3
            Av = torch.zeros((3, n_lin), dtype=dtype, device=dev)
            Av[:, 1:4] = -dt[k] * I3
            Av[:, 4 + 3 * k:7 + 3 * k] = -I3
            Av[:, 7 + 3 * k:10 + 3 * k] = I3
            rows_A += [Ap * w[k], Av * w[k]]
            rows_b += [r1dP[k] * w[k], r1dV[k] * w[k]]
        x_lin = lstsq_svd(torch.cat(rows_A, 0), torch.cat(rows_b, 0))
        s_lin, g_lin, v_lin = x_lin[0], x_lin[1:4], x_lin[4:].reshape(K, 3)
        g_norm = torch.linalg.vector_norm(g_lin)
        ok_lin = (torch.isfinite(s_lin) & (s_lin > 1e-3) & (s_lin < 1e6)
                  & torch.all(torch.isfinite(g_lin)) & torch.all(torch.isfinite(v_lin))
                  & (g_norm > 1e-3))
        log_s0 = torch.where(ok_lin, torch.log(torch.clamp(s_lin, 1e-3, 1e6)), log_s0)
        v0 = torch.where(ok_lin, v_lin, v0)
        Rwg0 = torch.where(ok_lin, _align_z(g_lin / torch.clamp(g_norm, min=1e-9)), Rwg0)

    info = pre.information(preint)  # (K-1, 9, 9)
    L = torch.linalg.cholesky_ex(info + 1e-10 * torch.eye(9, dtype=dtype, device=dev))[0]
    sq_g = torch.sqrt(torch.tensor(prior_g, dtype=dtype, device=dev))
    sq_a = torch.sqrt(torch.tensor(prior_a, dtype=dtype, device=dev))

    def unpack(params):
        """params (B, n) -> batched (Rwg, s, bg, ba, vel)."""
        theta = params[..., 0:2]
        Rwg = Rwg0 @ so3.exp(torch.cat([theta, torch.zeros_like(theta[..., :1])], -1))
        s = torch.exp(params[..., 2]) if optimize_scale else torch.ones_like(params[..., 2])
        return Rwg, s, params[..., 3:6], params[..., 6:9], params[..., 9:].reshape(-1, K, 3)

    def residuals(params):
        Rwg, s, bg, ba, vel = unpack(params)
        g_w = (Rwg @ g0[:, None])[..., 0]
        s3 = s[:, None, None]
        r = pre.inertial_residual(preint, Rwb[:-1], vel[:, :-1], s3 * pwb[:-1], Rwb[1:],
                                  vel[:, 1:], s3 * pwb[1:], bg[:, None], ba[:, None],
                                  g_w[:, None])  # (B, K-1, 9)
        rw = torch.einsum("eij,bei->bej", L, r) * w[:, None]
        return torch.cat([rw.reshape(params.shape[0], -1), sq_g * bg, sq_a * ba], -1)

    n_params = 9 + 3 * K
    params = torch.zeros((n_params,), dtype=dtype, device=dev)
    params[2] = log_s0
    params[9:] = v0.reshape(-1)
    eye_n = torch.eye(n_params, dtype=dtype, device=dev)
    zeros_n = torch.zeros((n_params,), dtype=dtype, device=dev)
    cost_of = lambda p: torch.sum(residuals(p[None])[0] ** 2)
    cost = cost_of(params)
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    costs = [cost]
    for _ in range(iters):
        # one forward-mode pass over the batch of the n basis directions
        r, dr = jvp(residuals, (params.expand(n_params, n_params).contiguous(),), (eye_n,))
        r, J = r[0], dr.T
        col = torch.linalg.vector_norm(J, dim=0)
        col = torch.where(col > 1e-12, col, torch.ones_like(col))
        A = torch.cat([J / col, torch.sqrt(lam) * eye_n], 0)
        dx = -lstsq_svd(A, torch.cat([r, zeros_n])) / col
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        cand = params + dx
        cand_cost = cost_of(cand)
        accept = cand_cost < cost
        params = torch.where(accept, cand, params)
        cost = torch.where(accept, cand_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0), 1e-10, 1e3)
        costs.append(cost)
    Rwg, s, bg, ba, vel = unpack(params[None])
    return InertialInit(Rwg=Rwg[0], scale=s[0], bg=bg[0], ba=ba[0], vel=vel[0],
                        cost=torch.stack(costs))


def apply_scaled_rotation(Rcw, tcw, points, vel, Rwg, scale
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Re-express a map in the gravity-aligned, metric frame: world' =
    Rwg^T world, positions scaled by s; Tcw' = [Rcw Rwg | s tcw]."""
    Rgw = Rwg.transpose(-1, -2)
    return (Rcw @ Rgw.transpose(-1, -2), scale * tcw,
            scale * torch.einsum("ij,mj->mi", Rgw, points),
            scale * torch.einsum("ij,kj->ki", Rgw, vel))
