"""Essential-graph (pose-graph) optimization over Sim3 or SE3 — a PyTorch
copy of the JAX package's `optim/pose_graph.py`.

Gauss-Newton over the keyframe poses S_iw with batched edge residuals
r_e = log(S_meas_ji o S_iw o S_jw^-1) and right perturbations
S_iw <- S_iw o exp(xi). Per-edge Jacobians are forward-mode autodiff, as
in the reference; the 14x14 edge blocks are scatter-added into a dense
(7K, 7K) system, projected onto each vertex's free tangent subspace
(identity on the locked one, zero for a fixed vertex) and solved by
Cholesky.

Modes: "sim3" (7 DoF), "se3" (scale locked) and "4dof" (yaw and
translation, for gravity-aligned inertial maps): with a `yaw_axis` the
rotation block of each vertex's projection is g g^T for the unit gravity
direction g, without one the world z axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from vi_slam_tpu_torch.lie import sim3 as sim3_m
from vi_slam_tpu_torch.lie.sim3 import Sim3

_DOF_MASKS = {
    # tangent layout [rho (3), phi (3), sigma]
    "sim3": (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0),
    "se3": (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0),
    "4dof": (1.0, 1.0, 1.0, 0.0, 0.0, 1.0, 0.0),
}


class PoseGraphResult(NamedTuple):
    poses: Sim3  # optimized S_iw (K,)
    final_cost: torch.Tensor


def _edge_residual(Si: Sim3, Sj: Sim3, Sm: Sim3, xi_i: torch.Tensor, xi_j: torch.Tensor):
    Si_p = Si.compose(sim3_m.exp(xi_i))
    Sj_p = Sj.compose(sim3_m.exp(xi_j))
    return sim3_m.log(Sm.compose(Si_p.compose(Sj_p.inverse())))


def _edge_jacobians(Si: Sim3, Sj: Sim3, Sm: Sim3):
    """Residuals (E, 7) and their Jacobians (E, 7, 7) wrt xi_i and xi_j:
    forward mode along the 14 tangent directions at once. (The edges stay
    a batch dimension: per-edge 0-dim scalars under torch.func promote
    Python constants to float64.)"""
    E = Si.t.shape[0]
    zero = torch.zeros((E, 7), dtype=Si.t.dtype, device=Si.t.device)
    basis = torch.eye(14, dtype=zero.dtype, device=zero.device)[:, None, :].expand(14, E, 14)

    def f(xi_i, xi_j):
        return _edge_residual(Si, Sj, Sm, xi_i, xi_j)

    def push(d):
        return jvp(f, (zero, zero), (d[..., :7].contiguous(), d[..., 7:].contiguous()))[1]

    J = vmap(push)(basis)  # (14, E, 7)
    J = J.permute(1, 2, 0)
    return f(zero, zero), J[..., :7], J[..., 7:]


def optimize_pose_graph(poses: Sim3, edges_ij: torch.Tensor, meas: Sim3, edge_valid: torch.Tensor,
                        edge_weight: torch.Tensor, fixed: torch.Tensor, iters: int = 20,
                        mode: str = "sim3", yaw_axis: torch.Tensor | None = None
                        ) -> PoseGraphResult:
    """Optimize keyframe poses S_iw (K,) over relative-pose constraints.

    edges_ij: (E, 2) vertex ids (i, j); meas: (E,) S_ji measurements;
    edge_valid: (E,) bool; edge_weight: (E,); fixed: (K,) bool anchored
    vertices; yaw_axis: (3,) world gravity direction of "4dof"."""
    dt = poses.t.dtype
    dev = poses.t.device
    K = poses.t.shape[0]
    n = 7 * K
    ii = torch.clamp(edges_ij[:, 0].long(), 0, K - 1)
    jj = torch.clamp(edges_ij[:, 1].long(), 0, K - 1)
    P7 = torch.diag(torch.tensor(_DOF_MASKS[mode], dtype=dt, device=dev))
    if mode == "4dof" and yaw_axis is not None:
        g = yaw_axis.to(dt)
        g = g / torch.clamp(torch.linalg.vector_norm(g), min=1e-9)
        P7[3:6, 3:6] = torch.outer(g, g)
    Pk = torch.where(fixed[:, None, None], torch.zeros((), dtype=dt, device=dev), P7[None])
    ar7 = torch.arange(7, device=dev)
    kidx = torch.arange(K, device=dev)[:, None] * 7 + ar7[None, :]
    gidx = torch.cat([ii[:, None] * 7 + ar7, jj[:, None] * 7 + ar7], dim=-1)  # (E, 14)
    E = gidx.shape[0]
    w = (edge_valid.to(dt) * edge_weight)[:, None]
    eye7 = torch.eye(7, dtype=dt, device=dev)
    eye_n = torch.eye(n, dtype=dt, device=dev)

    def apply_P_vec(v):
        return torch.einsum("kij,kj->ki", Pk, v.reshape(K, 7)).reshape(-1)

    cost = torch.zeros((), dtype=dt, device=dev)
    for _ in range(iters):
        r, Jii, Jjj = _edge_jacobians(poses.index(ii), poses.index(jj), meas)
        rw = r * w
        J = torch.cat([Jii, Jjj], dim=-1)  # (E, 7, 14)
        Jw = J * w[..., None]
        Hblk = torch.einsum("eri,erj->eij", Jw, J)
        bblk = -torch.einsum("eri,er->ei", Jw, r)
        H = torch.zeros((n, n), dtype=dt, device=dev)
        H.index_put_((gidx[:, :, None].expand(E, 14, 14), gidx[:, None, :].expand(E, 14, 14)),
                     Hblk, accumulate=True)
        b = torch.zeros((n,), dtype=dt, device=dev).index_add_(0, gidx.reshape(-1), bblk.reshape(-1))
        # H <- P H P, identity on the locked subspace, so that Cholesky
        # stays positive definite and the locked dofs solve to zero
        H = torch.einsum("kij,kjN->kiN", Pk, H.reshape(K, 7, n)).reshape(n, n)
        H = torch.einsum("Nkj,kij->Nki", H.reshape(n, K, 7), Pk).reshape(n, n)
        H = H.index_put((kidx[:, :, None].expand(K, 7, 7), kidx[:, None, :].expand(K, 7, 7)),
                        eye7[None] - Pk, accumulate=True)
        H = H + 1e-6 * eye_n
        L = torch.linalg.cholesky_ex(H)[0]
        dx = torch.cholesky_solve(apply_P_vec(b)[:, None], L)[:, 0]
        poses = poses.compose(sim3_m.exp(apply_P_vec(dx).reshape(K, 7)))
        cost = torch.sum(rw * rw)
    return PoseGraphResult(poses=poses, final_cost=cost)

