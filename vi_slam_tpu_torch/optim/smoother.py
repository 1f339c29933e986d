"""Fixed-lag visual-inertial smoother — a PyTorch copy of the JAX package's
`optim/smoother.py`.

A batch Gauss-Newton over a window of W frame states, each 15 wide
[pose (6) | velocity (3) | gyro bias (3) | accel bias (3)], slot 0 the
oldest. The dense (15W, 15W) system holds motion-only visual anchors per
slot (fixed world points and their pixels), the preintegrated inertial
edges between consecutive slots, the bias random walks, and a 15x15
marginal prior on slot 0. Sliding the window Schur-eliminates slot 0 onto
slot 1, whose prior the result becomes.

The reference linearizes every block by forward-mode autodiff at the zero
tangent. Here the blocks have analytic Jacobians: the 2x6 pinhole
Jacobian under `retract_left` for the anchors, `pose_inertial
.inertial_residual_jac` for the inertial edges (the reference's 24-wide
tangent [xi_i, dv_i, dbg_i, dba_i | xi_j, dv_j]) and SE(3)'s inverse left
Jacobian for the prior, each batched over the slots or edges. All blocks
land in the system through one indexed add with indices built once per
window size. Nothing here waits for the host but `torch.linalg.eigh` in
`marginalize_oldest`, which synchronizes on a CUDA device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vi_slam_tpu_torch.cameras import pinhole
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.imu import preintegration as pre
from vi_slam_tpu_torch.lie import se3, so3
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.ops.fast import top_k
from vi_slam_tpu_torch.optim.pose_inertial import inertial_residual_jac
from vi_slam_tpu_torch.utils.device import resolve_device

D = 15  # state width

# the weak pose / velocity gauge and the stronger bias priors of a fresh
# window's slot 0
PRIOR_H0_DIAG = [1e2] * 6 + [1e1] * 3 + [1e4] * 3 + [1e3] * 3


class SmootherWindow(NamedTuple):
    """Fixed-capacity sliding window (W slots, slot 0 the oldest)."""

    T_R: torch.Tensor  # (W, 3, 3) Tcw
    T_t: torch.Tensor  # (W, 3)
    vel: torch.Tensor  # (W, 3)
    bg: torch.Tensor  # (W, 3)
    ba: torch.Tensor  # (W, 3)
    valid: torch.Tensor  # (W,) bool
    preint: pre.Preintegrated  # (W-1, ...) between consecutive slots
    inertial_valid: torch.Tensor  # (W-1,) bool
    vis_xw: torch.Tensor  # (W, V, 3) anchor world points
    vis_uv: torch.Tensor  # (W, V, 2) their pixels
    vis_sigma2: torch.Tensor  # (W, V)
    vis_valid: torch.Tensor  # (W, V) bool
    prior_H: torch.Tensor  # (15, 15) information of slot 0's prior
    prior_R: torch.Tensor  # (3, 3) its linearization point
    prior_t: torch.Tensor  # (3,)
    prior_vel: torch.Tensor  # (3,)
    prior_bg: torch.Tensor  # (3,)
    prior_ba: torch.Tensor  # (3,)


def allocate_window(w: int, v: int, dtype=torch.float32, device="cuda") -> SmootherWindow:
    """An empty window of `w` slots with `v` anchors each."""
    device = resolve_device(device)
    f = dict(dtype=dtype, device=device)
    z = lambda *s: torch.zeros(s, **f)
    return SmootherWindow(
        T_R=torch.eye(3, **f).expand(w, 3, 3).clone(), T_t=z(w, 3), vel=z(w, 3), bg=z(w, 3),
        ba=z(w, 3), valid=torch.zeros((w,), dtype=torch.bool, device=device),
        preint=pre.identity_preintegrated((w - 1,), dtype=dtype, device=device),
        inertial_valid=torch.zeros((w - 1,), dtype=torch.bool, device=device),
        vis_xw=z(w, v, 3), vis_uv=z(w, v, 2), vis_sigma2=torch.ones((w, v), **f),
        vis_valid=torch.zeros((w, v), dtype=torch.bool, device=device),
        prior_H=z(D, D), prior_R=torch.eye(3, **f), prior_t=z(3), prior_vel=z(3), prior_bg=z(3),
        prior_ba=z(3),
    )


def window_from_numpy(win, device="cuda") -> SmootherWindow:
    """The reference's SmootherWindow (arrays, its `preint` a
    Preintegrated of arrays) -> the port's on `device`."""
    device = resolve_device(device)

    def t(x):
        x = np.asarray(x)
        return torch.from_numpy(np.array(x, np.float32 if x.dtype.kind == "f" else x.dtype)
                                ).to(device)

    fields = {k: t(getattr(win, k)) for k in SmootherWindow._fields if k != "preint"}
    return SmootherWindow(preint=pre.preintegrated_from_numpy(win.preint, device=device),
                          **fields)


_INDEX_CACHE: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}


def _block_indices(W: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat indices into the (15W, 15W) system and the (15W,) gradient of
    every block `_blocks` returns, in its order: the anchors' 6x6 pose
    blocks per slot, the inertial 24x24 blocks per edge, the bias walks'
    6x6 blocks per edge (gyro, then accel), the prior's 15x15."""
    key = (W, str(device))
    if key not in _INDEX_CACHE:
        n = D * W
        k = torch.arange(W)[:, None]
        e = torch.arange(W - 1)[:, None]
        vis = D * k + torch.arange(6)  # (W, 6)
        s = torch.arange(15)
        inert = torch.cat([D * e + s, D * (e + 1) + s[:9]], dim=1)  # (W-1, 24)
        walk = torch.stack([torch.cat([D * e + off + s[:3], D * (e + 1) + off + s[:3]], dim=1)
                            for off in (9, 12)], dim=1).reshape(-1, 6)  # (2(W-1), 6)
        rows = [vis, inert, walk, s[None]]
        H_idx = torch.cat([(r[:, :, None] * n + r[:, None, :]).reshape(-1) for r in rows])
        b_idx = torch.cat([r.reshape(-1) for r in rows])
        _INDEX_CACHE[key] = (H_idx.to(device), b_idx.to(device))
    return _INDEX_CACHE[key]


def _nan_unless(ok: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """A Cholesky factor, NaN where the factorization failed (what the
    reference's `cholesky` returns there)."""
    return torch.where((ok == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def _blocks(cam: CameraParams, win: SmootherWindow, gravity, walk_info_g, walk_info_a):
    """The blocks of the system at the current estimate, in
    `_block_indices`' order: (H values, b values, cost)."""
    dtype, dev = win.T_t.dtype, win.T_t.device
    W = win.T_R.shape[0]
    I3 = torch.eye(3, dtype=dtype, device=dev)

    # anchors: residual (pred - uv) * sqrt(valid / sigma2), behind-camera rows
    # zeroed; left-perturbed pose: d pc / d xi = [I, -hat(pc)]
    R = so3.normalize(win.T_R)
    pc = (R[:, None] @ win.vis_xw[..., None])[..., 0] + win.T_t[:, None]
    s = torch.sqrt(win.vis_valid.to(dtype) / torch.clamp(win.vis_sigma2, min=1e-9))
    s = s * (pc[..., 2] > 0.1).to(dtype)
    r_v = (pinhole.project(cam, pc) - win.vis_uv) * s[..., None]  # (W, V, 2)
    J_v = pinhole.project_jac(cam, pc) @ torch.cat(
        [I3.expand(*pc.shape[:-1], 3, 3), -so3.hat(pc)], dim=-1) * s[..., None, None]
    H_v = torch.einsum("wvki,wvkj->wij", J_v, J_v)
    b_v = -torch.einsum("wvki,wvk->wi", J_v, r_v)
    c_v = torch.sum(r_v * r_v)

    # inertial edges (identity extrinsic: the window holds camera poses),
    # sqrt-information weighted
    Ti = SE3(win.T_R[:-1], win.T_t[:-1])
    Tj = SE3(win.T_R[1:], win.T_t[1:])
    r_i, J_i = inertial_residual_jac(win.preint, Ti, win.vel[:-1], win.bg[:-1], win.ba[:-1], Tj,
                                     win.vel[1:], gravity, I3, torch.zeros(3, dtype=dtype,
                                                                           device=dev))
    info = pre.information(win.preint) + 1e-6 * torch.eye(9, dtype=dtype, device=dev)
    L, ok = torch.linalg.cholesky_ex(info)
    Lt = _nan_unless(ok, L).transpose(-1, -2) * win.inertial_valid.to(dtype)[:, None, None]
    r_i = (Lt @ r_i[..., None])[..., 0]
    J_i = Lt @ J_i
    H_i = J_i.transpose(-1, -2) @ J_i
    b_i = -(J_i.transpose(-1, -2) @ r_i[..., None])[..., 0]
    c_i = torch.sum(r_i * r_i)

    # bias random walks: r = b_j - b_i, per edge gyro then accel
    w_e = win.inertial_valid.to(dtype)
    wgt = torch.stack([walk_info_g * w_e, walk_info_a * w_e], dim=1)  # (W-1, 2)
    r_w = torch.stack([win.bg[1:] - win.bg[:-1], win.ba[1:] - win.ba[:-1]], dim=1)  # (W-1, 2, 3)
    pm = torch.tensor([[1.0, -1.0], [-1.0, 1.0]], dtype=dtype, device=dev)
    H_w = wgt[..., None, None] * torch.kron(pm, I3)  # (W-1, 2, 6, 6)
    b_w = torch.cat([wgt[..., None] * r_w, -wgt[..., None] * r_w], dim=-1)  # (W-1, 2, 6)
    c_w = torch.sum(wgt * torch.sum(r_w * r_w, dim=-1))

    # the prior on slot 0, at the rotation retract_left(T_0, 0) normalizes to
    T0 = SE3(R[0], win.T_t[0])
    r_pose = se3.log(T0.compose(SE3(win.prior_R, win.prior_t).inverse()))
    r_p = torch.cat([r_pose, win.vel[0] - win.prior_vel, win.bg[0] - win.prior_bg,
                     win.ba[0] - win.prior_ba])
    J_p = torch.eye(D, dtype=dtype, device=dev)
    J_p[:6, :6] = se3.left_jacobian_inverse(r_pose)
    H_p = J_p.T @ win.prior_H @ J_p
    b_p = -J_p.T @ (win.prior_H @ r_p)
    c_p = r_p @ win.prior_H @ r_p

    H_vals = torch.cat([H_v.reshape(-1), H_i.reshape(-1), H_w.reshape(-1), H_p.reshape(-1)])
    b_vals = torch.cat([b_v.reshape(-1), b_i.reshape(-1), b_w.reshape(-1), b_p])
    return H_vals, b_vals, c_v + c_i + c_w + c_p


def _build_system(cam: CameraParams, win: SmootherWindow, gravity, walk_info_g, walk_info_a):
    """The dense (15W, 15W) Gauss-Newton system at the current estimate:
    (H, b, cost), b the negative gradient."""
    W = win.T_R.shape[0]
    n = D * W
    H_idx, b_idx = _block_indices(W, win.T_t.device)
    H_vals, b_vals, cost = _blocks(cam, win, gravity, walk_info_g, walk_info_a)
    H = torch.zeros(n * n, dtype=H_vals.dtype, device=H_vals.device).index_add_(0, H_idx, H_vals)
    b = torch.zeros(n, dtype=b_vals.dtype, device=b_vals.device).index_add_(0, b_idx, b_vals)
    return H.reshape(n, n), b, cost


def _apply_delta(win: SmootherWindow, dx: torch.Tensor) -> SmootherWindow:
    W = win.T_R.shape[0]
    dx = dx.reshape(W, D) * win.valid.to(dx.dtype)[:, None]
    T = se3.retract_left(SE3(win.T_R, win.T_t), dx[:, 0:6])
    return win._replace(T_R=T.R, T_t=T.t, vel=win.vel + dx[:, 6:9], bg=win.bg + dx[:, 9:12],
                        ba=win.ba + dx[:, 12:15])


def optimize_window(cam: CameraParams, win: SmootherWindow, gravity, walk_info_g, walk_info_a,
                    iters: int = 5) -> Tuple[SmootherWindow, torch.Tensor]:
    """`iters` Gauss-Newton steps over the window, warm-started from it;
    inactive slots get identity rows. A system that is not positive
    definite gives NaN states, as the reference's Cholesky does. Returns
    the window and the cost at the last step's linearization."""
    W = win.T_R.shape[0]
    dtype = win.T_t.dtype
    cost = None
    for _ in range(iters):
        H, b, cost = _build_system(cam, win, gravity, walk_info_g, walk_info_a)
        act = win.valid.repeat_interleave(D).to(dtype)
        H = H * (act[:, None] * act[None, :])
        H = H + torch.diag(torch.where(act > 0, torch.full_like(act, 1e-6), torch.ones_like(act)))
        H = 0.5 * (H + H.T)  # the reference's Cholesky symmetrizes its input
        L, ok = torch.linalg.cholesky_ex(H)
        dx = torch.cholesky_solve((b * act)[:, None], _nan_unless(ok, L))[:, 0]
        win = _apply_delta(win, dx)
    return win, cost


def marginalize_oldest(cam: CameraParams, win: SmootherWindow, gravity, walk_info_g,
                       walk_info_a) -> SmootherWindow:
    """Slide the window: the factors touching slot 0 (its anchors, the
    edge to slot 1 with its bias walks, its prior) Schur-eliminated onto
    slot 1, whose prior the result becomes (symmetrized, eigenvalues
    clamped to [0, 1e12]); every slot moves down by one and the last is
    freed. `torch.linalg.eigh` waits for the host on a CUDA device."""
    dtype, dev = win.T_t.dtype, win.T_t.device
    touching = win._replace(
        vis_valid=torch.cat([win.vis_valid[:1], torch.zeros_like(win.vis_valid[1:])]),
        inertial_valid=torch.cat([win.inertial_valid[:1],
                                  torch.zeros_like(win.inertial_valid[1:])]))
    Ht, _, _ = _build_system(cam, touching, gravity, walk_info_g, walk_info_a)
    H00 = Ht[:D, :D] + 1e-8 * torch.eye(D, dtype=dtype, device=dev)
    H01 = Ht[:D, D:2 * D]
    H11 = Ht[D:2 * D, D:2 * D]
    H00_inv = torch.linalg.inv_ex(H00)[0]
    prior_H = H11 - H01.T @ H00_inv @ H01
    prior_H = 0.5 * (prior_H + prior_H.T)
    # torch's eigh raises on a non-finite input where the reference's
    # returns NaN: the decomposition sees zeros there, and the prior is NaN
    finite = torch.all(torch.isfinite(prior_H))
    evals, evecs = torch.linalg.eigh(torch.where(finite, prior_H, torch.zeros_like(prior_H)))
    prior_H = (evecs * torch.clamp(evals, 0.0, 1e12)[None, :]) @ evecs.T
    prior_H = torch.where(finite, prior_H, torch.full_like(prior_H, float("nan")))

    def shift(x):
        return torch.cat([x[1:], x[-1:]], dim=0)

    def freed(x):
        x = shift(x)
        x[-1] = False
        return x

    return win._replace(
        T_R=shift(win.T_R), T_t=shift(win.T_t), vel=shift(win.vel), bg=shift(win.bg),
        ba=shift(win.ba), valid=freed(win.valid), preint=pre.map_preint(shift, win.preint),
        inertial_valid=freed(win.inertial_valid), vis_xw=shift(win.vis_xw),
        vis_uv=shift(win.vis_uv), vis_sigma2=shift(win.vis_sigma2),
        vis_valid=freed(win.vis_valid), prior_H=prior_H, prior_R=win.T_R[1], prior_t=win.T_t[1],
        prior_vel=win.vel[1], prior_bg=win.bg[1], prior_ba=win.ba[1],
    )


def select_anchors(obs, anchor_ok: torch.Tensor, n: int):
    """A frame's `n` visual anchors from its pose observations: the valid
    ones of lowest sigma2 (finest pyramid levels) first, ties by the lower
    index, as `jax.lax.top_k` orders them; when fewer are valid, the rest
    are picked and flagged invalid. Returns (xw (n, 3), uv (n, 2), sigma2
    (n,), valid (n,))."""
    score = torch.where(anchor_ok, -obs.sigma2, torch.full_like(obs.sigma2, -float("inf")))
    _, sel = top_k(score, n)
    valid = anchor_ok[sel] & torch.isfinite(score[sel])
    return obs.xw[sel], obs.uvr[sel, :2], torch.clamp(obs.sigma2[sel], min=1e-6), valid


def set_slot(win: SmootherWindow, k: int, T: SE3, vel, bg, ba, vis_xw, vis_uv, vis_sigma2,
             vis_valid, preint: Optional[pre.Preintegrated] = None) -> SmootherWindow:
    """Slot `k` (in place) set to a state and its anchors, and, when
    `preint` is given (k > 0), the edge from slot k-1 to it."""
    win.T_R[k] = T.R
    win.T_t[k] = T.t
    win.vel[k] = vel
    win.bg[k] = bg
    win.ba[k] = ba
    win.valid[k] = True
    win.vis_xw[k] = vis_xw
    win.vis_uv[k] = vis_uv
    win.vis_sigma2[k] = vis_sigma2
    win.vis_valid[k] = vis_valid
    if preint is not None:
        for dst, src in zip(win.preint, preint):
            dst[k - 1] = src
        win.inertial_valid[k - 1] = True
    return win


def seed_prior(win: SmootherWindow, T: SE3, vel, bg, ba, prior_H=None) -> SmootherWindow:
    """A fresh window's prior on slot 0: `prior_H` (default the weak gauge
    of PRIOR_H0_DIAG) at the given state."""
    dtype, dev = win.T_t.dtype, win.T_t.device
    if prior_H is None:
        prior_H = torch.diag(torch.tensor(PRIOR_H0_DIAG, dtype=dtype, device=dev))
    c = lambda x: torch.as_tensor(x, dtype=dtype, device=dev).clone()
    return win._replace(prior_H=c(prior_H), prior_R=c(T.R), prior_t=c(T.t), prior_vel=c(vel),
                        prior_bg=c(bg), prior_ba=c(ba))


class FixedLagSmoother:
    """Host wrapper: push states, optimize, slide. When the window is full,
    a push marginalizes the oldest state into the prior first."""

    def __init__(self, cam: CameraParams, window: int = 10, max_vis: int = 128,
                 gravity=(0.0, 0.0, -9.81), walk_info_g: float = 1e6, walk_info_a: float = 1e4,
                 dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.cam = cam
        self.W = window
        self.V = max_vis
        self.dtype = dtype
        self.win = allocate_window(window, max_vis, dtype, self.device)
        self.n = 0  # filled slots
        f = dict(dtype=dtype, device=self.device)
        self.gravity = torch.tensor(gravity, **f)
        self.wg = torch.tensor(walk_info_g, **f)
        self.wa = torch.tensor(walk_info_a, **f)

    def push(self, T_cw: SE3, vel, preint: Optional[pre.Preintegrated], vis_xw=None, vis_uv=None,
             vis_sigma2=None, prior_H0=None) -> None:
        if self.n == self.W:
            self.win = marginalize_oldest(self.cam, self.win, self.gravity, self.wg, self.wa)
            self.n -= 1
        k = self.n
        V = self.V
        f = dict(dtype=self.dtype, device=self.device)
        xw, uv = torch.zeros((V, 3), **f), torch.zeros((V, 2), **f)
        s2 = torch.ones((V,), **f)
        vv = torch.zeros((V,), dtype=torch.bool, device=self.device)
        if vis_xw is not None and len(vis_xw):
            c = min(len(vis_xw), V)
            xw[:c] = torch.as_tensor(np.asarray(vis_xw[:c]), **f)
            uv[:c] = torch.as_tensor(np.asarray(vis_uv[:c]), **f)
            if vis_sigma2 is not None:
                s2[:c] = torch.as_tensor(np.asarray(vis_sigma2[:c]), **f)
            vv[:c] = True
        w = self.win
        prev = max(k - 1, 0)
        bg, ba = w.bg[prev].clone(), w.ba[prev].clone()
        vel = torch.as_tensor(np.asarray(vel) if not torch.is_tensor(vel) else vel, **f)
        w = set_slot(w, k, T_cw, vel, bg, ba, xw, uv, s2, vv,
                     preint if k > 0 and preint is not None else None)
        if k == 0:
            w = seed_prior(w, T_cw, vel, w.bg[0], w.ba[0], prior_H0)
        self.win = w
        self.n += 1

    def optimize(self, iters: int = 5) -> float:
        self.win, cost = optimize_window(self.cam, self.win, self.gravity, self.wg, self.wa,
                                         iters=iters)
        return float(cost)

    def latest(self) -> Tuple[SE3, np.ndarray, np.ndarray, np.ndarray]:
        k = self.n - 1
        w = self.win
        return (SE3(w.T_R[k], w.T_t[k]), w.vel[k].cpu().numpy(), w.bg[k].cpu().numpy(),
                w.ba[k].cpu().numpy())
