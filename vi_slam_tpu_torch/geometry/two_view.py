"""Two-view reconstruction for monocular initialization — a PyTorch copy of
the JAX package's `geometry/two_view.py`.

Homography and fundamental-matrix RANSAC share one set of 8-point
samples: every hypothesis of both models is solved at once (batched
SVDs of the (H, 16, 9) and (H, 8, 9) DLT systems) and scored as an
(H, N) matrix, by symmetric transfer for H and epipolar distance for F.
The model with RH = SH / (SH + SF) > 0.40 wins. Its motion hypotheses (4
from the essential matrix, 8 from the Faugeras decomposition of the
homography) are triangulated and gated together (cheirality, parallax,
reprojection); the hypothesis with the most good points wins, near-ties
broken by the larger median parallax, and it must dominate the runner-up.

The reference draws its samples inside its jitted solver with
`jax.random.choice(key, N, (H, 8), p=valid / n_valid)`; here the draw is
a separate step (`utils/sampling.py`) and `reconstruct_two_view_core`
takes the index array, so a test can hand it the reference's own draws.
The SVDs' sign and order conventions differ from the reference's: the
homography is normalized by H[2, 2], the scores square away the sign of
F, and the decompositions give the same set of hypotheses, perhaps in
another order. On a CUDA tensor each `torch.linalg.svd` waits for the
host (PyTorch checks its result there).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.geometry.triangulate import triangulate_dlt
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.utils.numerics import norm3_f32
from vi_slam_tpu_torch.utils.sampling import DrawFn

# chi2 thresholds (the reference's CheckHomography / CheckFundamental)
_TH_H = 5.991
_TH_F = 3.841
_TH_SCORE = 5.991  # score cap term


class TwoViewResult(NamedTuple):
    ok: torch.Tensor  # () bool
    T21: SE3  # pose of view 2 wrt view 1 (world = view 1)
    points: torch.Tensor  # (N, 3) triangulated points (view-1 frame)
    inliers: torch.Tensor  # (N,) bool, the good triangulations
    n_good: torch.Tensor  # () int32
    used_homography: torch.Tensor  # () bool


def _normalize(x: torch.Tensor, w: torch.Tensor):
    """Similarity normalization (mean 0, mean absolute deviation 1) of the
    weighted points x (N, 2): (normalized points, 3x3 transform)."""
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    mean = torch.sum(x * w[:, None], dim=0) / wsum
    d = x - mean
    md = torch.sum(torch.abs(d) * w[:, None], dim=0) / wsum
    s = 1.0 / torch.clamp(md, min=1e-9)
    zero = torch.zeros_like(s[0])
    T = torch.stack([
        torch.stack([s[0], zero, -mean[0] * s[0]]),
        torch.stack([zero, s[1], -mean[1] * s[1]]),
        torch.stack([zero, zero, torch.ones_like(zero)]),
    ])
    return d * s, T


def _h_dlt(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Homographies (x2 ~ H x1) from (..., 8, 2) pre-normalized
    correspondences by unnormalized DLT: (..., 3, 3)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 16, 9)
    Vt = torch.linalg.svd(A, full_matrices=True)[2]
    return Vt[..., -1, :].reshape(*A.shape[:-2], 3, 3)


def _f_8point(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Fundamental matrices from (..., 8, 2) correspondences, rank 2
    enforced: (..., 3, 3)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    o = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], dim=-1)
    Vt = torch.linalg.svd(A, full_matrices=True)[2]
    F = Vt[..., -1, :].reshape(*A.shape[:-2], 3, 3)
    U, s, Vt2 = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return U @ torch.diag_embed(s) @ Vt2


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _transfer_sq(Hm: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance of b from a mapped by each homography Hm (..., 3, 3):
    (..., N)."""
    p = _homogeneous(a) @ Hm.transpose(-1, -2)
    w = p[..., 2]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return torch.sum((p[..., :2] / w[..., None] - b) ** 2, dim=-1)


def _gated_score(chi1: torch.Tensor, chi2: torch.Tensor, valid: torch.Tensor, th: float):
    """Summed capped score over the points and the mask of points inside
    the gate in both directions."""
    in1 = valid & (chi1 < th)
    in2 = valid & (chi2 < th)
    zero = torch.zeros_like(chi1)
    score = torch.where(in1, _TH_SCORE - chi1, zero) + torch.where(in2, _TH_SCORE - chi2, zero)
    return torch.sum(score, dim=-1), in1 & in2


def _score_h(H21, H12, x1, x2, valid, sigma2):
    """Symmetric-transfer score of each homography (CheckHomography):
    (score (...,), inliers (..., N))."""
    chi1 = _transfer_sq(H21, x1, x2) / sigma2
    chi2 = _transfer_sq(H12, x2, x1) / sigma2
    return _gated_score(chi1, chi2, valid, _TH_H)


def _score_f(F21, x1, x2, valid, sigma2):
    """Epipolar-distance score of each fundamental matrix
    (CheckFundamental): (score (...,), inliers (..., N))."""
    x1h = _homogeneous(x1)
    x2h = _homogeneous(x2)
    l2 = x1h @ F21.transpose(-1, -2)  # epilines in image 2
    l1 = x2h @ F21  # epilines in image 1
    d2 = torch.sum(x2h * l2, dim=-1) ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2,
                                                        min=1e-12)
    d1 = torch.sum(x1h * l1, dim=-1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2,
                                                        min=1e-12)
    return _gated_score(d2 / sigma2, d1 / sigma2, valid, _TH_F)


def _decompose_e(E: torch.Tensor):
    """E (3, 3) -> 4 (R, t) hypotheses: (R (4, 3, 3), t (4, 3))."""
    U, _s, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp(norm3_f32(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_h(H: torch.Tensor, K: torch.Tensor, Kinv: torch.Tensor):
    """Faugeras's SVD decomposition of a calibrated homography into 8
    motion hypotheses (ReconstructH): 4 with d' > 0, then 4 with d' < 0.
    Returns (R (8, 3, 3), unit t (8, 3))."""
    A = Kinv @ H @ K
    U, s, Vt = torch.linalg.svd(A)
    sgn = torch.linalg.det(U) * torch.linalg.det(Vt.T)
    d1, d2, d3 = s[0], s[1], s[2]
    dev, dt = A.device, A.dtype

    def signs(*v):
        return torch.tensor(v, dtype=dt, device=dev)

    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / den)
    aux3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / den)
    x1s = signs(1.0, 1.0, -1.0, -1.0) * aux1
    x3s = signs(1.0, -1.0, 1.0, -1.0) * aux3
    # sign(sin) = sign(x1) * sign(x3) for each of the 4 combinations
    eps = signs(1.0, -1.0, -1.0, 1.0)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero = torch.zeros_like(x1s)
    one = torch.ones_like(x1s)

    def rot(r00, r02, r11, r20, r22):
        """(4, 3, 3) rotations [[r00, 0, r02], [0, r11, 0], [r20, 0, r22]]."""
        r00, r11, r22 = r00 * one, r11 * one, r22 * one
        return torch.stack([
            torch.stack([r00, zero, r02], dim=-1),
            torch.stack([zero, r11, zero], dim=-1),
            torch.stack([r20, zero, r22], dim=-1),
        ], dim=-2)

    # d' > 0
    sin_t = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    stheta = eps * sin_t
    Rp_pos = rot(cos_t, -stheta, 1.0, stheta, cos_t)
    tp_pos = (d1 - d3) * torch.stack([x1s, zero, -x3s], dim=-1)
    # d' < 0
    sin_p = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    sphi = eps * sin_p
    Rp_neg = rot(cos_p, sphi, -1.0, sphi, -cos_p)
    tp_neg = (d1 + d3) * torch.stack([x1s, zero, x3s], dim=-1)

    Rp = torch.cat([Rp_pos, Rp_neg])
    tp = torch.cat([tp_pos, tp_neg])
    Rs = sgn * (U @ Rp @ Vt)
    ts = (U @ tp[..., None])[..., 0]
    return Rs, ts / torch.clamp(norm3_f32(ts, keepdim=True), min=1e-12)


def _check_rt(R: torch.Tensor, t: torch.Tensor, x1n: torch.Tensor, x2n: torch.Tensor,
              valid: torch.Tensor, sigma2: torch.Tensor, fx: torch.Tensor,
              min_parallax_cos: float = 0.99998):
    """Score motion hypotheses R (B, 3, 3), t (B, 3) (CheckRT): triangulate
    every match, count the points in front of both views with enough
    parallax and a low reprojection error in both. x1n/x2n (N, 2) are
    normalized image coordinates. Returns (good counts (B,), points
    (B, N, 3), good (B, N), parallax 1 - cos where good else 0 (B, N))."""
    B = R.shape[0]
    T2 = SE3(R[:, None], t[:, None])
    T1 = SE3.identity((B, 1), dtype=x1n.dtype, device=x1n.device)
    xw = triangulate_dlt(T1, T2, _homogeneous(x1n), _homogeneous(x2n))
    z1 = xw[..., 2]
    pc2 = T2.apply(xw)
    z2 = pc2[..., 2]
    c2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    r2 = xw - c2[:, None]
    cosp = torch.sum(xw * r2, dim=-1) / torch.clamp(norm3_f32(xw) * norm3_f32(r2), min=1e-12)
    p1 = xw[..., :2] / torch.clamp(z1, min=1e-12)[..., None]
    p2 = pc2[..., :2] / torch.clamp(z2, min=1e-12)[..., None]
    e1 = torch.sum((p1 - x1n) ** 2, dim=-1) * fx * fx
    e2 = torch.sum((p2 - x2n) ** 2, dim=-1) * fx * fx
    good = (valid & (z1 > 0) & (z2 > 0) & (cosp < min_parallax_cos)
            & (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2))
    par = torch.where(good, 1.0 - cosp, torch.zeros_like(cosp))
    return torch.sum(good, dim=-1), xw, good, par


def reconstruct_two_view_core(cam: CameraParams, uv1: torch.Tensor, uv2: torch.Tensor,
                              valid: torch.Tensor, sigma2: torch.Tensor,
                              idx: torch.Tensor) -> TwoViewResult:
    """Two-view reconstruction from matched pixels uv1/uv2 (N, 2), their
    mask `valid` (N,) and pyramid variances `sigma2` (N,), over the given
    (H, 8) RANSAC samples. ok needs >= 50 good triangulations, more than
    75 % of the model's inliers, and a runner-up below 75 % of the
    winner."""
    N = uv1.shape[0]
    dt = uv1.dtype
    dev = uv1.device
    w = valid.to(dt)
    x1n_img, T1 = _normalize(uv1, w)
    x2n_img, T2 = _normalize(uv2, w)
    T2inv = torch.linalg.inv_ex(T2)[0]

    idx = idx.long()
    a1 = x1n_img[idx]
    a2 = x2n_img[idx]
    H21 = T2inv @ _h_dlt(a1, a2) @ T1
    F_all = T2.T @ _f_8point(a1, a2) @ T1
    h22 = H21[:, 2, 2]
    h22 = torch.where(torch.abs(h22) < 1e-12, torch.full_like(h22, 1e-12), h22)
    H_all = H21 / h22[:, None, None]

    SH_all, _ = _score_h(H_all, torch.linalg.inv_ex(H_all)[0], uv1, uv2, valid, sigma2)
    SF_all, _ = _score_f(F_all, uv1, uv2, valid, sigma2)
    bh = torch.argmax(SH_all)
    bf = torch.argmax(SF_all)
    H_best = H_all[bh]
    F_best = F_all[bf]
    SH = SH_all[bh]
    SF = SF_all[bf]
    _, inl_h = _score_h(H_best, torch.linalg.inv_ex(H_best)[0], uv1, uv2, valid, sigma2)
    _, inl_f = _score_f(F_best, uv1, uv2, valid, sigma2)
    use_h = SH / torch.clamp(SH + SF, min=1e-12) > 0.40

    zero = torch.zeros_like(cam.fx)
    Km = torch.stack([torch.stack([cam.fx, zero, cam.cx]), torch.stack([zero, cam.fy, cam.cy]),
                      torch.stack([zero, zero, torch.ones_like(zero)])]).to(dt)
    Kinv = torch.linalg.inv_ex(Km)[0]
    Rs_e, ts_e = _decompose_e(Km.T @ F_best @ Km)
    Rs_h, ts_h = _decompose_h(H_best, Km, Kinv)
    Rs = torch.cat([Rs_e, Rs_h])
    ts = torch.cat([ts_e, ts_h])
    from_h = torch.arange(12, device=dev) >= 4
    enabled = torch.where(use_h, from_h, ~from_h)
    model_inl = torch.where(use_h, inl_h, inl_f)

    c = torch.stack([cam.cx, cam.cy]).to(dt)
    f = torch.stack([cam.fx, cam.fy]).to(dt)
    n_good, xws, goods, par = _check_rt(Rs, ts, (uv1 - c) / f, (uv2 - c) / f, model_inl,
                                        sigma2, cam.fx.to(dt))
    # median parallax among the good points (the ReconstructH/F parallax)
    pos = N - torch.clamp(n_good // 2, min=1)
    med_par = torch.gather(torch.sort(par, dim=-1).values, 1, pos[:, None])[:, 0]
    n_goods = torch.where(enabled, n_good, torch.full_like(n_good, -1))
    # near-ties on the good count (the homography's twisted pair) break on
    # parallax: the physical solution triangulates with more
    top = torch.max(n_goods)
    tie = n_goods.to(dt) > 0.95 * torch.clamp(top, min=1).to(dt)
    best = torch.argmax(torch.where(tie, med_par, torch.full_like(med_par, -1.0)))
    n_best = n_goods[best]
    n_inl = torch.sum(model_inl)
    second = torch.sort(n_goods).values[-2]
    ok = ((n_best >= 50) & (n_best.to(dt) > 0.75 * n_inl.to(dt))
          & (second.to(dt) < 0.75 * n_best.to(dt)))
    return TwoViewResult(ok=ok, T21=SE3(Rs[best], ts[best]), points=xws[best],
                         inliers=goods[best], n_good=n_best.to(torch.int32),
                         used_homography=use_h)


def reconstruct_two_view(cam: CameraParams, uv1, uv2, valid, sigma2, draw: DrawFn,
                         n_hyp: int = 200) -> TwoViewResult:
    """Monocular initialization from matched pixels (MonoInitializer's
    Initialize), with `n_hyp` shared 8-point samples from `draw`."""
    return reconstruct_two_view_core(cam, uv1, uv2, valid, sigma2, draw(valid, n_hyp, 8))
