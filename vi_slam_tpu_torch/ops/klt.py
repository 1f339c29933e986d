"""Pyramidal inverse-compositional Lucas-Kanade tracking — a PyTorch copy of
the JAX package's `ops/klt.py` (vilib's GPU feature tracker: per-feature
patch pyramids, translation-only IC-LK with a fixed number of iterations
per level, residual and conditioning gates).

All N features iterate together. Each patch access is one index gather of
(N, P+1, P+1) pixels, whose origins are clipped into the image as the
reference's `dynamic_slice` clips them, and a 4-tap bilinear blend. The
levels (coarse to fine) and the iterations are unrolled Python loops, as
in the reference; the inverse-compositional form hoists each level's
Hessian out of its iterations. The work is plain PyTorch on either device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch


class TrackResult(NamedTuple):
    xy: torch.Tensor  # (N, 2) tracked level-0 positions
    ok: torch.Tensor  # (N,) bool: in bounds, residual and conditioning gates
    residual: torch.Tensor  # (N,) mean absolute photometric residual


def _sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples at (..., 2) positions, clamped into the image."""
    h, w = img.shape
    x = torch.clamp(xy[..., 0], 0.0, w - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi, yi = x0.long(), y0.long()
    i00 = img[yi, xi]
    i01 = img[yi, xi + 1]
    i10 = img[yi + 1, xi]
    i11 = img[yi + 1, xi + 1]
    return (i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy)
            + i10 * (1 - fx) * fy + i11 * fx * fy)


def _origin(v: torch.Tensor, hi: int) -> torch.Tensor:
    """floor(v) as an index clipped to [0, hi], with the reference's
    saturating float-to-int conversion (NaN -> 0)."""
    v = torch.nan_to_num(v, nan=0.0)
    return torch.clamp(v, 0.0, float(hi)).long()


def _int_patches(img: torch.Tensor, x0i: torch.Tensor, y0i: torch.Tensor,
                 P: int) -> torch.Tensor:
    """(N, P, P) patches at integer origins (in the image): one gather."""
    W = img.shape[1]
    r = torch.arange(P, device=img.device)
    idx = (y0i[:, None] + r)[:, :, None] * W + (x0i[:, None] + r)[:, None, :]
    return img.reshape(-1)[idx]


def _bilinear_patch(img: torch.Tensor, cxy: torch.Tensor, half: int,
                    dx: float = 0.0, dy: float = 0.0) -> torch.Tensor:
    """(N, P, P) bilinear patches centred at cxy (+ a constant offset),
    P = 2 * half + 1, from one (P+1, P+1) gather per feature. Origins are
    clipped into the image: a border feature samples a shifted window, and
    its caller's in-bounds gate rejects it."""
    H, W = img.shape
    P = 2 * half + 1
    # (dx - half) first: XLA folds the reference's `cxy + dx - half` into
    # one constant. Then the +-0.5 gradient patches of a track share their
    # fractional offset bit for bit, and where their clipped origins meet
    # the gradient is exactly 0, as in the reference (ROADMAP H11)
    xf = cxy[:, 0] + (dx - half)
    yf = cxy[:, 1] + (dy - half)
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    fx = (xf - x0)[:, None, None]
    fy = (yf - y0)[:, None, None]
    raw = _int_patches(img, _origin(x0, W - (P + 1)), _origin(y0, H - (P + 1)), P + 1)
    return (raw[:, :-1, :-1] * (1 - fx) * (1 - fy) + raw[:, :-1, 1:] * fx * (1 - fy)
            + raw[:, 1:, :-1] * (1 - fx) * fy + raw[:, 1:, 1:] * fx * fy)


def _gradients(img: torch.Tensor, xy: torch.Tensor, half: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference template gradients (N, P, P) at xy."""
    gx = _bilinear_patch(img, xy, half, dx=0.5) - _bilinear_patch(img, xy, half, dx=-0.5)
    gy = _bilinear_patch(img, xy, half, dy=0.5) - _bilinear_patch(img, xy, half, dy=-0.5)
    return gx, gy


def _track_level(prev: torch.Tensor, nxt: torch.Tensor, xy_prev: torch.Tensor,
                 xy_cur: torch.Tensor, half: int, iters: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`iters` IC-LK steps on one pyramid level: (new xy_cur, mean absolute
    residual at it)."""
    T = _bilinear_patch(prev, xy_prev, half)
    gx, gy = _gradients(prev, xy_prev, half)
    h11 = torch.sum(gx * gx, dim=(-2, -1))
    h12 = torch.sum(gx * gy, dim=(-2, -1))
    h22 = torch.sum(gy * gy, dim=(-2, -1))
    det = h11 * h22 - h12 * h12
    det_safe = torch.where(torch.abs(det) < 1e-9, torch.full_like(det, 1e-9), det)
    for _ in range(iters):
        e = _bilinear_patch(nxt, xy_cur, half) - T
        b1 = torch.sum(gx * e, dim=(-2, -1))
        b2 = torch.sum(gy * e, dim=(-2, -1))
        dx = (h22 * b1 - h12 * b2) / det_safe
        dy = (h11 * b2 - h12 * b1) / det_safe
        xy_cur = xy_cur - torch.stack([dx, dy], dim=-1)
    e = _bilinear_patch(nxt, xy_cur, half) - T
    return xy_cur, torch.mean(torch.abs(e), dim=(-2, -1))


def track_pyramidal(prev_pyr: Sequence[torch.Tensor], next_pyr: Sequence[torch.Tensor],
                    xy: torch.Tensor, valid: torch.Tensor,
                    xy_guess: Optional[torch.Tensor] = None, half: int = 5, iters: int = 8,
                    max_residual: float = 25.0, min_eig: float = 1e-3) -> TrackResult:
    """Track level-0 features `xy` (N, 2) from prev to next through
    half-sampling pyramids (`ops/pyramid.build_halfsample_pyramid`): from
    the coarsest level at xy / 2^(L-1) (or `xy_guess`), `iters` steps a
    level, positions doubled between levels. A track is ok when valid, in
    bounds, under the residual gate and well conditioned (the smallest
    eigenvalue of the level-0 template's structure tensor per pixel above
    `min_eig`)."""
    L = len(prev_pyr)
    cur = (xy if xy_guess is None else xy_guess) / (2.0 ** (L - 1))
    res = torch.zeros((xy.shape[0],), dtype=xy.dtype, device=xy.device)
    for l in range(L - 1, -1, -1):
        cur, res = _track_level(prev_pyr[l], next_pyr[l], xy / (2.0 ** l), cur, half, iters)
        if l > 0:
            cur = cur * 2.0
    h, w = prev_pyr[0].shape
    m = half + 1
    inb = (cur[:, 0] >= m) & (cur[:, 0] < w - m) & (cur[:, 1] >= m) & (cur[:, 1] < h - m)
    gx, gy = _gradients(prev_pyr[0], xy, half)
    h11 = torch.sum(gx * gx, dim=(-2, -1))
    h12 = torch.sum(gx * gy, dim=(-2, -1))
    h22 = torch.sum(gy * gy, dim=(-2, -1))
    tr = 0.5 * (h11 + h22)
    disc = torch.sqrt(torch.clamp(tr * tr - (h11 * h22 - h12 * h12), min=0.0))
    lam_min = (tr - disc) / float((2 * half + 1) ** 2)
    ok = valid & inb & (res < max_residual) & (lam_min > min_eig)
    return TrackResult(xy=cur, ok=ok, residual=res)
