"""Trajectory evaluation: Horn alignment and ATE RMSE — a numpy copy of
the JAX package's `io/evaluation.py`."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def horn_align(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Find (R, t, s) minimizing || gt - (s R est + t) ||^2.

    est, gt: (N, 3) matched positions. Returns (R (3,3), t (3,), s)."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    W = gc.T @ ec
    U, d, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec ** 2).sum()
        s = float((d * np.diag(S)).sum() / max(var_e, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(
    est_positions: np.ndarray,
    gt_positions: np.ndarray,
    with_scale: bool = False,
) -> Dict[str, float]:
    """Absolute trajectory error after Horn alignment.

    Returns dict with rmse, mean, median, scale."""
    R, t, s = horn_align(est_positions, gt_positions, with_scale)
    aligned = (s * (R @ est_positions.T)).T + t
    err = np.linalg.norm(aligned - gt_positions, axis=1)
    return {
        "rmse": float(np.sqrt((err ** 2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "scale": float(s),
        "n": int(err.shape[0]),
    }
