"""Relocalization: recover a lost tracker from the place-recognition
database — a PyTorch copy of the JAX package's
`pipeline/relocalization.py`.

For each of the best 5 candidates the database returns, the frame's
keypoints are matched to the candidate keyframe's map points (mutual best
Hamming with a ratio test), a PnP RANSAC finds the pose, and the pose
Gauss-Newton refines it over the PnP inliers. A fix with >= 50 inliers is
taken at once; otherwise the best fix with >= 30 inliers. The reference
solves every candidate in one program and then discards those with fewer
than 15 matches; the port counts the matches first (one host sync) and
solves only the others, with the same samples drawn in the same order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.features.extractor import Features
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.ops.hamming import hamming_matrix
from vi_slam_tpu_torch.optim import pose_opt
from vi_slam_tpu_torch.optim.pnp import pnp_ransac_core
from vi_slam_tpu_torch.optim.pose_opt import PoseObs
from vi_slam_tpu_torch.slam_map.state import MapState
from vi_slam_tpu_torch.utils.sampling import DrawFn, Sampler

PNP_HYPOTHESES, PNP_SAMPLE = 256, 6  # pnp_ransac's defaults


def mutual_best_matches(D: torch.Tensor, ok_rows: torch.Tensor, ok_cols: torch.Tensor,
                        th: float, ratio: float):
    """Rows' mutual best matches in a Hamming matrix (N, N'), masked by
    ok_rows / ok_cols: (best column (N,), best distance (N,), good (N,))
    with good = best < th, best < ratio * second best, mutual."""
    big = 1e9
    D = torch.where(ok_rows[:, None] & ok_cols[None, :], D.to(torch.float32),
                    torch.full((), big, device=D.device))
    j_best = torch.argmin(D, dim=1)
    d_best = torch.gather(D, 1, j_best[:, None])[:, 0]
    rows = torch.arange(D.shape[0], device=D.device)
    D2 = D.clone()
    D2[rows, j_best] = big
    d_second = torch.min(D2, dim=1)[0]
    mutual = torch.argmin(D, dim=0)[j_best] == rows
    good = (d_best < th) & (d_best < ratio * d_second) & mutual & ok_rows
    return j_best, d_best, good


def _match_frame_to_kf(state: MapState, kf: int, desc: torch.Tensor, kp_valid: torch.Tensor,
                       th: int = 50, ratio: float = 0.75):
    """Frame keypoints -> the candidate keyframe's map points:
    (mp id (N,) int32, -1 = none; good (N,))."""
    M = state.mp_pos.shape[0]
    mp_kf = state.kf_mp[kf]
    ok_kf = state.kf_kp_valid[kf] & (mp_kf >= 0)
    ok_kf = ok_kf & state.mp_valid[torch.clamp(mp_kf, 0, M - 1).long()]
    j_best, _, good = mutual_best_matches(hamming_matrix(desc, state.kf_desc[kf]), kp_valid,
                                          ok_kf, th, ratio)
    mp = torch.where(good, mp_kf[j_best], torch.full_like(mp_kf[j_best], -1))
    return mp.to(torch.int32), good


def _reloc_solve(cam: CameraParams, state: MapState, mp: torch.Tensor, good: torch.Tensor,
                 feats: Features, uright: torch.Tensor, level_scales: torch.Tensor,
                 idx: torch.Tensor, rounds: int = 4, iters: int = 10):
    """One candidate's pose from its matches: PnP RANSAC over the drawn
    samples `idx`, then the pose GN over the PnP inliers. Returns (T,
    n_pnp_inliers, n_final_inliers)."""
    M = state.mp_pos.shape[0]
    xw = state.mp_pos[torch.clamp(mp, 0, M - 1).long()]
    sigma2 = level_scales[torch.clamp(feats.level, 0, level_scales.shape[0] - 1).long()] ** 2
    res = pnp_ransac_core(cam, xw, feats.xy, good, sigma2, idx)
    stereo = uright > 0
    uvr = torch.cat([feats.xy, torch.where(stereo, uright, torch.zeros_like(uright))[:, None]],
                    dim=-1)
    obs = PoseObs(xw=xw, uvr=uvr, stereo=stereo, sigma2=sigma2, valid=good & res.inliers)
    T_opt, _, n_in = pose_opt.pose_optimize(cam, res.T_cw, obs, rounds=rounds, iters=iters)
    return T_opt, res.n_inliers, n_in


class Relocalizer:
    """Relocalization over the keyframe database, run from the host. Its PnP
    samples come from `self.draw` (by default a generator seeded 11, the
    reference's key)."""

    def __init__(self, cam: CameraParams, level_scales: torch.Tensor, min_matches: int = 15,
                 min_inliers: int = 30):
        self.cam = cam
        self.level_scales = level_scales
        self.min_matches = min_matches
        self.min_inliers = min_inliers
        self.draw: DrawFn = Sampler(11, level_scales.device)

    def try_relocalize(self, state: MapState, db, bow_vec: torch.Tensor, feats: Features,
                       uright: torch.Tensor) -> Tuple[Optional[SE3], int]:
        """(pose, n_inliers), or (None, 0) without a fix."""
        best: Tuple[Optional[SE3], int] = (None, 0)
        for cand in db.detect_reloc_candidates(state, bow_vec).tolist()[:5]:
            mp, good = _match_frame_to_kf(state, int(cand), feats.desc, feats.valid)
            # every candidate draws its sample, as the reference's does, so
            # that the draws of later candidates do not depend on the skips
            idx = self.draw(good, PNP_HYPOTHESES, PNP_SAMPLE)
            if int(torch.sum(good)) < self.min_matches:
                continue  # the reference discards this candidate's solve
            T, _, n_in = _reloc_solve(self.cam, state, mp, good, feats, uright,
                                      self.level_scales, idx)
            n_in = int(n_in)
            if n_in >= 50:
                return T, n_in
            if n_in >= self.min_inliers and n_in > best[1]:
                best = (T, n_in)
        return best
