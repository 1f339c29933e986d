"""Monocular visual odometry — a PyTorch copy of the JAX package's
`pipeline/mono_vo.py::MonoVO`.

It shares the tracking core with StereoVO (every observation is mono:
u_right = depth = -1, so the pose solver runs 2-row residuals) and
tracks synchronously, one frame at a time, with the keyframe decision on
the host. It differs in two places:
  * initialization: a reference frame is held; the next frame with
    enough features is matched to it (mutual best Hamming, ratio test)
    and reconstructed by `geometry/two_view.py`; the map is scaled to a
    median depth of 1, the two keyframes and the points are created, and
    a 20-iteration whole-map BA refines them;
  * keyframe creation: no depth points; new points come from epipolar
    matching and triangulation against the keyframes 1, 2, 4 and 8
    slots back (`steps.match_and_triangulate`, 512 at most each).

Two guards that the JAX package lacks keep the map's scale gauge from
breaking the run (ROADMAP F14, H13): the initial map is scaled back to a
median depth of 1 after its BA (`_rescale_initial_map`), and the BAs
reject LM steps that take observations out of the cost
(`ba_guard`, passed to each of its BAs).

The host reads the reference makes are kept, on the same frames: the
match count and the two-view verdict of an initialization attempt, the
median depth, and the new-point count of each triangulation. The
two-view RANSAC draws its samples from `init_draw` (a generator seeded 3,
the reference's key), which a caller may replace.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vi_slam_tpu_torch.features.extractor import Features
from vi_slam_tpu_torch.geometry.two_view import reconstruct_two_view
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.ops.hamming import hamming_matrix
from vi_slam_tpu_torch.optim import local_ba
from vi_slam_tpu_torch.pipeline import steps
from vi_slam_tpu_torch.pipeline.stereo_vo import (
    NOT_INITIALIZED, OK, StereoVO, TrackStats, make_oracle_features,
)
from vi_slam_tpu_torch.retrieval import vocabulary as voc
from vi_slam_tpu_torch.slam_map import state as map_state
from vi_slam_tpu_torch.utils.config import SystemConfig
from vi_slam_tpu_torch.utils.sampling import DrawFn, Sampler

INIT_BA_ITERS = 20  # the reference's GlobalBundleAdjustment(20) after the two-view map
KF_LOOKBACK = (1, 2, 4, 8)  # the keyframes a new keyframe triangulates against
KF_TRIANGULATE_BUDGET = 512  # new points per pair, at most


def _match_frames(desc1: torch.Tensor, valid1: torch.Tensor, desc2: torch.Tensor,
                  valid2: torch.Tensor, th: int = 64, ratio: float = 0.9):
    """Brute-force mutual-best matching of two frames' descriptors with a
    ratio test: (index into frame 2 (N,) int32, match mask (N,) bool)."""
    D = hamming_matrix(desc1, desc2).to(torch.float32)
    big = torch.full_like(D, 1e9)
    D = torch.where(valid1[:, None] & valid2[None, :], D, big)
    # argmin/min take the first index on ties, as jnp.argmin does
    j_best = torch.argmin(D, dim=1)
    d_best = torch.min(D, dim=1).values
    cols = torch.arange(D.shape[1], device=D.device)
    d_second = torch.min(torch.where(cols[None, :] == j_best[:, None], big, D), dim=1).values
    i_best_of_j = torch.argmin(D, dim=0)
    mutual = i_best_of_j[j_best] == torch.arange(D.shape[0], device=D.device)
    ok = (d_best < th) & (d_best < ratio * d_second) & mutual & valid1
    return j_best.to(torch.int32), ok


class MonoVO(StereoVO):
    """Monocular pipeline: StereoVO's tracking core, a two-view bootstrap
    and triangulated landmark creation."""

    def __init__(self, cfg: SystemConfig, device="cuda", vocab: Optional[voc.Vocabulary] = None,
                 draw: Optional[DrawFn] = None):
        super().__init__(cfg, device=device, vocab=vocab)
        if self.loop_closer is not None:
            # monocular scale drifts: loops are corrected as Sim3
            self.loop_closer.fix_scale = False
        self._init_ref = None  # (features, timestamp, frame id) of the held frame
        self.init_draw: DrawFn = draw if draw is not None else Sampler(3, self.device)
        self.init_result = None  # (used_homography, n_good) of the accepted two-view solve
        self.init_depth_after_ba = None  # the initial points' median depth after the BA
        # a monocular map's scale is a gauge of its BAs (keyframe 0 fixed,
        # or one fixed keyframe in a short local window), along which a
        # rounding step can mirror the points behind the cameras and out of
        # the cost: no LM step of its BAs may take an observation out of it
        self.ba_guard = True

    # ------------------------------------------------------------------ API

    def process_mono(self, img, timestamp: float) -> TrackStats:
        """Track one grey image (H, W) synchronously (GrabImageMonocular)."""
        return self._mono_entry(self.extractor(self._upload_f32(img)), timestamp)

    def process_oracle_mono(self, xy, desc, level, timestamp: float) -> TrackStats:
        """Track one frame of given keypoints (pixels (V, 2), uint32
        descriptors (V, 8), pyramid levels (V,)) synchronously."""
        minus1 = np.full((len(xy),), -1.0, np.float32)
        feats, _, _ = make_oracle_features(self.cfg.extractor.n_features, xy, minus1, minus1,
                                           desc, level, device=self.device)
        return self._mono_entry(feats, timestamp)

    def _mono_entry(self, feats: Features, timestamp: float) -> TrackStats:
        minus1 = torch.full((feats.xy.shape[0],), -1.0, dtype=torch.float32, device=self.device)
        bundle = None
        if self.state != NOT_INITIALIZED:
            bundle = self._track(self.map, self._slot(max(self.ref_kf, 0)), feats, minus1, minus1,
                                 self.T_dev, self.vel_dev)
        return self._track_entry(feats, minus1, minus1, timestamp, bundle)

    # ------------------------------------------------------- initialization

    def _initialize(self, feats, uright, depth, timestamp) -> bool:
        """MonocularInitialization: hold a reference frame, then attempt a
        two-view reconstruction against it."""
        n_valid = int(torch.sum(feats.valid))
        if self._init_ref is None:
            if n_valid >= 100:
                self._init_ref = (feats, timestamp, self.frame_id)
            return False
        ref_feats, ref_ts, ref_fid = self._init_ref
        if n_valid < 100:
            self._init_ref = None
            return False
        with self.timer.span("init_two_view"):
            got = self._two_view(ref_feats, feats)
        if got is None:
            # a stale or failed reference is replaced by this frame
            self._init_ref = (feats, timestamp, self.frame_id)
            return False
        j, ok, used_h, good, pts, R21, t21 = got
        med_depth = float(np.median(pts[good][:, 2]))
        if med_depth <= 0:
            return False
        with self.timer.span("init_map"):
            self._initial_map(ref_feats, ref_ts, ref_fid, feats, timestamp, j, ok, good,
                              pts / med_depth, R21, t21 / med_depth)
        self.init_result = (used_h, int(np.sum(good)))
        return True

    def _two_view(self, ref_feats: Features, feats: Features):
        """Match the held frame to this one and reconstruct: None when
        fewer than 100 match or the reconstruction is rejected, else (match
        index, match mask, and from one host read: whether the homography
        won, the good mask, the points, R21 and t21)."""
        j, ok = _match_frames(ref_feats.desc, ref_feats.valid, feats.desc, feats.valid)
        if int(torch.sum(ok)) < 100:
            return None
        n = feats.xy.shape[0]
        uv2 = feats.xy[torch.clamp(j, 0, n - 1).long()]
        L = self.level_scales.shape[0]
        sigma2 = self.level_scales[torch.clamp(ref_feats.level, 0, L - 1).long()] ** 2
        res = reconstruct_two_view(self.cam, ref_feats.xy, uv2, ok, sigma2, self.init_draw,
                                   n_hyp=200)
        if not bool(res.ok):
            return None
        host = torch.cat([res.inliers.to(torch.float32), res.points.reshape(-1),
                          res.T21.R.reshape(-1), res.T21.t,
                          res.used_homography.to(torch.float32)[None]]).cpu().numpy()
        good = host[:n] > 0.5
        pts = host[n:4 * n].reshape(n, 3)
        return (j, ok, bool(host[-1] > 0.5), good, pts, host[4 * n:4 * n + 9].reshape(3, 3),
                host[4 * n + 9:4 * n + 12])

    def _initial_map(self, ref_feats, ref_ts, ref_fid, feats, timestamp, j, ok, good, pts,
                     R21, t21):
        """CreateInitialMapMonocular: keyframe 0 at the origin with the
        points, keyframe 1 at (R21, t21) observing them, then whole-map BA,
        the rescale to median depth 1, and the live pose from keyframe 1."""
        dev = self.device
        n = feats.xy.shape[0]
        dt = self.map.mp_pos.dtype
        self.T_dev = SE3.identity(device=dev)
        self.T_np = np.eye(4)
        self._create_kf_shell(ref_feats, ref_ts, frame_id=ref_fid)
        create = good & ref_feats.valid.cpu().numpy()
        dist = np.linalg.norm(pts, axis=-1)
        normal = pts / np.maximum(dist[:, None], 1e-9)
        ext = self.cfg.extractor
        sf = ext.scale_factor
        max_dist = dist * sf ** ref_feats.level.cpu().numpy().astype(np.float32)
        min_dist = max_dist / sf ** (ext.n_levels - 1)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dt)

        create_dev = torch.from_numpy(create).to(dev)
        self.map, ids = map_state.create_points(
            self.map, self.n_mp, 0, torch.arange(n, dtype=torch.int32, device=dev), put(pts),
            ref_feats.desc, put(normal), put(min_dist), put(max_dist), create_dev,
        )
        self.n_mp += int(np.sum(create))

        self.T_dev = SE3(put(R21), put(t21))
        self.T_np = np.eye(4)
        self.T_np[:3, :3] = R21
        self.T_np[:3, 3] = t21
        self._create_kf_shell(feats, timestamp)
        self.map = map_state.register_obs(self.map, ids, 1, j, create_dev & ok)
        M = self.map.mp_pos.shape[0]
        self.map = map_state.update_point_stats(
            self.map, torch.where(create_dev, ids, torch.full_like(ids, M - 1)))
        self._initial_ba()
        self._rescale_initial_map(ids[create_dev].long())
        self.T_dev = SE3(self.map.kf_R[1].clone(), self.map.kf_t[1].clone())
        got = torch.cat([self.T_dev.R.reshape(-1), self.T_dev.t]).cpu().numpy()
        self.T_np = np.eye(4)
        self.T_np[:3, :3] = got[:9].reshape(3, 3)
        self.T_np[:3, 3] = got[9:]
        self.ref_pose_np = self.T_np.copy()
        self.state = OK
        self.vel_dev = SE3.identity(device=dev)
        self._ref_kf_tracked = int(np.sum(create))
        self._init_ref = None

    def _initial_ba(self):
        """Whole-map BA over the two-keyframe map: the two-view geometry
        leaves pixel-level residuals that would anchor the whole
        trajectory. The map holds keyframes 0 and 1 and the initial points,
        all among the first n_features point slots (it was empty), so the
        problem is gathered from those slots alone: the reference's
        whole-map problem without its empty rows."""
        K, N = 2, self.cfg.extractor.n_features
        if self.n_kf != K or self.n_mp > N:
            raise RuntimeError(f"the initial map has {self.n_kf} keyframes and {self.n_mp}"
                               f" points; its BA expects {K} and at most {N}")
        m = self.map
        sub = m._replace(**{f: getattr(m, f)[:K] for f in m._fields if f.startswith("kf_")},
                         **{f: getattr(m, f)[:N] for f in m._fields if f.startswith("mp_")})
        prob = steps.gather_global_ba_problem(self.cam, sub)
        gres = local_ba.bundle_adjust(self.cam, prob, iters=INIT_BA_ITERS, assembly="scatter",
                                      guard_in_front=self.ba_guard)
        sub = steps.scatter_global_ba_result(sub, gres.poses, gres.points)
        m.kf_R[:K] = sub.kf_R
        m.kf_t[:K] = sub.kf_t
        m.mp_pos[:N] = sub.mp_pos

    def _local_ba_program(self, mstate, ref_slot: int):
        """StereoVO's local BA with the monocular guard."""
        return super()._local_ba_program(mstate, ref_slot, guard_in_front=self.ba_guard)

    def _rescale_initial_map(self, ids: torch.Tensor):
        """Back to a median depth of 1 after the whole-map BA, as the
        reference's CreateInitialMapMonocular does (the JAX package states
        it in a comment and leaves it out, ROADMAP H13). With keyframe 0
        fixed the map's scale is a gauge of that BA, along which its
        float32 LM walks by rounding (the initial points' median depth
        after it: 0.62-1.12 on the card). Dividing by the median brings
        the points back to the scale their statistics were taken at (and a
        mirrored map, of negative median depth, back in front).
        `init_depth_after_ba` keeps the median before the division."""
        z = self.map.mp_pos[ids, 2]  # keyframe 0 is the origin: z is its depth
        med = float(np.median(z.cpu().numpy()))
        self.init_depth_after_ba = med
        if not np.isfinite(med) or med == 0.0:
            return
        self.map.mp_pos[ids] = self.map.mp_pos[ids] / med
        self.map.kf_t[1] = self.map.kf_t[1] / med

    def _create_kf_shell(self, feats: Features, timestamp, frame_id=None):
        """Insert a keyframe without stereo points or associations."""
        slot = self.n_kf
        self.n_kf += 1
        n = feats.xy.shape[0]
        minus1 = torch.full((n,), -1.0, dtype=self.map.kf_uright.dtype, device=self.device)
        self.map = map_state.insert_keyframe(
            self.map, slot, self.T_dev, self.frame_id if frame_id is None else frame_id,
            timestamp, feats, minus1, minus1,
            torch.full((n,), -1, dtype=torch.int32, device=self.device),
        )
        self.ref_kf = slot
        self.ref_pose_np = self.T_np.copy()

    # --------------------------------------------------- keyframe creation

    def _need_keyframe(self, n_in: int, n_tracked_close: int, n_creatable: int) -> bool:
        """The monocular keyframe policy: after the two initial keyframes,
        on the timeout, or when fewer than 90 % of the reference
        keyframe's points are tracked (and more than 15)."""
        if self.n_kf >= self.map.kf_R.shape[0] - 1:
            return False
        if self.n_kf < 2:
            return False
        if self.frames_since_kf >= self.cfg.tracker.max_frames_between_kf:
            return True
        weak = n_in < 0.9 * max(self._ref_kf_tracked, 1)
        return bool(weak and n_in > 15)

    def _create_keyframe(self, feats, uright, depth, matched_mp, timestamp, pose_dev=None,
                         frame_id=None, pose_np=None):
        """Monocular CreateNewKeyFrame: insert the keyframe with its tracked
        associations, then triangulate new points against the keyframes
        KF_LOOKBACK slots back (wide baselines for the parallax gate under
        forward motion)."""
        slot = self.n_kf
        self.n_kf += 1
        self.map = map_state.insert_keyframe(
            self.map, slot, pose_dev if pose_dev is not None else self.T_dev,
            frame_id if frame_id is not None else self.frame_id, timestamp, feats, uright, depth,
            matched_mp,
        )
        self.ref_kf = slot
        self.ref_pose_np = (pose_np if pose_np is not None else self.T_np).copy()
        with self.timer.span("kf_triangulate"):
            for prev in sorted({slot - d for d in KF_LOOKBACK if slot - d >= 0}):
                self.map, n_new = self._triangulate_into(self.map, slot, prev, self.n_mp,
                                                         KF_TRIANGULATE_BUDGET)
                self.n_mp += int(n_new)

    def _triangulate_into(self, mstate, kf_new: int, kf_ref: int, base_id: int, max_new: int):
        """New points from the unmatched keypoints of keyframes kf_new and
        kf_ref, observed by both: (map, number created)."""
        cfg = self.cfg
        ext = cfg.extractor
        cand = steps.match_and_triangulate(
            self.cam, mstate, kf_new, kf_ref, max_new, th_low=cfg.matcher.th_low,
            scale_factor=ext.scale_factor, n_levels=ext.n_levels,
        )
        M = mstate.mp_pos.shape[0]
        offsets = torch.cumsum(cand.create.to(torch.int32), 0) - 1
        create = cand.create & (base_id + offsets < M - 1)
        mstate, ids = map_state.create_points(
            mstate, base_id, kf_new, cand.kp_new, cand.pos, cand.desc, cand.normal,
            cand.min_dist, cand.max_dist, create,
        )
        mstate = map_state.register_obs(mstate, ids, kf_ref, cand.kp_ref, create)
        mstate = map_state.update_point_stats(
            mstate, torch.where(create, ids, torch.full_like(ids, M - 1)))
        return mstate, torch.sum(create)
