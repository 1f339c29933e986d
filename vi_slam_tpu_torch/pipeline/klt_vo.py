"""The KLT (track-then-redetect) stereo frontend — a PyTorch copy of the
JAX package's `pipeline/klt_vo.py::KltStereoVO` (vilib's GPU feature
tracker: pyramidal LK on the live track set, tracks killed on divergence
and respawned from fresh detections).

Between keyframes a frame runs no ORB extraction and no descriptor search.
The tracks carry their map-point ids; each frame:
  * predicts every track at its map point's projection from the motion
    model, LK-tracks the set into the new left image (pass 1), and solves
    the pose;
  * re-seeds the tracks at their projections from that pose and tracks
    again (pass 2), keeping the result only for the tracks pass 1 lost;
  * LK-tracks each surviving track into the right image, seeded at the
    predicted disparity, for a stereo row, and solves the pose again;
  * below `klt_rescue_min` inliers, extracts ORB features and runs the
    local-map tracking of `StereoVO._track`, and keeps that result when
    it has more inliers (the rescue);
  * decides a keyframe on the track count: on one, extracts ORB features,
    associates them with the surviving tracks by position (mutual nearest
    within `klt_assoc_radius`), creates the keyframe as the ORB frontend
    does, and respawns the track set from the keyframe's keypoints that
    carry a map point.
Everything at keyframe rate (mapping pass, local BA, maintenance, loop
closing, the atlas) is `StereoVO`'s.

The reference makes the rescue and the keyframe branches `lax.cond`s on
the device; here they are host branches that read one device scalar each,
as `StereoVO._decide_keyframe` does (ROADMAP F2). Where the reference
extracts in both branches of one frame, the port extracts once and uses
the features twice: they are the same features. Every extraction is
counted in `n_extractions` (two FAST-9 pyramids each).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from vi_slam_tpu_torch.cameras import pinhole
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.ops import klt
from vi_slam_tpu_torch.ops import pyramid as pyr_ops
from vi_slam_tpu_torch.optim import pose_opt
from vi_slam_tpu_torch.pipeline.stereo_vo import (
    _PK_NIN, NOT_INITIALIZED, OK, FrameJob, StereoVO, TrackBundle, TrackStats,
)
from vi_slam_tpu_torch.retrieval import vocabulary as voc
from vi_slam_tpu_torch.utils.config import SystemConfig
from vi_slam_tpu_torch.utils.timing import ProgramTimer

# the stages of a KLT frame that `klt_timer` spans
KLT_STAGES = ("lk", "pose", "rescue", "keyframe")


class KltStereoVO(StereoVO):
    """StereoVO with the LK track-then-redetect frontend
    (cfg.tracker.frontend == "klt")."""

    def __init__(self, cfg: SystemConfig, device="cuda", vocab: Optional[voc.Vocabulary] = None):
        super().__init__(cfg, device=device, vocab=vocab)
        self.n_extractions = 0
        # per KLT frame: LK passes, pose passes, rescues, keyframe branches
        self.klt_timer = ProgramTimer(self.device, KLT_STAGES)
        # the frames (ids at dispatch) that ran the rescue, and that made a
        # keyframe in the KLT keyframe branch
        self.rescue_frames: List[int] = []
        self.klt_kf_frames: List[int] = []
        self._clear_tracks()

    # ----------------------------------------------------- device programs

    def _extract_pair(self, imgs_u8: torch.Tensor):
        self.n_extractions += 1
        return super()._extract_pair(imgs_u8)

    def _pyramid(self, imgs_u8: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The LK pyramid of the left image of a (2, H, W) uint8 pair."""
        return tuple(pyr_ops.build_halfsample_pyramid(imgs_u8[0].to(torch.float32),
                                                      self.cfg.tracker.klt_levels))

    def _lk(self, prev_pyr, next_pyr, xy, valid, guess) -> klt.TrackResult:
        tr = self.cfg.tracker
        return klt.track_pyramidal(prev_pyr, next_pyr, xy, valid, xy_guess=guess,
                                   half=tr.klt_half, iters=tr.klt_iters,
                                   max_residual=tr.klt_max_residual)

    def _frame_klt(self, imgs_u8: torch.Tensor, frame_id: int, ts: float) -> TrackBundle:
        """One KLT frame: LK, pose, rescue, keyframe decision and creation,
        respawn. Updates the map, the track set, the carry and the previous
        pyramid; returns the frame's bundle."""
        cfg = self.cfg
        tr_cfg = cfg.tracker
        cam = self.cam
        N = cfg.extractor.n_features
        timer = self.klt_timer
        mstate = self.map
        T_last, vel = self.T_dev, self.vel_dev
        trk_xy, trk_mp = self.trk_xy, self.trk_mp
        trk_level, trk_valid = self.trk_level, self.trk_valid
        prev_pyr = self.prev_pyr
        extracted = []

        def extract():
            if not extracted:
                extracted.append(self._extract_pair(imgs_u8))
            return extracted[0]

        M = mstate.mp_pos.shape[0]
        mp_safe = torch.clamp(trk_mp, 0, M - 1).long()
        xw = mstate.mp_pos[mp_safe]
        alive = mstate.mp_valid[mp_safe] & (trk_mp >= 0)

        def projected(T: SE3, fallback):
            """The tracks' map points projected from T, `fallback` where a
            point is dead or not in front."""
            pc = T.apply(xw)
            keep = (alive & (pc[..., 2] > 0.1))[:, None]
            return torch.where(keep, pinhole.project(cam, pc), fallback).to(torch.float32)

        sigma2 = torch.pow(cfg.extractor.scale_factor, 2.0 * trk_level.to(torch.float32))

        def optimize(xy_cur, ok_cur, T0, ur=None):
            obs_valid = ok_cur & trk_valid & alive
            if ur is None:
                stereo = torch.zeros((N,), dtype=torch.bool, device=self.device)
                ur_col = torch.zeros((N, 1), dtype=torch.float32, device=self.device)
            else:
                stereo = ur > 0
                ur_col = torch.where(stereo, ur, torch.zeros_like(ur))[:, None]
            obs = pose_opt.PoseObs(xw=xw, uvr=torch.cat([xy_cur, ur_col], dim=-1),
                                   stereo=stereo, sigma2=sigma2, valid=obs_valid)
            T, _inlier, n_in = pose_opt.pose_optimize(
                cam, T0, obs, rounds=cfg.ba.pose_rounds, iters=cfg.ba.pose_iters_per_round)
            return T, n_in, obs_valid

        pyrL = self._pyramid(imgs_u8)
        T_pred0 = vel.compose(T_last)
        with timer.span("lk"):
            tr = self._lk(prev_pyr, pyrL, trk_xy, trk_valid, projected(T_pred0, trk_xy))
        with timer.span("pose"):
            T1, _n1, _ov1 = optimize(tr.xy, tr.ok, T_pred0)
        with timer.span("lk"):
            # pass 2 from T1's projections rescues only the tracks pass 1
            # lost: re-seeding healthy tracks lets repetitive texture snap
            # them one cell over
            tr2 = self._lk(prev_pyr, pyrL, trk_xy, trk_valid, projected(T1, tr.xy))
            use2 = tr2.ok & ~tr.ok
            xy_f = torch.where(use2[:, None], tr2.xy, tr.xy)
            ok_f = tr.ok | tr2.ok
            # stereo rows: each track LK-tracked into the right image from
            # the map-predicted disparity
            pyrR = tuple(pyr_ops.build_halfsample_pyramid(imgs_u8[1].to(torch.float32),
                                                          tr_cfg.klt_levels))
            z1 = torch.clamp(T1.apply(xw)[..., 2], min=0.5)
            disp_pred = cam.bf / z1
            guess_r = xy_f - torch.stack([disp_pred, torch.zeros_like(disp_pred)], dim=-1)
            trR = self._lk(pyrL, pyrR, xy_f, ok_f & trk_valid & alive, guess_r)
            disp = xy_f[:, 0] - trR.xy[:, 0]
            r_ok = trR.ok & (torch.abs(trR.xy[:, 1] - xy_f[:, 1]) < 2.0) & (disp > 0.1)
            ur = torch.where(r_ok, trR.xy[:, 0], torch.full_like(disp, -1.0))
        with timer.span("pose"):
            T, n_in, obs_valid = optimize(xy_f, ok_f, T1, ur=ur)
        trk_xy = xy_f
        # LK-healthy tracks stay alive when the pose pass calls them
        # outliers this frame
        trk_valid = ok_f & trk_valid & alive

        K = mstate.kf_R.shape[0]
        if bool(n_in < tr_cfg.klt_rescue_min):
            self.rescue_frames.append(frame_id)
            with timer.span("rescue"):
                feats, uright, depth = extract()
                ref_slot = torch.clamp(mstate.kf_count[0].long() - 1, 0, K - 1)
                b = self._track(mstate, ref_slot, feats, uright, depth, T_last, vel)
                n_r = b.packed[_PK_NIN].to(n_in.dtype)
                better = n_r > n_in
                T = SE3(torch.where(better, b.T_R, T.R), torch.where(better, b.T_t, T.t))
                n_in = torch.where(better, n_r, n_in)
                trk_xy = torch.where(better, feats.xy, trk_xy)
                trk_mp = torch.where(better, b.matched_mp.to(trk_mp.dtype), trk_mp)
                trk_level = torch.where(better, feats.level.to(trk_level.dtype), trk_level)
                trk_valid = torch.where(better, feats.valid & (b.matched_mp >= 0), trk_valid)
        n_tracks = torch.sum(trk_valid)

        carry = self.carry_dev
        fs = carry[0] + 1
        ref_tracked = torch.clamp(carry[1], min=1)
        ok = n_in >= self._min_ok_static
        capacity = mstate.kf_count[0] < K - 1
        timeout = fs >= tr_cfg.max_frames_between_kf
        min_frames_ok = fs >= tr_cfg.min_frames_between_kf
        starving = n_tracks < tr_cfg.klt_min_tracks
        weak = n_tracks.to(torch.float32) < tr_cfg.kf_ref_ratio * ref_tracked.to(torch.float32)
        kf_new = ok & capacity & (timeout | (min_frames_ok & (starving | weak)))
        slot = mstate.kf_count[0].long()
        if bool(kf_new):
            self.klt_kf_frames.append(frame_id)
            with timer.span("keyframe"):
                feats, uright, depth = extract()
                matched_mp = self._associate(feats, trk_xy, trk_mp, trk_valid)
                mstate = self._create_kf_body(mstate, slot, T, frame_id, ts, feats, uright,
                                              depth, matched_mp, self._kf_budget)
                new_mp = mstate.kf_mp[slot.reshape(1)][0]
                trk_xy, trk_mp, trk_level = feats.xy, new_mp, feats.level
                trk_valid = feats.valid & (new_mp >= 0)
        self.carry_dev = torch.where(
            kf_new, torch.stack([torch.zeros_like(fs), n_tracks.to(fs.dtype)]),
            torch.stack([fs, carry[1]]),
        ).to(torch.int32)
        self.map = mstate
        self.trk_xy, self.trk_mp, self.trk_level, self.trk_valid = trk_xy, trk_mp, trk_level, trk_valid
        self.prev_pyr = pyrL

        vel_new = T.compose(T_last.inverse())
        # (1,) indices: a 0-dim tensor index would be read on the host
        ref_safe = torch.clamp(slot - 1, 0, K - 1).reshape(1)
        f32 = dict(dtype=torch.float32, device=self.device)
        counts = torch.stack([
            n_in.to(torch.float32),
            torch.sum(obs_valid).to(torch.float32),
            n_tracks.to(torch.float32),
            torch.zeros((), **f32),
            torch.zeros((), **f32),
            mstate.mp_count[0].to(torch.float32),
            kf_new.to(torch.float32),
            torch.where(kf_new, slot, -1).to(torch.float32),
            mstate.kf_count[0].to(torch.float32),
        ])
        packed = torch.cat([T.R.reshape(-1), T.t, mstate.kf_R[ref_safe].reshape(-1),
                            mstate.kf_t[ref_safe].reshape(-1), counts]).to(torch.float32)
        return TrackBundle(T_R=T.R, T_t=T.t, vel_R=vel_new.R, vel_t=vel_new.t,
                           matched_mp=trk_mp, packed=packed)

    def _associate(self, feats, trk_xy, trk_mp, trk_valid) -> torch.Tensor:
        """Fresh keypoints -> the map points of surviving tracks: each
        keypoint's nearest live track, kept when the track's nearest valid
        keypoint is that keypoint (first index on ties) and the squared
        distance is below klt_assoc_radius^2; -1 elsewhere."""
        N = feats.xy.shape[0]
        r2 = float(self.cfg.tracker.klt_assoc_radius) ** 2
        inf = float("inf")
        d2 = torch.sum((feats.xy[:, None, :] - trk_xy[None, :, :]) ** 2, dim=-1)
        d2t = torch.where(trk_valid[None, :], d2, inf)
        j = torch.argmin(d2t, dim=1)
        dmin = torch.gather(d2t, 1, j[:, None])[:, 0]
        i_best = torch.argmin(torch.where(feats.valid[:, None], d2t, inf), dim=0)
        mutual = i_best[j] == torch.arange(N, device=self.device)
        keep = feats.valid & (dmin < r2) & mutual
        return torch.where(keep, trk_mp[j], torch.full_like(trk_mp[j], -1))

    # ------------------------------------------------------------------ API

    def process_stereo(self, img_left, img_right, timestamp: float) -> TrackStats:
        """Track one stereo pair with the KLT frontend. Initialization, and
        a frame with no previous pyramid (after a reset or a fork), extract
        and go through `_track_entry`; then the track set is seeded from
        the new keyframe."""
        self._pre_frame(timestamp)
        imgs = self._upload_images(img_left, img_right)
        if self.state == NOT_INITIALIZED or self.prev_pyr is None:
            self.flush()
            feats, uright, depth = self._extract_pair(imgs)
            st = self._track_entry(feats, uright, depth, timestamp, None)
            if self.state == OK:
                self._seed_tracks(feats, self.map.kf_mp[self.ref_kf])
                self.prev_pyr = self._pyramid(imgs)
            return st
        self.frame_id += 1
        bundle = self._frame_klt(imgs, self.frame_id, timestamp)
        return self._enqueue(FrameJob(self.frame_id, timestamp, self.ref_kf, bundle, None, None,
                                      None, fused=True, imgs=imgs))

    # --------------------------------------------------------------- hooks

    def _seed_tracks(self, feats, mp_ids):
        """Respawn the track set from a keyframe's keypoints: the ones with
        a map point are live."""
        self.trk_xy = feats.xy
        self.trk_mp = mp_ids.to(torch.int32)
        self.trk_level = feats.level
        self.trk_valid = feats.valid & (self.trk_mp >= 0)

    def _clear_tracks(self):
        N = self.cfg.extractor.n_features
        dev = self.device
        self.trk_xy = torch.zeros((N, 2), dtype=torch.float32, device=dev)
        self.trk_mp = torch.full((N,), -1, dtype=torch.int32, device=dev)
        self.trk_level = torch.zeros((N,), dtype=torch.int32, device=dev)
        self.trk_valid = torch.zeros((N,), dtype=torch.bool, device=dev)
        self.prev_pyr: Optional[Tuple[torch.Tensor, ...]] = None

    def reset(self):
        super().reset()
        self._clear_tracks()

    def _create_map_in_atlas(self):
        super()._create_map_in_atlas()
        self._clear_tracks()

    def _handle_failure(self, job: FrameJob, st: TrackStats, T_np: np.ndarray) -> TrackStats:
        """A KLT frame carries no features: extract them so that the
        relocalization ladder can run, and after a fix rebuild the track
        set from the local-map tracking from the fixed pose."""
        if job.feats is None and job.imgs is not None:
            feats, ur, dp = self._extract_pair(job.imgs)
            job = dataclasses.replace(job, feats=feats, uright=ur, depth=dp)
        st = super()._handle_failure(job, st, T_np)
        if st.state == OK and job.imgs is not None:
            bundle = self._track(self.map, self._slot(max(self.ref_kf, 0)), job.feats,
                                 job.uright, job.depth, self.T_dev,
                                 SE3.identity(device=self.device))
            self._seed_tracks(job.feats, bundle.matched_mp)
            self.prev_pyr = self._pyramid(job.imgs)
        return st


def make_stereo_vo(cfg: SystemConfig, vocab: Optional[voc.Vocabulary] = None,
                   device="cuda") -> StereoVO:
    """Entry point of the tracking loop, by `cfg.tracker.frontend`: "klt"
    gives the KLT frontend, anything else the ORB frontend, as in the
    reference. Runs on CUDA unless the caller passes device="cpu"; a
    vocabulary turns on loop closing and relocalization."""
    if cfg.tracker.frontend == "klt":
        return KltStereoVO(cfg, device=device, vocab=vocab)
    return StereoVO(cfg, device=device, vocab=vocab)
