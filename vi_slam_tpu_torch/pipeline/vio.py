"""Stereo visual-inertial odometry — a PyTorch copy of the JAX package's
`pipeline/vio.py::StereoInertialVO`.

The keyframe chain's preintegration lives on the device as one
`Preintegrated` with a leading (max_keyframes,) dimension, beside the
keyframe velocities, the biases and the gravity vector. Per frame the
IMU samples of the frame are integrated (a loop over the samples, the
rows past them skipped) and folded into the running keyframe segment;
once the IMU is initialized, tracking predicts the pose from the IMU and
solves the previous and current frame states together under a marginal
prior (`optim/pose_inertial.py`). With `cfg.ba.use_smoother` the solved
state then enters the fixed-lag smoother (`optim/smoother.py`): its
best-anchored inliers become the new slot's visual anchors, the frame's
preintegration its inertial edge, and the whole window is re-optimized;
the frame keeps the smoothed pose and velocity and the solve's biases.
Keyframe creation closes the running segment; a culled keyframe's segment
is composed into its successor's.

Initialization is staged as in the reference: at 2 s, 5 s and 15 s of
keyframe span, gravity, biases and velocities are solved against the
fixed visual poses (`optim/inertial_init.py`), followed by a whole-chain
visual-inertial BA. Local BA becomes the visual-inertial window BA
(`optim/vi_ba.py`) once the IMU is ready. A divergent initialization
flags a bad IMU, and the next frame discards the map. While tracking is
lost within the grace window the pose is dead-reckoned from the IMU.

With the atlas on, a fork parks the inertial state with its map, and a
merge welds it back: velocities and gravity rotate into the stored
world, the active chain's segments are appended at the slot offset, and
the seam keyframe's incoming edge is marked as having no preintegration
(`_chain_breaks`). A loop correction rotates each keyframe velocity by
its pose correction.

Before the IMU is initialized, and while tracking recovers, frames are
processed synchronously; afterwards `process_stereo_inertial` keeps the
pipeline of frames in flight, as the visual path does.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from vi_slam_tpu_torch.imu import preintegration as pre
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.optim import inertial_init as iinit
from vi_slam_tpu_torch.optim import pose_inertial, smoother, vi_ba
from vi_slam_tpu_torch.pipeline import steps
from vi_slam_tpu_torch.pipeline.stereo_vo import (
    LOST, NOT_INITIALIZED, OK, RECENTLY_LOST, FrameJob, StereoVO, TrackStats,
    make_oracle_features,
)
from vi_slam_tpu_torch.retrieval import vocabulary as voc
from vi_slam_tpu_torch.slam_map.state import _scatter_set_, dev_index
from vi_slam_tpu_torch.utils.config import SystemConfig

# the inertial programs the timer counts ("smoother": a smoother step inside
# track_vio; "smoother_slide": its marginalization, one eigh wait on a card)
INERTIAL_PROGRAMS = ("integrate", "track_vio", "inertial_init", "vi_local_ba",
                     "full_inertial_ba", "smoother", "smoother_slide")


def _pad_imu(samples, t_prev: float, t_now: float, cap: int):
    """An (n, 7) [t, acc3, gyro3] batch as fixed-capacity (acc (cap, 3),
    gyro (cap, 3), dts (cap,)) float32 arrays whose spans cover
    (t_prev, t_now] (the last sample's span stretched to t_now), and the
    number of rows used."""
    acc = np.zeros((cap, 3), np.float32)
    gyro = np.zeros((cap, 3), np.float32)
    dts = np.zeros((cap,), np.float32)
    if samples is None or len(samples) == 0:
        return acc, gyro, dts, 0
    s = np.asarray(samples, np.float64)[:cap]
    t = s[:, 0]
    n = len(s)
    prev = np.concatenate([[t_prev], t[:-1]])
    d = t - prev
    d[-1] = max(t_now - prev[-1], 0.0)
    acc[:n] = s[:, 1:4]
    gyro[:n] = s[:, 4:7]
    dts[:n] = np.maximum(d, 0.0)
    return acc, gyro, dts, n


class StereoInertialVO(StereoVO):
    """StereoVO with the IMU: preintegration, inertial tracking, staged
    initialization and visual-inertial BA."""

    # (min keyframe span s, gyro-bias prior, accel-bias prior) of each stage
    _INIT_STAGES = ((2.0, 1e2, 1e6), (5.0, 1.0, 1e5), (15.0, 1e-2, 1e-2))

    def __init__(self, cfg: SystemConfig, device="cuda", vocab: Optional[voc.Vocabulary] = None):
        super().__init__(cfg, device=device, vocab=vocab)
        dev = self.device
        ic = cfg.imu
        self.calib = pre.ImuCalib.make(ic.noise_gyro, ic.noise_acc, ic.walk_gyro, ic.walk_acc,
                                       ic.freq)
        self.imu_cap = int(4 * max(ic.freq / cfg.camera.fps, 1))
        T = np.asarray(ic.T_bc, np.float64).reshape(4, 4) if ic.T_bc is not None else np.eye(4)
        self.R_bc = torch.tensor(T[:3, :3], dtype=torch.float32, device=dev)
        self.t_bc = torch.tensor(T[:3, 3], dtype=torch.float32, device=dev)
        self.gravity_mag = float(ic.gravity)
        self._walk_g2 = float(ic.walk_gyro) ** 2
        self._walk_a2 = float(ic.walk_acc) ** 2
        # the smoother's walk informations, at the nominal frame interval
        nominal_dt = 1.0 / max(cfg.camera.fps, 1.0)
        f32 = dict(dtype=torch.float32, device=dev)
        self._sm_wig = torch.tensor(1.0 / (self._walk_g2 * nominal_dt), **f32)
        self._sm_wia = torch.tensor(1.0 / (self._walk_a2 * nominal_dt), **f32)
        self._init_k = 16  # keyframes of the initialization window
        self._full_w = 32  # chain window of the full inertial BA
        for name in INERTIAL_PROGRAMS:
            self.timer.runs.setdefault(name, 0)
            self.timer.host_s.setdefault(name, 0.0)
        self.bad_imu = False
        self._last_init_cost = float("nan")
        # frame of each initialization stage (test and smoke bookkeeping)
        self.init_stage_frames: List[int] = []
        self._reset_inertial_state()

    # ----------------------------------------------------- device programs

    def _integrate_and_accum(self, accum: pre.Preintegrated, acc, gyro, dts, n: int, bg, ba):
        """This frame's samples, and the running segment with them."""
        with self.timer.span("integrate"):
            p_frame = pre.integrate(self.calib, acc, gyro, dts, bg, ba, n_steps=n)
            return pre.compose(accum, p_frame), p_frame

    def _track_vio(self, mstate, ref_slot, feats, uright, depth, T_last: SE3, v_last, p_frame,
                   bg, ba, g_w, prior):
        """IMU prediction, projection matching (the 3x radius when too few
        points match) and the inertial pose solve. Returns (bundle, v, bg,
        ba, next prior)."""
        cfg = self.cfg
        with self.timer.span("track_vio"):
            T_pred, v_pred = pose_inertial.predict_camera_pose(
                p_frame, T_last, v_last, bg, ba, g_w, self.R_bc, self.t_bc)
            proj, mp_ids, mp_mask = self._local_map(mstate, ref_slot, T_pred)
            dt = torch.clamp(p_frame.dt, min=1e-3)
            wig = 1.0 / (self._walk_g2 * dt)
            wia = 1.0 / (self._walk_a2 * dt)

            def run_match(rad):
                m, obs, kp_idx = self._search(proj, feats, uright, rad)
                out = pose_inertial.pose_inertial_prior_optimize(
                    self.cam, prior, T_last, v_last, bg, ba, T_pred, v_pred, obs, p_frame, g_w,
                    self.R_bc, self.t_bc, wig, wia, rounds=cfg.ba.pose_rounds,
                    iters=cfg.ba.pose_iters_per_round)
                return m, obs, kp_idx, out

            radius = cfg.tracker.search_radius
            m, obs, kp_idx, out = run_match(radius)
            if int(out[-1]) < cfg.tracker.min_matches_motion:
                m, obs, kp_idx, out = run_match(3.0 * radius)
            T, v_new, bg_new, ba_new, prior_new, inlier, n_in = out
            if cfg.ba.use_smoother:
                # the smoothed pose and velocity go on; the biases stay the
                # solve's (a window of frames under generic priors does not
                # observe them better than the keyframe chain)
                anchor_ok = m.ok & proj.valid & inlier & obs.valid
                T, v_new = self._smoother_step(T, v_new, bg_new, ba_new, p_frame, obs, anchor_ok,
                                               g_w)
            bundle = self._track_bundle(mstate, ref_slot, feats, depth, proj, mp_ids, mp_mask, m,
                                        kp_idx, T, T_last, inlier, n_in)
        return bundle, v_new, bg_new, ba_new, prior_new

    def _smoother_step(self, T: SE3, v, bg, ba, p_frame: pre.Preintegrated, obs, anchor_ok, g_w):
        """One fixed-lag smoother update: slide the window when it is full
        (the oldest state Schur-marginalized into the prior), put the
        solved state in the next slot with its best inlier anchors (finest
        pyramid levels first) and the frame's preintegration as the edge
        from the slot before, then re-optimize the whole window from there.
        The count of steps since the last reset lives on the host, so the
        slide and the fresh window's prior are host branches that wait for
        nothing. Returns the slot's smoothed pose and velocity. The
        inertial edges take the identity extrinsic, whatever cfg.imu.T_bc
        is (the reference's, ROADMAP H12)."""
        cfg = self.cfg.ba
        SW = cfg.smoother_window
        with self.timer.span("smoother"):
            xw, uv, s2, vvalid = smoother.select_anchors(obs, anchor_ok, cfg.smoother_vis)
            win = self.smoother_win
            if self.smoother_count >= SW:
                with self.timer.span("smoother_slide"):
                    win = smoother.marginalize_oldest(self.cam, win, g_w, self._sm_wig,
                                                      self._sm_wia)
            k = min(self.smoother_count, SW - 1)
            win = smoother.set_slot(win, k, T, v, bg, ba, xw, uv, s2, vvalid,
                                    p_frame if k > 0 else None)
            if self.smoother_count == 0:
                win = smoother.seed_prior(win, T, v, bg, ba)
            win, _ = smoother.optimize_window(self.cam, win, g_w, self._sm_wig, self._sm_wia,
                                              iters=cfg.smoother_iters)
            self.smoother_win = win
            self.smoother_count += 1
            return SE3(win.T_R[k], win.T_t[k]), win.vel[k]

    def _close_segment(self, slot, accum: pre.Preintegrated, v, bg, ba) -> pre.Preintegrated:
        """Store the finished segment and velocity at keyframe `slot` (in
        place); return a fresh segment linearized at the current biases."""
        idx = dev_index(slot, self.device)
        for buf, x in zip(self.kf_preint_dev, accum):
            buf[idx] = x[None]
        self.kf_vel_dev[idx] = v[None]
        return pre.identity_preintegrated(device=self.device)._replace(bias_gyro=bg.clone(),
                                                                       bias_acc=ba.clone())

    def _frame_vio(self, imgs_u8, mstate, carry, T_last: SE3, v_last, bg, ba, g_w, prior, accum,
                   acc, gyro, dts, n_imu: int, frame_id: int, ts: float):
        """One pipelined inertial frame: extract + stereo, integrate, track,
        and the keyframe decision and creation (which closes the running
        segment)."""
        feats, uright, depth = self._extract_pair(imgs_u8)
        accum2, p_frame = self._integrate_and_accum(accum, acc, gyro, dts, n_imu, bg, ba)
        K = mstate.kf_R.shape[0]
        ref_slot = torch.clamp(mstate.kf_count[0].long() - 1, 0, K - 1)
        bundle, v_new, bg_new, ba_new, prior_new = self._track_vio(
            mstate, ref_slot, feats, uright, depth, T_last, v_last, p_frame, bg, ba, g_w, prior)
        segment = [accum2]

        def close(slot):
            segment[0] = self._close_segment(slot, accum2, v_new, bg_new, ba_new)

        bundle, mstate, carry, feats, uright, depth = self._decide_keyframe(
            bundle, mstate, carry, frame_id, ts, feats, uright, depth, on_create=close)
        return (bundle, mstate, carry, segment[0], v_new, bg_new, ba_new, prior_new, feats,
                uright, depth)

    def _weld_inertial(self, st_preint: pre.Preintegrated, st_vel, R_S, s_S, kf_off: int):
        """The merge's weld of the chain buffers: the active rows land at
        +kf_off (past the capacity dropped) with their velocities rotated
        and scaled into the stored world; segments are body-frame and copy
        unchanged."""
        K = st_vel.shape[0]
        k = torch.arange(K, device=self.device)
        sel = k + kf_off < K
        for d, s in zip(st_preint, self.kf_preint_dev):
            _scatter_set_(d, k + kf_off, s, sel)
        _scatter_set_(st_vel, k + kf_off, s_S * torch.einsum("ij,kj->ki", R_S, self.kf_vel_dev),
                      sel)
        return st_preint, st_vel

    def _weld_segment(self, culled: int, nxt: int):
        """A culled keyframe's incoming segment composed into its
        successor's."""
        P = self.kf_preint_dev
        merged = pre.compose(pre.map_preint(lambda x: x[culled], P),
                             pre.map_preint(lambda x: x[nxt], P))
        for buf, x in zip(P, merged):
            buf[nxt] = x

    def _gather_init(self, window: np.ndarray, pre_ok: np.ndarray):
        """Body poses, segments and edge mask of a -1 padded chain window,
        and the gravity rotation seeded from the summed velocity deltas."""
        K = self.map.kf_R.shape[0]
        w = torch.from_numpy(window).to(self.device)
        safe = torch.clamp(w, 0, K - 1).long()
        Rwb, pwb = pose_inertial.body_from_cam(SE3(self.map.kf_R[safe], self.map.kf_t[safe]),
                                               self.R_bc, self.t_bc)
        seg = pre.map_preint(lambda x: x[safe[1:]], self.kf_preint_dev)
        valid = (w[1:] >= 0) & (w[:-1] >= 0) & torch.from_numpy(pre_ok).to(self.device)
        wf = valid.to(torch.float32)
        dirG = -torch.sum(torch.einsum("kij,kj->ki", Rwb[:-1], seg.dV) * wf[:, None], dim=0)
        dirG = dirG / torch.clamp(torch.linalg.vector_norm(dirG), min=1e-9)
        return Rwb, pwb, seg, valid, iinit._align_z(dirG)

    def _vi_local_ba(self, temporal: np.ndarray, fixed_t: np.ndarray, pre_ok: np.ndarray,
                     last_idx: int, WF: int, n_iters: int):
        """Visual-inertial BA over the temporal chain window (pose,
        velocity and biases; inertial edges along its prefix) with the WF
        most covisible keyframes outside it as fixed anchors. Scatters the
        poses, points and velocities back; returns (bg, ba of the newest
        keyframe, the correction of the live pose)."""
        cfg = self.cfg
        mstate = self.map
        dev = self.device
        K = mstate.kf_R.shape[0]
        Wv = temporal.shape[0]
        WT = Wv + WF
        temporal_t = torch.from_numpy(temporal).to(dev)
        fixed_tt = torch.from_numpy(fixed_t).to(dev)
        if WF > 0:
            cand = steps.covis_window(mstate, self.ref_kf, WT)
            in_temp = torch.any(cand[:, None] == temporal_t[None, :], dim=1) | (cand < 0)
            key = torch.where(in_temp, torch.full_like(cand, WT + 1),
                              torch.arange(WT, dtype=cand.dtype, device=dev))
            order = torch.argsort(key, stable=True)[:WF]
            anchors = torch.where(key[order] <= WT, cand[order], torch.full_like(cand[order], -1))
            window = torch.cat([temporal_t.to(anchors.dtype), anchors])
            fixed = torch.cat([fixed_tt, torch.ones((WF,), dtype=torch.bool, device=dev)])
        else:
            window, fixed = temporal_t, fixed_tt
        mp_ids, _ = steps.gather_local_points(mstate, temporal_t, cfg.ba.max_local_points)
        visual = steps.gather_ba_problem(self.cam, mstate, window, fixed, mp_ids, n_window=WT,
                                         n_points=cfg.ba.max_local_points,
                                         n_obs=cfg.map.max_obs_per_point)
        safe = torch.clamp(window, 0, K - 1).long()
        seg = pre.map_preint(lambda x: x[safe[1:]], self.kf_preint_dev)
        ivalid = ((window[1:] >= 0) & (window[:-1] >= 0)
                  & (torch.arange(WT - 1, device=dev) < Wv - 1)
                  & torch.cat([torch.from_numpy(pre_ok).to(dev),
                               torch.zeros((WT - Wv,), dtype=torch.bool, device=dev)]))
        dt = torch.clamp(seg.dt, min=1e-3)
        prob = vi_ba.VIBAProblem(
            visual=visual, vel=self.kf_vel_dev[safe], bg=self.bg_dev.expand(WT, 3),
            ba=self.ba_dev.expand(WT, 3), preint=seg, inertial_valid=ivalid,
            gravity=self.g_w_dev, walk_info_g=1.0 / (self._walk_g2 * dt),
            walk_info_a=1.0 / (self._walk_a2 * dt), R_bc=self.R_bc, t_bc=self.t_bc)
        res = vi_ba.vi_bundle_adjust(self.cam, prob, iters=n_iters, use_huber=True)
        r1 = dev_index(self.ref_kf, dev)
        ref_pre = SE3(mstate.kf_R[r1][0], mstate.kf_t[r1][0])
        self.map = steps.scatter_ba_result(mstate, window, fixed, mp_ids, res.poses, res.points)
        ref_post = SE3(self.map.kf_R[r1][0], self.map.kf_t[r1][0])
        _scatter_set_(self.kf_vel_dev, torch.clamp(window, min=0), res.vel,
                      (window >= 0) & ~fixed)
        return res.bg[last_idx], res.ba[last_idx], ref_pre.inverse().compose(ref_post)

    # ------------------------------------------------------------------ API

    def process_oracle_inertial(self, xy, uright, depth, desc, level, imu_samples,
                                timestamp: float) -> TrackStats:
        """Track one frame of given keypoints with its IMU samples
        ((n, 7) [t, acc xyz, gyro xyz] in (t_prev, t_now]), synchronously."""
        self._pre_frame(timestamp)
        feats, ur, dp = make_oracle_features(self.cfg.extractor.n_features, xy, uright, depth,
                                             desc, level, device=self.device)
        return self._inertial_entry(feats, ur, dp, imu_samples, timestamp)

    def process_stereo_inertial(self, img_left, img_right, imu_samples,
                                timestamp: float) -> TrackStats:
        """Track one stereo pair with its IMU samples. Synchronous until the
        IMU is initialized and while recovering; then pipelined like
        `process_stereo` (the chain couples frames only through device
        state). Returns the stats of the newest finalized frame."""
        self._pre_frame(timestamp)
        if not self.imu_ready or self.state != OK or self._last_ts is None:
            self.flush()
            self._vio_pipelined = False
            feats, ur, dp = self._extract_pair(self._upload_images(img_left, img_right))
            return self._inertial_entry(feats, ur, dp, imu_samples, timestamp)
        if not self._vio_pipelined:
            # entering the pipeline: the device keyframe-decision carry
            # takes the host's counters of the synchronous phase
            self.carry_dev = torch.tensor([self.frames_since_kf, max(self._ref_kf_tracked, 1)],
                                          dtype=torch.int32, device=self.device)
            self._vio_pipelined = True
        imgs = self._upload_images(img_left, img_right)
        acc, gyro, dts, n = self._imu_tensors(imu_samples, timestamp)
        self.frame_id += 1
        (bundle, self.map, self.carry_dev, self._accum, self.vel_w_dev, self.bg_dev, self.ba_dev,
         self.prior_dev, feats, ur, dp) = self._frame_vio(
            imgs, self.map, self.carry_dev, self.T_dev, self.vel_w_dev, self.bg_dev, self.ba_dev,
            self.g_w_dev, self.prior_dev, self._accum, acc, gyro, dts, n, self.frame_id,
            timestamp)
        return self._enqueue(FrameJob(self.frame_id, timestamp, self.ref_kf, bundle, feats, ur,
                                      dp, fused=True))

    def _imu_tensors(self, imu_samples, timestamp: float):
        acc, gyro, dts, n = _pad_imu(imu_samples, self._last_ts, timestamp, self.imu_cap)
        self._last_ts = timestamp
        t = lambda a: torch.from_numpy(a).to(self.device)
        return t(acc), t(gyro), t(dts), n

    def _on_keyframe_created(self, job: FrameJob, slot: int):
        """A keyframe the device created (its segment already closed):
        the host's chain and the staged initialization."""
        if job.fused:
            self.kf_chain.append(slot)
            self._maybe_init_imu()

    def _inertial_entry(self, feats, ur, dp, imu_samples, timestamp: float) -> TrackStats:
        p_frame = self._preintegrate(imu_samples, timestamp)
        if self.state == NOT_INITIALIZED:
            return self._track_entry(feats, ur, dp, timestamp, None)
        ref = self._slot(max(self.ref_kf, 0))
        if self.imu_ready and p_frame is not None:
            bundle, self.vel_w_dev, self.bg_dev, self.ba_dev, self.prior_dev = self._track_vio(
                self.map, ref, feats, ur, dp, self.T_dev, self.vel_w_dev, p_frame, self.bg_dev,
                self.ba_dev, self.g_w_dev, self.prior_dev)
        else:
            bundle = self._track(self.map, ref, feats, ur, dp, self.T_dev, self.vel_dev)
        return self._track_entry(feats, ur, dp, timestamp, bundle)

    # ------------------------------------------------------------ inertial

    def _preintegrate(self, imu_samples, timestamp: float) -> Optional[pre.Preintegrated]:
        """This frame's samples folded into the running segment (none for
        the first frame of a map's clock)."""
        if self._last_ts is None:
            self._last_ts = timestamp
            return None
        acc, gyro, dts, n = self._imu_tensors(imu_samples, timestamp)
        self._accum, p_frame = self._integrate_and_accum(self._accum, acc, gyro, dts, n,
                                                         self.bg_dev, self.ba_dev)
        return p_frame

    def _create_keyframe(self, feats, uright, depth, matched_mp, timestamp, pose_dev=None,
                         frame_id=None, pose_np=None):
        super()._create_keyframe(feats, uright, depth, matched_mp, timestamp, pose_dev=pose_dev,
                                 frame_id=frame_id, pose_np=pose_np)
        slot = self.ref_kf
        self._accum = self._close_segment(slot, self._accum, self.vel_w_dev, self.bg_dev,
                                          self.ba_dev)
        self.kf_chain.append(slot)
        self._maybe_init_imu()

    def _apply_cull_info(self, info: np.ndarray):
        if float(info[0]) >= 0.5:
            slot = int(info[1])
            if slot in self.kf_chain:
                i = self.kf_chain.index(slot)
                if 0 < i < len(self.kf_chain) - 1:
                    nxt = self.kf_chain[i + 1]
                    if slot in self._chain_breaks:
                        # a seam's incoming segment is not physical: pass
                        # the break on instead of welding it
                        self._chain_breaks.add(nxt)
                    else:
                        self._weld_segment(slot, nxt)
                if i > 0:
                    self.kf_chain.pop(i)
            self._chain_breaks.discard(slot)
        super()._apply_cull_info(info)

    def _pre_frame(self, timestamp: float):
        """A bad-IMU verdict discards the active map (its records frozen
        to absolute poses first) before the next frame."""
        if self.bad_imu:
            self.flush()
            self._freeze_active_records()
            self._new_active_map()
            self._reset_inertial_state()
            self.bad_imu = False
        super()._pre_frame(timestamp)

    def _apply_map_scale(self, s: float):
        """Rescale the active map and every translation-like state by s
        (rotations, biases and preintegration unchanged)."""
        m = self.map
        for x in (m.kf_t, m.mp_pos, m.mp_min_dist, m.mp_max_dist, self.kf_vel_dev,
                  self.vel_w_dev):
            x.mul_(s)
        self.T_dev = SE3(self.T_dev.R, self.T_dev.t * s)
        self.vel_dev = SE3(self.vel_dev.R, self.vel_dev.t * s)
        self._last_good = (self.T_dev.R, self.T_dev.t)
        self.T_np = self.T_np.copy()
        self.T_np[:3, 3] *= s
        self.ref_pose_np = self.ref_pose_np.copy()
        self.ref_pose_np[:3, 3] *= s
        for i, rec in enumerate(self.records):
            if rec.map_id != self.active_map_id:
                continue
            T_rel = rec.T_rel.copy()
            T_rel[:3, 3] *= s
            self.records[i] = rec.__class__(rec.frame_id, rec.timestamp, rec.ref_kf, T_rel,
                                            rec.state, rec.map_id)
        culled = {}
        for k, (p, T) in self.culled_parent.items():
            T2 = T.copy()
            T2[:3, 3] *= s
            culled[k] = (p, T2)
        self.culled_parent = culled
        self._reset_smoother()

    def _pre_ok(self, window: np.ndarray, Wv: int) -> np.ndarray:
        """(Wv-1,) True where the chain edge window[i] -> window[i+1] has a
        physical segment (False across a merge seam)."""
        out = np.ones((Wv - 1,), bool)
        for i in range(Wv - 1):
            if window[i + 1] < 0 or int(window[i + 1]) in self._chain_breaks:
                out[i] = False
        return out

    def _reset_inertial_state(self):
        """A fresh inertial state for a new (or reset) map."""
        dev = self.device
        K = self.cfg.map.max_keyframes
        z3 = lambda: torch.zeros((3,), dtype=torch.float32, device=dev)
        self.kf_preint_dev = pre.identity_preintegrated((K,), device=dev)
        self.kf_vel_dev = torch.zeros((K, 3), dtype=torch.float32, device=dev)
        self.bg_dev, self.ba_dev, self.g_w_dev, self.vel_w_dev = z3(), z3(), z3(), z3()
        self._accum = pre.identity_preintegrated(device=dev)
        self.prior_dev = pose_inertial.initial_prior(SE3.identity(device=dev), z3(), z3(), z3())
        self.imu_ready = False
        self._init_stage = 0
        self._init_attempts = 0
        self.kf_chain: List[int] = []
        self._chain_breaks: set = set()  # slots whose incoming edge has no segment
        self._last_ts: Optional[float] = None
        self._vio_pipelined = False
        if self.loop_closer is not None:
            self.loop_closer.gravity_aligned = False
            self.loop_closer.gravity_w = None
        self._reset_smoother()

    def _reseed_prior(self):
        self.prior_dev = pose_inertial.initial_prior(self.T_dev, self.vel_w_dev, self.bg_dev,
                                                     self.ba_dev)

    def _reset_smoother(self):
        """An empty smoother window: after the state's basis (gravity,
        biases, scale, the map) changed, its warm start would be linearized
        at a stale state."""
        ba = self.cfg.ba
        self.smoother_win = smoother.allocate_window(ba.smoother_window, ba.smoother_vis,
                                                     device=self.device)
        self.smoother_count = 0

    def _shift_smoother(self, delta: SE3):
        """A keyframe-rate BA's correction of the live pose applied to the
        window's poses and its prior's linearization point (velocity and
        bias shifts are second order for such corrections)."""
        w = self.smoother_win
        T = SE3(w.T_R, w.T_t).compose(delta)
        P = SE3(w.prior_R, w.prior_t).compose(delta)
        self.smoother_win = w._replace(T_R=T.R, T_t=T.t, prior_R=P.R, prior_t=P.t)

    # ---------------------------------------------------- atlas (inertial)

    def _create_map_in_atlas(self):
        """Park the map with its inertial state, then start fresh."""
        sidecar = {
            "kf_preint": self.kf_preint_dev, "kf_vel": self.kf_vel_dev, "bg": self.bg_dev,
            "ba": self.ba_dev, "g_w": self.g_w_dev, "imu_ready": self.imu_ready,
            "init_stage": self._init_stage, "kf_chain": list(self.kf_chain),
            "chain_breaks": set(self._chain_breaks),
        }
        super()._create_map_in_atlas()
        if self.atlas_stored:
            self.atlas_stored[-1].inertial = sidecar
        self._reset_inertial_state()

    def reset(self):
        super().reset()
        self._reset_inertial_state()
        self.bad_imu = False

    def _do_merge(self, si: int, cur: int, cand: int, S_cl, pairs) -> bool:
        """The visual merge, then the inertial weld: the active chain's
        velocities rotate into the stored world and its segments append at
        the slot offset, the seam edge is marked, gravity is the stored
        map's when it has one, and a whole-chain inertial BA follows."""
        # the drain can create keyframes and close segments: snapshot after it
        self.flush()
        sm = self.atlas_stored[si]
        kf_off = sm.n_kf
        act_chain = list(self.kf_chain)
        act_breaks = set(self._chain_breaks)
        act_ready = self.imu_ready
        act_stage = self._init_stage
        if not super()._do_merge(si, cur, cand, S_cl, pairs):
            return False
        side = sm.inertial or {}
        R_S = self._last_weld_S.R.to(torch.float32)
        s_S = self._last_weld_S.s.to(torch.float32)
        st_preint = side.get("kf_preint")
        st_vel = side.get("kf_vel")
        if st_preint is None:
            st_preint = pre.map_preint(torch.clone, self.kf_preint_dev)
            st_vel = torch.zeros_like(self.kf_vel_dev)
        self.kf_preint_dev, self.kf_vel_dev = self._weld_inertial(st_preint, st_vel, R_S, s_S,
                                                                  kf_off)
        self.vel_w_dev = s_S * (R_S @ self.vel_w_dev)
        self.g_w_dev = side["g_w"] if side.get("imu_ready", False) else R_S @ self.g_w_dev
        self.kf_chain = list(side.get("kf_chain", [])) + [s + kf_off for s in act_chain]
        self._chain_breaks = set(side.get("chain_breaks", set()))
        self._chain_breaks |= {s + kf_off for s in act_breaks}
        if act_chain:
            self._chain_breaks.add(act_chain[0] + kf_off)
        self.imu_ready = act_ready or side.get("imu_ready", False)
        self._init_stage = max(act_stage, side.get("init_stage", 0))
        self._reseed_prior()
        self._reset_smoother()
        if self.imu_ready and len(self.kf_chain) >= 3:
            self._full_inertial_ba()
        return True

    def _after_loop_correction(self):
        """After a loop correction: each keyframe velocity rotated by its
        keyframe's rotation correction, the live velocity by the reference
        keyframe's, and the prior re-seeded. (A merge also ends here, with
        no pre-correction poses.)"""
        lc = self.loop_closer
        old = lc._last_old_poses if lc is not None else None
        if lc is not None:
            lc._last_old_poses = None
        super()._after_loop_correction()
        if not self.imu_ready or old is None:
            return
        old_R = old[0]
        R_cor = torch.einsum("kji,kjl->kil", self.map.kf_R, old_R)
        v_rot = torch.einsum("kij,kj->ki", R_cor, self.kf_vel_dev)
        self.kf_vel_dev = torch.where(self.map.kf_valid[:, None], v_rot, self.kf_vel_dev)
        ref = max(self.ref_kf, 0)
        self.vel_w_dev = R_cor[ref] @ self.vel_w_dev
        self._reseed_prior()
        self._reset_smoother()

    # ------------------------------------------------------- initialization

    def _maybe_init_imu(self):
        """The staged initialization: once the chain spans the stage's
        seconds over >= 6 keyframes, solve gravity, biases and velocities
        against the fixed visual poses (scale too on a monocular map);
        accept a finite, improving solve within the noise band, flag a bad
        IMU on a divergent one or on 12 failures at the first stage."""
        if self._init_stage >= len(self._INIT_STAGES) or len(self.kf_chain) < 6:
            return
        ts = self.map.kf_timestamp[[self.kf_chain[0], self.kf_chain[-1]]].cpu().numpy()
        min_span, prior_g, prior_a = self._INIT_STAGES[self._init_stage]
        if float(ts[1] - ts[0]) < min_span:
            return
        with self.timer.span("inertial_init"):
            window = np.full((self._init_k,), -1, np.int32)
            chain = self.kf_chain[-self._init_k:]
            window[:len(chain)] = chain
            pre_ok = np.asarray([w >= 0 and int(w) not in self._chain_breaks
                                 for w in window[1:]], bool)
            Rwb, pwb, seg, valid, Rwg0 = self._gather_init(window, pre_ok)
            mono = float(self.cfg.camera.bf) <= 0
            res = iinit.inertial_init(Rwb, pwb, seg, valid, prior_g=prior_g, prior_a=prior_a,
                                      optimize_scale=mono, gravity_mag=self.gravity_mag,
                                      Rwg0=Rwg0)
            got = torch.cat([res.cost, res.bg, res.ba, torch.sum(valid)[None].float()]).cpu().numpy()
        costs, bg, ba = got[:-7], got[-7:-4], got[-4:-1]
        n_edges = max(int(got[-1]), 1)
        self._last_init_cost = float(costs[-1]) / n_edges
        if (not np.isfinite(costs[-1]) or costs[-1] > 0.95 * costs[0]
                or self._last_init_cost > 1e5):
            self._init_attempts += 1
            if self._init_stage == 0 and self._init_attempts >= 12:
                self.bad_imu = True
            return
        if np.linalg.norm(bg) > 1.0 or np.linalg.norm(ba) > 5.0 or self._last_init_cost > 1e5:
            self._init_attempts += 1
            self.bad_imu = True
            return
        self.bg_dev = res.bg
        self.ba_dev = res.ba
        g0 = torch.tensor([0.0, 0.0, -self.gravity_mag], dtype=torch.float32, device=self.device)
        self.g_w_dev = res.Rwg @ g0
        if mono:
            s = float(res.scale)
            if abs(s - 1.0) > 1e-4:
                self._apply_map_scale(s)
        w = torch.from_numpy(window).to(self.device)
        _scatter_set_(self.kf_vel_dev, torch.clamp(w, min=0), res.vel, w >= 0)
        self.vel_w_dev = self.kf_vel_dev[chain[-1]].clone()
        # the running segment is linearized at the new biases
        self._accum = self._accum._replace(bias_gyro=res.bg, bias_acc=res.ba)
        self._reseed_prior()
        self._reset_smoother()
        self.imu_ready = True
        self._init_stage += 1
        self.init_stage_frames.append(self.records[-1].frame_id)
        if self.loop_closer is not None:
            # loop corrections now keep the gravity direction: the 4-DoF graph
            self.loop_closer.gravity_aligned = True
            self.loop_closer.gravity_w = self.g_w_dev
            self.loop_closer.fix_scale = True
        self._full_inertial_ba()

    def _chain_window(self, Wv: int):
        """The newest Wv chain slots, -1 padded, the oldest one fixed."""
        window = np.full((Wv,), -1, np.int32)
        chain = self.kf_chain[-Wv:]
        window[:len(chain)] = chain
        fixed = np.zeros((Wv,), bool)
        fixed[0] = True
        fixed[len(chain):] = True
        return window, fixed, len(chain)

    def _full_inertial_ba(self):
        """Whole-chain visual-inertial BA after an initialization stage;
        then the live pose chain is re-anchored and the prior re-seeded."""
        if len(self.kf_chain) < 3:
            return
        with self.timer.span("full_inertial_ba"):
            window, fixed, n = self._chain_window(self._full_w)
            self.bg_dev, self.ba_dev, delta = self._vi_local_ba(
                window, fixed, self._pre_ok(window, self._full_w), n - 1, 0,
                2 * self.cfg.ba.local_ba_iters)
            self.T_dev = self.T_dev.compose(delta)
            self._last_good = (self.T_dev.R, self.T_dev.t)
            self.vel_w_dev = self.kf_vel_dev[self.kf_chain[-1]].clone()
            self._reseed_prior()
            self._reset_smoother()

    def _local_ba(self):
        if not self.imu_ready:
            return super()._local_ba()
        if len(self.kf_chain) < 2:
            return
        Wv = self.cfg.ba.inertial_window
        with self.timer.span("vi_local_ba"):
            window, fixed, n = self._chain_window(Wv)
            self.bg_dev, self.ba_dev, delta = self._vi_local_ba(
                window, fixed, self._pre_ok(window, Wv), n - 1, min(6, self.cfg.ba.max_fixed_kfs),
                self.cfg.ba.local_ba_iters)
            self.T_dev = self.T_dev.compose(delta)
            self._last_good = (self.T_dev.R, self.T_dev.t)
            # mapping rewrote the keyframe states: the per-frame prior is
            # re-seeded at the corrected live state, and the smoother's
            # window takes the same correction
            self._reseed_prior()
            self._shift_smoother(delta)

    def _handle_failure(self, job: FrameJob, st: TrackStats, T_np: np.ndarray) -> TrackStats:
        """With a live inertial state the grace window is bridged by dead
        reckoning: the frame keeps its IMU-predicted pose."""
        if not self.imu_ready or job.bundle is None:
            return super()._handle_failure(job, st, T_np)
        if self.state == OK:
            self.state = RECENTLY_LOST
            self._lost_since = job.timestamp
        if job.timestamp - self._lost_since <= self.cfg.tracker.recently_lost_sec:
            self.T_np = T_np
            self._record(job, T_np, self.ref_pose_np, self.ref_kf, RECENTLY_LOST)
            st.n_kfs, st.n_mps, st.state = self.n_kf, self.n_mp, self.state
            self.stats.append(st)
            return st
        self.state = LOST
        return super()._handle_failure(job, st, T_np)


def make_stereo_inertial_vo(cfg: SystemConfig, vocab: Optional[voc.Vocabulary] = None,
                            device="cuda") -> StereoInertialVO:
    """Entry point of the stereo-inertial pipeline; runs on CUDA unless the
    caller passes device="cpu". A vocabulary turns on loop closing,
    relocalization and the atlas, `cfg.ba.use_smoother` the fixed-lag
    smoother. The ORB frontend only, as in the reference (its
    StereoInertialVO is a StereoVO, not a KltStereoVO)."""
    if cfg.tracker.frontend == "klt":
        raise NotImplementedError("the stereo-inertial pipeline has the ORB frontend only:"
                                  " the reference has no KLT stereo-inertial pipeline")
    return StereoInertialVO(cfg, device=device, vocab=vocab)
