"""Stereo visual odometry: the host state machine over the device programs
— a PyTorch copy of the JAX package's `pipeline/stereo_vo.py::StereoVO`.

Per frame, `_frame` extracts ORB features from both images, associates
them along the scanlines, tracks the local map (covisibility window,
projection matching, pose Gauss-Newton), and decides and creates a
keyframe. All host-relevant numbers come back in one packed float32
vector, copied to pinned host memory without blocking. The host keeps a
`pipeline_depth`-deep queue of frames in flight and finalizes the oldest,
so its bookkeeping (records, states, keyframe counts) happens on the same
frames as in the reference. `process_oracle` is the synchronous path for
given keypoints (tests without the image frontend); it decides keyframes
on the host, as `process_rgbd` does for an RGB-D frame (one-image
extraction, each keypoint's depth turned into a virtual right
coordinate). The KLT frontend is the subclass `pipeline/klt_vo.py::
KltStereoVO`, which `make_stereo_vo` picks by `cfg.tracker.frontend`.

At keyframe rate the host runs, on the reference's cadences, the mapping
pass (fuse with covisible neighbours, stereo triangulation against the
best one), local BA over the covisibility window, and map maintenance
(young-point culling and the culling of one redundant keyframe). None of
them waits for the device: local BA's correction of the live pose chain
is composed on the device, and a cull's bookkeeping comes back with a
later frame's pull. `trajectory_wc` walks past culled reference keyframes.

Given a vocabulary, the system also closes loops and relocalizes. Each
new keyframe's BoW vector enters the place-recognition database at once;
its map-point row is copied to the host without blocking, and the loop
query for it runs one keyframe later (`_loop_closing`), as the
reference's loop-closing thread lags its mapping. A verified loop drains
the frames in flight, corrects the map (essential graph and global BA)
and re-anchors the live pose on the corrected reference keyframe. A
failed frame first tries to relocalize against the database; otherwise
it degrades OK -> RECENTLY_LOST -> LOST.

A young map (< 10 keyframes) that gets lost, and a timestamp that jumps
backwards or too far, reset the system. With the atlas on (a vocabulary
and `atlas_enabled`) and at least 5 keyframes, a map lost for longer than
`recently_lost_sec + atlas_lost_sec`, or a timestamp jump, parks the
active map with its database and covisibility graph and starts a new one
(`_create_map_in_atlas`). At every keyframe the newest keyframe then
queries each parked map's database; a candidate verified by a Sim3 RANSAC
welds the active map into the parked one (`_do_merge`: the constant-offset
append of `slam_map/atlas.py`, seam fusion and whole-map BA), and the
frame records of the active map are relabelled to the merged one.
`trajectory_wc` resolves each record in its own map.

The reference's two `lax.cond`s (the wide-radius retry and the keyframe
creation) become host branches here, which read one device scalar each.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vi_slam_tpu_torch.cameras import pinhole
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.features.extractor import Features, OrbExtractor
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.ops import match as match_ops
from vi_slam_tpu_torch.ops import pyramid as pyr_ops
from vi_slam_tpu_torch.ops import stereo as stereo_ops
from vi_slam_tpu_torch.ops.fast import top_k
from vi_slam_tpu_torch.optim import local_ba, pose_opt
from vi_slam_tpu_torch.pipeline import steps
from vi_slam_tpu_torch.pipeline.loop_closing import LoopCloser, _kf_bow
from vi_slam_tpu_torch.pipeline.relocalization import Relocalizer
from vi_slam_tpu_torch.retrieval import vocabulary as voc
from vi_slam_tpu_torch.slam_map import atlas as atlas_mod
from vi_slam_tpu_torch.slam_map import state as map_state
from vi_slam_tpu_torch.utils.config import SystemConfig
from vi_slam_tpu_torch.utils.device import resolve_device
from vi_slam_tpu_torch.utils.numerics import norm3_f32
from vi_slam_tpu_torch.utils.sampling import DrawFn, Sampler
from vi_slam_tpu_torch.utils.timing import ProgramTimer

NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
RECENTLY_LOST = "RECENTLY_LOST"
LOST = "LOST"

# packed layout (float32): [T_R(9), T_t(3), ref_R(9), ref_t(3), n_in,
# n_matches, n_local, n_tracked_close, n_creatable, mp_count, kf_flag,
# new_kf_slot, kf_count] = (33,)
PACKED_LEN = 33
_PK_NIN = 24
_PK_NMATCH = 25
_PK_NLOCAL = 26
_PK_NCLOSE = 27
_PK_NCREAT = 28
_PK_MPCOUNT = 29
_PK_KFFLAG = 30
_PK_KFSLOT = 31
_PK_KFCOUNT = 32


class TrackBundle(NamedTuple):
    """Per-frame device outputs; `packed` is the only one the host reads."""

    T_R: torch.Tensor  # (3, 3) optimized Tcw
    T_t: torch.Tensor  # (3,)
    vel_R: torch.Tensor  # (3, 3) T_cur ∘ T_last^-1
    vel_t: torch.Tensor  # (3,)
    matched_mp: torch.Tensor  # (N,) int32
    packed: torch.Tensor  # (33,) float32


@dataclass
class FrameJob:
    """A frame dispatched and not yet finalized."""

    frame_id: int
    timestamp: float
    ref_kf: int  # host reference keyframe at dispatch
    bundle: Optional[TrackBundle]
    feats: Optional[Features]  # None for a KLT frame, which extracts none
    uright: Optional[torch.Tensor]
    depth: Optional[torch.Tensor]
    fused: bool = False  # the keyframe decision ran inside the frame program
    packed_host: Optional[torch.Tensor] = None  # pinned copy of bundle.packed
    copied: Optional[torch.cuda.Event] = None  # set when packed_host is filled
    # the uploaded (2, H, W) uint8 pair of a KLT frame, from which a failed
    # frame extracts its features for the relocalization ladder
    imgs: Optional[torch.Tensor] = None


@dataclass
class FrameRecord:
    frame_id: int
    timestamp: float
    ref_kf: int
    T_rel: np.ndarray  # (4, 4) Tcw_frame @ Twc_refkf
    state: str
    map_id: int = 0  # the atlas map the frame tracked in


@dataclass
class TrackStats:
    n_matches: int = 0
    n_inliers: int = 0
    n_local_points: int = 0
    n_kfs: int = 0
    n_mps: int = 0
    state: str = OK


def make_oracle_features(n: int, xy, uright, depth, desc, level, device="cuda"):
    """Pad given keypoint arrays into a fixed-capacity Features batch and
    its (u_right, depth) on `device`: the first min(len, n) entries are
    valid."""
    device = resolve_device(device)
    cnt = min(len(xy), n)

    def pad(a, shape, fill, dtype):
        out = np.full(shape, fill, dtype)
        out[:cnt] = np.asarray(a)[:cnt]
        return torch.from_numpy(out).to(device)

    valid = np.zeros((n,), bool)
    valid[:cnt] = True
    feats = Features(
        xy=pad(xy, (n, 2), 0.0, np.float32),
        level=pad(level, (n,), 0, np.int32),
        angle=torch.zeros((n,), dtype=torch.float32, device=device),
        score=pad(np.ones(cnt), (n,), 0.0, np.float32),
        desc=pad(np.asarray(desc, np.uint32).view(np.int32), (n, 8), 0, np.int32),
        valid=torch.from_numpy(valid).to(device),
    )
    return feats, pad(uright, (n,), -1.0, np.float32), pad(depth, (n,), -1.0, np.float32)


class StereoVO:
    """Stereo VO over the array map, on one device."""

    def __init__(self, cfg: SystemConfig, device="cuda", vocab: Optional[voc.Vocabulary] = None):
        if cfg.camera.model != "pinhole":
            raise NotImplementedError(
                f"camera model {cfg.camera.model!r}: the port has the pinhole model only"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        c = cfg.camera
        dev = self.device
        self.cam = CameraParams.make(c.fx, c.fy, c.cx, c.cy, dist=c.dist, bf=c.bf, device=dev)
        self.baseline = c.bf / c.fx
        self.close_depth = cfg.camera.th_depth * self.baseline
        self.extractor = OrbExtractor(cfg.extractor, c.height, c.width, device=dev)
        ext = cfg.extractor
        self.level_scales = torch.from_numpy(
            pyr_ops.scale_factors(ext.n_levels, ext.scale_factor)
        ).to(dev)
        self.row_offsets = torch.tensor(self.extractor.row_offsets, dtype=torch.int32, device=dev)
        m = cfg.map
        self.map = map_state.allocate(
            m.max_keyframes, ext.n_features, m.max_points, m.max_obs_per_point, device=dev
        )
        self.n_kf = 0
        self.n_mp = 0
        # culled keyframe -> (parent slot, T_culled @ inv(T_parent) at cull
        # time), the hops trajectory_wc walks past culled reference keyframes
        self.culled_parent: Dict[int, Tuple[int, np.ndarray]] = {}
        self._pending_culls: List[Tuple[torch.Tensor, Optional[torch.cuda.Event]]] = []
        # keyframe-rate programs and relocalization attempts: runs, host
        # seconds spent dispatching them, device spans on the card
        self.timer = ProgramTimer(dev, ("mapping", "local_ba", "maintenance", "reloc", "fork",
                                        "merge_detect", "merge"))
        self.program_runs = self.timer.runs
        self.program_host_s = self.timer.host_s
        self.state = NOT_INITIALIZED
        self.ref_kf = -1
        self.frame_id = -1
        self.frames_since_kf = 0
        self._ref_kf_tracked = 0
        self.records: List[FrameRecord] = []
        self.stats: List[TrackStats] = []
        self.n_relocalized = 0  # frames recovered by relocalization
        self.T_dev = SE3.identity(device=dev)
        self.vel_dev = SE3.identity(device=dev)
        self.T_np = np.eye(4)
        self.ref_pose_np = np.eye(4)
        self._last_good = (self.T_dev.R, self.T_dev.t)
        self._lost_since = 0.0
        self._reset_pending = False
        self._last_frame_ts: Optional[float] = None
        # device keyframe-decision carry: (frames_since_kf, ref_kf_tracked)
        self.carry_dev = torch.zeros((2,), dtype=torch.int32, device=dev)
        self.pipeline_depth = cfg.tracker.pipeline_depth
        self._inflight: deque = deque()
        self._map_tick = 0
        self._ba_tick = 0
        self._maint_tick = 0
        tr = cfg.tracker
        self._min_ok_static = max(tr.min_matches_motion // 2, 10)
        self._kf_budget = min(tr.kf_point_budget, ext.n_features)
        # loop closing and relocalization, enabled by a vocabulary. Each
        # new keyframe's (slot, map-point row in flight to the host) waits
        # here for its loop query one keyframe later.
        self._covis_queue: deque = deque()
        self._loop_busy = False
        self.loop_closer: Optional[LoopCloser] = None
        self.relocalizer: Optional[Relocalizer] = None
        if vocab is not None:
            self.loop_closer = LoopCloser(cfg, self.cam, vocab, fix_scale=True)
            self.relocalizer = Relocalizer(self.cam, self.level_scales)
        # the atlas: parked maps, the active map's id, and the merge's
        # Sim3 RANSAC samples (a generator seeded 23, the reference's key)
        self.atlas_stored: List[atlas_mod.StoredMap] = []
        self.active_map_id = 0
        self.merge_count = 0
        self._next_map_id = 0
        self._fork_pending = False
        self._merge_guard = False
        self.merge_draw: DrawFn = Sampler(23, dev)

    # ----------------------------------------------------- device programs

    def _local_map(self, mstate, ref_slot, T_pred: SE3):
        """The covisibility window's points projected from T_pred:
        (projection, point ids, point mask)."""
        cfg = self.cfg
        ext = cfg.extractor
        window = steps.covis_window(mstate, ref_slot, cfg.ba.max_local_kfs)
        mp_ids, mp_mask = steps.gather_local_points(mstate, window, cfg.ba.max_local_points)
        proj = steps.project_local_points(
            self.cam, mstate, mp_ids, mp_mask, T_pred,
            cfg.camera.width, cfg.camera.height,
            n_levels=ext.n_levels, scale_factor=ext.scale_factor,
        )
        return proj, mp_ids, mp_mask

    def _search(self, proj, feats, uright, radius: float):
        """Projection matching within `radius`: (matches, pose
        observations, their keypoint indices)."""
        cfg = self.cfg
        m = match_ops.search_by_projection(
            proj.uv, proj.level, proj.desc, proj.valid,
            feats.xy, feats.level, feats.desc, feats.valid,
            radius=radius, level_scales=self.level_scales,
            max_dist=cfg.matcher.th_high, ratio=cfg.matcher.nn_ratio,
        )
        m = match_ops.resolve_duplicate_targets(m, cfg.extractor.n_features)
        obs, kp_idx = steps.build_pose_obs(proj, m, feats, uright)
        return m, obs, kp_idx

    def _track(self, mstate, ref_slot, feats, uright, depth, T_last: SE3, vel: SE3) -> TrackBundle:
        """Local-map tracking: covisibility window, projection matching
        with a 3x-radius retry from the last pose when too few points
        match, and pose Gauss-Newton."""
        cfg = self.cfg
        T_pred = vel.compose(T_last)
        proj, mp_ids, mp_mask = self._local_map(mstate, ref_slot, T_pred)

        def run_match(rad, T_init):
            m, obs, kp_idx = self._search(proj, feats, uright, rad)
            T_opt, inlier, n_in = pose_opt.pose_optimize(
                self.cam, T_init, obs, rounds=cfg.ba.pose_rounds,
                iters=cfg.ba.pose_iters_per_round,
            )
            return m, kp_idx, T_opt, inlier, n_in

        radius = cfg.tracker.search_radius
        m, kp_idx, T, inlier, n_in = run_match(radius, T_pred)
        if int(n_in) < cfg.tracker.min_matches_motion:
            m, kp_idx, T, inlier, n_in = run_match(3.0 * radius, T_last)
        return self._track_bundle(mstate, ref_slot, feats, depth, proj, mp_ids, mp_mask, m,
                                  kp_idx, T, T_last, inlier, n_in)

    def _track_bundle(self, mstate, ref_slot, feats, depth, proj, mp_ids, mp_mask, m, kp_idx,
                      T: SE3, T_last: SE3, inlier, n_in) -> TrackBundle:
        """The tracking result: keypoint -> map point links of the inliers,
        the SE3 motion, and the packed vector the host reads."""
        n_feats = self.cfg.extractor.n_features
        ok = m.ok & proj.valid & inlier
        matched_mp = steps.scatter_matches_to_kps(n_feats, kp_idx, mp_ids, ok)
        vel_new = T.compose(T_last.inverse())
        close = (depth > 0) & (depth < self.close_depth) & feats.valid
        has_mp = matched_mp >= 0
        K = mstate.kf_R.shape[0]
        ref_safe = torch.clamp(ref_slot, 0, K - 1)
        f32 = dict(dtype=torch.float32, device=self.device)
        counts = torch.stack([
            n_in.to(torch.float32),
            torch.sum(m.ok & proj.valid).to(torch.float32),
            torch.sum(mp_mask).to(torch.float32),
            torch.sum(close & has_mp).to(torch.float32),
            torch.sum(close & ~has_mp).to(torch.float32),
            mstate.mp_count[0].to(torch.float32),
            torch.zeros((), **f32),  # kf_flag
            torch.full((), -1.0, **f32),  # new slot
            mstate.kf_count[0].to(torch.float32),
        ])
        packed = torch.cat([
            T.R.reshape(-1), T.t, mstate.kf_R[ref_safe].reshape(-1),
            mstate.kf_t[ref_safe], counts,
        ]).to(torch.float32)
        return TrackBundle(T_R=T.R, T_t=T.t, vel_R=vel_new.R, vel_t=vel_new.t,
                           matched_mp=matched_mp, packed=packed)

    def _extract_pair(self, imgs_u8: torch.Tensor):
        """ORB on both images of a (2, H, W) uint8 pair, then stereo
        association: (left features, u_right, depth)."""
        cfg = self.cfg
        featsL, atlasL = self.extractor.extract(imgs_u8[0].to(torch.float32))
        featsR, atlasR = self.extractor.extract(imgs_u8[1].to(torch.float32))
        sm = stereo_ops.match_stereo(
            featsL, featsR, atlasL, atlasR, self.row_offsets, self.level_scales,
            self.cam.bf, max_disp=float(cfg.camera.bf / 0.5),
            use_mutual=cfg.matcher.stereo_mutual,
            use_median=cfg.matcher.stereo_median_sweep,
        )
        minus1 = torch.full_like(sm.u_right, -1.0)
        uright = torch.where(sm.ok, sm.u_right, minus1)
        depth = torch.where(sm.ok, sm.depth, minus1)
        return featsL, uright, depth

    def _frame(self, imgs_u8, mstate, carry, T_last, vel, frame_id: int, ts: float):
        """One frame: extract + stereo + track + the keyframe decision and
        creation (carry = (frames_since_kf, ref_kf_tracked))."""
        feats, uright, depth = self._extract_pair(imgs_u8)
        K = mstate.kf_R.shape[0]
        ref_slot = torch.clamp(mstate.kf_count[0].long() - 1, 0, K - 1)
        bundle = self._track(mstate, ref_slot, feats, uright, depth, T_last, vel)
        return self._decide_keyframe(bundle, mstate, carry, frame_id, ts, feats, uright, depth)

    def _decide_keyframe(self, bundle: TrackBundle, mstate, carry, frame_id: int, ts: float,
                         feats, uright, depth, on_create=None):
        """The device keyframe decision of a tracked frame, and the
        keyframe's creation (then `on_create(slot)`); returns (bundle with
        the decision packed, map, carry, feats, uright, depth)."""
        tr = self.cfg.tracker
        K = mstate.kf_R.shape[0]
        p = bundle.packed
        n_in = p[_PK_NIN].to(torch.int32)
        n_close = p[_PK_NCLOSE].to(torch.int32)
        n_creat = p[_PK_NCREAT].to(torch.int32)
        fs = carry[0] + 1
        ref_tracked = torch.clamp(carry[1], min=1)
        ok = n_in >= self._min_ok_static
        capacity = mstate.kf_count[0] < K - 1
        timeout = fs >= tr.max_frames_between_kf
        min_frames_ok = fs >= tr.min_frames_between_kf
        need_close = (n_close < 100) & (n_creat > 70)
        weak = n_in.to(torch.float32) < tr.kf_ref_ratio * ref_tracked.to(torch.float32)
        kf_new = ok & capacity & (timeout | (min_frames_ok & (need_close | weak)))
        slot = mstate.kf_count[0].long()
        if bool(kf_new):
            mstate = self._create_kf_body(
                mstate, slot, SE3(bundle.T_R, bundle.T_t), frame_id, ts,
                feats, uright, depth, bundle.matched_mp, self._kf_budget,
            )
            if on_create is not None:
                on_create(slot)
        carry_new = torch.where(
            kf_new, torch.stack([torch.zeros_like(n_in), n_in]),
            torch.stack([fs, carry[1]]),
        ).to(torch.int32)
        packed = p.clone()
        packed[_PK_KFFLAG] = kf_new.to(torch.float32)
        packed[_PK_KFSLOT] = torch.where(kf_new, slot, -1).to(torch.float32)
        packed[_PK_KFCOUNT] = mstate.kf_count[0].to(torch.float32)
        return bundle._replace(packed=packed), mstate, carry_new, feats, uright, depth

    def _create_kf_body(self, mstate, slot, T: SE3, frame_id, ts, feats, uright, depth,
                        matched_mp, budget: int):
        """Insert the keyframe, create up to `budget` new points from its
        closest unmatched stereo keypoints, and refresh the statistics of
        the points it matched."""
        ext = self.cfg.extractor
        mstate = map_state.insert_keyframe(
            mstate, slot, T, frame_id, ts, feats, uright, depth, matched_mp
        )
        M = mstate.mp_pos.shape[0]
        base_id = mstate.mp_count[0].clone()  # mp_count is updated in place below
        can = (
            feats.valid & (depth > 0) & (depth < 2.0 * self.close_depth)
            & (matched_mp < 0)
        )
        dvals = torch.where(can, depth, torch.full_like(depth, float("inf")))
        neg_top, sel = top_k(-dvals, budget)
        create0 = torch.isfinite(-neg_top)
        offsets = torch.cumsum(create0.to(torch.int32), 0) - 1
        create = create0 & (base_id + offsets < M - 1)
        kp_xy = feats.xy[sel]
        pc = pinhole.unproject(self.cam, kp_xy) * depth[sel][:, None]
        Twc = T.inverse()
        pw = Twc.apply(pc)
        rays = pw - Twc.t
        dist = norm3_f32(rays)
        normal = rays / torch.clamp(dist[:, None], min=1e-9)
        sf = ext.scale_factor
        max_dist = dist * torch.pow(sf, feats.level[sel].to(torch.float32))
        min_dist = max_dist / sf ** (ext.n_levels - 1)
        mstate, _ids = map_state.create_points(
            mstate, base_id, slot, sel, pw, feats.desc[sel], normal,
            min_dist, max_dist, create,
        )
        upd_ids = torch.where(matched_mp >= 0, matched_mp, torch.full_like(matched_mp, M - 1))
        return map_state.update_point_stats(mstate, upd_ids)

    def _mapping_pass(self, mstate, ref_slot: int):
        """Fuse the newest keyframe's points with its covisible neighbours,
        then triangulate its unmatched keypoints against the best
        neighbour, and add the new points with both observations."""
        cfg = self.cfg
        ext = cfg.extractor
        mstate = steps.fuse_neighbors(
            self.cam, mstate, ref_slot, float(cfg.camera.width), float(cfg.camera.height),
            n_window=cfg.ba.mapping_fuse_window, max_fuse=96, th_low=cfg.matcher.th_low,
            scale_factor=ext.scale_factor, n_levels=ext.n_levels,
        )
        if cfg.camera.bf > 0:
            K = mstate.kf_R.shape[0]
            M = mstate.mp_pos.shape[0]
            window = steps.covis_window(mstate, ref_slot, 2)
            nb = torch.clamp(window[1:2], 0, K - 1)
            cand = steps.match_and_triangulate(
                self.cam, mstate, ref_slot, nb, max_new=256, th_low=cfg.matcher.th_low,
                scale_factor=ext.scale_factor, n_levels=ext.n_levels,
            )
            base_id = mstate.mp_count[0].clone()  # create_points moves mp_count
            offsets = torch.cumsum(cand.create.to(torch.int32), 0) - 1
            create = cand.create & (base_id + offsets < M - 1) & (window[1] >= 0)
            mstate, ids = map_state.create_points(
                mstate, base_id, ref_slot, cand.kp_new, cand.pos, cand.desc, cand.normal,
                cand.min_dist, cand.max_dist, create,
            )
            mstate = map_state.register_obs(mstate, ids, nb, cand.kp_ref, create)
            mstate = map_state.update_point_stats(
                mstate, torch.where(create, ids, torch.full_like(ids, M - 1)))
        return mstate

    def _local_ba_program(self, mstate, ref_slot: int, guard_in_front: bool = False):
        """Local BA over the covisibility window of `ref_slot`. The origin
        keyframe and the oldest third of the window are fixed. Returns
        (map, delta) with delta = inv(T_ref before) @ T_ref after, the
        right-multiplicative correction of the live pose chain.
        `guard_in_front`: see `optim/local_ba.py::_ba_core` (off, as in
        the JAX package, but for the monocular pipeline)."""
        ba_cfg = self.cfg.ba
        window = steps.covis_window(mstate, ref_slot, ba_cfg.max_local_kfs)
        alive = window >= 0
        slot_key = torch.where(alive, window, torch.full_like(window, torch.iinfo(torch.int32).max))
        # padded entries share one key, so both sorts must be stable
        rank = torch.argsort(torch.argsort(slot_key, stable=True), stable=True)
        n_fix = torch.clamp(torch.sum(alive.to(torch.int32)) // 3, min=1)
        fixed = (rank < n_fix) | (window == 0)
        mp_ids, _ = steps.gather_local_points(mstate, window, ba_cfg.max_local_points)
        prob = steps.gather_ba_problem(
            self.cam, mstate, window, fixed, mp_ids, n_window=ba_cfg.max_local_kfs,
            n_points=ba_cfg.max_local_points, n_obs=self.cfg.map.max_obs_per_point,
        )
        res = local_ba._ba_core(self.cam, prob, ba_cfg.local_ba_iters, True, 1e-4,
                                guard_in_front=guard_in_front)
        r1 = map_state.dev_index(ref_slot, self.device)
        ref_pre = SE3(mstate.kf_R[r1][0], mstate.kf_t[r1][0])  # copies
        mstate = steps.scatter_ba_result(mstate, window, fixed, mp_ids, res.poses, res.points)
        ref_post = SE3(mstate.kf_R[r1][0], mstate.kf_t[r1][0])
        return mstate, ref_pre.inverse().compose(ref_post)

    def _maintenance_program(self, mstate, ref_slot: int, min_obs: int, lo: int, hi: int):
        """Young-point culling, then the culling of at most one redundant
        keyframe of slots [lo, hi). Returns (map, the cull's info (15,))."""
        mstate, _ = map_state.cull_young_points(mstate, ref_slot, min_obs)
        return map_state.cull_redundant_keyframe(mstate, lo, hi)

    # ------------------------------------------------------------------ API

    def process_stereo(self, img_left, img_right, timestamp: float) -> TrackStats:
        """Track one stereo pair. Returns the stats of the newest finalized
        frame (host decisions lag `pipeline_depth` frames)."""
        self._pre_frame(timestamp)
        imgs = self._upload_images(img_left, img_right)
        if self.state == NOT_INITIALIZED:
            self.flush()
            feats, uright, depth = self._extract_pair(imgs)
            return self._track_entry(feats, uright, depth, timestamp, None)
        self.frame_id += 1
        bundle, self.map, self.carry_dev, feats, uright, depth = self._frame(
            imgs, self.map, self.carry_dev, self.T_dev, self.vel_dev,
            self.frame_id, timestamp,
        )
        return self._enqueue(FrameJob(self.frame_id, timestamp, self.ref_kf, bundle, feats,
                                      uright, depth, fused=True))

    def _enqueue(self, job: FrameJob) -> TrackStats:
        """Queue a dispatched frame (its packed vector on its way to pinned
        host memory) and finalize the frames past the pipeline depth."""
        bundle = job.bundle
        if self.device.type == "cuda":
            job.packed_host = torch.empty((PACKED_LEN,), dtype=torch.float32, pin_memory=True)
            job.packed_host.copy_(bundle.packed, non_blocking=True)
            job.copied = torch.cuda.Event()
            job.copied.record()
        # optimistic device pose chain; finalize repairs it on failure
        self.T_dev = SE3(bundle.T_R, bundle.T_t)
        self.vel_dev = SE3(bundle.vel_R, bundle.vel_t)
        self._inflight.append(job)
        st = None
        while len(self._inflight) > self.pipeline_depth:
            st = self._finalize(self._inflight.popleft())
        return st if st is not None else TrackStats(
            n_kfs=self.n_kf, n_mps=self.n_mp, state=self.state
        )

    def process_rgbd(self, img, depth_img, timestamp: float) -> TrackStats:
        """Track one RGB-D frame (a grey image and a depth map in metres,
        both (H, W)) synchronously: one-image ORB extraction, each
        keypoint's depth looked up at its truncated pixel, and u_right =
        u - bf / z where z > 0, so that the stereo tracking applies
        unchanged; the keyframe decision runs on the host."""
        self._pre_frame(timestamp)
        feats, uright, depth = self._rgbd_features(self._upload_f32(img),
                                                   self._upload_f32(depth_img))
        bundle = None
        if self.state != NOT_INITIALIZED:
            bundle = self._track(self.map, self._slot(max(self.ref_kf, 0)), feats, uright, depth,
                                 self.T_dev, self.vel_dev)
        return self._track_entry(feats, uright, depth, timestamp, bundle)

    def _rgbd_features(self, img: torch.Tensor, depth_img: torch.Tensor):
        """(features, u_right, depth) of an RGB-D frame; -1 where a
        keypoint has no positive depth."""
        feats = self.extractor(img)
        H, W = depth_img.shape
        u = torch.clamp(feats.xy[:, 0].to(torch.int32), 0, W - 1).long()
        v = torch.clamp(feats.xy[:, 1].to(torch.int32), 0, H - 1).long()
        z = depth_img[v, u]
        ok = feats.valid & (z > 0)
        minus1 = torch.full_like(z, -1.0)
        depth = torch.where(ok, z, minus1)
        uright = torch.where(ok, feats.xy[:, 0] - self.cam.bf / torch.clamp(z, min=1e-6), minus1)
        return feats, uright, depth

    def _upload_f32(self, img) -> torch.Tensor:
        """One float32 (H, W) upload."""
        host = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    def process_oracle(self, xy, uright, depth, desc, level, timestamp: float) -> TrackStats:
        """Track one frame of given keypoints (pixels (V, 2), u_right and
        depth (V,), uint32 descriptors (V, 8), pyramid levels (V,)),
        synchronously, with the keyframe decision on the host."""
        self._pre_frame(timestamp)
        feats, ur, dp = make_oracle_features(
            self.cfg.extractor.n_features, xy, uright, depth, desc, level, device=self.device
        )
        bundle = None
        if self.state != NOT_INITIALIZED:
            bundle = self._track(self.map, self._slot(max(self.ref_kf, 0)), feats, ur, dp,
                                 self.T_dev, self.vel_dev)
        return self._track_entry(feats, ur, dp, timestamp, bundle)

    def flush(self) -> Optional[TrackStats]:
        """Finalize every frame in flight, apply the pending culls, and run
        the queued loop queries."""
        st = self._flush_frames()
        if self.loop_closer is not None:
            self._drain_loop_queue()
        return st

    def _flush_frames(self) -> Optional[TrackStats]:
        """Finalize the frames in flight and apply the pending culls,
        without the loop queue (safe inside a loop correction)."""
        st = None
        while self._inflight:
            st = self._finalize(self._inflight.popleft())
        self._apply_pending_culls()
        return st

    def _upload_images(self, img_left, img_right) -> torch.Tensor:
        """One (2, H, W) uint8 upload per stereo pair."""
        stacked = torch.from_numpy(
            np.stack([np.asarray(img_left), np.asarray(img_right)]).astype(np.uint8)
        )
        if self.device.type == "cuda":
            return stacked.pin_memory().to(self.device, non_blocking=True)
        return stacked

    def _slot(self, slot: int) -> torch.Tensor:
        return torch.tensor(slot, dtype=torch.long, device=self.device)

    # ------------------------------------------------------------- tracking

    def _track_entry(self, feats, uright, depth, timestamp, bundle) -> TrackStats:
        """Synchronous dispatch and finalize (initialization, oracle path)."""
        self.frame_id += 1
        job = FrameJob(self.frame_id, timestamp, self.ref_kf, bundle, feats, uright, depth)
        if bundle is not None:
            self.T_dev = SE3(bundle.T_R, bundle.T_t)
            self.vel_dev = SE3(bundle.vel_R, bundle.vel_t)
        return self._finalize(job)

    def _pull_packed(self, job: FrameJob) -> np.ndarray:
        if job.copied is not None:
            job.copied.synchronize()
            return job.packed_host.numpy().copy()
        return job.bundle.packed.cpu().numpy().copy()

    @staticmethod
    def _poses_from_packed(p: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        T_np = np.eye(4)
        T_np[:3, :3] = p[0:9].reshape(3, 3)
        T_np[:3, 3] = p[9:12]
        ref_pose = np.eye(4)
        ref_pose[:3, :3] = p[12:21].reshape(3, 3)
        ref_pose[:3, 3] = p[21:24]
        return T_np, ref_pose

    def _finalize(self, job: FrameJob) -> TrackStats:
        st = TrackStats(n_kfs=self.n_kf, n_mps=self.n_mp)
        if job.bundle is None:
            ok = self._initialize(job.feats, job.uright, job.depth, job.timestamp)
            st.n_kfs, st.n_mps = self.n_kf, self.n_mp
            self._record(job, self.T_np, self.ref_pose_np, self.ref_kf, OK if ok else LOST)
            st.state = self.state
            self.stats.append(st)
            return st

        self._apply_pending_culls()
        p = self._pull_packed(job)
        T_np, ref_pose = self._poses_from_packed(p)
        n_in = int(p[_PK_NIN])
        self.n_mp = int(p[_PK_MPCOUNT])
        st.n_matches = int(p[_PK_NMATCH])
        st.n_inliers = n_in
        st.n_local_points = int(p[_PK_NLOCAL])

        # a frame right after a loss or a relocalization needs > 50 inliers
        min_ok = max(self.cfg.tracker.min_matches_motion // 2, 10)
        if self.state != OK:
            min_ok = max(min_ok, 50)
        failed = n_in < min_ok
        if self.state in (OK, RECENTLY_LOST) and failed or self.state == LOST:
            return self._handle_failure(job, st, T_np)

        self.state = OK
        self.T_np = T_np
        self.ref_pose_np = ref_pose
        self._last_good = (job.bundle.T_R, job.bundle.T_t)
        if job.fused:
            kf_created = int(p[_PK_KFFLAG]) > 0
            self.n_kf = max(self.n_kf, int(p[_PK_KFCOUNT]))
            ref_used = int(p[_PK_KFCOUNT]) - (1 if kf_created else 0) - 1
            self._record(job, T_np, ref_pose, ref_used, OK)
            self.ref_kf = self.n_kf - 1
            if kf_created:
                slot = int(p[_PK_KFSLOT])
                self.ref_pose_np = T_np.copy()
                # the keyframe's own record is relative to itself
                self.records[-1] = FrameRecord(job.frame_id, job.timestamp, slot, np.eye(4), OK)
                self._on_keyframe_created(job, slot)
                self._kf_mapping(n_in)
        else:
            self.frames_since_kf += 1
            self._record(job, T_np, ref_pose, job.ref_kf, OK)
            if self._need_keyframe(n_in, int(p[_PK_NCLOSE]), int(p[_PK_NCREAT])):
                self._create_keyframe(
                    job.feats, job.uright, job.depth, job.bundle.matched_mp, job.timestamp,
                    pose_dev=SE3(job.bundle.T_R, job.bundle.T_t), frame_id=job.frame_id,
                    pose_np=T_np,
                )
                self.records[-1] = FrameRecord(job.frame_id, job.timestamp, self.ref_kf,
                                               np.eye(4), OK)
                self._on_keyframe_created(job, self.ref_kf)
                self._kf_mapping(n_in)
                self.frames_since_kf = 0
        st.n_kfs, st.n_mps, st.state = self.n_kf, self.n_mp, OK
        self.stats.append(st)
        return st

    def _handle_failure(self, job: FrameJob, st: TrackStats, T_np: np.ndarray) -> TrackStats:
        """Failed-frame ladder: relocalize (refined against the local map
        from the fix), else degrade OK -> RECENTLY_LOST -> LOST; a map
        lost past the atlas window is parked at the next frame. (T_np,
        the frame's tracked pose, serves the inertial pipeline.)"""
        n_rel = self._try_relocalize(job.feats, job.uright)
        if n_rel > 0:
            bundle = self._track(self.map, self._slot(max(self.ref_kf, 0)), job.feats,
                                 job.uright, job.depth, self.T_dev,
                                 SE3.identity(device=self.device))
            p = bundle.packed.cpu().numpy()
            n_ref = int(p[_PK_NIN])
            if n_ref >= n_rel:
                n_rel = n_ref
                self.T_dev = SE3(bundle.T_R, bundle.T_t)
                self.vel_dev = SE3.identity(device=self.device)
                self._last_good = (bundle.T_R, bundle.T_t)
                self.T_np, self.ref_pose_np = self._poses_from_packed(p)
            self.state = OK
            self.n_relocalized += 1
            st.n_inliers = n_rel
            self._record(job, self.T_np, self.ref_pose_np, self.ref_kf, OK)
            st.n_kfs, st.n_mps, st.state = self.n_kf, self.n_mp, OK
            self.stats.append(st)
            return st
        if self.state == OK:
            self.state = RECENTLY_LOST
            self._lost_since = job.timestamp
            # freeze the device pose chain at the last good pose
            self.T_dev = SE3(*self._last_good)
            self.vel_dev = SE3.identity(device=self.device)
        elif self.state == RECENTLY_LOST and (
            job.timestamp - self._lost_since > self.cfg.tracker.recently_lost_sec
        ):
            self.state = LOST
            # a young lost map is reset at the next frame
            if self.n_kf < 10 and not self._atlas_ready():
                self._reset_pending = True
        elif self.state == LOST and self._atlas_ready() and (
            job.timestamp - self._lost_since
            > self.cfg.tracker.recently_lost_sec + self.cfg.tracker.atlas_lost_sec
        ):
            self._fork_pending = True
        self._record(job, self.T_np, self.ref_pose_np, self.ref_kf, self.state)
        st.n_kfs, st.n_mps, st.state = self.n_kf, self.n_mp, self.state
        self.stats.append(st)
        return st

    def _try_relocalize(self, feats: Features, uright: torch.Tensor) -> int:
        """One relocalization attempt against the keyframe database;
        returns its inlier count (0 = no fix)."""
        if self.relocalizer is None or self.loop_closer is None or self.n_kf < 1:
            return 0
        with self.timer.span("reloc"):
            vocab = self.loop_closer.vocab
            words, _ = voc.transform(vocab, feats.desc)
            bow = voc.bow_vectors(words[None], feats.valid[None], vocab.idf, vocab.n_words)[0]
            pose, n_in = self.relocalizer.try_relocalize(self.map, self.loop_closer.db, bow,
                                                         feats, uright)
        if pose is None:
            return 0
        self.T_dev = pose
        self.vel_dev = SE3.identity(device=self.device)
        self._last_good = (pose.R, pose.t)
        T_np = np.eye(4)
        T_np[:3, :3] = pose.R.cpu().numpy()
        T_np[:3, 3] = pose.t.cpu().numpy()
        self.T_np = T_np
        return n_in

    def _on_keyframe_created(self, job: FrameJob, slot: int):
        """Subclass hook, called right after a keyframe is inserted (the
        inertial pipeline closes its preintegration segment here)."""

    def _kf_mapping(self, n_in: int):
        """Keyframe-rate duties on the reference's cadences: the mapping
        pass every `mapping_every`-th keyframe (from 3 keyframes on), local
        BA every `local_ba_every`-th, maintenance every
        `maintenance_every`-th counted from 4 keyframes on; then the loop
        closer's step."""
        tr = self.cfg.tracker
        self._map_tick += 1
        if self.n_kf >= 3 and self._map_tick % tr.mapping_every == 0:
            with self.timer.span("mapping"):
                self.map = self._mapping_pass(self.map, self.ref_kf)
        self._ba_tick += 1
        if self._ba_tick % tr.local_ba_every == 0:
            self._local_ba()
        self._culling()
        if self.loop_closer is not None:
            self._loop_closing()
            if self.atlas_stored and self.n_kf >= 3:
                self._try_merge_maps()
        self._ref_kf_tracked = n_in

    def _local_ba(self):
        """Local BA, then the correction of the live (newest dispatched)
        pose, composed on the device."""
        if self.n_kf < 3:
            return
        with self.timer.span("local_ba"):
            self.map, delta = self._local_ba_program(self.map, self.ref_kf)
            self.T_dev = self.T_dev.compose(delta)
            self._last_good = (self.T_dev.R, self.T_dev.t)

    def _culling(self):
        """Map maintenance. A stereo map's young point needs 3
        observations; the keyframe slot range [1, n_kf - 3) is empty below
        8 keyframes. The cull's info comes back with a later pull."""
        if self.n_kf < 4:
            return
        self._maint_tick += 1
        if self._maint_tick % self.cfg.tracker.maintenance_every:
            return
        with self.timer.span("maintenance"):
            min_obs = 3 if self.cfg.camera.bf > 0 else 2
            lo = 1
            hi = max(self.n_kf - 3, lo) if self.n_kf >= 8 else lo
            self.map, info = self._maintenance_program(self.map, self.ref_kf, min_obs, lo, hi)
            self._pending_culls.append(self._to_host_async(info))

    def _to_host_async(self, t: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """A copy of `t` on its way to the host: (copy, event set when it
        has landed) on the card, (a snapshot, None) on the CPU."""
        if self.device.type != "cuda":
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _landed(pending: Tuple[torch.Tensor, Optional[torch.cuda.Event]]) -> np.ndarray:
        host, done = pending
        if done is not None:
            done.synchronize()
        return host.numpy()

    def _apply_pending_culls(self):
        for pending in self._pending_culls:
            self._apply_cull_info(self._landed(pending))
        self._pending_culls = []

    def _apply_cull_info(self, info: np.ndarray):
        if float(info[0]) < 0.5:
            return
        T_rel = np.eye(4)
        T_rel[:3, :3] = np.asarray(info[3:12], np.float64).reshape(3, 3)
        T_rel[:3, 3] = np.asarray(info[12:15], np.float64)
        slot = int(info[1])
        self.culled_parent[slot] = (int(info[2]), T_rel)
        if self.loop_closer is not None:
            self.loop_closer.remove_keyframe(slot)

    # --------------------------------------------------------- loop closing

    def _loop_closing(self):
        """The newest keyframe's BoW vector enters the database now; its
        map-point row starts for the host, and its loop query runs at the
        next keyframe (one keyframe of lag)."""
        slot = self.ref_kf
        self.loop_closer.add_bow(self.map, slot)
        self._covis_queue.append((slot, self._to_host_async(self.map.kf_mp[slot])))
        if len(self._covis_queue) > 1:
            self._drain_loop_queue(limit=len(self._covis_queue) - 1)

    def _drain_loop_queue(self, limit: Optional[int] = None):
        if self._loop_busy:
            return  # re-entered from the drain before a correction
        lc = self.loop_closer
        self._loop_busy = True
        try:
            n = 0
            while self._covis_queue and (limit is None or n < limit):
                slot, pending = self._covis_queue.popleft()
                n += 1
                if slot in self.culled_parent:  # culled while queued
                    continue
                lc.register_covis(slot, self._landed(pending))

                def _refresh():
                    # frames dispatched against the pre-correction poses
                    # are finalized first
                    self._flush_frames()
                    return self.map

                self.map, closed = lc.process(self.map, slot, self.n_kf, refresh_cb=_refresh)
                if closed:
                    self._after_loop_correction()
        finally:
            self._loop_busy = False

    def _after_loop_correction(self):
        """Re-anchor the live pose on the corrected reference keyframe
        (keeping the current frame's pose relative to it) and drop the
        motion model."""
        ref = max(self.ref_kf, 0)
        T_ref = np.eye(4)
        T_ref[:3, :3] = self.map.kf_R[ref].cpu().numpy()
        T_ref[:3, 3] = self.map.kf_t[ref].cpu().numpy()
        self.T_np = self.T_np @ np.linalg.inv(self.ref_pose_np) @ T_ref
        self.ref_pose_np = T_ref.copy()
        f32 = dict(dtype=self.map.kf_R.dtype, device=self.device)
        self.T_dev = SE3(torch.tensor(self.T_np[:3, :3], **f32), torch.tensor(self.T_np[:3, 3], **f32))
        self._last_good = (self.T_dev.R, self.T_dev.t)
        self.vel_dev = SE3.identity(device=self.device)

    # ------------------------------------------------------------- helpers

    def _initialize(self, feats, uright, depth, timestamp) -> bool:
        """Stereo initialization: the first frame with >= 100 stereo
        keypoints becomes keyframe 0 at the origin."""
        n_good = int(torch.sum(feats.valid & (depth > 0)))
        if n_good < 100:
            return False
        self.T_dev = SE3.identity(device=self.device)
        self.vel_dev = SE3.identity(device=self.device)
        self.T_np = np.eye(4)
        self._create_keyframe(
            feats, uright, depth,
            torch.full((feats.xy.shape[0],), -1, dtype=torch.int32, device=self.device),
            timestamp,
        )
        self.n_mp = int(self.map.mp_count[0])
        self.state = OK
        self._last_good = (self.T_dev.R, self.T_dev.t)
        self._ref_kf_tracked = n_good
        self.carry_dev = torch.tensor([0, n_good], dtype=torch.int32, device=self.device)
        return True

    def _need_keyframe(self, n_in: int, n_tracked_close: int, n_creatable: int) -> bool:
        """The host keyframe decision of the oracle path (the image path
        decides on the device with the same rule)."""
        tr = self.cfg.tracker
        if self.n_kf >= self.map.kf_R.shape[0] - 1:
            return False
        if self.frames_since_kf >= tr.max_frames_between_kf:
            return True
        if self.frames_since_kf < tr.min_frames_between_kf:
            return False
        need_close = n_tracked_close < 100 and n_creatable > 70
        weak = n_in < tr.kf_ref_ratio * max(self._ref_kf_tracked, 1)
        return bool(need_close or weak)

    def _create_keyframe(self, feats, uright, depth, matched_mp, timestamp, pose_dev=None,
                         frame_id=None, pose_np=None):
        """Host-decided keyframe creation (initialization, oracle path)."""
        slot = self.n_kf
        self.n_kf += 1
        budget = min(1024 if slot == 0 else self.cfg.tracker.kf_point_budget,
                     self.cfg.extractor.n_features)
        self.map = self._create_kf_body(
            self.map, slot, pose_dev if pose_dev is not None else self.T_dev,
            frame_id if frame_id is not None else self.frame_id, timestamp,
            feats, uright, depth, matched_mp, budget,
        )
        self.ref_kf = slot
        self.ref_pose_np = (pose_np if pose_np is not None else self.T_np).copy()

    def _pre_frame(self, timestamp: float):
        """Timestamp sanity (a backwards or too-large jump forks a new map
        when the atlas is ready, else resets the system), a pending reset
        of a young lost map, and a pending fork."""
        if self._last_frame_ts is not None and self.state != NOT_INITIALIZED:
            dt = timestamp - self._last_frame_ts
            if dt < 0 or dt > self.cfg.tracker.max_timestamp_jump_sec:
                if self._atlas_ready():
                    self._fork_pending = True
                else:
                    self.reset()
        self._last_frame_ts = timestamp
        if self._reset_pending:
            self._reset_pending = False
            self.reset()
        if self._fork_pending:
            self.flush()
            if self._fork_pending:
                self._create_map_in_atlas()

    def _atlas_ready(self) -> bool:
        return (self.cfg.tracker.atlas_enabled and self.loop_closer is not None
                and self.n_kf >= 5)

    def reset(self):
        """Drop every map and the records and return to NOT_INITIALIZED
        (the keyframe-rate cadence counters run on, as in the reference)."""
        self.flush()
        self._new_active_map()
        self.records = []
        self.stats = []
        self.atlas_stored = []
        self.active_map_id = 0
        self._next_map_id = 0
        self._fork_pending = False
        self.frame_id = -1
        self._last_frame_ts = None

    def _record(self, job: FrameJob, T_np, ref_pose_np, ref_kf, state):
        if ref_kf >= 0:
            T_rel = T_np @ np.linalg.inv(ref_pose_np)
        else:
            T_rel = T_np.copy()
        self.records.append(FrameRecord(job.frame_id, job.timestamp, ref_kf, T_rel, state,
                                        self.active_map_id))

    # ----------------------------------------------------------------- atlas

    def _new_active_map(self):
        """A fresh map and tracking state, and a fresh database and graph
        in the loop closer (the fork and the bad-IMU reset)."""
        m = self.cfg.map
        self.map = map_state.allocate(
            m.max_keyframes, self.cfg.extractor.n_features, m.max_points, m.max_obs_per_point,
            device=self.device,
        )
        self.n_kf = 0
        self.n_mp = 0
        self.ref_kf = -1
        self.culled_parent = {}
        self.state = NOT_INITIALIZED
        self.frames_since_kf = 0
        self._ref_kf_tracked = 0
        self.T_dev = SE3.identity(device=self.device)
        self.vel_dev = SE3.identity(device=self.device)
        self.T_np = np.eye(4)
        self.ref_pose_np = np.eye(4)
        self._last_good = (self.T_dev.R, self.T_dev.t)
        self.carry_dev = torch.zeros((2,), dtype=torch.int32, device=self.device)
        if self.loop_closer is not None:
            self.loop_closer.reset_for_new_map()

    def _create_map_in_atlas(self):
        """Park the active map with its database, covisibility graph, loop
        edges and culled keyframes, and start tracking into a new map."""
        with self.timer.span("fork"):
            self._fork_pending = False
            lc = self.loop_closer
            self.atlas_stored.append(atlas_mod.StoredMap(
                map=self.map, n_kf=self.n_kf, n_mp=self.n_mp, map_id=self.active_map_id,
                db=lc.db if lc else None, covis=lc.covis if lc else None,
                loop_edges=list(lc.loop_edges) if lc else [],
                culled_parent=dict(self.culled_parent),
            ))
            self._new_active_map()
            self._next_map_id += 1
            self.active_map_id = self._next_map_id

    def _try_merge_maps(self) -> bool:
        """Query each parked map's database with the newest keyframe; weld
        on the first candidate that a Sim3 RANSAC verifies (of the best 3
        of each map). Spans "merge_detect": each query and verification."""
        if self._merge_guard:
            return False
        lc = self.loop_closer
        cur = self.ref_kf
        self._merge_guard = True
        try:
            with self.timer.span("merge_detect"):
                bow = _kf_bow(self.map, cur, lc.vocab)
            for si, sm in enumerate(self.atlas_stored):
                if sm.db is None:
                    continue
                with self.timer.span("merge_detect"):
                    cands = sm.db.detect_reloc_candidates(sm.map, bow)
                for cand in cands.tolist()[:3]:
                    with self.timer.span("merge_detect"):
                        ok, S_cl, pairs = atlas_mod.verify_merge(
                            self.cam, self.map, cur, sm.map, int(cand), self.merge_draw,
                            min_inliers=20, th=self.cfg.matcher.th_low, fix_scale=True)
                    if ok and self._do_merge(si, cur, int(cand), S_cl, pairs):
                        return True
        finally:
            self._merge_guard = False
        return False

    def _do_merge(self, si: int, cur: int, cand: int, S_cl, pairs) -> bool:
        """Weld the active map into parked map `si`: the frames in flight
        are drained first, then the active map is appended with the Sim3
        weld, its seam duplicates give way to the parked map's points,
        whole-map BA runs, and the records, culls, database and graph move
        to the merged map's slots."""
        sm = self.atlas_stored[si]
        K = self.map.kf_R.shape[0]
        M = self.map.mp_pos.shape[0]
        # the drain can insert keyframes and points: check the capacity after it
        self.flush()
        if sm.n_kf + self.n_kf > K - 1 or sm.n_mp + self.n_mp > M - 2:
            return False
        with self.timer.span("merge"):
            kf_off, mp_off = sm.n_kf, sm.n_mp
            T_cur = SE3(self.map.kf_R[cur], self.map.kf_t[cur])
            T_cand = SE3(sm.map.kf_R[cand], sm.map.kf_t[cand])
            S = atlas_mod.weld_transform(S_cl, T_cur, T_cand)
            self._last_weld_S = S  # the inertial merge rotates its chain by it
            merged = atlas_mod.merge_into(sm.map, self.map, S, kf_off, mp_off)
            # seam fusion: the active side's duplicates give way; the pairs
            # were verified before the drain, so both sides are checked again
            mp_cur, mp_old, fvalid = pairs
            src = torch.where(mp_cur >= 0, mp_cur + mp_off, torch.full_like(mp_cur, -1))
            Mm = merged.mp_valid.shape[0]
            fvalid = (fvalid & merged.mp_valid[torch.clamp(src, 0, Mm - 1).long()]
                      & merged.mp_valid[torch.clamp(mp_old, 0, Mm - 1).long()])
            merged = map_state.fuse_points(merged, src, mp_old, fvalid)
            prob = steps.gather_global_ba_problem(self.cam, merged)
            gres = local_ba.bundle_adjust(self.cam, prob, iters=self.cfg.ba.gba_iters,
                                          assembly="scatter")
            merged = steps.scatter_global_ba_result(merged, gres.poses, gres.points)

            old_id = self.active_map_id
            for i, rec in enumerate(self.records):
                if rec.map_id == old_id:
                    self.records[i] = FrameRecord(
                        rec.frame_id, rec.timestamp,
                        rec.ref_kf + kf_off if rec.ref_kf >= 0 else rec.ref_kf,
                        rec.T_rel, rec.state, sm.map_id)
            culled = dict(sm.culled_parent)
            for k, (p, T) in self.culled_parent.items():
                culled[k + kf_off] = (p + kf_off, T)
            self.culled_parent = culled
            self.map = merged
            self.n_kf = kf_off + self.n_kf
            self.n_mp = mp_off + self.n_mp
            self.ref_kf = self.ref_kf + kf_off
            self.active_map_id = sm.map_id
            self.atlas_stored.pop(si)

            # the loop closer adopts the parked map's database and graph and
            # registers the appended keyframes under their new slots
            lc = self.loop_closer
            if lc is not None:
                shifted = [(a + kf_off, b + kf_off) for a, b in lc.loop_edges]
                lc.db = sm.db
                lc.covis = sm.covis
                lc.loop_edges = sm.loop_edges + shifted
                lc.last_closed_kf = -(10 ** 9)
                kf_valid = merged.kf_valid.cpu().numpy()
                for s_ in range(kf_off, self.n_kf):
                    if kf_valid[s_]:
                        lc.add_bow(merged, s_)
                        lc.register_covis(s_, merged.kf_mp[s_].cpu().numpy())
            self._after_loop_correction()
            self.merge_count += 1
        return True

    def _freeze_active_records(self):
        """Resolve every record of the active map to its absolute pose
        (ref_kf = -1), before the active map is discarded."""
        kf_R = self.map.kf_R.cpu().numpy()
        kf_t = self.map.kf_t.cpu().numpy()
        for i, rec in enumerate(self.records):
            if rec.map_id != self.active_map_id or rec.ref_kf < 0:
                continue
            Tcw = rec.T_rel @ self._ref_pose_through_culls(rec.ref_kf, kf_R, kf_t,
                                                             self.culled_parent)
            self.records[i] = FrameRecord(rec.frame_id, rec.timestamp, -1, Tcw, rec.state,
                                          rec.map_id)

    @staticmethod
    def _ref_pose_through_culls(ref: int, kf_R, kf_t, culled) -> np.ndarray:
        """T_chain @ Tcw of the first live keyframe up the culled chain
        from `ref`."""
        T_chain = np.eye(4)
        while ref in culled:
            ref, T_rel = culled[ref]
            T_chain = T_chain @ T_rel
        T_ref = np.eye(4)
        T_ref[:3, :3] = kf_R[ref]
        T_ref[:3, 3] = kf_t[ref]
        return T_chain @ T_ref

    # ------------------------------------------------------------- outputs

    def trajectory_wc(self) -> np.ndarray:
        """(N, 4, 4) Twc of every processed frame, through its reference
        keyframe's current pose in the frame's own map (the active map or
        a parked one); a culled reference keyframe is replaced by its
        parent, through the relative pose kept at the cull."""
        self.flush()
        tables = {self.active_map_id: (self.map, self.culled_parent)}
        for sm in self.atlas_stored:
            tables[sm.map_id] = (sm.map, sm.culled_parent)
        tables = {k: (m.kf_R.cpu().numpy(), m.kf_t.cpu().numpy(), c)
                  for k, (m, c) in tables.items()}
        out = []
        for rec in self.records:
            if rec.ref_kf >= 0:
                kf_R, kf_t, culled = tables.get(rec.map_id, tables[self.active_map_id])
                Tcw = rec.T_rel @ self._ref_pose_through_culls(rec.ref_kf, kf_R, kf_t, culled)
            else:
                Tcw = rec.T_rel
            out.append(np.linalg.inv(Tcw))
        return np.stack(out) if out else np.zeros((0, 4, 4))


def make_stereo_vo(cfg: SystemConfig, vocab: Optional[voc.Vocabulary] = None,
                   device="cuda") -> StereoVO:
    """Entry point of the tracking loop: `pipeline/klt_vo.py::make_stereo_vo`,
    which picks the frontend by `cfg.tracker.frontend`."""
    from vi_slam_tpu_torch.pipeline import klt_vo

    return klt_vo.make_stereo_vo(cfg, vocab=vocab, device=device)
