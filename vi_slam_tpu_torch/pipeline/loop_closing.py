"""Loop detection and correction over the array map — a PyTorch copy of the
JAX package's `pipeline/loop_closing.py`.

Per keyframe: the BoW database query (`retrieval/database.py`), a
covisibility-consistency gate over consecutive queries, then geometric
verification of up to 3 candidates (mutual-best descriptor matching of
the two keyframes' map points, Sim3 RANSAC, Sim3 Gauss-Newton). A
verified loop is corrected by propagating the corrected Sim3 through the
query keyframe's covisible window (poses and the points they anchor),
fusing the seam duplicates, optimizing the essential graph (spanning
tree, strong covisibility and loop edges) and a whole-map bundle
adjustment.

The covisibility graph is the host-side `slam_map/covis.py`, fed with
each keyframe's map-point row. The consistency gate mirrors the
reference as it is: a group's count carries from the previous query's
groups, `reset_for_new_map` keeps them, and a candidate is verified once
its count reaches `consistency_th` (ROADMAP H5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.lie.sim3 import Sim3
from vi_slam_tpu_torch.loop.sim3_solver import sim3_ransac
from vi_slam_tpu_torch.ops.fast import top_k
from vi_slam_tpu_torch.ops.hamming import hamming_matrix
from vi_slam_tpu_torch.ops.orb import unpack_bits
from vi_slam_tpu_torch.optim.local_ba import bundle_adjust
from vi_slam_tpu_torch.optim.pose_graph import optimize_pose_graph
from vi_slam_tpu_torch.optim.sim3_opt import optimize_sim3
from vi_slam_tpu_torch.pipeline import steps
from vi_slam_tpu_torch.pipeline.relocalization import mutual_best_matches
from vi_slam_tpu_torch.retrieval import database as kfdb
from vi_slam_tpu_torch.retrieval import vocabulary as voc
from vi_slam_tpu_torch.slam_map.covis import CovisGraph
from vi_slam_tpu_torch.slam_map.state import MapState, fuse_points
from vi_slam_tpu_torch.utils.config import SystemConfig
from vi_slam_tpu_torch.utils.sampling import DrawFn, Sampler
from vi_slam_tpu_torch.utils.timing import ProgramTimer

# the loop programs the timer counts
LOOP_PROGRAMS = ("bow_add", "detect", "verify", "correct", "gba")


def _match_kf_pair(state: MapState, kf_a: int, kf_b: int, max_pairs: int, th: int = 50,
                   ratio: float = 0.75):
    """Mutual-best Hamming matches between the map-point keypoints of two
    keyframes, the best `max_pairs` by distance: (kp_a, kp_b, mp_a, mp_b,
    valid), each (max_pairs,)."""
    mp_a = state.kf_mp[kf_a]
    mp_b = state.kf_mp[kf_b]
    ok_a = state.kf_kp_valid[kf_a] & (mp_a >= 0)
    ok_b = state.kf_kp_valid[kf_b] & (mp_b >= 0)
    j_best, d_best, good = mutual_best_matches(
        hamming_matrix(state.kf_desc[kf_a], state.kf_desc[kf_b]), ok_a, ok_b, th, ratio)
    _, sel = top_k(torch.where(good, -d_best, torch.full_like(d_best, -1e9)), max_pairs)
    kp_b = j_best[sel]
    return sel, kp_b, mp_a[sel], mp_b[kp_b], good[sel]


def _pair_geometry(state: MapState, kf_a: int, kf_b: int, kp_a, kp_b, mp_a, mp_b, valid):
    """Camera-frame coordinates, pixels and pyramid variances of matched
    map-point pairs (the Sim3 solver's inputs), and their validity."""
    M = state.mp_pos.shape[0]
    ia = torch.clamp(mp_a, 0, M - 1).long()
    ib = torch.clamp(mp_b, 0, M - 1).long()
    x1 = SE3(state.kf_R[kf_a], state.kf_t[kf_a]).apply(state.mp_pos[ia])
    x2 = SE3(state.kf_R[kf_b], state.kf_t[kf_b]).apply(state.mp_pos[ib])
    uv1 = state.kf_xy[kf_a, kp_a]
    uv2 = state.kf_xy[kf_b, kp_b]
    s1 = torch.pow(1.2, 2.0 * state.kf_level[kf_a, kp_a].to(torch.float32))
    s2 = torch.pow(1.2, 2.0 * state.kf_level[kf_b, kp_b].to(torch.float32))
    valid = valid & (mp_a >= 0) & (mp_b >= 0) & state.mp_valid[ia] & state.mp_valid[ib]
    return x1, x2, uv1, uv2, s1, s2, valid


def _apply_correction(state: MapState, S_old: Sim3, S_new: Sim3, updated: torch.Tensor) -> MapState:
    """Rewrite keyframe poses and map points from per-keyframe (old, new)
    Sim3s: an updated keyframe's pose becomes SE3(R_new, t_new / s_new);
    a live point anchored at an updated keyframe r moves to
    S_new_r^-1(S_old_r(x))."""
    K = state.kf_R.shape[0]
    kf_R = torch.where(updated[:, None, None], S_new.R, state.kf_R)
    kf_t = torch.where(updated[:, None], S_new.t / torch.clamp(S_new.s, min=1e-12)[:, None],
                       state.kf_t)
    ref = torch.clamp(state.mp_ref_kf, 0, K - 1).long()
    x_new = S_new.index(ref).inverse().apply(S_old.index(ref).apply(state.mp_pos))
    move = updated[ref] & state.mp_valid & (state.mp_ref_kf >= 0)
    mp_pos = torch.where(move[:, None], x_new, state.mp_pos)
    return state._replace(kf_R=kf_R, kf_t=kf_t, mp_pos=mp_pos)


def _kf_bow(state: MapState, slot: int, vocab: voc.Vocabulary) -> torch.Tensor:
    words, _ = voc.transform_bits(unpack_bits(state.kf_desc[slot]), vocab.node_bits, vocab.k,
                                  vocab.levels, max(vocab.levels - 3, 0))
    return voc.bow_vectors(words[None], state.kf_kp_valid[slot][None], vocab.idf,
                           vocab.n_words)[0]


@dataclass
class LoopCloserStats:
    n_queries: int = 0
    n_candidates: int = 0
    n_verified: int = 0
    n_loops_closed: int = 0


class LoopCloser:
    """Per-keyframe loop detection and correction. Sim3 RANSAC samples come
    from `self.draw` (by default a generator seeded 7, the reference's
    key)."""

    def __init__(self, cfg: SystemConfig, cam: CameraParams, vocab: voc.Vocabulary,
                 fix_scale: bool = True, min_inliers: int = 20, max_pairs: int = 256,
                 min_gap_kfs: int = 10, run_gba: bool = True):
        self.cfg = cfg
        self.cam = cam
        self.device = cam.fx.device
        self.vocab = vocab.to(self.device)
        self.fix_scale = fix_scale
        self.min_inliers = min_inliers
        self.max_pairs = max_pairs
        self.min_gap_kfs = min_gap_kfs
        self.run_gba = run_gba
        self.stats = LoopCloserStats()
        self.timer = ProgramTimer(self.device, LOOP_PROGRAMS)
        self.draw: DrawFn = Sampler(7, self.device)
        # consecutive-query covisibility consistency required before a
        # candidate is verified (mnCovisibilityConsistencyTh)
        self.consistency_th = 3
        self._consistent_groups: list = []
        # an inertial pipeline sets these once its IMU is initialized: a
        # correction then runs the 4-DoF graph about the gravity axis, and
        # leaves the pre-correction poses for the owner to rotate its
        # keyframe velocities
        self.gravity_aligned = False
        self.gravity_w: Optional[torch.Tensor] = None
        self._last_old_poses: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.reset_for_new_map()

    def reset_for_new_map(self) -> None:
        """A fresh place-recognition database and covisibility graph (the
        consistency groups stay, as in the reference)."""
        self.db = kfdb.KeyFrameDatabase(self.cfg.map.max_keyframes, self.vocab.n_words, n_cand=16,
                                        device=self.device)
        self.covis = CovisGraph(self.cfg.map.max_keyframes)
        self.loop_edges: List[Tuple[int, int]] = []
        self.last_closed_kf = -(10 ** 9)

    def add_bow(self, state: MapState, slot: int) -> None:
        """Register a keyframe's BoW vector in the database."""
        with self.timer.span("bow_add"):
            self.db.add(slot, _kf_bow(state, slot, self.vocab))

    def register_covis(self, slot: int, mp_row: np.ndarray) -> None:
        """Feed a keyframe's map-point row into the covisibility graph."""
        self.covis.add_keyframe(slot, np.asarray(mp_row, np.int64))

    def add_keyframe(self, state: MapState, slot: int, mp_row: Optional[np.ndarray] = None) -> None:
        """BoW and covisibility registration in one call."""
        self.add_bow(state, slot)
        if mp_row is None:
            mp_row = state.kf_mp[slot].cpu().numpy()
        self.register_covis(slot, mp_row)

    def remove_keyframe(self, slot: int) -> None:
        """A culled keyframe leaves the database and the graph."""
        self.db.remove(slot)
        self.covis.remove_keyframe(slot)

    def process(self, state: MapState, cur: int, n_kf: int, refresh_cb=None
                ) -> Tuple[MapState, bool]:
        """Detect and, when verified, close a loop for keyframe `cur`.
        Returns (the possibly corrected map, closed?). refresh_cb, called
        after a verification and before the correction, drains the owner's
        frames in flight and returns the fresh map."""
        self.stats.n_queries += 1
        if cur - self.last_closed_kf < self.min_gap_kfs:
            return state, False
        K = state.kf_R.shape[0]
        with self.timer.span("detect"):
            n_ids, n_w = self.covis.best_neighbors(cur, K)
            exclude = np.zeros((K,), bool)
            exclude[n_ids] = True
            exclude[max(0, cur - self.min_gap_kfs):cur + 1] = True
            strong_mask = np.zeros((self.db.db.valid.shape[0],), bool)
            strong_mask[n_ids[n_w >= self.cfg.map.covis_weight_min]] = True
            cands = self.db.detect_loop_candidates_fused(
                state, self.db.db.bow[cur], torch.from_numpy(exclude).to(self.device),
                torch.from_numpy(strong_mask).to(self.device))
        cands = [c for c in cands.tolist() if not exclude[c]]
        self.stats.n_candidates += len(cands)
        if not cands:
            self._consistent_groups = []
            return state, False

        prev = self._consistent_groups
        new_groups, consistent = [], []
        for cand in cands[:8]:
            g_ids, g_w = self.covis.best_neighbors(cand, 16)
            grp = set(int(i) for i in g_ids[g_w > 0]) | {int(cand)}
            cnt = 1
            for pgrp, pcnt in prev:
                if grp & pgrp:
                    cnt = max(cnt, pcnt + 1)
            new_groups.append((grp, cnt))
            if cnt >= self.consistency_th:
                consistent.append(cand)
        self._consistent_groups = new_groups
        if not consistent:
            return state, False

        for cand in consistent[:3]:
            with self.timer.span("verify"):
                ok, S_cl, fused = self._verify(state, cur, cand)
            if not ok:
                continue
            self.stats.n_verified += 1
            if refresh_cb is not None:
                fresh = refresh_cb()
                if fresh is not None:
                    state = fresh
                    # the drain may have fused or culled points
                    mp_a, mp_b, fvalid = fused
                    M = state.mp_valid.shape[0]
                    fvalid = (fvalid & state.mp_valid[torch.clamp(mp_a, 0, M - 1).long()]
                              & state.mp_valid[torch.clamp(mp_b, 0, M - 1).long()])
                    fused = (mp_a, mp_b, fvalid)
            state = self._correct(state, cur, cand, S_cl, fused)
            self.loop_edges.append((cur, cand))
            self.last_closed_kf = cur
            self.stats.n_loops_closed += 1
            return state, True
        return state, False

    def _verify(self, state: MapState, cur: int, cand: int):
        """Sim3 RANSAC + Sim3 GN on the matched map points:
        (ok, S_cl, (mp_a, mp_b, fuse mask))."""
        kp_a, kp_b, mp_a, mp_b, valid = _match_kf_pair(state, cur, cand, self.max_pairs,
                                                       th=self.cfg.matcher.th_low)
        x1, x2, uv1, uv2, s1, s2, valid = _pair_geometry(state, cur, cand, kp_a, kp_b, mp_a,
                                                         mp_b, valid)
        if int(torch.sum(valid)) < self.min_inliers:
            return False, None, None
        res = sim3_ransac(self.cam, self.cam, x1, x2, uv1, uv2, valid, s1, s2, self.draw,
                          n_hyp=256, fix_scale=self.fix_scale)
        if int(res.n_inliers) < self.min_inliers:
            return False, None, None
        opt = optimize_sim3(self.cam, self.cam, res.S12, x1, x2, uv1, uv2, valid & res.inliers,
                            s1, s2, fix_scale=self.fix_scale)
        if int(opt.n_inliers) < self.min_inliers:
            return False, None, None
        return True, opt.S12, (mp_a, mp_b, valid & opt.inliers)

    def _correct(self, state: MapState, cur: int, cand: int, S_cl: Sim3, fused) -> MapState:
        """Propagate the corrected Sim3 through cur's covisible window, move
        its points, fuse the seam duplicates, optimize the essential graph,
        then run whole-map BA."""
        with self.timer.span("correct"):
            state = self._correct_graph(state, cur, cand, S_cl, fused)
        if self.run_gba:
            with self.timer.span("gba"):
                prob = steps.gather_global_ba_problem(self.cam, state)
                gres = bundle_adjust(self.cam, prob, iters=self.cfg.ba.gba_iters,
                                     assembly="scatter")
                state = steps.scatter_global_ba_result(state, gres.poses, gres.points)
        return state

    def _correct_graph(self, state: MapState, cur: int, cand: int, S_cl: Sim3, fused) -> MapState:
        K = state.kf_R.shape[0]
        dt = state.kf_t.dtype
        dev = self.device
        kf_valid = state.kf_valid.cpu().numpy()
        one = torch.ones((), dtype=dt, device=dev)
        S_cw_new = S_cl.compose(Sim3(state.kf_R[cand], state.kf_t[cand], one))
        S_cw_old = Sim3(state.kf_R[cur].clone(), state.kf_t[cur].clone(), one)

        n_ids, n_w = self.covis.best_neighbors(cur, K)
        window = np.zeros((K,), bool)
        window[n_ids[n_w >= self.cfg.map.covis_weight_min]] = True
        window[cur] = True
        window &= kf_valid

        S_old_all = Sim3(state.kf_R.clone(), state.kf_t.clone(), torch.ones((K,), dtype=dt, device=dev))
        self._last_old_poses = (S_old_all.R, S_old_all.t)
        S_new_all = S_old_all.compose(S_cw_old.inverse()).compose(S_cw_new)
        state = _apply_correction(state, S_old_all, S_new_all, torch.from_numpy(window).to(dev))

        # seam duplicates: the current side's point gives way to the loop side's
        mp_a, mp_b, fvalid = fused
        state = fuse_points(state, mp_a, mp_b, fvalid)

        # essential graph over the live keyframes; structural measurements
        # from the pre-correction poses, the loop edge carries S_cl
        max_edges = 4096
        pairs = set()
        for a, b in self.covis.essential_edges(self.cfg.map.essential_weight_min,
                                               max_edges).tolist():
            if kf_valid[a] and kf_valid[b]:
                pairs.add((a, b))
        for a, b in self.loop_edges:
            pairs.add((min(a, b), max(a, b)))
        # the reference pads the edge list to max_edges with weight-0 edges,
        # which add exact zeros to the system: only the live ones are solved
        pairs = sorted(pairs)[:max_edges - 1] + [(cand, cur)]
        edges = torch.tensor(pairs, dtype=torch.long, device=dev)
        E = edges.shape[0]
        meas = S_old_all.index(edges[:, 1]).compose(S_old_all.index(edges[:, 0]).inverse())
        meas = Sim3(*(torch.cat([m[:-1], v[None]]) for m, v in zip(meas, S_cl)))
        poses = Sim3(state.kf_R, state.kf_t, torch.ones((K,), dtype=dt, device=dev))
        fixed = ~torch.from_numpy(kf_valid).to(dev)
        fixed[cand] = True
        if self.gravity_aligned and self.gravity_w is not None:
            mode, yaw_axis = "4dof", self.gravity_w.to(dt)
        else:
            mode, yaw_axis = ("se3" if self.fix_scale else "sim3"), None
        res = optimize_pose_graph(
            poses, edges, meas, torch.ones((E,), dtype=torch.bool, device=dev),
            torch.ones((E,), dtype=dt, device=dev), fixed, iters=15, mode=mode,
            yaw_axis=yaw_axis,
        )
        return _apply_correction(state, poses, res.poses, torch.from_numpy(kf_valid).to(dev))
