"""The atlas: maps parked beside the active one, and the merge of two maps
— a PyTorch copy of the JAX package's `slam_map/atlas.py`.

Each map is one fixed-capacity `MapState`. Merging the active map into a
stored one is one append (`merge_into`): the active map's keyframe slots
shift by a constant offset and its map-point ids by another, and the Sim3
weld moves its poses and points into the stored map's world on the way.
A merge is found by matching the map points of a keyframe of each map
(`_match_cross`), a Sim3 RANSAC on them with samples drawn apart
(`utils/sampling.py`) and a Sim3 Gauss-Newton (`verify_merge`). The host
pipeline (`pipeline/stereo_vo.py`) decides when to fork and when to try a
merge.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.lie.sim3 import Sim3
from vi_slam_tpu_torch.loop.sim3_solver import sim3_ransac_core
from vi_slam_tpu_torch.ops.hamming import hamming_matrix
from vi_slam_tpu_torch.optim.sim3_opt import optimize_sim3
from vi_slam_tpu_torch.pipeline.relocalization import mutual_best_matches
from vi_slam_tpu_torch.slam_map.state import MapState, _scatter_set_
from vi_slam_tpu_torch.utils.sampling import DrawFn


@dataclass
class StoredMap:
    """A map parked in the atlas, with what the loop closer keeps of it."""

    map: MapState
    n_kf: int
    n_mp: int
    map_id: int
    db: Any = None  # its KeyFrameDatabase
    covis: Any = None  # its CovisGraph
    loop_edges: List[Tuple[int, int]] = field(default_factory=list)
    culled_parent: Dict[int, Tuple[int, np.ndarray]] = field(default_factory=dict)
    # the inertial pipeline's state of the map (its preintegration chain,
    # keyframe velocities, biases, gravity), welded back at a merge
    inertial: Optional[Dict[str, Any]] = None


def merge_into(dst: MapState, src: MapState, S: Sim3, kf_offset: int, mp_offset: int) -> MapState:
    """Append every allocated keyframe and map point of `src` into `dst`
    (in place), moving them from src's world into dst's by x_dst = S(x_src):
    keyframe slot k lands at kf_offset + k, point m at mp_offset + m. Rows
    that would overflow are dropped (the caller checks the capacity);
    culled src slots stay invalid and keep their shifted slot."""
    K = dst.kf_mp.shape[0]
    M = dst.mp_obs_kf.shape[0]
    dev = dst.kf_t.device
    dt = dst.kf_t.dtype
    S = Sim3(S.R.to(dt), S.t.to(dt), S.s.to(dt))
    Sinv = S.inverse()
    src_nkf = src.kf_count[0]
    src_nmp = src.mp_count[0]

    # keyframes: Tcw' = the SE3 part of Tcw o S^-1
    G = Sim3(src.kf_R, src.kf_t, torch.ones((K,), dtype=dt, device=dev)).compose(Sinv)
    new_t = G.t / torch.clamp(G.s, min=1e-12)[:, None]
    k = torch.arange(K, device=dev)
    dst_k = k + kf_offset
    copy_kf = (k < src_nkf) & (dst_k < K)
    mp_shift = torch.where(src.kf_mp >= 0, src.kf_mp + mp_offset, src.kf_mp)
    for name, val in (("kf_R", G.R), ("kf_t", new_t), ("kf_valid", src.kf_valid),
                      ("kf_frame_id", src.kf_frame_id), ("kf_timestamp", src.kf_timestamp),
                      ("kf_xy", src.kf_xy), ("kf_level", src.kf_level),
                      ("kf_angle", src.kf_angle), ("kf_desc", src.kf_desc),
                      ("kf_uright", src.kf_uright), ("kf_depth", src.kf_depth),
                      ("kf_kp_valid", src.kf_kp_valid), ("kf_mp", mp_shift)):
        _scatter_set_(getattr(dst, name), dst_k, val, copy_kf)

    # map points: x' = S(x), normals rotate, the scale range scales
    m = torch.arange(M, device=dev)
    dst_m = m + mp_offset
    copy_mp = (m < src_nmp) & (dst_m < M)
    kf_shift = lambda a: torch.where(a >= 0, a + kf_offset, torch.full_like(a, -1))
    for name, val in (("mp_pos", S.apply(src.mp_pos)),
                      ("mp_valid", src.mp_valid), ("mp_desc", src.mp_desc),
                      ("mp_normal", torch.einsum("ij,mj->mi", S.R, src.mp_normal)),
                      ("mp_min_dist", src.mp_min_dist * S.s),
                      ("mp_max_dist", src.mp_max_dist * S.s),
                      ("mp_ref_kf", kf_shift(src.mp_ref_kf)),
                      ("mp_first_kf", kf_shift(src.mp_first_kf)),
                      ("mp_obs_kf", kf_shift(src.mp_obs_kf)),
                      ("mp_obs_idx", src.mp_obs_idx), ("mp_n_obs", src.mp_n_obs)):
        _scatter_set_(getattr(dst, name), dst_m, val, copy_mp)
    dst.mp_count.copy_((src_nmp + mp_offset).reshape(1).to(torch.int32))
    dst.kf_count.copy_((src_nkf + kf_offset).reshape(1).to(torch.int32))
    return dst


def _match_cross(state_a: MapState, kf_a: int, state_b: MapState, kf_b: int,
                 th: float = 50.0, ratio: float = 0.75):
    """Mutual-best Hamming matches between the map-point keypoints of one
    keyframe in each of two maps: (kp_a, kp_b, mp_a, mp_b, good), each
    the length of a keyframe's keypoint row."""
    mp_a = state_a.kf_mp[kf_a]
    mp_b = state_b.kf_mp[kf_b]
    Ma = state_a.mp_pos.shape[0]
    Mb = state_b.mp_pos.shape[0]
    ok_a = (state_a.kf_kp_valid[kf_a] & (mp_a >= 0)
            & state_a.mp_valid[torch.clamp(mp_a, 0, Ma - 1).long()])
    ok_b = (state_b.kf_kp_valid[kf_b] & (mp_b >= 0)
            & state_b.mp_valid[torch.clamp(mp_b, 0, Mb - 1).long()])
    j_best, _, good = mutual_best_matches(
        hamming_matrix(state_a.kf_desc[kf_a], state_b.kf_desc[kf_b]), ok_a, ok_b, th, ratio)
    kp_a = torch.arange(mp_a.shape[0], dtype=torch.int32, device=mp_a.device)
    kp_b = j_best.to(torch.int32)
    return kp_a, kp_b, mp_a, mp_b[j_best], good


def _cross_geometry(state_a: MapState, kf_a: int, state_b: MapState, kf_b: int,
                    kp_a, kp_b, mp_a, mp_b, valid):
    """The Sim3 solver's inputs for cross-map pairs: camera-frame points,
    pixels and pyramid variances."""
    Ma = state_a.mp_pos.shape[0]
    Mb = state_b.mp_pos.shape[0]
    x1 = SE3(state_a.kf_R[kf_a], state_a.kf_t[kf_a]).apply(
        state_a.mp_pos[torch.clamp(mp_a, 0, Ma - 1).long()])
    x2 = SE3(state_b.kf_R[kf_b], state_b.kf_t[kf_b]).apply(
        state_b.mp_pos[torch.clamp(mp_b, 0, Mb - 1).long()])
    ia, ib = kp_a.long(), kp_b.long()
    uv1 = state_a.kf_xy[kf_a][ia]
    uv2 = state_b.kf_xy[kf_b][ib]
    s1 = torch.pow(1.2, 2.0 * state_a.kf_level[kf_a][ia].to(torch.float32))
    s2 = torch.pow(1.2, 2.0 * state_b.kf_level[kf_b][ib].to(torch.float32))
    return x1, x2, uv1, uv2, s1, s2, valid


def verify_merge(cam: CameraParams, state_cur: MapState, cur: int, state_old: MapState,
                 cand: int, draw: DrawFn, min_inliers: int = 20, th: int = 50,
                 fix_scale: bool = True):
    """Cross-map common-region verification: matching, Sim3 RANSAC and
    Sim3 Gauss-Newton. Returns (ok, S_cl, (mp_cur, mp_old, inlier mask))
    with S_cl mapping cand-camera coordinates to cur-camera coordinates.
    The RANSAC samples are drawn for every candidate, verified or not,
    as the reference splits its key for every candidate."""
    kp_a, kp_b, mp_a, mp_b, valid = _match_cross(state_cur, cur, state_old, cand, th=float(th))
    x1, x2, uv1, uv2, s1, s2, valid = _cross_geometry(state_cur, cur, state_old, cand,
                                                      kp_a, kp_b, mp_a, mp_b, valid)
    idx = draw(valid, 256, 3)
    if int(torch.sum(valid)) < min_inliers:
        return False, None, None
    res = sim3_ransac_core(cam, cam, x1, x2, uv1, uv2, valid, s1, s2, idx, fix_scale=fix_scale)
    if int(res.n_inliers) < min_inliers:
        return False, None, None
    opt = optimize_sim3(cam, cam, res.S12, x1, x2, uv1, uv2, valid & res.inliers, s1, s2,
                        fix_scale=fix_scale)
    if int(opt.n_inliers) < min_inliers:
        return False, None, None
    return True, opt.S12, (mp_a, mp_b, valid & opt.inliers)


def weld_transform(S_cl: Sim3, T_cur: SE3, T_cand: SE3) -> Sim3:
    """The Sim3 from the active map's world to the stored map's, given the
    verified camera-to-camera S_cl (cur camera <- cand camera) and the two
    keyframe poses: x_stored = T_cand^-1 o S_cl^-1 o T_cur (x_active)."""
    one = torch.ones((), dtype=T_cur.t.dtype, device=T_cur.t.device)
    Scur = Sim3(T_cur.R, T_cur.t, one)
    Scand = Sim3(T_cand.R, T_cand.t, one)
    return Scand.inverse().compose(S_cl.inverse()).compose(Scur)
