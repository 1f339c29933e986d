"""Device steps of the stereo pipeline — a PyTorch copy of the functions
of the JAX package's `pipeline/steps.py` that the main path calls: the
per-frame tracking steps, at keyframe rate the mapping pass (fuse +
triangulate) and local BA's gather and scatter, and after a loop
correction global BA's gather and scatter. None of them syncs with the
host."""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from vi_slam_tpu_torch.cameras import pinhole
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.geometry.epipolar import fundamental_from_poses
from vi_slam_tpu_torch.geometry.triangulate import triangulate_dlt
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.ops import match as match_ops
from vi_slam_tpu_torch.ops.fast import top_k
from vi_slam_tpu_torch.ops.hamming import hamming_matrix
from vi_slam_tpu_torch.optim.local_ba import BAProblem
from vi_slam_tpu_torch.optim.pose_opt import PoseObs
from vi_slam_tpu_torch.slam_map import state as map_state
from vi_slam_tpu_torch.slam_map.state import MapState, covisibility_row, dev_index
from vi_slam_tpu_torch.utils.numerics import log_f32, norm3_f32


def _unique_padded(key: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """The `size` smallest distinct values of `key`, ascending, padded
    with `fill` (`jnp.unique(key, size=size, fill_value=fill)`)."""
    s = torch.sort(key).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    pos = torch.cumsum(first.to(torch.int64), 0) - 1
    dest = torch.where(first & (pos < size), pos, torch.full_like(pos, size))
    out = torch.full((size + 1,), fill, dtype=key.dtype, device=key.device)
    out.scatter_(0, dest, torch.where(dest < size, s, torch.full_like(s, fill)))
    return out[:size]


def gather_local_points(state: MapState, recent_kfs: torch.Tensor, n_local: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unique map-point ids observed by the given keyframe slots (W,), -1
    padded: points of the first slot (the reference keyframe) first, then
    the newest. Returns (ids (n_local,) int32, -1 beyond the count; mask)."""
    K, N = state.kf_mp.shape
    M = state.mp_pos.shape[0]
    rows = state.kf_mp[torch.clamp(recent_kfs, 0, K - 1).long()]
    rows = torch.where((recent_kfs >= 0)[:, None], rows, torch.full_like(rows, -1))
    flat = rows.reshape(-1).long()
    Q = M + 1
    ref_row = rows[0].long()
    ref_clip = torch.clamp(ref_row, 0, M - 1)
    in_ref = torch.zeros((M,), dtype=torch.bool, device=flat.device)
    in_ref[ref_clip] = ref_row >= 0
    # The reference scatters with .set(): where a -1 entry and point 0
    # both land on index 0, the last write wins. Mirror that.
    n = ref_row.shape[0]
    pos = torch.arange(n, device=flat.device)
    last0 = torch.max(torch.where(ref_clip == 0, pos, torch.full_like(pos, -1)))
    in_ref[0] = torch.where(last0 >= 0, ref_row[torch.clamp(last0, min=0)] >= 0, in_ref[0])
    pri = torch.where(in_ref[torch.clamp(flat, 0, M - 1)], 0, 1)
    key = torch.where(flat >= 0, pri * Q + (M - flat), torch.full_like(flat, 2 * Q + 1))
    uniq = _unique_padded(key, n_local, 2 * Q + 1)
    ids = torch.where(uniq < 2 * Q, M - (uniq % Q), torch.full_like(uniq, -1)).to(torch.int32)
    return ids, ids >= 0


def covis_window(state: MapState, ref_slot, n_window: int) -> torch.Tensor:
    """The reference keyframe plus its most covisible live keyframes,
    newest first among equals: (n_window,) int32 slots, -1 padded."""
    K = state.kf_valid.shape[0]
    counts = covisibility_row(state, ref_slot).to(torch.int64)
    slots = torch.arange(K, device=counts.device)
    key = torch.where(state.kf_valid, counts * K + slots, torch.full_like(slots, -1))
    key[ref_slot] = torch.iinfo(torch.int32).max
    topv, topi = top_k(key, n_window)
    return torch.where(topv > 0, topi, torch.full_like(topi, -1)).to(torch.int32)


class Projected(NamedTuple):
    uv: torch.Tensor  # (M, 2)
    level: torch.Tensor  # (M,)
    desc: torch.Tensor  # (M, 8)
    valid: torch.Tensor  # (M,)
    pos: torch.Tensor  # (M, 3)


def project_local_points(cam: CameraParams, state: MapState, mp_ids: torch.Tensor,
                         mp_mask: torch.Tensor, T_cw: SE3, width: int, height: int,
                         n_levels: int = 8, scale_factor: float = 1.2) -> Projected:
    """Project map points into the predicted camera, with the predicted
    octave and the frustum, scale-range and viewing-angle gates."""
    M = state.mp_pos.shape[0]
    safe = torch.clamp(mp_ids, 0, M - 1).long()
    pos = state.mp_pos[safe]
    desc = state.mp_desc[safe]
    normal = state.mp_normal[safe]
    mind = state.mp_min_dist[safe]
    maxd = state.mp_max_dist[safe]
    alive = state.mp_valid[safe] & mp_mask
    pc = T_cw.apply(pos)
    z = pc[..., 2]
    uv = pinhole.project(cam, pc)
    in_img = (
        (uv[..., 0] >= 0) & (uv[..., 0] < width)
        & (uv[..., 1] >= 0) & (uv[..., 1] < height) & (z > 0.1)
    )
    cam_center = T_cw.inverse().t
    ray = pos - cam_center
    dist = norm3_f32(ray)
    in_range = (dist >= 0.8 * mind) & (dist <= 1.2 * maxd)
    nnorm = torch.sqrt(torch.sum(normal * normal, dim=-1))
    cosv = torch.sum(ray * normal, dim=-1) / torch.clamp(dist * nnorm, min=1e-9)
    view_ok = cosv > 0.5
    ratio = torch.clamp(maxd / torch.clamp(dist, min=1e-6), min=1e-6)
    level = torch.clamp(
        torch.ceil(log_f32(ratio) / math.log(scale_factor)).to(torch.int32),
        0, n_levels - 1,
    )
    return Projected(uv=uv, level=level, desc=desc,
                     valid=alive & in_img & in_range & view_ok, pos=pos)


def build_pose_obs(proj: Projected, m: match_ops.Matches, feats, uright: torch.Tensor,
                   scale_factor: float = 1.2) -> Tuple[PoseObs, torch.Tensor]:
    """Projection matches -> PoseObs; also the matched keypoint of each
    projected point."""
    kp = torch.clamp(m.idx, 0, feats.xy.shape[0] - 1).long()
    uv_kp = feats.xy[kp]
    ur_kp = uright[kp]
    stereo = ur_kp > 0
    uvr = torch.cat([uv_kp, torch.where(stereo, ur_kp, torch.zeros_like(ur_kp))[:, None]], dim=-1)
    sigma2 = torch.pow(scale_factor, 2.0 * feats.level[kp].to(torch.float32))
    obs = PoseObs(xw=proj.pos, uvr=uvr, stereo=stereo, sigma2=sigma2,
                  valid=m.ok & proj.valid)
    return obs, kp


def scatter_matches_to_kps(n_kps: int, kp_idx: torch.Tensor, mp_ids: torch.Tensor,
                           ok: torch.Tensor) -> torch.Tensor:
    """Per-keypoint map-point id (-1 none) from match lists; matched
    keypoints are unique."""
    safe_kp = torch.where(ok, torch.clamp(kp_idx.long(), 0, n_kps - 1),
                          torch.full_like(kp_idx, n_kps, dtype=torch.long))
    out = torch.full((n_kps + 1,), -1, dtype=torch.int32, device=kp_idx.device)
    out[safe_kp] = torch.where(ok, mp_ids.to(torch.int32), torch.full_like(mp_ids, -1, dtype=torch.int32))
    return out[:n_kps]


# ------------------------------------------------------- keyframe rate
#
# The mapping pass (fuse + triangulate) and local BA's gather and scatter.
# Keyframe slots come as Python ints from the host or as device tensors;
# both are used as (1,) index tensors (`dev_index`), so no step reads a
# device value on the host.


def fuse_pair_dir(cam: CameraParams, state: MapState, kf_a, kf_b, alive: torch.Tensor,
                  width: float, height: float, max_fuse: int = 96, radius: float = 3.0,
                  th_low: int = 50, scale_factor: float = 1.2, n_levels: int = 8) -> MapState:
    """One direction of the neighbour search: project keyframe a's map
    points into keyframe b. A match on a free keypoint becomes a new
    observation; a match on a keypoint that holds another point merges the
    two (the one with more observations survives; the projected point on
    a tie)."""
    K, N = state.kf_mp.shape
    M = state.mp_obs_kf.shape[0]
    dev = state.kf_mp.device
    a1, b1 = dev_index(kf_a, dev), dev_index(kf_b, dev)
    mp = state.kf_mp[a1][0]
    safe = torch.clamp(mp, 0, M - 1).long()
    has = (mp >= 0) & alive & state.mp_valid[safe]
    pos = state.mp_pos[safe]
    desc = state.mp_desc[safe]
    maxd = state.mp_max_dist[safe]

    Tb = SE3(state.kf_R[b1][0], state.kf_t[b1][0])
    pc = Tb.apply(pos)
    z = pc[..., 2]
    uv = pinhole.project(cam, pc)
    in_img = (
        (uv[..., 0] >= 0) & (uv[..., 0] < width)
        & (uv[..., 1] >= 0) & (uv[..., 1] < height) & (z > 0.1)
    )
    ray = pos - Tb.inverse().t
    dist = norm3_f32(ray)
    ratio_d = torch.clamp(maxd / torch.clamp(dist, min=1e-6), min=1e-6)
    level = torch.clamp(
        torch.ceil(log_f32(ratio_d) / math.log(scale_factor)).to(torch.int32),
        0, n_levels - 1,
    )
    valid = has & in_img

    level_scales = torch.pow(scale_factor, torch.arange(n_levels, dtype=uv.dtype, device=dev))
    kp_xy_b = state.kf_xy[b1][0]
    m = match_ops.search_by_projection(
        uv, level, desc, valid,
        kp_xy_b, state.kf_level[b1][0], state.kf_desc[b1][0], state.kf_kp_valid[b1][0],
        radius=radius, level_scales=level_scales, max_dist=th_low, ratio=0.95,
    )
    m = match_ops.resolve_duplicate_targets(m, N)
    kp = torch.clamp(m.idx, 0, N - 1).long()
    q = state.kf_mp[b1][0][kp]
    # stale links (culling clears a recent window only) count as free
    q = torch.where((q >= 0) & state.mp_valid[torch.clamp(q, 0, M - 1).long()], q,
                    torch.full_like(q, -1))
    okm = m.ok & valid
    # stereo consistency, for the merge only
    ur_kp = state.kf_uright[b1][0][kp]
    ur_pred = uv[:, 0] - cam.bf / torch.clamp(z, min=1e-6)
    r_eff = radius * level_scales[torch.clamp(level, 0, n_levels - 1).long()]
    ur_ok = (ur_kp <= 0) | (torch.abs(ur_pred - ur_kp) <= r_eff)

    # case 1: a free keypoint, and b does not observe the point yet
    already_in_b = torch.any(state.mp_obs_kf[safe] == b1[0].to(torch.int32), dim=1)
    free = okm & (q < 0) & ~already_in_b
    state = map_state.register_obs(state, torch.where(free, mp, torch.full_like(mp, -1)),
                                   b1, kp, free)

    # case 2: a duplicate: merge into the point with more observations
    dup = okm & ur_ok & (q >= 0) & (q != mp)
    q_safe = torch.clamp(q, 0, M - 1).long()
    p_wins = state.mp_n_obs[safe] >= state.mp_n_obs[q_safe]
    winner = torch.where(p_wins, mp, q)
    loser = torch.where(p_wins, q, mp)
    # the budget goes to the strongest (lowest-distance) pairs
    sel_score = torch.where(dup, -m.dist.to(torch.float32),
                            torch.full_like(m.dist, float("-inf"), dtype=torch.float32))
    _, sel = top_k(sel_score, max_fuse)
    dup_sel = dup[sel] & torch.isfinite(sel_score[sel])
    state = map_state.fuse_points(state, loser[sel], winner[sel], dup_sel)
    return map_state.update_point_stats(
        state, torch.where(dup_sel, winner[sel], torch.full_like(winner[sel], M - 1)))


def fuse_neighbors(cam: CameraParams, state: MapState, ref_slot, width: float, height: float,
                   n_window: int = 4, max_fuse: int = 96, radius: float = 3.0,
                   th_low: int = 50, scale_factor: float = 1.2, n_levels: int = 8) -> MapState:
    """Fuse the newest keyframe with its best covisible neighbours, both
    directions (window entries 1 .. n_window-1; none at n_window 1)."""
    window = covis_window(state, ref_slot, n_window)
    K = state.kf_mp.shape[0]
    kw = dict(max_fuse=max_fuse, radius=radius, th_low=th_low,
              scale_factor=scale_factor, n_levels=n_levels)
    for i in range(1, n_window):
        nb = window[i:i + 1]
        alive = nb[0] >= 0
        nb = torch.clamp(nb, 0, K - 1)
        state = fuse_pair_dir(cam, state, ref_slot, nb, alive, width, height, **kw)
        state = fuse_pair_dir(cam, state, nb, ref_slot, alive, width, height, **kw)
    return state


class TriangulationCandidates(NamedTuple):
    """Output of match_and_triangulate: a fixed-capacity batch of new
    points."""

    kp_new: torch.Tensor  # (C,) keypoint index in the new keyframe
    kp_ref: torch.Tensor  # (C,) keypoint index in the other keyframe
    pos: torch.Tensor  # (C, 3) world positions
    desc: torch.Tensor  # (C, 8) descriptors (of the new keyframe)
    normal: torch.Tensor  # (C, 3)
    min_dist: torch.Tensor  # (C,)
    max_dist: torch.Tensor  # (C,)
    create: torch.Tensor  # (C,) bool


def match_and_triangulate(cam: CameraParams, state: MapState, kf_new, kf_ref, max_new: int,
                          th_low: int = 50, ratio: float = 0.8, scale_factor: float = 1.2,
                          n_levels: int = 8) -> TriangulationCandidates:
    """Match the unmatched keypoints of two keyframes under the epipolar
    constraint (full Hamming matrix, mutual best, ratio test) and place
    each match by DLT, or by the stereo depth of the view with more
    parallax where the rays are too parallel; then the depth,
    reprojection and scale-consistency gates, and the `max_new` best by
    descriptor distance."""
    N = state.kf_mp.shape[1]
    dev = state.kf_mp.device
    n1, r1 = dev_index(kf_new, dev), dev_index(kf_ref, dev)
    d_new = state.kf_desc[n1][0]
    d_ref = state.kf_desc[r1][0]
    free_new = state.kf_kp_valid[n1][0] & (state.kf_mp[n1][0] < 0)
    free_ref = state.kf_kp_valid[r1][0] & (state.kf_mp[r1][0] < 0)
    T_new = SE3(state.kf_R[n1][0], state.kf_t[n1][0])
    T_ref = SE3(state.kf_R[r1][0], state.kf_t[r1][0])

    big = 1e9
    D = hamming_matrix(d_new, d_ref).to(torch.float32)
    D = torch.where(free_new[:, None] & free_ref[None, :], D, torch.full_like(D, big))

    # epipolar gate: distance of each ref keypoint to each new keypoint's epiline
    zero = torch.zeros_like(cam.fx)
    one = torch.ones_like(cam.fx)
    Kmat = torch.stack([torch.stack([cam.fx, zero, cam.cx]), torch.stack([zero, cam.fy, cam.cy]),
                        torch.stack([zero, zero, one])]).to(state.kf_xy.dtype)
    F = fundamental_from_poses(T_new, T_ref, Kmat, Kmat)
    uv_new = state.kf_xy[n1][0]
    uv_ref = state.kf_xy[r1][0]
    x1h = torch.cat([uv_new, torch.ones_like(uv_new[:, :1])], dim=-1)
    x2h = torch.cat([uv_ref, torch.ones_like(uv_ref[:, :1])], dim=-1)
    lines = x1h @ F
    l_norm = torch.clamp(lines[:, 0] ** 2 + lines[:, 1] ** 2, min=1e-12)
    dot = lines @ x2h.T
    epi_d2 = dot * dot / l_norm[:, None]
    lvl_ref_all = state.kf_level[r1][0].to(torch.float32)
    sigma2_ref = torch.pow(scale_factor, 2.0 * lvl_ref_all)
    epi_ok = epi_d2 < 3.84 * sigma2_ref[None, :]
    D = torch.where(epi_ok, D, torch.full_like(D, big))

    # argmin/min take the first index on ties, as jnp.argmin does
    j_best = torch.argmin(D, dim=1)
    d_best = torch.min(D, dim=1).values
    cols = torch.arange(N, device=dev)
    D2 = torch.where(cols[None, :] == j_best[:, None], torch.full_like(D, big), D)
    d_second = torch.min(D2, dim=1).values
    i_best_of_j = torch.argmin(D, dim=0)
    mutual = i_best_of_j[j_best] == cols
    good = (d_best < th_low) & (d_best < ratio * d_second) & mutual & free_new

    kp_ref_idx = j_best.to(torch.int32)
    b_new = pinhole.unproject(cam, uv_new)
    uv_r = uv_ref[j_best]
    b_ref = pinhole.unproject(cam, uv_r)

    # ray parallax of the bearings, against the parallax the stereo
    # baseline gives each view's depth
    ray_new_w = b_new @ T_new.R
    ray_ref_w = b_ref @ T_ref.R
    cos_rays = torch.sum(ray_new_w * ray_ref_w, dim=-1) / torch.clamp(
        norm3_f32(ray_new_w) * norm3_f32(ray_ref_w), min=1e-12)
    baseline = cam.bf / cam.fx
    d_new_st = state.kf_depth[n1][0]
    d_ref_st = state.kf_depth[r1][0][j_best]
    has_st_new = d_new_st > 0
    has_st_ref = d_ref_st > 0

    def cos_stereo(d, has):
        c = torch.cos(2.0 * torch.atan2(baseline / 2.0, torch.clamp(d, min=1e-6)))
        return torch.where(has, c, torch.full_like(c, 1.1))

    cos_st_new = cos_stereo(d_new_st, has_st_new)
    cos_st_ref = cos_stereo(d_ref_st, has_st_ref)
    cos_st = torch.minimum(cos_st_new, cos_st_ref)

    tri_ok = (cos_rays < cos_st) & (cos_rays > 0) & (cos_rays < 0.9998)
    xw_dlt = triangulate_dlt(T_new, T_ref, b_new, b_ref)
    Twc_new = T_new.inverse()
    Twc_ref = T_ref.inverse()
    xw_st_new = Twc_new.apply(b_new * d_new_st[:, None])
    xw_st_ref = Twc_ref.apply(b_ref * d_ref_st[:, None])
    use_st_new = ~tri_ok & has_st_new & (cos_st_new < cos_st_ref)
    use_st_ref = ~tri_ok & ~use_st_new & has_st_ref
    xw = torch.where(use_st_new[:, None], xw_st_new,
                     torch.where(use_st_ref[:, None], xw_st_ref, xw_dlt))
    good = good & (tri_ok | use_st_new | use_st_ref)

    pc_new = T_new.apply(xw)
    pc_ref = T_ref.apply(xw)
    z_new, z_ref = pc_new[:, 2], pc_ref[:, 2]
    c_new = Twc_new.t
    c_ref = Twc_ref.t

    # reprojection gates, with the right-image residual where there is one
    lvl_new = state.kf_level[n1][0].to(torch.float32)
    sig2_new = torch.pow(scale_factor, 2.0 * lvl_new)
    pr_new = pinhole.project(cam, pc_new)
    pr_ref = pinhole.project(cam, pc_ref)
    ur_new = state.kf_uright[n1][0]
    ur_ref = state.kf_uright[r1][0][j_best]
    e_new = torch.sum((pr_new - uv_new) ** 2, dim=-1)
    e_ref = torch.sum((pr_ref - uv_r) ** 2, dim=-1)
    ur_pred_new = pr_new[:, 0] - cam.bf / torch.clamp(z_new, min=1e-6)
    ur_pred_ref = pr_ref[:, 0] - cam.bf / torch.clamp(z_ref, min=1e-6)
    e_new3 = e_new + (ur_pred_new - ur_new) ** 2
    e_ref3 = e_ref + (ur_pred_ref - ur_ref) ** 2
    sig2_ref_m = sigma2_ref[j_best]
    gate_new = torch.where(ur_new > 0, e_new3 < 7.815 * sig2_new, e_new < 5.991 * sig2_new)
    gate_ref = torch.where(ur_ref > 0, e_ref3 < 7.815 * sig2_ref_m, e_ref < 5.991 * sig2_ref_m)
    good = good & (z_new > 0.05) & (z_ref > 0.05) & gate_new & gate_ref

    # scale consistency: the distance ratio agrees with the octave ratio
    dist_new_all = norm3_f32(xw - c_new[None, :])
    dist_ref_all = norm3_f32(xw - c_ref[None, :])
    ratio_dist = dist_ref_all / torch.clamp(dist_new_all, min=1e-9)
    ratio_octave = torch.pow(scale_factor, lvl_new - lvl_ref_all[j_best])
    ratio_factor = 1.5 * scale_factor
    good = (good & (dist_new_all > 1e-6) & (dist_ref_all > 1e-6)
            & (ratio_dist * ratio_factor > ratio_octave)
            & (ratio_dist < ratio_octave * ratio_factor))

    sel_score = torch.where(good, -d_best, torch.full_like(d_best, -big))
    _, sel = top_k(sel_score, max_new)
    create = good[sel]
    ray = xw[sel] - c_new[None, :]
    dist = norm3_f32(ray)
    max_dist = dist * torch.pow(scale_factor, lvl_new[sel])
    min_dist = max_dist / scale_factor ** (n_levels - 1)
    normal = ray / torch.clamp(norm3_f32(ray, keepdim=True), min=1e-9)
    return TriangulationCandidates(
        kp_new=sel.to(torch.int32), kp_ref=kp_ref_idx[sel], pos=xw[sel], desc=d_new[sel],
        normal=normal, min_dist=min_dist, max_dist=max_dist, create=create,
    )


def gather_ba_problem(cam: CameraParams, state: MapState, window_kfs: torch.Tensor,
                      window_fixed: torch.Tensor, mp_ids: torch.Tensor, n_window: int,
                      n_points: int, n_obs: int, scale_factor: float = 1.2) -> BAProblem:
    """A static-shape BAProblem of the window's keyframes (-1 padded) and
    the given points (-1 padded), with their observations inside the
    window."""
    K_total, N = state.kf_mp.shape
    M_total = state.mp_obs_kf.shape[0]
    dev = state.kf_mp.device
    kf_safe = torch.clamp(window_kfs, 0, K_total - 1).long()
    poses = SE3(state.kf_R[kf_safe], state.kf_t[kf_safe])
    kf_alive = (window_kfs >= 0) & state.kf_valid[kf_safe]
    fixed = window_fixed | ~kf_alive

    # global slot -> window index. A -1 pad clips to slot 0 like a real
    # slot-0 entry; the max-scatter keeps the live entry's index.
    widx = torch.arange(n_window, dtype=torch.int32, device=dev)
    slot_of = torch.full((K_total,), -1, dtype=torch.int32, device=dev)
    slot_of.scatter_reduce_(0, kf_safe, torch.where(kf_alive, widx, torch.full_like(widx, -1)),
                            reduce="amax")

    ids_safe = torch.clamp(mp_ids, 0, M_total - 1).long()
    pts = state.mp_pos[ids_safe]
    pt_valid = (mp_ids >= 0) & state.mp_valid[ids_safe]
    obs_kf = state.mp_obs_kf[ids_safe][:, :n_obs]
    obs_idx = state.mp_obs_idx[ids_safe][:, :n_obs]
    obs_has = obs_kf >= 0
    okf_safe = torch.clamp(obs_kf, 0, K_total - 1).long()
    oidx_safe = torch.clamp(obs_idx, 0, N - 1).long()
    w_slot = slot_of[okf_safe]
    in_window = (w_slot >= 0) & obs_has

    uv = state.kf_xy[okf_safe, oidx_safe]
    ur = state.kf_uright[okf_safe, oidx_safe]
    lvl = state.kf_level[okf_safe, oidx_safe]
    stereo = ur > 0
    uvr = torch.cat([uv, torch.where(stereo, ur, torch.zeros_like(ur))[..., None]], dim=-1)
    sigma2 = torch.pow(scale_factor, 2.0 * lvl.to(torch.float32))
    return BAProblem(
        poses=poses, fixed=fixed, points=pts, point_valid=pt_valid,
        obs_cam=torch.where(in_window, w_slot, torch.zeros_like(w_slot)).to(torch.int32),
        obs_uvr=uvr, obs_stereo=stereo, obs_sigma2=sigma2,
        obs_mask=in_window & pt_valid[:, None],
    )


def scatter_ba_result(state: MapState, window_kfs: torch.Tensor, window_fixed: torch.Tensor,
                      mp_ids: torch.Tensor, poses: SE3, points: torch.Tensor) -> MapState:
    """Write the optimized poses of the window's free keyframes and the
    positions of its live points back into the map; every other entry is
    dropped, so a clipped pad never lands on slot or point 0."""
    M_total = state.mp_pos.shape[0]
    upd = (window_kfs >= 0) & ~window_fixed
    kf_idx = torch.clamp(window_kfs, min=0)
    map_state._scatter_set_(state.kf_R, kf_idx, poses.R, upd)
    map_state._scatter_set_(state.kf_t, kf_idx, poses.t, upd)
    ids_safe = torch.clamp(mp_ids, 0, M_total - 1)
    updp = (mp_ids >= 0) & state.mp_valid[ids_safe.long()]
    map_state._scatter_set_(state.mp_pos, ids_safe, points, updp)
    return state


def gather_global_ba_problem(cam: CameraParams, state: MapState,
                             scale_factor: float = 1.2) -> BAProblem:
    """The whole map as a BAProblem: camera index = keyframe slot, every
    map point a landmark, observations straight from the incidence
    arrays. Slot 0 (the origin keyframe) and the free slots are fixed."""
    K, N = state.kf_mp.shape
    fixed = ~state.kf_valid
    fixed[0] = True
    obs_kf = state.mp_obs_kf
    okf_safe = torch.clamp(obs_kf, 0, K - 1).long()
    oidx_safe = torch.clamp(state.mp_obs_idx, 0, N - 1).long()
    obs_has = (obs_kf >= 0) & state.kf_valid[okf_safe]
    uv = state.kf_xy[okf_safe, oidx_safe]
    ur = state.kf_uright[okf_safe, oidx_safe]
    lvl = state.kf_level[okf_safe, oidx_safe]
    stereo = ur > 0
    uvr = torch.cat([uv, torch.where(stereo, ur, torch.zeros_like(ur))[..., None]], dim=-1)
    return BAProblem(
        poses=SE3(state.kf_R.clone(), state.kf_t.clone()),
        fixed=fixed,
        points=state.mp_pos.clone(),
        point_valid=state.mp_valid.clone(),
        obs_cam=torch.where(obs_has, okf_safe, torch.zeros_like(okf_safe)).to(torch.int32),
        obs_uvr=uvr,
        obs_stereo=stereo,
        obs_sigma2=torch.pow(scale_factor, 2.0 * lvl.to(torch.float32)),
        obs_mask=obs_has & state.mp_valid[:, None],
    )


def scatter_global_ba_result(state: MapState, poses: SE3, points: torch.Tensor) -> MapState:
    """Write whole-map BA results back: the poses of the live keyframes
    but slot 0, and the positions of the live points."""
    upd_kf = state.kf_valid.clone()
    upd_kf[0] = False
    return state._replace(
        kf_R=torch.where(upd_kf[:, None, None], poses.R, state.kf_R),
        kf_t=torch.where(upd_kf[:, None], poses.t, state.kf_t),
        mp_pos=torch.where(state.mp_valid[:, None], points, state.mp_pos),
    )
