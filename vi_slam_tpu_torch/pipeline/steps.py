"""Per-frame device steps of the tracking path — a PyTorch copy of the
functions of the JAX package's `pipeline/steps.py` that the frame loop
calls. None of them syncs with the host."""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from vi_slam_tpu_torch.cameras import pinhole
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.ops import match as match_ops
from vi_slam_tpu_torch.ops.fast import top_k
from vi_slam_tpu_torch.optim.pose_opt import PoseObs
from vi_slam_tpu_torch.slam_map.state import MapState, covisibility_row


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
    dist = torch.sqrt(torch.sum(ray * ray, dim=-1))
    in_range = (dist >= 0.8 * mind) & (dist <= 1.2 * maxd)
    nnorm = torch.sqrt(torch.sum(normal * normal, dim=-1))
    cosv = torch.sum(ray * normal, dim=-1) / torch.clamp(dist * nnorm, min=1e-9)
    view_ok = cosv > 0.5
    ratio = torch.clamp(maxd / torch.clamp(dist, min=1e-6), min=1e-6)
    level = torch.clamp(
        torch.ceil(torch.log(ratio) / math.log(scale_factor)).to(torch.int32),
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
