"""Struct-of-arrays SLAM map — a PyTorch copy of the parts of the JAX
package's `slam_map/state.py` that the tracking path uses.

Capacities: K keyframes x N keypoints each; M map points with up to P
observations. Poses are Tcw. `kf_mp[k, i]` is the map-point id seen by
keypoint i of keyframe k (-1 = none); `mp_obs_kf[m, j]` / `mp_obs_idx[m, j]`
are the inverse incidence (-1 = empty). Descriptors are int32 words that
hold the reference's uint32 bit patterns.

Unlike the reference, whose arrays are immutable, the update functions
here write into the map's tensors in place and return the same MapState:
a copy of the map per keyframe would cost more than the update. Row M-1
is the reference's dump row: masked-out writes are routed there with the
value it already holds, so no write is data-dependent in shape and none
needs a host sync.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.ops.hamming import popcount_u32


class MapState(NamedTuple):
    kf_R: torch.Tensor  # (K, 3, 3) Tcw rotation
    kf_t: torch.Tensor  # (K, 3)
    kf_valid: torch.Tensor  # (K,) bool
    kf_frame_id: torch.Tensor  # (K,) int32
    kf_timestamp: torch.Tensor  # (K,) float32
    kf_xy: torch.Tensor  # (K, N, 2)
    kf_level: torch.Tensor  # (K, N) int32
    kf_angle: torch.Tensor  # (K, N)
    kf_desc: torch.Tensor  # (K, N, 8) int32 bit patterns
    kf_uright: torch.Tensor  # (K, N) -1 = mono
    kf_depth: torch.Tensor  # (K, N) -1 = unknown
    kf_kp_valid: torch.Tensor  # (K, N) bool
    kf_mp: torch.Tensor  # (K, N) int32 map point id or -1
    mp_pos: torch.Tensor  # (M, 3)
    mp_valid: torch.Tensor  # (M,) bool
    mp_desc: torch.Tensor  # (M, 8) int32 bit patterns
    mp_normal: torch.Tensor  # (M, 3)
    mp_min_dist: torch.Tensor  # (M,)
    mp_max_dist: torch.Tensor  # (M,)
    mp_ref_kf: torch.Tensor  # (M,) int32
    mp_first_kf: torch.Tensor  # (M,) int32
    mp_obs_kf: torch.Tensor  # (M, P) int32, -1 empty
    mp_obs_idx: torch.Tensor  # (M, P) int32
    mp_n_obs: torch.Tensor  # (M,) int32
    mp_count: torch.Tensor  # (1,) int32 map-point ids ever allocated
    kf_count: torch.Tensor  # (1,) int32 keyframe slots ever allocated


_UINT32_FIELDS = ("kf_desc", "mp_desc")


def allocate(max_keyframes: int, n_features: int, max_points: int, max_obs: int,
             dtype=torch.float32, device="cpu") -> MapState:
    K, N, M, P = max_keyframes, n_features, max_points, max_obs
    i32 = dict(dtype=torch.int32, device=device)
    f = dict(dtype=dtype, device=device)
    b = dict(dtype=torch.bool, device=device)
    return MapState(
        kf_R=torch.eye(3, **f).expand(K, 3, 3).clone(),
        kf_t=torch.zeros((K, 3), **f),
        kf_valid=torch.zeros((K,), **b),
        kf_frame_id=torch.full((K,), -1, **i32),
        kf_timestamp=torch.zeros((K,), dtype=torch.float32, device=device),
        kf_xy=torch.zeros((K, N, 2), **f),
        kf_level=torch.zeros((K, N), **i32),
        kf_angle=torch.zeros((K, N), **f),
        kf_desc=torch.zeros((K, N, 8), **i32),
        kf_uright=torch.full((K, N), -1.0, **f),
        kf_depth=torch.full((K, N), -1.0, **f),
        kf_kp_valid=torch.zeros((K, N), **b),
        kf_mp=torch.full((K, N), -1, **i32),
        mp_pos=torch.zeros((M, 3), **f),
        mp_valid=torch.zeros((M,), **b),
        mp_desc=torch.zeros((M, 8), **i32),
        mp_normal=torch.zeros((M, 3), **f),
        mp_min_dist=torch.zeros((M,), **f),
        mp_max_dist=torch.full((M,), 1e9, **f),
        mp_ref_kf=torch.full((M,), -1, **i32),
        mp_first_kf=torch.full((M,), -1, **i32),
        mp_obs_kf=torch.full((M, P), -1, **i32),
        mp_obs_idx=torch.full((M, P), -1, **i32),
        mp_n_obs=torch.zeros((M,), **i32),
        mp_count=torch.zeros((1,), **i32),
        kf_count=torch.zeros((1,), **i32),
    )


def map_state_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> MapState:
    """The reference's MapState as numpy arrays (one per field name) ->
    the port's MapState; uint32 descriptors become int32 bit patterns."""
    fields = {}
    for name in MapState._fields:
        a = np.asarray(d[name])
        if name in _UINT32_FIELDS:
            a = a.astype(np.uint32).view(np.int32)
        fields[name] = torch.from_numpy(np.array(a)).to(device)
    return MapState(**fields)


def map_state_to_numpy(ms: MapState) -> Dict[str, np.ndarray]:
    """The port's MapState -> numpy arrays in the reference's dtypes."""
    out = {}
    for name, t in zip(MapState._fields, ms):
        a = t.detach().cpu().numpy()
        if name in _UINT32_FIELDS:
            a = a.view(np.uint32)
        out[name] = a
    return out


def _put_rows_(dst: torch.Tensor, rows: torch.Tensor, values: torch.Tensor,
               sel: torch.Tensor, dump: int) -> None:
    """dst[rows[i]] = values[i] where sel[i]. Unselected entries rewrite
    row `dump` with its own value; no selected entry may target `dump`."""
    r = torch.where(sel, rows.long(), torch.full_like(rows, dump, dtype=torch.long))
    shape = (-1,) + (1,) * (values.dim() - 1)
    dst[r] = torch.where(sel.reshape(shape), values.to(dst.dtype), dst[dump].expand_as(values))


def _put_cells_(dst: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                values: torch.Tensor, sel: torch.Tensor, dump: int) -> None:
    """dst[rows[i], cols[i]] = values[i] where sel[i]; unselected entries
    rewrite cell (dump, 0) with its own value."""
    r = torch.where(sel, rows.long(), torch.full_like(rows, dump, dtype=torch.long))
    c = torch.where(sel, cols.long(), torch.zeros_like(cols, dtype=torch.long))
    dst[r, c] = torch.where(sel, values.to(dst.dtype), dst[dump, 0].expand_as(values))


def insert_keyframe(state: MapState, slot, pose: SE3, frame_id, timestamp, feats,
                    uright: torch.Tensor, depth: torch.Tensor,
                    mp_ids: torch.Tensor) -> MapState:
    """Write a keyframe into `slot` and add an observation to every map
    point that a keypoint is associated with (mp_ids[i] >= 0). A point's
    observation list that is full keeps the forward link only; row M-1
    (the dump row) gains no observation."""
    M, P = state.mp_obs_kf.shape
    state.kf_R[slot] = pose.R
    state.kf_t[slot] = pose.t
    state.kf_valid[slot] = True
    state.kf_frame_id[slot] = frame_id
    state.kf_timestamp[slot] = timestamp
    state.kf_xy[slot] = feats.xy
    state.kf_level[slot] = feats.level
    state.kf_angle[slot] = feats.angle
    state.kf_desc[slot] = feats.desc
    state.kf_uright[slot] = uright
    state.kf_depth[slot] = depth
    state.kf_kp_valid[slot] = feats.valid
    has_mp = (mp_ids >= 0) & feats.valid
    has_mp = has_mp & state.mp_valid[torch.clamp(mp_ids, 0, M - 1).long()]
    state.kf_mp[slot] = torch.where(has_mp, mp_ids, torch.full_like(mp_ids, -1))
    mp_safe = torch.where(has_mp, mp_ids, torch.full_like(mp_ids, M - 1)).long()
    n_cur = state.mp_n_obs[mp_safe]
    obs_slot = torch.clamp(n_cur, 0, P - 1)
    can_add = has_mp & (n_cur < P) & (mp_safe != M - 1)
    kp_idx = torch.arange(mp_ids.shape[0], dtype=torch.int32, device=mp_ids.device)
    slot_t = torch.as_tensor(slot, dtype=torch.int32, device=mp_ids.device).expand_as(kp_idx)
    _put_cells_(state.mp_obs_kf, mp_safe, obs_slot, slot_t, can_add, M - 1)
    _put_cells_(state.mp_obs_idx, mp_safe, obs_slot, kp_idx, can_add, M - 1)
    state.mp_n_obs.index_add_(0, mp_safe, can_add.to(torch.int32))
    slot1 = torch.as_tensor(slot, dtype=torch.int32, device=mp_ids.device) + 1
    torch.maximum(state.kf_count, slot1, out=state.kf_count)
    return state


def create_points(state: MapState, base_id, kf_slot, kp_idx: torch.Tensor,
                  pos: torch.Tensor, desc: torch.Tensor, normal: torch.Tensor,
                  min_dist: torch.Tensor, max_dist: torch.Tensor,
                  create: torch.Tensor) -> Tuple[MapState, torch.Tensor]:
    """Create up to C new points at contiguous ids from base_id, observed
    by keyframe `kf_slot` at keypoints kp_idx; `create` masks real
    candidates. Returns (state, ids (C,), -1 where not created). Callers
    keep every id below M-1, as the reference's do."""
    M, P = state.mp_obs_kf.shape
    dev = kp_idx.device
    offsets = torch.cumsum(create.to(torch.int32), 0) - 1
    ids = torch.where(create, base_id + offsets, torch.full_like(offsets, -1)).to(torch.int32)
    sel = create & (ids < M - 1)
    C = kp_idx.shape[0]
    slot_c = torch.as_tensor(kf_slot, dtype=torch.int32, device=dev).expand(C)
    _put_rows_(state.mp_pos, ids, pos, sel, M - 1)
    _put_rows_(state.mp_valid, ids, torch.ones_like(sel), sel, M - 1)
    _put_rows_(state.mp_desc, ids, desc, sel, M - 1)
    _put_rows_(state.mp_normal, ids, normal, sel, M - 1)
    _put_rows_(state.mp_min_dist, ids, min_dist, sel, M - 1)
    _put_rows_(state.mp_max_dist, ids, max_dist, sel, M - 1)
    _put_rows_(state.mp_ref_kf, ids, slot_c, sel, M - 1)
    _put_rows_(state.mp_first_kf, ids, slot_c, sel, M - 1)
    zeros = torch.zeros_like(ids)
    _put_cells_(state.mp_obs_kf, ids, zeros, slot_c, sel, M - 1)
    _put_cells_(state.mp_obs_idx, ids, zeros, kp_idx.to(torch.int32), sel, M - 1)
    _put_rows_(state.mp_n_obs, ids, torch.ones_like(ids), sel, M - 1)
    N = state.kf_mp.shape[1]
    kp_safe = torch.clamp(kp_idx.long(), 0, N - 1)
    row = state.kf_mp[kf_slot]
    row[kp_safe] = torch.where(create, ids, row[kp_safe])
    top = base_id + torch.sum(create.to(torch.int32))
    torch.maximum(state.mp_count, top.to(torch.int32), out=state.mp_count)
    return state, ids


def covisibility_row(state: MapState, kf_slot) -> torch.Tensor:
    """(K,) float32 number of map points keyframe `kf_slot` shares with
    each keyframe (0 for itself)."""
    K = state.kf_mp.shape[0]
    mp = state.kf_mp[kf_slot]
    has = mp >= 0
    obs_kf = state.mp_obs_kf[torch.where(has, mp, torch.zeros_like(mp)).long()]
    w = (has[:, None] & (obs_kf >= 0)).to(torch.float32)
    counts = torch.zeros((K,), dtype=torch.float32, device=mp.device)
    counts.index_add_(0, torch.clamp(obs_kf.reshape(-1), 0, K - 1).long(), w.reshape(-1))
    counts[kf_slot] = 0.0
    return counts


def update_point_stats(state: MapState, mp_ids: torch.Tensor) -> MapState:
    """Refresh the mean viewing direction, scale range and distinctive
    descriptor (least summed Hamming distance to the other observations)
    of the given points."""
    M, P = state.mp_obs_kf.shape
    ids = torch.clamp(mp_ids, 0, M - 1).long()
    obs_kf = state.mp_obs_kf[ids]
    obs_idx = state.mp_obs_idx[ids]
    mask = obs_kf >= 0
    kf_safe = torch.where(mask, obs_kf, torch.zeros_like(obs_kf)).long()
    idx_safe = torch.where(mask, obs_idx, torch.zeros_like(obs_idx)).long()
    R = state.kf_R[kf_safe]
    t = state.kf_t[kf_safe]
    centers = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    pos = state.mp_pos[ids][:, None, :]
    rays = pos - centers
    norms = torch.sqrt(torch.sum(rays * rays, dim=-1))
    rays_n = rays / torch.clamp(norms[..., None], min=1e-9)
    n_obs = torch.clamp(torch.sum(mask, dim=-1), min=1)
    normal = torch.sum(torch.where(mask[..., None], rays_n, torch.zeros_like(rays_n)), dim=1) / n_obs[:, None]
    lvl0 = state.kf_level[kf_safe[:, 0], idx_safe[:, 0]]
    scale = torch.pow(1.2, lvl0.to(torch.float32))
    max_dist = norms[:, 0] * scale
    min_dist = max_dist / (1.2 ** 7)
    descs = state.kf_desc[kf_safe, idx_safe]
    x = descs[:, :, None, :] ^ descs[:, None, :, :]
    d = torch.sum(popcount_u32(x), dim=-1).to(torch.float32)
    pair_mask = mask[:, :, None] & mask[:, None, :]
    d = torch.where(pair_mask, d, torch.zeros_like(d))
    tot = torch.sum(d, dim=-1) + torch.where(mask, 0.0, 1e9)
    best = torch.argmin(tot, dim=-1)
    best_desc = descs[torch.arange(ids.shape[0], device=ids.device), best]
    valid_row = torch.sum(mask, dim=-1) > 0
    state.mp_normal[ids] = torch.where(valid_row[:, None], normal, state.mp_normal[ids])
    state.mp_min_dist[ids] = torch.where(valid_row, min_dist, state.mp_min_dist[ids])
    state.mp_max_dist[ids] = torch.where(valid_row, max_dist, state.mp_max_dist[ids])
    state.mp_desc[ids] = torch.where(valid_row[:, None], best_desc, state.mp_desc[ids])
    return state
