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
from vi_slam_tpu_torch.utils.device import resolve_device
from vi_slam_tpu_torch.utils.numerics import norm3_f32


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


def map_state_from_numpy(d: Dict[str, np.ndarray], device="cuda") -> MapState:
    """The reference's MapState as numpy arrays (one per field name) ->
    the port's MapState on `device` (default the card); uint32
    descriptors become int32 bit patterns."""
    device = resolve_device(device)
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


def dev_index(v, device) -> torch.Tensor:
    """A slot index as a (1,) int64 tensor on `device`. Indexing with it
    is advanced indexing, which never reads the value on the host (a 0-dim
    tensor index would, and wait for the card); a Python int becomes a
    fill kernel, not a copy."""
    if isinstance(v, torch.Tensor):
        return v.reshape(1).long()
    return torch.full((1,), int(v), dtype=torch.long, device=device)


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
    slot_c = dev_index(kf_slot, dev).to(torch.int32).expand(C)
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
    norms = norm3_f32(rays)
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


# ------------------------------------------------------------ map lifecycle
#
# The functions below are the keyframe-rate half of the reference's
# `slam_map/state.py`. Where the reference scatters with `.at[idx].set`
# and an index can repeat (clipped -1 pads, a keypoint claimed twice), its
# result on the CPU is that of writing the entries in order: the last one
# wins. `_scatter_set_` gives that result whatever order the device
# applies the writes in, so the card and the CPU agree with the reference.


def _scatter_set_(dst: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
                  sel: torch.Tensor | None = None) -> None:
    """dst[idx[i]] = values[i] along the first axis, entry after entry:
    where an index repeats the last entry wins, as the reference's
    `.at[idx].set(values)` does on the CPU. Entries whose `sel` is False
    are dropped (`mode="drop"`)."""
    n = dst.shape[0]
    tgt = idx.long()
    if sel is not None:
        tgt = torch.where(sel, tgt, torch.full_like(tgt, n))
    pos = torch.full((n + 1,), -1, dtype=torch.long, device=dst.device)
    pos.scatter_reduce_(0, tgt, torch.arange(tgt.shape[0], device=dst.device), reduce="amax")
    pos = pos[:n]
    shape = (-1,) + (1,) * (dst.dim() - 1)
    src = values.to(dst.dtype)[torch.clamp(pos, min=0)]
    dst.copy_(torch.where((pos >= 0).reshape(shape), src, dst))


def register_obs(state: MapState, mp_ids: torch.Tensor, kf_slot, kp_idx: torch.Tensor,
                 valid: torch.Tensor) -> MapState:
    """Add observations of existing map points from keyframe `kf_slot`
    at keypoints kp_idx (parallel (C,) arrays, masked by `valid`). A
    point's full observation list keeps the keyframe-side link only; the
    dump row M-1 is left as it was."""
    M, P = state.mp_obs_kf.shape
    N = state.kf_mp.shape[1]
    dev = mp_ids.device
    slot1 = dev_index(kf_slot, dev)
    ok = valid & (mp_ids >= 0) & (kp_idx >= 0)
    mp_safe = torch.where(ok, mp_ids, torch.full_like(mp_ids, M - 1)).long()
    n_cur = state.mp_n_obs[mp_safe]
    obs_slot = torch.clamp(n_cur, 0, P - 1).long()
    can = ok & (n_cur < P)
    write_m = torch.where(can, mp_safe, torch.full_like(mp_safe, M - 1))
    dump_kf = state.mp_obs_kf[M - 1].clone()
    dump_idx = state.mp_obs_idx[M - 1].clone()
    dump_n = state.mp_n_obs[M - 1].clone()
    cell = write_m * P + obs_slot
    flat_kf = state.mp_obs_kf.view(-1)
    flat_idx = state.mp_obs_idx.view(-1)
    slot_c = slot1.to(torch.int32).expand_as(kp_idx)
    _scatter_set_(flat_kf, cell, torch.where(can, slot_c, flat_kf[cell]))
    _scatter_set_(flat_idx, cell, torch.where(can, kp_idx.to(torch.int32), flat_idx[cell]))
    state.mp_n_obs.index_add_(0, write_m, can.to(torch.int32))
    state.mp_obs_kf[M - 1] = dump_kf
    state.mp_obs_idx[M - 1] = dump_idx
    state.mp_n_obs[M - 1] = dump_n
    kp_safe = torch.clamp(kp_idx, 0, N - 1).long()
    row = state.kf_mp[slot1][0]
    _scatter_set_(row, kp_safe, torch.where(ok, mp_ids.to(torch.int32), row[kp_safe]))
    state.kf_mp[slot1] = row[None]
    return state


def fuse_points(state: MapState, src: torch.Tensor, dst: torch.Tensor,
                valid: torch.Tensor) -> MapState:
    """Merge duplicated map points: every keyframe link to src[i] becomes
    dst[i], src[i] is invalidated, and its observations are appended to
    dst[i]'s list as far as it has room. A keyframe that already observes
    the winner keeps the winner's keypoint, and the loser's link there is
    erased. Of several pairs with one winner only the first is applied."""
    M, P = state.mp_obs_kf.shape
    K, N = state.kf_mp.shape
    dev = src.device
    C = src.shape[0]
    ar = torch.arange(C, device=dev)
    ok = valid & (src >= 0) & (dst >= 0) & (src != dst)
    dst_safe = torch.where(ok, dst, torch.full_like(dst, M - 1)).long()
    first = torch.full((M,), C, dtype=torch.long, device=dev)
    first.scatter_reduce_(0, dst_safe, torch.where(ok, ar, torch.full_like(ar, C)), reduce="amin")
    ok = ok & (first[dst_safe] == ar)
    src_safe = torch.where(ok, src, torch.full_like(src, M - 1)).long()

    # keyframe-side links src -> dst
    remap = torch.arange(M, dtype=torch.int32, device=dev)
    _scatter_set_(remap, src_safe, torch.where(ok, dst.to(torch.int32), remap[M - 1]))
    remap[M - 1] = M - 1
    kf_mp = torch.where(state.kf_mp >= 0, remap[torch.clamp(state.kf_mp, min=0).long()],
                        state.kf_mp)

    # invalidate the losers
    dump_valid = state.mp_valid[M - 1].clone()
    _scatter_set_(state.mp_valid, src_safe,
                  torch.where(ok, torch.zeros_like(ok), state.mp_valid[src_safe]))
    state.mp_valid[M - 1] = dump_valid

    # append loser observations to the winners, skipping keyframes that
    # already observe the winner
    lo_kf = state.mp_obs_kf[src_safe]  # (C, P)
    lo_idx = state.mp_obs_idx[src_safe]
    lv = (lo_kf >= 0) & ok[:, None]
    win_kf = state.mp_obs_kf[dst_safe]
    dup_obs = torch.any(
        lo_kf[:, :, None] == torch.where(win_kf >= 0, win_kf, torch.full_like(win_kf, -2))[:, None, :],
        dim=-1,
    )
    lv_add = lv & ~dup_obs
    base = state.mp_n_obs[dst_safe]
    slot = base[:, None] + torch.cumsum(lv_add.to(torch.int32), dim=1) - 1
    can = lv_add & (slot >= 0) & (slot < P)
    cell = (dst_safe[:, None] * P + torch.clamp(slot, 0, P - 1)).reshape(-1)
    _scatter_set_(state.mp_obs_kf.view(-1), cell, lo_kf.reshape(-1), can.reshape(-1))
    _scatter_set_(state.mp_obs_idx.view(-1), cell, lo_idx.reshape(-1), can.reshape(-1))
    state.mp_n_obs.index_add_(0, dst_safe, torch.sum(can, dim=1).to(torch.int32))

    # erase the keyframe-side links of dropped duplicate observations
    clr = (lv & dup_obs).reshape(-1)
    kcell = (torch.clamp(lo_kf, 0, K - 1).long() * N + torch.clamp(lo_idx, 0, N - 1)).reshape(-1)
    kf_flat = kf_mp.reshape(-1)
    _scatter_set_(kf_flat, kcell, torch.full_like(kcell, -1), clr)
    state.kf_mp.copy_(kf_flat.view(K, N))

    # clear the losers' observation rows
    minus1 = torch.full((1, P), -1, dtype=torch.int32, device=dev)
    _scatter_set_(state.mp_obs_kf, src_safe,
                  torch.where(ok[:, None], minus1, state.mp_obs_kf[src_safe]))
    _scatter_set_(state.mp_obs_idx, src_safe,
                  torch.where(ok[:, None], minus1, state.mp_obs_idx[src_safe]))
    _scatter_set_(state.mp_n_obs, src_safe,
                  torch.where(ok, torch.zeros_like(base), state.mp_n_obs[src_safe]))
    return state


def cull_young_points(state: MapState, current_kf, min_obs) -> Tuple[MapState, torch.Tensor]:
    """Invalidate points first seen 2-4 keyframes before `current_kf`
    that have fewer than `min_obs` observations, and clear their links in
    the 64 (at most K) most recent keyframe rows. Returns (state,
    number culled)."""
    M = state.mp_valid.shape[0]
    K, N = state.kf_mp.shape
    dev = state.kf_mp.device
    cur = dev_index(current_kf, dev)[0]
    age = cur - state.mp_first_kf
    young = (age >= 2) & (age <= 4) & (state.mp_first_kf >= 0)
    dead = state.mp_valid & young & (state.mp_n_obs < min_obs)
    recent = min(64, K)
    base = torch.clamp(cur - (recent - 1), 0, K - 1)
    slots = torch.clamp(base + torch.arange(recent, device=dev), 0, K - 1)
    rows = state.kf_mp[slots]
    linked_dead = (rows >= 0) & dead[torch.clamp(rows, 0, M - 1).long()]
    rows = torch.where(linked_dead, torch.full_like(rows, -1), rows)
    _scatter_set_(state.kf_mp, slots, rows)
    state.mp_valid.logical_and_(~dead)
    state.mp_n_obs.masked_fill_(dead, 0)
    state.mp_obs_kf.masked_fill_(dead[:, None], -1)
    state.mp_obs_idx.masked_fill_(dead[:, None], -1)
    return state, torch.sum(dead).to(torch.int32)


def keyframe_redundancy(state: MapState) -> torch.Tensor:
    """(K,) share of each keyframe's live map points that at least 3
    other keyframes observe."""
    M = state.mp_pos.shape[0]
    mp = torch.clamp(state.kf_mp, 0, M - 1).long()
    has = (state.kf_mp >= 0) & state.mp_valid[mp] & state.kf_kp_valid
    redundant = has & (state.mp_n_obs[mp] >= 4)
    n_pts = torch.clamp(torch.sum(has, dim=1), min=1)
    return torch.sum(redundant, dim=1) / n_pts


def cull_redundant_keyframe(state: MapState, lo, hi) -> Tuple[MapState, torch.Tensor]:
    """Remove at most one keyframe of slots [lo, hi) whose map points are
    more than 90 % redundant (the most redundant of the 48 slots from
    `lo`), without a host sync.

    Returns (state, info (15,) float32): [did, slot, parent, R_rel (9, row
    major), t_rel (3)], T_rel = T_culled @ inv(T_parent) at cull time, the
    parent being the nearest older live keyframe."""
    K, N = state.kf_mp.shape
    M = state.mp_pos.shape[0]
    dev = state.kf_mp.device
    lo_t = dev_index(lo, dev)[0]
    hi_t = dev_index(hi, dev)[0]
    C = min(48, K)
    ar = torch.arange(C, device=dev)
    cslots = torch.clamp(lo_t + ar, 0, K - 1)
    rows = state.kf_mp[cslots]
    mp = torch.clamp(rows, 0, M - 1).long()
    has = (rows >= 0) & state.mp_valid[mp] & state.kf_kp_valid[cslots]
    redundant = has & (state.mp_n_obs[mp] >= 4)
    n_pts = torch.clamp(torch.sum(has, dim=1), min=1)
    red_c = torch.sum(redundant, dim=1) / n_pts
    in_range = state.kf_valid[cslots] & (cslots >= lo_t) & (cslots < hi_t) & (lo_t + ar < K)
    cand_c = in_range & (red_c > 0.9)
    # (1,) indices throughout: a 0-dim index would be read on the host
    pick_c = torch.argmax(torch.where(cand_c, red_c, torch.full_like(red_c, -1.0))).reshape(1)
    did = cand_c[pick_c]
    pick = cslots[pick_c]
    slots = torch.arange(K, device=dev)
    older = state.kf_valid & (slots < pick)
    parent = torch.argmax(torch.where(older, slots, torch.full_like(slots, -1))).reshape(1)
    T_k = SE3(state.kf_R[pick][0], state.kf_t[pick][0])
    T_p = SE3(state.kf_R[parent][0], state.kf_t[parent][0])
    T_rel = T_k.compose(T_p.inverse())
    info = torch.cat([
        torch.cat([did, pick, parent]).to(torch.float32),
        T_rel.R.reshape(-1).to(torch.float32),
        T_rel.t.to(torch.float32),
    ])
    return remove_keyframe(state, pick, did[0]), info


def remove_keyframe(state: MapState, slot, apply: torch.Tensor | None = None) -> MapState:
    """Drop keyframe `slot`: scrub its observations from every map point,
    compact the observation lists (live entries first, in order), refresh
    the counts, and re-anchor points whose reference keyframe it was to
    their first remaining observer. With `apply` (a bool tensor), the map
    changes only where it is True."""
    N = state.kf_mp.shape[1]
    dev = state.kf_mp.device
    slot1 = dev_index(slot, dev)
    s = slot1[0].to(torch.int32)
    hit = state.mp_obs_kf == s
    obs_kf = torch.where(hit, torch.full_like(state.mp_obs_kf, -1), state.mp_obs_kf)
    obs_idx = torch.where(hit, torch.full_like(state.mp_obs_idx, -1), state.mp_obs_idx)
    order = torch.argsort((obs_kf < 0).to(torch.int32), dim=1, stable=True)
    obs_kf = torch.gather(obs_kf, 1, order)
    obs_idx = torch.gather(obs_idx, 1, order)
    n_obs = torch.sum(obs_kf >= 0, dim=1).to(torch.int32)
    new_ref = torch.where(state.mp_ref_kf == s, obs_kf[:, 0], state.mp_ref_kf)
    if apply is None:
        apply = torch.ones((), dtype=torch.bool, device=dev)

    def put(dst, new):
        dst.copy_(torch.where(apply, new, dst))

    put(state.mp_ref_kf, new_ref)
    put(state.mp_obs_kf, obs_kf)
    put(state.mp_obs_idx, obs_idx)
    put(state.mp_n_obs, n_obs)
    state.kf_valid[slot1] = state.kf_valid[slot1] & ~apply
    state.kf_kp_valid[slot1] = state.kf_kp_valid[slot1] & ~apply
    state.kf_mp[slot1] = torch.where(apply, torch.full((1, N), -1, dtype=torch.int32, device=dev),
                                     state.kf_mp[slot1])
    return state
