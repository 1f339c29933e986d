"""Descriptor matching by projection — a PyTorch copy of the functions of
the JAX package's `ops/match.py` that the tracking path uses."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from vi_slam_tpu_torch.ops.hamming import hamming_matrix_bits
from vi_slam_tpu_torch.ops.orb import unpack_bits

INF = 1 << 20


class Matches(NamedTuple):
    """For each query i, the matched target idx[i] (valid where ok[i])."""

    idx: torch.Tensor  # (N,) int32
    dist: torch.Tensor  # (N,) int32
    ok: torch.Tensor  # (N,) bool


def masked_min2(dist: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row best index (first minimum), best and second-best distance
    over a masked distance matrix."""
    d = torch.where(mask, dist, torch.full_like(dist, INF))
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)[None, :]
    d2 = torch.where(cols == best_idx[:, None], torch.full_like(d, INF), d)
    second = torch.min(d2, dim=1).values
    return best_idx.to(torch.int32), best, second


def search_by_projection(
    proj_uv, proj_level, proj_desc, proj_valid,
    kp_xy, kp_level, kp_desc, kp_valid,
    radius, level_scales, max_dist: int = 100, ratio: float = 0.9,
    level_slack: int = 1,
) -> Matches:
    """Match projected map points to keypoints inside a window of
    radius * scale(predicted level), under level, distance and ratio
    gates. Returns, per map point, the matched keypoint index."""
    D = hamming_matrix_bits(unpack_bits(proj_desc), unpack_bits(kp_desc))
    r = torch.as_tensor(radius, dtype=proj_uv.dtype, device=proj_uv.device)
    r = r.expand(proj_uv.shape[:1])
    lvl = torch.clamp(proj_level, 0, level_scales.shape[0] - 1).long()
    r_eff = r * level_scales[lvl]
    dx = torch.abs(proj_uv[:, 0:1] - kp_xy[None, :, 0])
    dy = torch.abs(proj_uv[:, 1:2] - kp_xy[None, :, 1])
    in_window = (dx <= r_eff[:, None]) & (dy <= r_eff[:, None])
    level_ok = torch.abs(kp_level[None, :] - proj_level[:, None]) <= level_slack
    mask = in_window & level_ok & proj_valid[:, None] & kp_valid[None, :]
    idx, best, second = masked_min2(D, mask)
    ok = (best <= max_dist) & (best.to(torch.float32) < ratio * second.to(torch.float32))
    return Matches(idx=idx, dist=best, ok=ok & proj_valid)


def resolve_duplicate_targets(m: Matches, n_targets: int) -> Matches:
    """One source per target: keep the lowest-(distance, source index)
    source claiming each target."""
    n = m.idx.shape[0]
    tgt = torch.where(m.ok, m.idx.long(), torch.full_like(m.idx, n_targets, dtype=torch.int64))
    key = m.dist.to(torch.int64) * (n + 1) + torch.arange(n, device=m.idx.device)
    best = torch.full((n_targets + 1,), torch.iinfo(torch.int64).max,
                      dtype=torch.int64, device=m.idx.device)
    best = best.scatter_reduce(0, tgt, key, reduce="amin")
    winner = best[tgt] == key
    return Matches(idx=m.idx, dist=m.dist, ok=m.ok & winner)
