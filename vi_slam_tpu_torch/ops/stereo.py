"""Stereo scanline matching with subpixel SAD refinement — a PyTorch copy
of the JAX package's `ops/stereo.py::match_stereo`."""

from __future__ import annotations

from typing import NamedTuple

import torch

from vi_slam_tpu_torch.ops.hamming import hamming_matrix_bits
from vi_slam_tpu_torch.ops.match import masked_min2
from vi_slam_tpu_torch.ops.orb import unpack_bits

_W = 5  # SAD half-window
_L = 5  # disparity search half-range for the subpixel step


class StereoMatches(NamedTuple):
    u_right: torch.Tensor  # (N,) float32 subpixel right x at level 0; -1 invalid
    depth: torch.Tensor  # (N,) float32; -1 invalid
    ok: torch.Tensor  # (N,) bool


def _gather_patch(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, hw: int, hh: int):
    """(B, 2*hh+1, 2*hw+1) integer patches centred at (cx, cy), shifted
    inside the image."""
    H, W = img.shape
    ph, pw = 2 * hh + 1, 2 * hw + 1
    y0 = torch.clamp(cy - hh, 0, H - ph)
    x0 = torch.clamp(cx - hw, 0, W - pw)
    ry = torch.arange(ph, device=img.device)
    rx = torch.arange(pw, device=img.device)
    return img[(y0[:, None] + ry)[:, :, None], (x0[:, None] + rx)[:, None, :]]


def match_stereo(
    left, right, atlas_left: torch.Tensor, atlas_right: torch.Tensor,
    row_offsets: torch.Tensor, level_scales: torch.Tensor, bf: torch.Tensor,
    min_disp: float = 0.0, max_disp: float = 400.0, max_hamming: int = 80,
    use_mutual: bool = True, use_median: bool = True,
) -> StereoMatches:
    """Associate left features with right features along the row band and
    refine the disparity; the atlases are the extractor's stacked levels."""
    D = hamming_matrix_bits(unpack_bits(left.desc), unpack_bits(right.desc))
    n_lv = level_scales.shape[0]
    scale_l = level_scales[torch.clamp(left.level, 0, n_lv - 1).long()]
    band = 2.0 * scale_l
    dv = torch.abs(left.xy[:, 1:2] - right.xy[None, :, 1])
    disp = left.xy[:, 0:1] - right.xy[None, :, 0]
    level_ok = torch.abs(left.level[:, None] - right.level[None, :]) <= 1
    mask = (
        (dv <= band[:, None]) & (disp >= min_disp) & (disp <= max_disp)
        & level_ok & left.valid[:, None] & right.valid[None, :]
    )
    idx, best, _ = masked_min2(D, mask)
    idx = idx.long()
    coarse_ok = best <= max_hamming
    if use_mutual:
        Dm = torch.where(mask, D, torch.full_like(D, 1 << 14))
        bestR = torch.min(Dm, dim=0).values
        coarse_ok = coarse_ok & (best <= bestR[idx])

    inv_scale = 1.0 / scale_l
    roff = row_offsets[torch.clamp(left.level, 0, row_offsets.shape[0] - 1).long()]
    uL_lvl = left.xy[:, 0] * inv_scale
    vL_lvl = left.xy[:, 1] * inv_scale
    uR0_lvl = right.xy[idx, 0] * inv_scale

    aw = atlas_left.shape[1]
    cxL = torch.clamp(torch.round(uL_lvl).long(), 0, aw - 1)
    cy = torch.clamp(torch.round(vL_lvl).long(), 0, 1 << 20) + torch.clamp(roff, min=0).long()
    cy = torch.clamp(cy, 0, atlas_left.shape[0] - 1)
    cxR = torch.clamp(torch.round(uR0_lvl).long(), 0, aw - 1)
    patchL = _gather_patch(atlas_left, cxL, cy, _W, _W)
    strip = _gather_patch(atlas_right, cxR, cy, _W + _L, _W)
    patchL = patchL - patchL[:, _W : _W + 1, _W : _W + 1]
    sads = []
    for s in range(2 * _L + 1):
        win = strip[:, :, s : s + 2 * _W + 1]
        win = win - win[:, _W : _W + 1, _W : _W + 1]
        sads.append(torch.sum(torch.abs(win - patchL), dim=(1, 2)))
    sad = torch.stack(sads, dim=-1)
    bi = torch.argmin(sad, dim=-1)
    smin = torch.gather(sad, 1, bi[:, None])[:, 0]
    sm1 = torch.gather(sad, 1, torch.clamp(bi - 1, 0, 2 * _L)[:, None])[:, 0]
    sp1 = torch.gather(sad, 1, torch.clamp(bi + 1, 0, 2 * _L)[:, None])[:, 0]
    denom = sm1 + sp1 - 2.0 * smin
    delta = torch.where(
        denom > 1e-6, 0.5 * (sm1 - sp1) / torch.clamp(denom, min=1e-6),
        torch.zeros_like(denom),
    )
    delta = torch.clamp(delta, -1.0, 1.0)
    best_incr = (bi.to(torch.float32) - _L) + delta
    sad_valid = (bi > 0) & (bi < 2 * _L) & (roff >= 0)

    u_right = (uR0_lvl + best_incr) * scale_l
    disparity = left.xy[:, 0] - u_right
    ok = (
        coarse_ok & sad_valid & left.valid
        & (disparity > max(min_disp, 1e-3)) & (disparity <= max_disp)
    )
    if use_median:
        n = ok.shape[0]
        inf = torch.full_like(smin, float("inf"))
        sorted_sad = torch.sort(torch.where(ok, smin, inf)).values
        n_ok = torch.sum(ok)
        med = sorted_sad[torch.clamp(torch.div(n_ok - 1, 2, rounding_mode="floor"), 0, n - 1)]
        med = torch.where(torch.isfinite(med), med, torch.zeros_like(med))
        floor = (2 * _W + 1) ** 2 * 2.0
        ok = ok & (smin < torch.clamp(1.5 * 1.4 * med, min=floor))
    depth = torch.where(ok, bf / torch.clamp(disparity, min=1e-3), torch.full_like(disparity, -1.0))
    u_right = torch.where(ok, u_right, torch.full_like(u_right, -1.0))
    return StereoMatches(u_right=u_right, depth=depth, ok=ok)
