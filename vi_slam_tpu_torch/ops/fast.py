"""FAST-9 corner response, 3x3 NMS and grid selection — the plain PyTorch
version of the JAX package's `ops/fast.py`.

`resp_pref` and `cell_max`, level by level, are the plain version of the
CUDA kernel in `csrc/fast_resp_pref.cu` (wrapper: `ops/fast_kernel.py`):
the CPU path runs them, and the GPU check holds the kernel to them.
`resp_pref` sums each arc's threshold excess in the same order as the
kernel, so the two agree bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle radius 3, 16 points, (dx, dy), clockwise from 12 o'clock.
CIRCLE = np.asarray(
    [
        (0, -3), (1, -3), (2, -2), (3, -1),
        (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1),
        (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)

BORDER = 3  # circle radius
ARC_LEN = 9  # FAST-9


def _circle_diffs(image: torch.Tensor) -> torch.Tensor:
    """Signed differences to the 16 circle neighbours, (16, H, W), with
    edge-replicated samples."""
    h, w = image.shape
    padded = F.pad(image[None, None], (BORDER,) * 4, mode="replicate")[0, 0]
    ds = [
        padded[BORDER + dy : BORDER + dy + h, BORDER + dx : BORDER + dx + w] - image
        for dx, dy in CIRCLE.tolist()
    ]
    return torch.stack(ds, dim=0)


def _arc_runs(mask: torch.Tensor) -> torch.Tensor:
    """(16, H, W) bool -> (H, W) int64 whose bit j is set iff the 9-arc
    starting at circle index j is all set (cyclic)."""
    weights = (1 << torch.arange(16, device=mask.device, dtype=torch.int64))
    m = torch.sum(mask.to(torch.int64) * weights[:, None, None], dim=0)
    m2 = m | (m << 16)
    run = m2
    for s in range(1, ARC_LEN):
        run = run & (m2 >> s)
    return run


def _arc_score(run: torch.Tensor, excess: torch.Tensor) -> torch.Tensor:
    """Max over valid arc starts j of the excess summed over the arc, in
    the order j, j+1, ..., j+8; 0 where no arc is valid."""
    best = torch.zeros(excess.shape[1:], dtype=excess.dtype, device=excess.device)
    for j in range(16):
        arc_sum = torch.zeros_like(best)
        for k in range(ARC_LEN):
            arc_sum = arc_sum + excess[(j + k) % 16]
        valid = ((run >> j) & 1).to(torch.bool)
        best = torch.maximum(best, torch.where(valid, arc_sum, torch.zeros_like(arc_sum)))
    return best


def _response_from_diffs(d: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 response from circle diffs (16, H, W)."""
    excess_b = torch.clamp(d - threshold, min=0.0)
    excess_d = torch.clamp(-d - threshold, min=0.0)
    return torch.maximum(
        _arc_score(_arc_runs(d > threshold), excess_b),
        _arc_score(_arc_runs(d < -threshold), excess_d),
    )


def _interior_mask(h: int, w: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= BORDER) & (ys < h - BORDER) & (xs >= BORDER) & (xs < w - BORDER)


def nms3x3(response: torch.Tensor) -> torch.Tensor:
    """Keep pixels >= all 8 neighbours (out-of-image neighbours are -inf)
    and > 0."""
    m = F.max_pool2d(response[None, None], 3, stride=1, padding=1)[0, 0]
    keep = (response >= m) & (response > 0.0)
    return torch.where(keep, response, torch.zeros_like(response))


def resp_pref(image: torch.Tensor, threshold: float, min_threshold: float) -> torch.Tensor:
    """NMS'd low-threshold response, + 1e4 where the pixel also clears the
    high threshold (the per-cell fallback preference)."""
    h, w = image.shape
    d = _circle_diffs(image)
    interior = _interior_mask(h, w, image.device)
    zero = torch.zeros_like(image)
    resp_low = torch.where(interior, _response_from_diffs(d, min_threshold), zero)
    resp_high = torch.where(interior, _response_from_diffs(d, threshold), zero)
    resp = nms3x3(resp_low)
    return torch.where((resp > 0.0) & (resp_high > 0.0), resp + 1e4, resp)


def cell_max(response: torch.Tensor, cell: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-cell winner (first maximum in row-major order within the cell):
    scores (C,), x (C,), y (C,) int32."""
    h, w = response.shape
    hc, wc = -(-h // cell), -(-w // cell)
    padded = F.pad(response, (0, wc * cell - w, 0, hc * cell - h))
    tiles = padded.reshape(hc, cell, wc, cell).permute(0, 2, 1, 3).reshape(hc * wc, cell * cell)
    idx = torch.argmax(tiles, dim=1)
    score = torch.gather(tiles, 1, idx[:, None])[:, 0]
    c = torch.arange(hc * wc, device=response.device)
    y = (c // wc) * cell + idx // cell
    x = (c % wc) * cell + idx % cell
    return score, x.to(torch.int32), y.to(torch.int32)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k values along the last axis, ties broken by lower index
    (the order `jax.lax.top_k` gives)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_from_cells(
    score: torch.Tensor, x: torch.Tensor, y: torch.Tensor, top_k_: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Global top-K over the per-cell winners: (xy (K, 2) float32 level
    coords, score (K,), valid (K,) bool)."""
    k = min(top_k_, score.shape[0])
    top_scores, top_idx = top_k(score, k)
    valid = top_scores > 0.0
    xy = torch.stack([x[top_idx].to(torch.float32), y[top_idx].to(torch.float32)], dim=-1)
    true_score = torch.where(top_scores >= 1e4, top_scores - 1e4, top_scores)
    return xy, true_score, valid


def level_picks(counts, ks, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """For `select_from_level_cells`: the level of each cell of levels
    whose cells lie one level after another (`counts[l]` each), and the
    positions of each level's top `ks[l]` (at most `counts[l]`) in the
    cells sorted by level, then by score."""
    level = np.repeat(np.arange(len(counts)), counts)
    first = np.cumsum([0] + list(counts[:-1]))
    picks = np.concatenate([f + np.arange(k) for f, k in zip(first, ks)])
    return (torch.from_numpy(level).to(device), torch.from_numpy(picks.astype(np.int64)).to(device))


def select_from_level_cells(
    score: torch.Tensor, x: torch.Tensor, y: torch.Tensor, level: torch.Tensor,
    picks: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`select_from_cells` of every level at once, concatenated: `score`,
    `x`, `y` hold the cells of all levels, one level after another;
    `level` and `picks` come from `level_picks`. One stable sort by score,
    then one by level, orders each level's cells as its own sort would."""
    order = torch.sort(score, descending=True, stable=True).indices
    order = order[torch.sort(level[order], stable=True).indices][picks]
    top_scores = score[order]
    valid = top_scores > 0.0
    xy = torch.stack([x[order].to(torch.float32), y[order].to(torch.float32)], dim=-1)
    true_score = torch.where(top_scores >= 1e4, top_scores - 1e4, top_scores)
    return xy, true_score, valid


def select_keypoints(
    pref: torch.Tensor, cell: int, top_k_: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-cell winner + global top-K: (xy (K, 2) float32 level coords,
    score (K,), valid (K,) bool)."""
    return select_from_cells(*cell_max(pref, cell), top_k_)
