"""Harris and Shi-Tomasi corner response — a PyTorch copy of the JAX
package's `ops/harris.py` (vilib's GPU Harris detector: Sobel gradients, a
windowed structure tensor, the k-form or min-eigenvalue response, one
corner per grid cell).

Gradients are shifted-slice differences of the edge-padded image, the
window is a box sum from 2D prefix sums (in XLA's CPU order of additions,
and with its fused multiply-adds, so the response is bit-equal to the
reference's on the CPU), and the grid selection is
`ops/fast.py`'s `cell_max` after its `nms3x3`. No pipeline calls it; it is
here so that `ops/` has all of the reference's vilib family.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from vi_slam_tpu_torch.ops import fast as fast_ops
from vi_slam_tpu_torch.utils.numerics import fma_f32, sqrt_f32


def _sobel(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sobel gradients (each scaled by 1/8) of the edge-padded image."""
    h, w = image.shape
    p = F.pad(image[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]

    def s(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = ((s(-1, 1) + 2.0 * s(0, 1) + s(1, 1))
          - (s(-1, -1) + 2.0 * s(0, -1) + s(1, -1))) * 0.125
    gy = ((s(1, -1) + 2.0 * s(1, 0) + s(1, 1))
          - (s(-1, -1) + 2.0 * s(-1, 0) + s(-1, 1))) * 0.125
    return gx, gy


def _scan(a: torch.Tensor) -> torch.Tensor:
    """Sequential prefix sums along dim 1."""
    out = [a[:, 0]]
    for i in range(1, a.shape[1]):
        out.append(out[-1] + a[:, i])
    return torch.stack(out, dim=1)


def _cumsum(a: torch.Tensor, dim: int, base: int = 16) -> torch.Tensor:
    """Prefix sums along `dim` in XLA's CPU order: sequential sums within
    blocks of `base`, plus the exclusive prefix sums of the block totals,
    taken the same way. The box sums below are differences of prefix sums
    (a cancellation), so their low digits depend on this order."""
    a = a.movedim(dim, 0)
    n = a.shape[0]
    if n <= base:
        return _scan(a[None])[0].movedim(0, dim)
    nb = -(-n // base)
    blocks = F.pad(a, (0, 0) * (a.dim() - 1) + (0, nb * base - n)).reshape(nb, base, *a.shape[1:])
    inner = _scan(blocks)
    totals = _cumsum(inner[:, -1], 0, base)
    excl = torch.cat([torch.zeros_like(totals[:1]), totals[:-1]])
    out = (inner + excl[:, None]).reshape(nb * base, *a.shape[1:])[:n]
    return out.movedim(0, dim)


def _box_sum(a: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1)^2 box sums with zero padding, from 2D prefix sums."""
    h, w = a.shape
    p = F.pad(a, (r + 1, r, r + 1, r))
    ii = _cumsum(_cumsum(p, 0), 1)
    d = 2 * r + 1
    return (ii[d:, d:] - ii[:-d, d:] - ii[d:, :-d] + ii[:-d, :-d])[:h, :w]


def harris_response(image: torch.Tensor, radius: int = 2, k: float = 0.04,
                    shi_tomasi: bool = False) -> torch.Tensor:
    """Harris (det - k trace^2) or Shi-Tomasi (smallest eigenvalue)
    response of an (H, W) float32 image; negative responses and the
    `radius + 1` border are 0."""
    gx, gy = _sobel(image)
    a = _box_sum(gx * gx, radius)
    b = _box_sum(gx * gy, radius)
    c = _box_sum(gy * gy, radius)
    # det = a * c - b * b, and the response, with the fused multiply-adds
    # that XLA's CPU compiler forms (ROADMAP H10)
    det = fma_f32(a, c, -(b * b))
    if shi_tomasi:
        tr = 0.5 * (a + c)
        disc = sqrt_f32(torch.clamp(fma_f32(tr, tr, -det), min=0.0))
        resp = tr - disc
    else:
        tr = a + c
        resp = fma_f32(-(k * tr), tr, det)
    h, w = image.shape
    ys = torch.arange(h, device=image.device)[:, None]
    xs = torch.arange(w, device=image.device)[None, :]
    m = radius + 1
    interior = (ys >= m) & (ys < h - m) & (xs >= m) & (xs < w - m)
    return torch.where(interior, torch.clamp(resp, min=0.0), torch.zeros_like(resp))


def detect_harris(image: torch.Tensor, cell: int = 32, top_k: int = 1024, radius: int = 2,
                  k: float = 0.04, rel_threshold: float = 1e-3, shi_tomasi: bool = False):
    """Grid-NMS corners: (xy (K, 2) float32, score (K,), valid (K,)). One
    winner per `cell`-pixel cell above `rel_threshold` times the image's
    largest response, the best `top_k` of them."""
    resp = fast_ops.nms3x3(harris_response(image, radius=radius, k=k, shi_tomasi=shi_tomasi))
    resp = torch.where(resp > rel_threshold * torch.max(resp), resp, torch.zeros_like(resp))
    score, x, y = fast_ops.cell_max(resp, cell)
    top_scores, top_idx = fast_ops.top_k(score, min(top_k, score.shape[0]))
    xy = torch.stack([x[top_idx].to(torch.float32), y[top_idx].to(torch.float32)], dim=-1)
    return xy, top_scores, top_scores > 0.0
