"""Image pyramid — a PyTorch copy of the JAX package's `ops/pyramid.py`.

Each level is an anti-aliased bilinear resize of the level before. The
reference calls `jax.image.resize(..., "bilinear", antialias=True)`, which
applies one weight matrix per axis (a triangle kernel widened by
max(1/scale, 1), columns normalised to sum 1). The port builds those
matrices in numpy (float64, then float32) and applies them as two float32
matrix products, so it does not depend on how `interpolate` defines
antialiasing. The result differs from XLA's CPU result by up to about
0.01 grey levels at 313x1034 (both are f32 sums in different orders).

The LK tracker's pyramid (`build_halfsample_pyramid`) halves each level by
a 2x2 mean instead.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


def level_shapes(
    height: int, width: int, n_levels: int, scale_factor: float
) -> List[Tuple[int, int]]:
    """Static (H, W) per level."""
    shapes = []
    for l in range(n_levels):
        s = scale_factor ** l
        shapes.append((max(int(round(height / s)), 16), max(int(round(width / s)), 16)))
    return shapes


def scale_factors(n_levels: int, scale_factor: float) -> np.ndarray:
    """Per-level scale (level coords * scale = level-0 coords)."""
    return np.asarray([scale_factor ** l for l in range(n_levels)], dtype=np.float32)


@functools.lru_cache(maxsize=64)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of an antialiased linear resize along
    one axis: the formula of `jax.image.resize` (scale n_out / n_in, no
    translation), evaluated in float64."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, 1.0),
        0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def pyramid_weights(
    height: int, width: int, n_levels: int, scale_factor: float, device="cpu"
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(row weights transposed, column weights) of each level after the
    first, on `device`; an extractor keeps them for every frame."""
    shapes = level_shapes(height, width, n_levels, scale_factor)
    out = []
    for (h0, w0), (h1, w1) in zip(shapes[:-1], shapes[1:]):
        out.append((
            torch.from_numpy(resize_weights(h0, h1)).T.contiguous().to(device),
            torch.from_numpy(resize_weights(w0, w1)).to(device),
        ))
    return out


def build_pyramid(
    image: torch.Tensor, n_levels: int, scale_factor: float, weights=None
) -> List[torch.Tensor]:
    """(H, W) float32 -> list of per-level images, each resized from the
    level before it as wr^T @ level @ wc. `weights` is
    `pyramid_weights(...)` for this geometry, made here if not given."""
    h, w = image.shape
    if weights is None:
        weights = pyramid_weights(h, w, n_levels, scale_factor, image.device)
    levels = [image]
    for wr_t, wc in weights:
        levels.append(wr_t @ levels[-1] @ wc)
    return levels


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (r / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(image: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with edge replication, as shifted
    multiply-adds in the reference's order."""
    k = _gaussian_kernel1d(ksize, sigma)
    pad = ksize // 2
    h, w = image.shape
    x = torch.cat([image[:1].expand(pad, w), image, image[-1:].expand(pad, w)], dim=0)
    y = sum(float(k[i]) * x[i : i + h, :] for i in range(ksize))
    x = torch.cat([y[:, :1].expand(h, pad), y, y[:, -1:].expand(h, pad)], dim=1)
    return sum(float(k[i]) * x[:, i : i + w] for i in range(ksize))


def halfsample(image: torch.Tensor) -> torch.Tensor:
    """2x2 mean with an odd last row and column cropped: vilib's
    half-sampling, the LK tracker's pyramid step. On integer-valued input
    every level is dyadic, so the result is exact."""
    h2, w2 = image.shape[0] // 2, image.shape[1] // 2
    x = image[: h2 * 2, : w2 * 2]
    return x.reshape(h2, 2, w2, 2).mean(dim=(1, 3))


def build_halfsample_pyramid(image: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """(H, W) float32 -> `n_levels` images, each half the one before."""
    levels = [image]
    for _ in range(1, n_levels):
        levels.append(halfsample(levels[-1]))
    return levels
