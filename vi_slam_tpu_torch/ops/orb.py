"""ORB orientation and rotated-BRIEF descriptors — a PyTorch copy of the
JAX package's `ops/orb.py` (the stencil-matmul path the extractor uses).

Descriptors are 256 bits packed into 8 int32 words that hold the uint32
bit patterns of the reference (PyTorch has few uint32 operations).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

PATCH_RADIUS = 15
PATTERN_SIZE = 256
_PATTERN_SIGMA = 6.0
_PATTERN_SEED = 20260817

N_ANGLE_BINS = 32
_PATCH = 41
_PATCH_C = _PATCH // 2


def _make_pattern() -> np.ndarray:
    """(256, 4) [ax, ay, bx, by] Gaussian point pairs clipped to the patch;
    the same deterministic pattern as the reference's."""
    rng = np.random.default_rng(_PATTERN_SEED)
    pts = rng.normal(0.0, _PATTERN_SIGMA, size=(PATTERN_SIZE, 4))
    pts = np.clip(np.round(pts), -(PATCH_RADIUS - 2), PATCH_RADIUS - 2)
    return pts.astype(np.float32)


PATTERN = _make_pattern()


def _prefix_sum_cols(a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 1 by log-step shifted adds (the
    reference's summation order)."""
    n = a.shape[1]
    s = 1
    while s < n:
        a = a + torch.nn.functional.pad(a[:, : n - s], (s, 0))
        s *= 2
    return a


def moment_images(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """m10 and m01 images of the radius-15 circular patch (zero outside
    the image), from per-row prefix sums."""
    h, w = image.shape
    r = PATCH_RADIUS
    ipad = torch.nn.functional.pad(image, (r + 1, r, r, r))
    xcoord = torch.arange(ipad.shape[1], dtype=image.dtype, device=image.device) - (r + 1)
    P = _prefix_sum_cols(ipad)
    Q = _prefix_sum_cols(ipad * xcoord[None, :])
    xs = torch.arange(w, dtype=image.dtype, device=image.device)[None, :]
    m10 = torch.zeros((h, w), dtype=image.dtype, device=image.device)
    m01 = torch.zeros((h, w), dtype=image.dtype, device=image.device)
    for dy in range(-r, r + 1):
        cw = int(np.floor(np.sqrt(r * r - dy * dy)))
        Pr = P[r + dy : r + dy + h]
        Qr = Q[r + dy : r + dy + h]
        hi = r + 1 + cw
        lo = r - cw
        dP = Pr[:, hi : hi + w] - Pr[:, lo : lo + w]
        dQ = Qr[:, hi : hi + w] - Qr[:, lo : lo + w]
        m10 = m10 + (dQ - xs * dP)
        m01 = m01 + dy * dP
    return m10, m01


def _round_index(v: torch.Tensor, hi: int) -> torch.Tensor:
    return torch.clamp(torch.round(v).to(torch.int64), 0, hi)


def orientations(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """IC angles (radians) for keypoints xy (N, 2) in image coords."""
    m10, m01 = moment_images(image)
    xi = _round_index(xy[:, 0], image.shape[1] - 1)
    yi = _round_index(xy[:, 1], image.shape[0] - 1)
    return torch.atan2(m01[yi, xi], m10[yi, xi])


def _make_stencils() -> np.ndarray:
    """(BINS, 41*41, 256) float32: column p of bin b holds the bilinear
    stencil of (a-sample minus b-sample) of pair p rotated by the bin's
    angle. Same arithmetic, in the same order, as the reference's."""
    out = np.zeros((N_ANGLE_BINS, _PATCH * _PATCH, PATTERN_SIZE), np.float32)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        R = np.array([[ca, -sa], [sa, ca]], np.float32)
        for p in range(PATTERN_SIZE):
            for off, sign in ((PATTERN[p, :2], 1.0), (PATTERN[p, 2:], -1.0)):
                x, y = R @ off
                px, py = x + _PATCH_C, y + _PATCH_C
                x0, y0 = int(np.floor(px)), int(np.floor(py))
                fx, fy = px - x0, py - y0
                for (yy, xx, wgt) in (
                    (y0, x0, (1 - fx) * (1 - fy)),
                    (y0, x0 + 1, fx * (1 - fy)),
                    (y0 + 1, x0, (1 - fx) * fy),
                    (y0 + 1, x0 + 1, fx * fy),
                ):
                    out[b, yy * _PATCH + xx, p] += sign * wgt
    return out


@functools.lru_cache(maxsize=1)
def stencil_matrix() -> np.ndarray:
    """(41*41, BINS*256) float32: all bins' stencils side by side, built on
    first use (55 MB; never written to disk)."""
    S = _make_stencils()
    return np.ascontiguousarray(S.transpose(1, 0, 2).reshape(_PATCH * _PATCH, -1))


def extract_patches(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(N, 41, 41) patches at the rounded keypoint coords, shifted inside
    the image."""
    h, w = image.shape
    x0 = torch.clamp(torch.round(xy[:, 0]).to(torch.int64) - _PATCH_C, 0, w - _PATCH)
    y0 = torch.clamp(torch.round(xy[:, 1]).to(torch.int64) - _PATCH_C, 0, h - _PATCH)
    r = torch.arange(_PATCH, device=image.device)
    return image[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]]


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32 words, bit i of word k = bit 32k+i."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = torch.sum(bits.reshape(-1, 8, 32).to(torch.int64) << shifts, dim=-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 -> (..., 256) float32 {0, 1} bit matrix."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc[..., None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], 256).to(torch.float32)


def angle_bins(angle: torch.Tensor) -> torch.Tensor:
    """Nearest of the 32 angle bins; `angle % 2pi` with the sign rule of
    the reference's float remainder."""
    two_pi = 2.0 * np.pi
    m = torch.fmod(angle, two_pi)
    m = torch.where((m != 0) & (m < 0), m + two_pi, m)
    return torch.remainder(
        torch.round(m / two_pi * N_ANGLE_BINS).to(torch.int64), N_ANGLE_BINS
    )


def describe_patches(
    blurred: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor, stencils: torch.Tensor
) -> torch.Tensor:
    """rBRIEF by one (N, 1681) x (1681, 32*256) float32 product, then each
    keypoint's angle bin; returns (N, 8) int32 packed descriptors.
    `stencils` is `stencil_matrix()` on the image's device. The product
    runs in full float32 (TF32 off, `utils/device.py`)."""
    n = xy.shape[0]
    patches = extract_patches(blurred, xy).reshape(n, _PATCH * _PATCH)
    diffs = (patches @ stencils).reshape(n, N_ANGLE_BINS, PATTERN_SIZE)
    b = angle_bins(angle)
    diff = torch.gather(diffs, 1, b[:, None, None].expand(n, 1, PATTERN_SIZE))[:, 0]
    return pack_bits(diff < 0.0)
