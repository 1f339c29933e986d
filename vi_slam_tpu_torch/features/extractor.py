"""ORB extraction: pyramid -> FAST -> orientation -> rBRIEF — a PyTorch
copy of the JAX package's `features/extractor.py::OrbExtractor`.

Per level, the FAST-9 response map comes from `ops/fast_kernel.resp_pref`:
the CUDA kernel for a CUDA image, the plain version for a CPU image. The
per-keypoint work then runs once for all levels over a vertical "atlas"
of the levels separated by 21 zero rows, as in the reference. All outputs
have a fixed capacity (`n_features`) with a validity mask.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from vi_slam_tpu_torch.ops import fast as fast_ops
from vi_slam_tpu_torch.ops import fast_kernel
from vi_slam_tpu_torch.ops import orb as orb_ops
from vi_slam_tpu_torch.ops import pyramid as pyr_ops
from vi_slam_tpu_torch.utils.config import ExtractorConfig


class Features(NamedTuple):
    """Fixed-capacity keypoint set for one image.

    xy:    (N, 2) float32 level-0 pixel coords
    level: (N,) int32 pyramid level
    angle: (N,) float32 orientation (radians)
    score: (N,) float32 detector response
    desc:  (N, 8) int32 packed 256-bit descriptors (uint32 bit patterns)
    valid: (N,) bool
    """

    xy: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    score: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor


def level_budgets(n_features: int, n_levels: int, scale_factor: float) -> List[int]:
    """Per-level keypoint budgets (geometric split over the levels)."""
    f = 1.0 / scale_factor
    first = n_features * (1.0 - f) / (1.0 - f ** n_levels)
    budgets = []
    acc = 0
    for l in range(n_levels):
        if l == n_levels - 1:
            budgets.append(max(n_features - acc, 0))
        else:
            b = int(round(first * f ** l))
            budgets.append(b)
            acc += b
    return budgets


ATLAS_SEP = 21  # zero rows between stacked levels (>= patch and SAD reach)


def atlas_row_offsets(shapes, budgets) -> List[int]:
    """Starting atlas row of each level (-1 for a level with no budget)."""
    offs, row = [], 0
    for (h, _w), b in zip(shapes, budgets):
        if b <= 0:
            offs.append(-1)
            continue
        offs.append(row)
        row += h + ATLAS_SEP
    return offs


class OrbExtractor:
    """ORB extraction for one image geometry on one device."""

    def __init__(self, cfg: ExtractorConfig, height: int, width: int, device="cpu"):
        self.cfg = cfg
        self.height = height
        self.width = width
        self.device = torch.device(device)
        self.shapes = pyr_ops.level_shapes(height, width, cfg.n_levels, cfg.scale_factor)
        self.scales = pyr_ops.scale_factors(cfg.n_levels, cfg.scale_factor)
        self.budgets = level_budgets(cfg.n_features, cfg.n_levels, cfg.scale_factor)
        self.row_offsets = atlas_row_offsets(self.shapes, self.budgets)
        self._stencils = None
        self._pyr_weights = None

    def stencils(self) -> torch.Tensor:
        """The rBRIEF stencil matrix on this extractor's device, made on
        first use."""
        if self._stencils is None:
            self._stencils = torch.from_numpy(orb_ops.stencil_matrix()).to(self.device)
        return self._stencils

    def pyramid_weights(self):
        """The per-level resize weights on this extractor's device, made
        on first use."""
        if self._pyr_weights is None:
            self._pyr_weights = pyr_ops.pyramid_weights(
                self.height, self.width, self.cfg.n_levels, self.cfg.scale_factor, self.device
            )
        return self._pyr_weights

    def __call__(self, image: torch.Tensor) -> Features:
        return self.extract(image)[0]

    def extract(self, image: torch.Tensor):
        """(H, W) float32 image -> (Features, raw level atlas)."""
        cfg = self.cfg
        W = self.width
        SEP = ATLAS_SEP
        levels = pyr_ops.build_pyramid(
            image, cfg.n_levels, cfg.scale_factor, self.pyramid_weights()
        )
        xs, ys, lv, sc, va, atlas_rows, atlas_xy = [], [], [], [], [], [], []
        row = 0
        for l, img in enumerate(levels):
            budget = self.budgets[l]
            if budget <= 0:
                continue
            pref = fast_kernel.resp_pref(img, cfg.fast_threshold, cfg.fast_min_threshold)
            xy, score, valid = fast_ops.select_keypoints(pref, cfg.cell_size, budget)
            h, w = img.shape
            margin = orb_ops._PATCH_C + 2
            inb = (
                (xy[:, 0] >= margin) & (xy[:, 0] < w - margin)
                & (xy[:, 1] >= margin) & (xy[:, 1] < h - margin)
            )
            valid = valid & inb
            s = float(self.scales[l])
            xs.append(xy[:, 0] * s)
            ys.append(xy[:, 1] * s)
            lv.append(torch.full((xy.shape[0],), l, dtype=torch.int32, device=img.device))
            sc.append(score)
            va.append(valid)
            atlas_xy.append(xy + torch.tensor([0.0, row], dtype=torch.float32, device=img.device))
            atlas_rows.append(torch.nn.functional.pad(img, (0, W - w, 0, SEP)))
            row += h + SEP

        atlas = torch.cat(atlas_rows, dim=0)
        xy_atlas = torch.cat(atlas_xy, dim=0)
        angle = orb_ops.orientations(atlas, xy_atlas)
        desc = orb_ops.describe_patches(
            pyr_ops.gaussian_blur(atlas), xy_atlas, angle, self.stencils()
        )
        feats = Features(
            xy=torch.stack([torch.cat(xs), torch.cat(ys)], dim=-1),
            level=torch.cat(lv),
            angle=angle,
            score=torch.cat(sc),
            desc=desc,
            valid=torch.cat(va),
        )
        cap = cfg.n_features
        n = feats.xy.shape[0]
        if n < cap:
            pad = cap - n
            feats = Features(
                xy=torch.nn.functional.pad(feats.xy, (0, 0, 0, pad)),
                level=torch.nn.functional.pad(feats.level, (0, pad)),
                angle=torch.nn.functional.pad(feats.angle, (0, pad)),
                score=torch.nn.functional.pad(feats.score, (0, pad)),
                desc=torch.nn.functional.pad(feats.desc, (0, 0, 0, pad)),
                valid=torch.nn.functional.pad(feats.valid, (0, pad)),
            )
        elif n > cap:
            feats = Features(*(a[:cap] for a in feats))
        return feats, atlas
