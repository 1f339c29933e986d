"""ORB extraction: pyramid -> FAST -> orientation -> rBRIEF — a PyTorch
copy of the JAX package's `features/extractor.py::OrbExtractor`.

The per-cell FAST-9 winners of all levels come from one call of
`ops/fast_kernel.pyramid_resp_cells`: one CUDA kernel launch for a CUDA
image, the plain version for a CPU image; the top-k per level follows.
The per-keypoint work then runs once for all levels over a vertical
"atlas" of the levels separated by 21 zero rows, as in the reference. All
outputs have a fixed capacity (`n_features`) with a validity mask.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from vi_slam_tpu_torch.ops import fast as fast_ops
from vi_slam_tpu_torch.ops import fast_kernel
from vi_slam_tpu_torch.ops import orb as orb_ops
from vi_slam_tpu_torch.ops import pyramid as pyr_ops
from vi_slam_tpu_torch.utils.config import ExtractorConfig
from vi_slam_tpu_torch.utils.device import resolve_device


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


class _Selection(NamedTuple):
    """Constants of the keypoint selection over the levels with a budget:
    per cell of the pyramid (`fast_ops.level_picks`), and per keypoint
    slot (K = the sum of the levels' top-k)."""

    level_of_cell: torch.Tensor  # (n_cells,) int64, index into `used`
    picks: torch.Tensor  # (K,) int64
    level: torch.Tensor  # (K,) int32 pyramid level
    scale: torch.Tensor  # (K, 1) float32 level -> level-0 coordinates
    limit: torch.Tensor  # (K, 2) float32 (w, h) - margin: x, y must lie below
    atlas_offset: torch.Tensor  # (K, 2) float32 (0, the level's first atlas row)


class OrbExtractor:
    """ORB extraction for one image geometry on one device."""

    def __init__(self, cfg: ExtractorConfig, height: int, width: int, device="cuda"):
        self.cfg = cfg
        self.height = height
        self.width = width
        self.device = resolve_device(device)
        self.shapes = pyr_ops.level_shapes(height, width, cfg.n_levels, cfg.scale_factor)
        self.scales = pyr_ops.scale_factors(cfg.n_levels, cfg.scale_factor)
        self.budgets = level_budgets(cfg.n_features, cfg.n_levels, cfg.scale_factor)
        self.row_offsets = atlas_row_offsets(self.shapes, self.budgets)
        self.used = [l for l in range(cfg.n_levels) if self.budgets[l] > 0]
        self._stencils = None
        self._pyr_weights = None
        self._selection = None

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

    def selection(self) -> _Selection:
        """The per-cell and per-keypoint constants of the selection on this
        extractor's device, made on first use."""
        if self._selection is None:
            counts = fast_kernel.tile_list(
                tuple(self.shapes[l] for l in self.used), self.cfg.cell_size
            ).count
            ks = [min(self.budgets[l], n) for l, n in zip(self.used, counts)]
            level_of_cell, picks = fast_ops.level_picks(counts, ks, self.device)
            margin = orb_ops._PATCH_C + 2
            kp = np.repeat(np.arange(len(ks)), ks)
            used = np.asarray(self.used)[kp]
            hw = np.asarray(self.shapes, dtype=np.float32)[used]
            rows = np.asarray(self.row_offsets, dtype=np.float32)[used]

            def dev(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

            self._selection = _Selection(
                level_of_cell=level_of_cell,
                picks=picks,
                level=dev(used.astype(np.int32)),
                scale=dev(self.scales[used][:, None]),
                limit=dev(hw[:, ::-1] - margin),
                atlas_offset=dev(np.stack([np.zeros_like(rows), rows], axis=-1)),
            )
        return self._selection

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
        sel = self.selection()
        pc = fast_kernel.pyramid_resp_cells(
            [levels[l] for l in self.used], cfg.fast_threshold, cfg.fast_min_threshold,
            cfg.cell_size,
        )
        xy, score, valid = fast_ops.select_from_level_cells(
            pc.score, pc.xy[0], pc.xy[1], sel.level_of_cell, sel.picks
        )
        margin = orb_ops._PATCH_C + 2
        valid = valid & torch.all((xy >= margin) & (xy < sel.limit), dim=-1)
        atlas_rows = [
            torch.nn.functional.pad(levels[l], (0, W - levels[l].shape[1], 0, SEP))
            for l in self.used
        ]
        atlas = torch.cat(atlas_rows, dim=0)
        xy_atlas = xy + sel.atlas_offset
        angle = orb_ops.orientations(atlas, xy_atlas)
        desc = orb_ops.describe_patches(
            pyr_ops.gaussian_blur(atlas), xy_atlas, angle, self.stencils()
        )
        feats = Features(
            xy=xy * sel.scale,
            level=sel.level,
            angle=angle,
            score=score,
            desc=desc,
            valid=valid,
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
