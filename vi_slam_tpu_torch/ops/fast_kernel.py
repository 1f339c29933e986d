"""Wrapper of the FAST-9 CUDA kernel (`csrc/fast_resp_pref.cu`), the port
of the TPU kernel `vi_slam_tpu/ops/fast_pallas.py::fast_resp_pref` with the
per-cell winner (`ops/fast.py::cell_max`) fused into its epilogue.

`pyramid_resp_cells` takes every level of one image pyramid and returns
the levels' preference maps and per-cell `(score, x, y)` in flat buffers
(`PyramidCells`): one kernel launch for a pyramid on a CUDA device, the
plain PyTorch version (`pyramid_resp_cells_plain`) only for a pyramid on
the CPU. There is no fallback from CUDA to the plain version: a CUDA
pyramid that the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from vi_slam_tpu_torch.ops import fast as fast_ops

MAX_LEVELS = 16
CELL_SIZES = (16, 32)  # the kernel's instantiations: tile side = cell size

# Kernel launches since the last `reset_launches()`; only the launch below
# counts.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


class TileList(NamedTuple):
    """The kernel's work list: tile side = cell size, tiles aligned to each
    level's cell grid, so the tiles of level l are its cells, numbered
    row-major from `first[l]`."""

    first: Tuple[int, ...]  # first tile of each level
    count: Tuple[int, ...]  # tiles (= cells) of each level
    total: int


@functools.lru_cache(maxsize=64)
def tile_list(shapes: Tuple[Tuple[int, int], ...], cell: int) -> TileList:
    first, count, total = [], [], 0
    for h, w in shapes:
        n = -(-h // cell) * -(-w // cell)
        first.append(total)
        count.append(n)
        total += n
    return TileList(tuple(first), tuple(count), total)


Cells = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # score f32, x i32, y i32


class PyramidCells(NamedTuple):
    """The maps and cells of every level of one pyramid, in flat buffers:
    the maps row-major one level after another, the cells in work-list
    order (level l's cells from `tiles.first[l]`, row-major)."""

    maps: torch.Tensor  # (sum of h * w,) float32
    score: torch.Tensor  # (n_cells,) float32
    xy: torch.Tensor  # (2, n_cells) int32: each winner's x and y in its level
    shapes: Tuple[Tuple[int, int], ...]
    tiles: TileList

    def level_maps(self) -> List[torch.Tensor]:
        """Each level's (H, W) map, as views of `maps`."""
        sizes = [h * w for h, w in self.shapes]
        return [m.view(hw) for m, hw in zip(self.maps.split(sizes), self.shapes)]

    def level_cells(self) -> List[Cells]:
        """Each level's (score, x, y), as views of `score` and `xy`."""
        n = self.tiles.count
        return list(zip(self.score.split(n), self.xy[0].split(n), self.xy[1].split(n)))


@functools.lru_cache(maxsize=1)
def _launcher():
    """The kernel's C entry, with its argument types, from the library
    built at first use."""
    from vi_slam_tpu_torch.kernels.build import load_library

    fn = load_library().fast_pyramid_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_args(levels: Sequence[torch.Tensor], threshold: float, min_threshold: float,
                cell: int) -> None:
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"fast_pyramid kernel takes 1 to {MAX_LEVELS} levels, got {len(levels)}")
    if cell not in CELL_SIZES:
        raise ValueError(f"fast_pyramid kernel has no cell size {cell}; it has {CELL_SIZES}")
    # -0.0 too: the kernel's sign-bit test of th - |d| needs th = +0.0 or more.
    if not all(t >= 0 and math.copysign(1.0, t) > 0 for t in (threshold, min_threshold)):
        raise ValueError(
            f"fast_pyramid kernel needs thresholds >= 0, got {threshold} and {min_threshold}"
        )
    dev = levels[0].device
    for img in levels:
        if img.device != dev:
            raise ValueError(f"fast_pyramid levels on {img.device} and {dev}")
        if img.dtype != torch.float32:
            raise TypeError(f"fast_pyramid kernel needs float32, got {img.dtype}")
        if img.dim() != 2 or img.shape[0] < 1 or img.shape[1] < 1:
            raise ValueError(f"fast_pyramid kernel needs 2-D levels, got {tuple(img.shape)}")
        if not img.is_contiguous():
            raise ValueError("fast_pyramid kernel needs contiguous levels")


def pyramid_resp_cells_cuda(
    levels: Sequence[torch.Tensor], threshold: float, min_threshold: float, cell: int
) -> PyramidCells:
    """One launch on PyTorch's current stream for all `levels` ((H, W)
    float32, contiguous, on one CUDA device)."""
    global launches
    _check_args(levels, threshold, min_threshold, cell)
    dev = levels[0].device
    if dev.type != "cuda":
        raise ValueError(f"fast_pyramid kernel needs CUDA tensors, got {dev}")
    shapes = tuple(tuple(img.shape) for img in levels)
    tiles = tile_list(shapes, cell)
    maps = torch.empty(sum(h * w for h, w in shapes), dtype=torch.float32, device=dev)
    score = torch.empty(tiles.total, dtype=torch.float32, device=dev)
    xy = torch.empty((2, tiles.total), dtype=torch.int32, device=dev)
    base, table, off = maps.data_ptr(), [], 0
    for img, (h, w), t0 in zip(levels, shapes, tiles.first):
        table.append((img.data_ptr(), base + 4 * off, h, w, t0))
        off += h * w
    table = np.asarray(table, dtype=np.int64)
    with torch.cuda.device(dev):
        rc = _launcher()(
            table.ctypes.data, len(levels), score.data_ptr(), xy.data_ptr(), tiles.total,
            float(min_threshold), float(threshold), cell,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fast_pyramid launch failed: cudaError {rc}")
    launches += 1
    return PyramidCells(maps, score, xy, shapes, tiles)


def pyramid_resp_cells_plain(
    levels: Sequence[torch.Tensor], threshold: float, min_threshold: float, cell: int
) -> PyramidCells:
    """The kernel's plain version: `resp_pref` and `cell_max` per level."""
    shapes = tuple(tuple(img.shape) for img in levels)
    maps = [fast_ops.resp_pref(img, threshold, min_threshold) for img in levels]
    score, x, y = zip(*(fast_ops.cell_max(m, cell) for m in maps))
    return PyramidCells(
        torch.cat([m.reshape(-1) for m in maps]), torch.cat(score),
        torch.stack([torch.cat(x), torch.cat(y)]), shapes, tile_list(shapes, cell),
    )


def pyramid_resp_cells(
    levels: Sequence[torch.Tensor], threshold: float, min_threshold: float, cell: int
) -> PyramidCells:
    """FAST-9 + NMS + high-threshold preference map and per-cell winner of
    every level of one pyramid: the CUDA kernel for CUDA levels, the plain
    version for CPU levels."""
    if all(img.device.type == "cpu" for img in levels):
        return pyramid_resp_cells_plain(levels, threshold, min_threshold, cell)
    return pyramid_resp_cells_cuda(levels, threshold, min_threshold, cell)
