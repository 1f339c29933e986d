"""Synthetic billboard worlds — a numpy copy of the JAX package's
`io/synthetic.py` (`make_trajectory`, `make_billboard_world`,
`render_billboard_image`), so that the port renders the same images from
the same seed without importing the JAX package.

Ground truth is a smooth forward motion with gentle yaw at KITTI-like
scale (metres, ~10 fps); the images are grayscale stereo renderings of
textured quads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def make_trajectory(
    n_frames: int, speed: float = 1.0, yaw_rate: float = 0.005, seed: int = 0
) -> np.ndarray:
    """(N, 4, 4) Twc camera-to-world poses: forward (+z) motion with gentle
    yaw, camera x right / y down / z forward (KITTI convention)."""
    rng = np.random.default_rng(seed)
    poses = []
    pos = np.zeros(3)
    yaw = 0.0
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])  # yaw about y (down)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = pos
        poses.append(T)
        fwd = R @ np.asarray([0.0, 0.0, 1.0])
        pos = pos + speed * fwd
        yaw += yaw_rate * (1.0 + 0.3 * np.sin(i * 0.05))
    return np.stack(poses)


class BillboardWorld(NamedTuple):
    centers: np.ndarray  # (B, 3)
    sizes: np.ndarray  # (B,)
    intensities: np.ndarray  # (B,)
    poses_wc: np.ndarray  # (N, 4, 4)
    textures: np.ndarray  # (B, G, G) per-board intensity pattern


def make_billboard_world(
    n_frames: int = 40,
    n_boards: int = 3000,
    seed: int = 1,
    speed: float = 0.8,
    yaw_rate: float = 0.004,
    texture_cells: int = 5,
) -> BillboardWorld:
    rng = np.random.default_rng(seed)
    poses = make_trajectory(n_frames, speed=speed, yaw_rate=yaw_rate, seed=seed)
    centers = poses[rng.integers(0, n_frames, n_boards), :3, 3]
    offs = np.stack(
        [
            rng.uniform(-15.0, 15.0, n_boards),
            rng.uniform(-5.0, 3.0, n_boards),
            rng.uniform(3.0, 50.0, n_boards),
        ],
        axis=-1,
    )
    intensities = rng.uniform(60.0, 255.0, n_boards)
    # per-board procedural texture: a coarse random intensity grid. A flat
    # quad makes every corner descriptor-identical (ORB aliases across
    # boards and tracking degenerates); a distinctive pattern that sticks
    # to the board gives the frontend real, repeatable structure.
    G = texture_cells
    tex = rng.uniform(30.0, 255.0, (n_boards, G, G)).astype(np.float32)
    return BillboardWorld(
        centers=centers + offs,
        sizes=rng.uniform(0.15, 0.6, n_boards),
        intensities=intensities,
        poses_wc=poses,
        textures=tex,
    )


def render_billboard_image(
    world: BillboardWorld,
    Twc: np.ndarray,
    cam_fx: float,
    cam_fy: float,
    cam_cx: float,
    cam_cy: float,
    width: int,
    height: int,
    baseline: float = 0.0,
    background: float = 20.0,
) -> np.ndarray:
    """Rasterize billboards as depth-sorted textured rectangles (approximate
    perspective: screen-aligned squares sized by depth; the texture is
    sampled in board-relative coordinates so it is view-consistent).
    baseline shifts the camera right (for the right stereo view)."""
    Rcw = Twc[:3, :3].T
    tw = Twc[:3, 3] + Twc[:3, :3] @ np.asarray([baseline, 0.0, 0.0])
    tcw = -Rcw @ tw
    pc = (Rcw @ world.centers.T).T + tcw
    z = pc[:, 2]
    vis = z > 1.0
    img = np.full((height, width), background, np.float32)
    u = cam_fx * pc[:, 0] / np.maximum(z, 1e-6) + cam_cx
    v = cam_fy * pc[:, 1] / np.maximum(z, 1e-6) + cam_cy
    half_w = cam_fx * world.sizes / np.maximum(z, 1e-6) * 0.5
    half_h = cam_fy * world.sizes / np.maximum(z, 1e-6) * 0.5
    G = world.textures.shape[1]
    order = np.argsort(-z)  # far to near
    for i in order:
        if not vis[i]:
            continue
        x0 = int(np.floor(u[i] - half_w[i]))
        x1 = int(np.ceil(u[i] + half_w[i]))
        y0 = int(np.floor(v[i] - half_h[i]))
        y1 = int(np.ceil(v[i] + half_h[i]))
        if x1 < 0 or y1 < 0 or x0 >= width or y0 >= height:
            continue
        if x1 - x0 < 1 or y1 - y0 < 1:
            continue
        x0c, x1c = max(x0, 0), min(x1, width)
        y0c, y1c = max(y0, 0), min(y1, height)
        if x1 - x0 < 4 or y1 - y0 < 4:
            # too small to resolve texture: flat fill
            img[y0c:y1c, x0c:x1c] = world.intensities[i]
            continue
        # board-relative texture coordinates (nearest-neighbour sample)
        xs = np.arange(x0c, x1c)
        ys = np.arange(y0c, y1c)
        tx = ((xs - x0) * G) // max(x1 - x0, 1)
        ty = ((ys - y0) * G) // max(y1 - y0, 1)
        tx = np.clip(tx, 0, G - 1)
        ty = np.clip(ty, 0, G - 1)
        img[y0c:y1c, x0c:x1c] = world.textures[i][np.ix_(ty, tx)]
    return img
