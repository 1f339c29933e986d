"""Synthetic worlds — a numpy copy of the parts of the JAX package's
`io/synthetic.py` that the port's tests and `chip_smoke.py` need, so that
the port renders the same frames from the same seed without importing the
JAX package:

  * billboard worlds (`make_trajectory`, `make_billboard_world`,
    `render_billboard_image`): grayscale stereo renderings of textured
    quads along a smooth forward motion with gentle yaw, at KITTI-like
    scale (metres, ~10 fps), and their depth maps
    (`render_billboard_depth`, for RGB-D);
  * oracle features (`make_landmark_world`, `flip_descriptor_bits`,
    `render_oracle_frame`): 3D landmarks with fixed random descriptors,
    projected with noise, for tests without the image frontend;
  * the drifted ring of the JAX package's loop-closing test
    (`make_drifted_ring`, tests/test_loop_closing.py), a ready-made map;
  * the closed-loop world of `bench.py --loop`
    (`make_inertial_world(closed_loop=True)`'s trajectory and landmarks,
    `make_billboard_inertial_sequence`), and the IMU stream of that world
    (`InertialWorld`), for the stereo-inertial pipeline.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

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


class LandmarkWorld(NamedTuple):
    points: np.ndarray  # (L, 3) world positions
    desc: np.ndarray  # (L, 8) uint32 descriptors
    poses_wc: np.ndarray  # (N, 4, 4) ground-truth Twc


def _corridor_landmarks(rng, poses, n_frames, n_landmarks, half_width):
    """Landmarks scattered in a corridor around the path, biased forward,
    with random descriptors."""
    centers = poses[rng.integers(0, n_frames, n_landmarks), :3, 3]
    offs = np.stack(
        [
            rng.uniform(-half_width, half_width, n_landmarks),
            rng.uniform(-4.0, 2.0, n_landmarks),
            rng.uniform(2.0, 45.0, n_landmarks),
        ],
        axis=-1,
    )
    desc = rng.integers(0, 2 ** 32, size=(n_landmarks, 8), dtype=np.uint32)
    return LandmarkWorld(points=centers + offs, desc=desc, poses_wc=poses)


def make_landmark_world(
    n_frames: int = 60,
    n_landmarks: int = 4000,
    corridor_half_width: float = 12.0,
    seed: int = 0,
    speed: float = 1.0,
    yaw_rate: float = 0.005,
) -> LandmarkWorld:
    rng = np.random.default_rng(seed)
    poses = make_trajectory(n_frames, speed=speed, yaw_rate=yaw_rate, seed=seed)
    return _corridor_landmarks(rng, poses, n_frames, n_landmarks, corridor_half_width)


def flip_descriptor_bits(desc: np.ndarray, n_bits: int, rng: np.random.Generator) -> np.ndarray:
    """Descriptor noise: flip n_bits random bits per descriptor."""
    out = desc.copy()
    n = desc.shape[0]
    for _ in range(n_bits):
        word = rng.integers(0, 8, n)
        bit = rng.integers(0, 32, n).astype(np.uint32)
        out[np.arange(n), word] ^= (np.uint32(1) << bit)
    return out


class OracleFrame(NamedTuple):
    """Per-frame oracle observations (visible landmarks projected)."""

    xy: np.ndarray  # (V, 2) pixel positions (left)
    uright: np.ndarray  # (V,) right-image u
    depth: np.ndarray  # (V,)
    desc: np.ndarray  # (V, 8) uint32
    landmark_id: np.ndarray  # (V,) ground-truth association
    level: np.ndarray  # (V,) simulated pyramid level


def render_oracle_frame(
    world: LandmarkWorld,
    frame_idx: int,
    cam_fx: float,
    cam_fy: float,
    cam_cx: float,
    cam_cy: float,
    bf: float,
    width: int,
    height: int,
    max_features: int = 1200,
    px_noise: float = 0.3,
    desc_noise_bits: int = 8,
    seed: int = 100,
) -> OracleFrame:
    rng = np.random.default_rng(seed + frame_idx)
    Twc = world.poses_wc[frame_idx]
    Rcw = Twc[:3, :3].T
    tcw = -Rcw @ Twc[:3, 3]
    pc = (Rcw @ world.points.T).T + tcw
    z = pc[:, 2]
    u = cam_fx * pc[:, 0] / np.maximum(z, 1e-6) + cam_cx
    v = cam_fy * pc[:, 1] / np.maximum(z, 1e-6) + cam_cy
    ur = u - bf / np.maximum(z, 1e-6)
    # each landmark has an intrinsic scale: d0 is the distance at which it
    # is detected at pyramid level 0, and it is visible within its
    # 8-octave band
    d0 = np.exp(
        np.random.default_rng(777).uniform(np.log(8.0), np.log(70.0), world.points.shape[0])
    )
    lvl_f = np.log(d0 / np.maximum(z, 1e-6)) / np.log(1.2)
    vis = (
        (z > 1.0) & (z < 60.0)
        & (u >= 5) & (u < width - 5) & (v >= 5) & (v < height - 5)
        & (lvl_f > -0.5) & (lvl_f < 7.5)
    )
    ids = np.where(vis)[0]
    if ids.shape[0] > max_features:
        # the lowest ids, so consecutive frames see a consistent set
        ids = np.sort(ids)[:max_features]
    u = u[ids] + rng.normal(0, px_noise, ids.shape[0])
    v = v[ids] + rng.normal(0, px_noise, ids.shape[0])
    ur = ur[ids] + rng.normal(0, px_noise, ids.shape[0])
    desc = flip_descriptor_bits(world.desc[ids], desc_noise_bits, rng)
    level = np.clip(np.round(lvl_f[ids]).astype(int), 0, 7)
    return OracleFrame(
        xy=np.stack([u, v], axis=-1), uright=ur, depth=z[ids], desc=desc,
        landmark_id=ids, level=level.astype(np.int32),
    )


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


def _render_pair(world, Twc, fx, fy, cx, cy, width, height, baseline):
    return (render_billboard_image(world, Twc, fx, fy, cx, cy, width, height, baseline=0.0),
            render_billboard_image(world, Twc, fx, fy, cx, cy, width, height,
                                   baseline=baseline))


def render_stereo_pairs(world: BillboardWorld, poses, fx: float, fy: float, cx: float,
                        cy: float, width: int, height: int, baseline: float,
                        pool=None) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The (left, right) renderings of `world` at each of `poses`, the
    right camera `baseline` metres to the right. Given a
    `multiprocessing` pool, its workers render the pairs (the same images,
    each pair rendered independently)."""
    args = [(world, T, fx, fy, cx, cy, width, height, baseline) for T in poses]
    if pool is None:
        return [_render_pair(*a) for a in args]
    # one chunk pickles the world once for all its tasks
    return pool.starmap(_render_pair, args, chunksize=max(1, len(args) // 32))


def render_billboard_depth(
    world: BillboardWorld,
    Twc: np.ndarray,
    cam_fx: float,
    cam_fy: float,
    cam_cx: float,
    cam_cy: float,
    width: int,
    height: int,
    far: float = 50.0,
) -> np.ndarray:
    """A z-buffer of the billboards seen from Twc (metres, `far` where no
    board is): each board in front of z = 1 filled far to near as the
    screen-aligned rectangle that `render_billboard_image` draws. The
    depth maps of the JAX package's RGB-D test (tests/test_lifecycle.py),
    for RGB-D ingest."""
    Rcw = Twc[:3, :3].T
    tcw = -Rcw @ Twc[:3, 3]
    pc = (Rcw @ world.centers.T).T + tcw
    z = pc[:, 2]
    depth = np.full((height, width), far, np.float32)
    u = cam_fx * pc[:, 0] / np.maximum(z, 1e-6) + cam_cx
    v = cam_fy * pc[:, 1] / np.maximum(z, 1e-6) + cam_cy
    half_w = cam_fx * world.sizes / np.maximum(z, 1e-6) * 0.5
    half_h = cam_fy * world.sizes / np.maximum(z, 1e-6) * 0.5
    for i in np.argsort(-z):
        if z[i] <= 1.0:
            continue
        x0 = max(int(np.floor(u[i] - half_w[i])), 0)
        x1 = min(int(np.ceil(u[i] + half_w[i])), width)
        y0 = max(int(np.floor(v[i] - half_h[i])), 0)
        y1 = min(int(np.ceil(v[i] + half_h[i])), height)
        if x0 < x1 and y0 < y1:
            depth[y0:y1, x0:x1] = z[i]
    return depth


def _roty(y):
    c, s = np.cos(y), np.sin(y)
    R = np.zeros((*np.shape(y), 3, 3))
    R[..., 0, 0] = c
    R[..., 0, 2] = s
    R[..., 1, 1] = 1.0
    R[..., 2, 0] = -s
    R[..., 2, 2] = c
    return R


class InertialWorld(NamedTuple):
    """A LandmarkWorld with its synchronized IMU stream."""

    world: LandmarkWorld
    imu_per_frame: List[np.ndarray]  # frame i: (n_i, 7) [t, acc3, gyro3] in (t_{i-1}, t_i]
    vel_w: np.ndarray  # (N, 3) true body velocity at the frame times
    gravity_w: np.ndarray  # (3,) gravity in the world frame
    bias_gyro: np.ndarray  # (3,) true constant gyro bias
    bias_acc: np.ndarray  # (3,)
    timestamps: np.ndarray  # (N,) frame times


def make_inertial_world(
    n_frames: int = 40,
    fps: float = 10.0,
    imu_rate: float = 200.0,
    n_landmarks: int = 6000,
    corridor_half_width: float = 12.0,
    seed: int = 0,
    speed: float = 1.2,
    bias_gyro=(0.002, -0.001, 0.0015),
    bias_acc=(0.05, -0.03, 0.02),
    noise_gyro: float = 1.7e-4,
    noise_acc: float = 2.0e-3,
    excitation: float = 1.0,
    closed_loop: bool = False,
    closed_loop_period_frames: int = 0,
) -> InertialWorld:
    """The reference's inertial world: a smooth analytic path in the KITTI
    camera convention (x right, y down, z forward, gravity +y), or with
    `closed_loop` a circle whose period is `closed_loop_period_frames` (the
    whole sequence by default), so that the tail re-traverses the start;
    landmarks in a corridor round it; and IMU samples at `imu_rate` from
    the closed-form motion: accel_b = R_wb^T (a_w - g_w) + b_a + noise,
    gyro_b = omega_b + b_g + noise (body frame = camera frame)."""
    rng = np.random.default_rng(seed)
    g_w = np.asarray([0.0, 9.81, 0.0])
    ax_, wx_ = 0.8 * excitation, 0.5
    ay_, wy_ = 0.15 * excitation, 0.9
    az_, wz_ = 0.5 * excitation, 0.4
    yaw0, wyaw = 0.25, 0.3

    def pos(t):
        return np.stack([ax_ * np.sin(wx_ * t), ay_ * np.sin(wy_ * t),
                         speed * t + az_ * np.sin(wz_ * t)], axis=-1)

    def vel(t):
        return np.stack([ax_ * wx_ * np.cos(wx_ * t), ay_ * wy_ * np.cos(wy_ * t),
                         speed + az_ * wz_ * np.cos(wz_ * t)], axis=-1)

    def acc(t):
        return np.stack([-ax_ * wx_ ** 2 * np.sin(wx_ * t), -ay_ * wy_ ** 2 * np.sin(wy_ * t),
                         -az_ * wz_ ** 2 * np.sin(wz_ * t)], axis=-1)

    def yaw(t):
        return yaw0 * np.sin(wyaw * t)

    def yawdot(t):
        return yaw0 * wyaw * np.cos(wyaw * t)

    if closed_loop:
        period = closed_loop_period_frames or n_frames
        w_c = 2.0 * np.pi / (period / fps)
        Rr = speed / w_c

        def pos(t):  # noqa: F811
            th = w_c * np.asarray(t)
            return np.stack([Rr * (1.0 - np.cos(th)), ay_ * np.sin(wy_ * t), Rr * np.sin(th)],
                            axis=-1)

        def vel(t):  # noqa: F811
            th = w_c * np.asarray(t)
            return np.stack([Rr * w_c * np.sin(th), ay_ * wy_ * np.cos(wy_ * t),
                             Rr * w_c * np.cos(th)], axis=-1)

        def acc(t):  # noqa: F811
            th = w_c * np.asarray(t)
            return np.stack([Rr * w_c ** 2 * np.cos(th), -ay_ * wy_ ** 2 * np.sin(wy_ * t),
                             -Rr * w_c ** 2 * np.sin(th)], axis=-1)

        def yaw(t):  # noqa: F811
            return w_c * np.asarray(t)

        def yawdot(t):  # noqa: F811
            return w_c * np.ones_like(np.asarray(t))

    t_frames = np.arange(n_frames) / fps
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    poses[:, :3, :3] = _roty(yaw(t_frames))
    poses[:, :3, 3] = pos(t_frames)
    world = _corridor_landmarks(rng, poses, n_frames, n_landmarks, corridor_half_width)

    bg = np.asarray(bias_gyro)
    ba = np.asarray(bias_acc)
    sg = noise_gyro * np.sqrt(imu_rate)
    sa = noise_acc * np.sqrt(imu_rate)
    imu_per_frame: List[np.ndarray] = [np.zeros((0, 7))]
    dt_imu = 1.0 / imu_rate
    for i in range(1, n_frames):
        ts = np.arange(t_frames[i - 1] + dt_imu, t_frames[i] + dt_imu / 2, dt_imu)
        Rwb = _roty(yaw(ts))
        a_b = np.einsum("nji,nj->ni", Rwb, acc(ts) - g_w[None, :])
        w_b = np.einsum("nji,nj->ni", Rwb,
                        np.stack([np.zeros_like(ts), yawdot(ts), np.zeros_like(ts)], -1))
        a_b = a_b + ba[None, :] + rng.normal(0, sa, a_b.shape)
        w_b = w_b + bg[None, :] + rng.normal(0, sg, w_b.shape)
        imu_per_frame.append(np.concatenate([ts[:, None], a_b, w_b], axis=1))
    return InertialWorld(world=world, imu_per_frame=imu_per_frame, vel_w=vel(t_frames),
                         gravity_w=g_w, bias_gyro=bg, bias_acc=ba, timestamps=t_frames)


def make_billboard_inertial_sequence(
    n_frames: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    bf: float,
    fps: float = 10.0,
    n_landmarks: int = 2000,
    n_boards: int = 4000,
    seed: int = 5,
    excitation: float = 1.0,
    closed_loop: bool = False,
    closed_loop_period_frames: int = 0,
    speed: float = 1.2,
    pool=None,
) -> Tuple[InertialWorld, BillboardWorld, List]:
    """The image sequence along the inertial world's trajectory (the world
    of `bench.py --loop` with closed_loop=True, and of
    `tools/bench_vio.py`): textured billboards rendered as stereo pairs
    (in `pool`'s workers when given, see `render_stereo_pairs`).
    Returns (inertial world, billboard world, [(imgL, imgR), ...])."""
    iw = make_inertial_world(
        n_frames=n_frames, fps=fps, n_landmarks=n_landmarks, seed=seed,
        excitation=excitation, speed=speed, closed_loop=closed_loop,
        closed_loop_period_frames=closed_loop_period_frames,
    )
    poses = iw.world.poses_wc
    rng = np.random.default_rng(seed + 2)
    centers = poses[rng.integers(0, n_frames, n_boards), :3, 3]
    offs = np.stack(
        [rng.uniform(-14.0, 14.0, n_boards),
         rng.uniform(-6.0, 3.0, n_boards),
         rng.uniform(2.0, 45.0, n_boards)], axis=-1,
    )
    G = 5
    bw = BillboardWorld(
        centers=centers + offs,
        sizes=rng.uniform(0.15, 0.7, n_boards),
        intensities=rng.uniform(60.0, 255.0, n_boards),
        poses_wc=poses,
        textures=rng.uniform(30.0, 255.0, (n_boards, G, G)).astype(np.float32),
    )
    frames = render_stereo_pairs(bw, poses[:n_frames], fx, fy, cx, cy, width, height, bf / fx,
                                 pool=pool)
    return iw, bw, frames


def make_board_ring_loop(n_frames: int, period_frames: int, radius: float,
                         n_boards: int = 1500, seed: int = 11,
                         board_seed: int = 13) -> BillboardWorld:
    """A closed circle of `radius` metres driven once every `period_frames`
    frames at 10 frames/s (`make_inertial_world(closed_loop=True)`), inside
    a ring of `n_boards` textured boards 4-25 m beyond the circle, all round
    it: every part of the circle looks at boards, so that tracking holds
    through the turn and the frames after one period re-see the start."""
    w_c = 2 * np.pi / (period_frames / 10.0)
    world = make_inertial_world(n_frames=n_frames, fps=10.0, n_landmarks=10, seed=seed,
                                speed=radius * w_c, closed_loop=True,
                                closed_loop_period_frames=period_frames).world
    rng = np.random.default_rng(board_seed)
    ang = rng.uniform(0, 2 * np.pi, n_boards)
    rad = rng.uniform(radius + 4, radius + 25, n_boards)
    centers = np.stack([radius - rad * np.cos(ang), rng.uniform(-3, 2, n_boards),
                        rad * np.sin(ang)], -1)
    return BillboardWorld(
        centers=centers, sizes=rng.uniform(0.3, 1.2, n_boards),
        intensities=rng.uniform(60, 255, n_boards), poses_wc=world.poses_wc,
        textures=rng.uniform(30, 255, (n_boards, 5, 5)).astype(np.float32))


# ---------------------------------------------------------------- the ring

RING_KFS = 12
RING_KPS = 256
RING_RADIUS = 10.0
RING_CAM = (300.0, 300.0, 160.0, 120.0)  # fx, fy, cx, cy of a 320x240 image


def _rodrigues(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * K @ K


def ring_pose(k: int) -> np.ndarray:
    """World->camera pose of ring keyframe k: the camera on the circle,
    looking along its tangent."""
    th = 2 * np.pi * k / RING_KFS
    c = np.array([RING_RADIUS * np.cos(th), RING_RADIUS * np.sin(th), 0.0])
    fwd = np.array([-np.sin(th), np.cos(th), 0.0])
    up = np.array([0.0, 0.0, 1.0])
    Rwc = np.stack([np.cross(fwd, up), -up, fwd], axis=1)
    T = np.eye(4)
    T[:3, :3] = Rwc.T
    T[:3, 3] = -Rwc.T @ c
    return T


def _ring_warp(k: int) -> np.ndarray:
    """The odometric drift of era k, a world-frame warp growing along the
    ring."""
    a = k / (RING_KFS - 1)
    W = np.eye(4)
    W[:3, :3] = _rodrigues(np.array([0.0, 0.0, 0.06 * a]))
    W[:3, 3] = [0.25 * a, -0.35 * a, 0.1 * a]
    return W


def make_drifted_ring(bf: float = 0.0):
    """The loop-closing test map of the JAX package
    (tests/test_loop_closing.py), in numpy: 12 keyframes on a circle of
    10 m whose odometry drifts, 500 physical points each owned by its first
    observer and expressed in that era's warped frame, and the seam (the
    points of keyframes 0-1 seen again by the last two) duplicated as
    late-era points. With bf > 0 each observation gets u_right = u - bf/z
    in its era's frame.

    Returns (map arrays by MapState field, in the reference's dtypes;
    the 500 descriptors (uint32); {physical point: seam duplicate id};
    (true rotations, true translations) of the keyframes)."""
    from vi_slam_tpu_torch.slam_map import state as map_state

    fx, fy, cx, cy = RING_CAM
    rng = np.random.default_rng(11)
    n_phys = 500
    ang = np.linspace(0, 2 * np.pi, n_phys, endpoint=False)
    pts = np.stack([(RING_RADIUS + 1.0 + rng.uniform(0, 4, n_phys)) * np.cos(ang),
                    (RING_RADIUS + 1.0 + rng.uniform(0, 4, n_phys)) * np.sin(ang),
                    rng.uniform(-1.5, 1.5, n_phys)], axis=1)
    desc = rng.integers(0, 2 ** 32, size=(n_phys, 8), dtype=np.uint32)
    T_gt = [ring_pose(k) for k in range(RING_KFS)]
    vis = np.zeros((RING_KFS, n_phys), bool)
    uv_all = np.zeros((RING_KFS, n_phys, 2))
    for k in range(RING_KFS):
        pc = pts @ T_gt[k][:3, :3].T + T_gt[k][:3, 3]
        z = np.where(np.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
        uv = np.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], -1)
        vis[k] = (pc[:, 2] > 1.0) & (uv[:, 0] > 10) & (uv[:, 0] < 310) & (uv[:, 1] > 10) & (uv[:, 1] < 230)
        uv_all[k] = uv

    P = 8
    d = {k: v.copy() for k, v in map_state.map_state_to_numpy(
        map_state.allocate(16, RING_KPS, 4096, P)).items()}
    owner = np.full(n_phys, -1, np.int32)
    for k in range(RING_KFS):
        owner[np.flatnonzero(vis[k] & (owner < 0))] = k
    W = [_ring_warp(k) for k in range(RING_KFS)]
    d["kf_R"][:] = 0.0  # the free slots hold zeros, as in the reference test's map
    for k in range(RING_KFS):
        Td = T_gt[k] @ np.linalg.inv(W[k])
        d["kf_R"][k], d["kf_t"][k], d["kf_valid"][k] = Td[:3, :3], Td[:3, 3], True

    n_mp = [0]

    def add_point(m, k):
        i = n_mp[0]
        d["mp_pos"][i] = W[k][:3, :3] @ pts[m] + W[k][:3, 3]
        d["mp_desc"][i] = desc[m]
        d["mp_valid"][i] = True
        d["mp_ref_kf"][i] = k
        n_mp[0] += 1
        return i

    phys_to_mp = np.full(n_phys, -1, np.int32)
    for m in range(n_phys):
        if owner[m] >= 0:
            phys_to_mp[m] = add_point(m, owner[m])
    late = [RING_KFS - 2, RING_KFS - 1]
    seam_dup = {}
    for m in range(n_phys):
        if owner[m] in (0, 1) and any(vis[k, m] for k in late):
            seam_dup[m] = add_point(m, min(k for k in late if vis[k, m]))
    for k in range(RING_KFS):
        ids = np.flatnonzero(vis[k])
        np.random.default_rng(100 + k).shuffle(ids)
        for slot, m in enumerate(ids[:RING_KPS]):
            if k in late and m in seam_dup:
                mid = seam_dup[m]
            elif owner[m] in (0, 1) and k in late:
                continue
            else:
                mid = phys_to_mp[m]
                # late keyframes do not see early-era points (drift broke
                # those associations)
                if k in late and owner[m] not in late and 0 <= owner[m] <= RING_KFS - 4:
                    continue
            if mid < 0:
                continue
            d["kf_xy"][k, slot] = uv_all[k, m]
            d["kf_desc"][k, slot] = desc[m]
            d["kf_kp_valid"][k, slot] = True
            d["kf_mp"][k, slot] = mid
            n = d["mp_n_obs"][mid]
            if n < P:
                d["mp_obs_kf"][mid, n] = k
                d["mp_obs_idx"][mid, n] = slot
                d["mp_n_obs"][mid] += 1
    if bf > 0:
        for k in range(RING_KFS):
            sel = np.flatnonzero(d["kf_mp"][k] >= 0)
            pc = d["mp_pos"][d["kf_mp"][k, sel]] @ d["kf_R"][k].T + d["kf_t"][k]
            d["kf_uright"][k, sel] = d["kf_xy"][k, sel, 0] - bf / pc[:, 2]
    truth = (np.stack([T[:3, :3] for T in T_gt]), np.stack([T[:3, 3] for T in T_gt]))
    return d, desc, seam_dup, truth
