"""Trajectory export and import in the KITTI, TUM and EuRoC formats — a
numpy copy of the JAX package's `io/trajectory.py`.

Full-frame trajectories come from `trajectory_wc()` (each frame's pose
relative to its reference keyframe, so keyframe corrections reach every
frame); `keyframe_trajectory` reads the live keyframes straight from the
map. The files are written with the same formats, digit for digit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """(3, 3) -> (x, y, z, w), Shepperd's method (the branch on the
    largest of the trace and the diagonal)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.asarray([x, y, z, w])


def save_kitti(path: str, poses_wc: Sequence[np.ndarray]) -> None:
    """KITTI: the 12 row-major entries of each camera-to-world [R | t] on
    one line."""
    with open(path, "w") as f:
        for T in poses_wc:
            row = np.asarray(T)[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def save_tum(path: str, timestamps: Sequence[float], poses_wc: Sequence[np.ndarray]) -> None:
    """TUM: `t tx ty tz qx qy qz qw` a line."""
    with open(path, "w") as f:
        for t, T in zip(timestamps, poses_wc):
            T = np.asarray(T)
            q = rotation_to_quaternion(T[:3, :3])
            tr = T[:3, 3]
            f.write(f"{t:.6f} {tr[0]:.7f} {tr[1]:.7f} {tr[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def save_euroc(path: str, timestamps: Sequence[float], poses_wc: Sequence[np.ndarray]) -> None:
    """EuRoC: a header, then `t_ns,tx,ty,tz,qw,qx,qy,qz` a line
    (nanosecond stamps, the quaternion w first)."""
    with open(path, "w") as f:
        f.write("#timestamp [ns], p_x [m], p_y [m], p_z [m], "
                "q_w [], q_x [], q_y [], q_z []\n")
        for t, T in zip(timestamps, poses_wc):
            T = np.asarray(T)
            q = rotation_to_quaternion(T[:3, :3])  # (x, y, z, w)
            tr = T[:3, 3]
            f.write(f"{int(round(t * 1e9))},{tr[0]:.7f},{tr[1]:.7f},"
                    f"{tr[2]:.7f},{q[3]:.7f},{q[0]:.7f},{q[1]:.7f},"
                    f"{q[2]:.7f}\n")


def load_euroc(path: str) -> Tuple[List[float], List[np.ndarray]]:
    """An EuRoC trajectory read back: (timestamps in s, camera-to-world
    (4, 4) poses)."""
    ts, out = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            t_ns, tx, ty, tz, qw, qx, qy, qz = vals[:8]
            T = np.eye(4)
            T[:3, 3] = (tx, ty, tz)
            x, y, z, w = qx, qy, qz, qw
            T[:3, :3] = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ])
            ts.append(t_ns * 1e-9)
            out.append(T)
    return ts, out


def keyframe_trajectory(vo) -> Tuple[List[float], List[np.ndarray]]:
    """(timestamps, camera-to-world poses) of the live keyframes of a
    pipeline's active map, from the optimized map; culled slots are
    skipped."""
    m = vo.map
    R, t = m.kf_R.cpu().numpy(), m.kf_t.cpu().numpy()
    valid, stamps = m.kf_valid.cpu().numpy(), m.kf_timestamp.cpu().numpy()
    ts, out = [], []
    for s in range(vo.n_kf):
        if not bool(valid[s]):
            continue
        Tcw = np.eye(4)
        Tcw[:3, :3] = R[s]
        Tcw[:3, 3] = t[s]
        ts.append(float(stamps[s]))
        out.append(np.linalg.inv(Tcw))
    return ts, out


def load_kitti(path: str) -> List[np.ndarray]:
    """A KITTI trajectory read back: camera-to-world (4, 4) poses."""
    out = []
    with open(path) as f:
        for line in f:
            vals = np.asarray([float(v) for v in line.split()])
            T = np.eye(4)
            T[:3, :4] = vals.reshape(3, 4)
            out.append(T)
    return out
