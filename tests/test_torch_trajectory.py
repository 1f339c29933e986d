"""The port's trajectory writers and readers (`io/trajectory.py`) against
the JAX package's `io/trajectory.py`: the files written are byte-equal,
the values read back equal, on seeded random poses and on a rotation for
each branch of `rotation_to_quaternion` (a positive trace, and a trace <= 0
with each diagonal entry the largest); `keyframe_trajectory` reads the
live keyframes of a port map as the reference's reads the same map.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_slam_tpu.io import trajectory as ref_traj
from vi_slam_tpu.slam_map import state as ref_state
from vi_slam_tpu_torch.io import trajectory
from vi_slam_tpu_torch.slam_map import state as map_state


def _axis_angle(axis, angle):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


# one rotation for each branch of Shepperd's method: a positive trace, and
# near-half-turns about x, y and z (trace <= 0, that axis's diagonal entry
# the largest)
BRANCHES = {
    "trace": _axis_angle([0.3, -0.5, 0.8], 0.7),
    "x": _axis_angle([1.0, 0.1, -0.2], 2.9),
    "y": _axis_angle([0.15, 1.0, 0.1], 3.0),
    "z": _axis_angle([-0.1, 0.2, 1.0], 2.8),
}


def _poses(seed=0, n=12):
    """n camera-to-world poses: random rotations (and the four branch
    rotations) with random translations, and their timestamps."""
    rng = np.random.default_rng(seed)
    out = []
    for R in list(BRANCHES.values()) + [
            _axis_angle(rng.normal(size=3), rng.uniform(0, np.pi)) for _ in range(n - 4)]:
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = rng.normal(scale=5.0, size=3)
        out.append(T)
    ts = list(np.cumsum(rng.uniform(0.03, 0.1, size=n)) + 1403636579.76)
    return ts, out


def test_branch_rotations_take_their_branch():
    R = BRANCHES
    assert np.trace(R["trace"]) > 0
    for k, i in (("x", 0), ("y", 1), ("z", 2)):
        d = np.diag(R[k])
        assert np.trace(R[k]) <= 0 and np.argmax(d) == i, (k, d)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_rotation_to_quaternion_matches_reference(branch):
    R = BRANCHES[branch]
    q = trajectory.rotation_to_quaternion(R)
    assert np.array_equal(q, ref_traj.rotation_to_quaternion(R))
    np.testing.assert_allclose(np.linalg.norm(q), 1.0, atol=1e-12)


@pytest.mark.parametrize("fmt", ["kitti", "tum", "euroc"])
def test_written_files_byte_equal(tmp_path, fmt):
    ts, poses = _poses()
    got, want = tmp_path / "port.txt", tmp_path / "ref.txt"
    if fmt == "kitti":
        trajectory.save_kitti(str(got), poses)
        ref_traj.save_kitti(str(want), poses)
    else:
        getattr(trajectory, f"save_{fmt}")(str(got), ts, poses)
        getattr(ref_traj, f"save_{fmt}")(str(want), ts, poses)
    assert got.read_bytes() == want.read_bytes()
    assert len(got.read_text().splitlines()) == len(poses) + (fmt == "euroc")


def test_readers_match_reference(tmp_path):
    """load_euroc and load_kitti read the same values as the reference's,
    and round-trip the poses (EuRoC within its 7 decimals)."""
    ts, poses = _poses(seed=1)
    pe, pk = tmp_path / "t.csv", tmp_path / "t.txt"
    ref_traj.save_euroc(str(pe), ts, poses)
    ref_traj.save_kitti(str(pk), poses)
    got_ts, got = trajectory.load_euroc(str(pe))
    want_ts, want = ref_traj.load_euroc(str(pe))
    assert got_ts == want_ts
    assert all(np.array_equal(a, b) for a, b in zip(got, want)) and len(got) == len(poses)
    np.testing.assert_allclose(np.stack(got), np.stack(poses), atol=1e-6)
    np.testing.assert_allclose(got_ts, ts, atol=1e-9)
    got_k, want_k = trajectory.load_kitti(str(pk)), ref_traj.load_kitti(str(pk))
    assert all(np.array_equal(a, b) for a, b in zip(got_k, want_k)) and len(got_k) == len(poses)
    np.testing.assert_allclose(np.stack(got_k), np.stack(poses), rtol=1e-8, atol=1e-8)


def test_keyframe_trajectory_skips_culled_slots():
    """Seven keyframes written to a port map and to a reference map, slots
    2 and 5 culled: both read the same five (timestamp, camera-to-world)
    pairs, the culled slots left out."""
    K, n_kf = 10, 7
    rng = np.random.default_rng(2)
    Rs = np.stack([_axis_angle(rng.normal(size=3), rng.uniform(0, np.pi))
                   for _ in range(K)]).astype(np.float32)
    ts = rng.normal(size=(K, 3)).astype(np.float32)
    stamps = (np.arange(K) * 0.1 + 7.0).astype(np.float32)
    valid = np.arange(K) < n_kf
    valid[[2, 5]] = False
    port = map_state.allocate(K, 16, 32, 4)._replace(
        kf_R=torch.from_numpy(Rs), kf_t=torch.from_numpy(ts), kf_valid=torch.from_numpy(valid),
        kf_timestamp=torch.from_numpy(stamps))
    with jax.enable_x64(False):
        ref = ref_state.allocate(K, 16, 32, 4)._replace(
            kf_R=jnp.asarray(Rs), kf_t=jnp.asarray(ts), kf_valid=jnp.asarray(valid),
            kf_timestamp=jnp.asarray(stamps))
        want_ts, want = ref_traj.keyframe_trajectory(SimpleNamespace(map=ref, n_kf=n_kf))
    got_ts, got = trajectory.keyframe_trajectory(SimpleNamespace(map=port, n_kf=n_kf))
    assert got_ts == want_ts and len(got) == 5
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    np.testing.assert_allclose(got_ts, stamps[[0, 1, 3, 4, 6]])
