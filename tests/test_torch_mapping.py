"""The keyframe-rate map programs of the port against the JAX package, on the
same numpy inputs: the map lifecycle (`slam_map/state.py`), the mapping
pass's steps (`pipeline/steps.py`) and `StereoVO`'s mapping and
maintenance programs.

Inputs: the reference's own cases (tests/test_fusion.py, the two cases of
tests/test_lifecycle.py), hand-built maps that pin the scatter collisions
and ties of the reference (ROADMAP H9, H2), and a scene map: six stereo
keyframes moving through 600 random 3D points, built with the reference's
own map functions, with matched, duplicated and free keypoints.

The reference runs with x64 off on float32/int32 inputs (H1). Integer and
boolean MapState arrays must be exactly equal after the same calls; float
arrays within the tolerance each test states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_slam_tpu.cameras.base import CameraParams as RefCam
from vi_slam_tpu.features.extractor import Features as RefFeatures
from vi_slam_tpu.lie.se3 import SE3 as RefSE3
from vi_slam_tpu.pipeline import steps as ref_steps
from vi_slam_tpu.pipeline.stereo_vo import StereoVO as RefStereoVO
from vi_slam_tpu.slam_map import state as ref_state
from vi_slam_tpu.utils import config as rc
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.pipeline import steps
from vi_slam_tpu_torch.pipeline.stereo_vo import StereoVO
from vi_slam_tpu_torch.slam_map import state as map_state
from vi_slam_tpu_torch.utils.config import config_from_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run: the tests run in
    parallel workers that share the machine's cores, and torch's default
    of one thread per core in each worker oversubscribes them (spinning
    threads made these files about ten times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def x64_off():
    """A fresh context per use: one shared `jax.enable_x64(False)` object
    entered twice (nested) saves False over the True it must restore, and
    leaves x64 off for every later test in the process."""
    return jax.enable_x64(False)


@pytest.fixture(autouse=True)
def _x64_restored():
    yield
    assert jax.config.jax_enable_x64 is True, "a test left JAX's x64 mode off"


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def J(a):
    return jnp.asarray(np.asarray(a))


def to_numpy(ms):
    return {k: np.array(v) for k, v in zip(ms._fields, ms)}


def to_ref(d):
    """The reference's MapState on copies of the arrays: its keyframe-rate
    programs donate the map, which must not reach the numpy inputs."""
    with x64_off():
        return ref_state.MapState(**{k: jnp.array(v, copy=True) for k, v in d.items()})


def to_port(d):
    return map_state.map_state_from_numpy(d, device="cpu")


def assert_maps_equal(port_ms, ref_ms, rtol=1e-5, atol=1e-5, what=""):
    """Integer and boolean fields exactly equal; float fields within the
    stated tolerance."""
    got = map_state.map_state_to_numpy(port_ms)
    for name, want in zip(ref_ms._fields, ref_ms):
        want = np.asarray(want)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got[name], want, rtol=rtol, atol=atol,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=f"{what} {name}")


# ------------------------------------------------- tests/test_fusion.py


def _mini_map():
    """tests/test_fusion.py::_mini_map, in numpy: two keyframes looking at
    the same 3 physical points; keyframe 1 holds duplicates 3, 4 of ids 0, 1
    and the true id 2."""
    K, NF, M, P = 4, 16, 32, 8
    with x64_off():
        d = to_numpy(ref_state.allocate(K, NF, M, P))
    rng = np.random.default_rng(0)
    pts = np.array([[0.0, 0.0, 5.0], [1.0, 0.5, 6.0], [-1.0, -0.5, 7.0]])
    desc = rng.integers(0, 2 ** 32, size=(3, 8), dtype=np.uint32)
    d["kf_t"][1, 0] = -0.5
    d["kf_valid"][:2] = True
    d["mp_max_dist"][:] = 1.0
    for i in range(3):
        pc = pts[i]
        d["kf_xy"][0, i] = [300 * pc[0] / pc[2] + 160, 300 * pc[1] / pc[2] + 120]
        d["kf_desc"][0, i] = desc[i]
        d["kf_kp_valid"][0, i] = True
        d["kf_mp"][0, i] = i
        d["mp_pos"][i] = pts[i]
        d["mp_desc"][i] = desc[i]
        d["mp_valid"][i] = True
        d["mp_obs_kf"][i, 0] = 0
        d["mp_obs_idx"][i, 0] = i
        d["mp_n_obs"][i] = 1
        d["mp_max_dist"][i] = np.linalg.norm(pts[i])
    for i, mid in enumerate([3, 4, 2]):
        pc = pts[i] + np.array([-0.5, 0.0, 0.0])
        d["kf_xy"][1, i] = [300 * pc[0] / pc[2] + 160, 300 * pc[1] / pc[2] + 120]
        d["kf_desc"][1, i] = desc[i]
        d["kf_kp_valid"][1, i] = True
        d["kf_mp"][1, i] = mid
        if mid >= 3:
            d["mp_pos"][mid] = pts[i] + rng.normal(0, 0.01, 3)
            d["mp_desc"][mid] = desc[i]
            d["mp_valid"][mid] = True
            d["mp_max_dist"][mid] = np.linalg.norm(pts[i])
        d["mp_obs_kf"][mid, d["mp_n_obs"][mid]] = 1
        d["mp_obs_idx"][mid, d["mp_n_obs"][mid]] = i
        d["mp_n_obs"][mid] += 1
    d["mp_ref_kf"] = np.where(d["mp_valid"], 0, -1).astype(np.int32)
    return d


def _fusion_case(case, d):
    """(the reference's call, the port's call) of one tests/test_fusion.py case."""
    rcam = RefCam.make(300.0, 300.0, 160.0, 120.0, bf=0.0)
    pcam = CameraParams.make(300.0, 300.0, 160.0, 120.0, bf=0.0)
    if case == "fuse_points_merges_and_remaps":
        src, dst, ok = [3, 4], [0, 1], [True, True]
    elif case == "fuse_points_erases_duplicate_observation":
        d["kf_mp"][1, 3] = 5
        d["kf_kp_valid"][1, 3] = True
        d["mp_valid"][5] = True
        d["mp_obs_kf"][5, 0] = 1
        d["mp_obs_idx"][5, 0] = 3
        d["mp_n_obs"][5] = 1
        src, dst, ok = [5], [2], [True]
    if case.startswith("fuse_points"):
        args = (np.array(src, np.int32), np.array(dst, np.int32), np.array(ok))
        return (lambda ms: ref_state.fuse_points(ms, *map(J, args)),
                lambda ms: map_state.fuse_points(ms, *map(T, args)))
    if case == "fuse_pair_dir_merges_duplicates_and_adds_obs":
        return (lambda ms: ref_steps.fuse_pair_dir(rcam, ms, jnp.int32(0), jnp.int32(1),
                                                   jnp.asarray(True), 320.0, 240.0,
                                                   max_fuse=8, radius=6.0),
                lambda ms: steps.fuse_pair_dir(pcam, ms, 0, 1, torch.tensor(True), 320.0,
                                               240.0, max_fuse=8, radius=6.0))
    return (lambda ms: ref_steps.fuse_neighbors(rcam, ms, jnp.int32(1), 320.0, 240.0,
                                                n_window=3, max_fuse=8, radius=6.0),
            lambda ms: steps.fuse_neighbors(pcam, ms, 1, 320.0, 240.0, n_window=3,
                                            max_fuse=8, radius=6.0))


@pytest.mark.parametrize("case", [
    "fuse_points_merges_and_remaps",
    "fuse_points_erases_duplicate_observation",
    "fuse_pair_dir_merges_duplicates_and_adds_obs",
    "fuse_neighbors_eliminates_duplicates",
])
def test_fusion_matches(case):
    """The four cases of tests/test_fusion.py on both sides: maps equal
    (floats within 1e-5: normals and distances of update_point_stats), and
    the reference test's own checks hold for the port."""
    d = _mini_map()
    ref_fn, port_fn = _fusion_case(case, d)
    with x64_off():
        want = ref_fn(to_ref(d))
        want = ref_state.MapState(*[np.asarray(a) for a in want])
    got = port_fn(to_port(d))
    assert_maps_equal(got, want, what=case)
    v, n, kf_mp = N(got.mp_valid), N(got.mp_n_obs), N(got.kf_mp)
    if case == "fuse_points_merges_and_remaps":
        assert not v[3] and not v[4] and v[0] and v[1]
        assert kf_mp[1, 0] == 0 and kf_mp[1, 1] == 1 and n[0] == 2 and n[1] == 2
        assert set(N(got.mp_obs_kf)[0][:2]) == {0, 1}
    elif case == "fuse_points_erases_duplicate_observation":
        assert not v[5] and list(N(got.mp_obs_kf)[2][:n[2]]).count(1) == 1
        assert kf_mp[1, 3] == -1 and kf_mp[1, 2] == 2
    elif case == "fuse_pair_dir_merges_duplicates_and_adds_obs":
        assert v[[0, 1, 2]].all() and not v[3] and not v[4]
        assert list(kf_mp[1, :3]) == [0, 1, 2] and list(n[:3]) == [2, 2, 2]
    else:
        for pair in ([0, 3], [1, 4]):
            alive = [m for m in pair if v[m]]
            assert len(alive) == 1 and n[alive[0]] == 2
        assert v[2] and n[2] == 2
        for row in kf_mp[:2]:
            assert v[row[row >= 0]].all()


# ---------------------------------------------- tests/test_lifecycle.py


def _alloc(K, NF, M, P):
    with x64_off():
        return to_numpy(ref_state.allocate(K, NF, M, P))


@pytest.mark.parametrize("case", ["lifecycle", "clipped_recent_rows", "recent_window_of_64"])
def test_cull_young_points_matches(case):
    """tests/test_lifecycle.py::test_cull_young_points; (H9) a current
    keyframe past the last slot, where the recent-window slots clip onto
    the last row and write it several times; and a map of 128 keyframes,
    where only the 64 most recent rows lose their links to dead points."""
    if case == "recent_window_of_64":
        rng = np.random.default_rng(5)
        d = _alloc(128, 8, 256, 4)
        d["mp_valid"][:200] = True
        d["mp_first_kf"][:200] = rng.integers(90, 101, 200)
        d["mp_n_obs"][:200] = rng.integers(0, 4, 200)
        d["kf_mp"][:] = np.where(rng.uniform(size=(128, 8)) < 0.7,
                                 rng.integers(0, 200, (128, 8)), -1)
        cur = 100
    elif case == "lifecycle":
        d = _alloc(8, 16, 64, 4)
        d["mp_valid"][:3] = True
        d["mp_first_kf"][:3] = [1, 1, 4]
        d["mp_n_obs"][:3] = [1, 3, 1]
        d["kf_mp"][1, 0], d["kf_mp"][1, 1] = 0, 1
        cur = 4
    else:
        rng = np.random.default_rng(3)
        d = _alloc(8, 16, 64, 4)
        d["mp_valid"][:40] = True
        d["mp_first_kf"][:40] = rng.integers(3, 9, 40)
        d["mp_n_obs"][:40] = rng.integers(0, 4, 40)
        d["kf_mp"][:] = np.where(rng.uniform(size=(8, 16)) < 0.6,
                                 rng.integers(0, 40, (8, 16)), -1)
        d["mp_obs_kf"][:40] = rng.integers(-1, 8, (40, 4))
        cur = 10
    with x64_off():
        out, n = ref_state.cull_young_points(to_ref(d), jnp.int32(cur), jnp.int32(3))
        want = ref_state.MapState(*[np.asarray(a) for a in out])
        n = int(n)
    got, n_p = map_state.cull_young_points(to_port(d), cur, 3)
    assert_maps_equal(got, want, what=case)
    assert int(n_p) == n
    if case == "lifecycle":
        v = N(got.mp_valid)
        assert n == 1 and not v[0] and v[1] and v[2]
        assert N(got.kf_mp)[1, 0] == -1 and N(got.kf_mp)[1, 1] == 1
    else:
        assert n > 0


def test_remove_keyframe_compacts_observations_matches():
    """tests/test_lifecycle.py::test_remove_keyframe_compacts_observations."""
    d = _alloc(4, 8, 16, 4)
    d["kf_valid"][:3] = True
    d["mp_valid"][0] = True
    d["mp_ref_kf"][0] = 1
    d["mp_obs_kf"][0, :2] = [1, 2]
    d["mp_obs_idx"][0, :2] = [5, 6]
    d["mp_n_obs"][0] = 2
    with x64_off():
        want = ref_state.remove_keyframe(to_ref(d), jnp.int32(1))
    got = map_state.remove_keyframe(to_port(d), 1)
    assert_maps_equal(got, want)
    assert not bool(got.kf_valid[1])
    assert int(got.mp_obs_kf[0, 0]) == 2 and int(got.mp_obs_idx[0, 0]) == 6
    assert int(got.mp_obs_kf[0, 1]) == -1 and int(got.mp_n_obs[0]) == 1
    assert int(got.mp_ref_kf[0]) == 2


# ------------------------------------------- scatter collisions (H9)


def _obs_map():
    """Keyframes 0 and 1 live; points 0-9 observed once by keyframe 0."""
    d = _alloc(4, 8, 16, 4)
    d["kf_valid"][:2] = True
    d["kf_kp_valid"][:2] = True
    d["mp_valid"][:10] = True
    d["mp_obs_kf"][:10, 0] = 0
    d["mp_obs_idx"][:10, 0] = np.arange(10) % 8
    d["mp_n_obs"][:10] = 1
    d["kf_mp"][0] = np.arange(8)
    return d


@pytest.mark.parametrize("case", ["clipped_pad_after_real_write", "repeated_point",
                                  "full_list_and_dump_row"])
def test_register_obs_collisions_match(case):
    """register_obs's scatters where an index repeats: the result is the
    reference's (the last write wins), whatever order the device writes in.
      * a masked entry with kp_idx -1, after a real write to keypoint 0:
        it clips to keypoint 0 and rewrites the old value over the real one;
      * one point twice: one observation slot written twice (the second
        keypoint wins) and the count raised by two;
      * a point whose list is full keeps the keyframe link only, and the
        dump row M-1 comes back unchanged."""
    d = _obs_map()
    if case == "clipped_pad_after_real_write":
        mp, kp, ok = [5, 7, 2], [0, -1, 3], [True, False, True]
    elif case == "repeated_point":
        mp, kp, ok = [3, 3, 9], [4, 6, 1], [True, True, True]
    else:
        d["mp_obs_kf"][6] = [0, 2, 3, 1]
        d["mp_obs_idx"][6] = [6, 1, 1, 1]
        d["mp_n_obs"][6] = 4
        d["mp_obs_kf"][15, 0] = 3
        mp, kp, ok = [6, 15, 4], [2, 5, 7], [True, True, False]
    args = (np.array(mp, np.int32), np.array(kp, np.int32), np.array(ok))
    with x64_off():
        want = ref_state.register_obs(to_ref(d), J(args[0]), jnp.int32(1), J(args[1]),
                                      J(args[2]))
    got = map_state.register_obs(to_port(d), T(args[0]), 1, T(args[1]), T(args[2]))
    assert_maps_equal(got, want, what=case)
    kf_mp = N(got.kf_mp)
    if case == "clipped_pad_after_real_write":
        assert kf_mp[1, 0] == -1 and kf_mp[1, 3] == 2  # the real write to 0 is lost
    elif case == "repeated_point":
        assert int(got.mp_n_obs[3]) == 3
        assert list(N(got.mp_obs_idx)[3, 1:3]) == [6, -1]
    else:
        assert kf_mp[1, 2] == 6 and int(got.mp_n_obs[6]) == 4
        assert int(got.mp_obs_kf[15, 0]) == 3


def test_fuse_points_chained_pairs_match():
    """Pairs whose loser is another pair's winner, a repeated winner (only
    the first pair applies) and a pair with src == dst, on a map whose
    points share keyframes."""
    d = _obs_map()
    d["mp_obs_kf"][:10, 1] = 1
    d["mp_obs_idx"][:10, 1] = (np.arange(10) + 3) % 8
    d["mp_n_obs"][:10] = 2
    d["kf_mp"][1] = (np.arange(8) + 5) % 10
    src = np.array([1, 2, 3, 4, 5, 6], np.int32)
    dst = np.array([2, 7, 7, 4, 0, 8], np.int32)
    ok = np.array([True, True, True, True, True, False])
    with x64_off():
        want = ref_state.fuse_points(to_ref(d), J(src), J(dst), J(ok))
    got = map_state.fuse_points(to_port(d), T(src), T(dst), T(ok))
    assert_maps_equal(got, want)


# ----------------------------------------------- keyframe culling ties


def _redundant_map(tie: bool):
    """Keyframes 0-5 live; keyframes 1 and 2 see points of 4 observations
    only (1.0 redundant; with `tie` False keyframe 1 has one point of 3,
    7/8 redundant, below the 0.9 bar)."""
    K, NF, M, P = 8, 8, 64, 8
    d = _alloc(K, NF, M, P)
    rng = np.random.default_rng(4)
    d["kf_valid"][:6] = True
    d["kf_kp_valid"][:6] = True
    d["kf_R"][:6] = np.eye(3, dtype=np.float32)
    d["kf_t"][:6] = rng.normal(0, 1, (6, 3)).astype(np.float32)
    ids = np.arange(48).reshape(6, 8)
    d["kf_mp"][:6] = ids
    d["mp_valid"][:48] = True
    d["mp_n_obs"][:48] = rng.integers(1, 3, 48)
    d["mp_n_obs"][ids[1]] = 4
    d["mp_n_obs"][ids[2]] = 4
    if not tie:
        d["mp_n_obs"][ids[1, 0]] = 3
    for m in range(48):
        d["mp_obs_kf"][m, :d["mp_n_obs"][m]] = rng.choice(6, d["mp_n_obs"][m], replace=False)
        d["mp_obs_idx"][m, :d["mp_n_obs"][m]] = m % 8
    d["mp_ref_kf"][:48] = d["mp_obs_kf"][:48, 0]
    return d


@pytest.mark.parametrize("case", ["tie_takes_first", "best_wins", "empty_range"])
def test_cull_redundant_keyframe_matches(case):
    """The cull's pick is jnp.argmax over the redundancies: on a tie the
    first slot (torch.argmax takes the first index too, on the CPU and on
    the card); the parent is the nearest older live keyframe; an empty
    range culls nothing. Maps exact, info within 1e-6."""
    d = _redundant_map(tie=case != "best_wins")
    lo, hi = (1, 1) if case == "empty_range" else (1, 5)
    with x64_off():
        red_r = np.asarray(ref_state.keyframe_redundancy(to_ref(d)))
        out, info_r = ref_state.cull_redundant_keyframe(to_ref(d), jnp.int32(lo), jnp.int32(hi))
        want = ref_state.MapState(*[np.asarray(a) for a in out])
        info_r = np.asarray(info_r)
    red_p = N(map_state.keyframe_redundancy(to_port(d)))
    got, info_p = map_state.cull_redundant_keyframe(to_port(d), lo, hi)
    np.testing.assert_array_equal(red_p, red_r)
    assert_maps_equal(got, want, what=case)
    np.testing.assert_allclose(N(info_p), info_r, rtol=0, atol=1e-6)
    if case == "empty_range":
        assert info_r[0] == 0.0
    else:
        pick = 1 if case == "tie_takes_first" else 2
        assert list(info_r[:3]) == [1.0, pick, pick - 1]
        assert not bool(got.kf_valid[pick])


# ------------------------------------------------------- the scene map

CAM = dict(width=320, height=240, fx=300.0, fy=300.0, cx=160.0, cy=120.0, bf=150.0)
SK, SNF, SM, SP = 16, 256, 2048, 8
N_KF = 6


def scene_config(**ba):
    """The scene's SystemConfig (reference classes); `ba` overrides BAConfig."""
    kw = dict(max_local_kfs=6, max_local_points=512, local_ba_iters=2, mapping_fuse_window=2)
    kw.update(ba)
    return rc.SystemConfig(
        camera=rc.CameraConfig(th_depth=35.0, **CAM),
        extractor=rc.ExtractorConfig(n_features=SNF, n_levels=4),
        ba=rc.BAConfig(**kw),
        map=rc.MapConfig(max_keyframes=SK, max_points=SM, max_obs_per_point=SP),
    )


def _scene_pose(k):
    a = 0.01 * k
    Rwc = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    c = np.array([0.05 * k, 0.0, 0.4 * k])
    return Rwc.T.astype(np.float32), (-Rwc.T @ c).astype(np.float32)


def scene_map(seed=0):
    """Six stereo keyframes through 600 points, built with the reference's
    map functions (x64 off). A keypoint of a point that has a map id is
    linked to it 75 % of the time; otherwise a stereo keypoint creates a
    new point half the time (a duplicate if the point has an id), and the
    rest stay free for triangulation. Levels are per point (0-2),
    descriptors carry 0-4 flipped bits per observation."""
    rng = np.random.default_rng(seed)
    n_pts = 600
    pts = np.concatenate([rng.uniform(-8, 8, (n_pts, 1)), rng.uniform(-3, 3, (n_pts, 1)),
                          rng.uniform(6, 30, (n_pts, 1))], -1)
    base_desc = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    level = rng.integers(0, 3, n_pts)
    first_id = {}
    fx, cx, cy, bf = CAM["fx"], CAM["cx"], CAM["cy"], CAM["bf"]
    with x64_off():
        ms = ref_state.allocate(SK, SNF, SM, SP)
        for k in range(N_KF):
            R, t = _scene_pose(k)
            pc = pts @ R.T.astype(np.float64) + t
            u = fx * pc[:, 0] / pc[:, 2] + cx
            v = fx * pc[:, 1] / pc[:, 2] + cy
            vis = np.nonzero((pc[:, 2] > 1.0) & (u > 5) & (u < 315) & (v > 5) & (v < 235))[0]
            vis = rng.permutation(vis)[:SNF]
            n = len(vis)
            xy = np.zeros((SNF, 2), np.float32)
            xy[:n] = np.stack([u[vis], v[vis]], -1) + rng.normal(0, 0.3, (n, 2))
            lv = np.zeros(SNF, np.int32)
            lv[:n] = level[vis]
            desc = np.zeros((SNF, 8), np.uint32)
            desc[:n] = base_desc[vis]
            for i in range(n):
                for b in rng.integers(0, 256, rng.integers(0, 5)):
                    desc[i, b // 32] ^= np.uint32(1 << int(b % 32))
            valid = np.zeros(SNF, bool)
            valid[:n] = True
            stereo = valid & (rng.uniform(size=SNF) < 0.8)
            depth = np.full(SNF, -1.0, np.float32)
            depth[:n] = pc[vis, 2] * (1 + rng.normal(0, 0.002, n))
            depth = np.where(stereo, depth, -1.0).astype(np.float32)
            uright = np.where(stereo, xy[:, 0] - bf / np.maximum(depth, 1e-3), -1.0).astype(np.float32)
            matched = np.full(SNF, -1, np.int32)
            create = np.zeros(SNF, bool)
            for i, w in enumerate(vis):
                r = rng.uniform()
                if w in first_id and r < 0.75:
                    matched[i] = first_id[w]
                elif stereo[i] and (k == 0 or rng.uniform() < 0.5):
                    create[i] = True
            feats = RefFeatures(xy=J(xy), level=J(lv), angle=J(np.zeros(SNF, np.float32)),
                                score=J(np.ones(SNF, np.float32)), desc=J(desc), valid=J(valid))
            ms = ref_state.insert_keyframe(ms, jnp.int32(k), RefSE3(J(R), J(t)), jnp.int32(k),
                                           jnp.float32(0.1 * k), feats, J(uright), J(depth),
                                           J(matched))
            b = np.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fx, np.ones(SNF)], -1)
            pw = ((b * np.maximum(depth, 0)[:, None] - t) @ R).astype(np.float32)
            center = (-t @ R).astype(np.float32)
            ray = pw - center
            dist = np.linalg.norm(ray, axis=-1)
            normal = (ray / np.maximum(dist[:, None], 1e-9)).astype(np.float32)
            maxd = (dist * 1.2 ** lv).astype(np.float32)
            mind = (maxd / 1.2 ** 3).astype(np.float32)
            base = int(ms.mp_count[0])
            ms, ids = ref_state.create_points(
                ms, ms.mp_count[0], jnp.int32(k), J(np.arange(SNF, dtype=np.int32)), J(pw),
                J(desc), J(normal), J(mind), J(maxd), J(create))
            ids = np.asarray(ids)
            for i in np.nonzero(create)[0]:
                first_id.setdefault(vis[i], int(ids[i]))
            assert int(ms.mp_count[0]) == base + int(create.sum())
            ms = ref_state.update_point_stats(ms, J(np.where(matched >= 0, matched, SM - 1)))
        return to_numpy(ms)


@pytest.fixture(scope="module")
def scene():
    return scene_map()


def _cams():
    c = CAM
    return (RefCam.make(c["fx"], c["fy"], c["cx"], c["cy"], bf=c["bf"]),
            CameraParams.make(c["fx"], c["fy"], c["cx"], c["cy"], bf=c["bf"]))


def test_scene_map_is_realistic(scene):
    """The scene exercises what the mapping pass needs: duplicated points,
    free keypoints with stereo depth, and points seen by several keyframes."""
    assert scene["kf_count"][0] == N_KF and scene["mp_count"][0] > 300
    assert (scene["mp_n_obs"] >= 3).sum() > 50
    free = scene["kf_kp_valid"][N_KF - 1] & (scene["kf_mp"][N_KF - 1] < 0)
    assert free.sum() > 20


def _duplicate_keypoint(d, kf, a, b):
    """Make keypoint b of keyframe kf a copy of keypoint a, both free:
    equal Hamming distances everywhere, so argmin and top_k ties."""
    for name in ("kf_xy", "kf_level", "kf_angle", "kf_desc", "kf_uright", "kf_depth",
                 "kf_kp_valid"):
        d[name][kf, b] = d[name][kf, a]
    d["kf_mp"][kf, a] = d["kf_mp"][kf, b] = -1


@pytest.mark.parametrize("case", ["neighbour", "older", "ties"])
def test_match_and_triangulate_matches(scene, case):
    """Candidates of keyframe 5 against keyframe 4 (the neighbour), 2
    (older: more parallax) and, for ties, against 4 with duplicated
    keypoints on both sides (jnp.argmin and torch.argmin both take the
    first index; top_k the lower index on equal scores). Indices and the
    create mask exact; positions within 1e-3 m relative (DLT normal
    equations, see tests/test_torch_geometry.py), descriptors exact."""
    d = {k: v.copy() for k, v in scene.items()}
    kf_ref = {"neighbour": 4, "older": 2, "ties": 4}[case]
    if case == "ties":
        free5 = np.nonzero(d["kf_kp_valid"][5] & (d["kf_mp"][5] < 0))[0]
        free4 = np.nonzero(d["kf_kp_valid"][4] & (d["kf_mp"][4] < 0))[0]
        for a, b in zip(free5[:6:2], free5[1:6:2]):
            _duplicate_keypoint(d, 5, a, b)
        for a, b in zip(free4[:6:2], free4[1:6:2]):
            _duplicate_keypoint(d, 4, a, b)
    rcam, pcam = _cams()
    with x64_off():
        want = ref_steps.match_and_triangulate(rcam, to_ref(d), jnp.int32(5), jnp.int32(kf_ref),
                                               max_new=64, n_levels=4)
        want = [np.asarray(a) for a in want]
    got = steps.match_and_triangulate(pcam, to_port(d), 5, torch.tensor([kf_ref]), max_new=64,
                                      n_levels=4)
    got = [N(a) for a in got]
    got[3] = got[3].view(np.uint32)
    names = steps.TriangulationCandidates._fields
    create = want[names.index("create")]
    assert create.sum() > 5
    for name, g, w in zip(names, got, want):
        if name in ("pos", "normal", "min_dist", "max_dist"):
            np.testing.assert_allclose(g[create], w[create], rtol=1e-3, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def vo_pair():
    """A reference StereoVO and the port's (CPU) with the scene's config,
    for their keyframe-rate programs."""
    cfg = scene_config()
    with x64_off():
        ref = RefStereoVO(cfg)
    port = StereoVO(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    return ref, port


def test_fuse_pair_dir_scene_matches(scene):
    """Keyframe 5's points into keyframe 3 and back, on the scene: new
    observations and merges exact; statistics within 1e-5."""
    rcam, pcam = _cams()
    with x64_off():
        ms = to_ref(scene)
        for a, b in ((5, 3), (3, 5)):
            ms = ref_steps.fuse_pair_dir(rcam, ms, jnp.int32(a), jnp.int32(b), jnp.asarray(True),
                                         320.0, 240.0, n_levels=4)
        want = ref_state.MapState(*[np.asarray(a) for a in ms])
    ms = to_port(scene)
    for a, b in ((5, 3), (3, 5)):
        ms = steps.fuse_pair_dir(pcam, ms, a, b, torch.tensor(True), 320.0, 240.0, n_levels=4)
    assert_maps_equal(ms, want)
    assert want.mp_valid.sum() < scene["mp_valid"].sum()  # something merged
    assert want.mp_n_obs.sum() != scene["mp_n_obs"].sum()


@pytest.mark.parametrize("ref_slot", [5, 4])
def test_mapping_pass_matches(scene, vo_pair, ref_slot):
    """StereoVO's mapping pass at fuse window 2 (one neighbour fused both
    ways, then stereo triangulation against the best neighbour): the map
    after it equal, floats within 1e-4 (new point positions from the DLT
    solve)."""
    ref, port = vo_pair
    with x64_off():
        want = ref._mapping_fn(to_ref(scene), jnp.int32(ref_slot))
        want = ref_state.MapState(*[np.asarray(a) for a in want])
    got = port._mapping_pass(to_port(scene), ref_slot)
    assert_maps_equal(got, want, rtol=1e-4, atol=1e-4)
    assert want.mp_count[0] > scene["mp_count"][0]  # points were triangulated


@pytest.mark.parametrize("lo,hi", [(1, 1), (1, 4)])
def test_maintenance_matches(scene, vo_pair, lo, hi):
    """StereoVO's maintenance program (young points with fewer than 3
    observations, then one redundant keyframe of [lo, hi)): map and cull
    info equal."""
    ref, port = vo_pair
    d = {k: v.copy() for k, v in scene.items()}
    # make keyframe 2 redundant: its points seen by 4 keyframes
    pts2 = d["kf_mp"][2][d["kf_mp"][2] >= 0]
    d["mp_n_obs"][pts2] = np.maximum(d["mp_n_obs"][pts2], 4)
    with x64_off():
        out, info_r = ref._maintenance_fn(to_ref(d), jnp.int32(5), jnp.int32(3), jnp.int32(lo),
                                          jnp.int32(hi))
        want = ref_state.MapState(*[np.asarray(a) for a in out])
        info_r = np.asarray(info_r)
    got, info_p = port._maintenance_program(to_port(d), 5, 3, lo, hi)
    assert_maps_equal(got, want)
    np.testing.assert_allclose(N(info_p), info_r, rtol=0, atol=1e-5)
    assert info_r[0] == (1.0 if hi > lo else 0.0)
    assert (want.mp_valid != d["mp_valid"]).any()  # young points died
