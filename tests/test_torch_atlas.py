"""The port's atlas (`slam_map/atlas.py` and the fork and merge paths of
`StereoVO`) against the JAX package's.

  * `merge_into` and `weld_transform` as tests/test_atlas.py runs them, and
    `merge_into` on two random maps with every field filled;
  * `verify_merge` on the drifted ring of tests/test_loop_closing.py and a
    Sim3-moved copy of it, fed the reference's draws (key 23, split per
    candidate);
  * tests/test_atlas.py::atlas_run side by side: 16 mapped frames, 10
    frames of random features (past the 0.3 s grace and the 0.3 s atlas
    window: the map forks), then frames 6-15 again, where the new map
    welds back into the first. The port's merge, loop and relocalization
    samples are the reference's draws.

Equal: the frame of the fork and of the merge, every frame's state,
reference keyframe and map id, the keyframe and map-point counts, every
integer and boolean field of a merged map, and the verification's inlier
masks. Within tolerances: merged poses, points and Sim3s within 1e-5 to
1e-4 (float32 products in another order; the Sim3 through a float32 SVD
and Gauss-Newton); the atlas run's trajectories within 5e-3 m (measured
2.1e-3 m: local BA's float32 LM, ROADMAP F7/F8).

The reference runs with x64 off (a fresh `jax.enable_x64(False)` per use).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop_parts import K_KF, ReferenceDraws, build_ring, x64_off
from test_torch_reloc import _frame, _garbage, make_cfg

from vi_slam_tpu.cameras.base import CameraParams as RefCam
from vi_slam_tpu.lie.se3 import SE3 as RefSE3
from vi_slam_tpu.lie.sim3 import Sim3 as RefSim3
from vi_slam_tpu.pipeline.stereo_vo import StereoVO as RefStereoVO
from vi_slam_tpu.retrieval import vocabulary as ref_voc
from vi_slam_tpu.slam_map import atlas as ref_atlas
from vi_slam_tpu.slam_map import state as ref_state
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.io import synthetic
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.lie.sim3 import Sim3
from vi_slam_tpu_torch.pipeline.stereo_vo import StereoVO
from vi_slam_tpu_torch.retrieval import vocabulary
from vi_slam_tpu_torch.slam_map import atlas
from vi_slam_tpu_torch.slam_map.state import map_state_from_numpy, map_state_to_numpy
from vi_slam_tpu_torch.utils.config import config_from_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the test workers share
    the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _x64_restored():
    yield
    assert jax.config.jax_enable_x64 is True, "a test left JAX's x64 mode off"


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _ref_state(d):
    return ref_state.MapState(**{k: jnp.array(v, copy=True) for k, v in d.items()})


def _as_numpy(ms):
    return {k: np.array(v) for k, v in zip(ms._fields, ms)}


def _assert_maps_equal(got, want, atol):
    for name, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[name], w, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=name)


def _random_map(rng, K, N_, M, P, n_kf, n_mp):
    """Every field of a small map filled with random values of its dtype,
    the first n_kf keyframes and n_mp points allocated."""
    with x64_off():
        d = _as_numpy(ref_state.allocate(K, N_, M, P))
    for name, a in d.items():
        if a.dtype == np.bool_:
            d[name] = rng.random(a.shape) < 0.7
        elif a.dtype.kind == "f":
            d[name] = rng.normal(0, 2, a.shape).astype(a.dtype)
        elif a.dtype == np.uint32:
            d[name] = rng.integers(0, 2 ** 32, a.shape, dtype=np.uint32)
        else:
            hi = {"kf_mp": n_mp, "mp_obs_kf": n_kf, "mp_ref_kf": n_kf,
                  "mp_first_kf": n_kf}.get(name, 8)
            d[name] = rng.integers(-1, hi, a.shape).astype(a.dtype)
    d["kf_R"] = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(K)]
                         ).astype(np.float32)
    d["kf_count"] = np.array([n_kf], np.int32)
    d["mp_count"] = np.array([n_mp], np.int32)
    return d


def _merge_both(dst, src, R, t, s, kf_off, mp_off):
    with x64_off():
        S = RefSim3(jnp.asarray(R), jnp.asarray(t), jnp.asarray(s))
        want = _as_numpy(ref_atlas.merge_into(_ref_state(dst), _ref_state(src), S,
                                              jnp.int32(kf_off), jnp.int32(mp_off)))
    got = atlas.merge_into(map_state_from_numpy(dst, device="cpu"),
                           map_state_from_numpy(src, device="cpu"),
                           Sim3(T(R), T(t), T(s)), kf_off, mp_off)
    return map_state_to_numpy(got), want


def test_merge_into_offsets_and_transform():
    """tests/test_atlas.py's case: slots shift by 2, ids by 5, the world by
    +x; the relabelled links and the welded pose and point."""
    with x64_off():
        A = _as_numpy(ref_state.allocate(8, 16, 64, 4))
        B = _as_numpy(ref_state.allocate(8, 16, 64, 4))
    A["kf_count"][:] = 2
    A["mp_count"][:] = 5
    A["kf_valid"][:2] = True
    A["mp_valid"][:5] = True
    B["kf_count"][:] = 1
    B["mp_count"][:] = 3
    B["kf_valid"][0] = True
    B["mp_valid"][:3] = True
    B["kf_mp"][0, 0] = 2
    B["mp_obs_kf"][2, 0] = 0
    B["mp_obs_idx"][2, 0] = 0
    B["mp_n_obs"][2] = 1
    B["mp_pos"][2] = [3.0, 2.0, 1.0]
    B["mp_ref_kf"][2] = 0
    got, want = _merge_both(A, B, np.eye(3, dtype=np.float32), np.array([1.0, 0, 0], np.float32),
                            np.float32(1.0), 2, 5)
    _assert_maps_equal(got, want, 1e-6)
    assert got["kf_count"][0] == 3 and got["mp_count"][0] == 8 and got["kf_mp"][2, 0] == 7
    np.testing.assert_allclose(got["mp_pos"][7], [4.0, 2.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(got["kf_t"][2], [-1.0, 0.0, 0.0], atol=1e-6)


@pytest.mark.parametrize("seed,offsets", [(0, (3, 20)), (1, (6, 50))])
def test_merge_into_random_maps_match_reference(seed, offsets):
    """Random maps with every field filled and a random Sim3; the second
    case appends past the capacity (the overflowing rows are dropped)."""
    rng = np.random.default_rng(seed)
    dst = _random_map(rng, 8, 16, 64, 4, offsets[0], offsets[1])
    src = _random_map(rng, 8, 16, 64, 4, 4, 30)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R = (R * np.sign(np.linalg.det(R))).astype(np.float32)
    got, want = _merge_both(dst, src, R, rng.normal(size=3).astype(np.float32),
                            np.float32(1.3), *offsets)
    _assert_maps_equal(got, want, 1e-5)


def test_weld_transform_matches_reference():
    """tests/test_atlas.py's identity case, and random poses and Sim3."""
    rng = np.random.default_rng(4)
    cases = [(np.eye(3), [0.3, -0.2, 1.0], np.eye(3), [0.3, -0.2, 1.0], np.eye(3), np.zeros(3),
              1.0)]
    for _ in range(3):
        rot = [np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(3)]
        rot = [r * np.sign(np.linalg.det(r)) for r in rot]
        cases.append((rot[0], rng.normal(size=3), rot[1], rng.normal(size=3), rot[2],
                      rng.normal(size=3), float(np.exp(rng.normal() * 0.2))))
    for Rc, tc, Rd, td, Rs, ts, s in cases:
        f = lambda a: np.asarray(a, np.float32)
        with x64_off():
            want = ref_atlas.weld_transform(
                RefSim3(jnp.asarray(f(Rs)), jnp.asarray(f(ts)), jnp.float32(s)),
                RefSE3(jnp.asarray(f(Rc)), jnp.asarray(f(tc))),
                RefSE3(jnp.asarray(f(Rd)), jnp.asarray(f(td))))
            want = [np.asarray(x) for x in want]
        got = atlas.weld_transform(Sim3(T(f(Rs)), T(f(ts)), torch.tensor(np.float32(s))),
                                   SE3(T(f(Rc)), T(f(tc))), SE3(T(f(Rd)), T(f(td))))
        for g, w in zip(got, want):
            np.testing.assert_allclose(N(g), w, atol=1e-5)
    np.testing.assert_allclose(N(atlas.weld_transform(
        Sim3(torch.eye(3), torch.zeros(3), torch.tensor(1.0)),
        SE3(torch.eye(3), T(np.float32([0.3, -0.2, 1.0]))),
        SE3(torch.eye(3), T(np.float32([0.3, -0.2, 1.0])))).t), 0.0, atol=1e-6)


def test_verify_merge_matches_reference_with_its_draws():
    """The drifted ring as the active map, and the same ring moved by a
    Sim3 as the stored map: keyframe 11 (which re-sees keyframe 0's
    points) against stored keyframes 0, 5 and 10 (5 shares no point with
    11, so it is refused before the RANSAC).
    With the reference's draws the decisions and inlier masks are equal,
    and the verified S_cl within 1e-4."""
    d, _, _, _ = build_ring()
    rng = np.random.default_rng(9)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R = (R * np.sign(np.linalg.det(R))).astype(np.float32)
    with x64_off():
        empty = _as_numpy(ref_state.allocate(*d["kf_mp"].shape, *d["mp_obs_kf"].shape))
    src = dict(d, kf_count=np.array([K_KF], np.int32),
               mp_count=np.array([np.flatnonzero(d["mp_valid"]).max() + 1], np.int32))
    moved, _ = _merge_both(empty, src, R, rng.normal(size=3).astype(np.float32),
                           np.float32(1.0), 0, 0)
    key = ReferenceDraws(23)
    port_draws = ReferenceDraws(23)
    with x64_off():
        cam = RefCam.make(300.0, 300.0, 160.0, 120.0)
        ra, rb = _ref_state(d), _ref_state(moved)
        want = []
        for cand in (0, 5, 10):
            ok, S, pairs = ref_atlas.verify_merge(cam, ra, K_KF - 1, rb, cand, key.split())
            want.append((ok, None if S is None else [np.asarray(x) for x in S],
                         None if pairs is None else [np.asarray(x) for x in pairs]))
    pcam = CameraParams.make(300.0, 300.0, 160.0, 120.0)
    pa = map_state_from_numpy(d, device="cpu")
    pb = map_state_from_numpy(moved, device="cpu")
    for cand, (ok, S, pairs) in zip((0, 5, 10), want):
        gok, gS, gpairs = atlas.verify_merge(pcam, pa, K_KF - 1, pb, cand, port_draws)
        assert gok == ok, cand
        if ok:
            for g, w in zip(gS, S):
                np.testing.assert_allclose(N(g), w, atol=1e-4)
            for g, w in zip(gpairs, pairs):
                np.testing.assert_array_equal(N(g), w)
    assert [w[0] for w in want] == [True, False, True]


# ------------------------------------------------------- the atlas run


def _atlas_inputs():
    n = 16
    world = synthetic.make_landmark_world(n_frames=n, n_landmarks=4000, seed=0, speed=0.8)
    frames = [_frame(world, i) for i in range(n)]
    inputs = [((f.xy, f.uright, f.depth, f.desc, f.level), i * 0.1) for i, f in enumerate(frames)]
    rng = np.random.default_rng(5)
    inputs += [(_garbage(rng), (n + g) * 0.1) for g in range(10)]
    t0 = (n + 10) * 0.1
    inputs += [((f.xy, f.uright, f.depth, f.desc, f.level), t0 + k * 0.1)
               for k, f in enumerate(frames[6:16])]
    return world, inputs


def _drive_logged(vo, inputs):
    """Process every input; log (input index, active map id, parked maps)
    whenever either changes."""
    log = []
    for j, (args, ts) in enumerate(inputs):
        before = (vo.active_map_id, len(vo.atlas_stored))
        vo.process_oracle(*args, ts)
        if (vo.active_map_id, len(vo.atlas_stored)) != before:
            log.append((j, vo.active_map_id, len(vo.atlas_stored)))
    vo.flush()
    return log


@pytest.fixture(scope="module")
def atlas_run():
    world, inputs = _atlas_inputs()
    cfg = make_cfg(recently_lost_sec=0.3, atlas_lost_sec=0.3, max_frames_between_kf=3)
    with x64_off():
        rvoc = ref_voc.train_vocabulary(world.desc[:3000], k=6, levels=3, iters=3)
        ref = RefStereoVO(cfg, vocab=rvoc)
        ref_log = _drive_logged(ref, inputs)
        ref_traj = ref.trajectory_wc()
    pvoc = vocabulary.train_vocabulary(world.desc[:3000], k=6, levels=3, iters=3, device="cpu")
    port = StereoVO(config_from_dict(dataclasses.asdict(cfg)), device="cpu", vocab=pvoc)
    port.relocalizer.draw = ReferenceDraws(11)
    port.loop_closer.draw = ReferenceDraws(7)
    port.merge_draw = ReferenceDraws(23)
    port_log = _drive_logged(port, inputs)
    return world, ref, ref_log, ref_traj, port, port_log, port.trajectory_wc()


def test_atlas_run_forks_and_merges_like_reference(atlas_run):
    """The fork (map 1 started, map 0 parked) and the merge back (map 0
    active, nothing parked) on the same frames; the same keyframes, map
    points, merges and program runs."""
    _, ref, ref_log, _, port, port_log, _ = atlas_run
    assert port_log == ref_log
    assert [(j, m) for j, m, _ in port_log] == [(port_log[0][0], 1), (port_log[1][0], 0)]
    assert port_log[0][0] < 26 <= port_log[1][0]
    assert (port.n_kf, port.n_mp, port.merge_count) == (ref.n_kf, ref.n_mp, ref.merge_count)
    assert (port.active_map_id, port.atlas_stored, port.state) == (0, [], "OK")
    assert port.program_runs["fork"] == 1 and port.program_runs["merge"] == 1


def test_atlas_run_records_match_reference(atlas_run):
    """Every frame's state, reference keyframe and map id as the
    reference's, and the trajectories within 5e-3 m; the welded revisit
    lands on the first map's frames 6-15 (the reference test's bound)."""
    world, ref, _, ref_traj, port, _, port_traj = atlas_run
    for key in ("state", "ref_kf", "map_id", "frame_id"):
        assert [getattr(r, key) for r in port.records] == [getattr(r, key) for r in ref.records]
    np.testing.assert_allclose(port_traj, ref_traj, atol=5e-3)
    err = np.linalg.norm(port_traj[26:36, :3, 3] - world.poses_wc[6:16, :3, 3], axis=1)
    assert float(np.median(err)) < 0.5, err
