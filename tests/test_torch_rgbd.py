"""RGB-D ingest (`StereoVO.process_rgbd`): the JAX package's StereoVO and
the port's, both on the CPU, over tests/test_lifecycle.py's RGB-D world
(`make_billboard_world(n_frames=6, n_boards=1500, seed=2, speed=0.4)`,
320x240, fx 250, bf 125, 600 features) with that test's configuration
and its z-buffer depth maps (`synthetic.render_billboard_depth`).

  * Fed the reference's per-frame features, u_right and depth (the
    reference's one-image extraction and depth lookup, `_rgbd_frame_fn`),
    with the mapping pass, local BA and maintenance off: per-frame states,
    reference keyframes, keyframe frames, inlier, match and map-point
    counts equal, poses within 1e-4 m (float32 Gauss-Newton summed in
    another order).
  * The same fed run at tests/test_lifecycle.py's cadences (the programs
    at every keyframe): every decision equal, and each frame before the
    local BA within 1e-4 m relative to its keyframe. The local BA parts
    the keyframes by millimetres along a flat valley (ROADMAP F10); a
    test started from the reference's own map shows it.
  * On its own features (which differ from the reference's in flat-pair
    descriptor bits and the resampled levels, ROADMAP H6/H7): the same
    states and keyframe frames.
  * The port's depth lookup on the reference's keypoints gives the
    reference's depth exactly and its u_right within 1e-4 px.

The reference runs with x64 off (a fresh context per use).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_slam_tpu.cameras.base import CameraParams as RefCam
from vi_slam_tpu.optim import local_ba as ref_ba
from vi_slam_tpu.pipeline import steps as ref_steps
from vi_slam_tpu.pipeline.stereo_vo import StereoVO as RefStereoVO
from vi_slam_tpu.slam_map import state as ref_state
from vi_slam_tpu.utils import config as rc
from vi_slam_tpu_torch.features.extractor import Features
from vi_slam_tpu_torch.io import synthetic
from vi_slam_tpu_torch.optim import local_ba
from vi_slam_tpu_torch.pipeline import steps
from vi_slam_tpu_torch.pipeline.stereo_vo import StereoVO
from vi_slam_tpu_torch.slam_map.state import map_state_from_numpy, map_state_to_numpy
from vi_slam_tpu_torch.utils.config import config_from_dict

W, H = 320, 240
FX = FY = 250.0
CX, CY = 160.0, 120.0
BF = 125.0
N_FRAMES = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the tests run in
    parallel workers that share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def x64_off():
    """A fresh context per use (a shared one, entered nested, would leave
    x64 off for every later test in the process)."""
    return jax.enable_x64(False)


@pytest.fixture(autouse=True)
def _x64_restored():
    yield
    assert jax.config.jax_enable_x64 is True, "a test left JAX's x64 mode off"


def rgbd_cfg(programs: bool = True):
    """tests/test_lifecycle.py::test_rgbd_ingest_tracks's configuration
    (the mapping pass, local BA and maintenance at every keyframe);
    without `programs` they are set beyond the run."""
    never = 10 ** 9
    tracker = rc.TrackerConfig() if programs else rc.TrackerConfig(
        mapping_every=never, local_ba_every=never, maintenance_every=never)
    return rc.SystemConfig(
        sensor=rc.Sensor.RGBD,
        camera=rc.CameraConfig(width=W, height=H, fx=FX, fy=FY, cx=CX, cy=CY, bf=BF,
                               th_depth=40.0),
        extractor=rc.ExtractorConfig(n_features=600),
        ba=rc.BAConfig(max_local_kfs=6, max_local_points=1024, local_ba_iters=4),
        map=rc.MapConfig(max_keyframes=32, max_points=8192, max_obs_per_point=8),
        tracker=tracker,
    )


def _kf_frames(records):
    return [np.array_equal(r.T_rel, np.eye(4)) for r in records]


def _numpy_map(ms):
    return {k: np.array(v) for k, v in zip(ms._fields, ms)}


def _fed_port(cfg, fed_inputs):
    """A port StereoVO whose RGB-D frames take the reference's features,
    u_right and depth, frame by frame."""
    vo = StereoVO(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    queue = iter(fed_inputs)

    def fed_features(img, depth_img):
        f, u, d = next(queue)
        f = list(f)
        f[4] = f[4].view(np.int32)
        return (Features(*(torch.from_numpy(x) for x in f)), torch.from_numpy(u),
                torch.from_numpy(d))

    vo._rgbd_features = fed_features
    return vo


def _drive(vo, frames):
    for i, (img, depth) in enumerate(frames):
        vo.process_rgbd(img, depth, i * 0.1)
    return vo.trajectory_wc()


@pytest.fixture(scope="module")
def runs():
    """With the programs on (as tests/test_lifecycle.py): the reference,
    with each local BA's input and output map kept, the port fed its
    features and the port on its own. With the programs off: the
    reference (the first one's compiled frame programs: same camera,
    extractor and map) and the port fed."""
    world = synthetic.make_billboard_world(n_frames=N_FRAMES, n_boards=1500, seed=2, speed=0.4)
    frames = [(synthetic.render_billboard_image(world, T, FX, FY, CX, CY, W, H),
               synthetic.render_billboard_depth(world, T, FX, FY, CX, CY, W, H))
              for T in world.poses_wc]
    fed_inputs, local_bas = [], []
    with x64_off():
        ref = RefStereoVO(rgbd_cfg())
        extract = ref._rgbd_frame_fn

        def recorded(img, depth_img):
            out = extract(img, depth_img)
            fed_inputs.append(([np.array(a) for a in out[0]], np.array(out[1]),
                               np.array(out[2])))
            return out

        ref._rgbd_fn_cached = recorded
        local_ba = ref._local_ba_fn

        def kept(ms, slot):
            before = _numpy_map(ms)
            out = local_ba(ms, slot)
            local_bas.append((before, int(slot), _numpy_map(out[0]), len(ref.records)))
            return out

        ref._local_ba_fn = kept
        ref_traj = _drive(ref, frames)
        off = RefStereoVO(rgbd_cfg(programs=False))
        off._rgbd_fn_cached = extract
        off._track_fn, off._create_kf_fn = ref._track_fn, ref._create_kf_fn
        off_traj = _drive(off, frames)
    fed = _fed_port(rgbd_cfg(), fed_inputs)
    fed_off = _fed_port(rgbd_cfg(programs=False), fed_inputs)
    own = StereoVO(config_from_dict(dataclasses.asdict(rgbd_cfg())), device="cpu")
    return dict(frames=frames, fed_inputs=fed_inputs, local_bas=local_bas,
                ref=ref, ref_traj=ref_traj, fed=fed, fed_traj=_drive(fed, frames),
                own=own, own_traj=_drive(own, frames),
                off=off, off_traj=off_traj, fed_off=fed_off, fed_off_traj=_drive(fed_off, frames))


def _assert_decisions_equal(ref, port):
    assert all(r.state == "OK" for r in ref.records)
    assert [r.state for r in port.records] == [r.state for r in ref.records]
    assert [r.ref_kf for r in port.records] == [r.ref_kf for r in ref.records]
    assert _kf_frames(port.records) == _kf_frames(ref.records)
    for name in ("n_inliers", "n_matches", "n_local_points", "n_mps", "n_kfs"):
        assert [getattr(s, name) for s in port.stats] == [getattr(s, name) for s in ref.stats]
    assert (port.n_kf, port.n_mp) == (ref.n_kf, ref.n_mp)
    assert ref.n_kf >= 2 and ref.n_mp > 100


def test_fed_rgbd_run_equals_reference(runs):
    """The programs off: every decision equal, poses within 1e-4 m."""
    _assert_decisions_equal(runs["off"], runs["fed_off"])
    np.testing.assert_allclose(runs["fed_off_traj"], runs["off_traj"], rtol=0, atol=1e-4)


def test_fed_rgbd_run_with_programs_decisions_equal(runs):
    """tests/test_lifecycle.py's cadences (a mapping pass and a local BA
    at the third keyframe): every decision equal; each frame recorded
    before the local BA within 1e-4 m of the reference relative to its
    keyframe. The local BA itself parts the poses (ROADMAP F10): see the
    next test."""
    ref, fed = runs["ref"], runs["fed"]
    _assert_decisions_equal(ref, fed)
    assert fed.program_runs["local_ba"] == len(runs["local_bas"]) == 1
    n_before = runs["local_bas"][0][3]
    for r, p in zip(ref.records[:n_before], fed.records[:n_before]):
        np.testing.assert_allclose(p.T_rel, r.T_rel, rtol=0, atol=1e-4)


def test_own_rgbd_run_tracks_like_reference(runs):
    """On its own features, with the programs on: every frame tracked, the
    reference's keyframe frames, a finite trajectory."""
    ref, own = runs["ref"], runs["own"]
    assert [r.state for r in own.records] == [r.state for r in ref.records]
    assert _kf_frames(own.records) == _kf_frames(ref.records)
    assert np.all(np.isfinite(runs["own_traj"]))


def test_local_ba_departure_is_a_flat_valley(runs):
    """Localizes ROADMAP F10. From the reference's own map before its local
    BA (3 keyframes, the origin fixed, 4 LM steps), the port's local BA
    starts at the reference's cost (within 1e-6 relative) and halves it as
    the reference's does, ending within 0.2 % of the reference's final
    cost, while its keyframes land millimetres from the reference's
    (5.9e-3 m measured; the reference's moved 2.4e-2 m): the float32 Schur
    solve, summed in another order, takes another path along a flat valley
    of a 3-keyframe window, as in F7/F8."""
    before, slot, after, _ = runs["local_bas"][0]
    port = runs["fed"]
    got, _ = port._local_ba_program(map_state_from_numpy(before, device="cpu"), slot)
    got = map_state_to_numpy(got)
    n = int(before["kf_count"][0])
    moved = np.abs(after["kf_t"][:n] - before["kf_t"][:n]).max()
    apart = np.abs(got["kf_t"][:n] - after["kf_t"][:n]).max()
    assert apart < 0.5 * moved
    ref_cost, port_cost = _local_ba_costs(port, before, slot)
    assert abs(port_cost[0] - ref_cost[0]) <= 1e-6 * ref_cost[0]
    assert ref_cost[-1] < 0.6 * ref_cost[0] and port_cost[-1] < 0.6 * port_cost[0]
    assert abs(port_cost[-1] - ref_cost[-1]) <= 2e-3 * ref_cost[-1]


def _local_ba_costs(port, before, slot):
    """The cost histories of both local BAs from one map: the problem of
    `StereoVO._local_ba_program` built on each side from the same window,
    fixed set and points."""
    ba = port.cfg.ba
    n_obs = port.cfg.map.max_obs_per_point
    with x64_off():
        rms = ref_state.MapState(**{k: jnp.asarray(v) for k, v in before.items()})
        window = ref_steps.covis_window(rms, jnp.int32(slot), ba.max_local_kfs)
        alive = window >= 0
        rank = jnp.argsort(jnp.argsort(jnp.where(alive, window, jnp.iinfo(jnp.int32).max)))
        fixed = (rank < jnp.maximum(1, jnp.sum(alive.astype(jnp.int32)) // 3)) | (window == 0)
        mp_ids, _ = ref_steps.gather_local_points(rms, window, ba.max_local_points)
        cam = RefCam.make(FX, FY, CX, CY, bf=BF)
        prob = ref_steps.gather_ba_problem(cam, rms, window, fixed, mp_ids,
                                           n_window=ba.max_local_kfs,
                                           n_points=ba.max_local_points, n_obs=n_obs)
        ref_cost = np.asarray(ref_ba._ba_core(cam, prob, ba.local_ba_iters, True, 1e-4).cost)
        window, fixed, mp_ids = (np.array(a) for a in (window, fixed, mp_ids))
    pprob = steps.gather_ba_problem(
        port.cam, map_state_from_numpy(before, device="cpu"), torch.from_numpy(window),
        torch.from_numpy(fixed), torch.from_numpy(mp_ids), n_window=ba.max_local_kfs,
        n_points=ba.max_local_points, n_obs=n_obs)
    port_cost = local_ba._ba_core(port.cam, pprob, ba.local_ba_iters, True, 1e-4).cost.numpy()
    return ref_cost, port_cost


def test_depth_lookup_matches_reference(runs):
    """The port's lookup on the reference's keypoints of every frame: the
    same depth (a copy) and u_right within 1e-4 px (a float32 division)."""
    port = runs["fed"]
    for (img, depth), (f, u, d) in zip(runs["frames"], runs["fed_inputs"]):
        feats = Features(*(torch.from_numpy(np.array(x)) for x in
                           [f[0], f[1], f[2], f[3], f[4].view(np.int32), f[5]]))
        got_u, got_d = _lookup(port, feats, depth)
        np.testing.assert_array_equal(got_d, d)
        np.testing.assert_allclose(got_u, u, rtol=0, atol=1e-4)
        assert (d > 0).sum() > 100


def _lookup(vo, feats, depth_img):
    """`StereoVO._rgbd_features`'s depth lookup for given features."""
    extractor = vo.extractor
    vo.extractor = lambda img: feats
    try:
        _, u, d = StereoVO._rgbd_features(vo, None, torch.from_numpy(depth_img))
    finally:
        vo.extractor = extractor
    return u.numpy(), d.numpy()
