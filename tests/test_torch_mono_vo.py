"""Monocular VO of the port against the JAX package's `pipeline/mono_vo.py`,
on tests/test_mono_vo.py's world: oracle features, 640x480, 30 frames of
`make_landmark_world(40, 8000 landmarks, seed 3, speed 0.8)`, its
configuration (`max_frames_between_kf=5`, local BA every keyframe).

One module fixture runs the reference, the port fed the reference's
two-view draws and its bundle-adjustment results, and the port on its own
`Sampler`; every check is its own test.

  * Fed: the port draws the reference's RANSAC samples (PRNGKey(3), split
    per attempt, through its `draw` hook), and after the initialization
    and after each local BA it takes the reference's map and live pose.
    The BA results must be fed because a monocular map's scale is a
    gauge: with keyframe 0 fixed, the initialization's whole-map BA (and
    local BA over a window with one fixed keyframe) has a null direction,
    and two float32 LMs from the same problem walk along it differently
    (ROADMAP F14, pinned below: equal costs to 1e-5 relative, keyframe 1
    1-8 % apart in scale). Fed so, states, the init frame, the
    keyframes (frames and slots), n_kf, n_mp, inlier counts and map-point
    counts equal the reference's on every frame; poses within 1e-5
    [measured 1.0e-7]; the points each keyframe triangulates within
    rtol 1e-3, atol 1e-4 of the reference's [measured 3e-5]; the
    scale-aligned ATE within 1e-5 m.
  * Own sampler, own BA, over the first 15 frames (for time):
    tests/test_mono_vo.py's limits (initialized before frame 10, no frame
    lost after, >= 3 keyframes, > 300 points); its ATE limit is a draw
    for the reference itself over these frames, so the ATE is held under
    the reference's median over five keys (the test says why). The same
    run's initialization shows the rescale after the initialization BA.
  * `_match_frames`, the keyframe policy and `kitti00_mono` exact; a
    vocabulary turns `fix_scale` off in the loop closer, as in the
    reference; the image path (`process_mono`, plain K1 on the CPU)
    initializes and tracks a small rendered world.

The reference runs with x64 off (a fresh context per use).
"""

import dataclasses
from contextlib import contextmanager

import jax
import numpy as np
import pytest
import torch
from test_torch_loop_parts import ReferenceDraws, x64_off

from vi_slam_tpu.optim import local_ba as ref_local_ba
from vi_slam_tpu.pipeline import mono_vo as ref_mono
from vi_slam_tpu.retrieval import vocabulary as ref_voc
from vi_slam_tpu.utils import config as rc
from vi_slam_tpu_torch.io import evaluation, synthetic
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.optim import local_ba
from vi_slam_tpu_torch.pipeline import mono_vo, steps
from vi_slam_tpu_torch.pipeline.stereo_vo import StereoVO
from vi_slam_tpu_torch.retrieval import vocabulary
from vi_slam_tpu_torch.utils import config as pc
from vi_slam_tpu_torch.utils.config import config_from_dict

WIDTH, HEIGHT = 640, 480
FX = FY = 500.0
CX, CY = 320.0, 240.0
N_FRAMES = 30
OWN_FRAMES = 15  # the run on the port's own sampler (cut from 30 for time)
# The reference's scale-aligned ATE over the first OWN_FRAMES frames of
# this world with its two-view key 3, 103, 203, 303 and 403, a lost or
# uninitialized run counted as worse than any (`tools/torch_parity_report.py
# --mono-seeds --frames 15`, JAX package at 822208b): 0.3833 m, lost after
# 8 OK frames, no initialization, 0.6471 m, 0.0397 m. Its median:
REF_OWN_MEDIAN_ATE = 0.6471


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run (the tests run in
    parallel workers that share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _x64_restored():
    yield
    assert jax.config.jax_enable_x64 is True, "a test left JAX's x64 mode off"


def make_cfg():
    """tests/test_mono_vo.py::make_cfg."""
    return rc.SystemConfig(
        sensor=rc.Sensor.MONOCULAR,
        camera=rc.CameraConfig(width=WIDTH, height=HEIGHT, fx=FX, fy=FY, cx=CX, cy=CY, bf=0.0),
        extractor=rc.ExtractorConfig(n_features=1200),
        tracker=rc.TrackerConfig(max_frames_between_kf=5),
        ba=rc.BAConfig(max_local_kfs=8, max_local_points=2048, local_ba_iters=6),
        map=rc.MapConfig(max_keyframes=128, max_points=32768, max_obs_per_point=8),
    )


def port_cfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def mono_frames(n=N_FRAMES):
    world = synthetic.make_landmark_world(n_frames=n + 10, n_landmarks=8000, seed=3, speed=0.8)
    frames = [synthetic.render_oracle_frame(world, i, FX, FY, CX, CY, 250.0, WIDTH, HEIGHT,
                                            max_features=1000, px_noise=0.3) for i in range(n)]
    return world, frames


def _numpy_map(m):
    return {k: np.array(v) for k, v in zip(m._fields, m)}


class _Snapshots:
    """The reference's state at its bundle adjustments: the map before
    each local BA (what the keyframe triangulated), and the map and live
    pose after the initialization and after each local BA."""

    def __init__(self):
        self.before_ba, self.after = [], []

    def take(self, vo, kind):
        self.after.append((kind, _numpy_map(vo.map), np.array(vo.T_dev.R), np.array(vo.T_dev.t),
                           vo.T_np.copy(), vo.ref_pose_np.copy()))


def _instrument_reference(vo, snaps):
    init, lba = vo._initialize, vo._local_ba

    def initialize(*a):
        ok = init(*a)
        if ok:
            snaps.take(vo, "init")
        return ok

    def local_ba_():
        if vo.n_kf >= 3:
            snaps.before_ba.append(_numpy_map(vo.map))
        lba()
        if vo.n_kf >= 3:
            snaps.take(vo, "local_ba")

    vo._initialize, vo._local_ba = initialize, local_ba_


def _feed(vo, snaps):
    """Give the port the reference's map and live pose where the reference
    took them, in place of its own initialization BA and local BAs (their
    results would be overwritten; the run on the port's own sampler runs
    them); record the port's own map before each local BA."""
    queue = list(snaps.after)
    init = vo._initialize
    vo._initial_ba = lambda: None
    before = []

    def take(kind):
        k, m, R, t, T_np, ref_pose = queue.pop(0)
        assert k == kind
        for name, v in m.items():
            dst = getattr(vo.map, name)
            dst.copy_(torch.from_numpy(v).to(dst.dtype))
        vo.T_dev = SE3(torch.from_numpy(R), torch.from_numpy(t))
        vo._last_good = (vo.T_dev.R, vo.T_dev.t)
        if kind == "init":
            vo.T_np, vo.ref_pose_np = T_np.copy(), ref_pose.copy()

    def initialize(*a):
        ok = init(*a)
        if ok:
            take("init")
        return ok

    def local_ba_():
        if vo.n_kf >= 3:
            before.append(_numpy_map(vo.map))
            take("local_ba")

    vo._initialize, vo._local_ba = initialize, local_ba_
    return before, queue


@contextmanager
def _capture_reference(out):
    """Record the reference's two-view results, its map just before the
    initialization BA, and that BA's result."""
    orig_ba, orig_tv = ref_local_ba.bundle_adjust, ref_mono.reconstruct_two_view
    orig_gather = ref_mono.steps.gather_global_ba_problem

    def gather(cam, m):
        out.setdefault("map_before", _numpy_map(m))
        return orig_gather(cam, m)

    def ba(cam, prob, **kw):
        res = orig_ba(cam, prob, **kw)
        out.setdefault("result", jax.tree_util.tree_map(np.array, res))
        return res

    def two_view(*a, **kw):
        res = orig_tv(*a, **kw)
        out.setdefault("two_view", []).append(jax.tree_util.tree_map(np.array, res))
        return res

    ref_local_ba.bundle_adjust, ref_mono.reconstruct_two_view = ba, two_view
    ref_mono.steps.gather_global_ba_problem = gather
    try:
        yield
    finally:
        ref_local_ba.bundle_adjust, ref_mono.reconstruct_two_view = orig_ba, orig_tv
        ref_mono.steps.gather_global_ba_problem = orig_gather


@pytest.fixture(scope="module")
def mono_runs():
    world, frames = mono_frames()
    cfg = make_cfg()
    snaps = _Snapshots()
    got = {}
    with x64_off(), _capture_reference(got):
        ref = ref_mono.MonoVO(cfg)
        _instrument_reference(ref, snaps)
        for i, fr in enumerate(frames):
            ref.process_oracle_mono(fr.xy, fr.desc, fr.level, i * 0.1)
        ref_traj = ref.trajectory_wc()
    fed = mono_vo.MonoVO(port_cfg(cfg), device="cpu", draw=ReferenceDraws(3))
    fed_before, left = _feed(fed, snaps)
    own = mono_vo.MonoVO(port_cfg(cfg), device="cpu")
    own_init = _record_initial_map(own)
    for i, fr in enumerate(frames):
        fed.process_oracle_mono(fr.xy, fr.desc, fr.level, i * 0.1)
        if i < OWN_FRAMES:
            own.process_oracle_mono(fr.xy, fr.desc, fr.level, i * 0.1)
    return dict(world=world, ref=ref, ref_traj=ref_traj, snaps=snaps, init_ba=got,
                two_view=got["two_view"],
                fed=fed, fed_traj=fed.trajectory_wc(), fed_before=fed_before, unfed=left,
                own=own, own_traj=own.trajectory_wc(), own_init=own_init)


def _record_initial_map(vo):
    """Keyframe 1's translation after the initialization BA, and the
    initial points' median depth and keyframe 1's translation after the
    rescale that follows it."""
    got = {}
    ba, rescale = vo._initial_ba, vo._rescale_initial_map

    def initial_ba():
        ba()
        got["kf1_after_ba"] = vo.map.kf_t[1].clone()

    def rescale_initial_map(ids):
        rescale(ids)
        got["median_depth"] = float(np.median(vo.map.mp_pos[ids, 2].numpy()))
        got["kf1"] = vo.map.kf_t[1].clone()
        got["n_points"] = int(ids.shape[0])

    vo._initial_ba, vo._rescale_initial_map = initial_ba, rescale_initial_map
    return got


def _ok_idx(vo):
    return [i for i, r in enumerate(vo.records) if r.state == "OK"]


def _ate(world, vo, traj):
    idx = _ok_idx(vo)
    return evaluation.ate_rmse(traj[idx, :3, 3], world.poses_wc[idx, :3, 3], with_scale=True)


def _ate_limit(world, vo):
    gt = world.poses_wc[_ok_idx(vo), :3, 3]
    return max(0.015 * np.linalg.norm(np.diff(gt, axis=0), axis=1).sum(), 0.05)


# ----------------------------------------------------------- matching


def test_match_frames_matches_reference():
    """Mutual-best matching of frames 0 and 3 (their oracle descriptors,
    padded to 1200) and of random descriptors against a shuffled copy with
    24 bits flipped each: the same indices and mask."""
    _, frames = mono_frames(4)
    rng = np.random.default_rng(5)
    cases = []
    for a, b in ((frames[0], frames[3]), (frames[3], frames[0])):
        cases.append((a.desc, b.desc))
    rand = rng.integers(0, 2 ** 32, size=(300, 8), dtype=np.uint32)
    cases.append((rand, synthetic.flip_descriptor_bits(rand[rng.permutation(300)], 24, rng)))
    for d1, d2 in cases:
        n = 1200
        p1 = np.zeros((n, 8), np.uint32)
        p2 = np.zeros((n, 8), np.uint32)
        p1[:len(d1)], p2[:len(d2)] = d1, d2
        v1 = np.arange(n) < len(d1)
        v2 = np.arange(n) < len(d2)
        with x64_off():
            rj, rok = (np.asarray(a) for a in ref_mono._match_frames(
                jax.numpy.asarray(p1), jax.numpy.asarray(v1), jax.numpy.asarray(p2),
                jax.numpy.asarray(v2)))
        pj, pok = mono_vo._match_frames(torch.from_numpy(p1.view(np.int32)), torch.from_numpy(v1),
                                        torch.from_numpy(p2.view(np.int32)), torch.from_numpy(v2))
        assert np.array_equal(pok.numpy(), rok) and rok.sum() > 0
        assert np.array_equal(pj.numpy()[rok], rj[rok])


# ------------------------------------------------------------- fed run


def test_fed_run_states_and_init_frame(mono_runs):
    ref, fed = mono_runs["ref"], mono_runs["fed"]
    states = [r.state for r in ref.records]
    assert [r.state for r in fed.records] == states
    assert states.index("OK") == 1 and states.count("LOST") == 1  # frame 0 is held
    assert [r.frame_id for r in fed.records] == [r.frame_id for r in ref.records]
    assert (fed.state, fed.frame_id) == (ref.state, ref.frame_id) == ("OK", N_FRAMES - 1)
    # the accepted two-view solve: the same model and good count, and every
    # good point became a map point
    r = mono_runs["two_view"][-1]
    assert bool(r.ok)
    assert fed.init_result == (bool(r.used_homography), int(r.n_good)) == (
        fed.init_result[0], fed.stats[1].n_mps)


def test_fed_run_keyframes(mono_runs):
    ref, fed = mono_runs["ref"], mono_runs["fed"]
    assert fed.n_kf == ref.n_kf >= 3
    assert [r.ref_kf for r in fed.records] == [r.ref_kf for r in ref.records]
    n = ref.n_kf
    assert np.array_equal(fed.map.kf_frame_id[:n].numpy(), np.asarray(ref.map.kf_frame_id[:n]))
    # every keyframe after the first two came from _create_keyframe
    assert not mono_runs["unfed"] and len(mono_runs["snaps"].after) == 1 + (n - 2)


def test_fed_run_map_points_and_inliers(mono_runs):
    ref, fed = mono_runs["ref"], mono_runs["fed"]
    assert fed.n_mp == ref.n_mp > 300
    assert [s.n_mps for s in fed.stats] == [s.n_mps for s in ref.stats]
    assert [s.n_inliers for s in fed.stats] == [s.n_inliers for s in ref.stats]
    assert [s.n_matches for s in fed.stats] == [s.n_matches for s in ref.stats]


def test_fed_run_poses(mono_runs):
    np.testing.assert_allclose(mono_runs["fed_traj"], mono_runs["ref_traj"], atol=1e-5)


def test_fed_run_triangulated_map(mono_runs):
    """Before each local BA (the keyframe and its triangulated points, from
    the same fed map), the port's map is the reference's: the same live
    points and keyframe links, positions within rtol 1e-3, atol 1e-4."""
    ref_maps, port_maps = mono_runs["snaps"].before_ba, mono_runs["fed_before"]
    assert len(port_maps) == len(ref_maps) >= 3
    for r, p in zip(ref_maps, port_maps):
        assert np.array_equal(p["mp_valid"], r["mp_valid"])
        assert np.array_equal(p["kf_mp"], r["kf_mp"])
        assert np.array_equal(p["mp_obs_kf"], r["mp_obs_kf"])
        v = r["mp_valid"]
        np.testing.assert_allclose(p["mp_pos"][v], r["mp_pos"][v], rtol=1e-3, atol=1e-4)


def test_fed_run_ate(mono_runs):
    world, ref, fed = mono_runs["world"], mono_runs["ref"], mono_runs["fed"]
    a_ref = _ate(world, ref, mono_runs["ref_traj"])
    a_fed = _ate(world, fed, mono_runs["fed_traj"])
    assert abs(a_fed["rmse"] - a_ref["rmse"]) < 1e-5
    assert a_fed["rmse"] < _ate_limit(world, fed) and a_fed["scale"] > 0


# ------------------------------------------------- the scale gauge (F14)


def test_init_ba_scale_is_a_flat_valley(mono_runs):
    """The port's initialization BA as MonoVO runs it (`_initial_ba`: the
    problem gathered from the two keyframes and the first n_features point
    slots, the monocular guard on) from the reference's map just before
    its own whole-map BA. It ends at the reference's cost (rtol 1e-5),
    keyframe 1's translation in the reference's direction (1e-3 rad) and
    the map the reference's up to scale (each side's points over its
    median depth, atol 1e-4), while the scale itself is a gauge with
    keyframe 0 fixed (ROADMAP F14): keyframe 1's translation is held only
    within 5 % of the reference's. Measured: costs 228.60983 and
    228.60962, the scaled points 1.1e-5 apart, keyframe 1's translation
    0.21 % shorter in the port's run (7.8 % longer on the valid points
    alone without the guard: where LM stops along the valley is a matter
    of rounding)."""
    got = mono_runs["init_ba"]
    before, res = got["map_before"], got["result"]
    vo = mono_vo.MonoVO(port_cfg(make_cfg()), device="cpu")
    for name, v in before.items():
        dst = getattr(vo.map, name)
        dst.copy_(torch.from_numpy(v).to(dst.dtype))
    vo.n_kf, vo.n_mp = 2, int(before["mp_valid"].sum())
    assert vo.n_mp == mono_runs["ref"].stats[1].n_mps
    costs = []
    ba = local_ba.bundle_adjust

    def bundle_adjust(*a, **kw):
        assert kw.get("guard_in_front") is True
        out = ba(*a, **kw)
        costs.append(float(out.cost[-1]))
        return out

    local_ba.bundle_adjust = bundle_adjust
    try:
        vo._initial_ba()
    finally:
        local_ba.bundle_adjust = ba
    np.testing.assert_allclose(costs[0], float(res.cost[-1]), rtol=1e-5)
    t_ref, t_port = res.poses.t[1].astype(np.float64), vo.map.kf_t[1].numpy().astype(np.float64)
    angle = np.arctan2(np.linalg.norm(np.cross(t_ref, t_port)), t_ref @ t_port)
    assert angle < 1e-3, angle
    assert abs(np.linalg.norm(t_port) / np.linalg.norm(t_ref) - 1.0) < 0.05
    valid = before["mp_valid"]
    p_ref, p_port = res.points[valid], vo.map.mp_pos.numpy()[valid]
    np.testing.assert_allclose(p_port / np.median(p_port[:, 2]), p_ref / np.median(p_ref[:, 2]),
                               rtol=0, atol=1e-4)


# ------------------------------------------------------- own sampler


def test_own_sampler_run_meets_reference_limits(mono_runs):
    """tests/test_mono_vo.py's checks on the port alone (its own draws
    and BA, with the monocular guards) over the first 15 frames:
    initialized before frame 10, no frame lost after, >= 3 keyframes, >
    300 points, a positive Horn scale.

    That test's ATE limit (max(1.5 % of the path, 5 cm): 0.156 m over 15
    frames) is a draw for the reference itself: over the same frames with
    its keys 3, 103, 203, 303 and 403 it meets it once (0.0397 m), tracks
    twice above it (0.3833 and 0.6471 m), loses its map once and never
    initializes once. So the port's ATE is held under the reference's
    median over those keys (REF_OWN_MEDIAN_ATE, 0.6471 m). The port over
    the same seeds of its Sampler tracks all five: 0.2300 (seed 3, this
    run), 0.0424, 0.2817, 0.0723 and 0.1474 m, median 0.1474 m
    (`tools/torch_parity_report.py --mono-seeds --frames 15`)."""
    world, own = mono_runs["world"], mono_runs["own"]
    states = [r.state for r in own.records]
    assert len(states) == OWN_FRAMES and own.state == "OK"
    first_ok = states.index("OK")
    assert first_ok < 10
    assert states[first_ok:].count("LOST") == 0
    assert states[first_ok:].count("RECENTLY_LOST") == 0
    assert own.n_kf >= 3 and own.n_mp > 300
    traj = mono_runs["own_traj"]
    assert np.all(np.isfinite(traj))
    a = _ate(world, own, traj)
    assert a["rmse"] < REF_OWN_MEDIAN_ATE, a
    assert a["scale"] > 0


def test_initial_map_rescaled_after_ba(mono_runs):
    """The port scales its initial map back to a median depth of 1 after
    the whole-map BA (the reference's CreateInitialMapMonocular; the JAX
    package leaves it out, ROADMAP H13). In the own run: its BA left the
    initial points' median depth at 0.9400, and after the rescale it is 1
    (1e-6) with keyframe 1 scaled with it; the reference's map after its
    initialization keeps its BA's median (1.0010: its LM rejected the
    gauge steps this time)."""
    got, own = mono_runs["own_init"], mono_runs["own"]
    assert got["n_points"] > 300
    assert abs(got["median_depth"] - 1.0) < 1e-6
    assert abs(own.init_depth_after_ba - 1.0) > 1e-3
    np.testing.assert_allclose(got["kf1"].numpy(),
                               got["kf1_after_ba"].numpy() / own.init_depth_after_ba, rtol=1e-6)
    ref_map = mono_runs["snaps"].after[0][1]
    n_ref = mono_runs["ref"].stats[1].n_mps
    ref_med = float(np.median(ref_map["mp_pos"][:n_ref, 2]))
    assert abs(ref_med - 1.0) > 1e-5, ref_med


def test_ba_guard_keeps_the_map_in_front():
    """H13: LM under the reference's accept rule (any step that lowers the
    cost), on the initialization problem of the first two frames of
    tests/test_mono_vo.py's world cut to 2 frames (12 frames long; the
    port fed the reference's two-view draws), with an initial damping of
    1e-8, steps along the scale gauge through zero: the map ends mirrored
    behind both cameras, every observation out of the cost, cost 0. With
    the monocular guard (guard_in_front) no step may take an observation
    out: every observation stays, the map in front, at the default
    damping's cost (rtol 1e-4). (At 1e-6, 1e-7, 1e-9 and 1e-10 the same
    problem does not mirror: where LM lands along the gauge is a matter of
    rounding, ROADMAP F14.)"""
    _, frames = mono_frames(2)
    vo = mono_vo.MonoVO(port_cfg(make_cfg()), device="cpu", draw=ReferenceDraws(3))
    problems = []

    def initial_ba():  # the problem only: the test runs the BAs below
        K, N = 2, vo.cfg.extractor.n_features
        m = vo.map
        sub = m._replace(**{f: getattr(m, f)[:K].clone() for f in m._fields if f.startswith("kf_")},
                         **{f: getattr(m, f)[:N].clone() for f in m._fields if f.startswith("mp_")})
        problems.append(steps.gather_global_ba_problem(vo.cam, sub))

    vo._initial_ba = initial_ba
    for i, fr in enumerate(frames):
        vo.process_oracle_mono(fr.xy, fr.desc, fr.level, i * 0.1)
    prob = problems[0]
    n_obs = int(prob.obs_mask.sum())

    def run(lam0, guard):
        res = local_ba.bundle_adjust(vo.cam, prob, iters=mono_vo.INIT_BA_ITERS,
                                     assembly="scatter", lam0=lam0, guard_in_front=guard)
        kept = int(local_ba._residuals(vo.cam, res.poses, res.points, prob)[3][..., 0].sum())
        return res, kept, float(np.median(res.points[prob.point_valid, 2].numpy()))

    base, kept, _ = run(1e-4, False)
    assert kept == n_obs
    _, kept, med = run(1e-8, False)
    assert kept == 0 and med < 0, (kept, med)
    res, kept, med = run(1e-8, True)
    assert kept == n_obs and med > 0
    np.testing.assert_allclose(float(res.cost[-1]), float(base.cost[-1]), rtol=1e-4)


# -------------------------------------------------------- small parts


def test_keyframe_policy_matches_reference():
    """The monocular keyframe decision over a grid of keyframe counts,
    frames since the last keyframe, inliers and the reference keyframe's
    tracked count."""
    cfg = make_cfg()
    with x64_off():
        ref = ref_mono.MonoVO(cfg)
    port = mono_vo.MonoVO(port_cfg(cfg), device="cpu")
    for n_kf in (0, 1, 2, 5, 126, 127):
        for fs in (0, 4, 5, 9):
            for tracked in (0, 100, 400):
                for n_in in (0, 15, 16, 89, 90, 359, 360, 400):
                    for vo in (ref, port):
                        vo.n_kf, vo.frames_since_kf, vo._ref_kf_tracked = n_kf, fs, tracked
                    assert port._need_keyframe(n_in, 0, 0) == ref._need_keyframe(n_in, 0, 0), (
                        n_kf, fs, tracked, n_in)


def test_kitti00_mono_matches_reference():
    assert dataclasses.asdict(pc.kitti00_mono()) == {
        **dataclasses.asdict(rc.kitti00_mono()), "sensor": pc.Sensor.MONOCULAR}
    assert port_cfg(rc.kitti00_mono()) == pc.kitti00_mono()


def test_fix_scale_off_with_vocabulary():
    """With a vocabulary the mono loop closer corrects in Sim3 (fix_scale
    False), as the reference's; a stereo one keeps SE3."""
    desc = np.random.default_rng(0).integers(0, 2 ** 32, size=(400, 8), dtype=np.uint32)
    cfg = make_cfg()
    with x64_off():
        ref = ref_mono.MonoVO(cfg, vocab=ref_voc.train_vocabulary(desc, k=4, levels=2, iters=2))
    voc = vocabulary.train_vocabulary(desc, k=4, levels=2, iters=2, device="cpu")
    port = mono_vo.MonoVO(port_cfg(cfg), device="cpu", vocab=voc)
    assert port.loop_closer.fix_scale is False and ref.loop_closer.fix_scale is False
    assert port.relocalizer is not None
    assert StereoVO(port_cfg(cfg), device="cpu", vocab=voc).loop_closer.fix_scale is True


def test_image_path_initializes_and_tracks():
    """`process_mono` on rendered images (plain K1 on the CPU): a 3-frame
    sequence of tools/bench_vio.py's world at half its width (620x188,
    800 features over 4 levels) holds frame 0, initializes on frame 1 and
    tracks frame 2."""
    W, H = 620, 188
    F = 718.856 * W / 1241
    _, _, frames = synthetic.make_billboard_inertial_sequence(3, F, F, W / 2, H / 2, W, H, 0.54 * F,
                                                              n_landmarks=2000, seed=5)
    cfg = rc.SystemConfig(
        sensor=rc.Sensor.MONOCULAR,
        camera=rc.CameraConfig(width=W, height=H, fx=F, fy=F, cx=W / 2, cy=H / 2, bf=0.0),
        extractor=rc.ExtractorConfig(n_features=800, cell_size=16, n_levels=4),
        tracker=rc.TrackerConfig(max_frames_between_kf=4),
        ba=rc.BAConfig(max_local_kfs=6, max_local_points=1024, local_ba_iters=4),
        map=rc.MapConfig(max_keyframes=16, max_points=4096, max_obs_per_point=8),
    )
    vo = mono_vo.MonoVO(port_cfg(cfg), device="cpu")
    for i, (left, _) in enumerate(frames):
        vo.process_mono(left, i * 0.1)
    assert [r.state for r in vo.records] == ["LOST", "OK", "OK"]
    assert vo.init_result is not None and vo.init_result[1] >= 50
    assert vo.timer.runs["init_two_view"] == 1 and vo.timer.runs["init_map"] == 1
    assert min(s.n_inliers for s in vo.stats[2:]) >= 20
    assert np.all(np.isfinite(vo.trajectory_wc()))
