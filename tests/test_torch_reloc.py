"""Relocalization, the oracle-feature path and the map resets of the port's
StereoVO against the JAX package's, fed the same oracle frames
(tests/test_vo_oracle.py's world and camera).

  * tests/test_reloc.py's kidnapped run: 14 mapped frames, two frames of
    random garbage, then frame 6's view again, which the wide search from
    the frozen pose tracks without relocalizing; and the same run
    returning to frame 0's view, 10 m back, where tracking fails and the
    keyframe database relocalizes. The port's PnP samples are the
    reference's draws (key 11, split per candidate attempt), so it must
    relocalize on the same frame.
  * tests/test_vo_oracle.py's 40-frame run.
  * a young map lost for longer than `recently_lost_sec`, and a timestamp
    that jumps backwards, reset both systems to the same state; with a
    vocabulary and the atlas on, a timestamp jump forks a new map.

Every frame's state, reference keyframe and frame id are equal, and so
are the keyframe counts. Inlier counts are within 2 of the reference's
(of 250-900: the 40-frame run differs by 1-2 on 4 frames, the kidnapped
run by 2 on its relocalized frame), and trajectories within 5 mm on the
17-frame runs.

On the 40-frame run (31 m, a keyframe every 10 frames, local BA at each)
the port's trajectory departs from the reference's through the keyframe
poses alone. Local BA's window of up to five keyframes with one fixed has
a flat cost valley, and from the same input the reference's and the
port's float32 LM stop at costs equal to 3e-6 relative (209.7107 and
209.7101) with keyframe translations 9.6e-4 m apart; later windows move
the same keyframes again, and at the end they are up to 3.5e-2 m apart.
Each frame's pose relative to its reference keyframe stays within 1e-3 m
of the reference's until the first frame whose inlier count differs
(frame 27; measured 7.3e-4 m at frame 26), and every frame's position
within twice the largest keyframe gap (measured 4.4e-2 m against
3.5e-2 m). Fed the reference's map after each keyframe instead, the port
tracks every frame to the reference's pose within 2e-5 m (measured
2.2e-6 m) with equal inlier counts, and its ATE equals the reference's
to 1e-5 m: the tracking is the reference's, and the difference in ATE
(port 0.87 cm, reference 2.85 cm unfed) is the keyframe programs'.

The reference runs with x64 off (a fresh context per use).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_loop_parts import ReferenceDraws, x64_off

from vi_slam_tpu.pipeline.stereo_vo import StereoVO as RefStereoVO
from vi_slam_tpu.retrieval import vocabulary as ref_voc
from vi_slam_tpu.utils import config as rc
from vi_slam_tpu_torch.io import synthetic
from vi_slam_tpu_torch.pipeline.stereo_vo import StereoVO
from vi_slam_tpu_torch.retrieval import vocabulary
from vi_slam_tpu_torch.utils.config import config_from_dict

WIDTH, HEIGHT = 640, 480
FX = FY = 500.0
CX, CY = 320.0, 240.0
BF = 250.0


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


@pytest.fixture(autouse=True)
def _x64_restored():
    yield
    assert jax.config.jax_enable_x64 is True, "a test left JAX's x64 mode off"


def make_cfg(**tracker):
    """tests/test_vo_oracle.py::make_cfg, with tracker overrides."""
    return rc.SystemConfig(
        camera=rc.CameraConfig(width=WIDTH, height=HEIGHT, fx=FX, fy=FY, cx=CX, cy=CY,
                               bf=BF, th_depth=40.0),
        extractor=rc.ExtractorConfig(n_features=1200),
        ba=rc.BAConfig(max_local_kfs=8, max_local_points=2048, local_ba_iters=6),
        map=rc.MapConfig(max_keyframes=128, max_points=32768, max_obs_per_point=8),
        tracker=rc.TrackerConfig(**tracker),
    )


def _frame(world, i):
    return synthetic.render_oracle_frame(world, i, FX, FY, CX, CY, BF, WIDTH, HEIGHT,
                                         max_features=1000, px_noise=0.3)


def _garbage(rng):
    xy = rng.uniform(0, 600, size=(500, 2))
    desc = rng.integers(0, 2 ** 32, size=(500, 8), dtype=np.uint32)
    return xy, np.full((500,), -1.0), np.full((500,), -1.0), desc, np.zeros((500,), np.int32)


def _drive(vo, inputs):
    for args, ts in inputs:
        vo.process_oracle(*args, ts)
    return vo


def _pair(cfg, inputs, vocab_desc=None):
    """(reference, port) after the same oracle inputs."""
    rvoc = pvoc = None
    with x64_off():
        if vocab_desc is not None:
            rvoc = ref_voc.train_vocabulary(vocab_desc, k=6, levels=3, iters=3)
        ref = _drive(RefStereoVO(cfg, vocab=rvoc), inputs)
        ref_traj = ref.trajectory_wc()
    if vocab_desc is not None:
        pvoc = vocabulary.train_vocabulary(vocab_desc, k=6, levels=3, iters=3, device="cpu")
    port = StereoVO(config_from_dict(dataclasses.asdict(cfg)), device="cpu", vocab=pvoc)
    if port.relocalizer is not None:
        port.relocalizer.draw = ReferenceDraws(11)
    return ref, ref_traj, _drive(port, inputs), port.trajectory_wc()


def _assert_same_run(ref, ref_traj, port, port_traj, atol=5e-3):
    assert [r.state for r in port.records] == [r.state for r in ref.records]
    assert [r.ref_kf for r in port.records] == [r.ref_kf for r in ref.records]
    assert [r.frame_id for r in port.records] == [r.frame_id for r in ref.records]
    n_port = np.array([s.n_inliers for s in port.stats])
    n_ref = np.array([s.n_inliers for s in ref.stats])
    assert np.abs(n_port - n_ref).max() <= 2, (n_port - n_ref)
    assert (port.n_kf, port.state, port.frame_id) == (ref.n_kf, ref.state, ref.frame_id)
    np.testing.assert_allclose(port_traj, ref_traj, atol=atol)


@pytest.fixture(scope="module", params=[6, 0], ids=["back_to_6", "back_to_0"])
def kidnapped(request):
    world = synthetic.make_landmark_world(n_frames=20, n_landmarks=4000, seed=0, speed=0.8)
    rng = np.random.default_rng(5)
    inputs = [((f.xy, f.uright, f.depth, f.desc, f.level), i * 0.1)
              for i, f in ((i, _frame(world, i)) for i in range(14))]
    inputs += [(_garbage(rng), (14 + i) * 0.1) for i in range(2)]
    back = _frame(world, request.param)
    inputs.append(((back.xy, back.uright, back.depth, back.desc, back.level), 1.7))
    return request.param, world, _pair(make_cfg(), inputs, vocab_desc=world.desc[:3000])


def test_kidnap_then_relocalize_like_reference(kidnapped):
    """Same states frame by frame (RECENTLY_LOST for the garbage, OK on
    the return), relocalization attempted on both garbage frames, and on
    the return to frame 0 (where it succeeds); the recovered pose on the
    map's estimate of the returned-to frame, as tests/test_reloc.py
    requires."""
    back, world, (ref, ref_traj, port, port_traj) = kidnapped
    _assert_same_run(ref, ref_traj, port, port_traj)
    assert [r.state for r in port.records][-3:] == ["RECENTLY_LOST", "RECENTLY_LOST", "OK"]
    assert port.program_runs["reloc"] == (3 if back == 0 else 2)
    np.testing.assert_allclose(port.T_np, ref.T_np, atol=5e-3)
    Twc = np.linalg.inv(port.T_np)
    assert np.linalg.norm(Twc[:3, 3] - port_traj[back][:3, 3]) < 0.1
    assert np.linalg.norm(Twc[:3, 3] - world.poses_wc[back][:3, 3]) < 0.5


def _ate(world, traj):
    err = traj[:, :3, 3] - world.poses_wc[:, :3, 3]
    return np.sqrt(np.mean(np.sum(err ** 2, axis=-1)))


def _kf_centres(R, t):
    return np.einsum("kji,kj->ki", R, -t)


@pytest.fixture(scope="module")
def oracle_runs():
    """tests/test_vo_oracle.py's run (40 frames, no vocabulary): the
    reference, with its map after every frame that made a keyframe; the
    port alone; and the port given the reference's map after each such
    frame (every field, copied into its tensors in place)."""
    world = synthetic.make_landmark_world(n_frames=40, n_landmarks=4000, seed=0, speed=0.8)
    inputs = [((f.xy, f.uright, f.depth, f.desc, f.level), i * 0.1)
              for i, f in ((i, _frame(world, i)) for i in range(40))]
    cfg = make_cfg()
    maps = {}
    with x64_off():
        ref = RefStereoVO(cfg)
        for i, (args, ts) in enumerate(inputs):
            n_kf = ref.n_kf
            ref.process_oracle(*args, ts)
            if ref.n_kf != n_kf:
                maps[i] = {k: np.array(v) for k, v in zip(ref.map._fields, ref.map)}
        ref_traj = ref.trajectory_wc()
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    port = _drive(StereoVO(pcfg, device="cpu"), inputs)
    fed = StereoVO(pcfg, device="cpu")
    for i, (args, ts) in enumerate(inputs):
        fed.process_oracle(*args, ts)
        for k, v in maps.get(i, {}).items():
            dst = getattr(fed.map, k)
            dst.copy_(torch.from_numpy(v).to(dst.dtype))
    return dict(world=world, ref=ref, ref_traj=ref_traj, port=port,
                port_traj=port.trajectory_wc(), fed=fed, fed_traj=fed.trajectory_wc(),
                n_fed=len(maps))


def test_oracle_run_matches_reference(oracle_runs):
    """Every frame tracked as the reference tracks it, each frame's pose
    relative to its reference keyframe as the reference's until the
    inlier counts first differ, every position within twice the largest
    keyframe gap, and the reference test's bounds on the port (ATE
    < 0.30 m, inliers >= 30)."""
    world, ref, port = oracle_runs["world"], oracle_runs["ref"], oracle_runs["port"]
    ref_traj, port_traj = oracle_runs["ref_traj"], oracle_runs["port_traj"]
    _assert_same_run(ref, ref_traj, port, port_traj, atol=np.inf)
    assert all(r.state == "OK" for r in port.records) and port.n_kf >= 3
    assert min(s.n_inliers for s in port.stats[1:]) >= 30
    assert _ate(world, port_traj) < 0.30

    n_port = np.array([s.n_inliers for s in port.stats])
    n_ref = np.array([s.n_inliers for s in ref.stats])
    first = int(np.argmax(n_port != n_ref)) if np.any(n_port != n_ref) else len(n_ref)
    rel_gap = [np.linalg.norm(np.asarray(a.T_rel)[:3, 3] - b.T_rel[:3, 3])
               for a, b in zip(ref.records[:first], port.records[:first])]
    assert max(rel_gap) < 1e-3, rel_gap

    live = np.asarray(ref.map.kf_valid)
    kf_gap = np.linalg.norm(
        _kf_centres(port.map.kf_R.numpy()[live], port.map.kf_t.numpy()[live])
        - _kf_centres(np.asarray(ref.map.kf_R)[live], np.asarray(ref.map.kf_t)[live]), axis=-1)
    gap = np.linalg.norm(port_traj[:, :3, 3] - ref_traj[:, :3, 3], axis=-1)
    assert gap.max() <= 2.0 * kf_gap.max(), (gap.max(), kf_gap.max())


def test_oracle_run_fed_reference_map_tracks_to_reference(oracle_runs):
    """Given the reference's map after each keyframe, the port tracks
    every frame to the reference's pose: the same states and inlier
    counts, positions within 2e-5 m and the same ATE to 1e-5 m."""
    world, ref, fed = oracle_runs["world"], oracle_runs["ref"], oracle_runs["fed"]
    ref_traj, fed_traj = oracle_runs["ref_traj"], oracle_runs["fed_traj"]
    assert oracle_runs["n_fed"] == ref.n_kf >= 3
    _assert_same_run(ref, ref_traj, fed, fed_traj, atol=2e-5)
    assert [s.n_inliers for s in fed.stats] == [s.n_inliers for s in ref.stats]
    assert abs(_ate(world, fed_traj) - _ate(world, ref_traj)) < 1e-5


def test_young_lost_map_resets_like_reference():
    """Garbage frames past a 0.15 s grace window: RECENTLY_LOST, then LOST
    with 3 keyframes, and the next frame resets the system, which then
    initializes again. Both systems end in the same state."""
    world = synthetic.make_landmark_world(n_frames=12, n_landmarks=4000, seed=1, speed=0.8)
    rng = np.random.default_rng(7)
    inputs = [((f.xy, f.uright, f.depth, f.desc, f.level), i * 0.1)
              for i, f in ((i, _frame(world, i)) for i in range(5))]
    inputs += [(_garbage(rng), (5 + i) * 0.1) for i in range(4)]
    inputs += [((f.xy, f.uright, f.depth, f.desc, f.level), (9 + i) * 0.1)
               for i, f in ((i, _frame(world, 9 + i)) for i in range(3))]
    ref, ref_traj, port, port_traj = _pair(make_cfg(recently_lost_sec=0.15), inputs)
    _assert_same_run(ref, ref_traj, port, port_traj)
    assert port.n_kf >= 1 and len(port.records) < len(inputs)  # the reset dropped records


def test_timestamp_jump_resets_like_reference():
    """A timestamp going backwards resets both systems (no vocabulary, so
    no atlas); the next frames re-initialize and track."""
    world = synthetic.make_landmark_world(n_frames=10, n_landmarks=4000, seed=2, speed=0.8)
    frames = [_frame(world, i) for i in range(10)]
    inputs = [((f.xy, f.uright, f.depth, f.desc, f.level), i * 0.1) for i, f in enumerate(frames[:6])]
    inputs += [((f.xy, f.uright, f.depth, f.desc, f.level), 0.05 + i * 0.1)
               for i, f in enumerate(frames[6:])]
    ref, ref_traj, port, port_traj = _pair(make_cfg(), inputs)
    _assert_same_run(ref, ref_traj, port, port_traj)
    assert len(port.records) == 4 and port.state == "OK"


def test_atlas_fork_raises():
    """With a vocabulary, the atlas on and >= 5 keyframes, a timestamp jump
    forks a new map, in the reference and in the port (which raised here
    before the atlas slice): the active map is parked with its keyframes,
    and the next frame initializes map 1."""
    world = synthetic.make_landmark_world(n_frames=16, n_landmarks=4000, seed=0, speed=0.8)
    pvoc = vocabulary.train_vocabulary(world.desc[:3000], k=6, levels=3, iters=3,
                                       device="cpu")
    cfg = config_from_dict(dataclasses.asdict(make_cfg(max_frames_between_kf=1)))
    port = StereoVO(cfg, device="cpu", vocab=pvoc)
    for i in range(8):
        f = _frame(world, i)
        port.process_oracle(f.xy, f.uright, f.depth, f.desc, f.level, i * 0.1)
    assert port.n_kf >= 5 and port._atlas_ready()
    n_kf = port.n_kf
    f = _frame(world, 8)
    port.process_oracle(f.xy, f.uright, f.depth, f.desc, f.level, 100.0)
    assert port.program_runs["fork"] == 1 and len(port.atlas_stored) == 1
    assert port.atlas_stored[0].map_id == 0 and port.atlas_stored[0].n_kf == n_kf
    assert (port.active_map_id, port.n_kf, port.state) == (1, 1, "OK")
    assert [r.map_id for r in port.records] == [0] * 8 + [1]
    assert port.trajectory_wc().shape == (9, 4, 4)
