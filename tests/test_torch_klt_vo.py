"""The KLT frontend end to end: the JAX package's KltStereoVO and the
port's, both on the CPU, over the same short rendered billboard world.

320x240, 500 features, 12 frames, pipeline_depth 3, bench.py's keyframe
policy (min_frames_between_kf=1) with the keyframe-rate programs set
beyond the run, `frontend="klt"`. 4 pyramid levels for ORB (compiling the
reference's extraction costs about 26 s a program at 8; extraction at 8
levels is held to the reference in tests/test_torch_frontend.py), and
`klt_min_tracks` 90 instead of 350: 350 is sized for 2000 features, and
at 500 every frame would be "starving" and make a keyframe, so the frames
between keyframes (LK only) would never run.

The reference extracts ORB features inside its fused KLT frame program
(the rescue and the keyframe branches) and in separately compiled
programs (initialization, a failed frame); the port extracts only where
it needs to. `ReferenceFeatures` records every reference extraction by
the bytes of its image pair (inside the fused program through
`jax.debug.callback`), and the frames whose rescue ran; a fed port looks
its features up by the same key.

  * Fed: per-frame states, reference keyframes, keyframe frames, rescue
    frames, inlier, track and map-point counts equal; poses within 1e-4 m
    (float32 LK and Gauss-Newton summed in another order).
  * Own extraction: 0 lost, ATE within max(1 cm, 20 %) of the
    reference's (its features differ from the reference's in flat-pair
    descriptor bits and the resampled levels, ROADMAP H6/H7).
  * A timestamp jump mid-run resets both systems and clears their tracks;
    the records after it are equal.

A rescue on every frame, relocalization through the KLT failure path and
RGB-D ingest are in tests/test_torch_klt_rescue.py,
tests/test_torch_klt_reloc.py and tests/test_torch_rgbd.py (each file
stays under 240 s of one worker). The reference runs with x64 off (a
fresh context per use).
"""

import dataclasses
import hashlib

import jax
import numpy as np
import pytest
import torch

from vi_slam_tpu.pipeline.klt_vo import make_stereo_vo as ref_make_stereo_vo
from vi_slam_tpu.utils import config as rc
from vi_slam_tpu_torch.features.extractor import Features
from vi_slam_tpu_torch.io import evaluation, synthetic
from vi_slam_tpu_torch.pipeline.stereo_vo import make_stereo_vo
from vi_slam_tpu_torch.utils.config import config_from_dict

W, H = 320, 240
FX = FY = 300.0
CX, CY = W / 2, H / 2
BASE = 0.5
N_FRAMES = 12
NEVER = 10 ** 9
JUMP_AT = 8  # the frame whose timestamp jumps by 100 s


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


def klt_cfg(**tracker):
    kw = dict(min_frames_between_kf=1, pipeline_depth=3, maintenance_every=NEVER,
              local_ba_every=NEVER, mapping_every=NEVER, frontend="klt", klt_min_tracks=90)
    kw.update(tracker)
    return rc.SystemConfig(
        camera=rc.CameraConfig(width=W, height=H, fx=FX, fy=FY, cx=CX, cy=CY,
                               bf=FX * BASE, th_depth=35.0),
        extractor=rc.ExtractorConfig(n_features=500, cell_size=16, n_levels=4),
        ba=rc.BAConfig(max_local_kfs=6, max_local_points=1024),
        map=rc.MapConfig(max_keyframes=32, max_points=8192, max_obs_per_point=8),
        tracker=rc.TrackerConfig(**kw),
    )


def port_cfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def render_frames(world, poses=None):
    """(left, right) of each pose (default: the world's trajectory)."""
    poses = world.poses_wc if poses is None else poses
    return [(synthetic.render_billboard_image(world, T, FX, FY, CX, CY, W, H, baseline=0.0),
             synthetic.render_billboard_image(world, T, FX, FY, CX, CY, W, H, baseline=BASE))
            for T in poses]


def image_key(imgs) -> str:
    """The key of a (2, H, W) image pair: the hash of its uint8 bytes, as
    both systems upload it."""
    return hashlib.sha1(np.ascontiguousarray(np.asarray(imgs), np.uint8).tobytes()).hexdigest()


def pair_key(left, right) -> str:
    return image_key(np.stack([left, right]).astype(np.uint8))


def port_features(f, u, d):
    f = list(f)
    f[4] = f[4].view(np.int32)
    return (Features(*(torch.from_numpy(np.array(x)) for x in f)), torch.from_numpy(np.array(u)),
            torch.from_numpy(np.array(d)))


class ReferenceFeatures:
    """Every extraction of a reference KltStereoVO by its image pair's key
    (the separately compiled `_extract_pair_fn`, and `_extract_pair_core`
    inside the fused KLT frame), and the keys of the frames whose rescue
    ran the ORB tracking (`_track_core` inside the fused frame). Install
    before the reference's first frame: the fused program reads both
    cores when it is traced."""

    def __init__(self, ref):
        self.by_key = {}
        self._rescue_xy = set()
        self.wrap(ref)

    def wrap(self, ref):
        fn = ref._extract_pair_fn

        def extract_fn(imgs):
            out = fn(imgs)
            self._record(imgs, *out[0], out[1], out[2])
            return out

        core = ref._extract_pair_core

        def extract_core(imgs):
            out = core(imgs)
            jax.debug.callback(self._record, imgs, *out[0], out[1], out[2])
            return out

        track = ref._track_core

        def track_core(mstate, ref_slot, feats, *rest):
            jax.debug.callback(self._rescued, feats.xy)
            return track(mstate, ref_slot, feats, *rest)

        ref._extract_pair_fn, ref._extract_pair_core, ref._track_core = (
            extract_fn, extract_core, track_core)

    def _record(self, imgs, *arrays):
        k = image_key(imgs)
        got = ([np.array(a) for a in arrays[:6]], np.array(arrays[6]), np.array(arrays[7]))
        if k in self.by_key:  # the rescue and the keyframe branch of one frame
            for a, b in zip(self.by_key[k][0], got[0]):
                np.testing.assert_array_equal(a, b)
        self.by_key[k] = got

    def _rescued(self, xy):
        self._rescue_xy.add(np.array(xy).tobytes())

    def rescue_keys(self):
        return {k for k, v in self.by_key.items() if v[0][0].tobytes() in self._rescue_xy}

    def feed(self, vo):
        """Make a port StereoVO extract by looking the reference's features
        up."""
        vo._extract_pair = lambda imgs: port_features(*self.by_key[image_key(imgs.cpu().numpy())])


def drive(vo, frames, timestamps):
    for (left, right), ts in zip(frames, timestamps):
        vo.process_stereo(left, right, ts)
    return vo.trajectory_wc()


def summary(vo, traj):
    """What a run leaves: per-frame records and stats, counts, trajectory."""
    return dict(records=list(vo.records), stats=list(vo.stats), n_kf=vo.n_kf, n_mp=vo.n_mp,
                traj=traj)


def kf_frames(records):
    return [np.array_equal(r.T_rel, np.eye(4)) for r in records]


def assert_runs_equal(ref, port, atol=1e-4):
    """Per-frame states, reference keyframes, frame ids, keyframe frames,
    inlier, track and map-point counts equal; poses within `atol`."""
    rr, pr = ref["records"], port["records"]
    assert [r.state for r in pr] == [r.state for r in rr]
    assert [r.ref_kf for r in pr] == [r.ref_kf for r in rr]
    assert [r.frame_id for r in pr] == [r.frame_id for r in rr]
    assert kf_frames(pr) == kf_frames(rr)
    for name in ("n_inliers", "n_local_points", "n_matches", "n_mps", "n_kfs"):
        assert [getattr(s, name) for s in port["stats"]] == [
            getattr(s, name) for s in ref["stats"]], name
    assert (port["n_kf"], port["n_mp"]) == (ref["n_kf"], ref["n_mp"])
    assert port["traj"].shape == ref["traj"].shape
    np.testing.assert_allclose(port["traj"], ref["traj"], rtol=0, atol=atol)


def ate(traj, world):
    return evaluation.ate_rmse(traj[:, :3, 3], world.poses_wc[:len(traj), :3, 3])["rmse"]


def rescue_frames(store, frames):
    keys = store.rescue_keys()
    return [i for i, f in enumerate(frames) if pair_key(*f) in keys]


@pytest.fixture(scope="module")
def world_frames():
    world = synthetic.make_billboard_world(n_frames=N_FRAMES, n_boards=1500, seed=11, speed=1.0)
    return world, render_frames(world)


@pytest.fixture(scope="module")
def runs(world_frames):
    """The reference, the port fed its features and the port on its own,
    over the 12 frames; then the reference and the fed port again, each
    after a reset, over the same frames with a timestamp jump at JUMP_AT."""
    world, frames = world_frames
    cfg = klt_cfg()
    ts = [i * 0.1 for i in range(N_FRAMES)]
    with x64_off():
        ref = ref_make_stereo_vo(cfg)
        store = ReferenceFeatures(ref)
        ref_run = summary(ref, drive(ref, frames, ts))
    fed = make_stereo_vo(port_cfg(cfg), device="cpu")
    store.feed(fed)
    fed_run = summary(fed, drive(fed, frames, ts))
    fed_run.update(rescues=list(fed.rescue_frames), klt_kfs=list(fed.klt_kf_frames))
    ref_run["rescues"] = rescue_frames(store, frames)
    own = make_stereo_vo(port_cfg(cfg), device="cpu")
    own_run = summary(own, drive(own, frames, ts))

    # the timestamp jump; each reset notes whether the tracks are cleared
    cleared = {}

    def watch(vo, name, tracks_cleared):
        reset = vo.reset

        def wrapped():
            reset()
            cleared.setdefault(name, []).append(tracks_cleared(vo))

        vo.reset = wrapped

    watch(ref, "ref", lambda v: v.prev_pyr_dev is None and not np.asarray(v.trk_valid_dev).any())
    watch(fed, "port", lambda v: v.prev_pyr is None and not bool(v.trk_valid.any()))
    jump_ts = [t + (100.0 if i >= JUMP_AT else 0.0) for i, t in enumerate(ts)]
    with x64_off():
        ref.reset()
        ref_jump = summary(ref, drive(ref, frames, jump_ts))
    fed.reset()
    fed_jump = summary(fed, drive(fed, frames, jump_ts))
    return dict(world=world, frames=frames, store=store, ref=ref_run, fed=fed_run, own=own_run,
                ref_jump=ref_jump, fed_jump=fed_jump, cleared=cleared)


def test_fed_run_equals_reference(runs):
    """Every discrete decision equal, poses within 1e-4 m; the run has
    keyframe and non-keyframe frames and a rescue, and no frame lost."""
    ref, fed = runs["ref"], runs["fed"]
    assert all(r.state == "OK" for r in ref["records"])
    assert_runs_equal(ref, fed)
    assert fed["rescues"] == ref["rescues"] != []
    kfs = kf_frames(fed["records"])
    assert 3 <= sum(kfs) < N_FRAMES
    # the keyframes after initialization came from the KLT keyframe branch
    assert fed["klt_kfs"] == [i for i, k in enumerate(kfs) if k and i > 0]


def test_own_extraction_tracks_like_reference(runs):
    world, ref, own = runs["world"], runs["ref"], runs["own"]
    assert all(r.state == "OK" for r in own["records"])
    assert np.all(np.isfinite(own["traj"]))
    ref_ate, own_ate = ate(ref["traj"], world), ate(own["traj"], world)
    assert abs(own_ate - ref_ate) <= max(0.01, 0.2 * ref_ate), (own_ate, ref_ate)


def test_timestamp_jump_resets_and_clears_tracks(runs):
    """The jump resets both systems (no atlas without a vocabulary) with
    their tracks cleared; the jumped frame initializes a new map and the
    records after it are equal."""
    assert runs["cleared"] == {"ref": [True, True], "port": [True, True]}
    ref, fed = runs["ref_jump"], runs["fed_jump"]
    assert len(fed["records"]) == N_FRAMES - JUMP_AT
    assert fed["records"][0].timestamp == 100.0 + JUMP_AT * 0.1
    assert_runs_equal(ref, fed)
