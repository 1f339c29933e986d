"""Relocalization through the KLT frontend's failure path
(`KltStereoVO._handle_failure`): the JAX package's KltStereoVO and the
port's, both on the CPU, fed the same features.

tests/test_torch_klt_vo.py's world and configuration with a vocabulary
(trained on the run's own ORB descriptors, as bench.py trains one), the
atlas off, and the ORB rescue off (`klt_rescue_min` 0): with it on, the
rescue's wide search from the frozen pose re-finds the map on the
kidnapped frame below, and the failure ladder is not reached. The run:
frames 0-9 of the world; two random-texture pairs in place of frames 10
and 11, which LK fails to track; then the view of frame 0 again (the
camera kidnapped back about 10 m) and of frames 1 and 2. A KLT frame
carries no features, so each failed frame extracts them for the
relocalization ladder. Frame 0's view finds no fix; frame 1's does (the
keyframe database and a PnP RANSAC, then the local-map tracking at the
fix), and the track set is rebuilt from that tracking; frame 2's view,
dispatched before that fix with the frozen pose and the lost tracks
(`pipeline_depth` 3), fails its LK and relocalizes in turn.

The port's PnP and Sim3 samples are the reference's draws
(`ReferenceDraws`: keys 11 and 7, split per attempt, as
tests/test_torch_reloc.py feeds them), so the frames lost, the
relocalization attempts and their outcomes, the relocalized frame and the
re-seeded track set (positions, map points, validity) must be equal, and
so must every later frame's state and counts; poses within 1e-3 m
(tests/test_torch_reloc.py's bound after a relocalization: the PnP
refinement and the local-map Gauss-Newton in float32).
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_klt_vo import (
    ReferenceFeatures, drive, kf_frames, klt_cfg, port_cfg, render_frames, summary,
)
from test_torch_loop_parts import ReferenceDraws

from vi_slam_tpu.pipeline.klt_vo import make_stereo_vo as ref_make_stereo_vo
from vi_slam_tpu.retrieval import vocabulary as ref_voc
from vi_slam_tpu_torch.features.extractor import OrbExtractor
from vi_slam_tpu_torch.io import synthetic
from vi_slam_tpu_torch.pipeline.stereo_vo import make_stereo_vo
from vi_slam_tpu_torch.retrieval import vocabulary

MAPPED = 10  # frames of the world before the random pairs
GARBAGE = 2
REVISIT = (0, 1, 2)  # the world frames shown after them


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


def _kidnap_frames():
    world = synthetic.make_billboard_world(n_frames=12, n_boards=1500, seed=11, speed=1.0)
    frames = render_frames(world)
    rng = np.random.default_rng(5)
    h, w = frames[0][0].shape
    garbage = [(rng.uniform(0, 255, (h, w)).astype(np.float32),
                rng.uniform(0, 255, (h, w)).astype(np.float32)) for _ in range(GARBAGE)]
    return frames[:MAPPED] + garbage + [frames[i] for i in REVISIT]


def _vocabulary_descriptors(cfg, frames):
    """The ORB descriptors of every other mapped left image (the port's
    extractor; the same array trains both vocabularies)."""
    ext = OrbExtractor(port_cfg(cfg).extractor, cfg.camera.height, cfg.camera.width,
                       device="cpu")
    descs = []
    for left, _ in frames[:MAPPED:2]:
        f, _ = ext.extract(torch.from_numpy(np.asarray(left, np.float32)))
        descs.append(f.desc[f.valid].numpy())
    return np.concatenate(descs).view(np.uint32)


def _watch(vo, log):
    """Log each relocalization attempt's frame and inliers, and each
    re-seeded track set."""
    reloc = vo._try_relocalize

    def attempt(feats, uright):
        n = reloc(feats, uright)
        log["reloc"].append(n)
        return n

    seed = vo._seed_tracks

    def seeded(feats, mp_ids):
        log["seeds"].append((np.array(feats.xy), np.array(mp_ids), np.array(feats.valid)))
        return seed(feats, mp_ids)

    vo._try_relocalize, vo._seed_tracks = attempt, seeded


@pytest.fixture(scope="module")
def runs():
    frames = _kidnap_frames()
    cfg = klt_cfg(atlas_enabled=False, klt_rescue_min=0)
    desc = _vocabulary_descriptors(cfg, frames)
    ts = [i * 0.1 for i in range(len(frames))]
    ref_log, fed_log = dict(reloc=[], seeds=[]), dict(reloc=[], seeds=[])
    with x64_off():
        ref = ref_make_stereo_vo(cfg, vocab=ref_voc.train_vocabulary(desc, k=8, levels=3,
                                                                    iters=4, seed=3))
        store = ReferenceFeatures(ref)
        _watch(ref, ref_log)
        ref_run = summary(ref, drive(ref, frames, ts))
    fed = make_stereo_vo(port_cfg(cfg), vocab=vocabulary.train_vocabulary(
        desc, k=8, levels=3, iters=4, seed=3, device="cpu"), device="cpu")
    fed.relocalizer.draw = ReferenceDraws(11)
    fed.loop_closer.draw = ReferenceDraws(7)
    store.feed(fed)
    _watch(fed, fed_log)
    fed_run = summary(fed, drive(fed, frames, ts))
    return dict(ref=ref_run, fed=fed_run, ref_log=ref_log, fed_log=fed_log,
                n_relocalized=fed.n_relocalized)


def test_kidnap_relocalizes_through_the_klt_failure_path(runs):
    """The random pairs and the kidnapped frame are lost, every failed
    frame attempts a relocalization (the same inlier count on both sides:
    the same draws), and the revisited views relocalize on the same
    frames."""
    ref, fed = runs["ref"], runs["fed"]
    states = [r.state for r in ref["records"]]
    assert [r.state for r in fed["records"]] == states
    assert states == ["OK"] * MAPPED + ["RECENTLY_LOST"] * (GARBAGE + 1) + ["OK"] * 2
    assert runs["fed_log"]["reloc"] == runs["ref_log"]["reloc"]
    assert [n > 0 for n in runs["ref_log"]["reloc"]] == [False] * (GARBAGE + 1) + [True] * 2
    assert runs["n_relocalized"] == 2
    assert [r.ref_kf for r in fed["records"]] == [r.ref_kf for r in ref["records"]]
    assert kf_frames(fed["records"]) == kf_frames(ref["records"])


def test_reseeded_tracks_equal(runs):
    """Every track set seeded (at initialization and after each
    relocalization): positions, map points and validity equal."""
    ref_seeds, fed_seeds = runs["ref_log"]["seeds"], runs["fed_log"]["seeds"]
    assert len(fed_seeds) == len(ref_seeds) == 3
    for (rx, rm, rv), (px, pm, pv) in zip(ref_seeds, fed_seeds):
        np.testing.assert_array_equal(px, rx)
        np.testing.assert_array_equal(pm, rm)
        np.testing.assert_array_equal(pv, rv)
    assert (fed_seeds[1][1] >= 0).sum() > 50


def test_counts_and_poses_after_relocalization(runs):
    ref, fed = runs["ref"], runs["fed"]
    for name in ("n_inliers", "n_local_points", "n_mps", "n_kfs"):
        assert [getattr(s, name) for s in fed["stats"]] == [
            getattr(s, name) for s in ref["stats"]], name
    ok = [i for i, r in enumerate(ref["records"]) if r.state == "OK"]
    np.testing.assert_allclose(fed["traj"][ok], ref["traj"][ok], rtol=0, atol=1e-3)
