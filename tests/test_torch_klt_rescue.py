"""The KLT frontend's ORB rescue on every frame: the JAX package's
KltStereoVO and the port's, both on the CPU, the port fed the reference's
features.

tests/test_torch_klt_vo.py's world and configuration with
`klt_rescue_min` above any inlier count, so that every tracked frame
extracts ORB features and runs `StereoVO._track` as the rescue, and keeps
its result where it has more inliers than the LK passes. Fed through the
same image-pair keys as tests/test_torch_klt_vo.py: the rescue frames,
per-frame states, reference keyframes, keyframe frames, inlier, track and
map-point counts equal; poses within 1e-4 m (float32 LK and Gauss-Newton
summed in another order). The reference runs with x64 off (a fresh
context per use).
"""

import jax
import pytest
import torch
from test_torch_klt_vo import (
    N_FRAMES, ReferenceFeatures, assert_runs_equal, drive, klt_cfg, port_cfg, render_frames,
    rescue_frames, summary,
)

from vi_slam_tpu.pipeline.klt_vo import make_stereo_vo as ref_make_stereo_vo
from vi_slam_tpu_torch.io import synthetic
from vi_slam_tpu_torch.pipeline.stereo_vo import make_stereo_vo


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


@pytest.fixture(scope="module")
def rescue_runs():
    world = synthetic.make_billboard_world(n_frames=N_FRAMES, n_boards=1500, seed=11, speed=1.0)
    frames = render_frames(world)
    cfg = klt_cfg(klt_rescue_min=10 ** 6)
    ts = [i * 0.1 for i in range(N_FRAMES)]
    with x64_off():
        ref = ref_make_stereo_vo(cfg)
        store = ReferenceFeatures(ref)
        ref_run = summary(ref, drive(ref, frames, ts))
    ref_run["rescues"] = rescue_frames(store, frames)
    fed = make_stereo_vo(port_cfg(cfg), device="cpu")
    store.feed(fed)
    fed_run = summary(fed, drive(fed, frames, ts))
    fed_run["rescues"] = list(fed.rescue_frames)
    return ref_run, fed_run


def test_rescue_every_frame_fed_equals_reference(rescue_runs):
    ref, fed = rescue_runs
    assert fed["rescues"] == ref["rescues"] == list(range(1, N_FRAMES))
    assert_runs_equal(ref, fed)
    assert all(r.state == "OK" for r in ref["records"])
