"""The port's stereo-inertial pipeline with the fixed-lag smoother
(`cfg.ba.use_smoother`) against the JAX package's, fed the same oracle
frames and IMU stream, on the CPU.

tests/test_vio.py::TestSmootherPath's world (its oracle world: seed 3,
640x480, 1200 features, 200 Hz IMU) with tests/test_torch_vio.py's
configuration and the smoother on: 32 clean frames, through the first
initialization stage (2 s of keyframes, at frame 20) and far enough after
it for the 6-slot window to slide at least three times (13 slides in 19
steps), then a dropout of
4 frames (3 features each) bridged by dead reckoning, and 4 frames after
it. Every inertial frame runs a smoother step; its window restarts at
each initialization stage and whole-chain inertial BA, and takes each VI
local BA's correction.

Equal: every frame's state and reference keyframe, the keyframes, the
initialization stages and their frames, the smoother's steps and slides.
Within tests/test_torch_vio.py's `_assert_same` tolerances: trajectory
2e-3 m, velocity 1e-3 m/s, biases 2e-5 rad/s and 2e-4 m/s^2, gravity
0.01 deg (measured 2.0e-4 m, 7.7e-4 m/s, 2.0e-6, 3.0e-5, 1.9e-5 deg). The
window's poses right after each VI local BA's shift within 2e-3 m and
2e-3 (measured 2.5e-4 m and 7.7e-6).

The reference runs with x64 off (a fresh `jax.enable_x64(False)` per use).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_vio import _assert_same, _frame, _oracle, _pair, make_cfg

from vi_slam_tpu.pipeline.vio import StereoInertialVO as RefVIO
from vi_slam_tpu_torch.io import synthetic
from vi_slam_tpu_torch.pipeline.vio import StereoInertialVO

N_CLEAN, N_DROP, N_AFTER = 32, 4, 4


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


def _window_poses(vo):
    """The smoother window's filled slots after a VI local BA: (count,
    T_R, T_t)."""
    w = vo.smoother_win
    n = min(int(np.asarray(vo.smoother_count)), vo.cfg.ba.smoother_window)
    g = lambda x: np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)[:n]
    return n, g(w.T_R), g(w.T_t)


def _instrument(mp):
    """Both pipelines log the window after each VI local BA (its shift);
    the reference also logs its step count before every inertial track
    (one smoother step each; the window slides when the count is at the
    window's size)."""

    def local_ba(orig):
        def wrapped(self):
            out = orig(self)
            if self.imu_ready:
                self.test_shifts = getattr(self, "test_shifts", []) + [_window_poses(self)]
            return out
        return wrapped

    build = RefVIO._build_vio_fns

    def build_counted(self):
        build(self)
        track = self._track_vio_fn
        self.test_counts = []

        def counted(*a):
            self.test_counts.append(int(a[-1]))
            return track(*a)

        self._track_vio_fn = counted

    mp.setattr(RefVIO, "_build_vio_fns", build_counted)
    mp.setattr(RefVIO, "_local_ba", local_ba(RefVIO._local_ba))
    mp.setattr(StereoInertialVO, "_local_ba", local_ba(StereoInertialVO._local_ba))


def _smoother_run():
    n = N_CLEAN + N_DROP + N_AFTER
    iw = synthetic.make_inertial_world(n_frames=n, fps=10.0, n_landmarks=5000, seed=3)
    inputs = []
    for i in range(n):
        dropped = N_CLEAN <= i < N_CLEAN + N_DROP
        inputs.append((_oracle(_frame(iw.world, i, 3 if dropped else 1000)),
                       iw.imu_per_frame[i], iw.timestamps[i]))
    cfg = make_cfg()
    cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, use_smoother=True))
    with pytest.MonkeyPatch.context() as mp:
        _instrument(mp)
        return iw, _pair(cfg, inputs, snap_at=(N_CLEAN - 1,))


@pytest.fixture(scope="module")
def smoother_run():
    return _smoother_run()


def test_smoother_run_matches_reference(smoother_run):
    """The clean frames: every frame tracked as the reference tracks it,
    the initialization stage on the same frame, the same keyframes and
    chain, the same smoother steps (one per inertial track) and slides
    (at least three), and the state within `_assert_same`'s tolerances."""
    iw, (ref, (r_snaps, r_stages, _), port, (p_snaps, p_stages, _)) = smoother_run
    got, want = p_snaps[N_CLEAN - 1], r_snaps[N_CLEAN - 1]
    _assert_same(got, want)
    assert p_stages == r_stages and len(p_stages) >= 1
    assert got.imu_ready and got.states.count("OK") == N_CLEAN
    runs = port.program_runs
    SW = port.cfg.ba.smoother_window
    assert runs["smoother"] == runs["track_vio"] == len(ref.test_counts) > 0
    assert runs["smoother_slide"] == sum(c >= SW for c in ref.test_counts) >= 3
    assert port.smoother_count == int(np.asarray(ref.smoother_count))


def test_smoother_rides_dropout_like_reference(smoother_run):
    """The dropout and after: RECENTLY_LOST on the dropped frames, OK
    again after them, never LOST, the same states, and the end state
    within `_assert_same`'s tolerances."""
    iw, (ref, (_, r_stages, r_end), port, (_, p_stages, p_end)) = smoother_run
    _assert_same(p_end, r_end)
    assert p_stages == r_stages
    dropped = p_end.states[N_CLEAN:N_CLEAN + N_DROP]
    assert "RECENTLY_LOST" in dropped and "LOST" not in p_end.states
    assert p_end.states[-1] == "OK"


def test_smoother_window_shifted_by_local_ba_like_reference(smoother_run):
    """After every VI local BA both windows took its correction: the same
    number of filled slots, their poses within 2e-3 m and 2e-3, and at
    least one such shift of a filled window."""
    _, (ref, _, port, _) = smoother_run
    assert len(port.test_shifts) == len(ref.test_shifts) >= 1
    assert any(n > 0 for n, _, _ in port.test_shifts)
    for (n_p, R_p, t_p), (n_r, R_r, t_r) in zip(port.test_shifts, ref.test_shifts):
        assert n_p == n_r
        np.testing.assert_allclose(t_p, t_r, rtol=0, atol=2e-3)
        np.testing.assert_allclose(R_p, R_r, rtol=0, atol=2e-3)
