"""The port's synthetic worlds (`vi_slam_tpu_torch/io/synthetic.py`, numpy
copies that import nothing of the JAX package) against the JAX package's,
from the same seeds: the oracle path's landmark world, its per-frame
observations and descriptor noise; the inertial world's trajectory, open
and closed; bench.py --loop's billboard sequence; and the board ring of
`chip_smoke.py`'s ring phase, which the reference builds in
`tools/slice_reference_ate.py --ring` from its own functions, as here.

Both sides run the same numpy operations on the same generators, so every
array is exactly equal. Images are small (160x120, a few frames) to keep
the file fast.
"""

import jax
import numpy as np
import pytest

from vi_slam_tpu.io import synthetic as ref_synthetic
from vi_slam_tpu_torch.io import synthetic

W, H = 160, 120
FX = FY = 92.7
CX, CY = 78.2, 59.1
BF = 49.8


@pytest.fixture(autouse=True)
def _x64_restored():
    yield
    assert jax.config.jax_enable_x64 is True, "a test left JAX's x64 mode off"


def _assert_same(got, want):
    assert type(got).__name__ == type(want).__name__
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_landmark_world_oracle_frames_and_noise_match_reference():
    world = synthetic.make_landmark_world(n_frames=12, n_landmarks=2000, seed=0, speed=0.8)
    want = ref_synthetic.make_landmark_world(n_frames=12, n_landmarks=2000, seed=0, speed=0.8)
    _assert_same(world, want)
    for i in (0, 7):
        _assert_same(
            synthetic.render_oracle_frame(world, i, 500.0, 500.0, 320.0, 240.0, 250.0, 640, 480,
                                          max_features=1000, px_noise=0.3),
            ref_synthetic.render_oracle_frame(want, i, 500.0, 500.0, 320.0, 240.0, 250.0, 640,
                                              480, max_features=1000, px_noise=0.3))
    got = synthetic.flip_descriptor_bits(world.desc[:300], 20, np.random.default_rng(3))
    np.testing.assert_array_equal(
        got, ref_synthetic.flip_descriptor_bits(want.desc[:300], 20, np.random.default_rng(3)))


@pytest.mark.parametrize("closed", [False, True], ids=["open", "closed_loop"])
def test_inertial_world_matches_reference(closed):
    kw = dict(n_frames=30, fps=10.0, n_landmarks=500, seed=11, speed=5.0, closed_loop=closed,
              closed_loop_period_frames=24 if closed else 0)
    _assert_same(synthetic.make_inertial_world(**kw).world,
                 ref_synthetic.make_inertial_world(**kw).world)


def test_billboard_inertial_sequence_matches_reference():
    """bench.py --loop's sequence, cut to 4 frames of 160x120."""
    kw = dict(fps=10.0, n_landmarks=300, n_boards=400, seed=11, closed_loop=True,
              closed_loop_period_frames=3, speed=5.0)
    world, boards, frames = synthetic.make_billboard_inertial_sequence(
        4, FX, FY, CX, CY, W, H, BF, **kw)
    ref_world, ref_boards, ref_frames = ref_synthetic.make_billboard_inertial_sequence(
        4, FX, FY, CX, CY, W, H, BF, **kw)
    _assert_same(world.world, ref_world.world)
    _assert_same(boards, ref_boards)
    for (a, b), (c, d) in zip(frames, ref_frames):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_board_ring_loop_matches_reference():
    """`make_board_ring_loop` against the same world built from the JAX
    package's functions, and its rendered pairs."""
    n, period, radius, nb = 4, 100, 3.0, 300
    boards = synthetic.make_board_ring_loop(n, period, radius, n_boards=nb)
    w_c = 2 * np.pi / (period / 10.0)
    iw = ref_synthetic.make_inertial_world(
        n_frames=n, fps=10.0, n_landmarks=10, seed=11, speed=radius * w_c, closed_loop=True,
        closed_loop_period_frames=period)
    rng = np.random.default_rng(13)
    ang = rng.uniform(0, 2 * np.pi, nb)
    rad = rng.uniform(radius + 4, radius + 25, nb)
    centers = np.stack([radius - rad * np.cos(ang), rng.uniform(-3, 2, nb), rad * np.sin(ang)],
                       -1)
    want = ref_synthetic.BillboardWorld(
        centers=centers, sizes=rng.uniform(0.3, 1.2, nb), intensities=rng.uniform(60, 255, nb),
        poses_wc=iw.world.poses_wc, textures=rng.uniform(30, 255, (nb, 5, 5)).astype(np.float32))
    _assert_same(boards, want)
    for T in boards.poses_wc:
        for base in (0.0, BF / FX):
            np.testing.assert_array_equal(
                synthetic.render_billboard_image(boards, T, FX, FY, CX, CY, W, H, baseline=base),
                ref_synthetic.render_billboard_image(want, T, FX, FY, CX, CY, W, H,
                                                     baseline=base))
