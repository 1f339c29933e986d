"""The port's IMU preintegration (`imu/preintegration.py`) against the JAX
package's, and the port's IMU stream of the inertial world against the
reference's.

Inputs: tests/test_imu.py's simulated motion (constant body rate and
world acceleration, 1000 samples at 1 kHz, with and without biases) and
tests/test_vio.py::TestPreintegrationCompose's random batch (40 samples at
200 Hz, split 25 + 15 and composed). The reference runs with x64 off (a
fresh `jax.enable_x64(False)` per use).

Tolerances: deltas, bias Jacobians and predicted states within rtol 1e-5
of the largest entry of each (float32 chains of up to 1000 products, in
another order of operations: measured up to 2e-6); covariance and
information within rtol 1e-4 of their largest entry (a 9x9 inverse of a
covariance whose entries span eight decades). The padded and unpadded
integrations of the port are exactly equal, and the inertial world's
IMU samples are bit-equal to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_imu import CALIB as REF_CALIB
from test_imu import simulate
from test_torch_loop_parts import x64_off

from vi_slam_tpu.imu import preintegration as ref_pre
from vi_slam_tpu.io import synthetic as ref_synthetic
from vi_slam_tpu_torch.imu import preintegration as pre
from vi_slam_tpu_torch.io import synthetic

CALIB = pre.ImuCalib.make(1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3, 200.0)
DELTAS = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "dt", "bias_gyro", "bias_acc")


@pytest.fixture(autouse=True)
def _x64_restored():
    yield
    assert jax.config.jax_enable_x64 is True, "a test left JAX's x64 mode off"


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rtol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _assert_preint_close(got: pre.Preintegrated, want):
    for k in DELTAS:
        _close(getattr(got, k).numpy(), getattr(want, k), 1e-5)
    _close(got.C.numpy(), want.C, 1e-4)


def _both(acc, gyro, dts, bg, ba):
    with x64_off():
        want = ref_pre.integrate(REF_CALIB, jnp.asarray(acc), jnp.asarray(gyro),
                                 jnp.asarray(dts), jnp.asarray(bg, jnp.float32),
                                 jnp.asarray(ba, jnp.float32))
        want = ref_pre.Preintegrated(*(np.asarray(x) for x in want))
    return pre.integrate(CALIB, T(acc), T(gyro), T(dts), T(bg), T(ba)), want


def _vio_batch():
    """tests/test_vio.py::TestPreintegrationCompose's inputs."""
    rng = np.random.default_rng(0)
    acc = (rng.normal(0, 2, (40, 3)) + np.array([0, 0, 9.8])).astype(np.float32)
    gyro = rng.normal(0, 0.3, (40, 3)).astype(np.float32)
    dts = np.full((40,), 1 / 200.0, np.float32)
    return acc, gyro, dts, [0.01, -0.02, 0.005], [0.1, -0.05, 0.02]


@pytest.mark.parametrize("biased", [False, True], ids=["no_bias", "bias"])
def test_integrate_matches_reference(biased):
    """tests/test_imu.py's 1000-sample motion, integrated at zero bias and
    at the biases of its Jacobian test."""
    bg = [0.02, -0.01, 0.015] if biased else [0.0, 0.0, 0.0]
    ba = [0.1, -0.05, 0.08] if biased else [0.0, 0.0, 0.0]
    acc, gyro, dts, _ = simulate(bias_g=np.array(bg), bias_a=np.array(ba))
    got, want = _both(acc, gyro, dts, bg, ba)
    _assert_preint_close(got, want)
    _close(pre.information(got).numpy(), np.asarray(ref_pre.information(want)), 1e-4)


def test_integrate_and_compose_match_reference():
    """The 40-sample batch whole and split 25 + 15: each integration, the
    composition of the halves, and the composition of the halves as a
    stacked (2,) chain with the whole batch twice."""
    acc, gyro, dts, bg, ba = _vio_batch()
    full, want_full = _both(acc, gyro, dts, bg, ba)
    h1, w1 = _both(acc[:25], gyro[:25], dts[:25], bg, ba)
    h2, w2 = _both(acc[25:], gyro[25:], dts[25:], bg, ba)
    for got, want in ((full, want_full), (h1, w1), (h2, w2)):
        _assert_preint_close(got, want)
    with x64_off():
        want = ref_pre.compose(ref_pre.Preintegrated(*map(jnp.asarray, w1)),
                               ref_pre.Preintegrated(*map(jnp.asarray, w2)))
        want = ref_pre.Preintegrated(*(np.asarray(x) for x in want))
        want_info = np.asarray(ref_pre.information(want))
    got = pre.compose(h1, h2)
    _assert_preint_close(got, want)
    _close(pre.information(got).numpy(), want_info, 1e-4)
    stacked = pre.compose(pre.map_preint(lambda a, b: torch.stack([a, b]), h1, full),
                          pre.map_preint(lambda a, b: torch.stack([a, b]), h2, full))
    _assert_preint_close(pre.map_preint(lambda x: x[0], stacked), want)
    _assert_preint_close(pre.map_preint(lambda x: x[1], stacked),
                         pre.map_preint(lambda x: x.numpy(), pre.compose(full, full)))


def test_padding_and_step_bound_ignored():
    """tests/test_imu.py's padding case: 100 samples and 50 rows of
    padding integrate exactly as the 100 alone, with or without the
    `n_steps` bound; the reference agrees with both."""
    acc, gyro, dts, _ = simulate(n=100)
    pad = lambda a: np.concatenate([a, np.zeros((50,) + a.shape[1:], a.dtype)])
    z = [0.0, 0.0, 0.0]
    p1, want = _both(acc, gyro, dts, z, z)
    p2 = pre.integrate(CALIB, T(pad(acc)), T(pad(gyro)), T(pad(dts)), T(z), T(z))
    p3 = pre.integrate(CALIB, T(pad(acc)), T(pad(gyro)), T(pad(dts)), T(z), T(z), n_steps=100)
    for a, b, c in zip(p1, p2, p3):
        assert torch.equal(a, b) and torch.equal(a, c)
    _assert_preint_close(p2, want)


def test_bias_correction_prediction_and_residual_match_reference():
    """delta_with_bias at the true biases, predict_state from the origin
    and the residual against the true end state, on tests/test_imu.py's
    biased motion integrated at zero bias."""
    bg = np.array([0.02, -0.01, 0.015])
    ba = np.array([0.1, -0.05, 0.08])
    acc, gyro, dts, (R_f, v_f, p_f) = simulate(bias_g=bg, bias_a=ba)
    p0, w0 = _both(acc, gyro, dts, [0.0] * 3, [0.0] * 3)
    I3, z3, g = np.eye(3, dtype=np.float32), np.zeros(3, np.float32), np.array([0, 0, -9.81])
    with x64_off():
        wp = ref_pre.Preintegrated(*map(jnp.asarray, w0))
        J = lambda a: jnp.asarray(np.asarray(a, np.float32))
        want = [np.asarray(x) for x in ref_pre.delta_with_bias(wp, J(bg), J(ba))]
        want += [np.asarray(x) for x in ref_pre.predict_state(wp, J(I3), J(z3), J(z3), J(bg),
                                                              J(ba))]
        want.append(np.asarray(ref_pre.inertial_residual(
            wp, J(I3), J(z3), J(z3), J(R_f), J(v_f), J(p_f), J(bg), J(ba), J(g))))
    got = list(pre.delta_with_bias(p0, T(bg), T(ba)))
    got += list(pre.predict_state(p0, T(I3), T(z3), T(z3), T(bg), T(ba)))
    got.append(pre.inertial_residual(p0, T(I3), T(z3), T(z3), T(R_f), T(v_f), T(p_f), T(bg),
                                     T(ba), T(g)))
    for a, b in zip(got[:-1], want[:-1]):
        _close(a.numpy(), b, 1e-5)
    # the residual is a difference of nearly equal states: absolute 1e-5
    np.testing.assert_allclose(got[-1].numpy(), want[-1], atol=1e-5)


@pytest.mark.parametrize("closed", [False, True], ids=["open", "closed_loop"])
def test_inertial_world_imu_matches_reference(closed):
    """The port's IMU stream, velocities, gravity, biases and timestamps
    of the inertial world are bit-equal to the reference's."""
    kw = dict(n_frames=12, fps=10.0, n_landmarks=300, seed=3, closed_loop=closed,
              closed_loop_period_frames=10 if closed else 0)
    got = synthetic.make_inertial_world(**kw)
    want = ref_synthetic.make_inertial_world(**kw)
    assert len(got.imu_per_frame) == len(want.imu_per_frame) == 12
    for a, b in zip(got.imu_per_frame, want.imu_per_frame):
        np.testing.assert_array_equal(a, b)
    for name in ("vel_w", "gravity_w", "bias_gyro", "bias_acc", "timestamps"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.world.poses_wc, want.world.poses_wc)


def test_preintegrated_from_numpy_round_trip():
    """preintegrated_from_numpy takes the reference's object as it is, and
    _to_numpy gives it back."""
    acc, gyro, dts, bg, ba = _vio_batch()
    _, want = _both(acc, gyro, dts, bg, ba)
    got = pre.preintegrated_from_numpy(want, device="cpu")
    back = pre._to_numpy(got)
    for k in pre.Preintegrated._fields:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(want, k), np.float32))
