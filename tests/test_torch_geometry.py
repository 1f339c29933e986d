"""Two-view geometry of the port against the JAX package, on the same numpy
inputs: the cases of tests/test_geometry.py, run on both sides.

The reference runs with x64 off on float32 inputs (H1). Tolerances, and why:
  * the closed-form 3x3 solve: rtol 1e-5 / atol 1e-5;
  * DLT triangulation: rtol 1e-3 against the reference. XLA's CPU dot sums
    the 4 rows of A^T A with fused multiply-adds, torch without; the
    float32 normal equations of rays 8-30 m deep amplify that last-bit
    difference to ~2e-4 relative. The exact case is also held within 1e-2
    m of the truth;
  * parallax cosines, depths, E and F: rtol 1e-5 (float32, 3-term sums in
    another order);
  * epiline and Sampson distances: rtol 1e-3 / atol 1e-5 px^2 (squares of
    small differences of O(1e3) products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_slam_tpu.cameras import CameraParams as RefCam
from vi_slam_tpu.cameras import pinhole as ref_pinhole
from vi_slam_tpu.geometry import epipolar as ref_epipolar
from vi_slam_tpu.geometry import triangulate as ref_triangulate
from vi_slam_tpu.lie import se3 as ref_se3
from vi_slam_tpu.lie.se3 import SE3 as RefSE3
from vi_slam_tpu_torch.cameras import pinhole
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.geometry import epipolar, triangulate
from vi_slam_tpu_torch.lie import se3
from vi_slam_tpu_torch.lie.se3 import SE3


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


def x64_off():
    """A fresh context per use: one shared `jax.enable_x64(False)` object
    entered twice (nested) saves False over the True it must restore, and
    leaves x64 off for every later test in the process."""
    return jax.enable_x64(False)


@pytest.fixture(autouse=True)
def _x64_restored():
    yield
    assert jax.config.jax_enable_x64 is True, "a test left JAX's x64 mode off"
K = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
XI2 = np.array([0.5, 0.05, 0.02, 0.01, 0.08, 0.005], np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def J(a):
    return jnp.asarray(np.asarray(a))


def _two_view(seed, n=200):
    """tests/test_geometry.py's two-view scene, drawn with numpy: points 8-30
    m ahead, the second camera 0.5 m to the side and slightly rotated."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-5, 5, (n, 2)), rng.uniform(8, 30, (n, 1))],
                          -1).astype(np.float32)


def _ref_poses():
    with x64_off():
        T2 = ref_se3.exp(J(XI2))
        return RefSE3.identity(), T2


def _port_poses():
    return SE3.identity(), se3.exp(T(XI2))


def _project_both(pts, seed=None, noise=0.0):
    """Pixels of the points in both views (the reference's projection)."""
    T1, T2 = _ref_poses()
    with x64_off():
        cam = RefCam.make(500.0, 500.0, 320.0, 240.0, bf=50.0)
        uv1 = np.asarray(ref_pinhole.project(cam, T1.apply(J(pts))))
        uv2 = np.asarray(ref_pinhole.project(cam, T2.apply(J(pts))))
    if noise:
        rng = np.random.default_rng(seed)
        uv1 = (uv1 + noise * rng.normal(0, 1, uv1.shape)).astype(np.float32)
        uv2 = (uv2 + noise * rng.normal(0, 1, uv2.shape)).astype(np.float32)
    return uv1, uv2


def test_solve3x3_matches():
    rng = np.random.default_rng(0)
    A = rng.normal(0, 1, (64, 3, 3)).astype(np.float32)
    A[0] = 0.0  # singular: the determinant guard
    b = rng.normal(0, 1, (64, 3)).astype(np.float32)
    with x64_off():
        want = np.asarray(ref_triangulate._solve3x3(J(A), J(b)))
    got = N(triangulate._solve3x3(T(A), T(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["exact", "noisy"])
def test_triangulate_dlt_matches(case):
    """test_dlt_exact: bearings straight from the points; test_dlt_noisy:
    0.5 px noise on both pixels."""
    pts = _two_view(0 if case == "exact" else 1)
    T1r, T2r = _ref_poses()
    T1p, T2p = _port_poses()
    if case == "exact":
        with x64_off():
            b1 = np.asarray(T1r.apply(J(pts)))
            b2 = np.asarray(T2r.apply(J(pts)))
        b1 = (b1 / b1[:, 2:3]).astype(np.float32)
        b2 = (b2 / b2[:, 2:3]).astype(np.float32)
    else:
        uv1, uv2 = _project_both(pts, seed=2, noise=0.5)
        pc = CameraParams.make(500.0, 500.0, 320.0, 240.0, bf=50.0)
        b1, b2 = N(pinhole.unproject(pc, T(uv1))), N(pinhole.unproject(pc, T(uv2)))
    with x64_off():
        want = np.asarray(ref_triangulate.triangulate_dlt(T1r, T2r, J(b1), J(b2)))
    got = N(triangulate.triangulate_dlt(T1p, T2p, T(b1), T(b2)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    err = np.linalg.norm(got - pts, axis=-1)
    if case == "exact":
        assert err.max() < 1e-2, err.max()
    else:
        assert np.median(err) < 1.0  # ~ z^2 * sigma / (f * baseline)


def test_parallax_and_depth_match():
    pts = _two_view(3)
    T1r, T2r = _ref_poses()
    T1p, T2p = _port_poses()
    with x64_off():
        cos_r = np.asarray(ref_triangulate.parallax_cos(T1r, T2r, J(pts)))
        z_r = np.asarray(ref_triangulate.depths(T2r, J(pts)))
    cos_p = N(triangulate.parallax_cos(T1p, T2p, T(pts)))
    z_p = N(triangulate.depths(T2p, T(pts)))
    np.testing.assert_allclose(cos_p, cos_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(z_p, z_r, rtol=1e-5, atol=1e-5)
    assert np.all(cos_p < 1.0) and np.all(z_p > 0)


@pytest.mark.parametrize("case", ["epiline_true", "epiline_mismatch", "sampson_true"])
def test_epipolar_matches(case):
    """test_epiline_distance_zero_for_true_matches,
    test_epiline_distance_nonzero_for_mismatches, test_sampson_symmetric_zero."""
    pts = _two_view({"epiline_true": 4, "epiline_mismatch": 5, "sampson_true": 6}[case])
    uv1, uv2 = _project_both(pts)
    if case == "epiline_mismatch":
        uv2 = np.roll(uv2, 1, axis=0)
    fn = "sampson_distance_sq" if case.startswith("sampson") else "epiline_distance_sq"
    T1r, T2r = _ref_poses()
    T1p, T2p = _port_poses()
    with x64_off():
        E_r = np.asarray(ref_epipolar.essential_from_relative(T1r.compose(T2r.inverse())))
        F_r = ref_epipolar.fundamental_from_poses(T1r, T2r, J(K), J(K))
        d2_r = np.asarray(getattr(ref_epipolar, fn)(F_r, J(uv1), J(uv2)))
        F_r = np.asarray(F_r)
    E_p = N(epipolar.essential_from_relative(T1p.compose(T2p.inverse())))
    F_p = epipolar.fundamental_from_poses(T1p, T2p, T(K), T(K))
    d2_p = N(getattr(epipolar, fn)(F_p, T(uv1), T(uv2)))
    np.testing.assert_allclose(E_p, E_r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(N(F_p), F_r, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(d2_p, d2_r, rtol=1e-3, atol=1e-5)
    if case == "epiline_mismatch":
        assert np.median(d2_p) > 1.0
    else:
        assert d2_p.max() < 1e-4
