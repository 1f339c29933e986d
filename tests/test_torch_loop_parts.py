"""The loop-closing and relocalization parts of the port against the JAX
package, on the same seeded numpy inputs: `lie/sim3.py`, Horn and the
Sim3 RANSAC, the Sim3 and pose-graph optimizers, the scatter assembly of
bundle adjustment, the covisibility graph, the vocabulary, the keyframe database and the PnP RANSAC.

The RANSAC solvers take their samples from a draw function; here they get
the reference's own draws (`ReferenceDraws`: `jax.random.choice` on the
reference's key schedule and probabilities), so that their inlier masks
must be exactly equal.

The reference runs with x64 off (a fresh `jax.enable_x64(False)` context
per use) on float32/int32 inputs. Tolerances: Sim3 maps within 1e-5
(1e-4 through log, a 3x3 inverse); RANSAC and optimizer poses within
1e-4 (float32 SVDs and solves in another order); pose graphs within 1e-4
(rotation) and 1e-3 (translation) after 15 iterations; BA as
tests/test_torch_local_ba.py states; BoW vectors and scores within 1e-6
(float32 sums of up to 216 terms in another order). Discrete outputs
(inlier masks, words, centroids, candidate lists, graph orders and edges)
are exactly equal.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_local_ba import _assert_results_close, _synth_ba_problem

from vi_slam_tpu.cameras import pinhole as ref_pinhole
from vi_slam_tpu.cameras.base import CameraParams as RefCam
from vi_slam_tpu.io import synthetic as ref_synthetic
from vi_slam_tpu.lie import sim3 as ref_sim3
from vi_slam_tpu.lie.se3 import SE3 as RefSE3
from vi_slam_tpu.loop import sim3_solver as ref_solver
from vi_slam_tpu.native import CovisGraph as RefCovisGraph
from vi_slam_tpu.native import available as native_available
from vi_slam_tpu.optim import local_ba as ref_ba
from vi_slam_tpu.optim import pnp as ref_pnp
from vi_slam_tpu.optim import pose_graph as ref_pg
from vi_slam_tpu.optim import sim3_opt as ref_sim3_opt
from vi_slam_tpu.retrieval import database as ref_db
from vi_slam_tpu.retrieval import vocabulary as ref_voc
from vi_slam_tpu.slam_map import state as ref_state
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.io import synthetic
from vi_slam_tpu_torch.lie import sim3
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.lie.sim3 import Sim3
from vi_slam_tpu_torch.loop import sim3_solver
from vi_slam_tpu_torch.optim import local_ba, pnp, pose_graph, sim3_opt
from vi_slam_tpu_torch.retrieval import database, vocabulary
from vi_slam_tpu_torch.slam_map.covis import CovisGraph
from vi_slam_tpu_torch.slam_map.state import map_state_from_numpy


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
    """A fresh context per use (a shared one, entered nested, would leave
    x64 off for every later test in the process)."""
    return jax.enable_x64(False)


@pytest.fixture(autouse=True)
def _x64_restored():
    yield
    assert jax.config.jax_enable_x64 is True, "a test left JAX's x64 mode off"


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def N(t):
    return t.detach().cpu().numpy()


@partial(jax.jit, static_argnames=("n_hyp", "size"))
def _reference_choice(key, valid, n_hyp, size):
    w = valid.astype(jnp.float32)
    probs = w / jnp.maximum(jnp.sum(w), 1.0)
    return jax.random.choice(key, valid.shape[0], shape=(n_hyp, size), replace=True, p=probs)


class ReferenceDraws:
    """The reference's RANSAC samples: PRNGKey(seed) split before every
    solve, then `jax.random.choice` with p = valid / n_valid, as its
    `sim3_ransac`, `pnp_ransac`, `LoopCloser` and `Relocalizer` draw."""

    def __init__(self, seed: int):
        with x64_off():
            self.key = jax.random.PRNGKey(seed)

    def split(self):
        with x64_off():
            self.key, sub = jax.random.split(self.key)
        return sub

    def __call__(self, valid, n_hyp, size):
        sub = self.split()
        with x64_off():
            idx = _reference_choice(sub, J(N(valid)), n_hyp, size)
        return torch.from_numpy(np.asarray(idx).astype(np.int64)).to(valid.device)


def _rodrigues(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * K @ K


def _rand_sim3_np(rng, scale=True):
    R = _rodrigues(rng.normal(size=3) * 0.5)
    t = rng.normal(size=3)
    s = float(np.exp(rng.normal() * 0.2)) if scale else 1.0
    return R.astype(np.float32), t.astype(np.float32), np.float32(s)


# ------------------------------------------------------------------ Sim3


def test_sim3_maps_match_reference():
    """exp, log (and the round trip), compose, inverse and apply on 64
    random tangents, some with tiny rotation or scale (the Taylor
    branches)."""
    rng = np.random.default_rng(0)
    xi = (rng.normal(size=(64, 7)) * 0.4).astype(np.float32)
    xi[:8, 3:6] *= 1e-5
    xi[8:16, 6] = 0.0
    x = rng.normal(size=(64, 3)).astype(np.float32)
    with x64_off():
        A = ref_sim3.exp(J(xi))
        B = ref_sim3.exp(J(xi[::-1].copy()))
        want = dict(exp=A, log=ref_sim3.log(A), comp=A.compose(B), inv=A.inverse(),
                    apply=A.apply(J(x)))
        want = {k: [np.asarray(a) for a in (v if isinstance(v, tuple) else (v,))]
                for k, v in want.items()}
    pA = sim3.exp(T(xi))
    pB = sim3.exp(T(xi[::-1].copy()))
    got = dict(exp=pA, log=sim3.log(pA), comp=pA.compose(pB), inv=pA.inverse(), apply=pA.apply(T(x)))
    for k, v in got.items():
        for g, w in zip(v if isinstance(v, tuple) else (v,), want[k]):
            np.testing.assert_allclose(N(g), w, rtol=1e-4 if k == "log" else 1e-5,
                                       atol=1e-4 if k == "log" else 1e-5, err_msg=k)
    np.testing.assert_allclose(N(sim3.log(pA)), xi, atol=1e-4)


# -------------------------------------------------- Horn and Sim3 RANSAC


def _two_view(seed, n=200, outlier_frac=0.3):
    """tests/test_loop.py::_make_two_view in numpy: two cameras seeing one
    cloud, S12 random, a fraction of x2 corrupted."""
    rng = np.random.default_rng(seed)
    R, t, s = _rand_sim3_np(rng)
    x2 = (rng.normal(size=(n, 3)) * np.array([2.0, 2.0, 1.0]) + np.array([0, 0, 8.0])).astype(np.float32)
    x1 = (s * x2 @ R.T + t).astype(np.float32)

    def proj(x):
        return np.stack([400 * x[:, 0] / x[:, 2] + 320, 400 * x[:, 1] / x[:, 2] + 240], -1).astype(np.float32)

    uv1, uv2 = proj(x1), proj(x2)
    idx = rng.choice(n, int(n * outlier_frac), replace=False)
    x2c = x2.copy()
    x2c[idx] += (rng.normal(size=(len(idx), 3)) * 3.0).astype(np.float32)
    return (R, t, s), x1, x2c, uv1, uv2, idx


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_matches_reference(fix_scale):
    rng = np.random.default_rng(1)
    (R, t, s), x1, x2, *_ = _two_view(1, n=50, outlier_frac=0.0)
    w = rng.uniform(0, 1, (4, 50)).astype(np.float32)
    w[0] = 1.0
    with x64_off():
        want = [jax.vmap(lambda ww: ref_solver.horn_sim3(J(x1), J(x2), ww, fix_scale))(J(w))]
    got = sim3_solver.horn_sim3(T(x1), T(x2), T(w), fix_scale)
    for g, wv in zip(got, want[0]):
        np.testing.assert_allclose(N(g), np.asarray(wv), rtol=1e-5, atol=1e-5)
    if not fix_scale:
        np.testing.assert_allclose(N(got.R[0]), R, atol=1e-5)
        assert abs(float(got.s[0]) - s) < 1e-5


def test_sim3_ransac_with_reference_draws():
    """The reference's draws give the same inlier mask, exactly, and S12
    within 1e-4; the outliers are flagged."""
    (R, t, s), x1, x2, uv1, uv2, out_idx = _two_view(2)
    n = x1.shape[0]
    ones = np.ones((n,), np.float32)
    valid = np.ones((n,), bool)
    with x64_off():
        cam = RefCam.make(400.0, 400.0, 320.0, 240.0, bf=0.0)
        res = ref_solver.sim3_ransac(cam, cam, J(x1), J(x2), J(uv1), J(uv2), J(valid), J(ones),
                                     J(ones), jax.random.PRNGKey(0), n_hyp=256)
        want = [np.asarray(a) for a in (*res.S12, res.inliers)]
        idx = np.asarray(_reference_choice(jax.random.PRNGKey(0), J(valid), 256, 3))
    pcam = CameraParams.make(400.0, 400.0, 320.0, 240.0, bf=0.0)
    got = sim3_solver.sim3_ransac(pcam, pcam, T(x1), T(x2), T(uv1), T(uv2), T(valid), T(ones),
                                  T(ones), lambda v, h, k: torch.from_numpy(idx.astype(np.int64)),
                                  n_hyp=256)
    np.testing.assert_array_equal(N(got.inliers), want[3])
    for g, w in zip(got.S12, want[:3]):
        np.testing.assert_allclose(N(g), w, rtol=1e-4, atol=1e-4)
    assert int(got.n_inliers) > 0.6 * n and N(got.inliers)[out_idx].mean() < 0.2
    np.testing.assert_allclose(N(got.S12.R), R, atol=1e-3)


def test_optimize_sim3_matches_reference():
    """tests/test_loop.py::test_optimize_sim3_refines' inputs, both
    fix_scale settings: S12 within 1e-4; the inlier mask exact on every
    pair at least 0.1 m off both image planes (|depth| > 0.1). Nearer
    the plane the chi2 gate reads a projection of ~5e5 px (one corrupted
    pair here sits at depth -0.004 m, behind the camera, where it carries
    no weight in the optimization), and a pose that agrees to 1e-6 still
    moves its chi2 across the gate (16.7 against 5.5)."""
    (R, t, s), x1, x2, uv1, uv2, _ = _two_view(3, outlier_frac=0.1)
    n = x1.shape[0]
    rng = np.random.default_rng(3)
    dxi = (rng.normal(size=7) * 0.02).astype(np.float32)
    ones = np.ones((n,), np.float32)
    valid = np.ones((n,), bool)
    pcam = CameraParams.make(400.0, 400.0, 320.0, 240.0, bf=0.0)
    for fix_scale in (False, True):
        with x64_off():
            cam = RefCam.make(400.0, 400.0, 320.0, 240.0, bf=0.0)
            S0 = ref_sim3.exp(J(dxi)).compose(ref_sim3.Sim3(J(R), J(t), J(s)))
            res = ref_sim3_opt.optimize_sim3(cam, cam, S0, J(x1), J(x2), J(uv1), J(uv2), J(valid),
                                             J(ones), J(ones), fix_scale=fix_scale)
            want = [np.asarray(a) for a in (*res.S12, res.inliers)]
            S0n = [np.asarray(a) for a in S0]
            front = ((np.abs(np.asarray(res.S12.apply(J(x2)))[:, 2]) > 0.1)
                     & (np.abs(np.asarray(res.S12.inverse().apply(J(x1)))[:, 2]) > 0.1))
        got = sim3_opt.optimize_sim3(pcam, pcam, Sim3(*map(T, S0n)), T(x1), T(x2), T(uv1), T(uv2),
                                     T(valid), T(ones), T(ones), fix_scale=fix_scale)
        assert front.sum() >= 185
        np.testing.assert_array_equal(N(got.inliers)[front], want[3][front])
        for g, w in zip(got.S12, want[:3]):
            np.testing.assert_allclose(N(g), w, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ pose graph


def _circle(K, radius=10.0):
    Rs, ts = [], []
    for k in range(K):
        th = 2 * np.pi * k / K
        Rwc = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        Rs.append(Rwc.T)
        ts.append(-Rwc.T @ np.array([radius * np.cos(th), radius * np.sin(th), 0.0]))
    return np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32)


@pytest.mark.parametrize("mode", ["sim3", "se3"])
def test_pose_graph_matches_reference(mode):
    """tests/test_loop.py's ring: 24 keyframes on a circle, exact odometry
    and loop edges, poses but keyframe 0's perturbed by 0.02 per tangent
    coordinate, keyframe 0 fixed, 15 iterations. The port closes the ring as the
    reference does (poses within 1e-4/1e-3, centres within 0.15 m of the
    truth), and se3 keeps every scale at 1."""
    K = 24
    R, t = _circle(K)
    xi = (np.random.default_rng(4).normal(size=(K, 7)) * 0.02).astype(np.float32)
    xi[0] = 0.0  # the fixed vertex stays at the truth
    edges = np.array([(i, i + 1) for i in range(K - 1)] + [(K - 1, 0)], np.int32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    E = len(edges)
    with x64_off():
        gt = ref_sim3.Sim3(J(R), J(t), jnp.ones(K, jnp.float32))
        init = ref_sim3.exp(J(xi)).compose(gt)
        Si = ref_sim3.Sim3(*(a[edges[:, 0]] for a in gt))
        Sj = ref_sim3.Sim3(*(a[edges[:, 1]] for a in gt))
        meas = Sj.compose(Si.inverse())
        res = ref_pg.optimize_pose_graph(init, J(edges), meas, jnp.ones(E, bool),
                                         jnp.ones(E, jnp.float32), J(fixed), iters=15, mode=mode)
        want = [np.asarray(a) for a in res.poses]
        init_n = [np.asarray(a) for a in init]
        meas_n = [np.asarray(a) for a in meas]
    got = pose_graph.optimize_pose_graph(
        Sim3(*map(T, init_n)), T(edges), Sim3(*map(T, meas_n)), torch.ones(E, dtype=torch.bool),
        torch.ones(E), T(fixed), iters=15, mode=mode)
    np.testing.assert_allclose(N(got.poses.R), want[0], atol=1e-4)
    np.testing.assert_allclose(N(got.poses.t), want[1], atol=1e-3)
    np.testing.assert_allclose(N(got.poses.s), want[2], atol=1e-4)
    if mode == "sim3":
        centres = np.einsum("kji,kj->ki", N(got.poses.R), -N(got.poses.t)) / N(got.poses.s)[:, None]
        assert np.linalg.norm(centres - np.einsum("kji,kj->ki", R, -t), axis=-1).max() < 0.15
    else:
        np.testing.assert_array_equal(N(got.poses.s), N(Sim3(*map(T, init_n)).s))


def test_pose_graph_4dof_raises():
    """The 4-DoF graph, which raised before the inertial slice, against the
    reference on tests/test_inertial_loop.py's unit problem
    (test_4dof_projection_preserves_axis_rotation): six identity rotations
    on a chain closed by one edge, keyframe 0 fixed, the yaw axis not a
    coordinate axis, 10 iterations. Poses within 1e-5 of the reference's,
    and every rotation a pure turn about the axis (1e-5); without an axis
    the rotations turn about the world z axis only."""
    rng = np.random.default_rng(0)
    K = 6
    axis = np.asarray([0.3, -0.9, 0.3])
    axis /= np.linalg.norm(axis)
    R = np.tile(np.eye(3), (K, 1, 1)).astype(np.float32)
    t = rng.normal(0, 1.0, (K, 3)).astype(np.float32)
    edges = np.asarray([[i, i + 1] for i in range(K - 1)] + [[K - 1, 0]], np.int32)
    fixed = np.zeros((K,), bool)
    fixed[0] = True
    Si = Sim3(T(R[edges[:, 0]]), T(t[edges[:, 0]]), torch.ones(K))
    Sj = Sim3(T(R[edges[:, 1]]), T(t[edges[:, 1]]), torch.ones(K))
    meas = Sj.compose(Si.inverse())
    for yaw in (axis, None):
        with x64_off():
            res = ref_pg.optimize_pose_graph(
                ref_sim3.Sim3(J(R), J(t), jnp.ones(K, jnp.float32)), J(edges),
                ref_sim3.Sim3(*(J(N(a)) for a in meas)), jnp.ones(K, bool),
                jnp.ones(K, jnp.float32), J(fixed), iters=10, mode="4dof",
                yaw_axis=None if yaw is None else J(yaw.astype(np.float32)))
            want = [np.asarray(a) for a in res.poses]
        got = pose_graph.optimize_pose_graph(
            Sim3(T(R), T(t), torch.ones(K)), T(edges), meas, torch.ones(K, dtype=torch.bool),
            torch.ones(K), T(fixed), iters=10, mode="4dof",
            yaw_axis=None if yaw is None else T(yaw.astype(np.float32)))
        for a, b in zip(got.poses, want):
            np.testing.assert_allclose(N(a), b, atol=1e-5)
        ax = np.array([0.0, 0.0, 1.0]) if yaw is None else axis
        for k in range(K):
            w = N(sim3.log(Sim3(got.poses.R[k], torch.zeros(3), torch.ones(()))))[3:6]
            assert np.linalg.norm(w - ax * (ax @ w)) < 1e-5, (k, w)


# ------------------------------------------------- scatter-assembled BA


@pytest.mark.parametrize("seed,iters", [(4, 10), (6, 3)])
def test_scatter_bundle_adjust_matches_dense_and_reference(seed, iters):
    """tests/test_optim.py's problem: the port's scatter assembly against
    the reference's scatter assembly, and against the port's own dense
    assembly, with the tolerances of tests/test_torch_local_ba.py."""
    arrays, poses0, _, _ = _synth_ba_problem(seed)
    with x64_off():
        cam = RefCam.make(500.0, 500.0, 320.0, 240.0, bf=50.0)
        prob = ref_ba.BAProblem(poses=RefSE3(*map(J, poses0)), **{k: J(v) for k, v in arrays.items()})
        res = ref_ba.bundle_adjust(cam, prob, iters=iters, assembly="scatter")
        want = [np.asarray(a) for a in (res.poses.R, res.poses.t, res.points, res.obs_inlier,
                                         res.cost)]
    pcam = CameraParams.make(500.0, 500.0, 320.0, 240.0, bf=50.0)
    pprob = local_ba.BAProblem(poses=SE3(*map(T, poses0)), **{k: T(v) for k, v in arrays.items()})
    runs = [local_ba.bundle_adjust(pcam, pprob, iters=iters, assembly=a) for a in ("scatter", "dense")]
    got = [[N(a) for a in (r.poses.R, r.poses.t, r.points, r.obs_inlier, r.cost)] for r in runs]
    _assert_results_close(got[0], want)
    _assert_results_close(got[0], got[1])


def test_scatter_bundle_adjust_keeps_cameras_on_a_singular_landmark():
    """The zero-pivot rule (ROADMAP F5) on the scatter path (the case of
    tests/test_torch_local_ba.py::test_singular_landmark_keeps_the_cameras):
    40 points seen once without a right-image match have rank-2 blocks,
    some of which the reference's float32 LU inverts to non-finite; its
    camera step is then zeroed and only the points move. The port's
    scatter path does the same."""
    arrays, poses0, _, _ = _synth_ba_problem(14)
    rng = np.random.default_rng(14)
    z = rng.uniform(2, 10, (40, 1))
    near = np.concatenate([rng.uniform(-0.4, 0.4, (40, 2)) * z, z], -1).astype(np.float32)
    arrays["points"][:40] = near
    arrays["obs_mask"][:40] = False
    arrays["obs_mask"][:40, 0] = True
    arrays["obs_cam"][:40, 0] = 0
    arrays["obs_stereo"][:40] = False
    with x64_off():
        cam = RefCam.make(500.0, 500.0, 320.0, 240.0, bf=50.0)
        pc = np.asarray(RefSE3(J(poses0[0][0]), J(poses0[1][0])).apply(J(near)))
        arrays["obs_uvr"][:40, 0] = np.asarray(ref_pinhole.stereo_project(cam, J(pc)))
        prob = ref_ba.BAProblem(poses=RefSE3(*map(J, poses0)), **{k: J(v) for k, v in arrays.items()})
        res = ref_ba.bundle_adjust(cam, prob, iters=2, assembly="scatter")
        want = [np.asarray(a) for a in (res.poses.R, res.poses.t, res.points, res.obs_inlier,
                                         res.cost)]
    pcam = CameraParams.make(500.0, 500.0, 320.0, 240.0, bf=50.0)
    pprob = local_ba.BAProblem(poses=SE3(*map(T, poses0)), **{k: T(v) for k, v in arrays.items()})
    r = local_ba.bundle_adjust(pcam, pprob, iters=2, assembly="scatter")
    got = [N(a) for a in (r.poses.R, r.poses.t, r.points, r.obs_inlier, r.cost)]
    _assert_results_close(got, want)
    for res in (got, want):
        np.testing.assert_allclose(res[0], poses0[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(res[1], poses0[1], rtol=0, atol=1e-6)
    assert np.abs(got[2][40:] - arrays["points"][40:]).max() > 1e-3


# ------------------------------------------------------ covisibility graph


@pytest.mark.skipif(not native_available(), reason="the reference's native library is not built")
@pytest.mark.parametrize("seed", range(6))
def test_covis_graph_matches_native(seed):
    """Random keyframe sequences with many equal weights and a few culls:
    parents (the native graph's first-iterated strongest neighbour),
    best-neighbour orders and essential edges (also truncated at 20 before
    deduplication) exactly equal to the reference's native graph."""
    rng = np.random.default_rng(seed)
    K = int(rng.integers(20, 120))
    n_mp = int(rng.integers(50, 400))
    n_obs = int(rng.integers(5, 60))
    ref, port = RefCovisGraph(K), CovisGraph(K)
    for k in range(K):
        lo = max(0, int(k * n_mp / K) - 30)
        ids = rng.integers(lo, min(n_mp, lo + 60), n_obs)
        ids[rng.random(n_obs) < 0.2] = -1
        ref.add_keyframe(k, ids)
        port.add_keyframe(k, ids)
        if k > 2 and rng.random() < 0.1:
            d = int(rng.integers(1, k))
            ref.remove_keyframe(d)
            port.remove_keyframe(d)
    np.testing.assert_array_equal(port.parents(), ref.parents())
    for mw in (1, 3, 5):
        for me in (4096, 20):
            np.testing.assert_array_equal(port.essential_edges(mw, me), ref.essential_edges(mw, me))
    for k in range(K):
        for a, b in zip(port.best_neighbors(k, K), ref.best_neighbors(k, K)):
            np.testing.assert_array_equal(a, b)
        assert port.weight(k, (k + 1) % K) == ref.weight(k, (k + 1) % K)


# ------------------------------------------------------------ vocabulary


@pytest.fixture(scope="module")
def vocabularies():
    """tests/test_reloc.py's vocabulary: k=6, 3 levels, 3 iterations on
    3000 landmark descriptors, trained by both sides from the same seed."""
    world = ref_synthetic.make_landmark_world(n_frames=20, n_landmarks=4000, seed=0, speed=0.8)
    desc = world.desc[:3000]
    with x64_off():
        ref = ref_voc.train_vocabulary(desc, k=6, levels=3, iters=3)
    port = vocabulary.train_vocabulary(desc, k=6, levels=3, iters=3, device="cpu")
    return world, ref, port


def test_train_vocabulary_centroids_exact(vocabularies):
    _, ref, port = vocabularies
    np.testing.assert_array_equal(N(port.node_bits), np.asarray(ref.node_bits))
    np.testing.assert_array_equal(N(port.idf), np.asarray(ref.idf))
    assert (port.k, port.levels) == (ref.k, ref.levels)


def test_vocabulary_transform_bow_and_scores(vocabularies):
    """Words and mid-level nodes exact on noisy descriptors (and on the
    reference's own vocabulary, loaded into the port); BoW vectors with
    TF-IDF weights, and L1 scores, within 1e-6."""
    world, ref, port = vocabularies
    rng = np.random.default_rng(3)
    desc = ref_synthetic.flip_descriptor_bits(world.desc[:500], 20, rng)
    valid = rng.random(500) < 0.9
    idf = rng.uniform(0.1, 2.0, ref.n_words).astype(np.float32)
    with x64_off():
        w_ref, n_ref = ref_voc.transform(ref, J(desc))
        refs_words = jnp.stack([w_ref, jnp.roll(w_ref, 7), jnp.roll(w_ref, 99)])
        vmask = jnp.stack([J(valid), J(valid), ~J(valid)])
        bow_ref = ref_voc.bow_vectors(refs_words, vmask, J(idf), ref.n_words)
        score_ref = ref_voc.score_l1(bow_ref[0], bow_ref)
    pdesc = T(desc.view(np.int32))
    w, n = vocabulary.transform(port, pdesc)
    np.testing.assert_array_equal(N(w), np.asarray(w_ref))
    np.testing.assert_array_equal(N(n), np.asarray(n_ref))
    bow = vocabulary.bow_vectors(T(np.asarray(refs_words)), T(np.asarray(vmask)), T(idf), port.n_words)
    np.testing.assert_allclose(N(bow), np.asarray(bow_ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(N(vocabulary.score_l1(bow[0], bow)), np.asarray(score_ref), atol=1e-6)


def test_vocabulary_entry_points_default_to_the_card(vocabularies, tmp_path, monkeypatch):
    """Without a device, training keeps a tensor on its own device and
    sends numpy descriptors to the card; loading goes to the card. Where
    there is no card, both raise instead of running on the host."""
    world, ref, _ = vocabularies
    desc = world.desc[:300]
    on_cpu = vocabulary.train_vocabulary(T(desc.view(np.int32)), k=4, levels=2, iters=1)
    assert on_cpu.node_bits.device.type == "cpu" and on_cpu.idf.device.type == "cpu"
    path = str(tmp_path / "ref_voc.npz")
    ref_voc.save_vocabulary(path, ref)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        vocabulary.train_vocabulary(desc, k=4, levels=2, iters=1)
    with pytest.raises(RuntimeError, match="cuda"):
        vocabulary.load_vocabulary(path)


def test_vocabulary_file_round_trip(vocabularies, tmp_path):
    """A file the reference wrote loads into the port with the same
    centroids and weights, and the port writes the same format back."""
    _, ref, _ = vocabularies
    path = str(tmp_path / "ref_voc.npz")
    ref_voc.save_vocabulary(path, ref)
    port = vocabulary.load_vocabulary(path, device="cpu")
    np.testing.assert_array_equal(N(port.node_bits), np.asarray(ref.node_bits))
    np.testing.assert_array_equal(N(port.idf), np.asarray(ref.idf))
    back = str(tmp_path / "port_voc.npz")
    vocabulary.save_vocabulary(back, port)
    with x64_off():
        again = ref_voc.load_vocabulary(back)
    np.testing.assert_array_equal(np.asarray(again.node_bits), np.asarray(ref.node_bits))
    assert (again.k, again.levels) == (ref.k, ref.levels)


# -------------------------------------------------------------- database


def test_database_candidates_match_reference(ring_map):
    """The drifted ring's map (tests/test_torch_loop_closing.py): every
    keyframe's BoW vector in both databases, then for each keyframe the
    fused loop query (exclusion and strong-covisibility masks from the
    native graph) and the relocalization query give the same candidate
    lists; keyframe 3 is removed half way. Odd queries exclude only the
    query keyframe, so that their lists are not empty."""
    d, desc = ring_map
    with x64_off():
        rvoc = ref_voc.train_vocabulary(desc, k=6, levels=3, iters=4, seed=2)
        rstate = ref_state.MapState(**{k: jnp.array(v) for k, v in d.items()})
        rdb = ref_db.KeyFrameDatabase(16, rvoc.n_words, n_cand=16)
    pvoc = vocabulary.train_vocabulary(desc, k=6, levels=3, iters=4, seed=2, device="cpu")
    pstate = map_state_from_numpy(d, device="cpu")
    pdb = database.KeyFrameDatabase(16, pvoc.n_words, n_cand=16, device="cpu")
    graph = RefCovisGraph(16)
    from vi_slam_tpu.pipeline.loop_closing import _kf_bow as ref_kf_bow
    from vi_slam_tpu_torch.pipeline.loop_closing import _kf_bow
    for k in range(12):
        with x64_off():
            rdb.add(k, ref_kf_bow(rstate, jnp.int32(k), rvoc.node_bits, rvoc.idf, rvoc.k,
                                  rvoc.levels, rvoc.n_words))
        pdb.add(k, _kf_bow(pstate, k, pvoc))
        graph.add_keyframe(k, d["kf_mp"][k])
    np.testing.assert_allclose(N(pdb.db.bow), np.asarray(rdb.db.bow), atol=1e-6)
    n_nonempty = 0
    for k in range(12):
        if k == 6:
            with x64_off():
                rdb.remove(3)
            pdb.remove(3)
        ids, w = graph.best_neighbors(k, 16)
        exclude = np.zeros(16, bool)
        exclude[k] = True
        if k % 2 == 0:
            exclude[ids] = True
            exclude[max(0, k - 4):k + 1] = True
        strong = np.zeros(16, bool)
        strong[ids[w >= 15]] = True
        with x64_off():
            want = rdb.detect_loop_candidates_fused(rstate, rdb.db.bow[k], J(exclude), J(strong))
            want_rel = rdb.detect_reloc_candidates(rstate, rdb.db.bow[k])
        got = pdb.detect_loop_candidates_fused(pstate, pdb.db.bow[k], T(exclude), T(strong))
        got_rel = pdb.detect_reloc_candidates(pstate, pdb.db.bow[k])
        np.testing.assert_array_equal(got, want, err_msg=f"loop query of {k}")
        np.testing.assert_array_equal(got_rel, want_rel, err_msg=f"reloc query of {k}")
        n_nonempty += len(want) > 0
    assert n_nonempty >= 6


# ------------------------------------------------------------------ PnP


def test_pnp_ransac_with_reference_draws():
    """tests/test_reloc.py::test_pnp_ransac_recovers_pose' inputs (200
    points, 30 % outliers): the reference's draws give the same inlier
    mask, exactly, and the pose within 1e-4."""
    rng = np.random.default_rng(0)
    n = 200
    xw = np.stack([rng.uniform(-5, 5, n), rng.uniform(-4, 4, n), rng.uniform(4, 20, n)], 1)
    R = _rodrigues(np.array([0.1, -0.2, 0.05]))
    t = np.array([0.4, -0.3, 1.2])
    pc = xw @ R.T + t
    uv = np.stack([500 * pc[:, 0] / pc[:, 2] + 320, 500 * pc[:, 1] / pc[:, 2] + 240], -1)
    uv += rng.normal(size=uv.shape) * 0.3
    idx = rng.choice(n, 60, replace=False)
    uv[idx] += rng.uniform(20, 100, size=(60, 2))
    xw, uv = xw.astype(np.float32), uv.astype(np.float32)
    valid, ones = np.ones(n, bool), np.ones(n, np.float32)
    with x64_off():
        cam = RefCam.make(500.0, 500.0, 320.0, 240.0)
        res = ref_pnp.pnp_ransac(cam, J(xw), J(uv), J(valid), J(ones), jax.random.PRNGKey(1))
        want = [np.asarray(a) for a in (res.T_cw.R, res.T_cw.t, res.inliers, res.ok)]
        samples = np.asarray(_reference_choice(jax.random.PRNGKey(1), J(valid), 256, 6))
    pcam = CameraParams.make(500.0, 500.0, 320.0, 240.0)
    got = pnp.pnp_ransac(pcam, T(xw), T(uv), T(valid), T(ones),
                         lambda v, h, k: torch.from_numpy(samples.astype(np.int64)))
    np.testing.assert_array_equal(N(got.inliers), want[2])
    np.testing.assert_allclose(N(got.T_cw.R), want[0], atol=1e-4)
    np.testing.assert_allclose(N(got.T_cw.t), want[1], atol=1e-4)
    assert bool(got.ok) == bool(want[3]) and int(got.n_inliers) > 0.55 * n
    np.testing.assert_allclose(N(got.T_cw.t), t, atol=0.05)


# ------------------------------------------- the drifted ring, in numpy

K_KF = 12


def build_ring(bf=0.0):
    """tests/test_loop_closing.py's drifted ring, built in numpy by the
    port's `make_drifted_ring` and given to both sides."""
    return synthetic.make_drifted_ring(bf=bf)


def test_drifted_ring_matches_reference_map():
    """The port's numpy ring is the reference test's map: integer and
    boolean arrays, seam duplicates and descriptors equal, floats within
    1e-5 (the reference builds it in float64 with x64 on)."""
    import tests.test_loop_closing as tlc

    fixture = tlc.loop_world
    world = getattr(fixture, "__wrapped__", fixture)()
    state, desc, seam = tlc._build_drifted_map(world)
    d, pdesc, pseam, _ = build_ring()
    np.testing.assert_array_equal(pdesc, desc)
    assert pseam == seam
    for name, want in zip(state._fields, state):
        want = np.asarray(want)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(d[name], want, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(d[name], want, err_msg=name)


@pytest.fixture(scope="module")
def ring_map():
    d, desc, _, _ = build_ring()
    return d, desc
