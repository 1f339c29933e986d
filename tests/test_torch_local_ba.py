"""Local bundle adjustment of the port against the JAX package, on the same
numpy inputs: `optim/local_ba.py` (dense Schur path, LM and damped GN),
`pipeline/steps.py`'s gather and scatter of the BA problem, and
`StereoVO`'s local-BA program (covisibility window, fixed set, scatter,
the correction of the live pose).

Inputs: tests/test_optim.py::TestLocalBA's synthetic problem (6 cameras,
200 stereo points, 4 observations each), drawn with numpy, run on both
sides; and the scene map of tests/test_torch_mapping.py.

The reference runs with x64 off on float32/int32 inputs (H1). Tolerances,
and why: each iteration ends in a 36x36 float32 dense solve
(`jnp.linalg.solve` against `torch.linalg.solve`, other pivots and sums)
after Schur products summed in another order, so poses agree to 1e-4
(rotation) and 1e-3 m, points to 2e-3 m relative, costs to 1e-3 relative.
Integer and boolean outputs (masks, camera indices, inlier flags, the map's
integer arrays) are exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import (
    N, T, J, _cams, assert_maps_equal, scene_config, to_port, to_ref,
)

from vi_slam_tpu.cameras import CameraParams as RefCam
from vi_slam_tpu.cameras import pinhole as ref_pinhole
from vi_slam_tpu.lie import se3 as ref_se3
from vi_slam_tpu.lie.se3 import SE3 as RefSE3
from vi_slam_tpu.optim import local_ba as ref_ba
from vi_slam_tpu.pipeline import steps as ref_steps
from vi_slam_tpu.pipeline.stereo_vo import StereoVO as RefStereoVO
from vi_slam_tpu.slam_map import state as ref_state
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.lie import se3
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.optim import local_ba
from vi_slam_tpu_torch.pipeline import steps
from vi_slam_tpu_torch.pipeline.stereo_vo import StereoVO
from vi_slam_tpu_torch.slam_map import state as map_state
from vi_slam_tpu_torch.utils.config import config_from_dict


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


def _synth_ba_problem(seed, n_cams=6, n_pts=200, obs_per_pt=4, noise=0.3):
    """tests/test_optim.py::synth_ba_problem, drawn with numpy: cameras
    0.5 m apart along x, cameras 0 and 1 fixed, free poses perturbed by
    ~0.02 and all points by 0.2 m. Returns (problem arrays, perturbed
    poses (R, t), ground-truth poses and points)."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-8, 8, (n_pts, 2)), rng.uniform(8, 40, (n_pts, 1))],
                         -1).astype(np.float32)
    xis = np.array([[-0.5 * k, 0, 0, 0, 0.002 * k, 0] for k in range(n_cams)], np.float32)
    obs_cam = rng.integers(0, n_cams, (n_pts, obs_per_pt)).astype(np.int32)
    dxi = (rng.normal(0, 1, (n_cams, 6)) * 0.02).astype(np.float32)
    dxi[:2] = 0.0
    with x64_off():
        cam = RefCam.make(500.0, 500.0, 320.0, 240.0, bf=50.0)
        gt = ref_se3.exp(J(xis))
        pc = np.einsum("mpij,mj->mpi", np.asarray(gt.R)[obs_cam], pts) + np.asarray(gt.t)[obs_cam]
        uvr = np.asarray(ref_pinhole.stereo_project(cam, J(pc.astype(np.float32))))
        p0 = ref_se3.retract_left(gt, J(dxi))
        poses0 = (np.asarray(p0.R), np.asarray(p0.t))
        gt = (np.asarray(gt.R), np.asarray(gt.t))
    uvr = (uvr + noise * rng.normal(0, 1, uvr.shape)).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True
    arrays = dict(
        fixed=fixed, points=(pts + rng.normal(0, 0.2, pts.shape)).astype(np.float32),
        point_valid=np.ones(n_pts, bool), obs_cam=obs_cam, obs_uvr=uvr,
        obs_stereo=np.ones((n_pts, obs_per_pt), bool),
        obs_sigma2=np.ones((n_pts, obs_per_pt), np.float32), obs_mask=pc[..., 2] > 1.0,
    )
    return arrays, poses0, gt, pts


def _run_both(arrays, poses0, iters, strategy="lm"):
    with x64_off():
        cam = RefCam.make(500.0, 500.0, 320.0, 240.0, bf=50.0)
        prob = ref_ba.BAProblem(poses=RefSE3(*map(J, poses0)), **{k: J(v) for k, v in arrays.items()})
        res = jax.jit(lambda p: ref_ba._ba_core(cam, p, iters, True, 1e-4, strategy=strategy))(prob)
        want = [np.asarray(res.poses.R), np.asarray(res.poses.t), np.asarray(res.points),
                np.asarray(res.obs_inlier), np.asarray(res.cost)]
    pcam = CameraParams.make(500.0, 500.0, 320.0, 240.0, bf=50.0)
    prob = local_ba.BAProblem(poses=SE3(*map(T, poses0)), **{k: T(v) for k, v in arrays.items()})
    if strategy == "lm":
        res = local_ba.bundle_adjust(pcam, prob, iters=iters)
    else:
        res = local_ba._ba_core(pcam, prob, iters, True, 1e-4, strategy=strategy)
    got = [N(res.poses.R), N(res.poses.t), N(res.points), N(res.obs_inlier), N(res.cost)]
    return got, want


def _assert_results_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4, err_msg="R")
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-3, err_msg="t")
    np.testing.assert_allclose(got[2], want[2], rtol=2e-3, atol=2e-3, err_msg="points")
    np.testing.assert_array_equal(got[3], want[3], err_msg="inliers")
    np.testing.assert_allclose(got[4], want[4], rtol=1e-3, atol=1e-3, err_msg="cost")


@pytest.mark.parametrize("case,seed,iters", [
    ("cost_decreases_and_converges", 4, 15),
    ("fixed_cameras_do_not_move", 5, 5),
    ("point_improvement", 6, 15),
    ("masked_points_unchanged", 7, 5),
])
def test_local_ba_matches(case, seed, iters):
    """tests/test_optim.py::TestLocalBA's four cases on both sides (LM, the
    reference's `bundle_adjust` default): results within the stated
    tolerances, and the reference test's own checks hold for the port."""
    arrays, poses0, gt, pts_gt = _synth_ba_problem(seed)
    if case == "masked_points_unchanged":
        arrays["point_valid"][:50] = False
    got, want = _run_both(arrays, poses0, iters)
    _assert_results_close(got, want)
    R, t, points, _, cost = got
    if case == "cost_decreases_and_converges":
        assert cost[-1] < cost[0] * 0.1, cost
        for k in range(2, 6):
            Tk = se3.log(SE3(T(gt[0][k]), T(gt[1][k])).inverse().compose(SE3(T(R[k]), T(t[k]))))
            assert float(torch.linalg.norm(Tk[3:])) < 5e-3
            rel = SE3(T(R[k]), T(t[k])).inverse().compose(SE3(T(gt[0][k]), T(gt[1][k])))
            assert float(torch.linalg.norm(rel.t)) < 5e-2
    elif case == "fixed_cameras_do_not_move":
        np.testing.assert_allclose(R[:2], poses0[0][:2], atol=1e-6)
        np.testing.assert_allclose(t[:2], poses0[1][:2], atol=1e-6)
    elif case == "point_improvement":
        err0 = np.linalg.norm(arrays["points"] - pts_gt, axis=-1)
        err1 = np.linalg.norm(points - pts_gt, axis=-1)
        assert np.median(err1) < 0.5 * np.median(err0) and np.median(err1) < 0.2
    else:
        np.testing.assert_array_equal(points[:50], arrays["points"][:50])


def test_local_ba_gauss_newton_matches():
    """The damped Gauss-Newton strategy (no accept test, lambda >= 1e-3)."""
    arrays, poses0, _, _ = _synth_ba_problem(8)
    got, want = _run_both(arrays, poses0, 3, strategy="gn")
    _assert_results_close(got, want)


def test_reduced_system_matches():
    """One Schur reduction: S, b, U and bp within 1e-3 of the largest
    entry of each (float32 products summed in another order); Hpp^-1 and
    the back-substituted points of a given camera step within 1e-2 of each
    landmark's largest entry: a landmark 40 m away seen from cameras 0.5 m
    apart has a 3x3 block of condition ~1e5, whose float32 inverse moves by
    up to 7e-3 relative with the rounding of its entries."""
    arrays, poses0, _, _ = _synth_ba_problem(9)
    lam = np.float32(1e-3)
    dxc = (np.random.default_rng(9).normal(0, 1e-3, (6, 6))).astype(np.float32)
    with x64_off():
        cam = RefCam.make(500.0, 500.0, 320.0, 240.0, bf=50.0)
        prob = ref_ba.BAProblem(poses=RefSE3(*map(J, poses0)), **{k: J(v) for k, v in arrays.items()})
        S, b, U, Hi, bp = ref_ba._visual_reduced_system(cam, prob.poses, prob.points, prob,
                                                        J(lam), True)
        dxp = ref_ba.back_substitute_points(U, Hi, bp, J(dxc))
        want = [np.asarray(a) for a in (S, b, U, Hi, bp, dxp)]
    pcam = CameraParams.make(500.0, 500.0, 320.0, 240.0, bf=50.0)
    prob = local_ba.BAProblem(poses=SE3(*map(T, poses0)), **{k: T(v) for k, v in arrays.items()})
    S, b, U, Hi, bp = local_ba._visual_reduced_system(pcam, prob.poses, prob.points, prob,
                                                      torch.tensor(lam), True)
    dxp = local_ba.back_substitute_points(U, Hi, bp, T(dxc))
    for name, g, w in zip(("S", "b", "U", "Hpp_inv", "bp", "dxp"), (S, b, U, Hi, bp, dxp), want):
        if name in ("Hpp_inv", "dxp"):
            w2 = w.reshape(w.shape[0], -1)
            scale = np.maximum(np.abs(w2).max(axis=1, keepdims=True), 1e-12)
            assert (np.abs(N(g).reshape(w2.shape) - w2) <= 1e-2 * scale).all(), name
        else:
            scale = max(float(np.abs(w).max()), 1e-12)
            np.testing.assert_allclose(N(g), w, rtol=0, atol=1e-3 * scale, err_msg=name)


# ----------------------------------------- gather and scatter on the map


@pytest.fixture(scope="module")
def scene():
    from test_torch_mapping import scene_map

    return scene_map()


@pytest.mark.parametrize("window,fixed", [
    ([5, 4, 3, 2, -1, -1], [False, False, True, True, False, False]),
    # slot 0 live and free, with pads that clip onto it (H9)
    ([0, 3, -1, -1, -1, -1], [False, True, False, False, False, False]),
])
def test_gather_and_scatter_ba_problem_match(scene, window, fixed):
    """gather_ba_problem (slot-to-window lookup by max-scatter, so a -1 pad
    clipped to slot 0 never hides slot 0's index) and scatter_ba_result
    (non-updated entries dropped, so a pad never overwrites slot 0's new
    pose): problem arrays exact (floats are gathers), map after the
    scatter exact."""
    window = np.array(window, np.int32)
    fixed = np.array(fixed)
    rcam, pcam = _cams()
    with x64_off():
        ms_r = to_ref(scene)
        ids_r, _ = ref_steps.gather_local_points(ms_r, J(window), 256)
        prob_r = ref_steps.gather_ba_problem(rcam, ms_r, J(window), J(fixed), ids_r,
                                             n_window=6, n_points=256, n_obs=8)
        new_R = np.asarray(prob_r.poses.R) @ np.asarray(ref_se3.exp(J(np.full((6,), 1e-3, np.float32))).R)
        new_t = np.asarray(prob_r.poses.t) + 0.01
        new_p = np.asarray(prob_r.points) + 0.02
        out = ref_steps.scatter_ba_result(ms_r, J(window), J(fixed), ids_r,
                                          RefSE3(J(new_R.astype(np.float32)), J(new_t)), J(new_p))
        want_prob = [np.asarray(a) for a in jax.tree.leaves(prob_r)]
        want = ref_state.MapState(*[np.asarray(a) for a in out])
        ids_r = np.asarray(ids_r)
    ms = to_port(scene)
    ids, _ = steps.gather_local_points(ms, T(window), 256)
    np.testing.assert_array_equal(N(ids), ids_r)
    prob = steps.gather_ba_problem(pcam, ms, T(window), T(fixed), ids, n_window=6,
                                   n_points=256, n_obs=8)
    got_prob = [N(prob.poses.R), N(prob.poses.t)] + [N(a) for a in prob[1:]]
    assert len(got_prob) == len(want_prob)
    for g, w in zip(got_prob, want_prob):
        np.testing.assert_array_equal(g, w)
    assert prob.obs_mask.sum() > 100
    ms = steps.scatter_ba_result(ms, T(window), T(fixed), ids,
                                 SE3(T(new_R.astype(np.float32)), T(new_t)), T(new_p))
    assert_maps_equal(ms, want, rtol=0, atol=0)
    if window[0] == 0:
        np.testing.assert_array_equal(N(ms.kf_t)[0], new_t[0])


@pytest.mark.parametrize("ref_slot", [5, 3])
def test_local_ba_program_matches(scene, ref_slot):
    """StereoVO's local-BA program at 2 LM iterations over an 8-keyframe
    window (the scene's 6 keyframes and 2 pads, which share the sort key
    int32.max, so the fixed set's double argsort must be stable): the
    fixed keyframes (origin + oldest third) unchanged, the map's integer
    arrays exact, rotations within 1e-4, points within 2e-3 relative, and
    translations within 2e-3 m (the live-pose correction too): the second
    LM step moves the free keyframes along a flat valley of the cost (at
    slot 3: 100.64 -> 100.56 on both sides), where the float32 rounding of
    the 48x48 solve moves them by up to 1.1 mm."""
    cfg = scene_config(max_local_kfs=8)
    with x64_off():
        ref = RefStereoVO(cfg)
        out, dR_r, dt_r = ref._local_ba_fn(to_ref(scene), jnp.int32(ref_slot))
        want = ref_state.MapState(*[np.asarray(a) for a in out])
        dR_r, dt_r = np.asarray(dR_r), np.asarray(dt_r)
    port = StereoVO(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    got, delta = port._local_ba_program(to_port(scene), ref_slot)
    got_np = map_state.map_state_to_numpy(got)
    for name, w in zip(want._fields, want):
        if name in ("kf_R", "kf_t"):
            atol = 1e-4 if name == "kf_R" else 2e-3
            np.testing.assert_allclose(got_np[name], w, rtol=0, atol=atol, err_msg=name)
        elif name == "mp_pos":
            np.testing.assert_allclose(got_np[name], w, rtol=2e-3, atol=2e-3, err_msg=name)
        else:
            np.testing.assert_array_equal(got_np[name], w, err_msg=name)
    np.testing.assert_allclose(N(delta.R), dR_r, rtol=0, atol=1e-4)
    np.testing.assert_allclose(N(delta.t), dt_r, rtol=0, atol=2e-3)
    moved = np.abs(want.kf_t - scene["kf_t"]).max(axis=1) > 0
    np.testing.assert_array_equal(np.abs(got_np["kf_t"] - scene["kf_t"]).max(axis=1) > 0, moved)
    assert not moved[0] and moved.sum() >= 2


def test_lu_pivots_match_reference():
    """`utils/numerics.py::lu3_pivots` gives the pivots of the reference's
    float32 LU (`jax.lax.linalg.lu`, which `jnp.linalg.inv` uses) bit for
    bit, zero pivots included, on nearly singular 3x3 normal matrices and
    on random ones with ties in the pivot search."""
    from vi_slam_tpu_torch.utils.numerics import lu3_pivots

    rng = np.random.default_rng(10)
    Jm = rng.normal(0, 1, (4000, 3, 3)) * rng.uniform(1, 100, (4000, 1, 1))
    Jm[:, 2] = Jm[:, 0] + rng.normal(0, 1, (4000, 3)) * 10 ** rng.uniform(-6, -1, (4000, 1))
    A = np.concatenate([np.einsum("nki,nkj->nij", Jm, Jm) + 1e-4 * np.eye(3),
                        np.round(rng.normal(0, 2, (1000, 3, 3)))]).astype(np.float32)
    with x64_off():
        lu = np.asarray(jax.jit(jax.lax.linalg.lu)(J(A))[0])
        inv = np.asarray(jax.jit(jnp.linalg.inv)(J(A)))
    got = N(lu3_pivots(T(A)))
    np.testing.assert_array_equal(got, np.stack([lu[:, 0, 0], lu[:, 1, 1], lu[:, 2, 2]], 1))
    zero = (got == 0).any(axis=1)
    assert zero.sum() > 100
    np.testing.assert_array_equal(zero, ~np.isfinite(inv).all(axis=(1, 2)))


def test_singular_landmark_keeps_the_cameras():
    """A point seen once, without a right-image match, has a rank-2 3x3
    block that only the damping (1e-4) keeps invertible; the reference's
    float32 LU of it can meet a zero pivot. Then the non-finite inverse
    spreads through the reduced camera system, the isfinite guard zeroes
    the camera step, and only the points move. The port does the same
    (here 40 such points 2-10 m away, some of them inverted to non-finite
    by the reference)."""
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
        Hi = jax.jit(lambda p: ref_ba._visual_reduced_system(
            cam, p.poses, p.points, p, jnp.float32(1e-4), True)[3])(prob)
        assert not np.isfinite(np.asarray(Hi)).all()  # the case under test
    got, want = _run_both(arrays, poses0, 2)
    _assert_results_close(got, want)
    for res in (got, want):  # unchanged up to the final re-orthonormalization
        np.testing.assert_allclose(res[0], poses0[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(res[1], poses0[1], rtol=0, atol=1e-6)
    assert np.abs(got[2][40:] - arrays["points"][40:]).max() > 1e-3
