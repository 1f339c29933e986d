"""The port's inertial optimizers against the JAX package's on the same
seeded numpy inputs: `optim/pose_inertial.py` (the per-frame solves and
the IMU prediction), `optim/vi_ba.py`, `optim/inertial_init.py`, and the
inertial branch of loop closing (the 4-DoF essential graph about the
gravity axis, the pre-correction poses left for the owner, the velocity
rotation after it).

Problems: tests/test_vi_ba.py's simulated keyframe chain (200 Hz IMU,
keyframes every 0.25 s, stereo landmarks; `make_vi_problem`,
`simulate_vi_sequence`) and its perturbation and initialization cases;
tests/test_inertial_loop.py's drifted ring closed with gravity along z.
The reference runs with x64 off (a fresh `jax.enable_x64(False)` per
use); both sides get the reference's preintegrated chain.

Tolerances (float32 solves in another order of summation): poses within
1e-4, velocities 1e-3 m/s, biases 1e-4, points 1e-3 m, gravity rotations
1e-4, costs rtol 1e-3 (their scales span 1e0-1e6; the initialization's
as its test states), marginal prior
information rtol 1e-3 of its largest entry. Inlier masks and counts are
exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop_parts import K_KF, ReferenceDraws, build_ring, x64_off
from test_vi_ba import CAM as REF_CAM
from test_vi_ba import G_W, make_vi_problem, simulate_vi_sequence

from vi_slam_tpu.lie import se3 as ref_se3
from vi_slam_tpu.lie import so3 as ref_so3
from vi_slam_tpu.lie.se3 import SE3 as RefSE3
from vi_slam_tpu.cameras.base import CameraParams as RefCam
from vi_slam_tpu.optim import inertial_init as ref_init
from vi_slam_tpu.optim import pose_inertial as ref_pi
from vi_slam_tpu.optim import vi_ba as ref_vi_ba
from vi_slam_tpu.optim.pose_opt import PoseObs as RefPoseObs
from vi_slam_tpu.pipeline.loop_closing import LoopCloser as RefLoopCloser
from vi_slam_tpu.retrieval import vocabulary as ref_voc
from vi_slam_tpu.slam_map import state as ref_state
from vi_slam_tpu.utils.config import MapConfig as RefMapConfig
from vi_slam_tpu.utils.config import SystemConfig as RefSystemConfig
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.imu import preintegration as pre
from vi_slam_tpu_torch.lie import so3
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.optim import inertial_init, pose_inertial, vi_ba
from vi_slam_tpu_torch.optim.local_ba import BAProblem
from vi_slam_tpu_torch.optim.pose_opt import PoseObs
from vi_slam_tpu_torch.pipeline.loop_closing import LoopCloser
from vi_slam_tpu_torch.pipeline.vio import StereoInertialVO
from vi_slam_tpu_torch.retrieval import vocabulary
from vi_slam_tpu_torch.slam_map.state import map_state_from_numpy, map_state_to_numpy
from vi_slam_tpu_torch.utils.config import CameraConfig, IMUConfig, MapConfig, SystemConfig

CAM = CameraParams.make(500.0, 500.0, 320.0, 240.0, bf=50.0)


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


def T(a, dtype=None):
    a = np.array(a)
    if dtype is None and a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a if dtype is None else a.astype(dtype))


def N(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def J(a):
    return jnp.asarray(np.asarray(a))


def _port_preint(p):
    return pre.preintegrated_from_numpy(p, device="cpu")


def _port_ba_problem(v) -> BAProblem:
    return BAProblem(poses=SE3(T(v.poses.R), T(v.poses.t)), fixed=T(v.fixed), points=T(v.points),
                     point_valid=T(v.point_valid), obs_cam=T(v.obs_cam), obs_uvr=T(v.obs_uvr),
                     obs_stereo=T(v.obs_stereo), obs_sigma2=T(v.obs_sigma2),
                     obs_mask=T(v.obs_mask))


def _port_vi_problem(p) -> vi_ba.VIBAProblem:
    return vi_ba.VIBAProblem(
        visual=_port_ba_problem(p.visual), vel=T(p.vel), bg=T(p.bg), ba=T(p.ba),
        preint=_port_preint(p.preint), inertial_valid=T(p.inertial_valid), gravity=T(p.gravity),
        walk_info_g=T(p.walk_info_g), walk_info_a=T(p.walk_info_a), R_bc=T(p.R_bc),
        t_bc=T(p.t_bc))


# ------------------------------------------------------------- per frame


def _frame_problem(seed=0, n_pts=150, px_noise=0.3):
    """Keyframes 1 -> 2 of the simulated chain as a tracking problem: the
    previous state (body = camera), the segment between them, and stereo
    observations of random points in frame 2 (some outliers). Returns
    numpy arrays."""
    rng = np.random.default_rng(seed)
    with x64_off():
        Rwb, pwb, vel, preint = simulate_vi_sequence(seed=seed)
        seg = ref_pi.pre.Preintegrated(*(np.asarray(x[1]) for x in preint))
    Rcw = np.swapaxes(Rwb, 1, 2)
    tcw = -np.einsum("kij,kj->ki", Rcw, pwb)
    pts = np.stack([rng.uniform(-6, 6, n_pts), rng.uniform(-4, 4, n_pts),
                    rng.uniform(6, 30, n_pts)], -1)
    pw = np.einsum("ji,nj->ni", Rcw[2], pts - tcw[2])  # points in the world seen by frame 2
    pc = pts
    u = 500.0 * pc[:, 0] / pc[:, 2] + 320.0
    v = 500.0 * pc[:, 1] / pc[:, 2] + 240.0
    uvr = np.stack([u, v, u - 50.0 / pc[:, 2]], -1) + rng.normal(0, px_noise, (n_pts, 3))
    uvr[:10] += rng.normal(0, 30.0, (10, 3))  # outliers
    obs = dict(xw=pw.astype(np.float32), uvr=uvr.astype(np.float32),
               stereo=np.ones(n_pts, bool), sigma2=np.ones(n_pts, np.float32),
               valid=np.ones(n_pts, bool))
    return dict(R1=Rcw[1], t1=tcw[1], R2=Rcw[2], t2=tcw[2], v1=vel[1], v2=vel[2], seg=seg,
                obs=obs, Rwb1=Rwb[1], pwb1=pwb[1])


def _perturbed(R, t, rng, s=0.02):
    with x64_off():
        T2 = ref_se3.retract_left(RefSE3(J(R.astype(np.float32)), J(t.astype(np.float32))),
                                  J(rng.normal(0, s, 6).astype(np.float32)))
        return np.asarray(T2.R), np.asarray(T2.t)


def test_predict_camera_pose_matches_reference():
    """IMU dead reckoning from keyframe 1 through the segment to 2."""
    fp = _frame_problem()
    z3 = np.zeros(3, np.float32)
    bg = np.array([1e-3, -2e-3, 5e-4], np.float32)
    with x64_off():
        Tw, vw = ref_pi.predict_camera_pose(
            ref_pi.pre.Preintegrated(*map(J, fp["seg"])), RefSE3(J(fp["R1"]), J(fp["t1"])),
            J(fp["v1"]), J(bg), J(z3), J(G_W), J(np.eye(3, dtype=np.float32)), J(z3))
        want = [np.asarray(x) for x in (Tw.R, Tw.t, vw)]
    Tg, vg = pose_inertial.predict_camera_pose(
        _port_preint(fp["seg"]), SE3(T(fp["R1"]), T(fp["t1"])), T(fp["v1"]), T(bg), T(z3),
        T(G_W), torch.eye(3), T(z3))
    for a, b in zip((Tg.R, Tg.t, vg), want):
        np.testing.assert_allclose(N(a), b, atol=1e-4)
    # the prediction lands on the true keyframe 2
    np.testing.assert_allclose(N(Tg.t), fp["t2"], atol=1e-2)


def test_pose_inertial_optimize_matches_reference():
    """The 9-dof solve of frame 2 from a perturbed start, against the
    fixed keyframe-1 body state: pose, velocity, inlier mask."""
    fp = _frame_problem(seed=1)
    rng = np.random.default_rng(3)
    R0, t0 = _perturbed(fp["R2"], fp["t2"], rng)
    v0 = (fp["v2"] + rng.normal(0, 0.05, 3)).astype(np.float32)
    z3 = np.zeros(3, np.float32)
    I3 = np.eye(3, dtype=np.float32)
    o = fp["obs"]
    with x64_off():
        Tr, vr, inl, n = ref_pi.pose_inertial_optimize(
            REF_CAM, RefSE3(J(R0), J(t0)), J(v0), RefPoseObs(**{k: J(v) for k, v in o.items()}),
            ref_pi.pre.Preintegrated(*map(J, fp["seg"])), J(fp["Rwb1"]), J(fp["v1"]),
            J(fp["pwb1"]), J(z3), J(z3), J(G_W), J(I3), J(z3))
        want = [np.asarray(x) for x in (Tr.R, Tr.t, vr, inl, n)]
    Tg, vg, ig, ng = pose_inertial.pose_inertial_optimize(
        CAM, SE3(T(R0), T(t0)), T(v0), PoseObs(**{k: T(v) for k, v in o.items()}),
        _port_preint(fp["seg"]), T(fp["Rwb1"]), T(fp["v1"]), T(fp["pwb1"]), T(z3), T(z3),
        T(G_W), T(I3), T(z3))
    np.testing.assert_array_equal(N(ig), want[3])
    assert int(ng) == int(want[4]) and int(ng) < len(ig)
    np.testing.assert_allclose(N(Tg.R), want[0], atol=1e-4)
    np.testing.assert_allclose(N(Tg.t), want[1], atol=1e-4)
    np.testing.assert_allclose(N(vg), want[2], atol=1e-3)


def test_pose_inertial_prior_optimize_matches_reference():
    """The tracking solve: both states move (the previous under the
    initial prior), biases from a small offset; the current state, the
    inlier mask and the marginalized next prior."""
    fp = _frame_problem(seed=2)
    rng = np.random.default_rng(5)
    R0, t0 = _perturbed(fp["R2"], fp["t2"], rng)
    v0 = (fp["v2"] + rng.normal(0, 0.05, 3)).astype(np.float32)
    bg = np.array([2e-3, -1e-3, 1e-3], np.float32)
    ba = np.array([0.02, 0.01, -0.03], np.float32)
    z3 = np.zeros(3, np.float32)
    I3 = np.eye(3, dtype=np.float32)
    dt = float(fp["seg"].dt)
    wig, wia = 1.0 / (1.9e-5 ** 2 * dt), 1.0 / (3.0e-3 ** 2 * dt)
    o = fp["obs"]
    with x64_off():
        T1 = RefSE3(J(fp["R1"]), J(fp["t1"]))
        prior = ref_pi.initial_prior(T1, J(fp["v1"]), J(bg), J(ba))
        out = ref_pi.pose_inertial_prior_optimize(
            REF_CAM, prior, T1, J(fp["v1"]), J(bg), J(ba), RefSE3(J(R0), J(t0)), J(v0),
            RefPoseObs(**{k: J(v) for k, v in o.items()}),
            ref_pi.pre.Preintegrated(*map(J, fp["seg"])), J(G_W), J(I3), J(z3),
            jnp.float32(wig), jnp.float32(wia))
        T2, v2, bg2, ba2, pr, inl, n = out
        want = dict(R=np.asarray(T2.R), t=np.asarray(T2.t), v=np.asarray(v2),
                    bg=np.asarray(bg2), ba=np.asarray(ba2), H=np.asarray(pr.H),
                    inl=np.asarray(inl), n=int(n))
    T1p = SE3(T(fp["R1"]), T(fp["t1"]))
    prior = pose_inertial.initial_prior(T1p, T(fp["v1"]), T(bg), T(ba))
    T2, v2, bg2, ba2, pr, inl, n = pose_inertial.pose_inertial_prior_optimize(
        CAM, prior, T1p, T(fp["v1"]), T(bg), T(ba), SE3(T(R0), T(t0)), T(v0),
        PoseObs(**{k: T(v) for k, v in o.items()}), _port_preint(fp["seg"]), T(G_W), T(I3),
        T(z3), torch.tensor(wig, dtype=torch.float32), torch.tensor(wia, dtype=torch.float32))
    np.testing.assert_array_equal(N(inl), want["inl"])
    assert int(n) == want["n"]
    np.testing.assert_allclose(N(T2.R), want["R"], atol=1e-4)
    np.testing.assert_allclose(N(T2.t), want["t"], atol=1e-4)
    np.testing.assert_allclose(N(v2), want["v"], atol=1e-3)
    np.testing.assert_allclose(N(bg2), want["bg"], atol=1e-4)
    np.testing.assert_allclose(N(ba2), want["ba"], atol=1e-4)
    np.testing.assert_allclose(N(pr.H), want["H"], rtol=0, atol=1e-3 * np.abs(want["H"]).max())
    np.testing.assert_allclose(N(pr.R), want["R"], atol=1e-4)


# ---------------------------------------------------------------- VI BA


@pytest.mark.parametrize("case", ["truth", "perturbed"])
def test_vi_bundle_adjust_matches_reference(case):
    """tests/test_vi_ba.py's problems: at the truth without pixel noise (one
    iteration), and from its perturbation (0.01 pose, 0.05 m/s velocity,
    0.1 m points; 10 iterations)."""
    with x64_off():
        prob, (Rwb, pwb, vel_gt, pts_gt) = make_vi_problem(
            px_noise=0.0 if case == "truth" else 0.3)
        iters = 1
        if case == "perturbed":
            K = Rwb.shape[0]
            rng = np.random.default_rng(7)
            dxi = jnp.asarray(rng.normal(0, 0.01, (K, 6)), jnp.float32).at[0].set(0.0)
            poses0 = ref_se3.retract_left(prob.visual.poses, dxi)
            vel0 = prob.vel + jnp.asarray(rng.normal(0, 0.05, (K, 3)), jnp.float32)
            pts0 = prob.visual.points + jnp.asarray(rng.normal(0, 0.1, pts_gt.shape),
                                                    jnp.float32)
            prob = prob._replace(visual=prob.visual._replace(poses=poses0, points=pts0),
                                 vel=vel0)
            iters = 10
        res = ref_vi_ba.vi_bundle_adjust(REF_CAM, prob, iters=iters)
        want = [np.asarray(x) for x in (res.poses.R, res.poses.t, res.points, res.vel, res.bg,
                                        res.ba, res.cost)]
        prob_n = jax.tree.map(np.asarray, prob)
    got = vi_ba.vi_bundle_adjust(CAM, _port_vi_problem(prob_n), iters=iters)
    got = [N(x) for x in (got.poses.R, got.poses.t, got.points, got.vel, got.bg, got.ba,
                          got.cost)]
    for g, w, tol in zip(got[:-1], want[:-1], (1e-4, 1e-4, 1e-3, 1e-3, 1e-4, 1e-4)):
        np.testing.assert_allclose(g, w, atol=tol)
    np.testing.assert_allclose(got[-1], want[-1], rtol=1e-3)
    if case == "perturbed":
        assert got[-1][-1] < 0.1 * got[-1][0]


# ------------------------------------------------------ initialization


@pytest.mark.parametrize("scale", [True, False], ids=["scale", "stereo"])
def test_inertial_init_matches_reference(scale):
    """tests/test_vi_ba.py's initialization case (8 keyframes, a visual
    frame rotated by 0.07 rad and scaled by 1/2.3, 25 iterations) with the
    scale solved; and the stereo case (true scale, scale held at 1, the
    gravity rotation seeded by the rotation of the case's tilt)."""
    s_true = 2.3 if scale else 1.0
    with x64_off():
        _, _, _, preint = simulate_vi_sequence(n_kf=8, seed=3)
        Rwb, pwb, _, _ = simulate_vi_sequence(n_kf=8, seed=3)
        Rg = np.asarray(ref_so3.exp(jnp.asarray([0.06, -0.04, 0.0])), np.float32)
        Rwb_vis = np.einsum("ij,kjl->kil", Rg.T, Rwb).astype(np.float32)
        pwb_vis = (np.einsum("ij,kj->ki", Rg.T, pwb) / s_true).astype(np.float32)
        seed = None if scale else np.asarray(ref_so3.exp(jnp.asarray([0.05, -0.03, 0.0])))
        res = ref_init.inertial_init(
            J(Rwb_vis), J(pwb_vis), preint, jnp.ones((7,), bool), prior_g=1e2, prior_a=1e5,
            iters=25, optimize_scale=scale, Rwg0=None if seed is None else J(seed))
        want = [np.asarray(x) for x in res]
        preint_n = jax.tree.map(np.asarray, preint)
    got = inertial_init.inertial_init(
        T(Rwb_vis), T(pwb_vis), _port_preint(preint_n), torch.ones(7, dtype=torch.bool),
        prior_g=1e2, prior_a=1e5, iters=25, optimize_scale=scale,
        Rwg0=None if seed is None else T(seed))
    got = [N(x) for x in got]
    for g, w, tol in zip(got, want[:-1], (1e-4, 1e-4, 1e-4, 1e-4, 1e-3)):
        np.testing.assert_allclose(g, w, atol=tol)
    # the cost histories: every cost within 1e-3 of the start of each
    # other (they end at their float32 floor, where their ratio is noise);
    # with the scale, also within 5 % of each other: the start is then the
    # linear seed, a float32 SVD of an ill-conditioned system, 2.2 % apart
    np.testing.assert_allclose(got[-1], want[-1], rtol=5e-2 if scale else 1e-5,
                               atol=1e-3 * want[-1][0])


def test_apply_scaled_rotation_matches_reference():
    with x64_off():
        Rwb, pwb, vel, _ = simulate_vi_sequence(n_kf=5, seed=1)
        Rg = np.asarray(ref_so3.exp(jnp.asarray([0.1, -0.2, 0.0])), np.float32)
    Rcw = np.swapaxes(Rwb, 1, 2)
    tcw = -np.einsum("kij,kj->ki", Rcw, pwb)
    pts = np.random.default_rng(0).normal(0, 5, (50, 3)).astype(np.float32)
    with x64_off():
        want = [np.asarray(x) for x in ref_init.apply_scaled_rotation(
            J(Rcw), J(tcw), J(pts), J(vel), J(Rg), jnp.float32(1.7))]
    got = inertial_init.apply_scaled_rotation(T(Rcw), T(tcw), T(pts), T(vel), T(Rg),
                                              torch.tensor(1.7))
    for g, w in zip(got, want):
        np.testing.assert_allclose(N(g), w, atol=1e-5)


# --------------------------------------------- inertial loop correction


def test_inertial_loop_correction_matches_reference():
    """tests/test_inertial_loop.py::test_inertial_loop_corrects_with_4dof on
    both sides (the reference's draws): gravity along z, the 4-DoF graph;
    the same loop edge, the corrected poses within 2e-4 / 2e-3 m, every
    rotation correction a yaw about z (1e-4), and the pre-correction poses
    left for the owner."""
    d, desc, _, _ = build_ring()
    with x64_off():
        cam = RefCam.make(300.0, 300.0, 160.0, 120.0)
        rvoc = ref_voc.train_vocabulary(desc, k=6, levels=3, iters=4, seed=2)
        cfg = RefSystemConfig(map=RefMapConfig(max_keyframes=16, max_points=4096,
                                               max_obs_per_point=8, essential_weight_min=100))
        ref = RefLoopCloser(cfg, cam, rvoc, fix_scale=True, min_gap_kfs=8, run_gba=False)
        ref.gravity_aligned, ref.gravity_w = True, jnp.asarray([0.0, 0.0, -9.81])
        ref.consistency_th = 1
        state = ref_state.MapState(**{k: jnp.array(v, copy=True) for k, v in d.items()})
        for k in range(K_KF):
            ref.add_keyframe(state, k)
        out, closed = ref.process(state, K_KF - 1, K_KF)
        assert closed and ref._last_old_poses is not None
        want = {k: np.array(v) for k, v in zip(out._fields, out)}
    pcfg = SystemConfig(map=MapConfig(max_keyframes=16, max_points=4096, max_obs_per_point=8,
                                      essential_weight_min=100))
    pvoc = vocabulary.train_vocabulary(desc, k=6, levels=3, iters=4, seed=2, device="cpu")
    port = LoopCloser(pcfg, CameraParams.make(300.0, 300.0, 160.0, 120.0), pvoc,
                      fix_scale=True, min_gap_kfs=8, run_gba=False)
    port.gravity_aligned, port.gravity_w = True, torch.tensor([0.0, 0.0, -9.81])
    port.consistency_th = 1
    port.draw = ReferenceDraws(7)
    pstate = map_state_from_numpy(d, device="cpu")
    for k in range(K_KF):
        port.add_keyframe(pstate, k)
    pout, pclosed = port.process(pstate, K_KF - 1, K_KF)
    assert pclosed and port.loop_edges == ref.loop_edges
    old_R = N(port._last_old_poses[0])
    np.testing.assert_array_equal(old_R[:K_KF], d["kf_R"][:K_KF])
    got = map_state_to_numpy(pout)
    np.testing.assert_allclose(got["kf_R"], want["kf_R"], atol=2e-4)
    np.testing.assert_allclose(got["kf_t"], want["kf_t"], atol=2e-3)
    for k in range(K_KF):
        w = N(so3.log(torch.from_numpy(got["kf_R"][k].T @ old_R[k])))
        assert np.linalg.norm(w[:2]) < 1e-4, (k, w)


def test_velocity_rotation_after_loop_correction():
    """tests/test_inertial_loop.py::test_velocity_rotation_hook: after a
    correction the pipeline rotates every keyframe velocity, and the live
    one through the reference keyframe, by the keyframe's rotation
    correction, and consumes the pre-correction poses once."""
    cfg = SystemConfig(
        camera=CameraConfig(width=64, height=48, fx=50.0, fy=50.0, cx=32.0, cy=24.0, bf=25.0),
        map=MapConfig(max_keyframes=8, max_points=256, max_obs_per_point=4),
        imu=IMUConfig(freq=100.0))
    vo = StereoInertialVO(cfg, device="cpu")
    K = 8
    rng = np.random.default_rng(1)
    old_R = np.stack([N(so3.exp(T(rng.normal(0, 0.3, 3)))) for _ in range(K)])
    R_cor = np.stack([N(so3.exp(T([0.0, 0.0, y]))) for y in rng.normal(0, 0.2, K)])
    vel = rng.normal(0, 1.5, (K, 3)).astype(np.float32)
    vo.imu_ready = True
    vo.ref_kf = 2
    vo.kf_vel_dev = T(vel)
    vo.vel_w_dev = T(vel[2])
    vo.map.kf_R.copy_(T(np.einsum("kij,klj->kil", old_R, R_cor)))
    vo.map.kf_valid.fill_(True)

    class _Closer:
        _last_old_poses = (T(old_R), None)

    vo.loop_closer = _Closer()
    vo._after_loop_correction()
    want = np.einsum("kij,kj->ki", R_cor, vel)
    np.testing.assert_allclose(N(vo.kf_vel_dev), want, atol=1e-4)
    np.testing.assert_allclose(N(vo.vel_w_dev), want[2], atol=1e-4)
    assert vo.loop_closer._last_old_poses is None
