"""The port's fixed-lag smoother (`optim/smoother.py`) against the JAX
package's `optim/smoother.py` on the same inputs, on the CPU.

The scenarios are tests/test_smoother.py's: a body on an analytic
trajectory, exact IMU between states 0.25 s apart (200 Hz), visual anchors
from 300 landmarks, perturbed initial states. "converges": window 6, 10
states (the window slides four times), anchors on every state; "marginal":
window 4, 7 states, anchors on even states only. The inputs are made once
with the reference's functions and fed to both sides; the reference runs
with x64 off (a fresh `jax.enable_x64(False)` per use), the port on one
torch thread.

Tolerances (float32 systems assembled in another order, the blocks by
analytic Jacobians where the reference differentiates forward), each with
the largest difference measured:
  * `_build_system`, each kind of factor alone and all together: H and b
    within 1e-4 of their largest entry (5.2e-7 and 4.6e-6), the cost rtol
    1e-5 (1.1e-6);
  * `optimize_window` at 2 and 4 iterations: positions 1e-4 m (5.1e-5),
    rotations 1e-4 (9.0e-6), velocities 1e-3 m/s (3.8e-5), biases 1e-4
    (2.4e-5); the cost at the last step within 1e-4 of the window's
    starting cost (6.9e-6);
  * `marginalize_oldest`: see its test (the Schur complement's float32
    cancellation);
  * the whole runs: see their test (the marginal scenario's excursion,
    ROADMAP F13);
  * the pipeline's step: pose and velocity as `optimize_window`'s
    (rotation 1.1e-5, position 7.8e-5 m, velocity 6.9e-5 m/s), and
    bit-equal between a turned and an identity T_bc.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_smoother import CAM as REF_CAM
from test_smoother import DT_KF, IMU_HZ, _imu_between, _state_at, _vis_anchors
from test_torch_loop_parts import x64_off

from vi_slam_tpu.imu import preintegration as ref_pre
from vi_slam_tpu.lie import se3 as ref_se3
from vi_slam_tpu.lie.se3 import SE3 as RefSE3
from vi_slam_tpu.optim import smoother as ref_sm
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.imu import preintegration as pre
from vi_slam_tpu_torch.lie import se3
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.optim import smoother
from vi_slam_tpu_torch.optim.pose_opt import PoseObs

CAM = CameraParams.make(400.0, 400.0, 320.0, 240.0)
GRAVITY = (0.0, 0.0, -9.81)
WG, WA = 1e6, 1e4  # FixedLagSmoother's walk informations


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


def N(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _np_tree(win):
    return jax.tree.map(np.asarray, win)


def _jnp_tree(win):
    return jax.tree.map(jnp.asarray, win)


SCENARIOS = {  # window, states, seed, pose and velocity noise, anchors on odd states
    "converges": (6, 10, 1, 0.03, 0.1, True),
    "marginal": (4, 7, 2, 0.02, 0.05, False),
}


def _inputs(name):
    """tests/test_smoother.py's pushes as numpy, made as that test makes
    them (under the test run's x64, float32 arrays): (T_R, T_t, vel,
    preint or None, xw, uv) per state, and the truth (T_R, T_t, vel) per
    state."""
    window, n, seed, s_xi, s_v, odd = SCENARIOS[name]
    rng = np.random.default_rng(0)
    landmarks = np.stack([rng.uniform(-8, 8, 300), rng.uniform(-2, 25, 300),
                          rng.uniform(-4, 7, 300)], axis=1)
    calib = ref_pre.ImuCalib.make(1e-4, 1e-3, 1e-6, 1e-5, IMU_HZ)
    rng = np.random.default_rng(seed)
    pushes, truth = [], []
    for k in range(n):
        T_gt, v_gt = _state_at(k * DT_KF)
        xi = rng.normal(size=6) * s_xi
        T0 = ref_se3.retract_left(T_gt, jnp.asarray(xi, jnp.float32))
        v0 = np.asarray(v_gt + rng.normal(size=3) * s_v, np.float32)
        p = None
        if k > 0:
            acc, gyro, dts = _imu_between((k - 1) * DT_KF, k * DT_KF)
            f = lambda a: jnp.asarray(a, jnp.float32)
            p = _np_tree(ref_pre.integrate(calib, f(acc), f(gyro), f(dts),
                                           jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32)))
        if odd or k % 2 == 0:
            xw, uv = _vis_anchors(T_gt, landmarks)
        else:
            xw, uv = np.zeros((0, 3)), np.zeros((0, 2))
        pushes.append((np.asarray(T0.R), np.asarray(T0.t), v0, p, xw, uv))
        truth.append((np.asarray(T_gt.R), np.asarray(T_gt.t), np.asarray(v_gt)))
    return window, pushes, truth


def _reference_runs():
    """Each scenario through the reference's FixedLagSmoother (4
    iterations after every push, as its test runs): the window after
    every push and after its optimize, the cost and the latest state
    after every optimize."""
    out = {}
    for name in SCENARIOS:
        window, pushes, truth = _inputs(name)
        before, after, latest, costs = [], [], [], []
        with x64_off():
            sm = ref_sm.FixedLagSmoother(REF_CAM, window=window, max_vis=96)
            for R, t, v, p, xw, uv in pushes:
                pj = None if p is None else _jnp_tree(p)
                sm.push(RefSE3(jnp.asarray(R), jnp.asarray(t)), v, pj, vis_xw=xw, vis_uv=uv)
                before.append(_np_tree(sm.win))
                costs.append(sm.optimize(iters=4))
                after.append(_np_tree(sm.win))
                T, v_est, bg, ba = sm.latest()
                latest.append((np.asarray(T.R), np.asarray(T.t), v_est, bg, ba))
        out[name] = dict(window=window, pushes=pushes, truth=truth, before=before,
                         after=after, latest=latest, costs=costs)
    return out


@pytest.fixture(scope="module")
def reference_runs():
    return _reference_runs()


def _ref_args():
    return (jnp.asarray(GRAVITY, jnp.float32), jnp.asarray(WG, jnp.float32),
            jnp.asarray(WA, jnp.float32))


def _port_args():
    return (torch.tensor(GRAVITY), torch.tensor(WG), torch.tensor(WA))


FACTORS = {  # the fields zeroed to keep one kind of factor
    "visual": ("inertial_valid", "prior_H"),
    "inertial": ("vis_valid", "prior_H"),
    "prior": ("vis_valid", "inertial_valid"),
    "all": (),
}
# "partial": the converges run after 4 pushes (slots 4 and 5 invalid);
# "slid": after 8 pushes (slid twice, full), its newest state perturbed. In
# the slid window slot 0 sits at its prior's linearization point, so the
# prior's residual there is rounding noise: the prior alone is compared on
# the partial window (and through the slides below).
SYSTEM_CASES = [(c, f) for c in ("partial", "slid") for f in FACTORS
                if (c, f) != ("slid", "prior")]


@pytest.mark.parametrize("case,factor", SYSTEM_CASES)
def test_build_system_matches_reference(reference_runs, case, factor):
    """H, b and cost of the reference's window, for each kind of factor
    alone and for all of them together: H and b within 1e-4 of their
    largest entry, the cost within rtol 1e-5."""
    i = 3 if case == "partial" else 7
    win = reference_runs["converges"]["before"][i]
    win = win._replace(**{k: np.zeros_like(getattr(win, k)) for k in FACTORS[factor]})
    with x64_off():
        H_r, b_r, c_r = ref_sm._build_system(REF_CAM, _jnp_tree(win), *_ref_args())
        H_r, b_r, c_r = np.asarray(H_r), np.asarray(b_r), float(c_r)
    H, b, c = smoother._build_system(CAM, smoother.window_from_numpy(win, device="cpu"),
                                     *_port_args())
    np.testing.assert_allclose(N(H), H_r, rtol=0, atol=1e-4 * np.abs(H_r).max())
    np.testing.assert_allclose(N(b), b_r, rtol=0, atol=1e-4 * np.abs(b_r).max())
    np.testing.assert_allclose(float(c), c_r, rtol=1e-5)


def _assert_states(got, want, pos, rot, vel, bias):
    """(T_R, T_t, vel, bg, ba) of a window or of one state."""
    for g, w, tol in zip(got, want, (rot, pos, vel, bias, bias)):
        np.testing.assert_allclose(N(g), w, rtol=0, atol=tol)


def _states(win):
    return win.T_R, win.T_t, win.vel, win.bg, win.ba


@pytest.mark.parametrize("iters", [2, 4])
def test_optimize_window_matches_reference(reference_runs, iters):
    """The converges run's window after its 8th push (slid twice, full),
    optimized from the same start: the states within the stated
    tolerances, and the cost at the last step within 1e-4 of the
    window's starting cost (the cost falls from 2.2e6 to 7e2 after one
    step and to 3e-4 after three, where it is rounding)."""
    win = reference_runs["converges"]["before"][7]
    with x64_off():
        c0 = float(ref_sm._build_system(REF_CAM, _jnp_tree(win), *_ref_args())[2])
        w_r, c_r = ref_sm.optimize_window(REF_CAM, _jnp_tree(win), *_ref_args(), iters=iters)
        w_r, c_r = _np_tree(w_r), float(c_r)
    w, c = smoother.optimize_window(CAM, smoother.window_from_numpy(win, device="cpu"),
                                    *_port_args(), iters=iters)
    _assert_states(_states(w), _states(w_r), pos=1e-4, rot=1e-4, vel=1e-3, bias=1e-4)
    assert abs(float(c) - c_r) <= 1e-4 * c0


def test_marginalize_oldest_matches_reference(reference_runs):
    """The converges run's full window as its 7th push finds it (6 states,
    optimized), slid. The Schur complement cancels entries of 1e9 down to
    the 1e6 of the new prior, so in float32 it carries rounding of a few
    tenths of a percent of its largest entry on either side: the port's
    prior within 2e-2 of the reference's largest entry (measured 5.7e-3)
    and within 1e-2 of the float64 Schur complement of the reference's
    own float32 system (measured 1.7e-3; the reference's own result is
    6.8e-3 from it). Every slot moved down by one and the last one freed,
    and the new prior's linearization point the old slot 1, all as in the
    reference."""
    full = reference_runs["converges"]["after"][5]
    touching = full._replace(
        vis_valid=np.concatenate([full.vis_valid[:1], np.zeros_like(full.vis_valid[1:])]),
        inertial_valid=np.concatenate([full.inertial_valid[:1],
                                       np.zeros_like(full.inertial_valid[1:])]))
    with x64_off():
        slid = _np_tree(ref_sm.marginalize_oldest(REF_CAM, _jnp_tree(full), *_ref_args()))
        Ht = np.asarray(ref_sm._build_system(REF_CAM, _jnp_tree(touching), *_ref_args())[0],
                        np.float64)
    D = smoother.D
    H01 = Ht[:D, D:2 * D]
    exact = Ht[D:2 * D, D:2 * D] - H01.T @ np.linalg.solve(Ht[:D, :D] + 1e-8 * np.eye(D), H01)
    got = smoother.marginalize_oldest(CAM, smoother.window_from_numpy(full, device="cpu"),
                                      *_port_args())
    scale = np.abs(slid.prior_H).max()
    np.testing.assert_allclose(N(got.prior_H), slid.prior_H, rtol=0, atol=2e-2 * scale)
    np.testing.assert_allclose(N(got.prior_H), 0.5 * (exact + exact.T), rtol=0, atol=1e-2 * scale)
    for k in ("T_R", "T_t", "vel", "bg", "ba", "valid", "inertial_valid", "vis_xw", "vis_uv",
              "vis_sigma2", "vis_valid", "prior_R", "prior_t", "prior_vel", "prior_bg",
              "prior_ba"):
        np.testing.assert_array_equal(N(getattr(got, k)), getattr(slid, k), err_msg=k)
    for a, b in zip(got.preint, slid.preint):
        np.testing.assert_array_equal(N(a), b)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fixed_lag_smoother_run_matches_reference(reference_runs, name):
    """The port's FixedLagSmoother over the scenario, the latest state
    after every push and optimize against the reference's, and the
    reference test's own limits on the port (converges: pose error below
    0.02 from the 3rd state on, velocity within 0.15 m/s, biases below
    0.01 and 0.1; marginal: the last pose within 0.05).

    converges: every push within 1e-4 m, 1e-4, 1e-3 m/s, 1e-4 (measured
    1.9e-5, 3.2e-6, 2.8e-5, 2.7e-5). marginal: the first anchorless
    state (push 1) is held only by the 1e1 velocity prior, and the
    window's float32 system has a condition number of about 4.5e8 there;
    the reference's four steps from the perturbed start end 10.9 m off
    (cost 2.2e10) and recover when the next anchored state comes (ROADMAP
    F13). So push 0 is held as above, and from push 3 on, after the
    excursion has left the window's estimate, within 1e-3 m, 1e-3,
    1e-3 m/s and 1e-3 (measured 2.5e-4, 4.1e-5, 2.5e-4, 2.3e-4)."""
    run = reference_runs[name]
    sm = smoother.FixedLagSmoother(CAM, window=run["window"], max_vis=96, device="cpu")
    errs = []
    if name == "marginal":
        assert run["costs"][1] > 1e9  # the reference's excursion
    for k, ((R, t, v, p, xw, uv), want, gt) in enumerate(
            zip(run["pushes"], run["latest"], run["truth"])):
        preint = None if p is None else pre.preintegrated_from_numpy(p, device="cpu")
        sm.push(SE3(torch.from_numpy(np.array(R)), torch.from_numpy(np.array(t))), v, preint,
                vis_xw=xw, vis_uv=uv)
        sm.optimize(iters=4)
        T, v_est, bg, ba = sm.latest()
        got = (T.R, T.t, v_est, bg, ba)
        if name == "converges" or k == 0:
            _assert_states(got, want, pos=1e-4, rot=1e-4, vel=1e-3, bias=1e-4)
        elif k >= 3:
            _assert_states(got, want, pos=1e-3, rot=1e-3, vel=1e-3, bias=1e-3)
        T_gt = SE3(torch.from_numpy(gt[0]), torch.from_numpy(gt[1]))
        errs.append(float(torch.linalg.vector_norm(se3.log(T.compose(T_gt.inverse())))))
        if name == "converges" and k >= 2:
            assert np.linalg.norm(v_est - gt[2]) < 0.15
    if name == "converges":
        assert max(errs[2:]) < 0.02, errs
        assert np.linalg.norm(bg) < 0.01 and np.linalg.norm(ba) < 0.1
    else:
        assert errs[-1] < 0.05, errs


def test_not_positive_definite_gives_nan(reference_runs):
    """A window whose system is not positive definite (a negative prior
    information) gives NaN states where the reference's Cholesky gives
    them; sliding that window gives a NaN prior, as the reference's `eigh`
    does, where torch's would raise; no raise."""
    win = reference_runs["converges"]["before"][1]
    win = win._replace(prior_H=np.asarray(-1e3 * np.eye(15), np.float32))
    with x64_off():
        w_r, _ = ref_sm.optimize_window(REF_CAM, _jnp_tree(win), *_ref_args(), iters=2)
        slid_r = _np_tree(ref_sm.marginalize_oldest(REF_CAM, w_r, *_ref_args()))
        w_r = _np_tree(w_r)
    w, _ = smoother.optimize_window(CAM, smoother.window_from_numpy(win, device="cpu"),
                                    *_port_args(), iters=2)
    assert np.all(np.isnan(w_r.T_t[:2])) and np.all(np.isnan(w_r.vel[:2]))
    np.testing.assert_array_equal(np.isnan(N(w.T_t)), np.isnan(w_r.T_t))
    np.testing.assert_array_equal(np.isnan(N(w.vel)), np.isnan(w_r.vel))
    slid = smoother.marginalize_oldest(CAM, w, *_port_args())
    assert np.all(np.isnan(slid_r.prior_H))
    np.testing.assert_array_equal(np.isnan(N(slid.prior_H)), np.isnan(slid_r.prior_H))


def test_anchor_selection_matches_reference_top_k():
    """Anchors with sigma2 tied per pyramid level and 57 of 300 valid: the
    port picks the reference's 96 rows (`jax.lax.top_k` of -sigma2 over
    the valid ones, ties by the lower index, the -inf rows after them by
    index) and flags the same ones valid."""
    rng = np.random.default_rng(4)
    n = 300
    level = rng.integers(0, 8, n)
    s2 = (1.2 ** (2 * level)).astype(np.float32)
    ok = np.zeros(n, bool)
    ok[rng.choice(n, 57, replace=False)] = True
    xw = np.stack([np.arange(n), rng.normal(size=n), rng.normal(size=n)], 1).astype(np.float32)
    uvr = rng.uniform(0, 600, (n, 3)).astype(np.float32)
    with x64_off():
        score = jnp.where(jnp.asarray(ok), -jnp.asarray(s2), -jnp.inf)
        _, sel = jax.lax.top_k(score, 96)
        sel = np.asarray(sel)
        vvalid = np.asarray(jnp.asarray(ok)[sel] & jnp.isfinite(score[sel]))
    obs = PoseObs(xw=torch.from_numpy(xw), uvr=torch.from_numpy(uvr),
                  stereo=torch.ones(n, dtype=torch.bool), sigma2=torch.from_numpy(s2),
                  valid=torch.ones(n, dtype=torch.bool))
    got_xw, got_uv, got_s2, got_valid = smoother.select_anchors(obs, torch.from_numpy(ok), 96)
    np.testing.assert_array_equal(N(got_xw)[:, 0].astype(int), sel)
    np.testing.assert_array_equal(N(got_uv), uvr[sel, :2])
    np.testing.assert_array_equal(N(got_s2), np.maximum(s2[sel], 1e-6))
    np.testing.assert_array_equal(N(got_valid), vvalid)
    assert vvalid.sum() == 57 and len(set(level[sel[:57]])) > 1


def test_pipeline_step_ignores_T_bc_and_matches_reference(reference_runs):
    """H12: the pipeline's smoother step passes the identity extrinsic to
    the inertial edges whatever cfg.imu.T_bc is, as the reference's does
    (`pipeline/vio.py::_smoother_step`). On a full window (the converges
    run's, as its 7th push finds it) a StereoInertialVO whose T_bc turns
    and shifts the IMU and one whose T_bc is the identity give the same
    smoothed pose and velocity, bit for bit; and both equal the
    reference's slide, insertion and 2 iterations on the same window with
    the pipeline's walk informations (at the nominal frame interval),
    within the optimize tolerances above."""
    import dataclasses

    from test_torch_vio import make_cfg

    from vi_slam_tpu.cameras.base import CameraParams as RefCam
    from vi_slam_tpu_torch.cameras import pinhole
    from vi_slam_tpu_torch.pipeline.vio import StereoInertialVO
    from vi_slam_tpu_torch.utils.config import config_from_dict

    run = reference_runs["converges"]
    R, t, v, p, xw, uv = run["pushes"][6]
    T_gt = SE3(*(torch.from_numpy(np.array(a)) for a in run["truth"][6][:2]))
    base = make_cfg()  # with tests/test_smoother.py's camera
    base = dataclasses.replace(base, ba=dataclasses.replace(base.ba, use_smoother=True),
                               camera=dataclasses.replace(base.camera, fx=400.0, fy=400.0))
    T_bc = np.eye(4)
    T_bc[:3, :3] = np.asarray([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
    T_bc[:3, 3] = [0.1, -0.05, 0.02]
    turned = dataclasses.replace(base, imu=dataclasses.replace(base.imu, T_bc=tuple(T_bc.reshape(-1))))
    n = 120  # the push's anchors, then rows that are not valid
    c = base.camera
    vo_cam = CameraParams.make(c.fx, c.fy, c.cx, c.cy)
    xw_all = np.zeros((n, 3), np.float32)
    xw_all[:len(xw)] = xw
    uv_all = N(pinhole.project(vo_cam, T_gt.apply(torch.from_numpy(xw_all))))
    ok = np.arange(n) < len(xw)
    obs = PoseObs(xw=torch.from_numpy(xw_all),
                  uvr=torch.from_numpy(np.concatenate([uv_all, uv_all[:, :1]], 1)),
                  stereo=torch.ones(n, dtype=torch.bool), sigma2=torch.ones(n),
                  valid=torch.from_numpy(ok))
    g = torch.tensor(GRAVITY)
    z3 = torch.zeros(3)
    out = []
    for cfg in (turned, base):
        vo = StereoInertialVO(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
        vo.smoother_win = smoother.window_from_numpy(run["after"][5], device="cpu")
        vo.smoother_count = 6
        T_s, v_s = vo._smoother_step(SE3(torch.from_numpy(np.array(R)),
                                         torch.from_numpy(np.array(t))),
                                     torch.from_numpy(np.array(v)), z3, z3,
                                     pre.preintegrated_from_numpy(p, device="cpu"), obs,
                                     torch.from_numpy(ok), g)
        out.append((N(T_s.R), N(T_s.t), N(v_s)))
        assert vo.smoother_count == 7 and vo.program_runs["smoother_slide"] == 1
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    # the reference's step on the same window
    nominal_dt = 1.0 / base.camera.fps
    wig = 1.0 / (float(base.imu.walk_gyro) ** 2 * nominal_dt)
    wia = 1.0 / (float(base.imu.walk_acc) ** 2 * nominal_dt)
    with x64_off():
        cam = RefCam.make(c.fx, c.fy, c.cx, c.cy)
        args = (jnp.asarray(GRAVITY, jnp.float32), jnp.asarray(wig, jnp.float32),
                jnp.asarray(wia, jnp.float32))
        w = ref_sm.marginalize_oldest(cam, _jnp_tree(run["after"][5]), *args)
        score = jnp.where(jnp.asarray(ok), -1.0, -jnp.inf)
        _, sel = jax.lax.top_k(score, 96)
        k = 5
        w = w._replace(
            T_R=w.T_R.at[k].set(R), T_t=w.T_t.at[k].set(t), vel=w.vel.at[k].set(v),
            bg=w.bg.at[k].set(0.0), ba=w.ba.at[k].set(0.0), valid=w.valid.at[k].set(True),
            vis_xw=w.vis_xw.at[k].set(xw_all[np.asarray(sel)]),
            vis_uv=w.vis_uv.at[k].set(uv_all[np.asarray(sel)]),
            vis_sigma2=w.vis_sigma2.at[k].set(1.0),
            vis_valid=w.vis_valid.at[k].set(jnp.asarray(ok)[sel] & jnp.isfinite(score[sel])),
            preint=jax.tree.map(lambda d, s_: d.at[k - 1].set(s_), w.preint, _jnp_tree(p)),
            inertial_valid=w.inertial_valid.at[k - 1].set(True))
        w, _ = ref_sm.optimize_window(cam, w, *args, iters=base.ba.smoother_iters)
        want = (np.asarray(w.T_R[k]), np.asarray(w.T_t[k]), np.asarray(w.vel[k]))
    _assert_states(out[0], want, pos=1e-4, rot=1e-4, vel=1e-3, bias=0)
