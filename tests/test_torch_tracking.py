"""Tracking path of the port against the JAX package, on the same numpy
inputs: config, Lie groups, the pinhole camera, Huber weights, projection
matching, pose optimization, the map updates and the per-frame steps on a
map carried across (`map_state_from_numpy` / `map_state_to_numpy`).

The reference runs with x64 off, as the bench does. Tolerances, and why:
  * integer and boolean outputs (indices, masks, ids, counts, map
    incidence): exactly equal.
  * Lie groups and cameras: atol 1e-5 on O(1) values (float32 transcendental
    functions and 3-term sums in another order).
  * pose optimization: 40 Gauss-Newton steps of float32 normal equations
    summed in another order: poses within 1e-4 (rotation) and 1e-3 m.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_slam_tpu.cameras import CameraParams as RefCam
from vi_slam_tpu.cameras import pinhole as ref_pinhole
from vi_slam_tpu.features.extractor import Features as RefFeatures
from vi_slam_tpu.lie import se3 as ref_se3
from vi_slam_tpu.lie import so3 as ref_so3
from vi_slam_tpu.lie.se3 import SE3 as RefSE3
from vi_slam_tpu.ops import match as ref_match
from vi_slam_tpu.optim import pose_opt as ref_pose_opt
from vi_slam_tpu.optim import robust as ref_robust
from vi_slam_tpu.pipeline import steps as ref_steps
from vi_slam_tpu.slam_map import state as ref_state
from vi_slam_tpu.utils import config as ref_config
from vi_slam_tpu_torch.cameras import pinhole
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.features.extractor import Features
from vi_slam_tpu_torch.lie import se3, so3
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.ops import match
from vi_slam_tpu_torch.optim import pose_opt, robust
from vi_slam_tpu_torch.pipeline import steps
from vi_slam_tpu_torch.slam_map import state as map_state
from vi_slam_tpu_torch.utils import config
from vi_slam_tpu_torch.utils.device import resolve_device


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


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def J(a):
    return jnp.asarray(np.asarray(a))


# --------------------------------------------------------------- config


def _asdict_by_name(cfg):
    d = dataclasses.asdict(cfg)
    d["sensor"] = cfg.sensor.name
    return d


def test_config_defaults_match():
    assert _asdict_by_name(config.SystemConfig()) == _asdict_by_name(ref_config.SystemConfig())


def test_config_from_reference_dict():
    ref = ref_config.SystemConfig(
        camera=ref_config.CameraConfig(width=320, height=240, dist=(0.1, 0.0, 0.0, 0.0, 0.0)),
        tracker=ref_config.TrackerConfig(pipeline_depth=1, mapping_every=7),
    )
    port = config.config_from_dict(dataclasses.asdict(ref))
    assert _asdict_by_name(port) == _asdict_by_name(ref)
    assert port.camera.dist == (0.1, 0.0, 0.0, 0.0, 0.0)
    with pytest.raises(KeyError):
        config.config_from_dict({"camera": {"no_such_field": 1}})


def test_device_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


# ------------------------------------------------------------ lie, cams

W_CASES = {
    "generic": np.random.default_rng(0).normal(0, 0.8, (64, 3)).astype(np.float32),
    "small": np.random.default_rng(1).normal(0, 1e-5, (16, 3)).astype(np.float32),
    "near_pi": (np.array([[1.0, 0.0, 0.0], [0.0, 0.6, 0.8], [0.48, 0.6, 0.64]]) * (np.pi - 1e-4)).astype(np.float32),
}


@jax.jit
def _ref_so3(w):
    R = ref_so3.exp(w)
    return (R, ref_so3.log(R), ref_so3.left_jacobian(w), ref_so3.inverse_right_jacobian(w),
            ref_so3.normalize(R * 1.001))


@pytest.mark.parametrize("case", sorted(W_CASES))
def test_so3_matches(case):
    w = W_CASES[case]
    with x64_off():
        want = dict(zip(("exp", "log", "jl", "jr_inv", "norm"), map(np.asarray, _ref_so3(J(w)))))
    R = want["exp"]
    got = {
        "exp": N(so3.exp(T(w))),
        "log": N(so3.log(T(R))),
        "jl": N(so3.left_jacobian(T(w))),
        "jr_inv": N(so3.inverse_right_jacobian(T(w))),
        "norm": N(so3.normalize(T(R * 1.001))),
    }
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-4 if case == "near_pi" else 1e-5, err_msg=k)


@jax.jit
def _ref_se3(xi, d, x):
    A = ref_se3.exp(xi)
    B = ref_se3.exp(xi[::-1])
    return [A.R, A.t, ref_se3.log(A), A.compose(B).R, A.compose(B).t,
            A.inverse().t, A.apply(x), ref_se3.retract_left(A, d).R,
            ref_se3.retract_left(A, d).t]


def test_se3_matches():
    rng = np.random.default_rng(2)
    xi = rng.normal(0, 0.5, (32, 6)).astype(np.float32)
    d = rng.normal(0, 0.05, (32, 6)).astype(np.float32)
    x = rng.normal(0, 5, (32, 3)).astype(np.float32)
    with x64_off():
        want = [np.asarray(a) for a in _ref_se3(J(xi), J(d), J(x))]
    A = se3.exp(T(xi))
    B = se3.exp(T(xi[::-1].copy()))
    got = [A.R, A.t, se3.log(A), A.compose(B).R, A.compose(B).t, A.inverse().t,
           A.apply(T(x)), se3.retract_left(A, T(d)).R, se3.retract_left(A, T(d)).t]
    for g, w in zip(got, want):
        np.testing.assert_allclose(N(g), w, rtol=1e-5, atol=1e-5)
    ident = SE3.identity((2,))
    np.testing.assert_array_equal(N(ident.R), np.tile(np.eye(3), (2, 1, 1)))
    np.testing.assert_array_equal(N(ident.t), np.zeros((2, 3)))


@jax.jit
def _ref_cam(xyz, uv, chi2):
    rc = RefCam.make(500.0, 480.0, 320.0, 240.0, bf=50.0)
    return [ref_pinhole.project(rc, xyz), ref_pinhole.project_jac(rc, xyz),
            ref_pinhole.unproject(rc, uv), ref_pinhole.stereo_project(rc, xyz),
            ref_pinhole.stereo_project_jac(rc, xyz),
            ref_robust.huber_weight(chi2, 5.991)]


def test_pinhole_and_robust_match():
    rng = np.random.default_rng(3)
    xyz = np.concatenate([rng.uniform(-5, 5, (50, 2)), rng.uniform(0.5, 40, (50, 1))], -1).astype(np.float32)
    uv = rng.uniform(0, 600, (50, 2)).astype(np.float32)
    chi2 = rng.uniform(0, 30, 50).astype(np.float32)
    with x64_off():
        want = [np.asarray(a) for a in _ref_cam(J(xyz), J(uv), J(chi2))]
    pc = CameraParams.make(500.0, 480.0, 320.0, 240.0, bf=50.0)
    got = [pinhole.project(pc, T(xyz)), pinhole.project_jac(pc, T(xyz)),
           pinhole.unproject(pc, T(uv)), pinhole.stereo_project(pc, T(xyz)),
           pinhole.stereo_project_jac(pc, T(xyz)),
           robust.huber_weight(T(chi2), 5.991)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(N(g), w, rtol=1e-6, atol=1e-4)


# ------------------------------------------------------------- matching

SCALES = (1.2 ** np.arange(8)).astype(np.float32)


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint32)


def test_masked_min2_matches():
    rng = np.random.default_rng(4)
    D = rng.integers(0, 20, (40, 60)).astype(np.int32)  # many ties
    mask = rng.uniform(size=(40, 60)) < 0.3
    with x64_off():
        want = [np.asarray(a) for a in ref_match.masked_min2(J(D), J(mask))]
    got = [N(a) for a in match.masked_min2(T(D), T(mask))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_search_by_projection_window_constraint():
    """tests/test_match.py::TestSearchByProjection cases."""
    rng = np.random.default_rng(7)
    n = 64
    d = _desc(rng, n).view(np.int32)
    xy = rng.uniform(0, 500, (n, 2)).astype(np.float32)
    level = np.zeros(n, np.int32)
    valid = np.ones(n, bool)
    args = [T(level), T(d), T(valid)]
    m = match.search_by_projection(T(xy), *args, T(xy), *args, radius=5.0,
                                   level_scales=T(SCALES), ratio=1.0)
    assert bool((m.idx == torch.arange(n)).all()) and int(m.ok.sum()) == n
    m2 = match.search_by_projection(T(xy + 100.0), *args, T(xy), *args, radius=5.0,
                                    level_scales=T(SCALES), ratio=1.0)
    assert int(m2.ok.sum()) == 0


@pytest.mark.parametrize("radius", [5.0, 15.0, 45.0])
def test_search_by_projection_matches(radius):
    rng = np.random.default_rng(8)
    nm, nk = 300, 400
    kd = _desc(rng, nk)
    src = rng.integers(0, nk, nm)
    pd = kd[src].copy()
    flips = rng.integers(0, 256, (nm, 30))
    for i in range(nm):  # noisy copies of keypoint descriptors
        for b in flips[i][: rng.integers(0, 30)]:
            pd[i, b // 32] ^= np.uint32(1 << (b % 32))
    kxy = rng.uniform(0, 600, (nk, 2)).astype(np.float32)
    pxy = (kxy[src] + rng.normal(0, 3, (nm, 2))).astype(np.float32)
    plv = rng.integers(0, 8, nm).astype(np.int32)
    klv = rng.integers(0, 8, nk).astype(np.int32)
    klv[src] = plv
    pv = rng.uniform(size=nm) < 0.9
    kv = rng.uniform(size=nk) < 0.95
    with x64_off():
        want = ref_match.search_by_projection(
            J(pxy), J(plv), J(pd), J(pv), J(kxy), J(klv), J(kd), J(kv),
            radius=radius, level_scales=J(SCALES), max_dist=100, ratio=0.9)
        want_r = ref_match.resolve_duplicate_targets(want, nk)
        want, want_r = [np.asarray(a) for a in want], [np.asarray(a) for a in want_r]
    got = match.search_by_projection(
        T(pxy), T(plv), T(pd.view(np.int32)), T(pv), T(kxy), T(klv), T(kd.view(np.int32)), T(kv),
        radius=radius, level_scales=T(SCALES), max_dist=100, ratio=0.9)
    got_r = match.resolve_duplicate_targets(got, nk)
    for g, w in zip(list(got) + list(got_r), want + want_r):
        np.testing.assert_array_equal(N(g), w)
    assert want[2].sum() > 20


def test_resolve_duplicates_case():
    m = match.Matches(T(np.array([3, 3, 5, 7], np.int32)), T(np.array([10, 4, 2, 9], np.int32)),
                      torch.ones(4, dtype=torch.bool))
    np.testing.assert_array_equal(N(match.resolve_duplicate_targets(m, 10).ok), [False, True, True, True])


# ----------------------------------------------------------- pose GN


def _pose_problem(seed, n=300, noise=0.5, outlier_frac=0.2, stereo=True):
    """tests/test_optim.py's synthetic pose problem, drawn with numpy."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-6, 6, (n, 2)), rng.uniform(5, 40, (n, 1))], -1).astype(np.float32)
    with x64_off():
        cam = RefCam.make(500.0, 500.0, 320.0, 240.0, bf=50.0)
        T_gt = ref_se3.exp(J(np.array([0.3, -0.1, 0.05, 0.02, -0.04, 0.01], np.float32)))
        uvr = np.array(ref_pinhole.stereo_project(cam, T_gt.apply(J(pts))))
        T_init = ref_se3.retract_left(T_gt, J((rng.normal(0, 1, 6) * 0.03).astype(np.float32)))
        T_gt = [np.asarray(a) for a in T_gt]
        T_init = [np.asarray(a) for a in T_init]
    uvr = (uvr + noise * rng.normal(0, 1, uvr.shape)).astype(np.float32)
    n_out = int(n * outlier_frac)
    uvr[:n_out] += (50.0 * rng.normal(0, 1, (n_out, 3))).astype(np.float32)
    obs = [pts, uvr, np.full(n, stereo), np.ones(n, np.float32), np.ones(n, bool)]
    return T_gt, T_init, obs, n_out


@pytest.mark.parametrize("seed,noise,outlier_frac,stereo,no_valid", [
    (0, 0.0, 0.0, True, False),
    (1, 0.5, 0.2, True, False),
    (2, 0.3, 0.1, False, False),
    (3, 0.5, 0.2, True, True),
])
def test_pose_optimize_matches(seed, noise, outlier_frac, stereo, no_valid):
    T_gt, T_init, obs, n_out = _pose_problem(seed, noise=noise, outlier_frac=outlier_frac, stereo=stereo)
    if no_valid:
        obs[4] = np.zeros_like(obs[4])
    with x64_off():
        cam = RefCam.make(500.0, 500.0, 320.0, 240.0, bf=50.0)
        Tr, inl_r, n_r = ref_pose_opt.pose_optimize(
            cam, RefSE3(*map(J, T_init)), ref_pose_opt.PoseObs(*map(J, obs)))
        Tr = [np.asarray(a) for a in Tr]
        inl_r = np.asarray(inl_r)
    pc = CameraParams.make(500.0, 500.0, 320.0, 240.0, bf=50.0)
    Tp, inl_p, n_p = pose_opt.pose_optimize(pc, SE3(*map(T, T_init)), pose_opt.PoseObs(*map(T, obs)))
    np.testing.assert_array_equal(N(inl_p), inl_r)
    assert int(n_p) == int(n_r)
    np.testing.assert_allclose(N(Tp.R), Tr[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(N(Tp.t), Tr[1], rtol=0, atol=1e-3)
    assert np.all(np.isfinite(N(Tp.t)))
    if not no_valid:
        err = np.abs(N(Tp.t) - T_gt[1]).max()
        assert err < 5e-2, err


# ------------------------------------------- map carried across + steps

K, NF, M, P = 8, 64, 512, 4


def _rand_feats(rng):
    return [
        rng.uniform(20, 300, (NF, 2)).astype(np.float32),
        rng.integers(0, 8, NF).astype(np.int32),
        rng.uniform(-3, 3, NF).astype(np.float32),
        rng.uniform(0, 50, NF).astype(np.float32),
        _desc(rng, NF),
        rng.uniform(size=NF) < 0.9,
    ]


def _port_feats(f):
    f = list(f)
    f[4] = f[4].view(np.int32)
    return Features(*map(T, f))


def _kf_inputs(rng, k, mp_prev):
    f = _rand_feats(rng)
    depth = np.where(rng.uniform(size=NF) < 0.8, rng.uniform(2, 30, NF), -1.0).astype(np.float32)
    uright = np.where(depth > 0, f[0][:, 0] - 50.0 / np.maximum(depth, 1e-3), -1.0).astype(np.float32)
    mp_ids = np.full(NF, -1, np.int32)
    if mp_prev > 0:
        pick = rng.choice(mp_prev, size=min(mp_prev, 30), replace=False)
        mp_ids[rng.choice(NF, size=len(pick), replace=False)] = pick
    xi = np.array([0, 0, 0.3 * k, 0.01 * k, 0.02, 0], np.float32)
    return f, uright, depth, mp_ids, xi


def _create_inputs(rng, C=40):
    return [
        rng.integers(0, NF, C).astype(np.int32),
        rng.normal(0, 5, (C, 3)).astype(np.float32),
        _desc(rng, C),
        rng.normal(0, 1, (C, 3)).astype(np.float32),
        rng.uniform(0.5, 2, C).astype(np.float32),
        rng.uniform(5, 50, C).astype(np.float32),
        rng.uniform(size=C) < 0.8,
    ]


@pytest.fixture(scope="module")
def carried():
    """A map built by the reference over 4 keyframes, then one more
    keyframe and one more point batch applied by both sides to the same
    carried-across map."""
    rng = np.random.default_rng(11)
    with x64_off():
        ms = ref_state.allocate(K, NF, M, P)
        for k in range(4):
            f, ur, dp, mp_ids, xi = _kf_inputs(rng, k, int(ms.mp_count[0]))
            ms = ref_state.insert_keyframe(ms, jnp.int32(k), ref_se3.exp(J(xi)), jnp.int32(k),
                                           jnp.float32(0.1 * k), RefFeatures(*map(J, f)),
                                           J(ur), J(dp), J(mp_ids))
            kp, pos, desc, nrm, mind, maxd, create = _create_inputs(rng)
            ms, _ = ref_state.create_points(ms, ms.mp_count[0], jnp.int32(k), J(kp), J(pos),
                                            J(desc), J(nrm), J(mind), J(maxd), J(create))
        before = {n: np.array(a) for n, a in zip(ms._fields, ms)}
        f, ur, dp, mp_ids, xi = _kf_inputs(rng, 4, int(ms.mp_count[0]))
        kin = (f, ur, dp, mp_ids, xi)
        ms = ref_state.insert_keyframe(ms, jnp.int32(4), ref_se3.exp(J(xi)), jnp.int32(9),
                                       jnp.float32(0.9), RefFeatures(*map(J, f)),
                                       J(ur), J(dp), J(mp_ids))
        cin = _create_inputs(rng)
        ms, ids = ref_state.create_points(ms, ms.mp_count[0], jnp.int32(4), *map(J, cin))
        upd = np.where(mp_ids >= 0, mp_ids, M - 1).astype(np.int32)
        ms = ref_state.update_point_stats(ms, J(upd))
        after = {n: np.array(a) for n, a in zip(ms._fields, ms)}
    return before, after, kin, cin, np.array(ids), upd


def test_map_round_trip(carried):
    before, _, _, _, _, _ = carried
    back = map_state.map_state_to_numpy(map_state.map_state_from_numpy(before, device="cpu"))
    for name in before:
        assert back[name].dtype == before[name].dtype, name
        np.testing.assert_array_equal(back[name], before[name], err_msg=name)


def test_insert_create_update_match(carried):
    before, after, kin, cin, ids, upd = carried
    f, ur, dp, mp_ids, xi = kin
    ms = map_state.map_state_from_numpy(before, device="cpu")
    ms = map_state.insert_keyframe(ms, 4, se3.exp(T(xi)), 9, 0.9, _port_feats(f), T(ur), T(dp), T(mp_ids))
    cin = list(cin)
    cin[2] = cin[2].view(np.int32)
    ms, pids = map_state.create_points(ms, ms.mp_count[0], 4, *map(T, cin))
    np.testing.assert_array_equal(N(pids), ids)
    ms = map_state.update_point_stats(ms, T(upd))
    got = map_state.map_state_to_numpy(ms)
    for name, want in after.items():
        if want.dtype.kind == "f":
            # kf_R/kf_t from se3.exp; normals and ranges from float32 norms
            np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)


@pytest.mark.parametrize("ref_slot", [0, 2, 3])
def test_covisibility_and_window_match(carried, ref_slot):
    _, after, _, _, _, _ = carried
    with x64_off():
        ms_r = ref_state.MapState(**{k: J(v) for k, v in after.items()})
        cov_r = np.asarray(ref_state.covisibility_row(ms_r, ref_slot))
        win_r = np.asarray(ref_steps.covis_window(ms_r, jnp.int32(ref_slot), 4))
        ids_r, mask_r = [np.asarray(a) for a in ref_steps.gather_local_points(ms_r, J(win_r), 96)]
    ms = map_state.map_state_from_numpy(after, device="cpu")
    np.testing.assert_array_equal(N(map_state.covisibility_row(ms, ref_slot)), cov_r)
    win = steps.covis_window(ms, torch.tensor(ref_slot), 4)
    np.testing.assert_array_equal(N(win), win_r)
    ids, mask = steps.gather_local_points(ms, win, 96)
    np.testing.assert_array_equal(N(ids), ids_r)
    np.testing.assert_array_equal(N(mask), mask_r)


def test_gather_local_points_priority_with_point_zero():
    """Point 0 in the reference keyframe's row, with -1 entries after it:
    the reference's scatter lets the last write to index 0 win."""
    with x64_off():
        ms_r = ref_state.allocate(4, 6, 32, 2)
        ms_r = ms_r._replace(kf_mp=ms_r.kf_mp.at[0].set(jnp.asarray([0, 5, -1, 7, -1, 3]))
                             .at[1].set(jnp.asarray([9, 0, 11, -1, 12, 13])))
        want = [np.asarray(a) for a in ref_steps.gather_local_points(ms_r, J(np.array([0, 1], np.int32)), 5)]
    ms = map_state.map_state_from_numpy({k: np.asarray(v) for k, v in zip(ms_r._fields, ms_r)}, device="cpu")
    got = [N(a) for a in steps.gather_local_points(ms, T(np.array([0, 1], np.int32)), 5)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_project_match_and_pose_obs_match(carried):
    _, after, kin, _, _, _ = carried
    rng = np.random.default_rng(12)
    f = _rand_feats(rng)
    ur = np.where(rng.uniform(size=NF) < 0.7, f[0][:, 0] - 5.0, -1.0).astype(np.float32)
    xi = np.array([0.0, 0.0, 0.5, 0.01, 0.0, 0.0], np.float32)
    with x64_off():
        ms_r = ref_state.MapState(**{k: J(v) for k, v in after.items()})
        ids_r, mask_r = ref_steps.gather_local_points(ms_r, J(np.array([4, 3, 2, -1], np.int32)), 128)
        cam = RefCam.make(300.0, 300.0, 160.0, 120.0, bf=50.0)
        proj_r = ref_steps.project_local_points(cam, ms_r, ids_r, mask_r, ref_se3.exp(J(xi)), 320, 240)
        m_r = ref_match.search_by_projection(
            proj_r.uv, proj_r.level, proj_r.desc, proj_r.valid, J(f[0]), J(f[1]), J(f[4]), J(f[5]),
            radius=400.0, level_scales=J(SCALES), max_dist=256, ratio=1.0)
        obs_r, kp_r = ref_steps.build_pose_obs(proj_r, m_r, RefFeatures(*map(J, f)), J(ur))
        mm_r = ref_steps.scatter_matches_to_kps(NF, kp_r, ids_r, m_r.ok & proj_r.valid)
        want = [np.asarray(a) for a in list(proj_r) + list(m_r) + list(obs_r) + [kp_r, mm_r]]
    ms = map_state.map_state_from_numpy(after, device="cpu")
    ids, mask = steps.gather_local_points(ms, T(np.array([4, 3, 2, -1], np.int32)), 128)
    pc = CameraParams.make(300.0, 300.0, 160.0, 120.0, bf=50.0)
    proj = steps.project_local_points(pc, ms, ids, mask, se3.exp(T(xi)), 320, 240)
    pf = _port_feats(f)
    m = match.search_by_projection(proj.uv, proj.level, proj.desc, proj.valid, pf.xy, pf.level,
                                   pf.desc, pf.valid, radius=400.0, level_scales=T(SCALES),
                                   max_dist=256, ratio=1.0)
    obs, kp = steps.build_pose_obs(proj, m, pf, T(ur))
    mm = steps.scatter_matches_to_kps(NF, kp, ids, m.ok & proj.valid)
    got = [N(a) for a in list(proj) + list(m) + list(obs) + [kp, mm]]
    got[2] = got[2].view(np.uint32)  # projected descriptors
    assert want[3].sum() > 0 and want[6].sum() > 0  # some visible, some matched
    for i, (g, w) in enumerate(zip(got, want)):
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-3, err_msg=str(i))
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(i))
