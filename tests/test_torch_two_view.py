"""Two-view reconstruction (monocular initialization) of the port against
the JAX package's `geometry/two_view.py`, on the same seeded numpy inputs.

The reference runs with x64 off on float32 inputs (a fresh context per
use). Scenes are tests/test_two_view.py's three: a general scene (F
wins), a planar one (H wins) and a pure rotation (rejected), built in
numpy from the same seeds, plus the matches of the first two frames of
tests/test_mono_vo.py's world.

Tolerances, and why (measured values in brackets):
  * `_normalize`: rtol 1e-6, atol 1e-6 (float32 sums of a few hundred
    terms in another order) [transform 4.8e-7];
  * `_h_dlt`, `_f_8point`: the null vector from another LAPACK build,
    compared after normalizing by H[2,2] and by the largest entry of F
    (which removes the SVD's sign): atol 2e-4 [H 6.0e-5, F 1.6e-5; F
    only on the general scene, a planar one leaves it undetermined];
  * scores: rtol 1e-4, and the inlier masks equal;
  * decompositions: the same set of (R, t) hypotheses in any order (the
    SVD's column signs permute them), atol 1e-4;
  * `_check_rt`: the DLT points differ by ~3e-5 relative
    (tests/test_torch_geometry.py), so a point whose parallax cosine lies
    within float32 rounding of the 0.99998 gate may flip: at most one
    point, within 1e-6 of the gate [1 of 4000 on the mono world]; counts
    within 1; points rtol 2e-3 [1.2e-3 on the farthest points of the
    general scene against the reference's solver vmapped under jit, as
    it runs inside `reconstruct_two_view`], parallax atol 1e-6;
  * `reconstruct_two_view` fed the reference's draws (`jax.random.choice`
    on the same key): ok and used_homography equal; where the reference
    accepts, n_good and the inlier mask equal, R and t within 1e-4 [2.4e-6
    and 1.1e-5], the points within rtol 1e-3, atol 1e-5 [1.2e-3 relative
    on the farthest of the mono world's points]. A rejected solve (the pure
    rotation) keeps a degenerate winner of 1-3 points picked by rounding.
On its own `Sampler` the port is held to tests/test_two_view.py's limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_slam_tpu.cameras.base import CameraParams as RefCam
from vi_slam_tpu.geometry import two_view as rtv
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.geometry import two_view as tv
from vi_slam_tpu_torch.io import synthetic
from vi_slam_tpu_torch.lie import so3
from vi_slam_tpu_torch.lie.se3 import SE3
from vi_slam_tpu_torch.utils.sampling import Sampler

FX = FY = 500.0
CX, CY = 320.0, 240.0
N_HYP = 200


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


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def port_cam():
    return CameraParams.make(FX, FY, CX, CY, bf=0.0)


def ref_cam():
    return RefCam.make(FX, FY, CX, CY, bf=0.0)


def _rodrigues(w):
    return so3.exp(torch.tensor(w, dtype=torch.float64)).numpy()


def _project(pts, R, t):
    pc = pts @ R.T + t
    return np.stack([FX * pts[:, 0] / pts[:, 2] + CX, FY * pts[:, 1] / pts[:, 2] + CY], -1), \
        np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1), pc


def make_scene(kind: str):
    """tests/test_two_view.py's scenes, in numpy: (uv1, uv2, valid, truth
    R, truth t, points) with float32 pixels."""
    if kind == "general":
        rng = np.random.default_rng(0)
        n = 300
        pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(4, 12, n)], 1)
        R, t, n_out = _rodrigues([0.02, -0.05, 0.01]), np.array([0.6, 0.05, 0.1]), 30
    elif kind == "planar":
        rng = np.random.default_rng(1)
        n = 300
        x, y = rng.uniform(-4, 4, n), rng.uniform(-3, 3, n)
        pts = np.stack([x, y, 8.0 + 0.3 * x - 0.2 * y], 1)
        R, t, n_out = _rodrigues([0.03, 0.06, -0.02]), np.array([0.5, -0.1, 0.15]), 15
    else:  # pure rotation
        rng = np.random.default_rng(2)
        n = 200
        pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(5, 10, n)], 1)
        R, t, n_out = _rodrigues([0.0, 0.08, 0.0]), np.zeros(3), 0
    uv1, uv2, pc2 = _project(pts, R, t)
    uv1 = uv1 + rng.normal(size=uv1.shape) * 0.3
    uv2 = uv2 + rng.normal(size=uv2.shape) * 0.3
    valid = (pts[:, 2] > 0.5) & (pc2[:, 2] > 0.5)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv2[idx] += rng.uniform(30, 120, size=(n_out, 2)) * rng.choice([-1, 1], size=(n_out, 2))
    return uv1.astype(np.float32), uv2.astype(np.float32), valid, R, t, pts


def mono_world_matches():
    """The oracle matches of frames 0 and 3 of tests/test_mono_vo.py's
    world (its camera, 0.3 px noise), matched by landmark id: (uv1, uv2,
    valid, sigma2)."""
    world = synthetic.make_landmark_world(n_frames=40, n_landmarks=8000, seed=3, speed=0.8)
    f0, f1 = (synthetic.render_oracle_frame(world, i, FX, FY, CX, CY, 250.0, 640, 480,
                                            max_features=1000, px_noise=0.3) for i in (0, 3))
    common, i0, i1 = np.intersect1d(f0.landmark_id, f1.landmark_id, return_indices=True)
    n = 1000
    uv1 = np.zeros((n, 2), np.float32)
    uv2 = np.zeros((n, 2), np.float32)
    valid = np.zeros((n,), bool)
    uv1[:len(common)] = f0.xy[i0]
    uv2[:len(common)] = f1.xy[i1]
    valid[:len(common)] = True
    level = np.zeros((n,), np.float32)
    level[:len(common)] = f0.level[i0]
    return uv1, uv2, valid, (1.2 ** (2.0 * level)).astype(np.float32)


SCENES = ("general", "planar", "rotation")


def scene_inputs(kind):
    if kind == "mono_world":
        return mono_world_matches()
    uv1, uv2, valid, *_ = make_scene(kind)
    return uv1, uv2, valid, np.ones((uv1.shape[0],), np.float32)


N_PADDED = 1000  # the mono world's rows


def padded_inputs(kind):
    """scene_inputs with invalid rows appended up to N_PADDED, as the
    pipeline pads its features: the reference's jitted functions then
    compile once for every scene."""
    uv1, uv2, valid, sigma2 = scene_inputs(kind)
    pad = N_PADDED - uv1.shape[0]
    uv1, uv2, sigma2 = (np.concatenate([a, np.ones((pad,) + a.shape[1:], a.dtype)])
                        for a in (uv1, uv2, sigma2))
    return uv1, uv2, np.concatenate([valid, np.zeros((pad,), bool)]), sigma2


@jax.jit
def _ref_choice(key, valid):
    w = valid.astype(jnp.float32)
    probs = w / jnp.maximum(jnp.sum(w), 1.0)
    return jax.random.choice(key, valid.shape[0], shape=(N_HYP, 8), replace=True, p=probs)


def ref_draws(valid, seed):
    """The reference's 200 x 8 samples for PRNGKey(seed), drawn as its
    `reconstruct_two_view` draws them."""
    with x64_off():
        return np.asarray(_ref_choice(jax.random.PRNGKey(seed), J(valid))).astype(np.int64)


# the reference's parts as its solver runs them (vmapped under jit), compiled
# once per input shape for the whole file
_ref_h_dlt = jax.jit(jax.vmap(rtv._h_dlt))
_ref_f_8point = jax.jit(jax.vmap(rtv._f_8point))
_ref_check_rt = jax.jit(jax.vmap(rtv._check_rt, in_axes=(0, 0, None, None, None, None, None)))


@jax.jit
def _ref_models(x1, x2, T1, T2, idx):
    Hn = jax.vmap(rtv._h_dlt)(x1[idx], x2[idx])
    H = jnp.linalg.inv(T2) @ Hn @ T1
    Fn = jax.vmap(rtv._f_8point)(x1[idx], x2[idx])
    return H / H[:, 2:, 2:], T2.T @ Fn @ T1


@jax.jit
def _ref_scores(H, F, uv1, uv2, valid, sigma2):
    def one(Hk, Fk):
        return (rtv._score_h(Hk, jnp.linalg.inv(Hk), uv1, uv2, valid, sigma2),
                rtv._score_f(Fk, uv1, uv2, valid, sigma2))
    return jax.vmap(one)(H, F)


# ------------------------------------------------------------ the parts


def test_normalize_matches_reference():
    uv1, _, valid, _ = scene_inputs("general")
    w = valid.astype(np.float32)
    with x64_off():
        rx, rT = rtv._normalize(J(uv1), J(w))
        rx, rT = np.asarray(rx), np.asarray(rT)
    px, pT = tv._normalize(T(uv1), T(w))
    np.testing.assert_allclose(N(px), rx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(N(pT), rT, rtol=1e-6)


def _samples(kind, seed=7):
    """16 seeded 8-point samples of the scene's normalized coordinates, as
    the solver hands them to its DLTs."""
    uv1, uv2, valid, _ = scene_inputs(kind)
    w = T(valid.astype(np.float32))
    x1, x2 = N(tv._normalize(T(uv1), w)[0]), N(tv._normalize(T(uv2), w)[0])
    idx = np.random.default_rng(seed).choice(np.flatnonzero(valid), size=(16, 8))
    return x1[idx], x2[idx]


def _unit_sign(M):
    """M / its entry of largest magnitude (removes scale and sign)."""
    flat = M.reshape(M.shape[0], -1)
    big = flat[np.arange(flat.shape[0]), np.argmax(np.abs(flat), axis=1)]
    return M / big[:, None, None]


@pytest.mark.parametrize("kind", ["general", "planar"])
def test_h_dlt_and_f_8point_match_reference(kind):
    """The DLT homographies of 16 seeded samples, and (on the general
    scene: a planar scene leaves F undetermined) the rank-2 fundamental
    matrices."""
    a1, a2 = _samples(kind)
    with x64_off():
        rH = np.asarray(_ref_h_dlt(J(a1), J(a2)))
        rF = np.asarray(_ref_f_8point(J(a1), J(a2)))
    pH = N(tv._h_dlt(T(a1), T(a2)))
    pF = N(tv._f_8point(T(a1), T(a2)))
    np.testing.assert_allclose(pH / pH[:, 2:, 2:], rH / rH[:, 2:, 2:], atol=2e-4)
    if kind == "general":
        np.testing.assert_allclose(_unit_sign(pF), _unit_sign(rF), atol=2e-4)
    # rank 2 on both sides
    assert np.all(np.abs(np.linalg.det(pF.astype(np.float64))) < 1e-5)


@pytest.mark.parametrize("kind", ["general", "planar", "mono_world"])
def test_scores_match_reference(kind):
    """SH and SF of 16 hypotheses (the reference's homographies and
    fundamental matrices, fed to both sides) and their inlier masks, on
    the scene's rows padded to N_PADDED."""
    uv1, uv2, valid, sigma2 = padded_inputs(kind)
    w = valid.astype(np.float32)
    with x64_off():
        x1, T1 = rtv._normalize(J(uv1), J(w))
        x2, T2 = rtv._normalize(J(uv2), J(w))
        Hs, Fs = _ref_models(x1, x2, T1, T2, J(ref_draws(valid, 5)[:16]))
        (rsh, rmh), (rsf, rmf) = _ref_scores(Hs, Fs, J(uv1), J(uv2), J(valid), J(sigma2))
        Hs, Fs = np.asarray(Hs), np.asarray(Fs)
        ref = [((float(a), np.asarray(b)), (float(c), np.asarray(d)))
               for a, b, c, d in zip(rsh, rmh, rsf, rmf)]
    sh, mh = tv._score_h(T(Hs), torch.linalg.inv(T(Hs)), T(uv1), T(uv2), T(valid), T(sigma2))
    sf, mf = tv._score_f(T(Fs), T(uv1), T(uv2), T(valid), T(sigma2))
    np.testing.assert_allclose(N(sh), [r[0][0] for r in ref], rtol=1e-4)
    np.testing.assert_allclose(N(sf), [r[1][0] for r in ref], rtol=1e-4)
    assert np.array_equal(N(mh), np.stack([r[0][1] for r in ref]))
    assert np.array_equal(N(mf), np.stack([r[1][1] for r in ref]))


def _as_set(Rs, ts):
    return np.concatenate([Rs.reshape(len(Rs), -1), ts], axis=1)


def _same_set(a, b, atol):
    """Each row of a matches a distinct row of b within atol."""
    used = set()
    for row in a:
        d = np.abs(b - row).max(axis=1)
        j = int(np.argmin(np.where([k in used for k in range(len(b))], np.inf, d)))
        assert d[j] < atol, (row, b[j], d[j])
        used.add(j)


@pytest.mark.parametrize("kind", ["general", "planar"])
def test_decompositions_match_reference(kind):
    """E's 4 and H's 8 motion hypotheses of the scene's true motion: the
    same set on both sides (the order may differ with the SVD's signs)."""
    _, _, _, R, t, _ = make_scene(kind)
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = (tx @ R).astype(np.float32)
    n = np.array([-0.3, 0.2, 1.0]) / 8.0 if kind == "planar" else np.array([0.0, 0.0, 1.0]) / 8.0
    Hc = R + np.outer(t, n)
    H = (K @ Hc @ np.linalg.inv(K)).astype(np.float32)
    Kinv = np.linalg.inv(K).astype(np.float32)
    with x64_off():
        rRe, rte = (np.asarray(a) for a in rtv._decompose_e(J(E)))
        rRh, rth = (np.asarray(a) for a in rtv._decompose_h(J(H), J(K), J(Kinv)))
    pRe, pte = (N(a) for a in tv._decompose_e(T(E)))
    pRh, pth = (N(a) for a in tv._decompose_h(T(H), T(K), T(Kinv)))
    _same_set(_as_set(pRe, pte), _as_set(rRe, rte), 1e-4)
    _same_set(_as_set(pRh, pth), _as_set(rRh, rth), 1e-4)
    # every rotation is proper
    for Rs in (pRe, pRh):
        np.testing.assert_allclose(np.linalg.det(Rs.astype(np.float64)), 1.0, atol=1e-5)


@pytest.mark.parametrize("kind", ["general", "planar", "mono_world"])
def test_check_rt_matches_reference(kind):
    """All 12 hypotheses of the reference's best models, scored on both
    sides: good counts and masks equal, points and parallax close (the
    scene's rows padded to N_PADDED)."""
    uv1, uv2, valid, sigma2 = padded_inputs(kind)
    with x64_off():
        res = rtv.reconstruct_two_view(ref_cam(), J(uv1), J(uv2), J(valid), J(sigma2),
                                       jax.random.PRNGKey(1))
        R0 = np.asarray(res.T21.R)
        t0 = np.asarray(res.T21.t)
    rng = np.random.default_rng(3)
    Rs = np.stack([R0] + [R0 @ _rodrigues(rng.normal(size=3) * 0.01) for _ in range(3)]
                  ).astype(np.float32)
    ts = np.stack([t0, -t0, t0 + rng.normal(size=3) * 0.05, t0]).astype(np.float32)
    x1n = ((uv1 - [CX, CY]) / [FX, FY]).astype(np.float32)
    x2n = ((uv2 - [CX, CY]) / [FX, FY]).astype(np.float32)
    with x64_off():
        got = [np.asarray(a) for a in _ref_check_rt(J(Rs), J(ts), J(x1n), J(x2n), J(valid),
                                                     J(sigma2), jnp.float32(FX))]
        ref = list(zip(*got))
    n, xw, good, par = (N(a) for a in tv._check_rt(T(Rs), T(ts), T(x1n), T(x2n), T(valid),
                                                   T(sigma2), torch.tensor(FX)))
    r_good = np.stack([r[2] for r in ref])
    # the masks differ only where the reference's parallax cosine lies
    # within float32 rounding of the gate (the DLT points differ by ~3e-5
    # relative; 1 point of 4000 on the mono world)
    differ = good != r_good
    r_par = np.stack([r[3] for r in ref])
    cos_at = np.where(r_good, 1.0 - r_par, 1.0 - par)  # the side that kept the point
    assert differ.sum() <= 1, differ.sum()
    assert np.all(np.abs(cos_at[differ] - 0.99998) < 1e-6), cos_at[differ]
    assert np.abs(n - np.array([int(r[0]) for r in ref])).max() <= 1
    g = good & r_good
    np.testing.assert_allclose(xw[g], np.stack([r[1] for r in ref])[g], rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(par[g], r_par[g], atol=1e-6)


# -------------------------------------------------------- whole solver


@pytest.mark.parametrize("kind", SCENES + ("mono_world",))
def test_reconstruct_fed_reference_draws(kind):
    """The port's solver over the reference's own samples reaches the
    reference's decision (the scene's rows padded to N_PADDED)."""
    uv1, uv2, valid, sigma2 = padded_inputs(kind)
    seed = {"general": 1, "planar": 2, "rotation": 3, "mono_world": 4}[kind]
    with x64_off():
        r = rtv.reconstruct_two_view(ref_cam(), J(uv1), J(uv2), J(valid), J(sigma2),
                                     jax.random.PRNGKey(seed), n_hyp=N_HYP)
        r = jax.tree_util.tree_map(np.asarray, r)
    p = tv.reconstruct_two_view_core(port_cam(), T(uv1), T(uv2), T(valid), T(sigma2),
                                     T(ref_draws(valid, seed)))
    assert bool(p.ok) == bool(r.ok)
    assert bool(p.used_homography) == bool(r.used_homography)
    if bool(r.ok):
        # a rejected solve (the pure rotation: t ~ 0, every hypothesis
        # degenerate) keeps a winner of 1-3 good points picked by rounding
        assert int(p.n_good) == int(r.n_good)
        assert np.array_equal(N(p.inliers), r.inliers)
        np.testing.assert_allclose(N(p.T21.R), r.T21.R, atol=1e-4)
        np.testing.assert_allclose(N(p.T21.t), r.T21.t, atol=1e-4)
        g = r.inliers
        np.testing.assert_allclose(N(p.points)[g], r.points[g], rtol=1e-3, atol=1e-5)


def _angle(R_est, R_true):
    dR = torch.tensor(np.asarray(R_est, np.float64) @ np.asarray(R_true, np.float64).T)
    return float(torch.linalg.norm(so3.log(dR)))


def _dir_error(t_est, t_true):
    a = np.asarray(t_est, np.float64) / np.linalg.norm(t_est)
    b = np.asarray(t_true, np.float64) / np.linalg.norm(t_true)
    return float(np.arccos(np.clip(abs(a @ b), -1, 1)))


def _structure_error(pts, good, est):
    """Median distance of the triangulated points from the truth after the
    best scale (tests/test_two_view.py's structure check)."""
    est = est[good].astype(np.float64)
    true = pts[good]
    scale = np.median(np.linalg.norm(true, axis=1) / np.linalg.norm(est, axis=1))
    return float(np.median(np.linalg.norm(est * scale - true, axis=1)))


def test_general_scene_selects_f_on_own_sampler():
    """tests/test_two_view.py::test_general_scene_selects_f on the port's
    own draws, seeds 0-7: each run ok, F selected, rotation within 0.01
    rad of the truth.

    That test's limits on the translation direction (0.02 rad) and the
    structure (0.1 m) are draws on this scene: the reference meets them
    with its key 1 in float64 (0.0184 rad), but on the same pixels rounded
    to float32 it gives 0.0378 rad and 0.1065 m, and over keys 0-7 in
    float32 0.0178-0.0951 rad and 0.1065-0.2304 m. So the port's medians
    over its seeds 0-7 are held within 1.5x the reference's medians over
    keys 0-7 (measured 0.0520 against 0.0412 rad, 0.1467 against 0.1391
    m)."""
    uv1, uv2, valid, R, t, pts = make_scene("general")
    ones = np.ones((uv1.shape[0],), np.float32)
    port, ref = [], []
    for seed in range(8):
        res = tv.reconstruct_two_view(port_cam(), T(uv1), T(uv2), T(valid), T(ones),
                                      Sampler(seed, "cpu"))
        assert bool(res.ok)
        assert not bool(res.used_homography)
        assert _angle(N(res.T21.R), R) < 0.01
        port.append((_dir_error(N(res.T21.t), t),
                     _structure_error(pts, N(res.inliers), N(res.points))))
        with x64_off():
            r = rtv.reconstruct_two_view(ref_cam(), J(uv1), J(uv2), J(valid), J(ones),
                                         jax.random.PRNGKey(seed))
            r = jax.tree_util.tree_map(np.asarray, r)
        ref.append((_dir_error(r.T21.t, t), _structure_error(pts, r.inliers, r.points)))
    port_med, ref_med = np.median(port, axis=0), np.median(ref, axis=0)
    assert np.all(port_med < 1.5 * ref_med), (port, ref)


def test_planar_scene_selects_h_on_own_sampler():
    """tests/test_two_view.py::test_planar_scene_selects_h on the port's
    own draws."""
    uv1, uv2, valid, R, t, _ = make_scene("planar")
    res = tv.reconstruct_two_view(port_cam(), T(uv1), T(uv2), T(valid),
                                  torch.ones(uv1.shape[0]), Sampler(2, "cpu"))
    assert bool(res.ok)
    assert bool(res.used_homography)
    assert _angle(N(res.T21.R), R) < 0.015
    assert _dir_error(N(res.T21.t), t) < 0.12


def test_pure_rotation_rejected_on_own_sampler():
    """tests/test_two_view.py::test_pure_rotation_rejected on the port's
    own draws: no parallax, no initialization."""
    uv1, uv2, valid, *_ = make_scene("rotation")
    res = tv.reconstruct_two_view(port_cam(), T(uv1), T(uv2), T(valid),
                                  torch.ones(uv1.shape[0]), Sampler(3, "cpu"))
    assert not bool(res.ok)
    assert isinstance(res.T21, SE3) and res.points.shape == (uv1.shape[0], 3)
